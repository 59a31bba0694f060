"""Multinomial softmax regression, the matrix-variable workload — the
counterpart of ``repro.problems.softmax``.

Global problem over row-partitioned multiclass data (A, y):

    min_X  sum_n [ logsumexp(a_n X) - (a_n X)_{y_n} ]  +  lam1 ||X||_1

with X in R^{d x C}.  On the wire the decision variable is the flattened
matrix, ``n_features = d * C``; ``solve`` reshapes internally and the
elementwise l1 prox is shape-blind.  Data: C Gaussian class blobs — per
global row a label y ~ U{0..C-1} and features a = class_sep * mu_y + noise
* N(0, I_d), the class means mu drawn from the off-row key stream.

The labels follow ``jax.random.randint`` at JAX's default integer width:
32 bits, or 64 under ``jax_enable_x64``, the only setting in which the
reference runs float64; so a float64 problem draws 64-bit labels.
"""
from __future__ import annotations

import torch

from repro_torch.core import prox
from repro_torch.data import threefry as tf
from repro_torch.data.logreg import shard_rows
from repro_torch.kernels import ops, ref
from repro_torch.problems import base


class SoftmaxProblem(base.FistaShardProblem):
    """See module docstring.  h(Z) = lam1 ||Z||_1 (elementwise, flat)."""

    def __init__(self, n_samples: int = 1024, n_features: int = 64, *,
                 n_classes: int = 8, lam1: float = 1e-3,
                 class_sep: float = 1.5, noise: float = 1.0, seed: int = 0,
                 fista=None, fixed_inner=None, dtype="float32",
                 device="cuda"):
        super().__init__(n_samples, n_features * n_classes, seed=seed,
                         fista=fista, fixed_inner=fixed_inner, dtype=dtype,
                         device=device)
        self.d_in = int(n_features)
        self.n_classes = int(n_classes)
        self.lam1 = float(lam1)
        self.class_sep = float(class_sep)
        self.noise = float(noise)

    def class_means(self) -> torch.Tensor:
        """(C, d) blob centres from the off-row key stream."""
        return tf.normal(self._aux_key(0), self.n_classes * self.d_in).view(
            self.n_classes, self.d_in)

    def _gen_shard(self, wid: int, n_workers: int):
        lo, hi = shard_rows(self.total_samples, n_workers, wid)
        sub = tf.split(self._row_keys(lo, hi), 2)
        bits = 64 if self.dtype == torch.float64 else 32
        y = tf.randint(tf.split_key(sub, 0), self.n_classes, bits)   # (R,)
        A = (self.class_sep * self.class_means()[y]
             + self.noise * tf.normal(tf.split_key(sub, 1), self.d_in))
        return A.to(self.dtype), y

    def _loss_value_and_grad(self, shard):
        A, y = shard
        mask = torch.ones(y.shape, dtype=A.dtype, device=A.device)
        d, C = self.d_in, self.n_classes

        def vg(x):
            f, g = ref.softmax_vjp_ref(A, y, mask, x.reshape(d, C))
            return f, g.reshape(-1)
        return vg

    def _masked_loss_value_and_grad(self, batch, mask):
        # a zero-padded row has logits 0: the mask zeroes its log(C) value
        # and its residual row
        A, y = batch
        d, C = self.d_in, self.n_classes

        def vg(X):
            f, g = ref.softmax_vjp_ref(A, y, mask, X.reshape(-1, d, C))
            return f, g.reshape(X.shape)
        return vg

    # -- fused-kernel path (SchedulerConfig(kernel="cuda")) -----------------
    def _masked_kernel_loss_value_and_grad(self, batch, mask):
        # shards are dense already, so batch_shards is the staging; the
        # wrapper runs its plain version on either device (no kernel, as
        # in the reference) but keeps the workload on the call contract
        A, y = batch
        C = self.n_classes

        def vg(X):
            return ops.fused_softmax_vjp(A, y, X, n_classes=C, mask=mask)
        return vg

    def prox_h(self, v, t):
        return prox.prox_l1(v, t, self.lam1)

    @property
    def h_l1_lam(self):
        return self.lam1

    def h_value(self, z) -> float:
        return self.lam1 * float(torch.sum(torch.abs(z)))


base.register("softmax", SoftmaxProblem)
