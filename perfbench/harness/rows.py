"""The benchmark's rows: a configuration's instance, its signs flipped by a
run's seed, on the run's device.

Written from the recipe of Koh, Kim and Boyd (JMLR 2007) as Section III of
arXiv:1901.03161 states it for the paper's instance: each row has
round(density · d) distinct nonzero features at uniformly random
positions, its label b is +1 or -1 with probability 1/2, and its nonzero
values are N(nu, 1) with nu ~ U[0, 1] for b = +1 and U[-1, 0] for b = -1.
The stream is this file's own (one ``torch.Generator``, a few large
calls), not the program's threefry generator, so a change to the
program's data layer cannot move the benchmark's inputs.

A configuration names one instance (``instance_seed``).  A run's seed
flips the signs of a random set of features (a_ij -> -a_ij for every row)
and of a random set of rows (a_i, b_i -> -a_i, -b_i): symmetries of the
problem that float arithmetic keeps exactly (every product, sum and
threshold only changes sign), so each seed poses the same problem with
the same iterations and the same work, in other bytes.  (A reordering
would not: float32 sums taken in another order round otherwise, and the
solver's float32 stopping rule, a relative improvement that rounds to
zero, then takes other iteration counts, which moved a round's time by up
to 8% from seed to seed on the card.)
The program and the reference both receive these rows.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from perfbench.reference.simulator import shard_rows

Rows = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def program_seed(seed: int) -> int:
    """The seed handed to the program's own draws (its simulated pool's
    RNG, its sketch maps): the run's seed folded into what numpy's
    RandomState takes."""
    return int(seed) % (2 ** 31 - 1)


def nonzeros_per_row(n_features: int, density: float) -> int:
    return max(1, round(density * n_features))


def draw(n_samples: int, n_features: int, density: float, seed: int,
         device) -> Rows:
    """(idx (N, k) int64, vals (N, k) float32, b (N,) float32 of ±1): N
    rows of k = round(density · d) distinct features each.  The same seed
    on the same device gives the same rows."""
    device = torch.device(device)
    k = nonzeros_per_row(n_features, density)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    b = (torch.randint(0, 2, (n_samples,), generator=g, device=device)
         .to(torch.float32) * 2.0 - 1.0)
    nu = torch.rand(n_samples, generator=g, device=device) * b
    idx = torch.randint(0, n_features, (n_samples, k), generator=g,
                        device=device)
    while True:
        # a row that drew a feature twice is drawn again whole
        srt = torch.sort(idx, dim=1).values
        again = torch.nonzero((srt[:, 1:] == srt[:, :-1]).any(dim=1))[:, 0]
        if again.numel() == 0:
            break
        idx[again] = torch.randint(0, n_features, (again.numel(), k),
                                   generator=g, device=device)
    vals = nu[:, None] + torch.randn(n_samples, k, generator=g,
                                     device=device)
    return idx, vals, b


def instance(n_samples: int, n_features: int, density: float,
             instance_seed: int, seed: int, device) -> Rows:
    """The configuration's instance (``draw`` with ``instance_seed``), with
    the signs of features and of rows flipped where ``seed`` draws it."""
    idx, vals, b = draw(n_samples, n_features, density, instance_seed,
                        device)
    g = torch.Generator(device=idx.device)
    g.manual_seed(int(seed) % (1 << 64))
    feature = torch.randint(0, 2, (n_features,), generator=g,
                            device=idx.device).to(torch.float32) * 2 - 1
    row = torch.randint(0, 2, (n_samples,), generator=g,
                        device=idx.device).to(torch.float32) * 2 - 1
    return idx, vals * feature[idx] * row[:, None], b * row


def write_shards(rows: Rows, n_workers: int, directory: str, *,
                 n_samples: int, n_features: int, density: float,
                 seed: int) -> int:
    """Write each worker's rows where the program's data cache
    (``REPRO_DATA_CACHE``) looks for them: one ``.npz`` per worker, under
    the names and keys the program's logistic-regression problem reads
    (idx int32, vals and b float32).  Returns the bytes written."""
    idx, vals, b = (t.cpu().numpy() for t in rows)
    total = 0
    for w in range(n_workers):
        lo, hi = shard_rows(n_samples, n_workers, w)
        path = os.path.join(directory, f"logreg_n{n_samples}_d{n_features}"
                            f"_p{density}_s{seed}_w{w}of{n_workers}.npz")
        np.savez(path, idx=idx[lo:hi].astype(np.int32), vals=vals[lo:hi],
                 b=b[lo:hi])
        total += os.path.getsize(path)
    return total
