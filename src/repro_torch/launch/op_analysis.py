"""Per-rank FLOPs, bytes, collectives and peak memory of one eager step:
the port's counterpart of ``repro/launch/hlo_analysis.py``.

The reference walks the compiled, post-SPMD HLO; an eager step has no HLO,
so this module reads the operator stream instead.  ``OpCounter`` is a
``TorchDispatchMode`` run around one step, and what it sees is each rank's
own program:

* matmul FLOPs by ``torch.utils.flop_counter``'s formulas (2 m n k for a
  matmul, the MFU numerator; elementwise FLOPs are ignored, as in the
  reference), plus the formulas of the port's kernels, which a ctypes
  launch hides from the dispatcher (``kernels/ops.KERNEL_HOOKS``: flash
  4 B S Skv H hd, halved by the causal mask and cut by a window; decode
  4 B H hd per live slot; the z-update 0);
* bytes: operand + result bytes of every operator that is not a view or a
  fresh allocation.  This is the unfused traffic — an upper bound on what
  the reference's fusion-boundary model counts, not the same quantity;
* each ``_c10d_functional`` collective (all_reduce, all_gather_into_tensor,
  reduce_scatter_tensor, all_to_all_single) with its tensor bytes and
  group size, turned into per-rank link bytes by the reference's ring
  formulas (``_link_bytes``), and whether its group crosses a pod
  (``_crosses_pod``);
* the peak of live bytes: the step's arguments plus every storage an
  operator allocated, released when the last tensor on it dies.

DTensor: an operator on DTensors is expanded by DTensor into local
operators and collectives, which run through the dispatcher in turn.  The
counter passes the DTensor-level operator on (``NotImplemented``) without
counting it, so its global shapes are never counted, neither instead of
nor beside the local operators it expands to.  DTensor's shape
propagation runs an operator once more on fake tensors of the global
shapes, under a ``FakeTensorMode`` of its own: no operator on a fake tensor
is counted, so the step itself must not run on fake tensors (the dry-run
runs it on ``meta`` tensors, which are counted like real ones).

``unknown_trip_loops`` is always 0: an eager step runs every loop
iteration through the dispatcher, so no loop goes uncounted (the
reference's count is of HLO while-loops whose trip count XLA could not
read).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.float16: 2, torch.bfloat16: 2,
    torch.int32: 4, torch.uint32: 4, torch.float32: 4,
    torch.int64: 8, torch.uint64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}

_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# allocations that touch no memory, and bookkeeping of the collectives
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
         "detach", "lift_fresh", "_local_scalar_dense", "set_"}


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * _DTYPE_BYTES.get(t.dtype, t.element_size())


def _link_bytes(op: str, result_bytes: float, n: int) -> float:
    """Per-rank link bytes of one collective under ring costs (T the
    per-participant tensor): all-reduce 2 T (n-1)/n, all-gather T_full
    (n-1)/n, reduce-scatter T_shard (n-1), all-to-all T (n-1)/n,
    collective-permute T."""
    if n <= 1:
        return 0.0
    if op.startswith("all-reduce"):
        return 2.0 * result_bytes * (n - 1) / n
    if op.startswith("all-gather"):
        return result_bytes * (n - 1) / n
    if op.startswith("reduce-scatter"):
        return float(result_bytes) * (n - 1)
    if op.startswith("all-to-all"):
        return result_bytes * (n - 1) / n
    if op.startswith("collective-permute"):
        return float(result_bytes)
    return 0.0


def _crosses_pod(ranks, pod_ranks: int) -> bool:
    """Does a group of global ranks span two pods (rank // pod_ranks)?"""
    return len({int(r) // pod_ranks for r in ranks}) > 1


def _group(name: str):
    from torch.distributed import distributed_c10d as c10d
    pg = c10d._resolve_process_group(name)
    return pg.size(), c10d.get_process_group_ranks(pg)


class OpCounter(TorchDispatchMode):
    """Counts one rank's operators while active (see the module's
    docstring).  ``add_args(tree)`` counts a step's arguments into the live
    bytes first."""

    def __init__(self, pod_ranks: int = 256):
        super().__init__()
        self.pod_ranks = pod_ranks
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.dcn = 0.0
        self.n_coll = 0
        self.kernel_flops: Dict[str, float] = defaultdict(float)
        self.arg_bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, int] = {}

    # -- live bytes ---------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        if key in self._refs:
            self._refs[key] += 1
        else:
            self._refs[key] = 1
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, key, n)

    def _release(self, key: int, n: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= n

    def add_args(self, tree) -> None:
        """The step's arguments (DTensors count their local shards), held
        for the whole step."""
        from torch.distributed.tensor import DTensor
        seen = set()
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                self.arg_bytes += st.nbytes()
        self.live += self.arg_bytes
        self.peak = max(self.peak, self.live)

    # -- the kernels' reports -----------------------------------------------
    def _kernel(self, name: str, flops: float, n_bytes: float) -> None:
        self.flops += flops
        self.bytes += n_bytes
        self.kernel_flops[name] += flops

    def __enter__(self):
        ops.KERNEL_HOOKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.KERNEL_HOOKS.remove(self._kernel)
        return super().__exit__(*exc)

    # -- the operators ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in ins):
            return NotImplemented        # counted as the local ops it runs
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                   # shape propagation, no work
        name = func._overloadpacket.__name__
        base = name.rstrip("_").removesuffix("_coalesced")
        if func.namespace == "_c10d_functional" and base in _COLLECTIVES:
            self._collective(_COLLECTIVES[base], args, outs)
        elif name not in _FREE and not func.is_view:
            self._count(func, args, kwargs, out, ins, outs)
        for t in outs:
            self._hold(t)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        seen = set()
        for t in ins:
            if id(t) not in seen:
                seen.add(id(t))
                self.bytes += _tensor_bytes(t)
        for t in outs:
            if id(t) not in seen:        # an in-place result is its input
                self.bytes += _tensor_bytes(t)

    def _collective(self, kind: str, args, outs) -> None:
        group_name = args[-1]
        n, ranks = _group(group_name)
        rb = float(sum(_tensor_bytes(t) for t in outs))
        lb = _link_bytes(kind, rb, n)
        self.coll[kind] += lb
        if _crosses_pod(ranks, self.pod_ranks):
            self.dcn += lb
        self.n_coll += 1
        self.bytes += 2 * rb

    # -- the summary --------------------------------------------------------
    def summary(self) -> Dict:
        """The reference's ``cost_summary`` keys, per rank."""
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes,
            "per_chip_link_bytes": float(sum(self.coll.values())),
            "dcn_link_bytes": self.dcn,
            "by_type": dict(self.coll),
            "n_collective_ops": self.n_coll,
            "unknown_trip_loops": 0,
            "kernel_flops": dict(self.kernel_flops),
            "arg_bytes": int(self.arg_bytes),
            "peak_bytes_est": int(self.peak),
        }


def cost_summary(step, *args, pod_ranks: int = 256):
    """Run ``step(*args)`` under an ``OpCounter`` -> (its result, the
    counter's summary)."""
    counter = OpCounter(pod_ranks)
    counter.add_args(args)
    with counter:
        out = step(*args)
    return out, counter.summary()
