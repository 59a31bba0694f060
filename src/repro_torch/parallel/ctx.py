"""Activation-sharding context (a port of ``repro/parallel/ctx.py``).

The model code is mesh-agnostic: it calls ``constrain(x, kind)`` at the
points where a placement hint helps (residual stream, attention heads,
logits, MoE slot buffers).  The launch layer installs a rule set mapping
``kind`` -> ``sharding.P``; outside a rule context, and for a plain
tensor, the call returns its argument, so single-device runs never touch
the mesh machinery.  For a DTensor it redistributes to the rule's
placements on the DTensor's own mesh, which is what JAX's
``with_sharding_constraint`` asks of the partitioner.  A rule whose split
does not divide the tensor is left out: the port ignores
``attn_head_pad``, so 28 or 40 query heads do not take a head rule made
for their padded count of 32 or 48.  The rules are thread-local, as in the
reference.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

_state = threading.local()


def current_rules() -> Optional[Dict[str, tuple]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Dict[str, tuple]):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def constrain(x, kind: str):
    rules = current_rules()
    if rules is None:
        return x
    spec = rules.get(kind)
    from torch.distributed.tensor import DTensor
    if spec is None or not isinstance(x, DTensor):
        return x
    from repro_torch.parallel.sharding import divides, to_placements
    if not divides(x.shape, x.device_mesh, spec):
        return x
    placements = to_placements(x.device_mesh, spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)
