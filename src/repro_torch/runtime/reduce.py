"""Hierarchical compressed fan-in: the fix for the paper's W=256 cliff.

Fig 5 of the paper shows parallel efficiency collapsing from 74% at W=64
to 26% at W=256 because ONE router thread serially ingests every
ω-message (``pool.master_drain`` models that M/D/1 queue).  The paper's
§V "proposed improvements" names hierarchical reduction and message
compression as the fixes; OverSketched Newton (Gupta et al. '19) and
Finol et al. '22 show tree aggregation is what lets serverless
optimization scale past a few hundred workers.

This module models a k-ary aggregator tree:

    workers ──► level-0 combiners ──► level-1 combiners ──► ... ──► root

* each combiner NODE is itself a small ``master_drain`` instance — a
  router thread (``t_ingest_s`` per message) feeding ``node_masters``
  reducer threads (``t_proc_s`` per message).  With a single level and a
  node sized like the flat master (``node_masters = W/W-bar``), the tree
  reproduces ``master_drain`` timings EXACTLY — that degenerate case is
  the regression anchor (tests/test_reduce.py).
* every non-root level forwards ONE combined message up a hop, paying an
  α-β cost on the combined payload.  The combined payload is modeled at
  the fleet codec's message size — an IDEALIZED re-encode: the extra
  lossiness that re-compressing a partial aggregate would induce is
  charged to neither the wire nor the math (the master averages the
  first-hop codec views), so the measured convergence covers first-hop
  compression only.  A real deployment would either forward the union
  of supports (larger upper-hop messages) or accept re-encode loss.
* the root therefore ingests ``ceil(W / fanout^depth)`` messages instead
  of W — serial ingest stops scaling with W and the cliff disappears.

The scheduler switches between the flat path and this tree with
``SchedulerConfig(fanin="flat"|"tree")``.  Replicated (FRS) mode
composes trivially: the scheduler resolves first-responder-per-group
BEFORE fan-in, so the tree only ever sees one message per logical
worker and the exactness argument is untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime.pool import master_drain

# standalone defaults — the flat master's calibrated per-message constants
# (PoolConfig.t_ingest_s / t_master_proc_s), so the tree's win comes
# purely from parallelising the ingest, not from assuming faster combiners
DEFAULT_T_INGEST_S = 0.008
DEFAULT_T_PROC_S = 0.009


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """k-ary aggregation tree.  Combiner costs left as None are derived
    by the caller: the scheduler (reduce.fanin_drain) substitutes the
    pool's byte-scaled per-message constants; standalone ``tree_drain``
    falls back to DEFAULT_T_INGEST_S / DEFAULT_T_PROC_S.  Set them
    explicitly to model faster or slower combiners — explicit values are
    always honored."""
    fanout: int = 16                       # k: max children per combiner
    node_masters: int = 1                  # reducer threads per combiner
    t_ingest_s: Optional[float] = None     # combiner router, per message
    t_proc_s: Optional[float] = None       # combiner reduce, per message
    max_depth: int = 8                     # safety bound on tree height

    def __post_init__(self):
        if self.fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {self.fanout}")


def tree_shape(n_leaves: int, fanout: int) -> List[int]:
    """Node counts per level, leaves-exclusive: [n_level0, ..., 1]."""
    if fanout < 2:
        raise ValueError(f"fanout must be >= 2, got {fanout}")
    shape = []
    n = n_leaves
    while True:
        n = -(-n // fanout)
        shape.append(n)
        if n == 1:
            return shape


def _deal(msgs: List[Tuple[float, int]], n_nodes: int
          ) -> List[List[Tuple[float, int]]]:
    """Round-robin deal in arrival order (same discipline as the flat
    master's fair queue)."""
    groups: List[List[Tuple[float, int]]] = [[] for _ in range(n_nodes)]
    for i, m in enumerate(msgs):
        groups[i % n_nodes].append(m)
    return groups


def tree_drain(arrivals: List[Tuple[float, int]], cfg: TreeConfig,
               hop_s: float) -> Tuple[Dict[int, float], float]:
    """Drain W ω-messages through the aggregation tree.

    ``arrivals`` is [(sim time the message reaches its level-0 combiner,
    wid)] — worker→combiner comm is already in the arrival times, exactly
    as it is for the flat master.  ``hop_s`` is the α-β cost of one
    combiner→parent hop on the combined (re-encoded) payload.

    Returns (wid -> level-0 processing-finished time, root completion
    time).  The root time is when the LAST message clears the root's
    reducers — the moment ω̄ is available for the z-update.
    """
    if not arrivals:
        return {}, 0.0
    t_ingest = (cfg.t_ingest_s if cfg.t_ingest_s is not None
                else DEFAULT_T_INGEST_S)
    t_proc = cfg.t_proc_s if cfg.t_proc_s is not None else DEFAULT_T_PROC_S
    shape = tree_shape(len(arrivals), cfg.fanout)
    if len(shape) > cfg.max_depth:
        raise ValueError(f"tree depth {len(shape)} exceeds max_depth="
                         f"{cfg.max_depth}; raise fanout")
    level_msgs: List[Tuple[float, int]] = sorted(arrivals)
    leaf_done: Dict[int, float] = {}
    for lvl, n_nodes in enumerate(shape):
        is_root = n_nodes == 1 and lvl == len(shape) - 1
        next_msgs: List[Tuple[float, int]] = []
        for node_id, msgs in enumerate(_deal(level_msgs, n_nodes)):
            if not msgs:
                continue
            done = master_drain(msgs, cfg.node_masters, t_proc, t_ingest)
            node_done = max(done.values())
            if lvl == 0:
                leaf_done.update(done)
            if is_root:
                return leaf_done, node_done
            next_msgs.append((node_done + hop_s, node_id))
        level_msgs = sorted(next_msgs)
    raise AssertionError("unreachable: tree_shape always ends at the root")


def fanin_drain(arrivals: List[Tuple[float, int]], fanin: str, pool,
                tree_cfg: TreeConfig, msg_bytes: int,
                n_workers: int) -> float:
    """The scheduler's (and benchmarks') fan-in timing dispatch: scale the
    per-message ingest/reduce costs with the wire size (deserialization is
    the router's cost — ``LambdaPool.msg_cost``), then drain through the
    flat router or the aggregation tree.  Returns the time the LAST
    message clears the reduce — when ω̄ is available for the z-update.

    ``n_workers`` sizes the flat path's master threads (the fleet's W,
    which can exceed ``len(arrivals)`` under partial barriers)."""
    pc = pool.cfg
    t_ing = pool.msg_cost(pc.t_ingest_s, msg_bytes)
    t_proc = pool.msg_cost(pc.t_master_proc_s, msg_bytes)
    if fanin == "tree":
        # hops carry the codec's message size (idealized combiner
        # re-encode — see module docstring); explicit TreeConfig costs
        # win over the derived byte-scaled constants
        cfg = dataclasses.replace(
            tree_cfg,
            t_ingest_s=(tree_cfg.t_ingest_s if tree_cfg.t_ingest_s
                        is not None else t_ing),
            t_proc_s=(tree_cfg.t_proc_s if tree_cfg.t_proc_s is not None
                      else t_proc))
        _, root_done = tree_drain(arrivals, cfg,
                                  pool.comm_time(msg_bytes))
        return root_done
    n_masters = -(-n_workers // pc.workers_per_master)
    done = master_drain(arrivals, n_masters, t_proc, t_ing)
    return max(done.values())


def flat_equivalent(pool_cfg, n_workers: int) -> TreeConfig:
    """The degenerate tree that reproduces the flat ``master_drain``
    exactly: one level (fanout >= W) whose single node has the flat
    scheduler's router + ceil(W/W-bar) reducer threads."""
    n_masters = -(-n_workers // pool_cfg.workers_per_master)
    return TreeConfig(fanout=max(n_workers, 1), node_masters=n_masters,
                      t_ingest_s=pool_cfg.t_ingest_s,
                      t_proc_s=pool_cfg.t_master_proc_s)


def root_ingest_count(n_leaves: int, fanout: int) -> int:
    """Messages the root serially ingests (== last level's input size)."""
    shape = tree_shape(n_leaves, fanout)
    return n_leaves if len(shape) == 1 else shape[-2]
