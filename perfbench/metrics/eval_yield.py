"""eval_yield (%): the share of the lanes' evaluations that their own
FISTA needed: over the traced rounds, the sum over rounds and lanes of
2 k + 1 (k the lane's steps, `RoundMetrics.inner_iters`: k evaluations
with a gradient, k + 1 losses, as `round_work` counts them), over W times
the sum over rounds of the program's `fista.evals` counter (each
evaluation streams all W lanes).  The program's traced rounds pair in
order with the window's; where their counts differ it reads nothing.
Moves round_s."""
import numpy as np

from perfbench.harness import program_trace


def read(ctx):
    per_round = program_trace.counts("fista.evals")
    traced = [r for r in ctx.window.rounds if r.traced]
    if per_round is None or len(per_round) != len(traced):
        return None
    needed = sum(float(np.sum(2 * np.asarray(r.metrics.inner_iters,
                                             np.int64) + 1))
                 for r in traced)
    made = ctx.cell.W * sum(per_round)
    return 100.0 * needed / made if made > 0 else None
