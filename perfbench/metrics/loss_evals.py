"""loss_evals (evals/round): the loss evaluations the program makes in a
round, each one launch over all W lanes: the program's `fista.evals`
counter, the mean over the traced rounds.  Moves round_s."""
from perfbench.harness import program_trace


def read(ctx):
    per_round = program_trace.counts("fista.evals")
    if per_round is None:
        return None
    return sum(per_round) / len(per_round)
