"""newton_solve_ms (ms/round): the master's float64 Newton solve on the
device's clock: the program's `newton.solve` span (`_newton_direction`: the
LU solve and the descent guard), the mean over the traced rounds.  Moves
round_s."""
from perfbench.harness import program_trace


def read(ctx):
    return program_trace.mean_ms(["newton.solve"], "device")
