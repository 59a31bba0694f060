"""xupdate_ms (ms/round): the x-update of every lane, on the device's
clock: the program's `round.xupdate` span (the residuals, the problem's
`solve_all` with its FISTA lanes, the ω messages), the mean over the
traced rounds.  Moves round_s."""
from perfbench.harness import program_trace


def read(ctx):
    return program_trace.mean_ms(["round.xupdate"], "device")
