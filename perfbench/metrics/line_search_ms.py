"""line_search_ms (ms/round): the master's Armijo search on the device's
clock: the program's `newton.line_search` span (the float64 objective at
the start and at each trial step), the mean over the traced rounds.  Moves
round_s."""
from perfbench.harness import program_trace


def read(ctx):
    return program_trace.mean_ms(["newton.line_search"], "device")
