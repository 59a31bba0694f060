"""scatter_ms (ms/round): the count sketch of every block on the device's
clock: the program's `newton.scatter` span around `plan.apply_all` inside
`round_messages_all`, the mean over the traced rounds.  Moves round_s."""
from perfbench.harness import program_trace


def read(ctx):
    return program_trace.mean_ms(["newton.scatter"], "device")
