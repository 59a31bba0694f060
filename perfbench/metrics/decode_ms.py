"""decode_ms (ms/round): the master's decode on the device's clock, its
own time: the program's `newton.decode` span (`BlockSketch.decode_sum`,
the coded sum of the messages) less its `newton.gram` children, the mean
over the traced rounds.  Moves round_s."""
from perfbench.harness import program_trace


def read(ctx):
    return program_trace.mean_ms(["newton.decode"], "device", self_time=True)
