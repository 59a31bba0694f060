"""gram_ms (ms/round): the master's block Grams on the device's clock: the
program's `newton.gram` spans, one a message read (a Gram product over the
message's blocks and its coding), summed within a round, the mean over the
traced rounds.  Moves round_s."""
from perfbench.harness import program_trace


def read(ctx):
    return program_trace.mean_ms(["newton.gram"], "device")
