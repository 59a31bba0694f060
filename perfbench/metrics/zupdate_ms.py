"""zupdate_ms (ms/round): the master's z-update on the device's clock:
the program's `round.zupdate` span (the fused soft-threshold kernel, or
`prox_h`, the residuals, the penalty's update), the mean over the traced
rounds.  Moves round_s."""
from perfbench.harness import program_trace


def read(ctx):
    return program_trace.mean_ms(["round.zupdate"], "device")
