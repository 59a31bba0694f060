"""sim_ms (ms/round): the simulators on the host's clock: the program's
`round.respawn` (the per-worker respawn checks) and `round.simulate` spans
(the per-worker timing, the barrier, the fan-in drain, the bill, the
round's metrics), summed within a round, the mean over the traced rounds.
Moves round_s."""
from perfbench.harness import program_trace


def read(ctx):
    return program_trace.mean_ms(["round.respawn", "round.simulate"], "host")
