"""fanin_ms (ms/round): the master's fan-in on the host's clock: the
program's `round.fanin` span (the codec's rollback, the ω and q tables'
commit, the x and u commit, ω̄), the mean over the traced rounds.  Moves
round_s."""
from perfbench.harness import program_trace


def read(ctx):
    return program_trace.mean_ms(["round.fanin"], "host")
