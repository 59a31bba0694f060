"""scheduler_ms (ms/round): the mean round wall less the time inside the
problem's calls (the benchmark's spans around ``solve_all``, or around
``round_messages_all`` and ``master_step``, each between two device
synchronizes): the scheduler's barrier, the simulators, the master's
reductions outside those calls, and the host work around them.  Moves
round_s."""


def read(ctx):
    rounds = ctx.window.rounds
    if not rounds:
        return None
    rest = [r.wall_s - sum(r.spans.values()) for r in rounds]
    return 1e3 * sum(rest) / len(rest)
