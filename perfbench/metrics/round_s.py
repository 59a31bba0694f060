"""round_s (s, lower is better): the window's wall time over the ADMM
rounds completed in it.  Host clock; the window starts after a device
synchronize and ends at the end of a round, after another."""


def read(ctx):
    n = len(ctx.window.rounds)
    return ctx.window.seconds / n if n else None
