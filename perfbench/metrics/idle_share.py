"""idle_share (%): the share of the traced part of the window (the first
solve) in which no operation ran on the card, from the profiler's device
timeline (``harness/devtrace.py``).  Moves round_s."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
