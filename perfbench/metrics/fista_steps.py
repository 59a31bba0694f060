"""fista_steps (steps/round): the mean over the window's rounds of the
largest FISTA iteration count among the lanes (``RoundMetrics.
inner_iters``, a count the program makes): the batched solve runs until
its last lane stops.  Moves round_s."""


def read(ctx):
    rounds = ctx.window.rounds
    if not rounds:
        return None
    return sum(float(max(r.metrics.inner_iters)) for r in rounds) / \
        len(rounds)
