"""master_ms (ms/round): the mean span around the problem's
``master_step`` (the messages' Grams and their decode, the float64 solve,
the Armijo search), between two device synchronizes.  Moves round_s."""


def read(ctx):
    vals = [r.spans["master"] for r in ctx.window.rounds
            if "master" in r.spans]
    return 1e3 * sum(vals) / len(vals) if vals else None
