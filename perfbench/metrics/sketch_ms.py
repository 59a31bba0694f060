"""sketch_ms (ms/round): the mean span around the problem's
``round_messages_all`` (margins, the count sketch of every block, the
gradient shards), between two device synchronizes.  Moves round_s."""


def read(ctx):
    vals = [r.spans["sketch"] for r in ctx.window.rounds
            if "sketch" in r.spans]
    return 1e3 * sum(vals) / len(vals) if vals else None
