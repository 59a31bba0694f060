"""staging_s (s): the set-up span around the problem's
``batch_shards(W)`` and ``kernel_batch_shards(W)``: the shards read from
the data cache, stacked, and staged for the kernel.  Moves setup_s."""


def read(ctx):
    return ctx.setup_spans.get("staging")
