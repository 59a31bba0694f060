"""setup_s (s, lower is better): process start to the window's start:
imports, the kernels' build or load, the rows drawn and handed over,
staging, and the warm-up rounds of the cell's own spec.  Host clock."""


def read(ctx):
    return ctx.setup_s
