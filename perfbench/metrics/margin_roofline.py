"""margin_roofline (%): one loss-and-gradient evaluation's least time on
the card, for what the sparse rows need, over the profiler's mean device
time a launch of the margin kernels (every kernel whose name holds
``margin``: today the dense ``margin_one_pass``, one launch an
evaluation) in the traced solve.  A kernel of the evaluation under
another name is read by a metric of its own, and ``round_mfu`` bounds
them all.  Moves round_s.

The work of an evaluation over W lanes of d features (``eval_work``):
each row's nonzeros read once (a 4-byte index and a 4-byte value), each
label once (4 B), x read once and the gradient written once (4 W d B
each), the W losses written once; 4 operations a nonzero (the margin's
multiply-add, the gradient's multiply-add) and 5 a row.  A loss alone
(``loss_work``) reads the same and writes no gradient: 2 operations a
nonzero and 4 a row.  The counts take the nonzeros from the rows, so a
dense and a sparse implementation of the same rows are held to the same
work."""
from perfbench.harness import peaks

KERNELS = "margin"


def eval_work(nnz: int, n_rows: int, n_workers: int,
              n_features: int) -> peaks.Work:
    n_bytes = (8.0 * nnz + 4.0 * n_rows + 2 * 4.0 * n_workers * n_features
               + 4.0 * n_workers)
    return peaks.Work({"float32": 4.0 * nnz + 5.0 * n_rows}, n_bytes)


def loss_work(nnz: int, n_rows: int, n_workers: int,
              n_features: int) -> peaks.Work:
    n_bytes = (8.0 * nnz + 4.0 * n_rows + 4.0 * n_workers * n_features
               + 4.0 * n_workers)
    return peaks.Work({"float32": 2.0 * nnz + 4.0 * n_rows}, n_bytes)


def read(ctx):
    if ctx.trace is None:
        return None
    secs, n = ctx.trace.kernel_time(KERNELS)
    if n == 0 or secs <= 0:
        return None
    cell = ctx.cell
    least = peaks.least_seconds(eval_work(cell.nonzeros(), cell.N, cell.W,
                                          cell.d))
    return 100.0 * least / (secs / n)
