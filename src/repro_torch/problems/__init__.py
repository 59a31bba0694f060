"""Workload registry of the port: the problems the scheduler can drive.

    from repro_torch import problems
    p = problems.make("logreg", device="cpu")
"""
from repro_torch.problems.base import (BatchedShardProblem, FistaShardProblem,
                                       WorkerProblem, as_fista_options,
                                       available, carry_shards, make,
                                       register, unregister)
from repro_torch.problems.logreg import LogRegProblem

__all__ = [
    "WorkerProblem", "FistaShardProblem", "BatchedShardProblem",
    "register", "unregister", "make", "available", "as_fista_options",
    "carry_shards", "LogRegProblem",
]
