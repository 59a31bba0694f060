"""Workload registry of the port: the problems the scheduler can drive.

    from repro_torch import problems
    problems.available()   # ['lasso', 'logreg', 'logreg_l2', 'softmax', 'svm']
    p = problems.make("svm", device="cpu")

The reference also registers ``newton_sketch`` and ``double_ml``; they wait
for the second-order slice (ROADMAP.md, Queue 1).
"""
from repro_torch.problems.base import (BatchedShardProblem, FistaShardProblem,
                                       WorkerProblem, as_fista_options,
                                       available, carry_shards, make,
                                       register, unregister)
from repro_torch.problems.lasso import LassoProblem
from repro_torch.problems.logreg import LogRegProblem
from repro_torch.problems.newton_sketch import LogRegL2Problem
from repro_torch.problems.softmax import SoftmaxProblem
from repro_torch.problems.svm import SVMProblem

__all__ = [
    "WorkerProblem", "FistaShardProblem", "BatchedShardProblem",
    "register", "unregister", "make", "available", "as_fista_options",
    "carry_shards", "LogRegProblem", "LassoProblem", "SVMProblem",
    "SoftmaxProblem", "LogRegL2Problem",
]
