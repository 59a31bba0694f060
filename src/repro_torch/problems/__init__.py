"""Workload registry of the port: the problems the scheduler can drive.

    from repro_torch import problems
    problems.available()   # ['double_ml', 'lasso', 'logreg', 'logreg_l2',
                           #  'newton_sketch', 'softmax', 'svm']
    p = problems.make("svm", device="cpu")
"""
from repro_torch.problems.base import (BatchedShardProblem, FistaShardProblem,
                                       WorkerProblem, as_fista_options,
                                       available, carry_shards, make,
                                       register, unregister)
from repro_torch.problems.double_ml import DoubleMLProblem, double_ml_dag
from repro_torch.problems.lasso import LassoProblem
from repro_torch.problems.logreg import LogRegProblem
from repro_torch.problems.newton_sketch import (LogRegL2Problem,
                                                NewtonSketchProblem,
                                                RoundMessages)
from repro_torch.problems.softmax import SoftmaxProblem
from repro_torch.problems.svm import SVMProblem

__all__ = [
    "WorkerProblem", "FistaShardProblem", "BatchedShardProblem",
    "register", "unregister", "make", "available", "as_fista_options",
    "carry_shards", "LogRegProblem", "LassoProblem", "SVMProblem",
    "SoftmaxProblem", "LogRegL2Problem", "NewtonSketchProblem",
    "RoundMessages", "DoubleMLProblem", "double_ml_dag",
]
