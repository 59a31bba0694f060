"""The paper's own workload: l1-penalized logistic regression (Section III).

N=600000 samples, d=10000 features, density p=0.001, lambda1=1,
labels +-1 w.p. 0.5, nonzero values ~ N(nu, 1) with nu ~ U[0,1] (or U[-1,0]),
generated per Koh-Kim-Boyd (JMLR'07).  ADMM: eps_r = eps_s = 2e-2, K=100,
rho0=1; FISTA: eps_g=1e-2, eps_f=1e-12, K_w in {1 (nonuniform), 50 (uniform)}.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LogRegConfig:
    n_samples: int = 600_000
    n_features: int = 10_000
    density: float = 0.001
    lam1: float = 1.0
    rho0: float = 1.0
    max_admm_iters: int = 100
    eps_primal: float = 2e-2
    eps_dual: float = 2e-2
    fista_min_iters: int = 1      # K_w: 1 = nonuniform load, 50 = uniform load
    fista_max_iters: int = 500
    eps_grad: float = 1e-2
    eps_fval: float = 1e-12
    seed: int = 0


CONFIG = LogRegConfig()


def scaled(n_samples: int, n_features: int, **kw) -> LogRegConfig:
    """Smaller instance of the same problem family (tests / examples)."""
    return dataclasses.replace(CONFIG, n_samples=n_samples, n_features=n_features, **kw)
