"""Global-variable-consensus ADMM options and the penalty rule (Eqs. 5-7 /
Algorithms 1-2 of the paper).

The event-driven scheduler (``repro_torch.runtime.scheduler``) drives the
per-worker and master math itself; this module holds what it shares with
any other driver: the options and Boyd's residual-balancing rule.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.fista import FistaOptions


@dataclasses.dataclass(frozen=True)
class AdmmOptions:
    rho0: float = 1.0
    max_iters: int = 100          # K
    eps_primal: float = 2e-2      # eps_r
    eps_dual: float = 2e-2        # eps_s
    # penalty adaptation (Boyd §3.4.1, the paper's rule)
    mu: float = 10.0
    tau_inc: float = 2.0
    tau_dec: float = 2.0
    fista: FistaOptions = FistaOptions()


def new_penalty(rho, r_norm: float, s_norm: float,
                opts: AdmmOptions) -> np.float32:
    """Boyd §3.4.1 residual-balancing rule (the paper's new_penalty), in
    float32 like the reference's ``new_penalty(jnp.float32(rho), ...)``.

    When rho changes, every worker's SCALED dual must be rescaled,
    u <- u * (rho_old / rho_new) (Boyd §3.4.1): u = y/rho, and it is y,
    not u, that is the persistent dual."""
    rho = np.float32(rho)
    if r_norm > opts.mu * s_norm:
        return rho * np.float32(opts.tau_inc)
    if s_norm > opts.mu * r_norm:
        return rho / np.float32(opts.tau_dec)
    return rho
