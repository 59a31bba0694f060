"""Carry the JAX package's parameters and training state across to the
port.

``params_from_jax`` takes the reference's ``init_params`` pytree (nested
dicts of arrays, layers stacked along a leading axis) and returns the
port's tree, which has the same structure and the same ``x @ w``
orientation: nothing is transposed.  Every leaf is checked against
``model.param_specs`` and takes its dtype from there (``cfg.dtype``, or
float32 for the leaves the reference keeps in float32 in any model); a
leaf the config's family does not have, or one that is missing or
misshapen, raises.  ``state_from_jax`` carries the trainer's
``ConsensusState`` (worker copies, duals, z, AdamW state, rho, residuals,
round) and ``sgd_state_from_jax`` the baseline's ``(params, opt)`` pair,
with the same checks, so that both packages can start from one state.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.trainer import ConsensusState
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod


def params_from_jax(tree, cfg, *, device="cuda"):
    """The reference's parameters (arrays of any kind that numpy reads) as
    the port's tensors on ``device``, each leaf in its dtype."""
    return _carry(tree, cfg, resolve_device(device))


def _carry(tree, cfg, dev, dtype=None, lead=()):
    """``tree`` checked against ``cfg``'s parameter specs (each shape
    prefixed by ``lead``) and moved to ``dev``, in ``dtype`` or, when it is
    None, in each leaf's own dtype."""
    def walk(node, spec, path):
        where = "/".join(path) or "<root>"
        if isinstance(spec, dict):
            if not isinstance(node, Mapping):
                raise ValueError(f"{where}: expected a dict of "
                                 f"{sorted(spec)}, got {type(node).__name__}")
            unknown = sorted(set(node) - set(spec))
            missing = sorted(set(spec) - set(node))
            if unknown or missing:
                raise ValueError(f"{where}: leaves {unknown} are not in the "
                                 f"{cfg.family} family's tree, {missing} "
                                 f"are missing")
            return {k: walk(node[k], spec[k], path + (k,)) for k in spec}
        arr = np.asarray(node)
        if arr.shape != tuple(lead) + tuple(spec.shape):
            raise ValueError(f"{where}: shape {arr.shape}, expected "
                             f"{tuple(lead) + tuple(spec.shape)}")
        host = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        return host.to(device=dev, dtype=dtype or spec.dtype)

    return walk(tree, model_mod.param_specs(cfg), ())


def _scalar(value, dtype, dev):
    return torch.tensor(np.asarray(value).item(), dtype=dtype, device=dev)


def _adamw_state(opt, cfg, dev, lead=()):
    f32 = torch.float32
    return {"m": _carry(opt["m"], cfg, dev, f32, lead),
            "v": _carry(opt["v"], cfg, dev, f32, lead),
            "step": _scalar(opt["step"], torch.int32, dev)}


def state_from_jax(state, cfg, *, device="cuda"):
    """The reference trainer's ``ConsensusState`` (its fields arrays of any
    kind that numpy reads) as the port's ``core.trainer.ConsensusState``
    on ``device``: x and z in the parameters' dtypes, u and the moments
    float32, rho and the residuals float32 scalars, the round and step
    int32."""
    dev = resolve_device(device)
    lead = np.shape(state.x["final_norm"])[:1]
    f32 = torch.float32
    return ConsensusState(
        x=_carry(state.x, cfg, dev, lead=lead),
        u=_carry(state.u, cfg, dev, f32, lead),
        z=_carry(state.z, cfg, dev),
        opt=_adamw_state(state.opt, cfg, dev, lead),
        rho=_scalar(state.rho, f32, dev),
        r_norm=_scalar(state.r_norm, f32, dev),
        s_norm=_scalar(state.s_norm, f32, dev),
        round=_scalar(state.round, torch.int32, dev))


def sgd_state_from_jax(pair, cfg, *, device="cuda"):
    """The baseline's ``(params, adamw_state)`` pair as the port's."""
    params, opt = pair
    dev = resolve_device(device)
    return _carry(params, cfg, dev), _adamw_state(opt, cfg, dev)
