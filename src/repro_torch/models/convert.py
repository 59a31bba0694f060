"""Carry the JAX package's parameters and training state across to the
port.

``params_from_jax`` takes the reference's ``init_params`` pytree (nested
dicts of arrays, layers stacked along a leading axis) and returns the
port's tree, which has the same structure and the same ``x @ w``
orientation: nothing is transposed.  Every leaf is checked against
``model.param_shapes``; a leaf the dense family does not have, or one that
is missing or misshapen, raises.  ``state_from_jax`` carries the trainer's
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
from repro_torch.models import layers
from repro_torch.models import model as model_mod


def params_from_jax(tree, cfg, *, device="cuda", dtype=None):
    """The reference's parameters (arrays of any kind that numpy reads) as
    the port's tensors on ``device``, in ``dtype`` (default ``cfg.dtype``)."""
    if dtype is None:
        dtype = layers.dtype_of(cfg)
    elif isinstance(dtype, str):
        dtype = layers.DTYPES[dtype]
    return _carry(tree, model_mod.param_shapes(cfg), resolve_device(device),
                  dtype)


def _carry(tree, spec, dev, dtype, lead=()):
    """``tree`` checked against the shapes ``spec`` (each prefixed by
    ``lead``) and moved to ``dev`` in ``dtype``."""
    def walk(node, shapes, path):
        where = "/".join(path) or "<root>"
        if isinstance(shapes, dict):
            if not isinstance(node, Mapping):
                raise ValueError(f"{where}: expected a dict of "
                                 f"{sorted(shapes)}, got {type(node).__name__}")
            unknown = sorted(set(node) - set(shapes))
            missing = sorted(set(shapes) - set(node))
            if unknown or missing:
                raise ValueError(f"{where}: leaves {unknown} are not in the "
                                 f"dense family's tree, {missing} are "
                                 f"missing")
            return {k: walk(node[k], shapes[k], path + (k,)) for k in shapes}
        arr = np.asarray(node)
        if arr.shape != tuple(lead) + tuple(shapes):
            raise ValueError(f"{where}: shape {arr.shape}, expected "
                             f"{tuple(lead) + tuple(shapes)}")
        host = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        return host.to(device=dev, dtype=dtype)

    return walk(tree, spec, ())


def _scalar(value, dtype, dev):
    return torch.tensor(np.asarray(value).item(), dtype=dtype, device=dev)


def _adamw_state(opt, spec, dev, lead=()):
    f32 = torch.float32
    return {"m": _carry(opt["m"], spec, dev, f32, lead),
            "v": _carry(opt["v"], spec, dev, f32, lead),
            "step": _scalar(opt["step"], torch.int32, dev)}


def state_from_jax(state, cfg, *, device="cuda"):
    """The reference trainer's ``ConsensusState`` (its fields arrays of any
    kind that numpy reads) as the port's ``core.trainer.ConsensusState``
    on ``device``: x and z in ``cfg.dtype``, u and the moments float32,
    rho and the residuals float32 scalars, the round and step int32."""
    dev = resolve_device(device)
    spec = model_mod.param_shapes(cfg)
    lead = np.shape(state.x["final_norm"])[:1]
    dtype, f32 = layers.dtype_of(cfg), torch.float32
    return ConsensusState(
        x=_carry(state.x, spec, dev, dtype, lead),
        u=_carry(state.u, spec, dev, f32, lead),
        z=_carry(state.z, spec, dev, dtype),
        opt=_adamw_state(state.opt, spec, dev, lead),
        rho=_scalar(state.rho, f32, dev),
        r_norm=_scalar(state.r_norm, f32, dev),
        s_norm=_scalar(state.s_norm, f32, dev),
        round=_scalar(state.round, torch.int32, dev))


def sgd_state_from_jax(pair, cfg, *, device="cuda"):
    """The baseline's ``(params, adamw_state)`` pair as the port's."""
    params, opt = pair
    dev = resolve_device(device)
    return (_carry(params, model_mod.param_shapes(cfg), dev,
                   layers.dtype_of(cfg)),
            _adamw_state(opt, model_mod.param_shapes(cfg), dev))
