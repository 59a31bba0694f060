"""Carry the JAX package's parameters across to the port.

``params_from_jax`` takes the reference's ``init_params`` pytree (nested
dicts of arrays, layers stacked along a leading axis) and returns the
port's tree, which has the same structure and the same ``x @ w``
orientation: nothing is transposed.  Every leaf is checked against
``model.param_shapes``; a leaf the dense family does not have, or one that
is missing or misshapen, raises.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models import model as model_mod


def params_from_jax(tree, cfg, *, device="cuda", dtype=None):
    """The reference's parameters (arrays of any kind that numpy reads) as
    the port's tensors on ``device``, in ``dtype`` (default ``cfg.dtype``)."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = layers.dtype_of(cfg)
    elif isinstance(dtype, str):
        dtype = layers.DTYPES[dtype]
    spec = model_mod.param_shapes(cfg)

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
                                 f"{cfg.family} family's tree, {missing} are "
                                 f"missing")
            return {k: walk(node[k], shapes[k], path + (k,)) for k in shapes}
        arr = np.asarray(node)
        if arr.shape != tuple(shapes):
            raise ValueError(f"{where}: shape {arr.shape}, expected "
                             f"{tuple(shapes)}")
        host = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        return host.to(device=dev, dtype=dtype)

    return walk(tree, spec, ())
