"""Meshes (a port of ``repro/launch/mesh.py``) and the card's constants.

``make_production_mesh`` and ``make_host_mesh`` are functions, so importing
this module touches no process group and no device.

Mesh geometry, the reference's, on which the sharding rules' divisibility
is defined:
  single pod : (16, 16)    axes ("data", "model")          = 256 GPUs
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model")   = 512 GPUs

The "data" axis is the paper's serverless worker pool; "model" is tensor
parallelism inside one worker; "pod" extends the worker pool across a
slower boundary.  On H100s a 16-wide "model" axis spans two 8-GPU NVLink
nodes, so its collectives cross the nodes' network for part of the ring:
the one NVLink figure below is optimistic for that axis (recorded, not
redesigned).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import MeshShape

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTI_POD_SHAPE, MULTI_POD_AXES = (2, 16, 16), ("pod", "data", "model")

# Hardware constants for the roofline terms, per GPU: NVIDIA H100 80GB
# HBM3, 700 W, datasheet (SXM part, dense rates without sparsity)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
HBM_PER_CHIP = 80e9               # B
LINK_BW = 450e9                   # B/s, NVLink 4, one direction


def production_shape(multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(MULTI_POD_AXES, MULTI_POD_SHAPE)
    return MeshShape(POD_AXES, POD_SHAPE)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: a CPU ``DeviceMesh`` over the default process
    group when one of the mesh's size exists (the dry-run's fake group),
    else its ``MeshShape`` (enough for the sharding rules)."""
    shape = production_shape(multi_pod)
    if dist.is_initialized() and dist.get_world_size() == shape.size:
        return init_device_mesh("cpu", shape.sizes,
                                mesh_dim_names=shape.axis_names)
    return shape


def make_host_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A ("data", "model") ``DeviceMesh`` over the ranks there are, clamped
    as the reference clamps to its devices: a 1x1 mesh on one card.  With
    no process group it starts one of one rank (nccl on the card, gloo on
    the CPU), which ``close_host_mesh`` ends.  Raises on a missing card."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh does not cover the "
                         f"{n} ranks of the process group")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def close_host_mesh() -> None:
    """End the process group ``make_host_mesh`` started (if any)."""
    if dist.is_initialized():
        dist.destroy_process_group()
