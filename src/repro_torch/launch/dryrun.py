"""Production-mesh dry-run: build and run every (arch x shape x mesh x
mode) cell on rank 0 of a fake process group, with fake tensors (a port of
``repro/launch/dryrun.py``).

The reference sets ``XLA_FLAGS`` for 512 host devices and compiles each
cell; here ``main`` first starts a ``"fake"`` process group of 256 (pod)
or 512 (multi-pod) ranks, whose collectives return at once, and then runs
each cell's step once on rank 0 with DTensors of ``meta`` tensors on a CPU
mesh: every tensor has its shape, dtype and placements and no memory.
(Meta and not ``FakeTensorMode``: the same step ran about 4x slower on
fake tensors, and ``op_analysis`` leaves fake tensors to DTensor's shape
propagation.)  Run it in a process of its own (the group lives as long as
the process).

For every cell the dry-run:
  1. builds the sharded step (``launch/steps.build_step``),
  2. places its meta arguments by its specs and runs it once
     (``lower_step(...).cost``) — success proves the distribution config is
     coherent for DTensor (placements consistent, shapes divide, every
     operator has a sharding rule),
  3. counts rank 0's FLOPs, bytes, collectives and peak live bytes
     (``launch/op_analysis.py``) and derives the three roofline terms on
     the H100's constants (``launch/mesh.py``),
  4. writes a JSON record under ``experiments/dryrun_torch/``; a cell whose
     step DTensor cannot run is recorded as ``status: "error"`` with its
     traceback.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_8b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun   # every cell
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

from repro_torch.configs import (ARCH_IDS, LM_SHAPES, cell_is_applicable,
                                 get_config, get_shape)
from repro_torch.launch.mesh import (HBM_BW, HBM_PER_CHIP, LINK_BW,
                                     PEAK_FLOPS_BF16, make_production_mesh,
                                     production_shape)
from repro_torch.launch.steps import build_step, default_modes, lower_step
from repro_torch.parallel.sharding import MeshShape

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def start_fake_group(world_size: int) -> None:
    """A ``"fake"`` process group of ``world_size`` ranks, this process
    rank 0 (the counterpart of the reference's ``XLA_FLAGS`` lines)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def roofline_terms(summary: dict, cfg, meta: dict) -> dict:
    t_compute = summary["flops_per_chip"] / PEAK_FLOPS_BF16
    t_memory = summary["bytes_per_chip"] / HBM_BW
    t_coll = summary["per_chip_link_bytes"] / LINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    # MODEL_FLOPS: 6·N·D for a train step over D tokens (3 fwd-equivalents);
    # 2·N_active·D for inference (fwd only)
    n_active = cfg.active_param_count()
    tokens = meta.get("tokens", 0)
    if meta["mode"] in ("sgd", "admm"):
        model_flops = 6.0 * n_active * tokens
    else:
        model_flops = 2.0 * n_active * tokens
    total = summary["flops_per_chip"] * meta["n_chips"]
    bound = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / total if total else 0.0,
        "roofline_bound_s": bound,
        "compute_fraction": t_compute / bound if bound else 0.0,
    }


def run_cell(arch: str, shape_name: str, mesh_name: str, mode: str, *,
             verbose: bool = True, save: bool = True, cfg=None) -> dict:
    """One cell; ``cfg`` overrides ``get_config(arch)`` (a reduced model in
    the tests).  Needs the fake group of the mesh's size
    (``start_fake_group``)."""
    import torch
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name)
    multi = mesh_name == "multipod"
    n_chips = production_shape(multi).size
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "mode": mode, "n_chips": n_chips, "status": ""}
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
        return _finish(record, save, verbose)
    mesh = make_production_mesh(multi_pod=multi)
    if isinstance(mesh, MeshShape):
        raise RuntimeError(f"no fake process group of {n_chips} ranks: call "
                           f"start_fake_group({n_chips}) first")
    bundle = build_step(cfg, shape, mesh, mode)
    if bundle is None:
        record.update(status="skipped",
                      reason="mode inapplicable on this mesh")
        return _finish(record, save, verbose)

    t0 = time.time()
    try:
        with torch.no_grad() if mode in ("prefill", "decode") \
                else torch.enable_grad():
            lowered = lower_step(bundle, mesh)
            t_place = time.time() - t0
            t0 = time.time()
            _, summary = lowered.cost(pod_ranks=256)
        t_run = time.time() - t0
    except Exception as e:           # recorded per cell, as the reference
        record.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                      traceback=traceback.format_exc()[-4000:])
        return _finish(record, save, verbose)

    meta = dict(bundle.meta, n_chips=n_chips)
    terms = roofline_terms(summary, cfg, meta)
    fits = summary["peak_bytes_est"] <= HBM_PER_CHIP
    record.update(status="ok", place_s=round(t_place, 1),
                  run_s=round(t_run, 1), fits_hbm=fits, meta=bundle.meta,
                  summary=summary, roofline=terms)
    if verbose:
        print(f"--- {arch} x {shape_name} x {mesh_name} x {mode} "
              f"({n_chips} ranks, rank 0 counted)")
        print("memory: peak %.3e B of %.3e (arguments %.3e)" % (
            summary["peak_bytes_est"], HBM_PER_CHIP, summary["arg_bytes"]))
        print("ops: flops=%.3e bytes=%.3e" % (
            summary["flops_per_chip"], summary["bytes_per_chip"]))
        print("collectives: %.3e link-B/rank over %d ops %s" % (
            summary["per_chip_link_bytes"], summary["n_collective_ops"],
            summary["by_type"]))
        print("roofline: compute=%.4fs memory=%.4fs collective=%.4fs "
              "dominant=%s useful=%.2f fits_hbm=%s" % (
                  terms["t_compute_s"], terms["t_memory_s"],
                  terms["t_collective_s"], terms["dominant"],
                  terms["useful_flops_ratio"], fits))
    return _finish(record, save, verbose=False)


def _finish(record: dict, save: bool, verbose: bool) -> dict:
    if verbose:
        print(f"--- {record['arch']} x {record['shape']} x {record['mesh']} "
              f"x {record['mode']}: {record['status']} "
              f"{record.get('reason', record.get('error', ''))}")
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        name = "{arch}__{shape}__{mesh}__{mode}.json".format(**record)
        (OUT_DIR / name).write_text(json.dumps(record, indent=1))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default=None, choices=("pod", "multipod"),
                    help="default: both")
    ap.add_argument("--mode", default=None,
                    choices=("sgd", "admm", "prefill", "decode"),
                    help="default: every mode the shape supports")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose JSON record already exists")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else [s.name for s in LM_SHAPES]
    meshes = [args.mesh] if args.mesh else ["pod", "multipod"]

    n_ok = n_skip = n_err = 0
    for mesh_name in meshes:
        start_fake_group(production_shape(mesh_name == "multipod").size)
        for arch in archs:
            for shape_name in shapes:
                modes = ([args.mode] if args.mode
                         else default_modes(get_shape(shape_name)))
                for mode in modes:
                    out = OUT_DIR / (f"{arch}__{shape_name}__{mesh_name}"
                                     f"__{mode}.json")
                    if args.skip_existing and out.exists():
                        continue
                    rec = run_cell(arch, shape_name, mesh_name, mode,
                                   save=not args.no_save)
                    n_ok += rec["status"] == "ok"
                    n_skip += rec["status"] == "skipped"
                    n_err += rec["status"] == "error"
    print(f"\n== dry-run done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
