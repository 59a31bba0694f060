"""End-to-end LM training driver (a port of ``repro/launch/train.py``):
consensus ADMM (the paper's technique) or conventional data-parallel
AdamW, with checkpoint/restart, on the card (``--device cuda``, the
default) or on the CPU.

The reference's flags and defaults, plus ``--device``.  As in the
reference, no learning-rate schedule is applied (it builds a
warmup-cosine one and never uses it), so the port prints the reference's
losses.

Examples:
  python -m repro_torch.launch.train --arch granite_8b --mode admm --steps 50
  python -m repro_torch.launch.train --device cpu --preset tiny --steps 4
  python -m repro_torch.launch.train --arch stablelm_3b --mode sgd \\
      --steps 200 --preset 100m --checkpoint-dir ck --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import trainer as trainer_mod
from repro_torch.data import lm as lm_data
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.optim import optimizers as opt_mod

PRESETS = {
    # ~100M-parameter config for the end-to-end example
    "100m": dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
                 d_ff=2048, vocab_size=32_000, head_dim=64, dtype="float32"),
    # CPU-friendly default
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 d_ff=128, vocab_size=512, head_dim=16, dtype="float32"),
}


def build_cfg(args):
    cfg = get_config(args.arch)
    if args.preset == "full":
        return cfg
    if args.preset == "tiny":
        return reduced(cfg)
    return dataclasses.replace(reduced(cfg), **PRESETS[args.preset])


def main(argv=None, *, state=None, params=None):
    """Train and return the final ``ConsensusState`` (admm) or parameters
    (sgd).  ``state`` (admm) or ``params`` (sgd), e.g. carried across from
    the reference by ``models/convert.py``, replace the random start; they
    are updated in place."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm_3b")
    ap.add_argument("--mode", choices=("admm", "sgd"), default="admm")
    ap.add_argument("--preset", choices=("tiny", "100m", "full"),
                    default="tiny")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workers", type=int, default=4,
                    help="ADMM consensus workers")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--rho", type=float, default=0.01)
    ap.add_argument("--prox", choices=("none", "l1", "l2sq"), default="none")
    ap.add_argument("--lam", type=float, default=1e-5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build_cfg(args)
    shape = ShapeConfig("train_cli", args.seq, args.batch, "train")
    dcfg = lm_data.LMDataConfig(seed=args.seed)
    n_params_cfg = cfg.param_count()
    print(f"[train] arch={args.arch} preset={args.preset} mode={args.mode} "
          f"params≈{n_params_cfg/1e6:.1f}M tokens/step={args.batch*args.seq}")

    ckpt = (CheckpointManager(args.checkpoint_dir, async_save=True)
            if args.checkpoint_dir else None)
    resume = (args.resume and args.checkpoint_dir
              and latest_step(args.checkpoint_dir) is not None)
    # no lr schedule is applied: the reference builds a warmup-cosine one
    # and never passes it to the optimizer
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    if args.mode == "admm":
        W = args.workers
        if args.batch % W:
            raise ValueError("--batch must divide by --workers")
        ccfg = trainer_mod.ConsensusConfig(
            n_workers=W, local_steps=args.local_steps, rho0=args.rho,
            prox=args.prox, lam=args.lam,
            optimizer=opt_mod.AdamWConfig(lr=args.lr, weight_decay=0.0))
        if state is None:
            state = trainer_mod.init_state(cfg, ccfg, generator=gen,
                                           device=dev)
        start = 0
        if resume:
            state, meta = ckpt.restore_latest(state)
            start = meta["step"]
            print(f"[train] resumed from step {start}")
        step_fn = trainer_mod.make_round_step(cfg, ccfg)

        for k in range(start, args.steps):
            t0 = time.time()
            gb = lm_data.batch_for(cfg, shape, k, dcfg, device=dev)
            batch = {kk: v.reshape((W, args.batch // W) + v.shape[1:])
                     for kk, v in gb.items()}
            state, m = step_fn(state, batch)
            if k % args.log_every == 0:
                print(f"round {k:4d} loss={float(m['loss']):.4f} "
                      f"r={float(m['r_norm']):.3f} s={float(m['s_norm']):.3f} "
                      f"rho={float(m['rho']):.4f} [{time.time()-t0:.2f}s]")
            if ckpt and (k + 1) % args.checkpoint_every == 0:
                ckpt.save(state, k + 1, {"step": k + 1, "mode": "admm"})
        if ckpt:
            ckpt.save(state, args.steps, {"step": args.steps, "mode": "admm"})
            ckpt.wait()
        return state

    # -- sgd -----------------------------------------------------------------
    if params is None:
        params = model_mod.init_params(cfg, generator=gen, device=dev)
    opt = opt_mod.adamw_init(params)
    start = 0
    if resume:
        (params, opt), meta = ckpt.restore_latest((params, opt))
        start = meta["step"]
        print(f"[train] resumed from step {start}")
    tcfg = trainer_mod.SgdTrainConfig(opt_mod.AdamWConfig(lr=args.lr))
    step_fn = trainer_mod.make_sgd_step(cfg, tcfg)

    for k in range(start, args.steps):
        t0 = time.time()
        batch = lm_data.batch_for(cfg, shape, k, dcfg, device=dev)
        params, opt, m = step_fn(params, opt, batch)
        if k % args.log_every == 0:
            print(f"step {k:4d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} [{time.time()-t0:.2f}s]")
        if ckpt and (k + 1) % args.checkpoint_every == 0:
            ckpt.save((params, opt), k + 1, {"step": k + 1, "mode": "sgd"})
    if ckpt:
        ckpt.save((params, opt), args.steps, {"step": args.steps, "mode": "sgd"})
        ckpt.wait()
    return params


if __name__ == "__main__":
    main()
