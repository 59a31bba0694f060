#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --phases 1,2,5  # the kernels and serving only
    python3 chip_smoke.py --phases 1,2,6  # the kernels and svm at size
    python3 chip_smoke.py --phases 1,2,7  # the kernels and the cluster
    python3 chip_smoke.py --phases 1,8    # the second-order path at size
    python3 chip_smoke.py --phases 1,9    # LM training
    python3 chip_smoke.py --phases 1,11   # the sharded steps and dry-run
    python3 chip_smoke.py --phases 1,12   # training the other families
    python3 chip_smoke.py --phases 1,13   # decode over slot shards
    python3 chip_smoke.py --phases 1,14   # the example twins
    python3 chip_smoke.py --src OTHER/src # time another checkout's ADMM
                                          # kernels, nothing else

Phases, one line or a few each (any failure exits non-zero; nothing is
caught):
  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, the kernels' build time and ptxas's registers and
     spills (the margin kernel must not spill);
  2. kernel parity: each CUDA kernel against its plain PyTorch version on
     the card, on small ragged shapes (for the margin kernel: ranges that
     cross lanes, ragged rows and columns, a 4-block cluster) and at the
     main paths' shapes, each margin and z-update call bitwise equal on a
     second call, with the kernel's, the plain version's, the bound's
     and a yardstick's times (scaled_dot_product_attention for attention,
     one cuBLAS read of A for the margin kernel, an empty kernel for the
     z-update); the flash kernel's causal=False instantiation on small
     ragged shapes (Skv != S, off the key tiles) and at the VLM's
     cross-attention prefill (8, 2048 queries, 64 heads over 8, 128) over
     1 601 image tokens, against block_attention(causal=False) and
     cross_attention; and phase 10's attention shapes (granite_moe,
     musicgen and zamba2, the VLM's self-attention, mixtral's 4096 window
     over 4608 positions and its wrapped 4096-slot ring, the VLM's cross
     decode through the decode kernel over all 1 601 slots), each held and
     timed beside SDPA and its bound;
  3. small instances on the card: the engine suite's logreg instance
     against the reference's trace (ENGINE_ANCHOR), and the registry's
     default instance in float64 against the same run on the CPU and in
     float32 (both engines) against that float64 run; then svm, lasso,
     softmax and logreg_l2 at the engine suite's sizes, and logreg and
     svm under async_, topk and qsgd, each on the card and on the CPU;
     then, each on the card and on the CPU in float64: the engine
     instance with kernel="cuda" (the margin kernel in float32 under a
     float64 FISTA) against kernel="torch", a mixed cluster (4 lasso and
     2 logreg jobs of two tenants, fifo and drf, heap and scan: equal
     reports), double_ml (n=2048, p=32, K=4) under reservation="phase"
     and "peak" (theta-hat), and a 200-job Poisson replay from
     runtime.loadgen (equal reports); then newton_sketch (n=512, d=32,
     W=8) in float64 under sync, drop_slowest and replicated, flat and
     tree, card against CPU with the loop and batched engines bitwise
     equal, and bench_newton's configuration (float32): rounds to target
     of Newton (clean and straggling pools) and its ADMM twin, card against
     CPU, printed beside benchmarks/baselines/baselines.json's anchors;
  4. the logreg main path at the paper's size: N=600 000, d=10 000, W=64,
     the batched engine with kernel="cuda", through ``api.run``, with the
     margin and z-update kernels' launch counts read around that run;
     then the same rounds twice with kernel="torch" (the plain sparse
     path, summed in a fixed order: its two runs must agree bit for bit)
     as the witness, and a control with the last 1% of each lane's rows
     masked out;
  5. serving: reduced granite_8b in float32 (2 layers, full and windowed
     attention) on the card against the same run on the CPU, then
     granite_8b at full width and depth in bfloat16 through
     ``repro_torch.launch.serve.main`` (batch 8, prompt 2048, 64 tokens),
     with the attention kernels' launch counts read around that run, and
     prefill-then-decode held against a prefill over the longer prompt, in
     bfloat16 and, at full width and depth too, in float32;
  6. svm at the paper's size: phase 4's data and fleet under the smoothed
     hinge, through ``api.run`` on the margin kernel's hinge instantiation
     and the z-update, with its witness and control as in phase 4, and
     the peak device memory;
  7. the multi-tenant cluster at the paper's size: four jobs of two
     tenants at t = 0 on one Cluster (policy drf, 2 job slots, 128
     workers, one shared warm pool): alice runs phase 4's logreg spec
     twice, bob phase 6's svm spec twice, each job on a pool seed of its
     own, over one logreg and one svm instance shared by each tenant's
     jobs (svm on logreg's rows); under the heap engine, then the scan
     engine, with each job's rounds held bit for bit to its solo run
     (phase 4's or 6's when they ran, else run here), heap's report to
     scan's, the margin launches to the sum of the jobs' own, and the
     peak device memory under 80 GB;
  8. the second-order path at the paper's size: newton_sketch on phase
     4's rows (generated here when phase 4 did not run), W=64, the
     batched engine, 3 rounds through ``api.run`` under sync, replicated
     (r = 2) and sync again, all three bitwise equal; each round's wall
     split into sketch, Grams and coding, decode, float64 solve and line
     search beside each part's bound; r_norm falling and Armijo accepting
     in every round; no ADMM kernel launched; peak device memory under 60
     GB and no device-to-host copy over 1 MiB (the profiler's record of
     the third run); the decoded Hessians of rounds 1 and 3 against a
     float64 oracle of the full stack, with a control (one block dropped
     without the code) that must miss the limit by over 100x;
  9. consensus-ADMM LM training (``core/trainer.py``): (a) reduced
     granite_8b in float32, W=4, K=2, prox l1, 3 rounds, on the card
     against the CPU from one state, with the z-update launched once per
     leaf per round, the flash kernel never, every leaf's gradient
     nonzero, and a repeat on the card bit for bit; then the same in
     bf16 at d_model 256, W=2, K=4, held by relative L2 gaps; (b)
     granite_8b at full width in bf16 with its depth cut to 4 layers,
     W=2, K=4, batch 8 x 1024 tokens, remat, 3 rounds: rounds 1 and 3
     timed as they run (wall, tokens/s), round 2 under a timing spy that
     splits it into local forward+backward (TFLOP/s against the bf16
     peak), augmented gradients, Adam, dual ascent, consensus mean,
     z-update (its launches) and the rest, and keeps the z-update's
     inputs on the two largest leaf sizes, held against its plain version
     after the round; peak memory and nnz(z)/P; the loss must fall; then
     3 AdamW baseline steps at the same config; (c)
     ``launch.train.main --preset 100m``, 4 rounds straight equal to 2
     rounds and ``--resume`` for 2 more, bit for bit, for admm and sgd;
  10. the other LM families: (a) the reduced configs of granite_moe,
     musicgen, zamba2, rwkv6, the VLM and mixtral in float32 (weights drawn
     once on the CPU with every all-zero leaf drawn anew: the VLM's gates,
     RWKV6's lora_b), prefill and 4 greedy decode steps on the card
     against the CPU (logits, tokens, every MoE routing's experts) and a
     repeat on the card bit for bit; (b) each at full width in bf16
     through ``repro_torch.launch.serve.main`` (batch 8, prompt 2048, 64
     tokens): granite_moe_3b_a800m at full depth (capacity factor 1.25,
     groups of 512: its drop share), musicgen_large (48 layers),
     zamba2_1_2b (38 mamba blocks, 6 shared-attention applications),
     rwkv6_1_6b (24 layers), llama3_2_vision_90b cut to one group (4 self,
     1 cross block over 1 601 image tokens), mixtral_8x7b cut to 2 of 32
     layers (batch 4, prompt 4608: its 4096-slot ring wraps); prefill s,
     decode ms a step eager and one step's device time, the attention
     launches against the config's own count (cross launches apart), peak
     memory; then prefill-then-decode against a longer prefill in bf16
     and, as the witness, in float32 (the MoE models at a dropless
     capacity factor), each with a control one position off that must
     miss the limit;
  11. mesh, sharding and the dry-run (``launch/{mesh,steps,op_analysis,
     dryrun}.py``): (a) granite_8b at full width and depth in bf16 through
     ``build_step(..., "prefill")`` (B=8, prompt 2048) and 8 ``"decode"``
     steps on ``make_host_mesh()`` (1x1 on the card), logits and greedy
     tokens bit for bit equal to ``model.prefill`` / ``decode_step`` on the
     same weights, with a control one position off that must differ, and
     the attention launches (36 flash, 36 x 8 decode); (b) one ADMM round
     through ``build_step(..., "admm")`` at phase 9's cut (4 layers, batch
     8 x 1024, K=4, l1; W=1) bit for bit equal to ``make_round_step`` at
     W=1 (metrics and every leaf), one z-update launch per leaf; (c) for
     (a)'s prefill, one decode step and (b)'s round: the op counter's FLOPs
     and bytes, the CUDA-event median, the roofline terms on the H100's
     datasheet, the achieved share and the useful-FLOPs ratio, prefill's
     counted FLOPs within [1.0, 1.1] of the analytic count; (d) the
     dry-run of granite_8b x {train_4k sgd, train_4k admm, decode_32k} on
     the (16, 16) mesh, each cell a process of its own on the CPU, all
     started together after (c), each "ok" and within 80e9 B a rank;
  12. card training of the moe, hybrid, ssm and audio families: (a) the
     reduced configs of granite_moe, zamba2, rwkv6 and musicgen in
     float32 and in bf16 at phase 9a's settings, on the card against the
     CPU from one state and again on the card bit for bit, with the
     z-update launched once per leaf per round, held at phase 9a's
     limits (zamba2 and rwkv6, whose chunked scans miss them, at fixed
     wider ones, with a control, the scan's decay nudged, that must miss
     those); in float32 the loss's gradients card against CPU at fixed
     limits (for the scan families with such a control); then one moe_ff
     backward at granite_moe's full layer width with drops (512 tokens
     sharing a direction) in float32, card against CPU, and a second card
     pass bit for bit; (b) each at full width in bf16 at phase 9b's
     settings, its depth cut (granite_moe 11 of 32 layers, zamba2 12 of
     38, rwkv6 2 of 24, musicgen 12 of 48): 3 rounds, each's wall and
     tokens/s, the first chunked scan's inputs of round 1 held in float32
     card against CPU (output, final state, input gradients; a control),
     round 2 under the timing spy (dual ascent, value_and_grads, augment,
     Adam, consensus mean, z-update, rescale) and, for granite_moe, the
     drop share of its training batches; the z-update kernel timed on
     the two largest leaf sizes against its byte bound and held against
     its plain version on round 2's inputs; peak memory; the loss lower
     after the third round than after the first; then rounds 1-2 again
     from the same seed, z and the metrics bit for bit;
  13. decode over a cache whose slot axis is split (the decode kernel's
     partial mode, ``models/attention.combine_partials``, rule "decode" of
     ``parallel/shards.py``): (a) in one process, phase 2's decode shape
     (8, 2112, 32, 8, 128) in bf16 and float32 under two position sets
     that leave shards with no live slot, and mixtral's wrapped 4096-slot
     ring, each cut into 2, 4 and 16 shards: each shard's (o, m, l) from
     the kernel held against the plain partial (an empty shard exactly
     (0, -1e30, 0)), the shards combined by a local reduction and held
     against the whole-cache kernel and the plain decode, a control (the
     ring without its last shard) that must miss; one partial launch timed
     at decode_32k's per-rank shape (8 sequences, 2048 of 32768 slots)
     beside the whole-cache kernel on the same slots, the plain partial and
     its byte bound; (b) four processes on the one card (gloo on CUDA
     tensors, a 1x4 mesh): granite_8b's decode attention at full width
     over a 4096-slot cache split 4 ways through ``ops.decode_attention``
     on DTensors (bf16 with ranks 2 and 3 holding no live slot, float32
     with rows ending on the ranks' edges, mixtral's wrapped ring), each
     process's output held against the whole-cache kernel and the plain
     decode, one partial launch and the combine's two all-reduces a
     process and no all-gather (this machine's gloo crashes on the
     functional all-gather of CUDA tensors, so a whole sharded decode
     step cannot run here; the four-rank CPU test runs it);
  14. the README's example entry points, ``examples/*_torch.py``: (a)
     the four first-order twins (quickstart, cost_aware, elastic_faults,
     double_ml) with their problems in float64 on the card and on the CPU,
     and as written (float32) on the card, in six processes of their
     own beside the LM twins, the float64 outputs and records equal
     (residuals at F64_RTOL; inner counts, respawns, clock, bill, the
     autoscaler's decisions, the provider's counts; double_ml's theta-hat
     at DML_THETA_RTOL), the float32 outputs printed; the serve twin
     (mixtral_8x7b's tiny preset, and rwkv6_1_6b) with the CPU's sample
     ids; the train twin's --quick against the CPU, and its default (the
     100m preset) 4 rounds straight against 2 and --resume 2, bit for
     bit; (b) alone on the card after (a), the examples' regimes on
     the paper's instance at W = 64 (TWIN_REGIMES: failures and
     lifetimes, replicated stragglers, async_, rescale 64 -> 32 -> 64 cold
     and warm, the per-job autoscaler, a checkpoint restored into a new
     scheduler) on the kernel path, each against the plain sparse path at
     phase 4's witness limits, with its walls, launches and peak memory;
     the respawned workers' regenerated shards and the 32-worker fleet's
     re-staged shards equal to those they replace; the restored run bit
     for bit against a straight run;
then the kernels line {"kernels": [...]} (when phases 2, 4, 5, 6, 7, 10
and 13 ran; each entry names the kernel's design in "body" and its
launches on each main path in "launches_by_phase", phase 9's, 11's,
12's and 14's among them when they ran; the flash kernel's causal=False
instantiation and the decode kernel's partial mode are entries of their
own) and the last line
{"ok": true, "device": {...}}.

It imports torch and the port only.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# (r_norm, s_norm, rho) per round of the JAX reference on the engine suite's
# logreg instance (tests/test_engine.py WORKLOADS["logreg"]), W=4, 6 rounds,
# pool seed 0, loop engine, partitionable threefry.  tests/test_torch_slice.py
# holds it against the live reference run; `python tests/test_torch_slice.py`
# prints it.
ENGINE_KW = dict(n_samples=50, n_features=24, density=0.2, lam1=0.05)
ENGINE_W = 4
ENGINE_ROUNDS = 6
ENGINE_ANCHOR = [
    (0.0, 2.293704032897949, 0.5),
    (2.4334540656155306, 1.389151930809021, 0.5),
    (1.6760951372875035, 1.103853702545166, 0.5),
    (0.9182787797773576, 0.8639368414878845, 0.5),
    (0.6755398445914991, 0.7042179703712463, 0.5),
    (0.5194663960985773, 0.5903111696243286, 0.5),
]
ANCHOR_RTOL = 2e-3          # tests/test_engine.py GOLDEN_RTOL["batched"]
# float32 against float64 on the registry's default instance: FISTA's
# stops there are decided by float32 rounding; on the CPU the port's two
# differ by up to 1.5e-2 in r_norm and s_norm over 10 rounds, and the
# reference's by 8.1e-2
F32_VS_F64_RTOL = 0.15
F64_RTOL = 1e-6             # the card's float64 run against the CPU's

# the paper's deployment (src/repro_torch/configs/logreg_paper.py)
PAPER_KW = dict(n_samples=600_000, n_features=10_000, density=0.001,
                lam1=1.0, fista=dict(min_iters=1, eps_grad=1e-2,
                                     eps_fval=1e-12, max_iters=500))
PAPER_W = 64
PAPER_ROUNDS = 2
# the kernel path against the plain sparse path (kernel="torch") on the
# paper instance, per round: relative gap of r_norm, s_norm and rho, and
# the |inner_mean| gap.  Both run float32 with other summation orders;
# the limits lie between the readings of sound runs and of a control
# (the last 1% of each lane's rows masked out) recorded in PERF.md
WITNESS_RTOL = 1e-3
WITNESS_INNER = 2.0
CONTROL_FRAC = 0.01
# phase 6: svm on the paper's data (Koh-Kim-Boyd, Section III) under the
# smoothed hinge of width 0.5 (src/repro_torch/problems/svm.py), same W,
# rounds and FISTA options as phase 4.  Its witness readings on an "NVIDIA
# H100 80GB HBM3, 700.00 W" support the same limits (PERF.md): sound
# 4.8e-5 to 3.1e-4 relative and 0.05 inner_mean, the control 8.2e-3 and
# 3.0.  The witness sums in a fixed order, so its two runs in a phase must
# agree bit for bit (a spread of exactly 0)
SVM_KW = dict(n_samples=600_000, n_features=10_000, density=0.001,
              lam1=1.0, smoothing=0.5, fista=PAPER_KW["fista"])
# the paper-size paths: phase -> (problem, kwargs, margin loss)
PAPER_PATHS = {4: ("logreg", PAPER_KW, "logistic"),
               6: ("svm", SVM_KW, "hinge")}

# the bound: H100 SXM peak memory rate, float32 rate and dense bf16
# tensor-core rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# parity: |kernel - plain| <= PARITY_RTOL * max(1, max|plain|), per output
PARITY_RTOL = 1e-5
# attention parity, per output row (one head's hd values at one position):
# |kernel - plain| / |plain| in L2, the plain version run in float32 on the
# same inputs.  float32: summation order only.  bf16: the kernels round P
# to bf16 before P.V (as the TPU kernels do) and round o to bf16, each a
# relative error of at most 2^-9 per element
ATTN_ROW_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
# q is drawn as 2 randn and k, v as randn / 2: scores with a std of about
# 1, so an output row is not a near-zero average of v
ATTN_Q_SCALE = 4.0

# the serving main path: granite_8b at full width and depth, bf16
SERVE_ARGV = ["--arch", "granite_8b", "--preset", "full", "--batch", "8",
              "--prompt-len", "2048", "--gen-len", "64"]
SERVE_B, SERVE_P, SERVE_GEN = 8, 2048, 64
# prefill-then-decode at full width and depth: the decode step's logits at
# position P against the last logits of a prefill over P + 1 tokens, by
# relative L2 over the batch's logits, and the share of rows with the same
# argmax.  float32 is the witness (summation order only); bf16 rounds the
# residual stream differently on the two paths in each of 36 layers.  The
# limits lie between the readings of sound runs and of a faulty control
# (the step one position on) recorded in PERF.md
SERVE_REL_L2 = {"float32": 1e-4, "bfloat16": 4e-2}
SERVE_SAME_ARGMAX = {"float32": 1.0, "bfloat16": 7 / 8}
# the reduced model on the card against the CPU, float32
REDUCED_RTOL = 1e-4


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_report(log: str):
    """(kernel, registers, spill line) for each entry function in nvcc's
    ``-Xptxas -v`` output."""
    out, fn, spill = [], None, ""
    for line in log.splitlines():
        line = line.strip()
        if line.startswith("ptxas info    : Function properties for "):
            fn = line.rsplit(" ", 1)[-1]
        elif "spill stores" in line:
            spill = line
        elif line.startswith("ptxas info    : Used ") and fn:
            out.append((fn, line.split()[4], spill))
            fn, spill = None, ""
    try:                                   # readable template names
        names = subprocess.run(["c++filt"], input="\n".join(
            f for f, _, _ in out), capture_output=True, text=True,
            check=True).stdout.split("\n")
        out = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                .removeprefix("void "), r, s)
               for n, (_, r, s) in zip(names, out)]
    except (OSError, subprocess.CalledProcessError):
        pass
    return out


def check_margin_spills(log: str) -> None:
    """Fail unless nvcc's output for logistic_vjp reports its
    ``margin_one_pass`` bodies and none of them spills.  The body keeps x
    and the gradient partial in registers: a spill would put its per-row
    work through local memory.  An output without the report (a library
    built without its .log beside it) fails too, since nothing was
    checked."""
    bodies = [(fn, spill) for fn, _, spill in ptxas_report(log)
              if "margin_one_pass" in fn]
    if not bodies:
        fail("nvcc's output for logistic_vjp holds no ptxas report of "
             "margin_one_pass, so its spills cannot be checked (remove "
             "build/torch_kernels to rebuild the library with its log)")
    spills = [fn for fn, spill in bodies
              if "0 bytes spill stores, 0 bytes spill loads" not in spill]
    if spills:
        fail(f"logistic_vjp spills in {spills}")


def median_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median device time of one call of ``fn``, each between its own pair
    of CUDA events.  For a call shorter than the host's launch cost this
    reads the launch cost: the eager time."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2]


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` with the host taken out: ``reps`` calls
    captured in one CUDA graph, replayed once between CUDA events.  For a
    launch-bound call, where ``median_ms`` reads the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want, name: str, rtol: float = PARITY_RTOL) -> float:
    err = float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0
    scale = max(1.0, float(want.double().abs().max()) if want.numel() else 0)
    if not math.isfinite(err) or err > rtol * scale:
        fail(f"{name}: max |kernel - plain| = {err:.3e} exceeds "
             f"{rtol:g} * {scale:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernel parity
# ---------------------------------------------------------------------------


def margin_inputs(torch, W, N, D, zero_lanes=(), seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((W, N, D), generator=g, device="cuda").mul_(0.3)
    b = torch.where(torch.rand((W, N), generator=g, device="cuda") < 0.5,
                    -1.0, 1.0)
    mask = (torch.rand((W, N), generator=g, device="cuda") < 0.8).float()
    mask[list(zero_lanes)] = 0.0
    x = torch.randn((W, D), generator=g, device="cuda") * 0.2
    return A, b, mask, x


def check_margin(torch, lv, ref, loss, A, b, mask, x, zero_lanes=(),
                 gamma=0.5):
    """The kernel against its plain version; all-zero-mask lanes exactly
    0, and a second call bitwise equal to the first."""
    f_k, g_k = lv.margin_vjp_cuda(A, b, mask, x, loss=loss, gamma=gamma)
    f_2, g_2 = lv.margin_vjp_cuda(A, b, mask, x, loss=loss, gamma=gamma)
    if loss == "logistic":
        f_p, g_p = ref.logistic_vjp_ref(A, b, mask, x)
    else:
        f_p, g_p = ref.svm_vjp_ref(A, b, mask, x, gamma)
    torch.cuda.synchronize()
    shape = tuple(A.shape)
    if not (torch.equal(f_k, f_2) and torch.equal(g_k, g_2)):
        fail(f"{loss} {shape}: a second call is not bitwise equal")
    for lane in zero_lanes:
        if float(f_k[lane]) != 0.0 or bool(torch.any(g_k[lane] != 0)):
            fail(f"{loss} {shape}: all-zero-mask lane {lane} is not "
                 f"exactly 0")
    return max(max_err(torch, f_k, f_p, f"{loss} loss {shape}"),
               max_err(torch, g_k, g_p, f"{loss} grad {shape}"))


def check_z_update(torch, st, ref, D, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    omega = torch.randn((D,), generator=g, device="cuda")
    z_old = torch.randn((D,), generator=g, device="cuda")
    thr = 0.37
    z_k, s_k, n_k = st.soft_threshold_cuda(omega, z_old, thr)
    z_2, s_2, n_2 = st.soft_threshold_cuda(omega, z_old, thr)
    z_p, s_p, n_p = ref.soft_threshold_ref(
        omega, z_old, torch.tensor(thr, dtype=torch.float32, device="cuda"))
    torch.cuda.synchronize()
    if not (torch.equal(z_k, z_2) and torch.equal(s_k, s_2)
            and torch.equal(n_k, n_2)):
        fail(f"z-update D={D}: a second call is not bitwise equal")
    if int(n_k) != int(n_p):
        fail(f"z-update D={D}: nnz {int(n_k)} != plain {int(n_p)}")
    return max(max_err(torch, z_k, z_p, f"z-update z D={D}"),
               max_err(torch, s_k, s_p, f"z-update ssq D={D}")), (omega,
                                                                 z_old, thr)


# (W, N, D), all-zero-mask lanes: ragged D (bulk copies need D % 4 == 0,
# so 70, 129 and 5 take the cp.async loader), ranges that cross lane
# boundaries mid-range (1024 x 8 rows, 3 x 111 rows), one lane of 2 048
# rows, a row count off the split at the main width, and rows too wide
# for one block: D = 40 000 (bulk copies) and 20 001 (cp.async) each take
# a cluster of 4 blocks per range
MARGIN_SMALL = [((3, 111, 70), (0,)), ((2, 300, 129), (1,)),
                ((1024, 8, 128), (5, 700)), ((8, 256, 128), ()),
                ((1, 2048, 128), ()), ((1, 1, 5), ()),
                ((5, 1001, 10_000), (2,)), ((2, 300, 40_000), (1,)),
                ((2, 50, 20_001), (0,))]
Z_SIZES = (1, 70, 8320, 10_000, 1_000_003)


def phase_parity(torch, lv, st, ref):
    results = {}
    worst = {"logistic": 0.0, "hinge": 0.0, "soft_threshold": 0.0}
    for (W, N, D), zero in MARGIN_SMALL:
        A, b, mask, x = margin_inputs(torch, W, N, D, zero, seed=W + N + D)
        for loss in ("logistic", "hinge"):
            worst[loss] = max(worst[loss], check_margin(
                torch, lv, ref, loss, A, b, mask, x, zero))
        p = lv.device_plan(W, N, D, "cuda", lv.bulk_loader(A, x))
        say(f"[2] margin {(W, N, D)}: {p.groups} ranges x {p.cluster} "
            f"block(s) of {p.threads} threads x {p.chunks} chunks, "
            f"{p.stages} stages of {p.rows_per_stage} rows, "
            f"{'bulk copy' if p.bulk else 'cp.async'} loader")
    for D in Z_SIZES:
        err, _ = check_z_update(torch, st, ref, D, seed=D)
        worst["soft_threshold"] = max(worst["soft_threshold"], err)
    say(f"[2] small shapes held, each second call bitwise equal, zero-mask "
        f"lanes exactly 0: logistic {worst['logistic']:.2e}, hinge "
        f"{worst['hinge']:.2e}, z-update {worst['soft_threshold']:.2e} "
        f"(tolerance {PARITY_RTOL:g} x max(1, |plain|); nnz exact)")

    # the main path's shapes: W=64 lanes of 9 375 rows, d = 10 000
    W, N, D = PAPER_W, -(-PAPER_KW["n_samples"] // PAPER_W), \
        PAPER_KW["n_features"]
    A, b, mask, x = margin_inputs(torch, W, N, D, (3,), seed=1)
    n_bytes = 4.0 * (W * N * D + 2 * W * N + 2 * W * D + W)
    # one cuBLAS read of A (A x as a batched product): a practical read
    # rate, not the same function
    read_ms = median_ms(torch, lambda: torch.bmm(A, x[:, :, None]), 5)
    p = lv.device_plan(W, N, D, "cuda", lv.bulk_loader(A, x))
    for loss in ("logistic", "hinge"):
        err = check_margin(torch, lv, ref, loss, A, b, mask, x, (3,))
        worst[loss] = max(worst[loss], err)
        kern = (lambda: lv.margin_vjp_cuda(A, b, mask, x, loss=loss,
                                           gamma=0.5))
        plain = ((lambda: ref.logistic_vjp_ref(A, b, mask, x))
                 if loss == "logistic"
                 else (lambda: ref.svm_vjp_ref(A, b, mask, x, 0.5)))
        ms_k = median_ms(torch, kern, 5)
        ms_p = median_ms(torch, plain, 3)
        b_ms, b_by = bound_ms(n_bytes, 4.0 * W * N * D)
        results[loss] = dict(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=worst[loss],
                             read_ms=read_ms, shape=[W, N, D])
        say(f"[2] {loss} at (W, N, D) = ({W}, {N}, {D}): max err {err:.2e}"
            f", kernel {ms_k:.3f} ms ({lv.BODY} body: {p.groups} ranges of "
            f"{W * N // p.groups}-{-(-W * N // p.groups)} rows, "
            f"{p.threads} threads x {p.chunks} chunks, {p.stages} stages), "
            f"{n_bytes / ms_k / 1e9:.3f} TB/s, {b_ms / ms_k:.3f} of the "
            f"bound; plain {ms_p:.3f} ms; bound {b_ms:.3f} ms ({b_by}: "
            f"{n_bytes / 1e9:.2f} GB at 3.35 TB/s); one cuBLAS read of A "
            f"(bmm) {read_ms:.3f} ms")
    del A, b, mask, x
    torch.cuda.empty_cache()

    # the z-update: device times of calls captured in one CUDA graph, at
    # the main path's D and at 10^6, beside an empty kernel's (the floor)
    floor_ms = graph_ms(torch, st.empty_launch, reps=200)
    thr_t = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    z_times = {}
    for Dz, seed in ((D, 2), (1_000_003, 3)):
        err, (omega, z_old, thr) = check_z_update(torch, st, ref, Dz, seed)
        worst["soft_threshold"] = max(worst["soft_threshold"], err)

        def kern():
            st.soft_threshold_cuda(omega, z_old, thr)

        def plain():
            ref.soft_threshold_ref(omega, z_old, thr_t)
        eager_k = median_ms(torch, kern, 200, warmup=5)
        eager_p = median_ms(torch, plain, 200, warmup=5)
        ms_k = graph_ms(torch, kern, reps=200)
        ms_p = graph_ms(torch, plain, reps=200)
        z_bytes = 4.0 * 3 * Dz + 4 + 4 + 8
        b_ms, b_by = bound_ms(z_bytes, 6.0 * Dz)
        z_times[Dz] = dict(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                           bound_by=b_by, eager_ms=eager_k,
                           eager_plain_ms=eager_p)
        say(f"[2] z-update at D = {Dz}: max err {err:.2e}; device time "
            f"(CUDA graph) kernel {ms_k:.5f} ms ({st.BODY} body, "
            f"{st.plan(Dz, torch.cuda.get_device_properties(0).multi_processor_count)}"
            f" blocks), plain {ms_p:.5f} ms, empty kernel {floor_ms:.5f} ms;"
            f" per eager call kernel {eager_k:.4f} ms, plain {eager_p:.4f} "
            f"ms; bound {b_ms:.6f} ms ({b_by}), "
            f"{z_bytes / ms_k / 1e9:.3f} TB/s")
    results["soft_threshold"] = dict(
        z_times[D], max_abs_err=worst["soft_threshold"], shape=[D],
        floor_ms=floor_ms, ms_1e6=z_times[1_000_003]["ms"],
        bound_ms_1e6=z_times[1_000_003]["bound_ms"])
    return results


# ---------------------------------------------------------------------------
# phase 2, attention: flash (prefill) and decode kernels
# ---------------------------------------------------------------------------

# (B, S, H, KV, hd, window): MHA, GQA G = 4 with a window, MQA, G = 3 and
# G = 7 with hd 128, a window inside one tile, hd 80; lengths off the
# 64-row / 64-key tiles.  Then for the bf16 wgmma body (hd 64 and 128,
# 128-row blocks, 128-key tiles in a ring of 4 or 3 stages): lengths off
# the tile and under one tile, G = 5 and G = 7, a window narrower than a
# tile, and 1 100 keys (9 tiles) so each ring wraps at least twice
FLASH_SMALL = [(1, 256, 4, 4, 64, None), (2, 200, 8, 2, 32, 40),
               (1, 130, 8, 1, 16, None), (2, 77, 12, 4, 128, None),
               (1, 100, 56, 8, 128, None), (1, 64, 32, 8, 128, 16),
               (2, 97, 32, 32, 80, None),
               (1, 1100, 8, 8, 64, None), (1, 1100, 20, 4, 128, None),
               (2, 50, 28, 4, 128, None), (1, 300, 40, 8, 64, 100),
               (2, 333, 35, 7, 64, None)]
# (B, Smax, H, KV, hd, positions): differing positions, live length 1
# (position 0), a cache off the 256-slot chunk, a ring cache that has
# wrapped (pos >= Smax), G = 1, 4, 7, 8; then G = 7 over an odd Smax, off
# every tile of slots
DECODE_SMALL = [(2, 512, 4, 4, 64, [170, 511]),
                (3, 300, 8, 2, 32, [0, 299, 57]),
                (2, 300, 4, 1, 16, [349, 12]),
                (2, 2112, 32, 8, 128, [2047, 100]),
                (1, 1000, 56, 8, 128, [999]),
                (2, 40, 8, 1, 128, [1000, 39]),
                (2, 1001, 28, 4, 64, [1000, 517])]
# (B, Smax, H, KV, hd): live lengths on the split boundaries of the plan
# the card gives these shapes (split_len L: live L, L + 1 and 2 L)
DECODE_BOUNDARY = [(3, 2112, 32, 8, 128), (3, 1001, 8, 8, 64)]


# the flash kernel's causal=False instantiation (B, S, H, KV, hd, Skv):
# Skv != S and off the 64- and 128-key tiles, one key, G = 1 to 8, in the
# scalar (float32, hd 16 and 32) and wgmma (bf16, hd 64 and 128) bodies
FLASH_CROSS_SMALL = [(2, 77, 8, 2, 64, 50), (1, 130, 16, 2, 128, 201),
                     (2, 64, 8, 8, 32, 1), (1, 300, 40, 8, 64, 129),
                     (2, 200, 8, 1, 16, 333), (1, 129, 64, 8, 128, 1601)]
# phase 10's prefill shapes (B, S, H, KV, hd, window), bf16: granite_moe
# (G = 3 at hd 64), musicgen and zamba2 (G = 1), the VLM's self-attention
# (G = 8), mixtral (a 4096-key window over 4608 positions)
FLASH_PATHS = {"granite_moe_3b_a800m": (8, 2048, 24, 8, 64, None),
               "musicgen_large, zamba2_1_2b": (8, 2048, 32, 32, 64, None),
               "llama3_2_vision_90b": (8, 2048, 64, 8, 128, None),
               "mixtral_8x7b": (4, 4608, 32, 8, 128, 4096)}
# the VLM's cross-attention prefill: 2048 queries over 1601 image tokens
VLM_CROSS = (8, 2048, 64, 8, 128, 1601)
# phase 10's decode shapes (B, Smax, H, KV, hd, position), bf16: mid-run
# of 64 tokens after a 2048-token prompt; mixtral's 4096-slot ring after
# a 4608-token prompt (wrapped); the VLM's cross decode, the decode kernel
# over all 1601 image slots (position 1600)
DECODE_PATHS = {"granite_moe_3b_a800m": (8, 2112, 24, 8, 64, 2079),
                "musicgen_large, zamba2_1_2b": (8, 2112, 32, 32, 64, 2079),
                "llama3_2_vision_90b": (8, 2112, 64, 8, 128, 2079),
                "mixtral_8x7b": (4, 4096, 32, 8, 128, 4639),
                "llama3_2_vision_90b cross": (8, 1601, 64, 8, 128, 1600)}


def attn_inputs(torch, shapes, dtype, seed):
    """q, k, v (or q and the two caches) of ``shapes``: q = 2 randn, the
    others randn / 2."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda")
            .mul_(0.5 * (ATTN_Q_SCALE if i == 0 else 1.0)).to(dtype)
            for i, s in enumerate(shapes)]


def row_gaps(torch, got, want):
    """|got - want| / |want| in L2 over the last axis, one per row."""
    d = (got.double() - want.double()).flatten(0, -2).norm(dim=-1)
    return d / want.double().flatten(0, -2).norm(dim=-1)


def hold_rows(torch, got, want, rtol, name):
    """Fails unless every row's relative L2 gap is within ``rtol``; returns
    (worst row gap, max |got - want|)."""
    worst = float(row_gaps(torch, got, want).max())
    if not math.isfinite(worst) or worst > rtol:
        fail(f"{name}: a row's |kernel - plain| / |plain| is {worst:.3e}, "
             f"over {rtol:g}")
    return worst, float((got.double() - want.double()).abs().max())


def control_rows(torch, ctrl, want, rtol, name):
    """The plain version with one key left out, against the plain version:
    the share of rows a kernel with that fault would fail.  Fails if the
    check could not see the fault."""
    seen = float((row_gaps(torch, ctrl, want) > rtol).double().mean())
    if seen == 0.0:
        fail(f"{name}: a kernel that leaves out one key would pass")
    return seen


def flash_flops(B, S, H, hd, window, Skv=None):
    """4 B H hd times the visible (query, key) pairs: of causal attention,
    or every pair of S queries and ``Skv`` keys when ``Skv`` is given (no
    mask)."""
    if Skv is not None:
        return 4.0 * B * H * hd * S * Skv
    pairs = sum(min(i + 1, window or i + 1) for i in range(S))
    return 4.0 * B * H * hd * pairs


def sdpa_inputs(torch, q, k, v, causal, window):
    """SDPA's (B, H, S, hd) operands and keyword arguments for the flash
    kernel's call: is_causal for plain causal attention; a boolean mask
    over K and V expanded to H heads for a window (the memory-efficient
    backend, which takes a mask); nothing for causal=False."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window is None:
        return (qt, kt, vt), dict(is_causal=causal, enable_gqa=True)
    G = q.shape[2] // k.shape[2]
    kt, vt = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
    i = torch.arange(q.shape[1], device=q.device)
    ok = (i[:, None] >= i[None, :]) & (i[None, :] > i[:, None] - window)
    return (qt, kt, vt), dict(attn_mask=ok)


def flash_path(torch, fa, attention, F, shape, seed, cross=False):
    """The flash kernel at one of phase 10's bf16 shapes, (B, S, H, KV,
    hd, window) or, with ``cross``, (B, S, H, KV, hd, Skv) for
    causal=False: held against the float32 plain version (and, for
    causal=False, the reference's ``cross_attention`` too), with its
    median time, SDPA's for the same call, and the bound."""
    B, S, H, KV, hd, w = shape
    Skv = w if cross else S
    window = None if cross else w
    q, k, v = attn_inputs(torch, [(B, S, H, hd), (B, Skv, KV, hd),
                                  (B, Skv, KV, hd)], torch.bfloat16, seed)
    got = fa.flash_attention_cuda(q, k, v, causal=not cross, window=window)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want = attention.block_attention(q32, k32, v32, causal=not cross,
                                     window=window)
    torch.cuda.synchronize()
    rtol = ATTN_ROW_RTOL["bfloat16"]
    gap, err = hold_rows(torch, got, want, rtol, f"flash at {shape}")
    if cross:
        gap = max(gap, hold_rows(torch, got, attention.cross_attention(
            q32, k32, v32), rtol, f"flash at {shape} vs cross_attention")[0])
    del got, want, q32, k32, v32
    args, kw = sdpa_inputs(torch, q, k, v, not cross, window)
    ms_k = median_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, causal=not cross, window=window), 7)
    ms_l = median_ms(torch, lambda: F.scaled_dot_product_attention(
        *args, **kw), 7)
    n_ops = flash_flops(B, S, H, hd, window, Skv if cross else None)
    n_bytes = 2.0 * (2 * B * S * H * hd + 2 * B * Skv * KV * hd)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    return dict(shape=list(shape), ms=ms_k, library_ms=ms_l, bound_ms=b_ms,
                bound_by=b_by, row_gap=gap, max_abs_err=err)


def decode_path(torch, dec, attention, F, shape, seed, cross=False):
    """The decode kernel at one of phase 10's bf16 cache shapes: held
    against the float32 plain version (and, for the VLM's cross decode,
    the reference's ``cross_attention`` of one query), with its device
    time per call in a CUDA graph, SDPA's for the same call, and the
    bound."""
    B, Smax, H, KV, hd, pos = shape
    q, kc, vc = attn_inputs(torch, [(B, 1, H, hd), (B, Smax, KV, hd),
                                    (B, Smax, KV, hd)], torch.bfloat16, seed)
    p = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    got = dec.decode_attention_cuda(q, kc, vc, p)
    q32, k32, v32 = (t.float() for t in (q, kc, vc))
    want = attention.decode_attention(q32, k32, v32, p)
    torch.cuda.synchronize()
    rtol = ATTN_ROW_RTOL["bfloat16"]
    gap, err = hold_rows(torch, got, want, rtol, f"decode at {shape}")
    if cross:
        gap = max(gap, hold_rows(torch, got, attention.cross_attention(
            q32, k32, v32), rtol, f"decode at {shape} vs cross_attention")[0])
    del got, want, q32, k32, v32
    live = min(pos + 1, Smax)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
    mask = (torch.arange(Smax, device="cuda")[None, :] <= p[:, None])[
        :, None, None, :]
    ms_k = graph_ms(torch, lambda: dec.decode_attention_cuda(q, kc, vc, p),
                    200)
    ms_l = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 200)
    n_bytes = 2.0 * (2 * B * live * KV * hd + 2 * B * H * hd) + 4 * B
    b_ms, b_by = bound_ms(n_bytes, 4.0 * B * H * hd * live, BF16_OPS_PER_S)
    return dict(shape=list(shape), ms=ms_k, library_ms=ms_l, bound_ms=b_ms,
                bound_by=b_by, row_gap=gap, max_abs_err=err)


def say_path(kind, name, r):
    say(f"[2] {kind} at {name} {tuple(r['shape'])} bf16: worst row gap "
        f"{r['row_gap']:.2e}; kernel {r['ms']:.4f} ms, SDPA "
        f"{r['library_ms']:.4f} ms (kernel / SDPA "
        f"{r['ms'] / r['library_ms']:.2f}), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")


def phase_attention_parity(torch, fa, dec, attention, F):
    """Flash and decode kernels against their plain versions, small ragged
    shapes in float32 and bf16, then the serving path's shapes in bf16
    with the kernel's, plain version's, bound's and SDPA's times.  The
    plain version runs in float32 on the kernel's inputs."""
    worst, abs_err = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        rtol = ATTN_ROW_RTOL[name]
        for B, S, H, KV, hd, window in FLASH_SMALL:
            q, k, v = attn_inputs(torch, [(B, S, H, hd), (B, S, KV, hd),
                                          (B, S, KV, hd)], dtype, S + H)
            got = fa.flash_attention_cuda(q, k, v, window=window)
            want = attention.block_attention(q.float(), k.float(), v.float(),
                                             window=window)
            torch.cuda.synchronize()
            gap, err = hold_rows(torch, got, want, rtol,
                                 f"flash {name} {(B, S, H, KV, hd, window)}")
            worst["flash", name] = max(worst.get(("flash", name), 0.0), gap)
            abs_err["flash"] = max(abs_err.get("flash", 0.0), err)
        decode_cases = list(DECODE_SMALL)
        for B, Smax, H, KV, hd in DECODE_BOUNDARY:
            L = dec.device_plan(dtype, B, KV, H // KV, hd, Smax, "cuda")[1]
            decode_cases.append((B, Smax, H, KV, hd,
                                 [min(x, Smax - 1) for x in (L - 1, L,
                                                             2 * L - 1)]))
        for B, Smax, H, KV, hd, pos in decode_cases:
            q, kc, vc = attn_inputs(torch, [(B, 1, H, hd), (B, Smax, KV, hd),
                                            (B, Smax, KV, hd)], dtype,
                                    Smax + H)
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            got = dec.decode_attention_cuda(q, kc, vc, p)
            want = attention.decode_attention(q.float(), kc.float(),
                                              vc.float(), p)
            torch.cuda.synchronize()
            gap, err = hold_rows(torch, got, want, rtol,
                                 f"decode {name} {(B, Smax, H, KV, hd, pos)}")
            worst["decode", name] = max(worst.get(("decode", name), 0.0), gap)
            abs_err["decode"] = max(abs_err.get("decode", 0.0), err)
        for B, S, H, KV, hd, Skv in FLASH_CROSS_SMALL:
            q, k, v = attn_inputs(torch, [(B, S, H, hd), (B, Skv, KV, hd),
                                          (B, Skv, KV, hd)], dtype, S + Skv)
            got = fa.flash_attention_cuda(q, k, v, causal=False)
            q32, k32, v32 = (t.float() for t in (q, k, v))
            torch.cuda.synchronize()
            case = f"flash causal=False {name} {(B, S, H, KV, hd, Skv)}"
            for plain in (attention.block_attention(q32, k32, v32,
                                                    causal=False),
                          attention.cross_attention(q32, k32, v32)):
                gap, err = hold_rows(torch, got, plain, rtol, case)
                worst["cross", name] = max(worst.get(("cross", name), 0.0),
                                           gap)
                abs_err["cross"] = max(abs_err.get("cross", 0.0), err)
    say(f"[2] flash causal=False, small ragged shapes held against "
        f"block_attention(causal=False) and cross_attention: worst row gap "
        f"{worst['cross', 'float32']:.2e} / {worst['cross', 'bfloat16']:.2e}"
        f" (float32 / bf16)")
    say(f"[2] attention, small ragged shapes held (worst row's relative L2 "
        f"gap; limit float32 {ATTN_ROW_RTOL['float32']:g}, bf16 "
        f"{ATTN_ROW_RTOL['bfloat16']:g}): flash "
        f"{worst['flash', 'float32']:.2e} / {worst['flash', 'bfloat16']:.2e},"
        f" decode {worst['decode', 'float32']:.2e} / "
        f"{worst['decode', 'bfloat16']:.2e} (float32 / bf16)")

    results = {}
    bf = torch.bfloat16
    rtol = ATTN_ROW_RTOL["bfloat16"]
    # prefill: (8, 2048, 32 heads over 8 KV heads, 128), the wgmma body
    B, S, H, KV, hd = SERVE_B, SERVE_P, 32, 8, 128
    q, k, v = attn_inputs(torch, [(B, S, H, hd), (B, S, KV, hd),
                                  (B, S, KV, hd)], bf, 7)
    got = fa.flash_attention_cuda(q, k, v)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want = attention.block_attention(q32, k32, v32)
    torch.cuda.synchronize()
    gap, err = hold_rows(torch, got, want, rtol, "flash at the serving shape")
    # the control: query i against keys 0..i-1, a kernel that leaves out
    # its diagonal key
    seen = control_rows(torch, attention.block_attention(
        q32[:, 1:], k32[:, :-1], v32[:, :-1]), want[:, 1:], rtol,
        "flash at the serving shape")
    del got, want, q32, k32, v32
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms_k = median_ms(torch, lambda: fa.flash_attention_cuda(q, k, v), 7)
    ms_p = median_ms(torch, lambda: attention.block_attention(q, k, v), 3)
    ms_l = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 7)
    n_ops = flash_flops(B, S, H, hd, None)
    n_bytes = 2.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    del qt, kt, vt, q, k, v
    body = fa.body(bf, hd)
    results["flash_attention"] = dict(
        ms=ms_k, plain_ms=ms_p, library_ms=ms_l, bound_ms=b_ms,
        bound_by=b_by, max_abs_err=max(err, abs_err["flash"]),
        shape=[B, S, H, KV, hd], body=body)
    say(f"[2] flash at (B, S, H, KV, hd) = {(B, S, H, KV, hd)} bf16: worst "
        f"row gap {gap:.2e} (max abs {err:.2e}); leaving out the diagonal "
        f"key would fail {seen:.3f} of rows; kernel {ms_k:.3f} ms ({body} "
        f"body), plain {ms_p:.3f} ms, SDPA {ms_l:.3f} ms (kernel / SDPA "
        f"{ms_k / ms_l:.2f}), bound {b_ms:.3f} "
        f"ms ({b_by}: {n_ops:.3e} flop at 989 TFLOP/s); "
        f"{n_ops / ms_k / 1e9:.1f} TFLOP/s achieved")

    # decode: caches of P + gen = 2112 slots, position P + 31 (mid-run)
    Smax = SERVE_P + SERVE_GEN
    pos_val = SERVE_P + SERVE_GEN // 2 - 1
    q, kc, vc = attn_inputs(torch, [(B, 1, H, hd), (B, Smax, KV, hd),
                                    (B, Smax, KV, hd)], bf, 8)
    p = torch.full((B,), pos_val, dtype=torch.int32, device="cuda")
    got = dec.decode_attention_cuda(q, kc, vc, p)
    q32, k32, v32 = (t.float() for t in (q, kc, vc))
    want = attention.decode_attention(q32, k32, v32, p)
    torch.cuda.synchronize()
    gap, err = hold_rows(torch, got, want, rtol,
                         "decode at the serving shape")
    # the control: the newest slot left out
    seen = control_rows(torch, attention.decode_attention(
        q32, k32, v32, p - 1), want, rtol, "decode at the serving shape")
    del got, want, q32, k32, v32
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
    mask = (torch.arange(Smax, device="cuda")[None, :] <= p[:, None])[
        :, None, None, :]

    def kern():
        dec.decode_attention_cuda(q, kc, vc, p)

    def plain():
        attention.decode_attention(q, kc, vc, p)

    def library():
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                       enable_gqa=True)
    eager_k = median_ms(torch, kern, 21, warmup=3)
    ms_k = graph_ms(torch, kern, 200)
    ms_p = graph_ms(torch, plain, 50)
    ms_l = graph_ms(torch, library, 200)
    live = pos_val + 1
    n_bytes = 2.0 * (2 * B * live * KV * hd + 2 * B * H * hd) + 4 * B
    n_ops = 4.0 * B * H * hd * live
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    plan = dec.device_plan(bf, B, KV, H // KV, hd, Smax, "cuda")
    results["decode_attention"] = dict(
        ms=ms_k, plain_ms=ms_p, library_ms=ms_l, bound_ms=b_ms,
        bound_by=b_by, eager_ms=eager_k,
        max_abs_err=max(err, abs_err["decode"]),
        shape=[B, Smax, H, KV, hd, live], body=dec.BODY)
    say(f"[2] decode at (B, Smax, H, KV, hd) = {(B, Smax, H, KV, hd)} bf16, "
        f"{live} live slots: worst row gap {gap:.2e} (max abs {err:.2e}); "
        f"leaving out the newest slot would fail {seen:.3f} of rows; device "
        f"time (CUDA graph) kernel {ms_k:.4f} ms ({dec.BODY} body, {plan[0]} "
        f"splits of {plan[1]} slots, one launch), plain {ms_p:.4f} ms, SDPA "
        f"{ms_l:.4f} ms (kernel / SDPA {ms_k / ms_l:.2f}); per eager call "
        f"kernel {eager_k:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
        f"{n_bytes / 1e6:.1f} MB at 3.35 TB/s, "
        f"{n_bytes / ms_k / 1e9:.2f} TB/s achieved)")
    del q, kc, vc, qt, kt, vt

    # flash's causal=False instantiation at the VLM's cross-attention
    # prefill, with a control and the plain version's time
    B, S, H, KV, hd, Skv = VLM_CROSS
    r = flash_path(torch, fa, attention, F, VLM_CROSS, 9, cross=True)
    q, k, v = attn_inputs(torch, [(B, S, H, hd), (B, Skv, KV, hd),
                                  (B, Skv, KV, hd)], bf, 9)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want = attention.block_attention(q32, k32, v32, causal=False)
    # the control: a kernel that leaves out the last image token
    seen = control_rows(torch, attention.block_attention(
        q32, k32[:, :-1], v32[:, :-1], causal=False), want, rtol,
        "flash causal=False at the VLM's shape")
    del want, q32, k32, v32
    r["plain_ms"] = median_ms(torch, lambda: attention.block_attention(
        q, k, v, causal=False), 3)
    r["max_abs_err"] = max(r["max_abs_err"], abs_err["cross"])
    r["body"] = fa.body(bf, hd)
    del q, k, v
    results["flash_attention_noncausal"] = r
    say(f"[2] flash causal=False at (B, S, H, KV, hd, Skv) = {VLM_CROSS} "
        f"bf16: worst row gap {r['row_gap']:.2e} against block_attention "
        f"and cross_attention; leaving out the last key would fail "
        f"{seen:.3f} of rows; kernel {r['ms']:.3f} ms ({r['body']} body), "
        f"plain {r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.3f} ms "
        f"(kernel / SDPA {r['ms'] / r['library_ms']:.2f}), bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']})")

    # phase 10's shapes: each path's prefill and decode
    for name, shape in FLASH_PATHS.items():
        r = flash_path(torch, fa, attention, F, shape, 10)
        results["flash_attention"].setdefault("paths", {})[name] = r
        say_path("flash", name, r)
    for name, shape in DECODE_PATHS.items():
        r = decode_path(torch, dec, attention, F, shape, 11,
                        cross=name.endswith("cross"))
        results["decode_attention"].setdefault("paths", {})[name] = r
        say_path("decode", name, r)
    return results


# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_serve_reduced(torch, configs, model, fa, dec):
    """reduced(granite_8b), float32, 2 layers: prefill and 8 greedy decode
    steps on the card (through the kernels) and on the CPU (plain
    versions) from the same parameters, fed the CPU's tokens."""
    B, P, steps = 4, 40, 8
    for window in (None, 16):
        cfg = configs.reduced(configs.get_config("granite_8b"),
                              sliding_window=window)
        gen = torch.Generator().manual_seed(0)
        cpu = model.init_params(cfg, generator=gen, device="cpu")
        card = tree_to(cpu, "cuda")
        toks = torch.randint(0, cfg.vocab_size, (B, P),
                             generator=torch.Generator().manual_seed(1))
        caches = [model.init_cache(cfg, B, P + steps, device=d)
                  for d in ("cpu", "cuda")]
        fa.reset_launches()
        dec.reset_launches()
        worst = 0.0
        with torch.inference_mode():
            lc, _ = model.prefill(cpu, cfg, {"tokens": toks}, caches[0])
            lg, _ = model.prefill(card, cfg, {"tokens": toks.cuda()},
                                  caches[1])
            worst = max(worst, max_err(torch, lg.cpu(), lc,
                                       f"reduced prefill window={window}",
                                       REDUCED_RTOL))
            nxt = lc[:, -1].argmax(-1)
            for i in range(steps):
                pos = torch.full((B,), P + i, dtype=torch.int32)
                lc, _ = model.decode_step(cpu, cfg, {
                    "tokens": nxt[:, None], "positions": pos}, caches[0])
                lg, _ = model.decode_step(card, cfg, {
                    "tokens": nxt[:, None].cuda(), "positions": pos.cuda()},
                    caches[1])
                worst = max(worst, max_err(
                    torch, lg.cpu(), lc,
                    f"reduced decode step {i} window={window}", REDUCED_RTOL))
                nxt = lc[:, 0].argmax(-1)
            worst = max(worst, max_err(torch, caches[1]["k"].cpu(),
                                       caches[0]["k"], "reduced k cache",
                                       REDUCED_RTOL))
        n_fa, n_dec = fa.LAUNCHES["flash_attention"], \
            dec.LAUNCHES["decode_attention"]
        if n_fa != cfg.n_layers or n_dec != cfg.n_layers * steps:
            fail(f"reduced run window={window}: {n_fa} flash and {n_dec} "
                 f"decode launches, expected {cfg.n_layers} and "
                 f"{cfg.n_layers * steps}")
        say(f"[5] reduced granite_8b (float32, 2 layers, window={window}, B="
            f"{B}, prompt {P}, {steps} decode steps): card vs CPU logits "
            f"{worst:.2e} (tolerance {REDUCED_RTOL:g} x max(1, |CPU|)); "
            f"launches flash {n_fa}, decode {n_dec}")


def phase_serve(torch, configs, model, serve, fa, dec, kernel_ms):
    """granite_8b at full width and depth, bf16, through serve.main; then
    prefill-then-decode in bf16 and, as the witness, in float32."""
    cfg = configs.get_config("granite_8b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with torch.inference_mode():
        params = model.init_params(
            cfg, generator=torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
    torch.cuda.synchronize()
    t_init = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"[5] granite_8b: {n_params / 1e9:.3f} B parameters drawn on the "
        f"card in {t_init:.1f} s ({torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB)")

    stats = {}
    fa.reset_launches()
    dec.reset_launches()
    out = serve.main(SERVE_ARGV, params=params, stats=stats)
    launches = {"flash_attention": fa.LAUNCHES["flash_attention"],
                "decode_attention": dec.LAUNCHES["decode_attention"]}
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_GEN - 1
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * steps}
    if launches != want:
        fail(f"serving launches {launches}, expected {want}")
    if tuple(out.shape) != (SERVE_B, SERVE_GEN) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"serving tokens: shape {tuple(out.shape)} or out of "
             f"[0, {cfg.vocab_size})")
    for key in ("prefill_logits", "first_decode_logits", "last_logits"):
        if not bool(torch.isfinite(stats[key]).all()):
            fail(f"serving: non-finite {key}")

    with torch.inference_mode():
        prompt, tok = stats["prompt"], out[:, 0].cuda()
        held = prefill_then_decode(torch, model, serve, params, cfg, prompt,
                                   tok, stats["first_decode_logits"])
        dev_ms = step_device_ms(torch, model, serve, params, cfg, prompt,
                                tok, SERVE_P, SERVE_GEN)
        del params
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params = model.init_params(
            cfg32, generator=torch.Generator(device="cuda").manual_seed(1),
            device="cuda")
        held32 = prefill_then_decode(torch, model, serve, params, cfg32,
                                     prompt, tok, None)
        del params
        torch.cuda.empty_cache()

    t_pre, t_dec = stats["prefill_s"], stats["decode_s"]
    ms_step = t_dec / steps * 1e3
    attn_ms = cfg.n_layers * kernel_ms.get("decode_attention", float("nan"))
    say(f"[5] serving granite_8b (B={SERVE_B}, prompt {SERVE_P}, "
        f"{SERVE_GEN} tokens, bf16): prefill {t_pre:.3f} s "
        f"({SERVE_B * SERVE_P / t_pre:.0f} tok/s); decode {ms_step:.3f} ms "
        f"per step, {SERVE_B * steps / t_dec:.1f} tok/s; launches {launches};"
        f" peak device memory {peak / 1e9:.2f} GB")
    say(f"[5] per decode step: device time {dev_ms:.3f} ms (one step in a "
        f"CUDA graph) of {ms_step:.3f} ms eager, host share "
        f"{1 - dev_ms / ms_step:.3f}; {cfg.n_layers} decode launches x "
        f"{kernel_ms.get('decode_attention', float('nan')):.4f} ms (phase-2 "
        f"device time) = {attn_ms:.3f} ms; prefill: "
        f"{cfg.n_layers} flash launches x "
        f"{kernel_ms.get('flash_attention', float('nan')):.3f} ms = "
        f"{cfg.n_layers * kernel_ms.get('flash_attention', float('nan')) / 1e3:.3f}"
        f" s of {t_pre:.3f} s")
    for name, h in (("bfloat16", held), ("float32", held32)):
        say(f"[5] prefill-then-decode at full width and depth, {name}: "
            f"relative L2 {h['rel']:.3e} (limit {SERVE_REL_L2[name]:g}), "
            f"same argmax in {h['same']:.3f} of rows, max gap "
            f"{h['gap']:.3e} of max |logit| {h['scale']:.3f}; the step one "
            f"position on: relative L2 {h['ctrl_rel']:.3e}, same argmax in "
            f"{h['ctrl_same']:.3f} of rows")
    for name, h in (("bfloat16", held), ("float32", held32)):
        if not (h["rel"] <= SERVE_REL_L2[name]
                and h["same"] >= SERVE_SAME_ARGMAX[name]):
            fail(f"prefill-then-decode, {name}: relative L2 {h['rel']:.3e} "
                 f"or same argmax {h['same']:.3f} outside "
                 f"{SERVE_REL_L2[name]:g} / {SERVE_SAME_ARGMAX[name]:.3f}")
    if not held32["ctrl_rel"] > SERVE_REL_L2["float32"]:
        fail("prefill-then-decode, float32: the step one position on "
             "passes the check")
    say(f"[5] tokens in [0, {cfg.vocab_size}), all kept logits finite")
    return launches, dict(prefill_s=t_pre, decode_ms_per_step=ms_step,
                          decode_device_ms_per_step=dev_ms, peak_gb=peak / 1e9)


def step_device_ms(torch, model, serve, params, cfg, prompt, tok, P, gen):
    """Device time of one decode step at a mid-run position (P + gen/2 - 1),
    captured in a CUDA graph: the host taken out."""
    B = tok.shape[0]
    cache = model.init_cache(cfg, B, P + gen, device="cuda")
    step = serve.step_batch(params, cfg, prompt, tok, P + gen // 2 - 1)
    ms = graph_ms(torch, lambda: model.decode_step(params, cfg, step,
                                                   cache), 4)
    del cache
    return ms


def _prompt_len(cfg, prompt):
    return prompt["embeds" if cfg.family == "audio" else "tokens"].shape[1]


def _extend(torch, params, cfg, prompt, tok):
    """The prompt with ``tok`` (B,) appended: its token, or for the audio
    family its embedding row."""
    key = "embeds" if cfg.family == "audio" else "tokens"
    new = params["embed"][tok][:, None] if key == "embeds" else tok[:, None]
    return dict(prompt, **{key: torch.cat([prompt[key],
                                           new.to(prompt[key].dtype)], 1)})


def prefill_then_decode(torch, model, serve, params, cfg, prompt, tok, got):
    """The decode step's logits for ``tok`` (B,) at position P (``got``, or
    computed here after a prefill over ``prompt``) against the last logits
    of a prefill over ``prompt`` + ``tok``, over the vocabulary (the
    padded rows' -1e30 left out).  The control is a step one position
    off: ``tok`` given position P + 1; for the families that carry a
    recurrent state (hybrid, ssm), whose mixers read no position, ``tok``
    at P - 1 after a prefill one token short.  Returns the relative L2
    gap, the share of rows with the same argmax, the max gap and max
    |logit|, and the control's relative L2 and argmax share."""
    P, B, dev = _prompt_len(cfg, prompt), tok.shape[0], tok.device
    cache = model.init_cache(cfg, B, P + 2, device=dev)
    model.prefill(params, cfg, prompt, cache, last_only=True)
    if got is None:
        saved = {k: t.clone() for k, t in cache.items()}
        got = model.decode_step(params, cfg, serve.step_batch(
            params, cfg, prompt, tok, P), cache)[0][:, 0]
        cache = saved
    if cfg.family not in ("hybrid", "ssm"):
        ctrl = model.decode_step(params, cfg, serve.step_batch(
            params, cfg, prompt, tok, P + 1), cache)[0]
    else:
        short = {k: v[:, :-1] if k in ("tokens", "embeds") else v
                 for k, v in prompt.items()}
        cache = model.init_cache(cfg, B, P + 1, device=dev)
        model.prefill(params, cfg, short, cache, last_only=True)
        ctrl = model.decode_step(params, cfg, serve.step_batch(
            params, cfg, short, tok, P - 1), cache)[0]
    del cache
    cache = model.init_cache(cfg, B, P + 1, device=dev)
    want = model.prefill(params, cfg, _extend(torch, params, cfg, prompt,
                                              tok),
                         cache, last_only=True)[0][:, 0]
    del cache
    V = cfg.vocab_size
    got, ctrl, want = got[..., :V], ctrl[..., :V], want[..., :V]

    def rel(x):
        return float((x - want).norm() / want.norm())

    def same(x):
        return float((x.argmax(-1) == want.argmax(-1)).double().mean())
    return dict(rel=rel(got), same=same(got),
                gap=float((got - want).abs().max()),
                scale=float(want.abs().max()), ctrl_rel=rel(ctrl[:, 0]),
                ctrl_same=same(ctrl[:, 0]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 3: small instances
# ---------------------------------------------------------------------------


def small_run(api, SchedulerConfig, AdmmOptions, PoolConfig, kw, W, rounds,
              engine, kernel, device, problem="logreg", pool_seed=0,
              **extra):
    spec = api.ExperimentSpec(
        problem=problem, problem_kwargs=kw,
        scheduler=SchedulerConfig(n_workers=W, engine=engine, kernel=kernel,
                                  admm=AdmmOptions(max_iters=40),
                                  pool=PoolConfig(seed=pool_seed), **extra),
        max_rounds=rounds)
    res = api.run(spec, device=device)
    if len(res.trace) != rounds:
        fail(f"{problem} {engine}/{kernel} {extra} on {device}: "
             f"{len(res.trace)} rounds, expected {rounds}")
    return res


def rsr(trace):
    return [(r["r_norm"], r["s_norm"], r["rho"]) for r in trace]


def hold(name, got, want, rtol, cols=(0, 1, 2), floor=1e-9):
    """Each column of each round within ``rtol`` relative, or within the
    absolute ``floor``; returns the worst relative gap."""
    if len(got) != len(want):
        fail(f"{name}: {len(got)} rounds against {len(want)}")
    worst = 0.0
    for k, (row_g, row_w) in enumerate(zip(got, want), 1):
        for c in cols:
            diff = abs(row_g[c] - row_w[c])
            gap = diff / max(abs(row_w[c]), 1e-9)
            if not math.isfinite(row_g[c]) or (gap > rtol and diff > floor):
                fail(f"{name}: round {k} column {c}: {row_g[c]!r} vs "
                     f"{row_w[c]!r} (rtol {rtol:g}, floor {floor:.2e})")
            worst = max(worst, gap)
    return worst


def phase_small(torch, api, SchedulerConfig, AdmmOptions, PoolConfig, lv, st):
    args = (api, SchedulerConfig, AdmmOptions, PoolConfig)
    lv.reset_launches()
    st.reset_launches()
    loop = small_run(*args, ENGINE_KW, ENGINE_W, ENGINE_ROUNDS, "loop",
                     "torch", "cuda")
    batched = small_run(*args, ENGINE_KW, ENGINE_W, ENGINE_ROUNDS,
                        "batched", "cuda", "cuda")
    if lv.LAUNCHES["logistic"] == 0 or st.LAUNCHES["soft_threshold"] == 0:
        fail("the batched kernel run launched no kernel")
    g1 = hold("engine instance loop/torch vs anchor", rsr(loop.trace),
              ENGINE_ANCHOR, ANCHOR_RTOL)
    g2 = hold("engine instance batched/cuda vs anchor", rsr(batched.trace),
              ENGINE_ANCHOR, ANCHOR_RTOL)
    g3 = hold("engine instance batched/cuda vs loop/torch",
              rsr(batched.trace), rsr(loop.trace), ANCHOR_RTOL)
    say(f"[3] engine instance (n=50, d=24, W=4, 6 rounds) on the card: "
        f"loop/torch {g1:.2e}, batched/cuda {g2:.2e} from the reference's "
        f"trace, {g3:.2e} apart (rtol {ANCHOR_RTOL:g})")

    f64 = dict(dtype="float64")
    cpu64 = small_run(*args, f64, 8, 10, "loop", "torch", "cpu")
    card64 = small_run(*args, f64, 8, 10, "loop", "torch", "cuda")
    g4 = hold("default instance float64 card vs CPU", rsr(card64.trace),
              rsr(cpu64.trace), F64_RTOL)
    if ([r["inner_mean"] for r in card64.trace]
            != [r["inner_mean"] for r in cpu64.trace]):
        fail("default instance float64: inner iterations differ from the "
             "CPU's")
    loop32 = small_run(*args, {}, 8, 10, "loop", "torch", "cuda")
    bat32 = small_run(*args, {}, 8, 10, "batched", "cuda", "cuda")
    g5 = hold("default instance float32 loop/torch vs float64",
              rsr(loop32.trace), rsr(cpu64.trace), F32_VS_F64_RTOL, (0, 1))
    g6 = hold("default instance float32 batched/cuda vs float64",
              rsr(bat32.trace), rsr(cpu64.trace), F32_VS_F64_RTOL, (0, 1))
    say(f"[3] default instance (n=2048, d=128, W=8, 10 rounds): float64 "
        f"card vs CPU {g4:.2e} (rtol {F64_RTOL:g}); float32 loop/torch "
        f"{g5:.2e}, batched/cuda {g6:.2e} from float64 (rtol "
        f"{F32_VS_F64_RTOL:g}); final r_norm {loop32.trace[-1]['r_norm']:.4f}"
        f" / {bat32.trace[-1]['r_norm']:.4f} / "
        f"{cpu64.trace[-1]['r_norm']:.4f}")


# phase 3's other workloads (tests/test_engine.py::WORKLOADS; logreg_l2 on
# logreg's instance there) and modes: (label, problem, kwargs, W, config)
SMALL_WORKLOADS = {
    "svm": dict(n_samples=50, n_features=16),
    "lasso": dict(n_samples=50, n_features=16),
    "softmax": dict(n_samples=50, n_features=8, n_classes=3),
    "logreg_l2": dict(n_samples=50, n_features=24, density=0.2),
}
ASYNC = dict(mode="async_", async_batch=4, staleness_bound=4, pool_seed=3)
SMALL_CASES = (
    [(name, name, kw, 4, {}) for name, kw in SMALL_WORKLOADS.items()]
    + [(f"{name} async_", name, kw, 8, ASYNC)
       for name, kw in (("logreg", ENGINE_KW),
                        ("svm", SMALL_WORKLOADS["svm"]))]
    + [(f"logreg {c}", "logreg", ENGINE_KW, 4, dict(compress=c))
       for c in ("topk", "qsgd")])


def phase_small_modes(torch, api, SchedulerConfig, AdmmOptions, PoolConfig,
                      lv, st):
    """Each case on the card and on the CPU: float64 on both engines at
    F64_RTOL with equal inner counts; float32 with kernel="cuda" (the
    batched engine; async_ solves per arrival, so there only the z-update
    is fused) against the same float32 run with kernel="torch" on the CPU,
    at the engine tolerance ANCHOR_RTOL."""
    args = (api, SchedulerConfig, AdmmOptions, PoolConfig)
    lv.reset_launches()
    st.reset_launches()
    worst64, worst32 = 0.0, 0.0
    for label, name, kw, W, extra in SMALL_CASES:
        engines = ("loop",) if extra.get("mode") == "async_" else (
            "loop", "batched")
        for engine in engines:
            runs = [small_run(*args, dict(kw, dtype="float64"), W,
                              ENGINE_ROUNDS, engine, "torch", dev,
                              problem=name, **extra)
                    for dev in ("cuda", "cpu")]
            worst64 = max(worst64, hold(
                f"{label} {engine} float64 card vs CPU",
                rsr(runs[0].trace), rsr(runs[1].trace), F64_RTOL))
            if ([r["inner_mean"] for r in runs[0].trace]
                    != [r["inner_mean"] for r in runs[1].trace]):
                fail(f"{label} {engine} float64: inner iterations differ "
                     f"from the CPU's")
        engine = engines[-1]
        card = small_run(*args, kw, W, ENGINE_ROUNDS, engine, "cuda", "cuda",
                         problem=name, **extra)
        cpu = small_run(*args, kw, W, ENGINE_ROUNDS, engine, "torch", "cpu",
                        problem=name, **extra)
        worst32 = max(worst32, hold(f"{label} float32 cuda vs CPU",
                                    rsr(card.trace), rsr(cpu.trace),
                                    ANCHOR_RTOL))
    if lv.LAUNCHES["hinge"] == 0 or st.LAUNCHES["soft_threshold"] == 0:
        fail(f"the small svm runs launched no hinge or z-update kernel: "
             f"{lv.LAUNCHES}, {st.LAUNCHES}")
    say(f"[3] {', '.join(c[0] for c in SMALL_CASES)} ({ENGINE_ROUNDS} "
        f"rounds each): float64 card vs CPU {worst64:.2e} (rtol "
        f"{F64_RTOL:g}, equal inner counts); float32 kernel=cuda on the "
        f"card vs kernel=torch on the CPU {worst32:.2e} (rtol "
        f"{ANCHOR_RTOL:g}); launches {dict(lv.LAUNCHES)}, "
        f"{dict(st.LAUNCHES)}")


# phase 3's cluster cases, float64: tests/test_cluster.py's lasso instance
# (n=256, d=32) for four W=4 jobs of two tenants beside two logreg jobs on
# the batched engine; double_ml at (n, p, K) = (2048, 32, 4); a Poisson
# replay of 200 jobs from runtime.loadgen (its default templates in
# float64, 8 rounds at most a job)
CLUSTER_KW = dict(n_samples=256, n_features=32, dtype="float64")
DML_KW = dict(n_samples=2048, n_features=32, n_folds=4)
# double_ml draws its rows in float32 on either device (the reference does
# too; a float64 problem widens them), and cuBLAS and the CPU's BLAS sum
# X @ m in other orders: theta-hat card against CPU is held at the CPU
# tests' limit against the reference (tests/test_torch_phases.py)
DML_THETA_RTOL = 1e-4
REPLAY_LOAD = dict(model="poisson", jobs=200, horizon_s=1200.0, seed=7,
                   rounds_max=8)
# a cluster job's residuals card against CPU.  A float64 lasso or logreg
# problem draws its rows in float32 and widens them (as the reference
# does), and lasso's targets b = A x_true + noise are float32 products
# that cuBLAS and the CPU's BLAS sum in other orders, so the two devices
# solve data a few float32 ulp apart; a converging job's s_norm, rho ·
# sqrt(W) · ||z - z_prev||, a difference of near-equal vectors, magnifies
# that.  On an "NVIDIA H100 80GB HBM3, 700.00 W": 4.4e-6 relative on a
# lasso job's round-5 s_norm of 2.7e-4 (mixed cluster), 1.6e-5 on a
# replayed lasso job's round-8 s_norm of 1.3e-2.  So a residual is held
# at CLUSTER_RTOL relative, or within TRACE_FLOOR of its trace's largest
# value; the reports, which follow the inner counts, are held equal
CLUSTER_RTOL = 1e-4
TRACE_FLOOR = 1e-8


def cluster_fingerprint(res):
    """The report and every job's summary: what two runs of one batch must
    share exactly."""
    return (res.report.to_dict(),
            [j.summary() for j in sorted(res.jobs, key=lambda j: j.job_id)])


def hold_cluster(name, got, want, rtol=CLUSTER_RTOL):
    """Card against CPU: the reports and summaries equal, every done job's
    trace within ``rtol`` (or ``TRACE_FLOOR`` of the trace's largest
    value) with equal inner counts.  Returns the worst relative trace
    gap."""
    if cluster_fingerprint(got) != cluster_fingerprint(want):
        fail(f"{name}: the card's cluster report differs from the CPU's")
    worst = 0.0
    for a, b in zip(got.jobs, want.jobs):
        if a.state != "done":
            continue
        want_rows = rsr(b.result.trace)
        scale = max(abs(v) for row in want_rows for v in row)
        worst = max(worst, hold(f"{name} job {a.job_id}",
                                rsr(a.result.trace), want_rows, rtol,
                                floor=TRACE_FLOOR * scale))
        if ([r["inner_mean"] for r in a.result.trace]
                != [r["inner_mean"] for r in b.result.trace]):
            fail(f"{name} job {a.job_id}: inner iterations differ from the "
                 f"CPU's")
    return worst


def float64_dag(rt, dag):
    """``dag`` with every stage's problem in float64."""
    return rt.DagSpec(stages=tuple(dataclasses.replace(
        s, spec=dataclasses.replace(s.spec, problem_kwargs={
            **s.spec.problem_kwargs, "dtype": "float64"}))
        for s in dag.stages), label=dag.label)


def phase_small_cluster(torch, api, problems, rt, AdmmOptions, lv, st):
    """The float64 kernel path, a mixed cluster, double_ml and a replay,
    each on the card and on the CPU."""
    args = (api, rt.SchedulerConfig, AdmmOptions, rt.PoolConfig)
    f64 = dict(ENGINE_KW, dtype="float64")
    lv.reset_launches()
    st.reset_launches()
    card = small_run(*args, f64, ENGINE_W, ENGINE_ROUNDS, "batched", "cuda",
                     "cuda")
    n_margin, n_z = lv.LAUNCHES["logistic"], st.LAUNCHES["soft_threshold"]
    cpu = small_run(*args, f64, ENGINE_W, ENGINE_ROUNDS, "batched", "torch",
                    "cpu")
    g1 = hold("engine instance float64 kernel=cuda (card) vs kernel=torch "
              "(CPU)", rsr(card.trace), rsr(cpu.trace), ANCHOR_RTOL)
    if n_margin == 0 or n_z != 0 or any(r["z_nnz"] != -1
                                        for r in card.trace):
        fail(f"float64 kernel=cuda: {n_margin} margin launches (want > 0) "
             f"and {n_z} z-update launches (want 0: the plain float64 prox)")
    say(f"[3] engine instance in float64 with kernel=\"cuda\" on the card "
        f"(the margin kernel in float32, {n_margin} launches; the plain "
        f"float64 z-update) vs kernel=\"torch\" on the CPU: {g1:.2e} (rtol "
        f"{ANCHOR_RTOL:g})")

    kws = {"lasso": CLUSTER_KW, "logreg": dict(CLUSTER_KW, density=0.2)}

    def mix(device, policy, engine):
        probs = {name: problems.make(name, device=device, **kw)
                 for name, kw in kws.items()}
        c = rt.Cluster(rt.ClusterConfig(policy=policy, engine=engine,
                                        max_concurrent_jobs=2,
                                        max_active_workers=8), device=device)
        jobs = [("lasso", i, "loop") for i in range(4)] + [
            ("logreg", 10 + i, "batched") for i in range(2)]
        for name, seed, engine_ in jobs:
            c.submit(api.ExperimentSpec(
                problem=name, problem_kwargs=kws[name],
                scheduler=rt.SchedulerConfig(
                    n_workers=4, engine=engine_,
                    admm=AdmmOptions(max_iters=5),
                    pool=rt.PoolConfig(seed=seed,
                                       provider=rt.ProviderConfig())),
                max_rounds=5), tenant=f"t{seed % 2}", problem=probs[name])
        return c.run_all()

    worst = 0.0
    for policy in ("fifo", "drf"):
        runs = {(dev, eng): mix(dev, policy, eng)
                for dev in ("cuda", "cpu") for eng in ("heap", "scan")}
        for eng in ("heap", "scan"):
            worst = max(worst, hold_cluster(
                f"mixed cluster {policy}/{eng}", runs["cuda", eng],
                runs["cpu", eng]))
        if (cluster_fingerprint(runs["cuda", "heap"])
                != cluster_fingerprint(runs["cuda", "scan"])):
            fail(f"mixed cluster {policy}: heap and scan reports differ")
    rep = runs["cuda", "heap"].report
    say(f"[3] mixed cluster (4 lasso + 2 logreg jobs, 2 tenants, float64), "
        f"fifo and drf, heap and scan: card reports equal the CPU's and "
        f"heap equals scan; traces {worst:.2e} apart (rtol "
        f"{CLUSTER_RTOL:g}, equal inner counts); drf p50 "
        f"{rep.p50_latency_s:.3f} s, warm-hit "
        f"rate {rep.warm_hit_rate:.3f}")

    thetas = {}
    for device in ("cuda", "cpu"):
        for reservation in rt.cluster.RESERVATIONS:
            c = rt.Cluster(rt.ClusterConfig(reservation=reservation),
                           device=device)
            h = api.submit_dag(float64_dag(rt, problems.double_ml_dag(
                **DML_KW)), cluster=c, tenant="dml")
            res = c.run_all()
            if h.state != "done":
                fail(f"double_ml {reservation} on {device}: DAG {h.state}")
            thetas[device, reservation] = (
                float(h.stage_results["combine"].z[0]),
                res.report.makespan_s)
    for device in ("cuda", "cpu"):
        if thetas[device, "phase"][0] != thetas[device, "peak"][0]:
            fail(f"double_ml on {device}: theta-hat differs between the "
                 f"reservations: {thetas[device, 'phase'][0]!r} vs "
                 f"{thetas[device, 'peak'][0]!r}")
    gap = abs(thetas["cuda", "phase"][0] - thetas["cpu", "phase"][0])
    theta = thetas["cpu", "phase"][0]
    if not gap <= DML_THETA_RTOL * abs(theta):
        fail(f"double_ml: theta-hat on the card {thetas['cuda', 'phase'][0]!r}"
             f" vs the CPU {theta!r}")
    say(f"[3] double_ml (n={DML_KW['n_samples']}, p={DML_KW['n_features']}, "
        f"K={DML_KW['n_folds']}, float64 stages): theta-hat "
        f"{thetas['cuda', 'phase'][0]:.9f} on the card, {theta:.9f} on the "
        f"CPU ({gap / abs(theta):.2e} relative, rtol {DML_THETA_RTOL:g}), "
        f"the same under reservation=phase and peak; makespan phase "
        f"{thetas['cuda', 'phase'][1]:.2f} s, peak "
        f"{thetas['cuda', 'peak'][1]:.2f} s (simulated)")

    templates = {name: dict(t, problem_kwargs=dict(t["problem_kwargs"],
                                                   dtype="float64"))
                 for name, t in rt.loadgen.DEFAULT_TEMPLATES.items()}
    wl = rt.generate(rt.LoadSpec(**REPLAY_LOAD), templates=templates)
    replays, walls = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        replays[device] = api.replay(wl, cluster=rt.Cluster(
            rt.ClusterConfig(policy="fair_share"), device=device))
        walls[device] = time.time() - t0
    gap = hold_cluster("replay", replays["cuda"], replays["cpu"])
    rep = replays["cuda"].report
    n_rounds = sum(j.rounds for j in replays["cuda"].jobs)
    if any(j.state != "done" for j in replays["cuda"].jobs):
        fail("replay: a job did not finish")
    say(f"[3] Poisson replay ({len(wl)} jobs, {n_rounds} rounds, float64, "
        f"fair_share): card report equals the CPU's, traces {gap:.2e} apart "
        f"(rtol {CLUSTER_RTOL:g});"
        f" p50 {rep.p50_latency_s:.2f} s, p95 {rep.p95_latency_s:.2f} s, "
        f"deadline attainment {rep.deadline_attainment:.3f}, warm-hit rate "
        f"{rep.warm_hit_rate:.3f}; wall {walls['cuda']:.1f} s on the card, "
        f"{walls['cpu']:.1f} s on the CPU")


# ---------------------------------------------------------------------------
# phases 4 and 6: the paper's size
# ---------------------------------------------------------------------------


def paper_spec(api, SchedulerConfig, phase, kernel="cuda", pool=None):
    """Phase ``phase``'s deployment as an ExperimentSpec (the pool config
    ``pool`` if given)."""
    name, kw, _ = PAPER_PATHS[phase]
    extra = {} if pool is None else {"pool": pool}
    return api.ExperimentSpec(
        problem=name, problem_kwargs=kw,
        scheduler=SchedulerConfig(n_workers=PAPER_W, engine="batched",
                                  kernel=kernel, **extra),
        max_rounds=PAPER_ROUNDS)


def paper_run(torch, api, SchedulerConfig, problem, phase, kernel, lv, st):
    """PAPER_ROUNDS rounds of phase ``phase``'s deployment on ``problem``;
    the wall and the margin and z-update kernels' launch counts after each
    round."""
    loss = PAPER_PATHS[phase][2]
    spec = paper_spec(api, SchedulerConfig, phase, kernel)
    walls, per_round = [], []
    t_last = [0.0]

    def on_round(m):
        torch.cuda.synchronize()
        now = time.time()
        walls.append(now - t_last[0])
        t_last[0] = now
        per_round.append((lv.LAUNCHES[loss], st.LAUNCHES["soft_threshold"]))

    lv.reset_launches()
    st.reset_launches()
    torch.cuda.synchronize()
    t_last[0] = time.time()
    res = api.run(spec, problem=problem, on_round=on_round)
    return res, walls, per_round


def control_mask(mask, frac: float = CONTROL_FRAC):
    """The control's row mask: the last ceil(frac · n) of each lane's n
    real rows (the leading n, as ``batch_shards`` lays them out) masked
    out — what a kernel that dropped the tail of each lane would see."""
    ctrl = mask.clone()
    for w, n in enumerate(mask.sum(dim=1).tolist()):
        n = int(n)
        ctrl[w, n - math.ceil(n * frac):n] = 0.0
    return ctrl


def round_keys(res):
    """Per round of a RunResult: (r_norm, s_norm, rho, the per-worker inner
    counts, z_nnz) — what two runs of one spec must share bit for bit."""
    return [(m.r_norm, m.s_norm, m.rho, tuple(m.inner_iters.tolist()),
             m.z_nnz) for m in res.history]


def witness_gaps(got, want):
    """Over the rounds of two traces (lists of trace rows): the worst
    relative gap of r_norm, s_norm and rho, and the largest |inner_mean|
    gap, of ``got`` against ``want``."""
    if len(got) != len(want):
        fail(f"witness: {len(got)} rounds against {len(want)}")
    rel, inner = 0.0, 0.0
    for g, w in zip(got, want):
        for key in ("r_norm", "s_norm", "rho"):
            rel = max(rel, abs(g[key] - w[key]) / max(abs(w[key]), 1e-30))
        inner = max(inner, abs(g["inner_mean"] - w["inner_mean"]))
    return rel, inner


def phase_paper(torch, api, problems, SchedulerConfig, lv, st, ref,
                kernel_ms, phase, keep_rows=None):
    """Phase 4 (logreg) or 6 (svm): generate and stage the paper's data
    for W=64, run PAPER_ROUNDS rounds through ``api.run`` with
    kernel="cuda", hold the margin kernel against its plain version on the
    staged shards at the workers' last x, then the witness (the same
    rounds twice with kernel="torch", the plain sparse path on the card,
    whose two runs must agree bit for bit) and the control (the kernel path
    with ``control_mask``).  Returns the run's launch counts and its
    ``round_keys``; ``keep_rows`` (a dict) receives the sparse shards, the
    rows phase 8 reads."""
    name, kw, loss = PAPER_PATHS[phase]
    rtol, inner_limit = WITNESS_RTOL, WITNESS_INNER
    tag = f"[{phase}]"
    gamma = kw.get("smoothing", 0.0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    say(f"{tag} device memory in use before the phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.time()
    problem = problems.make(name, device="cuda", **kw)
    problem.batch_shards(PAPER_W)
    torch.cuda.synchronize()
    t_gen = time.time() - t0
    if keep_rows is not None:
        keep_rows.update(problem._shard_cache)
    t0 = time.time()
    (A, b_dense), mask = problem.kernel_batch_shards(PAPER_W)
    torch.cuda.synchronize()
    t_stage = time.time() - t0
    say(f"{tag} {name} at the paper's size: generated {kw['n_samples']} x "
        f"{kw['n_features']} (density {kw['density']}) in {t_gen:.2f} s; "
        f"staged dense shards {tuple(A.shape)} ({A.numel() * 4 / 1e9:.2f} "
        f"GB) in {t_stage:.2f} s")

    res, walls, per_round = paper_run(torch, api, SchedulerConfig, problem,
                                      phase, "cuda", lv, st)
    launches = {loss: lv.LAUNCHES[loss],
                "soft_threshold": st.LAUNCHES["soft_threshold"]}
    before = (0, 0)
    for row, wall, counts in zip(res.trace, walls, per_round):
        n_margin, n_z = (c - b for c, b in zip(counts, before))
        before = counts
        if n_margin <= 0 or n_z <= 0:
            fail(f"{name} round {row['k']}: {n_margin} {loss} and {n_z} "
                 f"z-update launches")
        busy = ""
        if kernel_ms:
            t_k = (n_margin * kernel_ms[loss]
                   + n_z * kernel_ms["soft_threshold"]) / 1e3
            busy = (f" (launches x phase-2 kernel time: {n_margin} x "
                    f"{kernel_ms[loss]:.3f} ms + {n_z} z-updates = "
                    f"{t_k:.2f} s)")
        say(f"{tag} round {row['k']}: wall {wall:.2f} s, {loss} launches "
            f"{n_margin}, z-update launches {n_z}{busy}, r_norm "
            f"{row['r_norm']:.6g}, s_norm {row['s_norm']:.6g}, rho "
            f"{row['rho']:g}, inner_mean {row['inner_mean']:.3f}, "
            f"inner_max {int(res.history[row['k'] - 1].inner_iters.max())}"
            f", z_nnz {row['z_nnz']}")
    z = res.z
    if z.shape != (kw["n_features"],) or not all(
            math.isfinite(v) for v in z.tolist()):
        fail(f"the {name} paper instance's z is not a finite d-vector")
    for row in res.trace:
        if not (math.isfinite(row["r_norm"]) and math.isfinite(row["s_norm"])
                and row["inner_mean"] >= 1 and row["z_nnz"] >= 0):
            fail(f"bad trace row {row}")

    # the staged shards: kernel against plain at the workers' last x
    xs = res.scheduler.x.contiguous()
    f_k, g_k = lv.margin_vjp_cuda(A, b_dense, mask, xs, loss=loss,
                                  gamma=gamma)
    f_p, g_p = (ref.logistic_vjp_ref(A, b_dense, mask, xs)
                if loss == "logistic"
                else ref.svm_vjp_ref(A, b_dense, mask, xs, gamma))
    torch.cuda.synchronize()
    err = max(max_err(torch, f_k, f_p, f"{loss} on the staged shards"),
              max_err(torch, g_k, g_p, f"{loss} grad on the staged shards"))
    del f_k, g_k, f_p, g_p
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"{tag} launches in the run: {launches} over {len(res.trace)} "
        f"rounds; peak device memory {peak:.2f} GB; kernel vs plain on the "
        f"staged shards {err:.2e} (tolerance {PARITY_RTOL:g} x max(1, "
        f"|plain|)); final z_nnz {int((abs(z) > 0).sum())}")

    # the witness, twice (it sums in a fixed order: the two runs must agree
    # bit for bit); the control: the kernel path with the tail of each lane
    # masked out
    witness, w_walls, _ = paper_run(torch, api, SchedulerConfig, problem,
                                    phase, "torch", lv, st)
    again, _, _ = paper_run(torch, api, SchedulerConfig, problem, phase,
                            "torch", lv, st)
    mask_ctrl = control_mask(mask)
    cut = int((mask - mask_ctrl).sum(dim=1).max())
    problem._kernel_batch_cache[PAPER_W] = ((A, b_dense), mask_ctrl)
    control, _, _ = paper_run(torch, api, SchedulerConfig, problem, phase,
                              "cuda", lv, st)
    problem._kernel_batch_cache[PAPER_W] = ((A, b_dense), mask)
    rel, inner = witness_gaps(res.trace, witness.trace)
    s_rel, s_inner = witness_gaps(again.trace, witness.trace)
    c_rel, c_inner = witness_gaps(control.trace, witness.trace)
    for label, r in (("torch", witness), ("torch again", again),
                     ("control", control)):
        say(f"{tag} {label} run: " + "; ".join(
            f"round {row['k']} r_norm {row['r_norm']:.6g}, s_norm "
            f"{row['s_norm']:.6g}, rho {row['rho']:g}, inner_mean "
            f"{row['inner_mean']:.3f}" for row in r.trace))
    repeats = round_keys(again) == round_keys(witness)
    say(f"{tag} witness: cuda vs torch worst relative gap (r_norm, s_norm, "
        f"rho) {rel:.3e} (limit {rtol:g}), inner_mean gap {inner:.3f} "
        f"(limit {inner_limit:g}); torch vs torch again (the witness's "
        f"spread) {s_rel:.3e}, {s_inner:.3f}, every round bitwise equal: "
        f"{repeats}; control (last {cut} rows of each lane masked) vs torch "
        f"{c_rel:.3e}, inner_mean gap {c_inner:.3f}; torch round walls "
        f"{', '.join(f'{w:.2f}' for w in w_walls)} s")
    if not repeats or s_rel != 0.0 or s_inner != 0.0:
        fail(f"{name} paper instance: the kernel=\"torch\" witness does not "
             f"repeat bit for bit ({s_rel:.3e} relative, {s_inner:.3f} "
             f"inner_mean)")
    if not (rel <= rtol and inner <= inner_limit):
        fail(f"{name} paper instance: the cuda run strays from the torch "
             f"run ({rel:.3e} relative, {inner:.3f} inner_mean)")
    if c_rel <= rtol and c_inner <= inner_limit:
        say(f"{tag} the control passes the witness's limits: the witness "
            f"cannot tell it apart; phase 2's per-call parity is the guard")
    return launches, round_keys(res)


# phase 7: the multi-tenant cluster at the paper's size.  Four jobs of two
# tenants submitted at t = 0 to one DRF cluster: alice runs phase 4's logreg
# deployment twice, bob phase 6's svm deployment twice, each job on a pool
# seed of its own.  One logreg and one svm instance, each shared by its
# tenant's two jobs (as api.replay shares one instance per template), svm
# on logreg's rows.  Two jobs of 64 workers fit the 128-worker cap at once
CLUSTER7 = dict(policy="drf", max_concurrent_jobs=2, max_active_workers=128,
                share_provider=True)
JOBS7 = (("alice", 4, 41), ("alice", 4, 42), ("bob", 6, 61), ("bob", 6, 62))
PEAK_LIMIT_GB = 80.0
KERNELS7 = ("logistic", "hinge", "soft_threshold")


def launch_counts(lv, st):
    return {"logistic": lv.LAUNCHES["logistic"],
            "hinge": lv.LAUNCHES["hinge"],
            "soft_threshold": st.LAUNCHES["soft_threshold"]}


def count_job_steps(torch, cluster, lv, st, per_job):
    """Wrap ``cluster._dispatch`` so each dispatched job's ``step`` records
    into ``per_job[job_id]`` its host wall (synchronized) and the launches
    of each ADMM kernel it made, round by round."""
    dispatch = cluster._dispatch

    def spy(job, at, **kw):
        dispatch(job, at, **kw)
        step = job.scheduler.step
        rounds = per_job.setdefault(job.job_id, [])

        def counted(*a, _step=step, _rounds=rounds, **k):
            torch.cuda.synchronize()
            before, t0 = launch_counts(lv, st), time.time()
            out = _step(*a, **k)
            torch.cuda.synchronize()
            after = launch_counts(lv, st)
            _rounds.append((time.time() - t0, {
                n: after[n] - before[n] for n in KERNELS7}))
            return out
        job.scheduler.step = counted
    cluster._dispatch = spy


def phase_cluster(torch, api, problems, rt, lv, st, solo, solo_launches,
                  kernel_ms):
    """Phase 7: the four jobs under the heap engine, then the scan engine,
    each job's rounds held bit for bit to its solo run (phase 4's or 6's
    in this call, else run here), heap's report to scan's, the margin
    launches to the sum of the jobs' own, the peak memory to the card.
    Returns the launches read around each engine's run."""
    tag = "[7]"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    say(f"{tag} device memory in use before the phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.time()
    inst = {4: problems.make("logreg", device="cuda", **PAPER_KW),
            6: problems.make("svm", device="cuda", **SVM_KW)}
    inst[4].batch_shards(PAPER_W)
    # svm reads the logreg generator on the same config: the same rows
    inst[6]._shard_cache.update(inst[4]._shard_cache)
    torch.cuda.synchronize()
    t_gen = time.time() - t0
    t0 = time.time()
    staged = [p.kernel_batch_shards(PAPER_W)[0][0] for p in inst.values()]
    torch.cuda.synchronize()
    say(f"{tag} generated the paper's rows once in {t_gen:.2f} s (svm on "
        f"logreg's shards); staged two dense batches "
        f"{' and '.join(str(tuple(a.shape)) for a in staged)} "
        f"({sum(a.numel() for a in staged) * 4 / 1e9:.2f} GB) in "
        f"{time.time() - t0:.2f} s")
    del staged
    for phase in (4, 6):
        if phase not in solo:
            loss = PAPER_PATHS[phase][2]
            lv.reset_launches()
            st.reset_launches()
            res = api.run(paper_spec(api, rt.SchedulerConfig, phase),
                          problem=inst[phase])
            solo[phase] = round_keys(res)
            solo_launches[phase] = {loss: lv.LAUNCHES[loss]}
            say(f"{tag} solo run of phase {phase}'s spec (phase {phase} did "
                f"not run in this call): {lv.LAUNCHES[loss]} {loss} "
                f"launches")

    fingerprints, counts = {}, {}
    for engine in ("heap", "scan"):
        c = rt.Cluster(rt.ClusterConfig(engine=engine, **CLUSTER7),
                       device="cuda")
        jobs = [(c.submit(paper_spec(api, rt.SchedulerConfig, phase,
                                     pool=rt.PoolConfig(seed=seed)),
                          tenant=tenant, problem=inst[phase]), phase)
                for tenant, phase, seed in JOBS7]
        per_job = {}
        count_job_steps(torch, c, lv, st, per_job)
        lv.reset_launches()
        st.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        res = c.run_all()
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts[engine] = launch_counts(lv, st)
        summed = {n: sum(d[n] for rounds in per_job.values()
                         for _, d in rounds) for n in KERNELS7}
        if summed != counts[engine]:
            fail(f"{tag} {engine}: launches {counts[engine]} against the "
                 f"jobs' own {summed}")
        for job, phase in jobs:
            name, _, loss = PAPER_PATHS[phase]
            rounds = per_job[job.job_id]
            n_margin = sum(d[loss] for _, d in rounds)
            n_z = sum(d["soft_threshold"] for _, d in rounds)
            if job.state != "done" or round_keys(job.result) != solo[phase]:
                fail(f"{tag} {engine}: job {job.job_id} ({job.tenant}, "
                     f"{name}) does not repeat its solo run bit for bit: "
                     f"{round_keys(job.result)[:1]} against "
                     f"{solo[phase][:1]}")
            if (n_margin != solo_launches[phase][loss]
                    or n_z != len(rounds)):
                fail(f"{tag} {engine}: job {job.job_id} made {n_margin} "
                     f"{loss} and {n_z} z-update launches; its solo run "
                     f"{solo_launches[phase][loss]} and {len(rounds)}")
            parts = []
            for k, (w, d) in enumerate(rounds, 1):
                busy = ""
                if kernel_ms:
                    t_k = (d[loss] * kernel_ms[loss]
                           + d["soft_threshold"]
                           * kernel_ms["soft_threshold"]) / 1e3
                    busy = (f" ({d[loss]} x {kernel_ms[loss]:.3f} ms = "
                            f"{t_k:.2f} s of kernel, host share "
                            f"{1 - t_k / w:.3f})")
                parts.append(f"round {k} {w:.2f} s{busy}")
            say(f"{tag} {engine}: job {job.job_id} {job.tenant} {name}: "
                f"latency {job.latency_s:.3f} s, cost "
                f"${job.result.cost_usd:.6f} (simulated), {job.rounds} "
                f"rounds, {n_margin} {loss} + {n_z} z-update launches; "
                + "; ".join(parts))
        rep = res.report
        say(f"{tag} {engine}: 4 jobs in {wall:.2f} s of wall; report p50 "
            f"{rep.p50_latency_s:.3f} s, p95 {rep.p95_latency_s:.3f} s, "
            f"makespan {rep.makespan_s:.3f} s, warm-hit rate "
            f"{rep.warm_hit_rate:.3f}, cost ${rep.total_cost_usd:.6f} "
            f"(simulated); launches {counts[engine]}, each job's rounds "
            f"bitwise equal to its solo run")
        fingerprints[engine] = cluster_fingerprint(res)
        del c, res, jobs
    if fingerprints["heap"] != fingerprints["scan"]:
        fail(f"{tag} the heap and scan engines' reports differ")
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"{tag} heap and scan reports equal job for job; peak device "
        f"memory {peak:.2f} GB (limit {PEAK_LIMIT_GB:g})")
    if not peak < PEAK_LIMIT_GB:
        fail(f"{tag} peak device memory {peak:.2f} GB")
    del inst
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 3's second-order runs, and phase 8: the second-order path at size
# ---------------------------------------------------------------------------

# tests/test_newton.py's instance (n=512, d=32, W=8, redundancy 1: FRS with
# r = 2) in float64 under each barrier mode, on both engines and fan-ins
NEWTON_SMALL_KW = dict(n_samples=512, n_features=32, redundancy=1,
                       dtype="float64")
NEWTON_SMALL_W = 8
NEWTON_SMALL_ROUNDS = 8
NEWTON_SMALL_MODES = {"sync": {}, "drop_slowest": dict(drop_frac=0.125),
                      "replicated": dict(replication=2)}
# benchmarks/bench_newton.py's own configuration (float32): Newton with a
# redundancy-8 code under drop_slowest 8/64 on a clean and a straggling
# pool, and the logreg_l2 ADMM twin; rounds to 1e-3 of the gradient norm
# at 0.  The anchors in benchmarks/baselines/baselines.json come from
# another threefry layout (ROADMAP.md, Queue 3): printed, not held
BENCH_W = 64
BENCH_KW = dict(n_samples=1024, n_features=64, lam2=1e-3, seed=0)
BENCH_REDUNDANCY = 8
BENCH_TARGET_REL = 1e-3
BENCH_MAX_ROUNDS = dict(newton=25, admm=120)
BASELINES = ROOT / "benchmarks" / "baselines" / "baselines.json"
# phase 8: newton_sketch on the paper's rows (Section III) with the
# reference's defaults for the rest: lam2 1e-3, a count sketch of 8·d rows,
# redundancy 1 (FRS with r = 2: 63 blocks of ceil(80 000 / 63) = 1 270
# rows, task 2g and 2g+1 send the same message), W = 64, the batched
# engine.  Cut: 3 rounds (the reference's benchmark runs up to 25)
NEWTON_KW = dict(n_samples=600_000, n_features=10_000, density=0.001,
                 lam2=1e-3, sketch="count", sketch_dim=80_000, redundancy=1)
NEWTON_W = 64
NEWTON_ROUNDS = 3
# the decoded Hessian (the float32 decode, widened) against a float64
# oracle of the full stack from the same plan: relative Frobenius gap.  The
# control, the uncoded mean of 63 blocks (block 0 dropped without the
# code), must miss the limit by more than CONTROL_MARGIN
HESS_RTOL = 1e-5
CONTROL_MARGIN = 100.0
NEWTON_PEAK_GB = 60.0
# the largest device-to-host copy a Newton round may make (d² floats are
# 400 MB; z is 40 KB)
HOST_COPY_LIMIT = 1 << 20
# H100 SXM FP64 tensor-core rate (NVIDIA's data sheet): the master's solve
F64_OPS_PER_S = 67e12


def newton_spec(api, rt, AdmmOptions, kw, W, rounds, problem="newton_sketch",
                pool=None, **cfg):
    """A run of ``rounds`` rounds that no residual stops early."""
    return api.ExperimentSpec(
        problem=problem, problem_kwargs=kw,
        scheduler=rt.SchedulerConfig(
            n_workers=W, admm=AdmmOptions(eps_primal=-1.0),
            pool=pool if pool is not None else rt.PoolConfig(seed=0), **cfg),
        max_rounds=rounds)


def newton_keys(res):
    """Per round: (r_norm, s_norm, sim_time, cost_usd, inner counts)."""
    return [(m.r_norm, m.s_norm, m.sim_time, m.cost_usd,
             tuple(m.inner_iters.tolist())) for m in res.history]


def rounds_to_target(torch, api, spec, problem, grad_of, target):
    """Step ``spec`` on ``problem`` until ``grad_of(z)``'s norm reaches
    ``target``: (rounds or None, sim seconds, dollars) at that round."""
    _, sched = api.build(spec, problem=problem)
    for k in range(1, spec.max_rounds + 1):
        m, _ = sched.step()
        if float(torch.linalg.vector_norm(grad_of(sched.z))) <= target:
            return k, m.sim_time, m.cost_usd
    return None, m.sim_time, m.cost_usd


def phase_small_newton(torch, api, problems, rt, AdmmOptions, lv, st):
    """newton_sketch card against CPU: the small instance in float64 under
    every mode, engine and fan-in; bench_newton's configuration's rounds to
    target."""
    args = (api, rt, AdmmOptions)
    lv.reset_launches()
    st.reset_launches()
    worst = 0.0
    for mode, extra in NEWTON_SMALL_MODES.items():
        for fanin in ("flat", "tree"):
            keys = {(engine, dev): newton_keys(api.run(newton_spec(
                *args, NEWTON_SMALL_KW, NEWTON_SMALL_W, NEWTON_SMALL_ROUNDS,
                mode=mode, engine=engine, fanin=fanin, **extra), device=dev))
                for engine in ("loop", "batched") for dev in ("cuda", "cpu")}
            name = f"newton_sketch {mode}/{fanin}"
            for dev in ("cuda", "cpu"):
                if keys["loop", dev] != keys["batched", dev]:
                    fail(f"{name} on {dev}: the loop and batched engines' "
                         f"rounds differ")
            card, cpu = keys["batched", "cuda"], keys["batched", "cpu"]
            worst = max(worst, hold(f"{name} float64 card vs CPU", card, cpu,
                                    F64_RTOL, cols=(0, 1)))
            if [k[2:] for k in card] != [k[2:] for k in cpu]:
                fail(f"{name}: the card's clock, bill or inner counts "
                     f"differ from the CPU's")
    say(f"[3] newton_sketch (n={NEWTON_SMALL_KW['n_samples']}, "
        f"d={NEWTON_SMALL_KW['n_features']}, W={NEWTON_SMALL_W}, "
        f"{NEWTON_SMALL_ROUNDS} rounds, float64) under "
        f"{', '.join(NEWTON_SMALL_MODES)}, flat and tree: loop == batched "
        f"bit for bit on each device; card vs CPU {worst:.2e} (rtol "
        f"{F64_RTOL:g}), sim_time, cost_usd and inner counts equal")

    anchors = json.loads(BASELINES.read_text())["bench_newton.json"]
    legs = {}
    for dev in ("cuda", "cpu"):
        pn = problems.make("newton_sketch", device=dev,
                           redundancy=BENCH_REDUNDANCY, **BENCH_KW)
        target = BENCH_TARGET_REL * float(torch.linalg.vector_norm(
            pn.full_grad(torch.zeros(BENCH_KW["n_features"]))))
        for leg, stragglers in (("clean", False), ("straggler", True)):
            pool = (rt.PoolConfig(seed=0, straggler_frac=0.1,
                                  straggler_slowdown=8.0) if stragglers
                    else rt.PoolConfig(seed=0))
            legs[dev, f"newton.{leg}"] = rounds_to_target(
                torch, api, newton_spec(
                    *args, dict(BENCH_KW, redundancy=BENCH_REDUNDANCY),
                    BENCH_W, BENCH_MAX_ROUNDS["newton"], pool=pool,
                    mode="drop_slowest", drop_frac=8 / BENCH_W,
                    iter_smoothing=True),
                problems.make("newton_sketch", device=dev,
                              redundancy=BENCH_REDUNDANCY, **BENCH_KW),
                pn.full_grad, target)
        legs[dev, "admm.clean"] = rounds_to_target(
            torch, api, newton_spec(
                *args, BENCH_KW, BENCH_W, BENCH_MAX_ROUNDS["admm"],
                problem="logreg_l2", iter_smoothing=True),
            problems.make("logreg_l2", device=dev, **BENCH_KW), pn.full_grad,
            target)
    for leg in ("newton.clean", "newton.straggler", "admm.clean"):
        if legs["cuda", leg][0] != legs["cpu", leg][0]:
            fail(f"bench_newton {leg}: {legs['cuda', leg][0]} rounds to "
                 f"target on the card, {legs['cpu', leg][0]} on the CPU")
    if legs["cuda", "newton.straggler"][0] != legs["cuda", "newton.clean"][0]:
        fail("bench_newton: the coded straggler leg's rounds differ from the "
             "clean leg's")
    if lv.LAUNCHES != {"logistic": 0, "hinge": 0} or st.LAUNCHES[
            "soft_threshold"] != 0:
        fail(f"the second-order runs launched an ADMM kernel: {lv.LAUNCHES}"
             f", {st.LAUNCHES}")
    say("[3] bench_newton's configuration (n=1024, d=64, W=64, float32), "
        "rounds to 1e-3 of the gradient norm, card = CPU: " + "; ".join(
            f"{leg} {legs['cuda', leg][0]} (sim {legs['cuda', leg][1]:.3f} "
            f"s, ${legs['cuda', leg][2]:.6f}; baselines.json "
            f"{anchors[leg + '.rounds_to_target']:g})"
            for leg in ("newton.clean", "newton.straggler", "admm.clean")))


def spy_newton(problem, plan, parts):
    """Keep what the Newton phase's checks read: the decode's (total,
    n_used, responders) under ``parts["decoded"]`` and the line search's
    (alpha, accepted, evaluations) under ``parts["searched"]``.  The
    round's parts are timed by the program's own spans
    (``repro_torch.trace``)."""
    decode = plan.decode_sum
    line_search = problem._line_search

    def decode_sum(responders, messages):
        out = decode(responders, messages)
        parts["decoded"] = (*out, [int(w) for w in responders])
        return out

    def searched(*a):
        out = line_search(*a)
        parts["searched"] = out
        return out

    plan.decode_sum = decode_sum
    problem._line_search = searched


def traced_parts(summary) -> dict:
    """A round's parts from the tracer's summary of it, on the device's
    clock (the host's on a CPU run, where no CUDA event is recorded):
    "sketch" (the count sketch of every block), "grams" (the messages
    read: each a Gram product over its blocks' rows and the coding; "rows"
    counts them), "decode" (the whole decode, grams included), "solve",
    "line_search"."""
    spans = summary.spans

    def device_s(name):
        if name not in spans:
            return 0.0
        t = spans[name]
        return t.host_s if t.device_s is None else t.device_s
    return {"sketch": device_s("newton.scatter"),
            "grams": device_s("newton.gram"),
            "rows": spans["newton.gram"].n if "newton.gram" in spans else 0,
            "decode": device_s("newton.decode"),
            "solve": device_s("newton.solve"),
            "line_search": device_s("newton.line_search")}


def newton_bounds(plan, n_rows, nnz, d, n_reps, n_evals):
    """Each part's least time (ms, by), from shapes: bytes over the HBM rate
    or operations over the peak rate of their type."""
    W, br = plan.n_tasks, plan.block_rows
    L = (d + d * d) * 4
    rows_read = n_reps * plan.blocks_per_task() * br
    return {
        # rows (idx int64, vals, b), buckets int64 and signs per block in;
        # the sketched blocks and the gradient shards out
        "sketch": bound_ms(nnz * 12 + n_rows * 4 + W * n_rows * 12
                           + (W * br * d + W * d) * 4, 0),
        # a Gram product over each read message's rows (float32, no TF32)
        "grams": bound_ms(W * br * d * 4 + n_reps * L,
                          2.0 * rows_read * d * d),
        # the messages read once, the total written once
        "decode": bound_ms((n_reps + 1) * L, n_reps * (d + d * d)),
        # LU and two triangular solves of the float64 d x d system
        "solve": bound_ms(d * d * 8 * 2, 2 / 3 * d ** 3 + 2 * d * d,
                          F64_OPS_PER_S),
        # each objective reads the float64 rows and z once
        "line_search": bound_ms(n_evals * (nnz * 16 + n_rows * 8 + d * 8),
                                n_evals * 4 * nnz),
    }


def host_copies(torch, run, path: Path):
    """Run ``run()`` under the profiler: (its result, the byte counts of its
    device-to-host copies, or None when the profiler recorded no copy)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    if not copies:
        return out, None
    return out, [int(e.get("args", {}).get("bytes", 0)) for e in copies
                 if "DtoH" in e.get("name", "")]


def phase_newton(torch, api, problems, rt, AdmmOptions, lv, st, rows,
                 device="cuda"):
    """Phase 8: the Newton path at the paper's size under sync, then
    replicated (r = 2), then sync again, through ``api.run``; each round's
    wall split into its parts beside their bounds; the decoded Hessian of
    rounds 1 and 3 against a float64 oracle of the full stack, with the
    control; ``rows`` are phase 4's sparse shards when it ran."""
    from repro_torch import trace
    tag = "[8]"
    sync = torch.cuda.synchronize
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lv.reset_launches()
    st.reset_launches()
    say(f"{tag} {nvidia_smi('name,power.limit')}; device memory in use "
        f"before the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    d, W = NEWTON_KW["n_features"], NEWTON_W
    problem = problems.make("newton_sketch", device=device, **NEWTON_KW)
    t0 = time.time()
    if rows:
        problem._shard_cache[(0, 1)] = tuple(
            torch.cat(leaf) for leaf in zip(*(rows[w, PAPER_W]
                                              for w in range(PAPER_W))))
        how = "phase 4's shards, concatenated"
    else:
        how = "generated"
    idx, vals, b = problem._rows()
    sync()
    t_rows = time.time() - t0
    t0 = time.time()
    plan = problem._plan(W)
    plan._maps(idx.device)
    sync()
    t_plan = time.time() - t0
    n_rows, nnz = idx.shape[0], idx.numel()
    say(f"{tag} newton_sketch at the paper's size: {n_rows} x {d} rows "
        f"({nnz} nonzeros, {how}) in {t_rows:.2f} s; the plan for W={W} "
        f"({plan.n_blocks} + {plan.redundancy} blocks of {plan.block_rows} "
        f"rows, coded with r = {plan.redundancy + 1}) built and on the card "
        f"in {t_plan:.2f} s")

    runs, records, parts = {}, {}, {}
    spy_newton(problem, plan, parts)
    trace.enable()
    for label, mode in (("sync", "sync"), ("replicated", "replicated"),
                        ("sync again", "sync")):
        rounds, t_last = [], [0.0]

        def on_round(m, _label=label, _rounds=rounds):
            sync()
            now = time.time()
            total, n_used, resp = parts.pop("decoded")
            rec = dict(wall=now - t_last[0], n_resp=len(resp),
                       dropped=sorted(set(range(W)) - set(resp)),
                       searched=parts.pop("searched"))
            if _label == "sync" and m.k in (1, NEWTON_ROUNDS):
                rec["total"], rec["n_used"] = total, n_used
            _rounds.append(rec)
            t_last[0] = now

        spec = newton_spec(api, rt, AdmmOptions, NEWTON_KW, W, NEWTON_ROUNDS,
                           mode=mode, engine="batched", replication=2)

        def go(_spec=spec, _on_round=on_round):
            trace.reset()
            sync()
            t_last[0] = time.time()
            return api.run(_spec, problem=problem, on_round=_on_round)

        if label == "sync again":
            res, copies = host_copies(torch, go,
                                      ROOT / "build" / "newton_trace.json")
        else:
            res = go()
        if label == "sync":
            peak = torch.cuda.max_memory_allocated() / 1e9
        runs[label], records[label] = res, rounds
        summaries = trace.rounds()
        if len(summaries) != len(rounds):
            fail(f"{tag} the tracer summarised {len(summaries)} rounds of "
                 f"the {label} run's {len(rounds)}")
        for rec, summary in zip(rounds, summaries):
            rec.update(traced_parts(summary))
        for rec, m in zip(rounds, res.history):
            alpha, accepted, n_evals = rec["searched"]
            bounds = newton_bounds(plan, n_rows, nnz, d, rec["rows"], n_evals)
            rest = (rec["wall"] - rec["sketch"] - rec["decode"]
                    - rec["solve"] - rec["line_search"])
            split = "; ".join(
                f"{name} {t:.3f} (bound {bounds[key][0] / 1e3:.5f}, "
                f"{bounds[key][1]})" for name, key, t in (
                    ("sketch", "sketch", rec["sketch"]),
                    (f"Grams and coding of {rec['rows']} messages", "grams",
                     rec["grams"]),
                    ("decode", "decode", rec["decode"] - rec["grams"]),
                    ("float64 solve", "solve", rec["solve"]),
                    (f"line search of {n_evals} objective calls",
                     "line_search", rec["line_search"])))
            say(f"{tag} {label} round {m.k}: wall {rec['wall']:.3f} s = "
                f"{split}; rest {rest:.3f}; {rec['n_resp']} responders "
                f"(dropped {rec['dropped']}); r_norm {m.r_norm!r}, s_norm "
                f"{m.s_norm!r}, alpha {alpha:g}, Armijo accepted {accepted}")
    trace.disable()
    trace.reset()
    launches = (dict(lv.LAUNCHES), dict(st.LAUNCHES))

    def keys(label):
        return [(m.r_norm, m.s_norm) for m in runs[label].history]

    for label in ("replicated", "sync again"):
        if keys(label) != keys("sync") or (
                runs[label].z.tobytes() != runs["sync"].z.tobytes()):
            fail(f"{tag} the {label} run is not bitwise equal to the sync "
                 f"run: {keys(label)} against {keys('sync')}")
    rs = [m.r_norm for m in runs["sync"].history]
    for label, recs in records.items():
        if not all(rec["searched"][1] for rec in recs):
            fail(f"{tag} {label}: the Armijo test rejected every trial in a "
                 f"round")
    if not all(b < a for a, b in zip(rs, rs[1:])):
        fail(f"{tag} r_norm does not fall in every round: {rs}")
    if not all(math.isfinite(v) for v in runs["sync"].z.tolist()):
        fail(f"{tag} z is not finite")
    if any(launches[0].values()) or launches[1]["soft_threshold"]:
        fail(f"{tag} the phase launched an ADMM kernel: {launches}")
    if not peak < NEWTON_PEAK_GB:
        fail(f"{tag} peak device memory {peak:.2f} GB (limit "
             f"{NEWTON_PEAK_GB:g})")
    if copies is None:
        copy_note = ("the profiler recorded no device copy: the host copies "
                     "are not measured")
    else:
        if copies and max(copies) > HOST_COPY_LIMIT:
            fail(f"{tag} a device-to-host copy of {max(copies)} bytes in a "
                 f"Newton run (limit {HOST_COPY_LIMIT})")
        copy_note = (f"device-to-host copies in the profiled run: "
                     f"{len(copies)}, {sum(copies)} bytes in all, the largest "
                     f"{max(copies, default=0)} bytes (limit "
                     f"{HOST_COPY_LIMIT})")
    say(f"{tag} sync, replicated (r = 2) and sync again: every round's "
        f"r_norm and s_norm and the final z bitwise equal; r_norm falls in "
        f"every round ({', '.join(f'{r:.6g}' for r in rs)}), Armijo accepts "
        f"every step; margin and z-update launches {launches}; peak device "
        f"memory in the sync run {peak:.2f} GB (limit {NEWTON_PEAK_GB:g}); "
        f"{copy_note}")

    # the decoded Hessians against a float64 oracle of the full stack
    sched = runs["sync"].scheduler
    zs = {1: torch.zeros(d, device=idx.device), NEWTON_ROUNDS: sched.z_prev}
    kept = {k: (rec["total"], rec["n_used"]) for k, rec in
            enumerate(records["sync"], 1) if "total" in rec}
    del runs, records, sched
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    idx64, vals64, b64 = problem._data64()

    def oracle(z):
        margins = -b64 * torch.sum(vals64 * z.double()[idx64], dim=-1)
        sig = torch.sigmoid(margins)
        return plan.gram((idx64, vals64), weights=torch.sqrt(sig * (1 - sig)),
                         n_cols=d)

    def rel_fro(a, ref):
        return float(torch.linalg.matrix_norm(a - ref)
                     / torch.linalg.matrix_norm(ref))

    gaps = {}
    for k, (total, n_used) in kept.items():
        sync()
        t0 = time.time()
        ref = oracle(zs[k])
        sync()
        t_oracle = time.time() - t0
        gaps[k] = rel_fro(total[d:].view(d, d).double() / n_used, ref)
        if k == 1:
            # the same round again: the FRS twin of worker 0 carries its
            # message, so a decode without worker 0 equals the run's bit for
            # bit; the control drops block 0 without the code
            msgs, _ = problem.round_messages_all(zs[k], W)
            twin, _ = problem.decode(msgs, list(range(1, W)), W)
            if not torch.equal(twin, total):
                fail(f"{tag} the decode without worker 0 differs from the "
                     f"run's decode of all {W}")
            SA = msgs.SA[1:].reshape(-1, d)
            ctrl = rel_fro((SA.T @ SA).double() / (W - 1), ref)
            del msgs, SA, twin
        del ref
        say(f"{tag} round {k}'s decoded Hessian against the float64 oracle "
            f"(S D^1/2 A)^T (S D^1/2 A) ({t_oracle:.2f} s): relative "
            f"Frobenius gap {gaps[k]:.3e} (limit {HESS_RTOL:g})")
    peak_oracle = torch.cuda.max_memory_allocated() / 1e9
    say(f"{tag} control, the uncoded mean of {W - 1} blocks (block 0 "
        f"dropped): "
        f"{ctrl:.3e} against round 1's oracle ({ctrl / HESS_RTOL:.0f} x the "
        f"limit; must exceed {CONTROL_MARGIN:g} x); peak device memory of "
        f"the oracles {peak_oracle:.2f} GB")
    if not all(g <= HESS_RTOL for g in gaps.values()):
        fail(f"{tag} a decoded Hessian strays from the oracle: {gaps}")
    if not ctrl > CONTROL_MARGIN * HESS_RTOL:
        fail(f"{tag} the control passes within {CONTROL_MARGIN:g} x the "
             f"limit: the check cannot tell a dropped block")
    del problem, plan, kept
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: consensus-ADMM LM training
# ---------------------------------------------------------------------------

# (a) reduced granite_8b in float32 on the card against the CPU from one
# state: W=4, K=2, global batch 8, seq 16, prox l1, adapt_rho on, 3 rounds.
# Held at the CPU tests' tolerances against the reference
# (tests/test_torch_train.py): leaves at TOL, the metrics at 1e-5 (float32
# in other summation orders, through Adam's division by sqrt(v))
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_METRIC_RTOL = 1e-5
TRAIN_SMALL = dict(W=4, K=2, batch=8, seq=16, rounds=3, lam=1e-4)
# ... and in bf16 at test_round_step_in_bf16_tracks_jax's configuration
# (d_model 256, W=2, K=4, seq 64, l1 at 1e-5), held to that test's limits:
# one bf16 ulp of x moves the next Adam step, so leaves are held by their
# relative L2 gap (u's against x's norm), the metrics at 1e-3 relative
TRAIN_BF16_CFG = dict(dtype="bfloat16", d_model=256, n_heads=8, n_kv_heads=2,
                      head_dim=32, d_ff=512, vocab_size=4096)
TRAIN_BF16 = dict(W=2, K=4, batch=8, seq=64, rounds=3, lam=1e-5)
TRAIN_BF16_L2 = {"x": 5e-3, "u": 5e-3, "z": 5e-3, "opt": 3e-2}
TRAIN_BF16_METRIC_RTOL = 1e-3
# (b) granite_8b at full width (d 4096, 32 heads and 8 KV heads of 128,
# d_ff 14 336, vocab 49 152, bf16), its depth cut to 4 of 36 layers so
# that the W=2 state (about 51 GB) fits one card beside remat's
# activations; then the AdamW baseline at the same config
TRAIN_FULL = dict(layers=4, W=2, K=4, batch=8, seq=1024, rounds=3, lam=1e-5,
                  sgd_steps=3)
TRAIN_PEAK_GB = 76.0
# (c) the train CLI: 4 rounds straight against 2, then --resume for 2 more
TRAIN_CLI = ["--preset", "100m", "--steps"]


def train_rounds(torch, trainer, lm_data, configs, cfg, state, p, device):
    """``p["rounds"]`` rounds of make_round_step from ``state`` on the
    batches of steps 0, 1, ...; returns (state, [metrics as floats])."""
    ccfg = trainer.ConsensusConfig(n_workers=p["W"], local_steps=p["K"],
                                   prox="l1", lam=p["lam"], adapt_rho=True)
    step = trainer.make_round_step(cfg, ccfg)
    shape = configs.ShapeConfig("train", p["seq"], p["batch"], "train")
    trace = []
    for k in range(p["rounds"]):
        gb = lm_data.batch_for(cfg, shape, k, device=device)
        batch = {n: v.reshape((p["W"], p["batch"] // p["W"]) + v.shape[1:])
                 for n, v in gb.items()}
        state, m = step(state, batch)
        trace.append({n: float(v) for n, v in m.items()})
    return state, trace


def train_gaps(torch, tree, got, want, trace, trace_want, dtype):
    """The gaps between two runs from one state in multiples of phase 9a's
    limits for ``dtype``: ({field of the ConsensusState: gap}, {metric:
    gap}).  A field's gap is, in float32, its worst element over
    TRAIN_TOL; in bf16, its worst leaf's relative L2 gap (u's against x's
    norm, as test_round_step_in_bf16_tracks_jax holds them) over
    TRAIN_BF16_L2.  A metric's is its worst round over TRAIN_METRIC_RTOL
    (atol 1e-7) in float32, TRAIN_BF16_METRIC_RTOL in bf16."""
    fields = {}
    for field in got._fields:
        scale = getattr(want, "x" if field == "u" else field)
        for a, b, x in zip(tree.leaves(getattr(got, field)),
                           tree.leaves(getattr(want, field)),
                           tree.leaves(scale)):
            a, b, x = (t.detach().double().cpu() for t in (a, b, x))
            if dtype == "float32":
                r = float(((a - b).abs() / (TRAIN_TOL["atol"] + TRAIN_TOL[
                    "rtol"] * b.abs())).max())
            else:
                r = float(torch.linalg.vector_norm(a - b)) / max(
                    float(torch.linalg.vector_norm(x)), 1e-30) / \
                    TRAIN_BF16_L2.get(field, 5e-3)
            fields[field] = max(fields.get(field, 0.0), r)
    rtol, atol = ((TRAIN_METRIC_RTOL, 1e-7) if dtype == "float32"
                  else (TRAIN_BF16_METRIC_RTOL, 0.0))
    metrics = {}
    for mg, mc in zip(trace, trace_want):
        for n in mc:
            d, lim = abs(mg[n] - mc[n]), rtol * abs(mc[n]) + atol
            metrics[n] = max(metrics.get(n, 0.0),
                             0.0 if d == 0 else d / lim if lim else math.inf)
    return fields, metrics


def over_limit(gaps, limit):
    """The gaps of ``train_gaps`` above ``limit``."""
    fields, metrics = gaps
    return {**{k: v for k, v in fields.items() if not v <= limit},
            **{f"metric {k}": v for k, v in metrics.items()
               if not v <= limit}}


def fmt_gaps(gaps):
    return {k: float(f"{v:.3g}") for d in gaps for k, v in d.items()}


def card_cpu_runs(torch, trainer, lm_data, configs, tree, st, cfg, p,
                  base=None, tag="[9a]"):
    """p["rounds"] rounds from one state drawn on the CPU (``base``, by
    default ``init_state`` at seed 0), run on the CPU, the card and the
    card again: {name: (state, trace)}; checks the z-update launches
    (leaves x rounds on the card, 0 on the CPU) and that the repeat equals
    the first card run bit for bit."""
    if base is None:
        base = trainer.init_state(
            cfg, trainer.ConsensusConfig(n_workers=p["W"]),
            generator=torch.Generator().manual_seed(0), device="cpu")
    n_z = len(tree.leaves(base.z)) * p["rounds"]
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", "cuda"), ("repeat", "cuda")):
        st.reset_launches()
        runs[name] = train_rounds(
            torch, trainer, lm_data, configs, cfg,
            tree.tree_map(lambda t: t.to(dev, copy=True), base), p, dev)
        launches = st.LAUNCHES["soft_threshold"]
        if launches != (0 if dev == "cpu" else n_z):
            fail(f"{tag} {cfg.dtype} {name}: {launches} z-update launches, "
                 f"expected {0 if dev == 'cpu' else n_z}")
    (card, tg), (rep, tr) = runs["card"], runs["repeat"]
    spread = max(float((a.double() - b.double()).abs().max())
                 for a, b in zip(tree.leaves(rep), tree.leaves(card)))
    if spread != 0.0 or tr != tg:
        fail(f"{tag} {cfg.dtype}: the repeat on the card differs: spread "
             f"{spread}")
    return runs, n_z, spread


def phase_train_small(torch, configs, trainer, lm_data, model, tree, st, fa):
    """(a): the card against the CPU in float32 and in bf16, their
    launches, every leaf's gradient, and a repeat on the card bit for
    bit."""
    p = TRAIN_SMALL
    cfg = configs.reduced(configs.get_config("granite_8b"))
    # every parameter leaf gets a nonzero gradient on the card
    z = model.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    ps, build = tree.flatten(tree.tree_map(lambda t: t.cuda(), z))
    req = [t.requires_grad_() for t in ps]
    shape = configs.ShapeConfig("train", p["seq"], p["batch"], "train")
    fa.reset_launches()
    loss = model.loss_fn(build(req), cfg,
                         lm_data.batch_for(cfg, shape, 0, device="cuda"))[0]
    dead = [i for i, g in enumerate(torch.autograd.grad(loss, req))
            if not int(torch.count_nonzero(g))]
    loss = loss.detach()
    if dead or not math.isfinite(float(loss)):
        fail(f"[9a] loss {float(loss)}; leaves {dead} got no gradient")
    runs, n_z, spread = card_cpu_runs(torch, trainer, lm_data, configs, tree,
                                      st, cfg, p)
    (cpu, tc), (card, tg) = runs["cpu"], runs["card"]
    gaps = train_gaps(torch, tree, card, cpu, tg, tc, cfg.dtype)
    if over := over_limit(gaps, 1.0):
        fail(f"[9a] card vs CPU over the limits (in multiples of them): "
             f"{over}")
    n_leaves = n_z // p["rounds"]
    say(f"[9a] reduced granite_8b (float32, W={p['W']}, K={p['K']}, batch "
        f"{p['batch']}, seq {p['seq']}, l1, 3 rounds): card vs CPU in "
        f"multiples of the tolerance {TRAIN_TOL} (metrics "
        f"{TRAIN_METRIC_RTOL:g}) {fmt_gaps(gaps)}; loss "
        f"{[round(m['loss'], 5) for m in tg]}, rho "
        f"{[m['rho'] for m in tg]}; z-update launches {n_z} (= "
        f"{n_leaves} leaves x {p['rounds']}), flash 0; every "
        f"leaf's gradient nonzero; repeat spread {spread}")

    # bf16: cuBLAS's bf16 products, the bf16 embedding backward,
    # grad_downcast and the bf16 z cast, against the CPU
    p = TRAIN_BF16
    cfg = configs.reduced(configs.get_config("granite_8b"), **TRAIN_BF16_CFG)
    runs, n_z, spread = card_cpu_runs(torch, trainer, lm_data, configs, tree,
                                      st, cfg, p)
    (cpu, tc), (card, tg) = runs["cpu"], runs["card"]
    gaps = train_gaps(torch, tree, card, cpu, tg, tc, cfg.dtype)
    if over := over_limit(gaps, 1.0):
        fail(f"[9a] bf16 card vs CPU over the limits (in multiples of "
             f"them): {over}")
    if fa.LAUNCHES["flash_attention"]:
        fail(f"[9a] training launched the flash kernel "
             f"{fa.LAUNCHES['flash_attention']} times")
    say(f"[9a] reduced granite_8b in bf16 (d_model {cfg.d_model}, W={p['W']}"
        f", K={p['K']}, batch {p['batch']}, seq {p['seq']}, l1, 3 rounds): "
        f"card vs CPU in multiples of the relative L2 limits {TRAIN_BF16_L2}"
        f" (metrics {TRAIN_BF16_METRIC_RTOL:g}) {fmt_gaps(gaps)}; loss "
        f"{[round(m['loss'], 5) for m in tg]}; z-update launches {n_z}, "
        f"flash 0; repeat spread {spread}")


def train_flops(cfg, B, S):
    """(bf16 FLOP, float32 FLOP) of one worker step under remat: the body's
    matmuls 8·N·T (forward, recomputed forward, backward), the float32
    head 6·N_head·T, and the plain attention's masked full square,
    4·B·S²·H·hd a forward, four times over."""
    d, T = cfg.d_model, B * S
    per_layer = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd \
        + cfg.n_heads * cfg.hd * d + 3 * d * cfg.d_ff
    attn = 4 * B * S * S * cfg.n_heads * cfg.hd
    return (8 * cfg.n_layers * per_layer * T,
            6 * cfg.vocab_size * d * T + 4 * cfg.n_layers * attn)


def spy_train(torch, trainer, ops, parts, kept, sizes):
    """Wrap the round's parts (module functions, restored by the returned
    callable): each call adds its synchronized wall to ``parts[name]``.
    The z-update kernel's inputs and outputs for the first leaf of each
    size in ``sizes`` go into ``kept[size]``, outside the timing."""
    sync = torch.cuda.synchronize
    saved = []

    def timed(module, attr, name, after=None):
        fn = getattr(module, attr)
        saved.append((module, attr, fn))

        def wrapped(*a, **k):
            sync()
            t0 = time.time()
            out = fn(*a, **k)
            sync()
            parts[name] = parts.get(name, 0.0) + time.time() - t0
            parts[name + "_n"] = parts.get(name + "_n", 0) + 1
            if after is not None:
                after(a, out)
            return out
        setattr(module, attr, wrapped)

    def keep(args, out):
        if args[0].numel() in sizes:
            kept.setdefault(args[0].numel(), (args, out))
    for attr, name in (("dual_ascent", "dual"), ("value_and_grads", "fwd_bwd"),
                       ("augment", "augment"), ("omega_bar", "mean"),
                       ("z_update", "z_update"), ("rescale_duals", "rescale")):
        timed(trainer, attr, name)
    timed(trainer.opt_mod, "adamw_update", "adam")
    timed(ops, "fused_z_update", "z_kernel", keep)

    def restore():
        for module, attr, fn in saved:
            setattr(module, attr, fn)
    return restore


def check_kept_z(torch, ref, kept, tag="[9b]"):
    """The z-update kernel's outputs on the training leaves kept by the
    spy against its plain version on the same inputs: z and ||dz||^2 at
    PARITY_RTOL, nnz exact.  Returns, per size, the worst error and each
    side's ||dz||^2 relative to the float32 squares summed in float64."""
    errs = {}
    for size, ((omega, z_old, thr), (z_k, s_k, n_k)) in sorted(kept.items()):
        z_p, s_p, n_p = ref.soft_threshold_ref(
            omega, z_old, torch.as_tensor(thr, dtype=torch.float32,
                                          device="cuda"))
        if int(n_k) != int(n_p):
            fail(f"{tag} z-update on a {size}-element leaf: nnz {int(n_k)} "
                 f"!= plain {int(n_p)}")
        truth = float(torch.sum((z_p - z_old).square().double()))
        errs[size] = dict(
            max_abs_err=max(
                max_err(torch, z_k, z_p, f"{tag} z-update z ({size} elements)"),
                max_err(torch, s_k, s_p,
                        f"{tag} z-update ssq ({size} elements)")),
            ssq_rel_kernel=abs(float(s_k) - truth) / truth,
            ssq_rel_plain=abs(float(s_p) - truth) / truth)
        del z_p, s_p, n_p
    return errs


def phase_train_full(torch, configs, trainer, lm_data, model, opt, tree, ops,
                     st, fa, ref):
    """(b): granite_8b at full width, depth cut, W=2 ADMM rounds then
    AdamW steps; returns the z-update launches of the ADMM run.  Rounds 1
    and 3 run as they are and give the wall and tokens/s; round 2 runs
    under the timing spy, which splits it into parts and keeps the
    z-update's inputs on the two largest leaf sizes, held against the
    plain version after the round."""
    p = TRAIN_FULL
    cfg = dataclasses.replace(configs.get_config("granite_8b"),
                              n_layers=p["layers"])
    P = cfg.param_count()
    Bw = p["batch"] // p["W"]
    bf16, f32 = train_flops(cfg, Bw, p["seq"])
    step_bound = bf16 / BF16_OPS_PER_S + f32 / F32_OPS_PER_S
    n_steps = p["W"] * p["K"]
    say(f"[9b] {cfg.name} at full width (d {cfg.d_model}, {cfg.n_heads} "
        f"heads / {cfg.n_kv_heads} KV of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}), {cfg.n_layers} of 36 layers: "
        f"{P / 1e9:.4f}e9 parameters; a worker step {bf16 / 1e12:.2f} TFLOP "
        f"bf16 + {f32 / 1e12:.2f} TFLOP float32, bound {step_bound * 1e3:.1f}"
        f" ms")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ccfg = trainer.ConsensusConfig(n_workers=p["W"])
    state = trainer.init_state(
        cfg, ccfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    torch.cuda.synchronize()
    say(f"[9b] init_state (W={p['W']}): {time.time() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    ccfg = trainer.ConsensusConfig(n_workers=p["W"], local_steps=p["K"],
                                   prox="l1", lam=p["lam"], adapt_rho=True)
    step = trainer.make_round_step(cfg, ccfg)
    shape = configs.ShapeConfig("train", p["seq"], p["batch"], "train")
    sizes = sorted({t.numel() for t in tree.leaves(state.z)})[-2:]
    kept = {}
    st.reset_launches()
    fa.reset_launches()
    losses = []
    tokens = n_steps * Bw * p["seq"]
    for k in range(p["rounds"]):
        gb = lm_data.batch_for(cfg, shape, k, device="cuda")
        batch = {n: v.reshape((p["W"], Bw) + v.shape[1:])
                 for n, v in gb.items()}
        spied = k == 1
        parts = {}
        restore = spy_train(torch, trainer, ops, parts, kept, sizes) \
            if spied else (lambda: None)
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            restore()
        m = {n: float(v) for n, v in m.items()}
        losses.append(m["loss"])
        tail = (f"loss {m['loss']:.5f}, r {m['r_norm']:.5g}, s "
                f"{m['s_norm']:.5g}, rho {m['rho']:.5g}, nnz(z)/P "
                f"{m['z_nnz'] / P:.6f}")
        if not spied:
            say(f"[9b] round {k + 1}: wall {wall:.3f} s, {tokens / wall:.0f} "
                f"tokens/s, {(bf16 + f32) * n_steps / wall / 1e12:.1f} "
                f"TFLOP/s over the round ({n_steps} worker steps; bound "
                f"{step_bound * n_steps:.3f} s); {tail}")
            continue
        named = ("fwd_bwd", "augment", "adam", "dual", "mean", "z_update")
        rest = wall - sum(parts[n] for n in named)
        tflops = (bf16 + f32) * parts["fwd_bwd_n"] / parts["fwd_bwd"] / 1e12
        say(f"[9b] round {k + 1}, split by the timing spy (a synchronize "
            f"around each part): wall {wall:.3f} s = local fwd+bwd "
            f"{parts['fwd_bwd']:.3f} ({parts['fwd_bwd_n']} worker steps, "
            f"{tflops:.1f} TFLOP/s = {tflops * 1e12 / BF16_OPS_PER_S:.3f} of "
            f"the bf16 dense peak; bound {step_bound * parts['fwd_bwd_n']:.3f}"
            f") + augment {parts['augment']:.3f} + Adam {parts['adam']:.3f} "
            f"({parts['adam_n']} updates) + dual {parts['dual']:.3f} + "
            f"consensus mean {parts['mean']:.3f} + z-update "
            f"{parts['z_update']:.3f} (kernel {parts['z_kernel_n']} launches "
            f"x {parts['z_kernel'] / parts['z_kernel_n'] * 1e3:.3f} ms) + "
            f"rest {rest:.3f}; {tail}")
        if sorted(kept) != sizes:
            fail(f"[9b] the spy kept z-update inputs of sizes "
                 f"{sorted(kept)}, expected {sizes}")
        errs = check_kept_z(torch, ref, kept)
        kept.clear()
        say(f"[9b] round {k + 1}'s z-update kernel on the leaves of {sizes} "
            f"elements against its plain version on the same inputs "
            f"(limit {PARITY_RTOL:g} x scale on z and ||dz||^2; nnz equal; "
            f"||dz||^2 relative to a float64 sum): {errs}")
    launches = st.LAUNCHES["soft_threshold"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_leaves = len(tree.leaves(state.z))
    say(f"[9b] peak device memory {peak:.2f} GB; z-update launches "
        f"{launches} (= {n_leaves} leaves x {p['rounds']}), flash "
        f"{fa.LAUNCHES['flash_attention']}")
    if launches != n_leaves * p["rounds"]:
        fail(f"[9b] {launches} z-update launches, expected "
             f"{n_leaves * p['rounds']}")
    if fa.LAUNCHES["flash_attention"]:
        fail("[9b] training launched the flash kernel")
    if not all(map(math.isfinite, losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        fail(f"[9b] the loss is not finite and falling: {losses}")
    if peak > TRAIN_PEAK_GB:
        fail(f"[9b] peak {peak:.2f} GB above {TRAIN_PEAK_GB} GB")
    del state, batch, gb, step
    gc.collect()
    torch.cuda.empty_cache()

    # the AdamW baseline: one global batch of 8 per step
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(1),
        device="cuda")
    opt_state = opt.adamw_init(params)
    sgd = trainer.make_sgd_step(cfg)
    bf16_g, f32_g = train_flops(cfg, p["batch"], p["seq"])
    sgd_losses = []
    for k in range(p["sgd_steps"]):
        batch = lm_data.batch_for(cfg, shape, k, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        params, opt_state, m = sgd(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.time() - t0
        sgd_losses.append(float(m["loss"]))
        say(f"[9b] AdamW step {k + 1}: wall {wall:.3f} s, "
            f"{p['batch'] * p['seq'] / wall:.0f} tokens/s, "
            f"{(bf16_g + f32_g) / wall / 1e12:.1f} TFLOP/s (step included), "
            f"loss {sgd_losses[-1]:.5f}, grad norm {float(m['grad_norm']):.4g}")
    peak_sgd = torch.cuda.max_memory_allocated() / 1e9
    say(f"[9b] AdamW peak device memory {peak_sgd:.2f} GB")
    if not all(map(math.isfinite, sgd_losses)):
        fail(f"[9b] AdamW losses not finite: {sgd_losses}")
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_cli(torch, train, tree):
    """(c): train.main 4 rounds straight against 2 rounds into a checkpoint
    directory and --resume for 2 more, bit for bit, for both modes."""
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    for mode in ("admm", "sgd"):
        argv = TRAIN_CLI + ["4", "--mode", mode]
        t0 = time.time()
        straight = train.main(argv)
        t_straight = time.time() - t0
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            ck = ["--checkpoint-dir", d]
            t0 = time.time()
            train.main(TRAIN_CLI + ["2", "--mode", mode] + ck)
            resumed = train.main(argv + ["--resume"] + ck)
            t_resumed = time.time() - t0
        ls, lr = tree.leaves(straight), tree.leaves(resumed)
        diff = [i for i, (a, b) in enumerate(zip(ls, lr))
                if a.dtype != b.dtype or not torch.equal(a, b)]
        if diff or len(ls) != len(lr):
            fail(f"[9c] {mode}: resume differs from the straight run at "
                 f"leaves {diff}")
        say(f"[9c] train.main --preset 100m --mode {mode}: 4 rounds straight "
            f"({t_straight:.1f} s) equal 2 + --resume 2 ({t_resumed:.1f} s, "
            f"checkpoint I/O included) bit for bit over {len(ls)} leaves")


# ---------------------------------------------------------------------------
# phase 10: the other LM families
# ---------------------------------------------------------------------------

# (arch, depth cut or None, batch, prompt): full width in bf16 through
# serve.main with 64 tokens; granite_moe at full depth (its published
# capacity factor 1.25, groups of 512); the VLM cut to one group of 4 self
# blocks and 1 cross block of its 100 layers, mixtral to 2 of 32 layers
# (batch 4, prompt 4608, so its 4096-slot ring wraps)
FAMILIES = [("granite_moe_3b_a800m", None, 8, 2048),
            ("musicgen_large", None, 8, 2048),
            ("zamba2_1_2b", None, 8, 2048),
            ("rwkv6_1_6b", None, 8, 2048),
            ("llama3_2_vision_90b", 5, 8, 2048),
            ("mixtral_8x7b", 2, 4, 4608)]
FAMILY_GEN = 64
# (a): the reduced configs in float32, card against CPU
FAMILY_SMALL = dict(B=2, P=40, steps=4)
# prefill-then-decode, as phase 5's: relative L2 of the batch's logits
# over the vocabulary, in float32 (the witness: summation order only, the
# same argmax in every row) and in bf16, where the two paths round the
# residual stream differently in every layer and a random-weight network
# amplifies that by its own measure (zamba2 most).  zamba2's float32 limit
# is wider: the chunked SSD (chunk 128 at 2048 tokens, 3 at 2049) takes
# exp of differences of cumulative log-decays that reach about -1e3 in
# float32, and the reference's own prefill-then-decode differs as much
# (tests/test_torch_families.py holds the port's gap to the reference's
# on the CPU).  The limits lie between the readings of sound runs and of
# the controls one position off (PERF.md)
FAMILY_F32_REL_L2 = {"granite_moe_3b_a800m": 1e-4, "musicgen_large": 1e-4,
                     "zamba2_1_2b": 1e-3, "rwkv6_1_6b": 1e-4,
                     "llama3_2_vision_90b": 1e-4, "mixtral_8x7b": 1e-4}
FAMILY_BF16_REL_L2 = {"granite_moe_3b_a800m": 4e-2, "musicgen_large": 3e-2,
                      "zamba2_1_2b": 0.5, "rwkv6_1_6b": 0.5,
                      "llama3_2_vision_90b": 4e-2, "mixtral_8x7b": 4e-2}


@contextlib.contextmanager
def spying(module, name, keep):
    """Wrap ``module.name``: each call's ``keep(args, result)`` is appended
    to the list this yields; the function is restored on the way out."""
    fn, kept = getattr(module, name), []

    def spy(*args, **kw):
        out = fn(*args, **kw)
        kept.append(keep(args, out))
        return out
    setattr(module, name, spy)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


def family_launches(cfg, steps):
    """The attention launches a prefill and ``steps`` decode steps of
    ``cfg`` make, from the config alone: one flash launch per self-
    attention layer (the hybrid's shared block once per group), one
    causal=False launch per VLM cross block, one decode launch per
    attention layer and step; and the decode launches of the cross
    blocks among them."""
    n_cross = 0
    if cfg.family == "ssm":
        n_self = 0
    elif cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        n_self = cfg.n_layers - n_cross
    elif cfg.family == "hybrid":
        n_self = cfg.n_layers // cfg.attn_every
    else:
        n_self = cfg.n_layers
    return {"flash_attention": n_self, "flash_attention_noncausal": n_cross,
            "decode_attention": (n_self + n_cross) * steps}, n_cross * steps


def read_launches(fa, dec):
    return {**fa.LAUNCHES, "decode_attention": dec.LAUNCHES[
        "decode_attention"]}


def draw_zero_leaves(torch, params, seed):
    """Every all-zero leaf (the VLM's tanh gates, RWKV6's decay lora_b,
    biases) drawn anew, normal with std 0.5: at zero they would hide a
    broken cross-attention or decay path."""
    gen = torch.Generator().manual_seed(seed)
    for t in _leaves(params):
        if not bool(t.any()):
            t.copy_(torch.randn(t.shape, generator=gen).mul_(0.5))


def phase_families_reduced(torch, configs, model, serve, moe, fa, dec):
    """(a) Each family's reduced config in float32: prefill and greedy
    decode steps on the CPU (plain versions) and twice on the card
    (kernels), from one set of weights drawn on the CPU with the zero
    leaves drawn anew, fed the CPU's tokens."""
    B, P, steps = FAMILY_SMALL["B"], FAMILY_SMALL["P"], FAMILY_SMALL["steps"]
    for arch, _, _, _ in FAMILIES:
        cfg = configs.reduced(configs.get_config(arch))
        cpu = model.init_params(cfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
        draw_zero_leaves(torch, cpu, 1)
        card = tree_to(cpu, "cuda")
        prompt = serve.synthetic_prompt(cfg, B, P, 0, torch.device("cpu"))
        runs, toks = {}, []
        for run, params, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda"),
                                 ("repeat", card, "cuda")):
            fa.reset_launches()
            dec.reset_launches()
            p = tree_to(prompt, dev)
            with spying(moe, "route", lambda a, r: r.gate_idx.sort(-1)
                        .values.cpu()) as routes, torch.inference_mode():
                # over the vocabulary: the padded rows are -1e30
                V = cfg.vocab_size
                cache = model.init_cache(cfg, B, P + steps, device=dev)
                logits = [model.prefill(params, cfg, p, cache)[0][..., :V]
                          .cpu()]
                for i in range(steps):
                    if run == "cpu":
                        toks.append(logits[-1][:, -1].argmax(-1))
                    logits.append(model.decode_step(
                        params, cfg, serve.step_batch(
                            params, cfg, p, toks[i].to(dev), P + i),
                        cache)[0][..., :V].cpu())
            runs[run] = (logits, routes, read_launches(fa, dec))
        (lc, rc, _), (lg, rg, launches), (lr, rr, _) = \
            runs["cpu"], runs["card"], runs["repeat"]
        worst = max(max_err(torch, g, c, f"{arch} reduced, logits {i}",
                            REDUCED_RTOL)
                    for i, (g, c) in enumerate(zip(lg, lc)))
        for i, (g, c) in enumerate(zip(lg, lc)):
            if not torch.equal(g[:, -1].argmax(-1), c[:, -1].argmax(-1)):
                fail(f"{arch} reduced: the card's greedy tokens differ from "
                     f"the CPU's at step {i}")
        if len(rg) != len(rc) or not all(map(torch.equal, rg, rc)):
            fail(f"{arch} reduced: the card's experts differ from the CPU's")
        if not (all(map(torch.equal, lg, lr)) and len(rr) == len(rg)
                and all(map(torch.equal, rg, rr))):
            fail(f"{arch} reduced: a repeat on the card is not bit for bit")
        want, _ = family_launches(cfg, steps)
        if launches != want:
            fail(f"{arch} reduced: launches {launches}, expected {want}")
        say(f"[10a] {arch} reduced (float32, {cfg.n_layers} layers, B={B}, "
            f"prompt {P}, {steps} decode steps): card vs CPU logits "
            f"{worst:.2e} (tolerance {REDUCED_RTOL:g} x max(1, |CPU|)), "
            f"greedy tokens equal, {len(rg)} MoE routings equal, a repeat "
            f"bit for bit; launches {launches}")


def phase_families(torch, configs, model, serve, moe, ops, fa, dec,
                   kernel_ms):
    """(b) Each family at full width in bf16 through serve.main, with the
    attention launches read around the run; then one decode step's device
    time and prefill-then-decode against a longer prefill (the MoE models
    on a copy of the config with a dropless capacity factor, E / top_k).
    Returns the launches of all the runs."""
    total = {}
    for arch, depth, B, P in FAMILIES:
        cfg = configs.get_config(arch)
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            params = model.init_params(
                cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
        n_params = sum(t.numel() for t in _leaves(params))
        argv = ["--arch", arch, "--preset", "full", "--batch", str(B),
                "--prompt-len", str(P), "--gen-len", str(FAMILY_GEN)]
        stats = {}
        fa.reset_launches()
        dec.reset_launches()
        with spying(moe, "route", lambda a, r: r.kept) as kept, \
                spying(ops, "cross_attention",
                       lambda a, r: a[0].shape[1] == 1) as crosses:
            out = serve.main(argv, params=params, stats=stats, cfg=cfg)
        launches = read_launches(fa, dec)
        peak = torch.cuda.max_memory_allocated()
        steps = FAMILY_GEN - 1
        want, want_cross = family_launches(cfg, steps)
        if launches != want or sum(crosses) != want_cross:
            fail(f"{arch}: launches {launches}, {sum(crosses)} of them cross "
                 f"decode; expected {want}, {want_cross}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        if tuple(out.shape) != (B, FAMILY_GEN) or not bool(
                ((out >= 0) & (out < cfg.vocab_size)).all()):
            fail(f"{arch}: tokens of shape {tuple(out.shape)} or out of "
                 f"[0, {cfg.vocab_size})")
        for key in ("prefill_logits", "first_decode_logits", "last_logits"):
            if not bool(torch.isfinite(stats[key]).all()):
                fail(f"{arch}: non-finite {key}")
        drops = ""
        if cfg.n_experts:
            pre = [k for k in kept if k.shape[1] > 1]
            share = sum(int((~k).sum()) for k in pre) / sum(
                k.numel() for k in pre)
            drops = (f"; prefill drops {share:.4f} of its expert "
                     f"assignments at capacity factor "
                     f"{cfg.capacity_factor:g} (decode: "
                     f"{sum(int((~k).sum()) for k in kept if k.shape[1] == 1)}"
                     f")")
        del kept
        t_pre, ms_step = stats["prefill_s"], stats["decode_s"] / steps * 1e3
        prompt, tok = stats["prompt"], out[:, 0].cuda()
        # the MoE models at a dropless capacity factor: at 1.25 a longer
        # prefill drops other assignments than a prefill and a step
        held_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k) \
            if cfg.n_experts else cfg
        with torch.inference_mode():
            dev_ms = step_device_ms(torch, model, serve, params, cfg, prompt,
                                    tok, P, FAMILY_GEN)
            held = {"bfloat16": prefill_then_decode(
                torch, model, serve, params, held_cfg, prompt, tok, None)}
            del params
            torch.cuda.empty_cache()
            cfg32 = dataclasses.replace(held_cfg, dtype="float32")
            params = model.init_params(
                cfg32, generator=torch.Generator(device="cuda")
                .manual_seed(1), device="cuda")
            prompt32 = {k: v.float() if v.is_floating_point() else v
                        for k, v in prompt.items()}
            held["float32"] = prefill_then_decode(
                torch, model, serve, params, cfg32, prompt32, tok, None)
        del params, stats, prompt, prompt32
        n_attn = launches["flash_attention"] + launches[
            "flash_attention_noncausal"]
        say(f"[10] {arch} ({cfg.n_layers} layers, {n_params / 1e9:.3f} B "
            f"parameters, bf16, B={B}, prompt {P}, {FAMILY_GEN} tokens): "
            f"prefill {t_pre:.3f} s ({B * P / t_pre:.0f} tok/s); decode "
            f"{ms_step:.3f} ms per step eager, device time {dev_ms:.3f} ms "
            f"(one step in a CUDA graph), host share "
            f"{1 - dev_ms / ms_step:.3f}; launches {launches} (cross "
            f"decode {sum(crosses)}; {n_attn} attention layers x "
            f"{kernel_ms.get('decode_attention', float('nan')):.4f} ms of "
            f"phase-2 decode); peak device memory {peak / 1e9:.2f} GB"
            f"{drops}")
        limits = {"float32": FAMILY_F32_REL_L2[arch],
                  "bfloat16": FAMILY_BF16_REL_L2[arch]}
        for name, h in held.items():
            say(f"[10] {arch} prefill-then-decode, {name}"
                + (f" (capacity factor {held_cfg.capacity_factor:g}, "
                   f"dropless)" if cfg.n_experts else "")
                + f": relative L2 {h['rel']:.3e} (limit {limits[name]:g}), "
                f"same argmax in {h['same']:.3f} of rows, max gap "
                f"{h['gap']:.3e} of max |logit| {h['scale']:.3f}; the "
                f"control one position off: relative L2 "
                f"{h['ctrl_rel']:.3e}, same argmax in {h['ctrl_same']:.3f} "
                f"of rows")
        for name, h in held.items():
            if not h["rel"] <= limits[name]:
                fail(f"{arch} prefill-then-decode, {name}: relative L2 "
                     f"{h['rel']:.3e} over {limits[name]:g}")
            if not h["ctrl_rel"] > limits[name]:
                fail(f"{arch} prefill-then-decode, {name}: the control one "
                     f"position off passes the check")
        if held["float32"]["same"] != 1.0:
            fail(f"{arch} prefill-then-decode, float32: the argmax differs "
                 f"in {1 - held['float32']['same']:.3f} of rows")
    return total


# ---------------------------------------------------------------------------
# phase 11: the sharded steps (launch/steps.py) on the card's 1x1 mesh, the
# op analysis against the card's roofline, and the dry-run at production
# size on the CPU
# ---------------------------------------------------------------------------

# (a) decode steps through the sharded step after its prefill
SHARD_DECODE = 8
# (c) prefill's counted FLOPs against the analytic count of its matmuls
# (the body's, the head's at the last position) and the flash kernel's
FLOP_BAND = (1.0, 1.1)
# (d) granite_8b's cells on the (16, 16) mesh, each in a process of its own
DRYRUN_CELLS = (("train_4k", "sgd"), ("train_4k", "admm"),
                ("decode_32k", "decode"))
DRYRUN_BUDGET_S = 120.0
DRYRUN_TIMEOUT_S = 400


def start_dryrun():
    """(d)'s cells, each ``python -m repro_torch.launch.dryrun`` with no card
    visible (the fake process group never meets this process's), all
    started together on the CPU."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = []
    for shape, mode in DRYRUN_CELLS:
        procs.append(((shape, mode), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "granite_8b", "--shape", shape, "--mesh", "pod", "--mode", mode],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return time.time(), procs


def stop_dryrun(procs):
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_dryrun(t0, procs, card):
    """Wait for (d)'s cells; each must reach status "ok" and fit in the
    card's 80e9 B."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HBM_PER_CHIP
    for (shape, mode), proc in procs:
        try:
            out, err = proc.communicate(timeout=max(
                1.0, DRYRUN_TIMEOUT_S - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            fail(f"[11d] dry-run {shape} x {mode} ran over "
                 f"{DRYRUN_TIMEOUT_S} s")
        path = dryrun.OUT_DIR / f"granite_8b__{shape}__pod__{mode}.json"
        if proc.returncode != 0 or not path.is_file():
            fail(f"[11d] dry-run {shape} x {mode} exited "
                 f"{proc.returncode}: {(out + err)[-3000:]}")
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            fail(f"[11d] dry-run {shape} x {mode}: {rec['status']} "
                 f"{rec.get('error')}")
        s, r = rec["summary"], rec["roofline"]
        say(f"[11d] dry-run granite_8b x {shape} x pod (16x16) x {mode}, "
            f"rank 0 of 256 on this machine's CPU: peak {s['peak_bytes_est']:.4e}"
            f" B of {HBM_PER_CHIP:.0e} (arguments {s['arg_bytes']:.4e}), "
            f"fits {rec['fits_hbm']}; FLOPs {s['flops_per_chip']:.4e}, bytes "
            f"{s['bytes_per_chip']:.4e}; collectives {s['n_collective_ops']} "
            f"ops, link bytes by type {s['by_type']}; terms on the H100's "
            f"datasheet (compute {r['t_compute_s']:.4f} s, memory "
            f"{r['t_memory_s']:.4f} s, collective {r['t_collective_s']:.4f} "
            f"s, {r['dominant']}), useful {r['useful_flops_ratio']:.3f}; "
            f"ran {rec['run_s']} s")
        if not rec["fits_hbm"]:
            fail(f"[11d] dry-run {shape} x {mode} does not fit: peak "
                 f"{s['peak_bytes_est']:.4e} B")
    wall = time.time() - t0
    say(f"[11d] the {len(procs)} dry-run cells took {wall:.1f} s of wall "
        f"together (budget {DRYRUN_BUDGET_S:g} s) {card}")


def _local(t):
    """A DTensor's shard on the 1x1 mesh (the whole tensor), or ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def roofline_line(name, summary, ms, model_flops, card):
    """(c): the counter's FLOPs and bytes, the CUDA-event median time, the
    two roofline terms on the H100's datasheet, the achieved share and the
    useful-FLOPs ratio."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    t_c = summary["flops_per_chip"] / PEAK_FLOPS_BF16 * 1e3
    t_m = summary["bytes_per_chip"] / HBM_BW * 1e3
    dom = "compute" if t_c >= t_m else "memory"
    say(f"[11c] {name}: counted {summary['flops_per_chip']:.6e} FLOP "
        f"(kernels {summary['kernel_flops']}), {summary['bytes_per_chip']:.6e}"
        f" B unfused; median {ms:.3f} ms (CUDA events); t_compute "
        f"{t_c:.3f} ms, t_memory {t_m:.3f} ms, dominant {dom}, achieved "
        f"{max(t_c, t_m) / ms:.4f} of that bound; useful_flops_ratio "
        f"{model_flops / summary['flops_per_chip']:.4f} (model FLOPs "
        f"{model_flops:.6e}); {card}")


def sharded_serve(torch, configs, model, steps, ops, fa, dec, mesh, card):
    """(a) granite_8b at full width and depth, bf16: the sharded prefill
    (B=8, prompt 2048) and SHARD_DECODE sharded decode steps against
    model.prefill / decode_step on the same weights, bit for bit, with a
    control one position off; then (c) for the prefill and one decode
    step."""
    cfg = configs.get_config("granite_8b")
    B, P, n = SERVE_B, SERVE_P, SHARD_DECODE
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    prompt = torch.randint(0, V, (B, P), dtype=torch.int32, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(5))
    bp = steps.build_step(cfg, configs.ShapeConfig("serve", P, B, "prefill"),
                          mesh, "prefill")
    bd = steps.build_step(cfg, configs.ShapeConfig("serve", P + n + 1, B,
                                                   "decode"), mesh, "decode")
    pos = lambda i: torch.full((B,), P + i, dtype=torch.int32, device="cuda")
    greedy = lambda lg: lg[:, -1, :V].argmax(-1)

    fa.reset_launches()
    dec.reset_launches()
    cache = model.init_cache(cfg, B, P + n + 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    low_p = steps.lower_step(bp, mesh, (params, {"tokens": prompt}, cache))
    lg, dcache = low_p.run()
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    dparams = low_p.args[0]
    got = [_local(lg).clone()]
    toks = [greedy(got[-1])]
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(n):
        step = {"tokens": toks[-1][:, None].to(torch.int32),
                "positions": pos(i)}
        lg, dcache = steps.lower_step(bd, mesh, (dparams, step,
                                                 dcache)).run()
        got.append(_local(lg).clone())
        toks.append(greedy(got[-1]))
    torch.cuda.synchronize()
    t_dec = (time.time() - t0) / n
    launches = {"flash_attention": fa.LAUNCHES["flash_attention"],
                "decode_attention": dec.LAUNCHES["decode_attention"]}
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * n}
    if launches != want:
        fail(f"[11a] sharded serving launches {launches}, expected {want}")

    # the unsharded path on the same weights
    ref_cache = model.init_cache(cfg, B, P + n + 1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    lg = model.prefill(params, cfg, {"tokens": prompt}, ref_cache,
                       last_only=True)[0]
    torch.cuda.synchronize()
    t_pre_plain = time.time() - t0
    saved = {k: v.clone() for k, v in ref_cache.items()}
    plain = [lg]
    ptoks = [greedy(lg)]
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(n):
        step = {"tokens": ptoks[-1][:, None].to(torch.int32),
                "positions": pos(i)}
        lg = model.decode_step(params, cfg, step, ref_cache)[0]
        plain.append(lg)
        ptoks.append(greedy(lg))
    torch.cuda.synchronize()
    t_dec_plain = (time.time() - t0) / n
    same_logits = all(torch.equal(a, b) for a, b in zip(got, plain))
    same_toks = all(torch.equal(a, b) for a, b in zip(toks, ptoks))
    # the control: the first decode step one position on
    ctrl = model.decode_step(params, cfg, {
        "tokens": ptoks[0][:, None].to(torch.int32), "positions": pos(1)},
        saved)[0]
    ctrl_rel = float((ctrl[..., :V].float() - got[1][..., :V].float()).norm()
                     / got[1][..., :V].float().norm())
    del saved, ref_cache
    say(f"[11a] granite_8b sharded (1x1 mesh {tuple(mesh.shape)}, bf16, "
        f"B={B}, prompt {P}): prefill {t_pre:.3f} s (unsharded "
        f"{t_pre_plain:.3f} s), decode {t_dec * 1e3:.2f} ms a step eager "
        f"(unsharded {t_dec_plain * 1e3:.2f} ms); launches {launches}; "
        f"logits of the prefill and {n} steps bit for bit equal to the "
        f"unsharded path: {same_logits}; greedy tokens equal: {same_toks}; "
        f"the control (first step one position on): equal "
        f"{torch.equal(ctrl, got[1])}, relative L2 {ctrl_rel:.3e}; {card}")
    if not (same_logits and same_toks):
        fail("[11a] the sharded steps differ from model.prefill / "
             "decode_step")
    if torch.equal(ctrl, got[1]):
        fail("[11a] the step one position on passes the check")

    # (c) prefill and one decode step under the counter, then timed
    _, s_pre = low_p.cost()
    ms_pre = median_ms(torch, low_p.run, 3, warmup=0)
    step0 = {"tokens": toks[0][:, None].to(torch.int32), "positions": pos(0)}
    low_d = steps.lower_step(bd, mesh, (dparams, step0, dcache))
    _, s_dec = low_d.cost()
    ms_dec = median_ms(torch, low_d.run, 3, warmup=0)
    d, H, KV, hd, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.n_layers)
    per_layer = d * (H + 2 * KV) * hd + H * hd * d + 3 * d * cfg.d_ff
    flash = L * ops.flash_flops(B, P, P, H, hd, True)
    exact = 2.0 * L * per_layer * B * P + 2.0 * cfg.padded_vocab * d * B \
        + flash
    N = cfg.active_param_count()
    literal = 2.0 * N * B * P + flash
    ratio = s_pre["flops_per_chip"] / exact
    say(f"[11c] prefill's counted FLOPs against the analytic count of its "
        f"matmuls (2 x {L} x {per_layer} x {B * P} tokens + the head at "
        f"the last position + flash {flash:.6e}) = {exact:.6e}: ratio "
        f"{ratio:.6f} (band {FLOP_BAND}); against 2 N tokens + flash = "
        f"{literal:.6e} (N = {N}, whose embedding is a lookup and whose head "
        f"runs at one position here): {s_pre['flops_per_chip'] / literal:.6f}")
    if not FLOP_BAND[0] <= ratio <= FLOP_BAND[1]:
        fail(f"[11c] prefill's counted FLOPs {s_pre['flops_per_chip']:.6e} "
             f"at {ratio:.6f} of the analytic count, outside {FLOP_BAND}")
    roofline_line(f"prefill (B={B}, {P} tokens)", s_pre, ms_pre,
                  2.0 * N * B * P, card)
    roofline_line(f"decode step (B={B}, position {P})", s_dec, ms_dec,
                  2.0 * N * B, card)
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"[11a] peak device memory {peak:.2f} GB")
    del params, dparams, cache, dcache, low_p, low_d, got, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def sharded_round(torch, configs, trainer, lm_data, tree, steps, st, mesh,
                  card):
    """(b) one ADMM round through build_step(..., "admm") at phase 9's cut
    (granite_8b at full width, 4 of 36 layers, batch 8 x 1024, K=4, prox
    l1) on the 1x1 mesh, so W=1, against trainer.make_round_step at W=1
    from a copy of the same state, bit for bit; then (c) for the round."""
    p = TRAIN_FULL
    cfg = dataclasses.replace(configs.get_config("granite_8b"),
                              n_layers=p["layers"])
    kw = dict(local_steps=p["K"], prox="l1", lam=p["lam"])
    ccfg = trainer.ConsensusConfig(n_workers=1, **kw)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(
        cfg, ccfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    twin = tree.tree_map(lambda t: t.clone(), state)
    shape = configs.ShapeConfig("train", p["seq"], p["batch"], "train")
    batch = {k: v[None] for k, v in
             lm_data.batch_for(cfg, shape, 0, device="cuda").items()}
    bundle = steps.build_step(cfg, shape, mesh, "admm", consensus=kw)
    n_leaves = len(tree.leaves(state.z))
    st.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    new, m = steps.lower_step(bundle, mesh, (state, batch)).run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = st.LAUNCHES["soft_threshold"]
    want, wm = trainer.make_round_step(cfg, ccfg)(twin, batch)
    same_m = {k: torch.equal(_local(m[k]), wm[k]) for k in wm}
    same_leaves = all(torch.equal(_local(a), b) for a, b in zip(
        tree.leaves(new), tree.leaves(want)))
    mv = {k: float(_local(v)) for k, v in m.items()}
    say(f"[11b] {cfg.name} at full width, {cfg.n_layers} of 36 layers, "
        f"W=1 (1x1 mesh), K={p['K']}, batch {p['batch']} x {p['seq']}, l1: "
        f"the sharded round {wall:.3f} s; metrics {mv}; equal to "
        f"make_round_step at W=1: {same_m}, every leaf bit for bit: "
        f"{same_leaves}; z-update launches {launches} (= {n_leaves} "
        f"leaves); {card}")
    if not all(same_m.values()) or not same_leaves:
        fail("[11b] the sharded round differs from make_round_step")
    if launches != n_leaves:
        fail(f"[11b] {launches} z-update launches, expected {n_leaves}")
    del twin, want, wm
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the round under the counter, then timed (each a further round)
    holder = [new]

    def again():
        holder[0] = steps.lower_step(bundle, mesh, (holder[0], batch)).run()[0]
    (holder[0], _), s = steps.lower_step(bundle, mesh,
                                         (holder[0], batch)).cost()
    ms = median_ms(torch, again, 3, warmup=0)
    roofline_line(f"ADMM round (W=1, K={p['K']}, {p['batch']} x "
                  f"{p['seq']})", s, ms,
                  6.0 * cfg.active_param_count() * bundle.meta["tokens"],
                  card)
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"[11b] peak device memory {peak:.2f} GB (the state and its copy "
        f"for the unsharded round)")
    del holder, new, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_sharded(torch, configs, model, trainer, lm_data, tree, ops, fa,
                  dec, st, card):
    """Phase 11 (a)-(d); returns the launches of (a) and (b).  (d) starts
    after (a)-(c), so their host-bound times are not taken with the
    dry-run's processes on the same cores."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    mesh = mesh_mod.make_host_mesh()
    try:
        with torch.no_grad():
            launches = sharded_serve(torch, configs, model, steps, ops, fa,
                                     dec, mesh, card)
        launches["soft_threshold"] = sharded_round(
            torch, configs, trainer, lm_data, tree, steps, st, mesh, card)
    finally:
        mesh_mod.close_host_mesh()
    t_dry, procs = start_dryrun()
    try:
        finish_dryrun(t_dry, procs, card)
    finally:
        stop_dryrun(procs)
    return launches


# ---------------------------------------------------------------------------
# phase 12: card training of the moe, hybrid, ssm and audio families
# ---------------------------------------------------------------------------

# (arch, depth cut or None): full width in bf16 at phase 9b's settings
# (TRAIN_FULL).  At phase 9b's 42 B a parameter (granite_8b's 53.58 GB
# peak over 1.275e9) about 1.25e9 parameters fit the card's 80 GB with
# remat's activations, and all four fit at these depths or more (peaks on
# an H100 80GB HBM3 at 700 W, PERF.md): granite_moe 11 of 32 layers
# (1.259e9; its stacked expert leaves (11, 40, 1536, 512), 3.46e8
# elements, 55.15 GB), zamba2 all 38 (1.120e9, 65.64 GB), rwkv6 18 of 24
# (1.249e9, 57.06 GB), musicgen 24 of 48 (1.216e9, 56.64 GB).  The chunked
# scans' many small kernels make zamba2's and rwkv6's rounds the slowest
# (7.3 s at 19 layers, 3.4 s at 2), so zamba2 runs 12 layers (two groups
# of 6 and their shared attention), rwkv6 2 and musicgen 12, to keep the
# phase within its time
FAMILY_TRAIN = [("granite_moe_3b_a800m", 11), ("zamba2_1_2b", 12),
                ("rwkv6_1_6b", 2), ("musicgen_large", 12)]
# (a)'s rounds are held at phase 9a's limits, except where a family's
# chunked scan makes them unreachable: Adam's normalised step amplifies
# the rounding of gradient entries that cancel to near zero, so the CPU
# against itself after a one-ulp nudge of the state already reads 1.8 x
# (zamba2) and 2.6 x (rwkv6) after one float32 round, 31 x and 28 x in
# bf16.  Those two are held at fixed multiples of phase 9a's limits, 1.5
# x the card's worst reading (PERF.md: 1.3, 2.99; 7.44, 24.6), and a
# control with the scan's decay nudged by SCAN_NUDGE must read above
# them.  In bf16 rounding alone moves them as far as a decay 1% off does,
# so there only a gross fault (30% off) is caught; their float32
# gradients and their scans at full width are held at SCAN_RTOL
FAMILY_ROUND_LIMIT = {("zamba2_1_2b", "float32"): 2.0,
                      ("zamba2_1_2b", "bfloat16"): 11.0,
                      ("rwkv6_1_6b", "float32"): 4.5,
                      ("rwkv6_1_6b", "bfloat16"): 37.0}
# each family's chunked scan and the index of its decay argument: dt of
# the SSD, the log-decays w of WKV6
SCANS = {"hybrid": ("ssd_chunked", 1), "ssm": ("wkv6_chunked", 3)}
# the controls: the decay scaled by 1 + SCAN_NUDGE[check] on the card
SCAN_NUDGE = {"rounds float32": 1e-3, "rounds bfloat16": 0.3,
              "grads": 1e-4, "scan": 1e-3}
# gradients in float32, card against CPU, as multiples of each leaf's
# largest entry of the CPU's: moe_ff's at full width and the loss's at
# the reduced size within GRAD_RTOL (float32 sums in other orders, as
# tests/test_torch_moe.py::test_moe_ff_gradients_match_jax holds them);
# where a chunked scan is on the path, its output, final state and input
# gradients within SCAN_RTOL, 1.5 x the card's worst reading (4.52e-5, on
# dt through zamba2's SSD at full width; 4.01e-5 on rwkv6's reduced loss)
GRAD_RTOL = 1e-5
SCAN_RTOL = 7e-5
# (a) one moe_ff backward at granite_moe's full layer width with drops:
# (batch, tokens, weight of the direction the tokens share), float32
MOE_BWD = dict(B=1, S=512, shared=0.9)
# rounds 1-2 of (b) run again from the same seed
FAMILY_REPEAT = 2


def worst_rel(got, want):
    """Per leaf, the worst |got - want| over the largest |want| (0 where
    the two are equal, inf where a zero leaf is not)."""
    out = []
    for g, w in zip(got, want):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        out.append(0.0 if err == 0 else err / scale if scale else math.inf)
    return out


@contextlib.contextmanager
def nudged_scan(ssm, family, eps):
    """The family's chunked scan, as the model calls it, with its decay
    argument scaled by 1 + ``eps``: the controls' fault."""
    name, i = SCANS[family]
    fn = getattr(ssm, name)

    def nudged(*args, **kw):
        args = list(args)
        args[i] = args[i] * (1 + eps)
        return fn(*args, **kw)
    setattr(ssm, name, nudged)
    try:
        yield
    finally:
        setattr(ssm, name, fn)


def moe_backward(torch, moe, cfg, device, seed=0):
    """One moe_ff forward and backward at ``cfg``'s MoE width in float32
    on ``device`` from weights and tokens drawn on the CPU: (the routing's
    kept mask, {leaf: gradient})."""
    p, g = MOE_BWD, torch.Generator().manual_seed(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    shapes = {"router": ((d, E), d ** -0.5), "w_up": ((E, d, f), d ** -0.5),
              "w_down": ((E, f, d), f ** -0.5)}
    if cfg.mlp == "swiglu":
        shapes["w_gate"] = ((E, d, f), d ** -0.5)
    w = {k: (torch.randn(s, generator=g) * std) for k, (s, std) in
         shapes.items()}
    x = (p["shared"] * torch.randn((d,), generator=g)
         + math.sqrt(1 - p["shared"] ** 2)
         * torch.randn((p["B"], p["S"], d), generator=g))
    ct = torch.randn(x.shape, generator=g)
    w = {k: v.to(device).requires_grad_() for k, v in w.items()}
    x = x.to(device).requires_grad_()
    with spying(moe, "route", lambda a, r: r.kept) as kept:
        out, aux = moe.moe_ff(w, x, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor,
                              group_size=cfg.moe_group_size)
    (torch.sum(out * ct.to(device)) + aux).backward()
    return kept[0], {**{k: v.grad for k, v in w.items()}, "x": x.grad}


def loss_grads(torch, model, lm_data, configs, tree, cfg, params, p,
               device):
    """The loss of step 0's global batch at ``params`` on ``device`` and
    its gradient per leaf (a zero leaf where the loss does not read it:
    the audio family's input embedding)."""
    ps, build = tree.flatten(params)
    req = [t.to(device, copy=True).requires_grad_() for t in ps]
    shape = configs.ShapeConfig("train", p["seq"], p["batch"], "train")
    loss = model.loss_fn(build(req), cfg, lm_data.batch_for(
        cfg, shape, 0, device=device))[0]
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(t) if g is None else g
                         for t, g in zip(req, grads)]


def hold_family_grads(torch, model, ssm, lm_data, configs, tree, cfg, p,
                      tag):
    """The loss and every leaf's gradient at the reduced size in float32,
    card against CPU, from weights drawn on the CPU with the zero leaves
    drawn anew, within GRAD_RTOL (SCAN_RTOL through a chunked scan, where
    the control with the scan's decay nudged must miss it).  Returns the
    readings."""
    params = model.init_params(cfg, generator=torch.Generator().manual_seed(
        0), device="cpu")
    draw_zero_leaves(torch, params, 1)
    args = (torch, model, lm_data, configs, tree, cfg, params, p)
    l_cpu, g_cpu = loss_grads(*args, "cpu")
    l_card, g_card = loss_grads(*args, "cuda")
    worst = max(worst_rel(g_card, g_cpu))
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    limit = SCAN_RTOL if cfg.family in SCANS else GRAD_RTOL
    if not (worst <= limit and loss_rel <= TRAIN_METRIC_RTOL):
        fail(f"{tag} gradients card vs CPU: worst leaf {worst:.3e} of its "
             f"largest entry (limit {limit:g}), loss {loss_rel:.3e} "
             f"relative (limit {TRAIN_METRIC_RTOL:g})")
    out = dict(loss_rel=loss_rel, worst=worst, limit=limit)
    if cfg.family in SCANS:
        with nudged_scan(ssm, cfg.family, SCAN_NUDGE["grads"]):
            out["control"] = max(worst_rel(loss_grads(*args, "cuda")[1],
                                           g_cpu))
        if not out["control"] > limit:
            fail(f"{tag} the control (the scan's decay scaled by 1 + "
                 f"{SCAN_NUDGE['grads']:g}) passed the gradient hold: "
                 f"{out['control']:.3e}")
    return out


def phase_family_train_small(torch, configs, trainer, lm_data, model, moe,
                             ssm, tree, st, fa):
    """(a): each family's reduced config on the card against the CPU and
    again on the card, in float32 then bf16 (phase 9a's settings; its
    limits or FAMILY_ROUND_LIMIT's, with a control where those are
    wider), and its float32 gradients card against CPU; then
    granite_moe's moe_ff backward at full width with drops, card against
    CPU, and twice on the card bit for bit."""
    fa.reset_launches()
    for arch, _ in FAMILY_TRAIN:
        for p, kw in ((TRAIN_SMALL, {}), (TRAIN_BF16, dict(dtype="bfloat16"))):
            cfg = configs.reduced(configs.get_config(arch), **kw)
            tag = f"[12a] {arch} {cfg.dtype}"
            t0 = time.time()
            base = trainer.init_state(
                cfg, trainer.ConsensusConfig(n_workers=p["W"]),
                generator=torch.Generator().manual_seed(0), device="cpu")
            runs, n_z, spread = card_cpu_runs(torch, trainer, lm_data,
                                              configs, tree, st, cfg, p,
                                              base, tag)
            (cpu, tc), (card, tg) = runs["cpu"], runs["card"]
            gaps = train_gaps(torch, tree, card, cpu, tg, tc, cfg.dtype)
            limit = FAMILY_ROUND_LIMIT.get((arch, cfg.dtype), 1.0)
            if over := over_limit(gaps, limit):
                fail(f"{tag} card vs CPU over {limit:g} x phase 9a's limits "
                     f"(in multiples of them): {over}")
            held = f"within {limit:g} x phase 9a's limits"
            if limit > 1.0:
                eps = SCAN_NUDGE[f"rounds {cfg.dtype}"]
                with nudged_scan(ssm, cfg.family, eps):
                    ctl, tl = train_rounds(
                        torch, trainer, lm_data, configs, cfg,
                        tree.tree_map(lambda t: t.to("cuda", copy=True),
                                      base), p, "cuda")
                missed = over_limit(train_gaps(torch, tree, ctl, cpu, tl, tc,
                                               cfg.dtype), limit)
                if not missed:
                    fail(f"{tag} the control (the scan's decay scaled by 1 +"
                         f" {eps:g}) stayed within {limit:g} x phase 9a's "
                         f"limits")
                held += (f"; the control with the scan's decay scaled by 1 +"
                         f" {eps:g} over them in "
                         f"{ {k: float(f'{v:.3g}') for k, v in missed.items()} }")
            if cfg.dtype == "float32":
                g = hold_family_grads(torch, model, ssm, lm_data, configs,
                                      tree, cfg, p, tag)
                held += (f"; the loss's gradients at step 0 (zero leaves "
                         f"drawn anew) card vs CPU: loss "
                         f"{g['loss_rel']:.3e} relative, worst leaf "
                         f"{g['worst']:.3e} of its largest entry (limit "
                         f"{g['limit']:g})")
                if "control" in g:
                    held += (f", the control with the decay scaled by 1 + "
                             f"{SCAN_NUDGE['grads']:g} {g['control']:.3e}")
            say(f"{tag} reduced (d_model {cfg.d_model}, W={p['W']}, K="
                f"{p['K']}, batch {p['batch']}, seq {p['seq']}, l1, "
                f"{p['rounds']} rounds): card vs CPU in multiples of phase "
                f"9a's limits {fmt_gaps(gaps)}, {held}; "
                f"{time.time() - t0:.1f} s; loss "
                f"{[round(m['loss'], 5) for m in tg]}; z-update launches "
                f"{n_z}; repeat spread {spread}")
    if fa.LAUNCHES["flash_attention"]:
        fail(f"[12a] training launched the flash kernel "
             f"{fa.LAUNCHES['flash_attention']} times")

    cfg = configs.get_config("granite_moe_3b_a800m")
    kept_c, want = moe_backward(torch, moe, cfg, "cpu")
    kept_g, got = moe_backward(torch, moe, cfg, "cuda")
    _, again = moe_backward(torch, moe, cfg, "cuda")
    if not torch.equal(kept_g.cpu(), kept_c):
        fail("[12a] moe_ff: the card kept other assignments than the CPU")
    share = float((~kept_c).float().mean())
    if not 0.0 < share < 1.0:
        fail(f"[12a] moe_ff: drop share {share}, the case must drop some")
    worst = dict(zip(want, worst_rel([got[k] for k in want], want.values())))
    if bad := {k: v for k, v in worst.items() if not v <= GRAD_RTOL}:
        fail(f"[12a] moe_ff gradients card vs CPU over {GRAD_RTOL:g} of "
             f"their largest entries: {bad}")
    if diff := [k for k in want if not torch.equal(got[k], again[k])]:
        fail(f"[12a] moe_ff gradients of {diff}: two card passes differ")
    say(f"[12a] moe_ff at granite_moe's width (d {cfg.d_model}, "
        f"{cfg.n_experts} experts, top {cfg.top_k}, capacity "
        f"{cfg.capacity_factor:g}, {MOE_BWD['B']} x {MOE_BWD['S']} tokens "
        f"sharing a direction at weight {MOE_BWD['shared']}), float32: drop "
        f"share {share:.4f}, the same kept set; backward card vs CPU, each "
        f"leaf's worst over its largest entry "
        f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } (limit "
        f"{GRAD_RTOL:g}); a second card pass bit for bit")


@contextlib.contextmanager
def first_call(module, name):
    """Wrap ``module.name``: the first call's (args, kwargs), each tensor
    argument detached and its first batch row copied in float32, are
    put in the dict this yields, under "call"."""
    fn, kept = getattr(module, name), {}

    def spy(*args, **kw):
        if "call" not in kept:
            kept["call"] = ([(t[:1] if t.dim() >= 3 else t).detach().float()
                             .clone() for t in args], kw)
        return fn(*args, **kw)
    setattr(module, name, spy)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


def scan_outputs(torch, fn, args, kw, i, device, eps=0.0):
    """The scan's output and final state on ``device`` and the gradients
    of its inputs under a cotangent drawn at seed 0, with the decay
    (argument ``i``) scaled by 1 + ``eps``."""
    ins = [t.to(device, copy=True).requires_grad_() for t in args]
    feed = list(ins)
    feed[i] = feed[i] * (1 + eps)
    outs = fn(*feed, **kw)
    gen = torch.Generator().manual_seed(0)
    loss = sum(torch.sum(o.float() * torch.randn(o.shape, generator=gen)
                         .to(device)) for o in outs)
    return [o.detach() for o in outs] + list(torch.autograd.grad(loss, ins))


def hold_scan(torch, ssm, family, call, tag):
    """The family's chunked scan on the inputs the model gave it, float32,
    card against CPU: its output, final state and input gradients within
    SCAN_RTOL of each one's largest entry; the control with the decay
    scaled by 1 + SCAN_NUDGE["scan"] must miss it.  Returns the readings."""
    name, i = SCANS[family]
    fn, (args, kw) = getattr(ssm, name), call
    want = scan_outputs(torch, fn, args, kw, i, "cpu")
    worst = worst_rel(scan_outputs(torch, fn, args, kw, i, "cuda"), want)
    control = max(worst_rel(scan_outputs(torch, fn, args, kw, i, "cuda",
                                         SCAN_NUDGE["scan"]), want))
    shapes = [tuple(t.shape) for t in args]
    if not max(worst) <= SCAN_RTOL:
        fail(f"{tag} {name} on {shapes} card vs CPU: {worst} of each "
             f"output's largest entry, limit {SCAN_RTOL:g}")
    if not control > SCAN_RTOL:
        fail(f"{tag} the control (the decay scaled by 1 + "
             f"{SCAN_NUDGE['scan']:g}) passed the scan hold: {control:.3e}")
    return dict(name=name, shapes=shapes, worst=max(worst), control=control)


def family_rounds(torch, trainer, lm_data, configs, cfg, state, p, rounds,
                  on_round):
    """``rounds`` rounds of make_round_step on the card from ``state`` on
    the batches of steps 0, 1, ...; ``on_round(k)`` is entered around
    round k (a context manager), whose wall it does not count.  Returns
    (state, [(wall s, metrics as floats)], z after round FAMILY_REPEAT)."""
    ccfg = trainer.ConsensusConfig(n_workers=p["W"], local_steps=p["K"],
                                   prox="l1", lam=p["lam"], adapt_rho=True)
    step = trainer.make_round_step(cfg, ccfg)
    shape = configs.ShapeConfig("train", p["seq"], p["batch"], "train")
    Bw = p["batch"] // p["W"]
    trace, z_kept = [], None
    for k in range(rounds):
        gb = lm_data.batch_for(cfg, shape, k, device="cuda")
        batch = {n: v.reshape((p["W"], Bw) + v.shape[1:])
                 for n, v in gb.items()}
        with on_round(k):
            torch.cuda.synchronize()
            t0 = time.time()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = time.time() - t0
        trace.append((wall, {n: float(v) for n, v in m.items()}))
        if k == FAMILY_REPEAT - 1:
            z_kept = state.z
    return state, trace, z_kept


def phase_family_train(torch, configs, trainer, lm_data, moe, ssm, tree, ops,
                       st, fa, ref):
    """(b): each family at full width in bf16, its depth cut, W=2 ADMM
    rounds at phase 9b's settings: rounds 1 and 3 timed as they run, the
    first chunked scan's inputs kept in round 1 and the scan held on them
    card against CPU after the rounds, round 2 under the timing spy (and,
    for granite_moe, a spy on the routing: its drop share), the z-update
    kernel timed and held on the two largest leaf sizes after round 2;
    then rounds 1-2 again from the same seed, z and the metrics bit for
    bit.  Returns the z-update launches."""
    p = TRAIN_FULL
    Bw = p["batch"] // p["W"]
    tokens = p["W"] * p["K"] * Bw * p["seq"]
    total = 0
    for arch, depth in FAMILY_TRAIN:
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=depth) if depth else full
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tag = f"[12b] {arch}"
        t_arch = time.time()
        say(f"{tag} at full width (d {cfg.d_model}, {cfg.dtype}), "
            f"{cfg.n_layers} of {full.n_layers} layers: "
            f"{cfg.param_count() / 1e9:.4f}e9 parameters; W={p['W']}, "
            f"K={p['K']}, batch {p['batch']} x {p['seq']}, l1 at "
            f"{p['lam']:g}, remat")
        fresh = lambda: trainer.init_state(
            cfg, trainer.ConsensusConfig(n_workers=p["W"]),
            generator=torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        t0 = time.time()
        state = fresh()
        torch.cuda.synchronize()
        t_init = time.time() - t0
        sizes = sorted({t.numel() for t in tree.leaves(state.z)})[-2:]
        n_leaves = len(tree.leaves(state.z))
        parts, kept, routed, held, scan_in = {}, {}, [], {}, {}

        @contextlib.contextmanager
        def on_round(k):
            """Round 1 keeps the first chunked scan's inputs; round 2 runs
            under the spies, and after it the z-update kernel is timed and
            held on the kept leaves, which are then let go."""
            if k == 0 and cfg.family in SCANS:
                with first_call(ssm, SCANS[cfg.family][0]) as call:
                    yield
                scan_in.update(call)
                return
            if k != 1:
                yield
                return
            restore = spy_train(torch, trainer, ops, parts, kept, sizes)
            try:
                with spying(moe, "route", lambda a, r: r.kept) as got:
                    yield
                routed.extend(got)
            finally:
                restore()
            if sorted(kept) != sizes:
                fail(f"{tag} the spy kept z-update inputs of sizes "
                     f"{sorted(kept)}, expected {sizes}")
            n = st.LAUNCHES["soft_threshold"]
            for size, ((omega, z_old, thr), _) in sorted(kept.items()):
                args = (omega.reshape(-1), z_old.reshape(-1), float(thr))
                ms = median_ms(torch, lambda: st.soft_threshold_cuda(*args),
                               5)
                b_ms, _ = bound_ms(12.0 * size, 4.0 * size)
                held[size] = dict(ms=ms, bound_ms=b_ms, of_bound=b_ms / ms)
            st.LAUNCHES["soft_threshold"] = n     # the timing's do not count
            held["errs"] = check_kept_z(torch, ref, kept, tag)
            kept.clear()
        st.reset_launches()
        fa.reset_launches()
        state, trace, z_want = family_rounds(torch, trainer, lm_data,
                                             configs, cfg, state, p,
                                             p["rounds"], on_round)
        launches = st.LAUNCHES["soft_threshold"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        for k, (wall, m) in enumerate(trace):
            say(f"{tag} round {k + 1}: wall {wall:.3f} s, "
                f"{tokens / wall:.0f} tokens/s; loss {m['loss']:.5f}, r "
                f"{m['r_norm']:.5g}, s {m['s_norm']:.5g}, rho {m['rho']:.5g},"
                f" nnz(z)/P {m['z_nnz'] / cfg.param_count():.6f}")
        named = ("fwd_bwd", "augment", "adam", "dual", "mean", "z_update",
                 "rescale")
        rest = trace[1][0] - sum(parts[n] for n in named)
        say(f"{tag} round 2 by the timing spy (a synchronize around each "
            f"part): dual ascent {parts['dual']:.3f} + value_and_grads "
            f"{parts['fwd_bwd']:.3f} ({parts['fwd_bwd_n']} worker steps) + "
            f"augment {parts['augment']:.3f} + Adam {parts['adam']:.3f} + "
            f"consensus mean {parts['mean']:.3f} + z-update "
            f"{parts['z_update']:.3f} ({parts['z_kernel_n']} launches) + "
            f"rescale {parts['rescale']:.3f} + rest {rest:.3f} s")
        if routed:
            share = lambda ks: sum(int((~k).sum()) for k in ks) / sum(
                k.numel() for k in ks)
            L = cfg.n_layers
            say(f"{tag} round 2's training batches drop {share(routed):.4f}"
                f" of their expert assignments at capacity "
                f"{cfg.capacity_factor:g} (groups of {cfg.moe_group_size}; "
                f"{len(routed)} routings); the first forward's layer 1 "
                f"{share(routed[:1]):.4f}, layer {L} "
                f"{share(routed[L - 1:L]):.4f}")
        if scan_in:
            sc = hold_scan(torch, ssm, cfg.family, scan_in.pop("call"), tag)
            say(f"{tag} {sc['name']} on round 1's first inputs (batch row 0,"
                f" {sc['shapes']}) in float32, card vs CPU: output, final "
                f"state and input gradients within {sc['worst']:.3e} of "
                f"each one's largest entry (limit {SCAN_RTOL:g}); the "
                f"control with the decay scaled by 1 + "
                f"{SCAN_NUDGE['scan']:g} {sc['control']:.3e}")
        errs = held.pop("errs")
        say(f"{tag} z-update kernel on round 2's leaves (median of 5, CUDA "
            f"events; bound 12 B an element at {HBM_BYTES_PER_S:g} B/s): "
            f"{ {k: {n: float(f'{v:.4g}') for n, v in t.items()} for k, t in held.items()} }"
            f"; against its plain version on the same inputs (limit "
            f"{PARITY_RTOL:g} x scale, nnz equal): {errs}")
        say(f"{tag} init_state {t_init:.2f} s; peak device memory {peak:.2f}"
            f" GB; z-update launches {launches} (= {n_leaves} leaves x "
            f"{p['rounds']}), flash {fa.LAUNCHES['flash_attention']}")
        losses = [m["loss"] for _, m in trace]
        if launches != n_leaves * p["rounds"]:
            fail(f"{tag} {launches} z-update launches, expected "
                 f"{n_leaves * p['rounds']}")
        if fa.LAUNCHES["flash_attention"]:
            fail(f"{tag} training launched the flash kernel")
        # each round draws new batches, so only the trend is asked for
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            fail(f"{tag} the loss is not finite, or not lower after "
                 f"{p['rounds']} rounds: {losses}")
        if peak > TRAIN_PEAK_GB:
            fail(f"{tag} peak {peak:.2f} GB above {TRAIN_PEAK_GB} GB")
        total += launches

        # the repeat: rounds 1-2 from the same seed, bit for bit
        del state
        gc.collect()
        torch.cuda.empty_cache()
        st.reset_launches()
        state, again, z_got = family_rounds(
            torch, trainer, lm_data, configs, cfg, fresh(), p, FAMILY_REPEAT,
            lambda k: contextlib.nullcontext())
        diff = [i for i, (a, b) in enumerate(zip(tree.leaves(z_got),
                                                 tree.leaves(z_want)))
                if not torch.equal(a, b)]
        if diff or [m for _, m in again] != [m for _, m in
                                             trace[:FAMILY_REPEAT]]:
            fail(f"{tag} rounds 1-{FAMILY_REPEAT} again from the same seed "
                 f"differ: z leaves {diff}, metrics "
                 f"{[m for _, m in again]} against "
                 f"{[m for _, m in trace[:FAMILY_REPEAT]]}")
        if st.LAUNCHES["soft_threshold"] != n_leaves * FAMILY_REPEAT:
            fail(f"{tag} the repeat launched the z-update "
                 f"{st.LAUNCHES['soft_threshold']} times")
        total += st.LAUNCHES["soft_threshold"]
        say(f"{tag} rounds 1-{FAMILY_REPEAT} again from the same seed: z "
            f"({n_leaves} leaves) and the metrics bit for bit; the arch's "
            f"wall {time.time() - t_arch:.1f} s")
        del state, z_got, z_want
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 13: decode over slot shards (the decode kernel's partial mode and the
# softmax combined across shards)
# ---------------------------------------------------------------------------

# (a) in one process: the serving decode shape of phase 2 in bf16 and
# float32 under two position sets (rows whose live slots end in the first
# shard of 16, on a shard boundary, past the middle; "early" leaves the
# second half of the cache with no live slot), and mixtral's wrapped
# 4096-slot ring; each cut into R shards of its slots
SLOT_SHARDS = (2, 4, 16)
SHARD_CASES = {"mixed": [0, 100, 527, 1055, 1056, 1500, 2047, 2111],
               "early": [0, 5, 64, 131, 132, 263, 500, 1000]}
RING_SHAPE = (4, 4096, 32, 8, 128)
RING_POSITIONS = [4095, 4096, 4639, 8191]
# a shard's float32 state (m, l) against the plain partial's: the same
# float32 scores summed in another order, the kernel's exponent taken in
# log2 units and m converted by one multiply
STATE_RTOL = 1e-4
# decode_32k's per-rank work on the (16, 16) mesh: 8 sequences, 2048 of
# 32768 slots (rank 5's, every slot live), granite_8b's heads
RANK_SHAPE = (8, 2048, 32, 8, 128)
RANK_SLOTS = 32768
# (b) four processes on the one card (gloo: NCCL refuses two ranks on one
# device), a 1x4 mesh, granite_8b's decode attention at full width over a
# 4096-slot cache (1024 slots a rank) through ops.decode_attention: bf16
# with ranks 2 and 3 holding no live slot, float32 with rows ending on
# every rank's edges, and mixtral's wrapped ring.  q comes replicated:
# this machine's gloo crashes (SIGSEGV in wait_tensor) on the functional
# all-gather on CUDA tensors that DTensor's Shard -> Replicate uses, so a
# whole decode step, and a q split by heads, cannot run here (PERF.md)
SHARD_RANKS = 4
SHARD_CASES_B = [
    ("bfloat16", (8, 4096, 32, 8, 128),
     [0, 5, 100, 500, 1023, 1024, 1500, 2047], "early"),
    ("float32", (8, 4096, 32, 8, 128),
     [0, 1023, 1024, 2047, 2048, 3071, 3072, 4095], "edges"),
    ("bfloat16", (4, 4096, 32, 8, 128), [4095, 4096, 4639, 8191], "ring"),
]


def slot_bounds(S: int, R: int):
    n = S // R
    return [(r * n, (r + 1) * n) for r in range(R)]


def combine_stacked(torch, attention, parts, dtype):
    """``combine_partials`` over the shards' states stacked on a new
    leading axis (the one-process form of the ranks' all-reduces)."""
    o, m, l = (torch.stack(t) for t in zip(*parts))
    return attention.combine_partials(o, m, l, lambda t: t.amax(dim=0),
                                      lambda t: t.sum(dim=0), dtype=dtype)


def hold_partial(torch, attention, got, want, rtol, name):
    """One shard's (o, m, l) from the kernel against the plain partial's:
    o by rows at ``rtol``, m and l at STATE_RTOL; a row with no live slot
    exactly (0, -1e30, 0).  Returns (worst o row gap, worst state gap,
    max |o - plain|, rows with no live slot)."""
    o, m, l = got
    po, pm, pl = want
    empty = pl == 0
    if not torch.equal(empty, l == 0):
        fail(f"{name}: the kernel and the plain partial disagree on which "
             f"rows hold no live slot")
    if (o[empty] != 0).any() or (m[empty] != attention.NEG_INF).any():
        fail(f"{name}: a row with no live slot is not (0, -1e30, 0)")
    live = ~empty
    if not live.any():
        return 0.0, 0.0, 0.0, int(empty.sum())
    gap, err = hold_rows(torch, o[live], po[live], rtol, name)
    state = max(float(((m - pm).abs() / pm.abs().clamp(min=1.0))[live].max()),
                float(((l - pl).abs() / pl)[live].max()))
    if not math.isfinite(state) or state > STATE_RTOL:
        fail(f"{name}: the shard's (m, l) is {state:.3e} off the plain "
             f"partial's, over {STATE_RTOL:g}")
    return gap, state, err, int(empty.sum())


def slot_shards_one(torch, dec, attention):
    """(a): every case cut into each R of SLOT_SHARDS shards, the partial
    kernel on each shard held against the plain partial, the shards
    combined and held against the whole-cache kernel and the plain decode;
    a control (the ring without its last shard) that must miss; then one
    partial launch timed at decode_32k's per-rank shape beside the
    whole-cache kernel on the same slots, the plain partial and the byte
    bound.  Returns the kernels line's entry."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(dt, (8, SERVE_P + SERVE_GEN, 32, 8, 128), pos, name)
             for dt in (bf, f32) for name, pos in SHARD_CASES.items()]
    cases.append((bf, RING_SHAPE, RING_POSITIONS, "ring"))
    worst = {}          # (measure, type) -> the worst reading
    abs_err, n_empty, n_cuts = 0.0, 0, 0
    for seed, (dtype, (B, S, H, KV, hd), pos, name) in enumerate(cases):
        tname = str(dtype).split(".")[-1]
        rtol = ATTN_ROW_RTOL[tname]
        q, kc, vc = attn_inputs(torch, [(B, 1, H, hd), (B, S, KV, hd),
                                        (B, S, KV, hd)], dtype, 130 + seed)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        whole = dec.decode_attention_cuda(q, kc, vc, p)
        q32, k32, v32 = (t.float() for t in (q, kc, vc))
        plain = attention.decode_attention(q32, k32, v32, p)
        for R in SLOT_SHARDS:
            tag = f"[13a] {name} {tname} {(B, S, H, KV, hd)} over {R} shards"
            parts = []
            for lo, hi in slot_bounds(S, R):
                got = dec.decode_attention_partial_cuda(
                    q, kc[:, lo:hi], vc[:, lo:hi], p, lo, S)
                want = attention.decode_attention_partial(
                    q32, k32[:, lo:hi], v32[:, lo:hi], p, lo, S)
                torch.cuda.synchronize()
                gap, state, err, empty = hold_partial(
                    torch, attention, got, want, rtol,
                    f"{tag}, slots [{lo}, {hi})")
                for key, val in (("part", gap), ("state", state)):
                    worst[key, tname] = max(worst.get((key, tname), 0.0),
                                            val)
                abs_err = max(abs_err, err)
                n_empty += empty
                parts.append(got)
            out = combine_stacked(torch, attention, parts, dtype)
            torch.cuda.synchronize()
            if out.dtype != dtype or not torch.isfinite(out).all():
                fail(f"{tag}: the combine is not finite {dtype}")
            for key, want in (("whole", whole), ("plain", plain)):
                worst[key, tname] = max(worst.get((key, tname), 0.0),
                                        hold_rows(torch, out, want, rtol,
                                                  f"{tag} vs {key}")[0])
            n_cuts += 1
        if name == "ring":
            seen = control_rows(torch, combine_stacked(
                torch, attention, parts[:-1], f32), plain, rtol,
                "[13a] the ring without its last shard")
        del q, kc, vc, q32, k32, v32, whole, plain, parts
    def two(key):
        return f"{worst[key, 'float32']:.2e} / {worst[key, 'bfloat16']:.2e}"
    say(f"[13a] {n_cuts} cuts ({len(cases)} cases x R in {SLOT_SHARDS}; "
        f"{n_empty} (row, head) states of shards with no live slot, each "
        f"exactly (0, -1e30, 0)), float32 / bf16: worst row gap of the "
        f"combine against the whole-cache kernel {two('whole')}, against "
        f"the plain decode {two('plain')} (limits "
        f"{ATTN_ROW_RTOL['float32']:g} / {ATTN_ROW_RTOL['bfloat16']:g}); "
        f"each shard's o against the plain partial {two('part')}, its (m, "
        f"l) {two('state')} (limit {STATE_RTOL:g}); the ring without its "
        f"last shard would fail {seen:.3f} of rows")

    B, S, H, KV, hd = RANK_SHAPE
    q, kc, vc = attn_inputs(torch, [(B, 1, H, hd), (B, S, KV, hd),
                                    (B, S, KV, hd)], bf, 13)
    off = 5 * S
    p = torch.full((B,), RANK_SLOTS - 1, dtype=torch.int32, device="cuda")
    p_whole = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
    ms_k = graph_ms(torch, lambda: dec.decode_attention_partial_cuda(
        q, kc, vc, p, off, RANK_SLOTS), 200)
    ms_w = graph_ms(torch, lambda: dec.decode_attention_cuda(q, kc, vc,
                                                             p_whole), 200)
    ms_p = graph_ms(torch, lambda: attention.decode_attention_partial(
        q, kc, vc, p, off, RANK_SLOTS), 50)
    n_bytes = 2.0 * (2 * B * S * KV * hd + B * H * hd) \
        + 4.0 * (B * H * hd + 2 * B * H + B)
    n_ops = 4.0 * B * H * hd * S
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    plan = dec.device_plan(bf, B, KV, H // KV, hd, S, "cuda")
    say(f"[13a] one partial launch at decode_32k's per-rank shape (B, S, H,"
        f" KV, hd) = {RANK_SHAPE} bf16, slots [{off}, {off + S}) of "
        f"{RANK_SLOTS}, all live: {ms_k:.4f} ms a launch (CUDA graph; "
        f"{plan[0]} splits of {plan[1]} slots), the whole-cache kernel on "
        f"the same slots {ms_w:.4f} ms (partial / whole "
        f"{ms_k / ms_w:.3f}), the plain partial {ms_p:.4f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.2f} MB at 3.35 TB/s), "
        f"{b_ms / ms_k:.3f} of it; {nvidia_smi('name,power.limit')}")
    del q, kc, vc
    return dict(ms=ms_k, plain_ms=ms_p, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, whole_ms=ms_w, max_abs_err=abs_err,
                shape=list(RANK_SHAPE) + [RANK_SLOTS], body=dec.BODY)


def shard_decode_rank(rank: int, port: int, out: str):
    """(b)'s process ``rank``: each of SHARD_CASES_B's decodes on the 1x4
    mesh through ``ops.decode_attention`` (rule "decode": this rank's 1024
    slots through the partial kernel, the softmax states combined across
    the four processes by gloo all-reduces) under the op counter, held
    against the whole-cache kernel and the plain decode on the same
    inputs, which every process draws alike.  Writes its launches,
    collectives and gaps to ``out``/rank<r>.json."""
    import faulthandler
    faulthandler.enable()       # a crash in a collective names its frame
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import op_analysis
    from repro_torch.models import attention
    from repro_torch.parallel.shards import wrap
    torch.cuda.set_device(0)
    R = SHARD_RANKS
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=R)
    try:
        mesh = mesh_mod.make_host_mesh(1, R)
        res = []
        for seed, (dtype, (B, S, H, KV, hd), pos, name) in enumerate(
                SHARD_CASES_B):
            dt = getattr(torch, dtype)
            q, kc, vc = attn_inputs(torch, [(B, 1, H, hd), (B, S, KV, hd),
                                            (B, S, KV, hd)], dt, 230 + seed)
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            S_l = S // R
            mine = slice(rank * S_l, (rank + 1) * S_l)
            dq = wrap(q, mesh, [Replicate(), Replicate()])
            dk, dv = (wrap(t[:, mine], mesh, [Replicate(), Shard(1)],
                           t.shape) for t in (kc, vc))
            dec.reset_launches()
            with torch.no_grad():
                o, summary = op_analysis.cost_summary(ops.decode_attention,
                                                      dq, dk, dv, p)
            launches = dict(dec.LAUNCHES)
            o = o.to_local()
            whole = dec.decode_attention_cuda(q, kc, vc, p)
            plain = attention.decode_attention(q.float(), kc.float(),
                                               vc.float(), p)
            torch.cuda.synchronize()
            rtol = ATTN_ROW_RTOL[dtype]
            res.append(dict(
                name=name, dtype=dtype, launches=launches,
                by_type=summary["by_type"],
                n_coll=summary["n_collective_ops"],
                live=int((torch.clamp(torch.clamp(p.long() + 1, max=S)
                                      - rank * S_l, 0, S_l)).sum()),
                whole=hold_rows(torch, o, whole, rtol,
                                f"[13b] {name} rank {rank} vs whole")[0],
                plain=hold_rows(torch, o, plain, rtol,
                                f"[13b] {name} rank {rank} vs plain")[0]))
        with open(Path(out) / f"rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def slot_shards_ranks(torch, card):
    """(b): SHARD_RANKS processes on the one card, spawned after the
    kernels were built here (four builds into one directory would race);
    every process's decodes held at ATTN_ROW_RTOL (in the process), each
    a single partial launch with the combine's two all-reduces and no
    all-gather.  Returns the partial kernel's launches over the
    processes."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        t0 = time.time()
        mp.spawn(shard_decode_rank, args=(port, out), nprocs=SHARD_RANKS)
        wall = time.time() - t0
        res = [json.loads((Path(out) / f"rank{r}.json").read_text())
               for r in range(SHARD_RANKS)]
    for r, cases in enumerate(res):
        for c in cases:
            if c["launches"] != {"decode_attention": 0,
                                 "decode_attention_partial": 1}:
                fail(f"[13b] rank {r}, {c['name']}: launches "
                     f"{c['launches']}, expected one partial launch")
            if c["n_coll"] != 2 or set(c["by_type"]) != {"all-reduce"}:
                fail(f"[13b] rank {r}, {c['name']}: collectives "
                     f"{c['by_type']} in {c['n_coll']} ops, expected the "
                     f"combine's two all-reduces")
    for i, (dtype, shape, pos, name) in enumerate(SHARD_CASES_B):
        cases = [x[i] for x in res]
        say(f"[13b] {name} {dtype} {shape} over {SHARD_RANKS} processes on "
            f"the one card (gloo, 1x{SHARD_RANKS} mesh, positions {pos}; "
            f"live slots by rank {[c['live'] for c in cases]}): "
            f"ops.decode_attention = one partial launch a rank and two "
            f"all-reduces ({cases[0]['by_type']['all-reduce']:.0f} link B "
            f"a rank), no all-gather; worst row gap against the whole-cache "
            f"kernel {max(c['whole'] for c in cases):.2e}, against the "
            f"plain decode {max(c['plain'] for c in cases):.2e} (limit "
            f"{ATTN_ROW_RTOL[dtype]:g})")
    say(f"[13b] {wall:.1f} s with the spawn (gloo stages through the host: "
        f"no time is read from it); {card}")
    return sum(c["launches"]["decode_attention_partial"]
               for cases in res for c in cases)


def phase_slot_shards(torch, dec, attention, card):
    """Phase 13 (a) and (b); returns (a)'s kernels-line entry and (b)'s
    partial launches (the main path's: the rule's)."""
    with torch.no_grad():
        r = slot_shards_one(torch, dec, attention)
    gc.collect()
    torch.cuda.empty_cache()
    return r, slot_shards_ranks(torch, card)


# ---------------------------------------------------------------------------
# phase 14: the README's example entry points (examples/*_torch.py)
# ---------------------------------------------------------------------------

EXAMPLES = ROOT / "examples"
FIRST_ORDER_TWINS = ("quickstart", "cost_aware", "elastic_faults",
                     "double_ml")
# printed numbers: "-1.5", "0.0180", "2e-05"
PRINTED_NUMBER = r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?"
# (a) the serve twin's default (mixtral_8x7b's tiny preset) and its
# docstring's other family; the train twin's --quick on the card against
# the CPU, then its default (the 100m preset) straight against a resume
SERVE_TWIN_ARGV = ([], ["--arch", "rwkv6_1_6b"])
TRAIN_TWIN_QUICK = ["--quick", "--steps", "3"]
# the train twin's --quick (qwen2_7b tiny, seq 128, no prox) in float32 is
# held card against CPU as phase 9a holds bf16: leaves by relative L2 gap
# (TRAIN_BF16_L2), the metrics at the float32 limits.  Elementwise at
# TRAIN_TOL it cannot be held: Adam turns a near-zero gradient's rounding
# into an lr-sized step.  On the CPU the port against the reference reads
# 1.02 x TRAIN_TOL on x, and the port against itself with x nudged one ulp
# 30 x; the card read 6.96 x on an "NVIDIA H100 80GB HBM3, 700.00 W"
# (b) the examples' regimes (elastic_faults.py, cost_aware.py) on the
# paper's instance, scaled from their W = 8 to W = 64: the batched engine
# with kernel="cuda", each against the same regime on the plain sparse path
# (kernel="torch") at phase 4's witness limits.  Each driver: "rounds"
# steps TWIN_ROUNDS rounds (the autoscaler, from 32 workers, acting
# between them, with a window and cooldown of one round); "async"
# TWIN_ASYNC_UPDATES z-updates, one sweep of the 64 workers at S = 4;
# "rescale" a round at 64, 32 and 64 again; "checkpoint" saves (z, x, u,
# rho) after TWIN_CKPT_ROUND rounds and restores them into a new scheduler
# for the last round, against a straight run.  The lifetime is
# elastic_faults.py's own: a worker respawns at its deadline less
# respawn_before_deadline_s (30 s), 30 s after it came up, and a round here
# takes tens of sim seconds (t_inner 6e-5 s x 9 375 rows = 0.57 s a FISTA
# step, 29 steps or more on the slowest lane of a round), so every worker
# passes that point by the start of round 3 (it respawned all 64 at round
# 2 on an "NVIDIA H100 80GB HBM3, 700.00 W", beside 7 failures)
TWIN_W = 64
TWIN_ROUNDS = 3
TWIN_ASYNC_UPDATES = TWIN_W // 4
TWIN_CKPT_ROUND = 2
TWIN_LIFETIME_S = 60.0
TWIN_REGIMES = {
    "sync + failures/lifetimes": ("rounds", dict(
        pool=dict(seed=1, fail_rate_per_round=0.04,
                  lifetime_s=TWIN_LIFETIME_S))),
    "replicated r=2 (coded)": ("rounds", dict(
        mode="replicated", replication=2,
        pool=dict(seed=2, straggler_frac=0.25, straggler_slowdown=4.0))),
    "async S=4, tau=4": ("async", dict(
        mode="async_", async_batch=4, staleness_bound=4, pool=dict(seed=3))),
    "rescale 64->32->64 cold": ("rescale", dict(
        pool=dict(seed=4, provider=dict(enabled=False)))),
    "rescale 64->32->64 warm": ("rescale", dict(
        pool=dict(seed=4, provider=dict(enabled=True)))),
    "warm + autoscale(eff) 32..64": ("rounds", dict(
        n_workers=TWIN_W // 2,
        autoscale=dict(policy="target_efficiency", min_workers=TWIN_W // 2,
                       max_workers=TWIN_W, cooldown_rounds=1, window=1),
        pool=dict(seed=0, provider=dict(enabled=True)))),
    "checkpoint at round 2": ("checkpoint", dict(pool=dict(seed=5))),
}


def load_twin(name: str):
    """``examples/<name>_torch.py`` as a fresh module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"twin_{name}", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sched_record(s) -> dict:
    """What two runs of one first-order example must share: per round the
    residuals, inner counts, clock and bill; respawns, the autoscaler's
    decisions, the provider's counts and the pool's start statistics."""
    prov = s.pool.provider
    return dict(
        rows=[(m.r_norm, m.s_norm, m.rho) for m in s.history],
        inner=[m.inner_iters.tolist() for m in s.history],
        sim=[m.sim_time for m in s.history],
        cost=[m.cost_usd for m in s.history],
        respawns=s.n_respawns, n_workers=s.cfg.n_workers,
        decisions=([list(d) for d in s.autoscaler.decisions]
                   if s.autoscaler else []),
        provider=(None if prov is None else [
            prov.stats.warm_hits, prov.stats.cold_misses,
            prov.stats.evictions, prov.stats.expirations]),
        warm_frac=s.pool.warm_frac(),
        mean_start=s.pool.mean_start_latency())


def run_first_order_twin(rt, name: str, device: str, float64: bool):
    """``main`` of a first-order twin on ``device`` (its problem in float64
    when asked), printing into a buffer; returns (output, record, wall):
    the record of every scheduler its runs and builds made, or for
    double_ml the estimate and the DAG's stage summaries."""
    mod = load_twin(name)
    scheds, dags = [], []
    if name == "double_ml":
        submit = mod.submit_dag

        def submit_dag(dag, **kw):
            dags.append(submit(float64_dag(rt, dag) if float64 else dag,
                               **kw))
            return dags[-1]
        mod.submit_dag = submit_dag
    else:
        run_, build_ = mod.run, getattr(mod, "build", None)

        def run(spec, **kw):
            if float64 and name == "quickstart":
                spec = dataclasses.replace(spec, problem_kwargs=dict(
                    spec.problem_kwargs, dtype="float64"))
            res = run_(spec, **kw)
            scheds.append(res.scheduler)
            return res
        mod.run = run
        if build_ is not None:
            def build(spec, **kw):
                p, s = build_(spec, **kw)
                scheds.append(s)
                return p, s
            mod.build = build
        if float64 and name != "quickstart":
            mod.PROBLEM_KW = dict(mod.PROBLEM_KW, dtype="float64")
    _, text, wall = captured(mod.main, device)
    if dags:
        h = dags[0]
        record = dict(theta=float(h.stage_results["combine"].z[0]),
                      stages=h.summary()["stages"], latency=h.latency_s,
                      cost=h.total_cost_usd)
    else:
        record = [sched_record(s) for s in scheds]
    # as JSON holds it: the CPU's record comes through a file
    record = json.loads(json.dumps(record, default=_plain))
    return text, record, wall


def _plain(o):
    return o.item() if hasattr(o, "item") else str(o)


def twins_run(device: str, dtype: str, names: str, out_path: str):
    """The first-order twins ``names`` (comma-separated) on ``device`` with
    their problems in ``dtype`` (float64, or float32 as written), written
    as JSON to ``out_path``.  Phase 14 runs these side by side, each in a
    process of its own (TWIN_PROCESSES): float64 on the card and on the
    CPU, which it holds against each other, and float32 on the card, whose
    output it prints."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch import runtime as rt
    torch.backends.cuda.matmul.allow_tf32 = False
    # one thread on the CPU: with two, under load, a float64 quickstart
    # read 3.9e-6 off in s_norm in 3 of 33 runs (a shard generated with
    # other bits; ROADMAP, Queue 3); with one, every run was bit for bit
    torch.set_num_threads(1 if device == "cpu" else 2)
    out = {}
    for name in names.split(","):
        text, record, wall = run_first_order_twin(rt, name, device,
                                                  dtype == "float64")
        out[name] = dict(out=text, record=record, wall=wall)
    Path(out_path).write_text(json.dumps(out))


def printed_unit(token: str) -> float:
    """One unit in the last decimal place ``token`` was printed with."""
    mantissa = token.split("e")[0]
    return 10.0 ** -len(mantissa.split(".")[1]) if "." in mantissa else 1.0


def hold_printed(name, got: str, want: str, rtol: float):
    """Line for line: the text equal with the numbers masked, each number
    within ``rtol`` relative or one unit of its last printed digit (two
    runs a hair apart can round to either side of a digit)."""
    import re
    num = re.compile(PRINTED_NUMBER)
    g_lines, w_lines = got.splitlines(), want.splitlines()
    if len(g_lines) != len(w_lines):
        fail(f"[14a] {name}: {len(g_lines)} lines printed against "
             f"{len(w_lines)}")
    for g, w in zip(g_lines, w_lines):
        gn, wn = num.findall(g), num.findall(w)
        if num.sub("#", g) != num.sub("#", w) or any(
                abs(float(a) - float(b)) > max(rtol * abs(float(b)),
                                               printed_unit(b) * 1.000001)
                for a, b in zip(gn, wn)):
            fail(f"[14a] {name}: the card printed {g!r}, the CPU {w!r}")


def hold_twin_records(name, card, cpu):
    """The card's float64 run of a first-order twin against the CPU's:
    residuals at F64_RTOL, and inner counts, respawns, clock, bill,
    autoscaler decisions and provider counts equal (double_ml: theta-hat
    at DML_THETA_RTOL, its stage summaries equal).  Returns the worst
    relative residual gap."""
    if name == "double_ml":
        gap = abs(card["theta"] - cpu["theta"]) / abs(cpu["theta"])
        if not gap <= DML_THETA_RTOL or card["stages"] != cpu["stages"]:
            fail(f"[14a] double_ml: theta-hat {card['theta']!r} vs "
                 f"{cpu['theta']!r} or the stage summaries differ")
        return gap
    if len(card) != len(cpu):
        fail(f"[14a] {name}: {len(card)} schedulers against {len(cpu)}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        worst = max(worst, hold(f"[14a] {name} run {i}", a["rows"],
                                b["rows"], F64_RTOL))
        for key in ("inner", "sim", "cost", "respawns", "n_workers",
                    "decisions", "provider", "warm_frac", "mean_start"):
            if a[key] != b[key]:
                fail(f"[14a] {name} run {i}: {key} {a[key]!r} on the card, "
                     f"{b[key]!r} on the CPU")
    return worst


def say_output(tag, name, text):
    for line in text.splitlines():
        say(f"{tag} {name} | {line}")


@contextlib.contextmanager
def drawn_on_cpu(torch, model, serve):
    """Parameters and prompts drawn on the CPU from fixed seeds and moved
    to the run's device, so a card run and a CPU run start alike."""
    init, prompt = model.init_params, serve.synthetic_prompt

    def init_params(cfg, *, generator, device="cuda"):
        return tree_to(init(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu"), device)

    def synthetic_prompt(cfg, batch, prompt_len, seed, device):
        return tree_to(prompt(cfg, batch, prompt_len, seed,
                              torch.device("cpu")), device)
    model.init_params, serve.synthetic_prompt = init_params, synthetic_prompt
    try:
        yield
    finally:
        model.init_params, serve.synthetic_prompt = init, prompt


def captured(fn, *args):
    """(fn(*args), what it printed, its wall)."""
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    return ret, buf.getvalue(), time.time() - t0


def phase_twins_lm(torch, configs, model, serve, trainer, tree, fa, dec):
    """(a) the serve twin (default and rwkv6) and the train twin on the
    card against the CPU; then the train twin's default straight against a
    resume.  Returns the attention launches of the serve twin's card
    runs."""
    twin = load_twin("serve_model")
    launches = {}
    for argv in SERVE_TWIN_ARGV:
        with drawn_on_cpu(torch, model, serve):
            cpu, _, _ = captured(twin.main, argv + ["--device", "cpu"])
            fa.reset_launches()
            dec.reset_launches()
            card, text, wall = captured(twin.main, argv)
        got = read_launches(fa, dec)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        say_output("[14a]", "serve_model_torch " + " ".join(argv), text)
        if not torch.equal(card, cpu):
            fail(f"[14a] serve_model_torch {argv}: the card's sample ids "
                 f"differ from the CPU's")
        say(f"[14a] serve_model_torch {' '.join(argv) or '(default)'}: "
            f"{card.shape[0]} x {card.shape[1]} ids equal to the CPU's; "
            f"attention launches {got}; {wall:.1f} s")

    twin = load_twin("train_admm_lm")
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    runs = {}
    for dev in ("cpu", "cuda"):
        make = trainer.make_round_step
        trace = []

        def make_round_step(cfg, ccfg, _make=make, _trace=trace):
            step = _make(cfg, ccfg)

            def run(state, batch):
                state, m = step(state, batch)
                _trace.append({n: float(v) for n, v in m.items()})
                return state, m
            return run
        trainer.make_round_step = make_round_step
        try:
            with drawn_on_cpu(torch, model, serve), \
                    tempfile.TemporaryDirectory(dir=scratch) as d:
                state, text, wall = captured(
                    twin.main, TRAIN_TWIN_QUICK + ["--checkpoint-dir", d]
                    + (["--device", "cpu"] if dev == "cpu" else []))
        finally:
            trainer.make_round_step = make
        runs[dev] = (state, trace, text, wall)
    (card, tc, text, wall), (cpu, tp, _, _) = runs["cuda"], runs["cpu"]
    say_output("[14a]", "train_admm_lm_torch --quick", text)
    # held as phase 9a holds bf16: each leaf by its relative L2 gap (at
    # TRAIN_BF16_L2), the metrics at the float32 limits (TRAIN_TWIN_QUICK)
    elementwise = train_gaps(torch, tree, card, cpu, tc, tp, "float32")
    gaps = (train_gaps(torch, tree, card, cpu, tc, tp, "bfloat16")[0],
            elementwise[1])
    if over_limit(gaps, 1.0) or len(tc) != len(tp):
        fail(f"[14a] train_admm_lm_torch --quick: the card strays from the "
             f"CPU: {fmt_gaps(gaps)} (multiples of phase 9a's limits)")
    say(f"[14a] train_admm_lm_torch --quick --steps 3: card vs CPU, leaves "
        f"by relative L2 and metrics, in multiples of phase 9a's limits "
        f"{fmt_gaps(gaps)} (elementwise at the float32 limits "
        f"{fmt_gaps(elementwise[:1])}); {wall:.1f} s on the card")

    with tempfile.TemporaryDirectory(dir=scratch) as d1, \
            tempfile.TemporaryDirectory(dir=scratch) as d2:
        straight, text, t_straight = captured(
            twin.main, ["--steps", "4", "--checkpoint-dir", d1])
        say_output("[14a]", "train_admm_lm_torch (straight)", text)
        _, _, t_first = captured(twin.main,
                                 ["--steps", "2", "--checkpoint-dir", d2])
        resumed, text, t_resume = captured(
            twin.main, ["--steps", "4", "--checkpoint-dir", d2])
        say_output("[14a]", "train_admm_lm_torch (resumed)", text)
    ls, lr = tree.leaves(straight), tree.leaves(resumed)
    diff = [i for i, (a, b) in enumerate(zip(ls, lr))
            if a.dtype != b.dtype or not torch.equal(a, b)]
    if diff or len(ls) != len(lr) or "resumed from step 2" not in text:
        fail(f"[14a] train_admm_lm_torch: the resume differs from the "
             f"straight run at leaves {diff}")
    say(f"[14a] train_admm_lm_torch (100m preset): 4 rounds straight "
        f"({t_straight:.1f} s) equal 2 + --resume 2 ({t_first + t_resume:.1f}"
        f" s, checkpoint I/O included) bit for bit over {len(ls)} leaves")
    return launches


def twin_config(rt, AdmmOptions, fields: dict, kernel: str):
    """A regime of TWIN_REGIMES as the port's SchedulerConfig."""
    fields = dict(fields)
    fields.setdefault("n_workers", TWIN_W)
    pool = dict(fields.pop("pool", {}))
    if "provider" in pool:
        pool["provider"] = rt.ProviderConfig(**pool["provider"])
    if "autoscale" in fields:
        fields["autoscale"] = rt.AutoscaleConfig(**fields["autoscale"])
    return rt.SchedulerConfig(engine="batched",
                              kernel=kernel, admm=AdmmOptions(max_iters=40),
                              pool=rt.PoolConfig(**pool), **fields)


def trace_rows(sched):
    return [{"r_norm": m.r_norm, "s_norm": m.s_norm, "rho": m.rho,
             "inner_mean": float(m.inner_iters.mean())}
            for m in sched.history]


def drive_regime(torch, api, rt, ck, AdmmOptions, problem, drive, fields,
                 kernel):
    """One regime of TWIN_REGIMES on ``problem`` with ``kernel``: returns
    (the scheduler whose rows are held, each step's wall, the slots that
    respawned as (logical wid, W), notes).  The checkpoint regime's notes
    hold its restored run."""
    scfg = twin_config(rt, AdmmOptions, fields, kernel)

    def build():
        _, s = api.build(api.ExperimentSpec(
            problem="logreg", problem_kwargs=PAPER_KW, scheduler=scfg),
            problem=problem)
        respawn = s._maybe_respawn

        def spy(wid):
            extra = respawn(wid)
            if extra:
                respawned.add((s._logical(wid), s.n_logical))
            return extra
        s._maybe_respawn = spy
        return s

    respawned, walls, notes = set(), [], {}

    def timed(fn, *args):
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        return out

    sched = build()
    if drive == "async":
        t_last = [time.time()]

        def on_round(m):
            torch.cuda.synchronize()
            walls.append(time.time() - t_last[0])
            t_last[0] = time.time()
        sched.solve(max_rounds=TWIN_ASYNC_UPDATES, on_round=on_round)
    elif drive == "rescale":
        timed(sched.step)
        sched.rescale(TWIN_W // 2)
        timed(sched.step)
        t0 = sched.sim_time
        sched.rescale(TWIN_W)
        notes["grow_stall_s"] = sched.sim_time - t0
        timed(sched.step)
    else:
        for _ in range(TWIN_ROUNDS):
            timed(sched.step)
    if drive == "checkpoint" and kernel == "cuda":
        import numpy as np
        first = build()
        for _ in range(TWIN_CKPT_ROUND):
            timed(first.step)
        state = {"z": first.z, "x": first.x, "u": first.u,
                 "rho": np.float32(first.rho)}
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            ck.save(state, d, first.k, {"round": first.k})
            second = build()
            restored, meta = ck.restore(state, d)
        second.z, second.x, second.u = (restored["z"], restored["x"],
                                        restored["u"])
        second.rho = float(restored["rho"])
        second.k = meta["round"]
        for _ in range(TWIN_ROUNDS - TWIN_CKPT_ROUND):
            timed(second.step)
        notes["restored"] = second
    return sched, walls, respawned, notes


def check_shards(torch, data_mod, base, problem, keys):
    """Each (wid, W) in ``keys``: the shard generated anew equal to the one
    the run solved (sparse) and to its lane of the staged dense batch."""
    for wid, W in sorted(keys):
        fresh = data_mod.worker_shard_sparse(problem.cfg, wid, W,
                                             device="cuda")
        held = problem._shard_cache[(wid, W)]
        (A, b), _ = problem._kernel_batch_cache[W]
        n = fresh[0].shape[0]
        dense = base.densify_sparse_rows(fresh[0], fresh[1], A.shape[-1])
        if not (all(torch.equal(f, h) for f, h in zip(fresh, held))
                and torch.equal(A[wid, :n], dense)
                and torch.equal(b[wid, :n], fresh[2])):
            fail(f"[14b] worker {wid} of {W}: its regenerated shard differs "
                 f"from the one it replaced")
        del dense


def check_restaged(torch, problem, wide, narrow):
    """The shards of ``narrow`` workers against pairs of ``wide`` workers'
    (narrow = wide / 2): each leaf of the sparse shards and each lane of
    the staged dense batch equal to the two rows it joins."""
    (A_w, b_w), _ = problem._kernel_batch_cache[wide]
    (A_n, b_n), _ = problem._kernel_batch_cache[narrow]
    for w in range(narrow):
        lo, hi = (problem._shard_cache[(2 * w + j, wide)] for j in (0, 1))
        got = problem._shard_cache[(w, narrow)]
        n0, n1 = lo[0].shape[0], hi[0].shape[0]
        if not (all(torch.equal(g, torch.cat([a, c]))
                    for g, a, c in zip(got, lo, hi))
                and torch.equal(A_n[w, :n0], A_w[2 * w, :n0])
                and torch.equal(A_n[w, n0:n0 + n1], A_w[2 * w + 1, :n1])
                and torch.equal(b_n[w, :n0 + n1],
                                torch.cat([b_w[2 * w, :n0],
                                           b_w[2 * w + 1, :n1]]))):
            fail(f"[14b] worker {w} of {narrow}: its re-staged shard is not "
                 f"workers {2 * w} and {2 * w + 1} of {wide}")


def phase_twins_paper(torch, api, problems, rt, AdmmOptions, lv, st, rows):
    """(b) TWIN_REGIMES on the paper's instance: each regime on the kernel
    path held against the plain sparse path at phase 4's witness limits,
    with its walls, launches and peak memory; respawned workers' shards
    and the re-staged shards of the 32-worker fleet against the ones they
    replaced; the restored run bit for bit against a straight one.
    ``rows`` are phase 4's sparse shards when it ran.  Returns the margin
    and z-update launches."""
    from repro_torch import checkpoint as ck
    from repro_torch.data import logreg as data_mod
    from repro_torch.problems import base
    t0 = time.time()
    problem = problems.make("logreg", device="cuda", **PAPER_KW)
    problem._shard_cache.update(rows)
    problem.kernel_batch_shards(TWIN_W)
    torch.cuda.synchronize()
    say(f"[14b] the paper's instance at W={TWIN_W}, its shards "
        f"{'from phase 4' if rows else 'generated here'}, staged in "
        f"{time.time() - t0:.1f} s")
    totals = {"logistic": 0, "soft_threshold": 0}
    for name, (drive, fields) in TWIN_REGIMES.items():
        torch.cuda.reset_peak_memory_stats()
        lv.reset_launches()
        st.reset_launches()
        sched, walls, respawned, notes = drive_regime(
            torch, api, rt, ck, AdmmOptions, problem, drive, fields, "cuda")
        n_margin, n_z = lv.LAUNCHES["logistic"], st.LAUNCHES["soft_threshold"]
        totals["logistic"] += n_margin
        totals["soft_threshold"] += n_z
        peak = torch.cuda.max_memory_allocated() / 1e9
        witness, w_walls, _, _ = drive_regime(
            torch, api, rt, ck, AdmmOptions, problem, drive, fields, "torch")
        rel, inner = witness_gaps(trace_rows(sched), trace_rows(witness))
        if not (rel <= WITNESS_RTOL and inner <= WITNESS_INNER):
            fail(f"[14b] {name}: the kernel path strays from the plain "
                 f"path ({rel:.3e} relative, {inner:.3f} inner_mean)")
        batched = drive != "async"
        if n_z < 1 or (batched and n_margin < 1):
            fail(f"[14b] {name}: {n_margin} margin and {n_z} z-update "
                 f"launches")
        if peak >= PEAK_LIMIT_GB:
            fail(f"[14b] {name}: peak device memory {peak:.2f} GB")
        extra = ""
        if respawned:
            check_shards(torch, data_mod, base, problem, respawned)
            extra += (f"; {sched.n_respawns} respawns, the shards of "
                      f"{len(respawned)} workers generated anew equal "
                      f"(sparse and staged)")
        if drive == "rescale":
            check_restaged(torch, problem, TWIN_W, TWIN_W // 2)
            extra += (f"; grow-back stall {notes['grow_stall_s']:.2f} s "
                      f"(sim); the {TWIN_W // 2} re-staged shards equal the "
                      f"{TWIN_W} they join")
        if sched.autoscaler is not None:
            eff = [m.t_comp.mean() / m.round_wall_s for m in sched.history]
            extra += (f"; efficiency by round "
                      f"{', '.join(f'{e:.3f}' for e in eff)}, autoscaler "
                      f"decisions {sched.autoscaler.decisions}")
        if drive == "checkpoint":
            second = notes["restored"]
            same = (torch.equal(second.z, sched.z)
                    and torch.equal(second.x, sched.x)
                    and torch.equal(second.u, sched.u)
                    and second.rho == sched.rho
                    and [(m.r_norm, m.s_norm) for m in second.history]
                    == [(m.r_norm, m.s_norm)
                        for m in sched.history[TWIN_CKPT_ROUND:]])
            if not same:
                fail(f"[14b] {name}: the restored run differs from the "
                     f"straight run")
            extra += (f"; restored at round {TWIN_CKPT_ROUND} into a new "
                      f"scheduler: z, x, u, rho and round "
                      f"{TWIN_CKPT_ROUND + 1}'s r/s bit for bit")
        if drive == "async":
            extra += f"; {sched.n_respawns} respawns"
        say(f"[14b] {name}: walls {', '.join(f'{w:.2f}' for w in walls)} s "
            f"(plain path {', '.join(f'{w:.2f}' for w in w_walls)}); "
            f"launches margin {n_margin}, z-update {n_z}; peak "
            f"{peak:.2f} GB; vs the plain path {rel:.3e} relative, "
            f"inner_mean {inner:.3f} (limits {WITNESS_RTOL:g}, "
            f"{WITNESS_INNER:g}); r_norm {sched.history[-1].r_norm:.6g}, "
            f"W {sched.cfg.n_workers}, sim {sched.sim_time:.1f} s, "
            f"${sched.meter.total_usd():.4f}{extra}")
    return totals


# phase 14's processes for the first-order twins: (device, problem dtype,
# twins), each set split in two of about equal wall
TWIN_PROCESSES = tuple((device, dtype, names)
                       for device, dtype in (("cuda", "float64"),
                                             ("cpu", "float64"),
                                             ("cuda", "float32"))
                       for names in ("quickstart,cost_aware",
                                     "elastic_faults,double_ml"))


def phase_twins(torch, api, problems, rt, AdmmOptions, configs, model, serve,
                trainer, tree, lv, st, fa, dec, rows):
    """Phase 14: (a) the six example twins, (b) the examples' regimes at
    the paper's size.  The first-order twins run in three processes of
    their own (TWIN_PROCESSES) while this one runs the LM twins; (b) runs
    after they end, alone on the card.  Returns {kernel: launches}."""
    t0 = time.time()
    procs, files, runs = {}, {}, {}
    try:
        for key in TWIN_PROCESSES:
            f = tempfile.NamedTemporaryFile(suffix=".json", delete=False)
            f.close()
            files[key] = Path(f.name)
            # the CPU's processes see no card
            env = dict(os.environ, **({"CUDA_VISIBLE_DEVICES": ""}
                                      if key[0] == "cpu" else {}))
            procs[key] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--twins",
                 *key, f.name], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=env)
        launches = phase_twins_lm(torch, configs, model, serve, trainer,
                                  tree, fa, dec)
        for key, proc in procs.items():
            log, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                fail(f"[14a] the first-order twins {key} failed:\n{log}")
            runs.setdefault(key[:2], {}).update(
                json.loads(files[key].read_text()))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files.values():
            f.unlink(missing_ok=True)
    for name in FIRST_ORDER_TWINS:
        run = runs["cuda", "float32"][name]
        say_output("[14a]", f"{name}_torch", run["out"])
        say(f"[14a] {name}_torch as written (float32) on the card: "
            f"{run['wall']:.1f} s")
    for name in FIRST_ORDER_TWINS:
        card, cpu = runs["cuda", "float64"][name], runs["cpu", "float64"][name]
        rtol = DML_THETA_RTOL if name == "double_ml" else F64_RTOL
        hold_printed(name, card["out"], cpu["out"], rtol)
        gap = hold_twin_records(name, card["record"], cpu["record"])
        say(f"[14a] {name}_torch in float64: the card's output and "
            f"records equal the CPU's (residuals {gap:.2e} apart, rtol "
            f"{rtol:g}; inner counts, respawns, clock, bill, autoscaler "
            f"and provider equal); {card['wall']:.1f} s on the card, "
            f"{cpu['wall']:.1f} s on the CPU")
    say(f"[14a] wall {time.time() - t0:.1f} s")
    t1 = time.time()
    launches.update(phase_twins_paper(torch, api, problems, rt, AdmmOptions,
                                      lv, st, rows))
    say(f"[14b] wall {time.time() - t1:.1f} s")
    return launches


def time_admm_kernels(torch, src: Path):
    """The margin kernel's median time per call (logistic, paper shape)
    and the z-update's device time per call in a CUDA graph (D = 10 000
    and 1 000 003), with phase 2's inputs and timers, for the port under
    ``src``.  It calls only ``margin_vjp_cuda`` and
    ``soft_threshold_cuda``, whose signatures every version of the port
    shares, so another checkout (a parent commit unpacked with ``git
    archive``) can be timed in turns with this one on the same card."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import logistic_vjp as lv
    from repro_torch.kernels import soft_threshold as st
    if not Path(lv.__file__).resolve().is_relative_to(src):
        fail(f"imported {lv.__file__}, not the port under {src}")
    W, N, D = PAPER_W, -(-PAPER_KW["n_samples"] // PAPER_W), \
        PAPER_KW["n_features"]
    A, b, mask, x = margin_inputs(torch, W, N, D, (3,), seed=1)
    margin_ms = median_ms(torch, lambda: lv.margin_vjp_cuda(
        A, b, mask, x, loss="logistic"), 5)
    del A, b, mask, x
    torch.cuda.empty_cache()
    z_ms = {}
    for Dz in (D, 1_000_003):
        g = torch.Generator(device="cuda").manual_seed(Dz)
        omega = torch.randn((Dz,), generator=g, device="cuda")
        z_old = torch.randn((Dz,), generator=g, device="cuda")
        z_ms[Dz] = graph_ms(
            torch, lambda: st.soft_threshold_cuda(omega, z_old, 0.37), 200)
    say(json.dumps({"card": nvidia_smi("name,power.limit"), "src": str(src),
                    "margin_shape": [W, N, D], "margin_ms": margin_ms,
                    "z_update_graph_ms": z_ms}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--src", type=Path,
                    help="run no phase: time the margin kernel and the "
                         "z-update of the port under this src directory "
                         "and print one JSON line (see time_admm_kernels)")
    ap.add_argument("--twins", nargs=4,
                    metavar=("DEVICE", "DTYPE", "NAMES", "JSON"),
                    help="run no phase: the first-order example twins NAMES "
                         "(comma-separated) on DEVICE (cuda or cpu) with "
                         "their problems in DTYPE (float32 or float64), "
                         "written to JSON (phase 14 starts these itself)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not phases <= set(range(1, 15)):
        fail(f"--phases takes phases 1 to 14, got {sorted(phases)}")

    if not (SRC / "repro_torch" / "api.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    import torch
    if args.twins is not None:
        twins_run(*args.twins)
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    if args.src is not None:
        time_admm_kernels(torch, args.src.resolve())
        return
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F
    from repro_torch import api, configs, problems, tree
    from repro_torch import runtime as rt
    from repro_torch.core import trainer
    from repro_torch.core.admm import AdmmOptions
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import logistic_vjp as lv
    from repro_torch.kernels import soft_threshold as st
    from repro_torch.launch import serve, train
    from repro_torch.models import attention, model, moe, ssm
    from repro_torch.optim import optimizers as opt
    from repro_torch.runtime import PoolConfig, SchedulerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    say(card)
    t_build = build.build()
    for name in build.SOURCES:
        build.load(name)
    say(f"[1] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()};"
        f" torch {torch.__version__}, CUDA {torch.version.cuda}; kernels "
        f"built from {build.CSRC.relative_to(ROOT)} in {t_build:.1f} s")
    for name in build.SOURCES:
        for fn, regs, spill in ptxas_report(build.log(name)):
            say(f"[1] {name} {fn}: {regs} registers, {spill}")
    check_margin_spills(build.log("logistic_vjp"))

    results = {}
    t0 = time.time()
    if 2 in phases:
        results.update(phase_parity(torch, lv, st, ref))
        results.update(phase_attention_parity(torch, fa, dec, attention, F))
        say(f"[2] phase wall {time.time() - t0:.1f} s")
    t0 = time.time()
    if 3 in phases:
        phase_small(torch, api, SchedulerConfig, AdmmOptions, PoolConfig,
                    lv, st)
        phase_small_modes(torch, api, SchedulerConfig, AdmmOptions,
                          PoolConfig, lv, st)
        phase_small_cluster(torch, api, problems, rt, AdmmOptions, lv, st)
        say(f"[3] phase wall before the second-order runs "
            f"{time.time() - t0:.1f} s")
        phase_small_newton(torch, api, problems, rt, AdmmOptions, lv, st)
        say(f"[3] phase wall {time.time() - t0:.1f} s")
    kernel_ms = {k: r["ms"] for k, r in results.items()}
    # each main path's launches, read around its own run: kernel -> phase
    # -> count
    by_phase = {k: {} for k in ("logistic", "hinge", "soft_threshold",
                                "flash_attention", "flash_attention_noncausal",
                                "decode_attention",
                                "decode_attention_partial")}
    # phases 4 and 6's kernel-path runs: round_keys and launch counts, the
    # solo runs phase 7's jobs are held to
    solo, solo_launches = {}, {}
    # phase 4's sparse rows, which phase 8 reads when phase 4 ran
    paper_rows = {}
    for phase in (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14):
        if phase not in phases:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        if phase in (4, 6):
            got, solo[phase] = phase_paper(
                torch, api, problems, SchedulerConfig, lv, st, ref,
                kernel_ms, phase, keep_rows=paper_rows if phase == 4
                else None)
            by_phase["soft_threshold"][str(phase)] = got.pop(
                "soft_threshold")
            solo_launches[phase] = got
            for k, n in got.items():
                by_phase[k][str(phase)] = n
        elif phase == 5:
            phase_serve_reduced(torch, configs, model, fa, dec)
            got = phase_serve(torch, configs, model, serve, fa, dec,
                              kernel_ms)[0]
            for k, n in got.items():
                by_phase[k]["5"] = n
        elif phase == 7:
            got = phase_cluster(torch, api, problems, rt, lv, st, solo,
                                solo_launches, kernel_ms)
            for engine, counts in got.items():
                for k, n in counts.items():
                    by_phase[k][f"7 {engine}"] = n
        elif phase == 8:
            phase_newton(torch, api, problems, rt, AdmmOptions, lv, st,
                         paper_rows)
            if 14 not in phases:
                paper_rows.clear()
        elif phase == 14:
            got = phase_twins(torch, api, problems, rt, AdmmOptions,
                              configs, model, serve, trainer, tree, lv, st,
                              fa, dec, paper_rows)
            paper_rows.clear()
            for k, n in got.items():
                if n:
                    by_phase[k]["14"] = n
        elif phase == 11:
            got = phase_sharded(torch, configs, model, trainer, lm_data,
                                tree, ops, fa, dec, st, card)
            for k, n in got.items():
                by_phase[k]["11"] = n
        elif phase == 13:
            results["decode_attention_partial"], n = phase_slot_shards(
                torch, dec, attention, card)
            by_phase["decode_attention_partial"]["13"] = n
        elif phase == 12:
            phase_family_train_small(torch, configs, trainer, lm_data,
                                     model, moe, ssm, tree, st, fa)
            by_phase["soft_threshold"]["12"] = phase_family_train(
                torch, configs, trainer, lm_data, moe, ssm, tree, ops, st,
                fa, ref)
        elif phase == 10:
            phase_families_reduced(torch, configs, model, serve, moe, fa,
                                   dec)
            got = phase_families(torch, configs, model, serve, moe, ops, fa,
                                 dec, kernel_ms)
            for k, n in got.items():
                by_phase[k]["10"] = n
        else:
            phase_train_small(torch, configs, trainer, lm_data, model, tree,
                              st, fa)
            by_phase["soft_threshold"]["9"] = phase_train_full(
                torch, configs, trainer, lm_data, model, opt, tree, ops, st,
                fa, ref)
            phase_train_cli(torch, train, tree)
        say(f"[{phase}] phase wall {time.time() - t0:.1f} s")
    if not {2, 4, 5, 6, 7, 10, 13} <= phases:
        say(f"phases {sorted(phases)} passed")
        return

    source = "src/repro_torch/kernels/csrc/{}.cu"
    # (name, source, TPU kernel, on a main path, body: the design that ran)
    meta = {
        "logistic": ("margin_vjp_logistic", "logistic_vjp",
                     "src/repro/kernels/logistic_vjp.py:41", True, lv.BODY),
        "hinge": ("margin_vjp_hinge", "logistic_vjp",
                  "src/repro/kernels/logistic_vjp.py:41", True, lv.BODY),
        "soft_threshold": ("soft_threshold", "soft_threshold",
                           "src/repro/kernels/soft_threshold.py:20", True,
                           st.BODY),
        "flash_attention": ("flash_attention", "flash_attention",
                            "src/repro/kernels/flash_attention.py:28", True,
                            results["flash_attention"]["body"]),
        "flash_attention_noncausal": (
            "flash_attention_noncausal", "flash_attention",
            "src/repro/kernels/flash_attention.py:28", True,
            results["flash_attention_noncausal"]["body"]),
        "decode_attention": ("decode_attention", "decode_attention",
                             "src/repro/kernels/decode_attention.py:26",
                             True, results["decode_attention"]["body"]),
        "decode_attention_partial": (
            "decode_attention_partial", "decode_attention",
            "src/repro/kernels/decode_attention.py:26", True,
            results["decode_attention_partial"]["body"] + " partial"),
    }
    kernels = []
    for key, (name, src, replaces, on_path, body) in meta.items():
        r = results[key]
        if not by_phase[key] or 0 in by_phase[key].values():
            fail(f"{name}: a main path launched it no time: {by_phase[key]}")
        kernels.append(dict(
            name=name, route="cuda", source=source.format(src),
            replaces=replaces, launches=sum(by_phase[key].values()),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms"), on_path=on_path, body=body,
            shape=r["shape"], launches_by_phase=by_phase[key],
            **{k: r[k] for k in ("eager_ms", "eager_plain_ms", "read_ms",
                                 "floor_ms", "ms_1e6", "bound_ms_1e6",
                                 "paths", "whole_ms")
               if k in r}))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
