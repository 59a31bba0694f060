#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --phases 1,2,5  # the kernels and serving only
    python3 chip_smoke.py --phases 1,2,6  # the kernels and svm at size
    python3 chip_smoke.py --phases 1,2,7  # the kernels and the cluster
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
     z-update);
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
     runtime.loadgen (equal reports);
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
then the kernels line {"kernels": [...]} (when phases 2, 4, 5, 6 and 7
ran; each entry names the kernel's design in "body" and its launches on
each main path in "launches_by_phase") and the last line
{"ok": true, "device": {...}}.

It imports torch and the port only.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
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


def flash_flops(B, S, H, hd, window):
    """4 B H hd times the visible (query, key) pairs of causal attention."""
    pairs = sum(min(i + 1, window or i + 1) for i in range(S))
    return 4.0 * B * H * hd * pairs


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
        prompt, tok = stats["prompt"], out[:, :1].cuda()
        held = prefill_then_decode(torch, model, params, cfg, prompt, tok,
                                   stats["first_decode_logits"])
        # device time of one decode step (mid-run position, the phase-2
        # decode shape), captured in a CUDA graph: the host taken out
        cache = model.init_cache(cfg, SERVE_B, SERVE_P + SERVE_GEN,
                                 device="cuda")
        step = {"tokens": tok, "positions": torch.full(
            (SERVE_B,), SERVE_P + SERVE_GEN // 2 - 1, dtype=torch.int32,
            device="cuda")}
        dev_ms = graph_ms(
            torch, lambda: model.decode_step(params, cfg, step, cache), 4)
        del cache, params
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params = model.init_params(
            cfg32, generator=torch.Generator(device="cuda").manual_seed(1),
            device="cuda")
        held32 = prefill_then_decode(torch, model, params, cfg32, prompt,
                                     tok, None)
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


def prefill_then_decode(torch, model, params, cfg, prompt, tok, got):
    """The decode step's logits for ``tok`` at position P (``got``, or
    computed here after a prefill over ``prompt``) against the last logits
    of a prefill over ``prompt`` + ``tok``; the control is the same step
    given position P + 1.  Returns the relative L2 gap, the share of rows
    with the same argmax, the max gap and max |logit|, and the control's
    relative L2 and argmax share."""
    (B, P), dev = prompt.shape, prompt.device
    cache = model.init_cache(cfg, B, P + 2, device=dev)
    model.prefill(params, cfg, {"tokens": prompt}, cache, last_only=True)
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    if got is None:
        saved = {k: t.clone() for k, t in cache.items()}
        got = model.decode_step(params, cfg, {"tokens": tok, "positions": pos},
                                cache)[0][:, 0]
        cache = saved
    ctrl = model.decode_step(params, cfg, {"tokens": tok,
                                           "positions": pos + 1}, cache)[0]
    del cache
    cache = model.init_cache(cfg, B, P + 1, device=dev)
    want = model.prefill(params, cfg, {"tokens": torch.cat([prompt, tok], 1)},
                         cache, last_only=True)[0][:, 0]
    del cache

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
                kernel_ms, phase):
    """Phase 4 (logreg) or 6 (svm): generate and stage the paper's data
    for W=64, run PAPER_ROUNDS rounds through ``api.run`` with
    kernel="cuda", hold the margin kernel against its plain version on the
    staged shards at the workers' last x, then the witness (the same
    rounds twice with kernel="torch", the plain sparse path on the card,
    whose two runs must agree bit for bit) and the control (the kernel path
    with ``control_mask``).  Returns the run's launch counts and its
    ``round_keys``."""
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
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--src", type=Path,
                    help="run no phase: time the margin kernel and the "
                         "z-update of the port under this src directory "
                         "and print one JSON line (see time_admm_kernels)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not phases <= set(range(1, 8)):
        fail(f"--phases takes phases 1 to 7, got {sorted(phases)}")

    if not (SRC / "repro_torch" / "api.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    if args.src is not None:
        time_admm_kernels(torch, args.src.resolve())
        return
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F
    from repro_torch import api, configs, problems
    from repro_torch import runtime as rt
    from repro_torch.core.admm import AdmmOptions
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import logistic_vjp as lv
    from repro_torch.kernels import soft_threshold as st
    from repro_torch.launch import serve
    from repro_torch.models import attention, model
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
    if 2 in phases:
        results.update(phase_parity(torch, lv, st, ref))
        results.update(phase_attention_parity(torch, fa, dec, attention, F))
    if 3 in phases:
        phase_small(torch, api, SchedulerConfig, AdmmOptions, PoolConfig,
                    lv, st)
        phase_small_modes(torch, api, SchedulerConfig, AdmmOptions,
                          PoolConfig, lv, st)
        phase_small_cluster(torch, api, problems, rt, AdmmOptions, lv, st)
    kernel_ms = {k: r["ms"] for k, r in results.items()}
    # each main path's launches, read around its own run: kernel -> phase
    # -> count
    by_phase = {k: {} for k in ("logistic", "hinge", "soft_threshold",
                                "flash_attention", "decode_attention")}
    # phases 4 and 6's kernel-path runs: round_keys and launch counts, the
    # solo runs phase 7's jobs are held to
    solo, solo_launches = {}, {}
    for phase in (4, 5, 6, 7):
        if phase not in phases:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        if phase in (4, 6):
            got, solo[phase] = phase_paper(torch, api, problems,
                                           SchedulerConfig, lv, st, ref,
                                           kernel_ms, phase)
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
        else:
            got = phase_cluster(torch, api, problems, rt, lv, st, solo,
                                solo_launches, kernel_ms)
            for engine, counts in got.items():
                for k, n in counts.items():
                    by_phase[k][f"7 {engine}"] = n
    if not {2, 4, 5, 6, 7} <= phases:
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
        "decode_attention": ("decode_attention", "decode_attention",
                             "src/repro/kernels/decode_attention.py:26",
                             True, results["decode_attention"]["body"]),
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
                                 "floor_ms", "ms_1e6", "bound_ms_1e6")
               if k in r}))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
