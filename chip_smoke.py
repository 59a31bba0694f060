#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --phases 1,2    # build and hold the kernels only

Phases, one line each (any failure exits non-zero; nothing is caught):
  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, the kernels' build time;
  2. kernel parity: each CUDA kernel against its plain PyTorch version on
     the card, on small ragged shapes and at the main path's shapes, with
     the kernel's, the plain version's and the bound's times;
  3. small instances on the card: the engine suite's logreg instance
     against the reference's trace (ENGINE_ANCHOR), and the registry's
     default instance in float64 against the same run on the CPU and in
     float32 (both engines) against that float64 run;
  4. the main path at the paper's size: N=600 000, d=10 000, W=64, the
     batched engine with kernel="cuda", through ``api.run``, with every
     kernel's launch count read around that run;
  5. the kernels line: {"kernels": [...]};
  6. the last line: {"ok": true, "device": {...}}.

It imports torch and the port only.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
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

# the bound: H100 SXM peak memory rate and float32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# parity: |kernel - plain| <= PARITY_RTOL * max(1, max|plain|), per output
PARITY_RTOL = 1e-5


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` with the host taken out: ``reps`` calls
    captured in one CUDA graph, replayed once between CUDA events.  For a
    launch-bound kernel, where ``cuda_ms`` measures the host's launch
    rate."""
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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want, name: str) -> float:
    err = float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0
    scale = max(1.0, float(want.double().abs().max()) if want.numel() else 0)
    if not math.isfinite(err) or err > PARITY_RTOL * scale:
        fail(f"{name}: max |kernel - plain| = {err:.3e} exceeds "
             f"{PARITY_RTOL:g} * {scale:.3e}")
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
    f_k, g_k = lv.margin_vjp_cuda(A, b, mask, x, loss=loss, gamma=gamma)
    if loss == "logistic":
        f_p, g_p = ref.logistic_vjp_ref(A, b, mask, x)
    else:
        f_p, g_p = ref.svm_vjp_ref(A, b, mask, x, gamma)
    torch.cuda.synchronize()
    for lane in zero_lanes:
        if float(f_k[lane]) != 0.0 or bool(torch.any(g_k[lane] != 0)):
            fail(f"{loss}: all-zero-mask lane {lane} is not exactly 0")
    shape = tuple(A.shape)
    return max(max_err(torch, f_k, f_p, f"{loss} loss {shape}"),
               max_err(torch, g_k, g_p, f"{loss} grad {shape}"))


def check_z_update(torch, st, ref, D, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    omega = torch.randn((D,), generator=g, device="cuda")
    z_old = torch.randn((D,), generator=g, device="cuda")
    thr = 0.37
    z_k, s_k, n_k = st.soft_threshold_cuda(omega, z_old, thr)
    z_p, s_p, n_p = ref.soft_threshold_ref(
        omega, z_old, torch.tensor(thr, dtype=torch.float32, device="cuda"))
    torch.cuda.synchronize()
    if int(n_k) != int(n_p):
        fail(f"z-update D={D}: nnz {int(n_k)} != plain {int(n_p)}")
    return max(max_err(torch, z_k, z_p, f"z-update z D={D}"),
               max_err(torch, s_k, s_p, f"z-update ssq D={D}")), (omega,
                                                                 z_old, thr)


def phase_parity(torch, lv, st, ref):
    results = {}
    worst = {"logistic": 0.0, "hinge": 0.0, "soft_threshold": 0.0}
    small = [((3, 111, 70), (0,)), ((2, 300, 129), (1,)),
             ((1024, 8, 128), (5, 700)), ((8, 256, 128), ()),
             ((1, 1, 5), ())]
    for (W, N, D), zero in small:
        A, b, mask, x = margin_inputs(torch, W, N, D, zero, seed=W + N + D)
        for loss in ("logistic", "hinge"):
            worst[loss] = max(worst[loss], check_margin(
                torch, lv, ref, loss, A, b, mask, x, zero))
    for D in (1, 70, 8320, 1_000_003):
        err, _ = check_z_update(torch, st, ref, D, seed=D)
        worst["soft_threshold"] = max(worst["soft_threshold"], err)
    say(f"[2] small ragged shapes held: logistic {worst['logistic']:.2e}, "
        f"hinge {worst['hinge']:.2e}, z-update "
        f"{worst['soft_threshold']:.2e} (tolerance {PARITY_RTOL:g} x "
        f"max(1, |plain|))")

    # the main path's shapes: W=64 lanes of 9 375 rows, d = 10 000
    W, N, D = PAPER_W, -(-PAPER_KW["n_samples"] // PAPER_W), \
        PAPER_KW["n_features"]
    A, b, mask, x = margin_inputs(torch, W, N, D, (3,), seed=1)
    n_bytes = 4.0 * (W * N * D + 2 * W * N + 2 * W * D + W)
    for loss in ("logistic", "hinge"):
        err = check_margin(torch, lv, ref, loss, A, b, mask, x, (3,))
        worst[loss] = max(worst[loss], err)
        kern = (lambda: lv.margin_vjp_cuda(A, b, mask, x, loss=loss,
                                           gamma=0.5))
        plain = ((lambda: ref.logistic_vjp_ref(A, b, mask, x))
                 if loss == "logistic"
                 else (lambda: ref.svm_vjp_ref(A, b, mask, x, 0.5)))
        ms_k = cuda_ms(torch, kern, reps=5)
        ms_p = cuda_ms(torch, plain, reps=3)
        b_ms, b_by = bound_ms(n_bytes, 4.0 * W * N * D)
        results[loss] = dict(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=worst[loss],
                             shape=[W, N, D])
        say(f"[2] {loss} at (W, N, D) = ({W}, {N}, {D}): max err {err:.2e}"
            f", kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}: {n_bytes / 1e9:.2f} GB at 3.35 TB/s)")
    del A, b, mask, x
    torch.cuda.empty_cache()

    err, (omega, z_old, thr) = check_z_update(torch, st, ref, D, seed=2)
    worst["soft_threshold"] = max(worst["soft_threshold"], err)
    thr_t = torch.tensor(thr, dtype=torch.float32, device="cuda")

    def kern():
        st.soft_threshold_cuda(omega, z_old, thr)

    def plain():
        ref.soft_threshold_ref(omega, z_old, thr_t)
    eager_k = cuda_ms(torch, kern, reps=200, warmup=5)
    eager_p = cuda_ms(torch, plain, reps=200, warmup=5)
    ms_k = graph_ms(torch, kern, reps=200)
    ms_p = graph_ms(torch, plain, reps=200)
    b_ms, b_by = bound_ms(4.0 * 3 * D + 4 + 4 + 8, 6.0 * D)
    results["soft_threshold"] = dict(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                                     bound_by=b_by,
                                     max_abs_err=worst["soft_threshold"],
                                     shape=[D], eager_ms=eager_k,
                                     eager_plain_ms=eager_p)
    say(f"[2] z-update at D = {D}: max err {err:.2e}; device time (CUDA "
        f"graph) kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms; per eager call "
        f"kernel {eager_k:.4f} ms, plain {eager_p:.4f} ms; bound "
        f"{b_ms:.6f} ms ({b_by})")
    return results


# ---------------------------------------------------------------------------
# phase 3: small instances
# ---------------------------------------------------------------------------


def small_run(api, SchedulerConfig, AdmmOptions, PoolConfig, kw, W, rounds,
              engine, kernel, device):
    spec = api.ExperimentSpec(
        problem="logreg", problem_kwargs=kw,
        scheduler=SchedulerConfig(n_workers=W, engine=engine, kernel=kernel,
                                  admm=AdmmOptions(max_iters=40),
                                  pool=PoolConfig(seed=0)),
        max_rounds=rounds)
    res = api.run(spec, device=device)
    if len(res.trace) != rounds:
        fail(f"{engine}/{kernel} on {device}: {len(res.trace)} rounds, "
             f"expected {rounds}")
    return res


def rsr(trace):
    return [(r["r_norm"], r["s_norm"], r["rho"]) for r in trace]


def hold(name, got, want, rtol, cols=(0, 1, 2)):
    if len(got) != len(want):
        fail(f"{name}: {len(got)} rounds against {len(want)}")
    worst = 0.0
    for k, (row_g, row_w) in enumerate(zip(got, want), 1):
        for c in cols:
            diff = abs(row_g[c] - row_w[c])
            gap = diff / max(abs(row_w[c]), 1e-9)
            if not math.isfinite(row_g[c]) or (gap > rtol and diff > 1e-9):
                fail(f"{name}: round {k} column {c}: {row_g[c]!r} vs "
                     f"{row_w[c]!r} (rtol {rtol:g})")
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


# ---------------------------------------------------------------------------
# phase 4: the main path at the paper's size
# ---------------------------------------------------------------------------


def phase_main(torch, api, problems, SchedulerConfig, lv, st, ref,
               kernel_ms):
    cfg = SchedulerConfig(n_workers=PAPER_W, engine="batched", kernel="cuda")
    spec = api.ExperimentSpec(problem="logreg", problem_kwargs=PAPER_KW,
                              scheduler=cfg, max_rounds=PAPER_ROUNDS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    problem = problems.make("logreg", device="cuda", **PAPER_KW)
    (idx, vals, b), mask = problem.batch_shards(PAPER_W)
    torch.cuda.synchronize()
    t_gen = time.time() - t0
    t0 = time.time()
    (A, b_dense), _ = problem.kernel_batch_shards(PAPER_W)
    torch.cuda.synchronize()
    t_stage = time.time() - t0
    say(f"[4] paper instance: generated {PAPER_KW['n_samples']} x "
        f"{PAPER_KW['n_features']} (density {PAPER_KW['density']}) in "
        f"{t_gen:.2f} s; staged dense shards {tuple(A.shape)} "
        f"({A.numel() * 4 / 1e9:.2f} GB) in {t_stage:.2f} s")

    walls, per_round = [], []
    t_last = [time.time()]

    def on_round(m):
        torch.cuda.synchronize()
        now = time.time()
        walls.append(now - t_last[0])
        t_last[0] = now
        per_round.append((lv.LAUNCHES["logistic"],
                          st.LAUNCHES["soft_threshold"]))

    lv.reset_launches()
    st.reset_launches()
    t_last[0] = time.time()
    res = api.run(spec, problem=problem, on_round=on_round)
    launches = {"logistic": lv.LAUNCHES["logistic"],
                "hinge": lv.LAUNCHES["hinge"],
                "soft_threshold": st.LAUNCHES["soft_threshold"]}
    before = (0, 0)
    for row, wall, counts in zip(res.trace, walls, per_round):
        n_margin, n_z = (c - b for c, b in zip(counts, before))
        before = counts
        busy = ""
        if kernel_ms:
            t_k = (n_margin * kernel_ms["logistic"]
                   + n_z * kernel_ms["soft_threshold"]) / 1e3
            busy = f" (launches x phase-2 kernel time: {t_k:.2f} s)"
        say(f"[4] round {row['k']}: wall {wall:.2f} s, margin launches "
            f"{n_margin}, z-update launches {n_z}{busy}, r_norm "
            f"{row['r_norm']:.6g}, s_norm {row['s_norm']:.6g}, rho "
            f"{row['rho']:g}, inner_mean {row['inner_mean']:.3f}, "
            f"inner_max {int(res.history[row['k'] - 1].inner_iters.max())}"
            f", z_nnz {row['z_nnz']}")
    if launches["logistic"] <= 0 or launches["soft_threshold"] <= 0:
        fail(f"the main path did not go through the kernels: {launches}")
    z = res.z
    if z.shape != (PAPER_KW["n_features"],) or not all(
            math.isfinite(v) for v in z.tolist()):
        fail("the paper instance's z is not a finite d-vector")
    for row in res.trace:
        if not (math.isfinite(row["r_norm"]) and math.isfinite(row["s_norm"])
                and row["inner_mean"] >= 1 and row["z_nnz"] >= 0):
            fail(f"bad trace row {row}")

    # the staged shards: kernel against plain at the workers' last x
    xs = res.scheduler.x.contiguous()
    f_k, g_k = lv.margin_vjp_cuda(A, b_dense, mask, xs, loss="logistic")
    f_p, g_p = ref.logistic_vjp_ref(A, b_dense, mask, xs)
    torch.cuda.synchronize()
    err = max(max_err(torch, f_k, f_p, "logistic on the staged shards"),
              max_err(torch, g_k, g_p, "logistic grad on the staged shards"))
    say(f"[4] launches in the run: {launches} over {len(res.trace)} rounds; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB; kernel vs plain on the staged shards {err:.2e}; final z_nnz "
        f"{int((abs(z) > 0).sum())}")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4",
                    help="comma-separated phases to run (default: all)")
    phases = {int(p) for p in ap.parse_args(argv).phases.split(",")}

    if not (SRC / "repro_torch" / "api.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    sys.path.insert(0, str(SRC))
    from repro_torch import api, problems
    from repro_torch.core.admm import AdmmOptions
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import logistic_vjp as lv
    from repro_torch.kernels import soft_threshold as st
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
    for name, log in build.LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[1] {name}: {line.strip()}")

    results = phase_parity(torch, lv, st, ref) if 2 in phases else {}
    if 3 in phases:
        phase_small(torch, api, SchedulerConfig, AdmmOptions, PoolConfig,
                    lv, st)
    if 4 not in phases:
        say(f"phases {sorted(phases)} passed")
        return
    launches = phase_main(torch, api, problems, SchedulerConfig, lv, st,
                          ref, {k: r["ms"] for k, r in results.items()})
    if 2 not in phases:
        say(f"phases {sorted(phases)} passed")
        return

    source = "src/repro_torch/kernels/csrc/{}.cu"
    meta = {
        "logistic": ("margin_vjp_logistic", "logistic_vjp",
                     "src/repro/kernels/logistic_vjp.py:41", True),
        "hinge": ("margin_vjp_hinge", "logistic_vjp",
                  "src/repro/kernels/logistic_vjp.py:41", False),
        "soft_threshold": ("soft_threshold", "soft_threshold",
                           "src/repro/kernels/soft_threshold.py:20", True),
    }
    kernels = []
    for key, (name, src, replaces, on_path) in meta.items():
        r = results[key]
        kernels.append(dict(
            name=name, route="cuda", source=source.format(src),
            replaces=replaces, launches=launches[key],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            on_path=on_path, shape=r["shape"],
            **{k: r[k] for k in ("eager_ms", "eager_plain_ms") if k in r}))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
