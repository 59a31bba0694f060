"""The slice end to end: the port's ``api.run(device="cpu")`` against the
JAX package's ``api.run`` on the same spec, seed and shards.

Shards are carried across (``repro_torch.problems.carry_shards``) so a
data fault cannot hide or imitate a solver fault; one test lets the port
generate its own.  JAX runs with the partitionable threefry layout the
port reproduces.

Three yardsticks, by how much float32 rounding the instance amplifies:

* float64, the registry's default instance (n=2048, d=128, W=8): both
  engines agree with the reference to 1e-15 (measured), with equal
  per-worker inner-iteration counts.
* float32, the engine suite's logreg instance (``tests/test_engine.py``,
  n=50, d=24, W=4): the kernel engine's tolerances
  (``test_kernel_engine.assert_kernel_traces_allclose``): rtol 1e-4,
  atol 1e-6, ``inner_mean`` atol 2/W; z at rtol 1e-4 / atol 2e-5
  (measured gap: 4e-7).  That slack lets one lane end one iteration
  earlier or later, and the simulated clock and the bill follow the
  counts: one iteration more in one lane of round 1 moves sim_time by
  3.0e-3, cost_usd by 9.1e-3 and that round's wall time by 3.5e-2
  (measured), so those keys are held at 1e-2, 2e-2 and 1e-1.
* float32, the default instance: here FISTA's stops and backtracking
  steps are decided by float32 rounding (its f ≈ 180 per worker, and the
  monotone safeguard ends a lane at the first step that does not lower
  f in float32), so two correct float32 implementations drift apart:
  measured 6.1e-4 on r_norm, 1.4e-2 on s_norm, 1.6e-3 on z, 3.1 on
  inner_mean, and the per-worker times and dollars follow the counts.
  Held at the widened tolerances below, on the residual trace and z.

The literal ``SEED_ANCHOR`` and the golden logreg rows are not used: they
were drawn from the non-partitionable threefry stream (with that layout
the reference's first s_norm is 13.20208 against the anchor's 13.20130;
with the partitionable one it is 13.97455), so no run on this stream can
reproduce them.  ``chip_smoke.py``'s own anchor is checked here instead.
"""
import contextlib
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as j_api                                # noqa: E402
from repro import problems as j_problems                      # noqa: E402
from repro.core.admm import AdmmOptions as JAdmm              # noqa: E402
from repro.runtime.pool import PoolConfig as JPool            # noqa: E402
from repro.runtime.scheduler import SchedulerConfig as JCfg   # noqa: E402
from repro_torch import api as t_api                          # noqa: E402
from repro_torch import problems as t_problems                # noqa: E402
from repro_torch.core import prox as t_prox                   # noqa: E402
from repro_torch.core.admm import AdmmOptions                 # noqa: E402
from repro_torch.data import threefry as tf                   # noqa: E402
from repro_torch.data.logreg import shard_rows                # noqa: E402
from repro_torch.kernels import logistic_vjp as t_lv          # noqa: E402
from repro_torch.kernels import soft_threshold as t_st        # noqa: E402
from repro_torch.runtime.pool import PoolConfig               # noqa: E402
from repro_torch.runtime.scheduler import SchedulerConfig     # noqa: E402
from test_torch_data import jax_config                        # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 6
GOLDEN_KW = dict(n_samples=50, n_features=24, density=0.2, lam1=0.05)
TRACE_KEYS = ("r_norm", "s_norm", "rho", "sim_time", "cost_usd",
              "round_wall_s", "inner_mean")
PORT_KERNEL = {"xla": "torch", "pallas": "cuda"}


@contextlib.contextmanager
def _pallas_mode(kernel: str):
    old = os.environ.get("REPRO_PALLAS")
    os.environ["REPRO_PALLAS"] = "interpret" if kernel == "pallas" else "ref"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_PALLAS", None)
        else:
            os.environ["REPRO_PALLAS"] = old


def _cfg_extras(cfg, pool_cls):
    """Scheduler fields beyond the ones named below, for either package:
    ``pool_seed`` becomes that package's ``PoolConfig(seed=...)``; the rest
    (compress, async_batch, ...) pass as they are."""
    cfg = dict(cfg)
    seed = cfg.pop("pool_seed", None)
    if seed is not None:
        cfg["pool"] = pool_cls(seed=seed)
    return cfg


def jax_run(kw, W, engine, kernel, *, problem="logreg", mode="sync",
            fanin="flat", rounds=ROUNDS, x64=False, rescale_to=None, **cfg):
    """The reference run of the registered ``problem``; returns (trace, z,
    its shards as numpy)."""
    with jax_config(jax_threefry_partitionable=True,
                    jax_enable_x64=x64), _pallas_mode(kernel):
        p = j_problems.make(problem, **kw)
        spec = j_api.ExperimentSpec(
            problem=problem, problem_kwargs=kw,
            scheduler=JCfg(n_workers=W, mode=mode, engine=engine,
                           kernel=kernel, fanin=fanin, replication=2,
                           admm=JAdmm(max_iters=rounds),
                           **_cfg_extras(cfg, JPool)),
            max_rounds=rounds)
        if rescale_to is None:
            res = j_api.run(spec, problem=p)
            trace, z = res.trace, np.asarray(res.z)
        else:
            _, sched = j_api.build(spec, problem=p)
            trace, z = _run_with_rescale(sched, rounds, rescale_to,
                                         j_api.result_from_scheduler, spec, p)
        shards = {k: tuple(np.asarray(a) for a in v)
                  for k, v in p._shard_cache.items()}
    return trace, z, shards


def port_run(kw, W, engine, kernel, shards=None, *, problem="logreg",
             mode="sync", fanin="flat", rounds=ROUNDS, rescale_to=None,
             **cfg):
    p = t_problems.make(problem, device="cpu", **kw)
    if shards is not None:
        t_problems.carry_shards(p, shards)
    spec = t_api.ExperimentSpec(
        problem=problem, problem_kwargs=kw,
        scheduler=SchedulerConfig(n_workers=W, mode=mode, engine=engine,
                                  kernel=kernel, fanin=fanin, replication=2,
                                  admm=AdmmOptions(max_iters=rounds),
                                  **_cfg_extras(cfg, PoolConfig)),
        max_rounds=rounds)
    if rescale_to is None:
        res = t_api.run(spec, problem=p)
        return res.trace, res.z
    _, sched = t_api.build(spec, problem=p)
    return _run_with_rescale(sched, rounds, rescale_to,
                             t_api.result_from_scheduler, spec, p)


def _run_with_rescale(sched, rounds, new_w, result_fn, spec, problem):
    for k in range(rounds):
        if k == rounds // 2:
            sched.rescale(new_w)
        sched.step()
    res = result_fn(spec, problem, sched)
    return res.trace, np.asarray(res.z)


# keys that follow the per-worker inner-iteration counts (module docstring)
COUNT_RTOL = {"sim_time": 1e-2, "cost_usd": 2e-2, "round_wall_s": 1e-1}


def assert_traces_close(ref, got, W, rtol=1e-4, atol=1e-6, count_rtol=None):
    count_rtol = COUNT_RTOL if count_rtol is None else count_rtol
    assert len(ref) == len(got)
    for key in TRACE_KEYS:
        a = np.array([row[key] for row in ref], np.float64)
        b = np.array([row[key] for row in got], np.float64)
        if key == "inner_mean":
            np.testing.assert_allclose(b, a, atol=2.0 / W + 1e-9,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(b, a, rtol=count_rtol.get(key, rtol),
                                       atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# float64: the solver port is exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_float64_default_instance_matches_jax(engine):
    kw = dict(dtype="float64")
    ref, zj, shards = jax_run(kw, 8, engine, "xla", x64=True)
    got, zt = port_run(kw, 8, engine, "torch", shards)
    assert [r["inner_mean"] for r in got] == [r["inner_mean"] for r in ref]
    assert_traces_close(ref, got, 8, rtol=1e-9, atol=1e-12, count_rtol={})
    np.testing.assert_allclose(zt, zj, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# float32: the engine suite's instance (tests/test_torch_engines.py holds
# every engine/kernel/mode pair on it)
# ---------------------------------------------------------------------------


def test_port_generated_shards_match_jax():
    """The port generates its own shards (vals a few ulp from JAX's)."""
    ref, zj, _ = jax_run(GOLDEN_KW, 4, "loop", "xla")
    got, zt = port_run(GOLDEN_KW, 4, "loop", "torch")
    assert_traces_close(ref, got, 4)
    np.testing.assert_allclose(zt, zj, rtol=1e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# float32: the registry's default instance (W=8, 6 rounds)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine,kernel", [("loop", "xla"),
                                           ("batched", "pallas")])
def test_default_instance_float32_matches_jax(engine, kernel):
    """Widened to the measured float32 drift (see the module docstring):
    r_norm rtol 5e-3 (measured 6.1e-4), s_norm rtol 1e-1 (measured
    1.4e-2), rho exact, z atol 1e-2 (measured 1.6e-3)."""
    ref, zj, shards = jax_run({}, 8, engine, kernel)
    t_lv.reset_launches()
    t_st.reset_launches()
    got, zt = port_run({}, 8, engine, PORT_KERNEL[kernel], shards)
    for key, rtol in (("r_norm", 5e-3), ("s_norm", 1e-1), ("rho", 0.0)):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in ref], rtol=rtol,
                                   atol=1e-9, err_msg=key)
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-2)
    # on the CPU the fused wrappers ran their plain versions
    assert t_lv.LAUNCHES == {"logistic": 0, "hinge": 0,
                             "logistic_rows": 0, "hinge_rows": 0}
    assert t_st.LAUNCHES == {"soft_threshold": 0}


# ---------------------------------------------------------------------------
# chip_smoke.py's anchor is the reference's
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_anchor_is_the_reference_run():
    """``chip_smoke.ENGINE_ANCHOR`` (r_norm, s_norm, rho per round) is the
    JAX reference's run of the engine suite's instance; the smoke holds
    the card's runs against it at GOLDEN_RTOL["batched"] = 2e-3."""
    smoke = _chip_smoke()
    ref, _, _ = jax_run(GOLDEN_KW, smoke.ENGINE_W, "loop", "xla")
    got = [(r["r_norm"], r["s_norm"], r["rho"]) for r in ref]
    np.testing.assert_allclose(np.asarray(got), np.asarray(
        smoke.ENGINE_ANCHOR), rtol=smoke.ANCHOR_RTOL, atol=1e-9)
    assert smoke.ENGINE_KW == GOLDEN_KW


# ---------------------------------------------------------------------------
# the FistaShardProblem scaffolding, on a toy workload
# ---------------------------------------------------------------------------


class _LeastSquares(t_problems.FistaShardProblem):
    """f_w(x) = 1/2 ||A_w x - y_w||², h = 0.1 ||z||_1, rows drawn from the
    per-global-row keys."""

    def _gen_shard(self, wid, n_workers):
        lo, hi = shard_rows(self.total_samples, n_workers, wid)
        keys = self._row_keys(lo, hi)
        return (tf.normal(keys, self.n_features).to(self.dtype),
                tf.uniform(keys).to(self.dtype))

    def _loss_value_and_grad(self, shard):
        A, y = shard

        def vg(x):
            r = A @ x - y
            return 0.5 * torch.dot(r, r), A.T @ r
        return vg

    def _masked_loss_value_and_grad(self, batch, mask):
        A, y = batch

        def vg(X):
            r = ((A @ X[..., None])[..., 0] - y) * mask
            return (0.5 * torch.sum(r * r, dim=-1),
                    (r[..., None, :] @ A)[..., 0, :])
        return vg

    def prox_h(self, v, t):
        return t_prox.prox_l1(v, t, 0.1)

    def h_value(self, z):
        return 0.1 * float(torch.sum(torch.abs(z)))


def test_fista_shard_scaffolding_engines_agree():
    """A workload on the scaffolding runs both engines (uneven shards:
    W=3 over 50 rows) to the same trace, and re-sharding regenerates the
    same global rows."""
    def trace(engine):
        p = _LeastSquares(50, 6, seed=3, dtype="float64", device="cpu",
                          fista=dict(min_iters=1, eps_grad=1e-8))
        sched = t_api.Scheduler(p, SchedulerConfig(n_workers=3,
                                                   engine=engine))
        sched.solve(max_rounds=5)
        return p, [(m.r_norm, m.s_norm, m.rho, float(m.inner_iters.mean()))
                   for m in sched.history]
    p, loop = trace("loop")
    _, batched = trace("batched")
    np.testing.assert_allclose(batched, loop, rtol=1e-9, atol=1e-12)
    one = p._shard(0, 1)[0]
    three = torch.cat([p._shard(w, 3)[0] for w in range(3)])
    assert torch.equal(one, three)
    assert [p.n_samples(w, 3) for w in range(3)] == [17, 17, 16]
    x = torch.full((6,), 0.5, dtype=torch.float64)
    assert p.objective(x, 3) == pytest.approx(
        0.3 + sum(p.local_value(w, 3, x) for w in range(3)))


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

F64 = dict(dtype="float64")


@pytest.mark.parametrize("cfg,kw,err", [
    (dict(kernel="pallas"), {}, ValueError),
    (dict(kernel="xla"), {}, ValueError),
    (dict(engine="vmap"), {}, ValueError),
    (dict(fanin="ring"), {}, ValueError),
    (dict(mode="bulk"), {}, ValueError),
    (dict(compress="gzip"), {}, ValueError),
])
def test_unported_options_raise(cfg, kw, err):
    p = t_problems.make("logreg", device="cpu", n_samples=40, n_features=8,
                        **kw)
    with pytest.raises(err):
        t_api.build(t_api.ExperimentSpec(
            scheduler=SchedulerConfig(n_workers=2, **cfg)), problem=p)


@pytest.mark.parametrize("cfg,kw", [
    (dict(mode="async_"), {}), (dict(compress="topk"), {}),
    (dict(compress="qsgd", engine="batched"), {}),
    (dict(checkpoint_every=2, checkpoint_dir="ckpt"), {}),
    # the float64 kernel path, in every mode
    (dict(kernel="cuda", mode="async_"), F64),
    (dict(kernel="cuda", compress="topk"), F64),
    (dict(kernel="cuda", compress="qsgd", engine="batched"), F64),
    (dict(kernel="cuda", checkpoint_every=2), F64),
    (dict(kernel="cuda", engine="batched"), F64),
])
def test_ported_modes_run(cfg, kw, tmp_path):
    """Each option the first slices refused now runs, the float64 kernel
    path included; checkpoint fields are accepted and write nothing, as in
    the reference's scheduler."""
    if "checkpoint_dir" in cfg:
        cfg = dict(cfg, checkpoint_dir=str(tmp_path / cfg["checkpoint_dir"]))
    p = t_problems.make("logreg", device="cpu", n_samples=40, n_features=8,
                        **kw)
    res = t_api.run(t_api.ExperimentSpec(
        scheduler=SchedulerConfig(n_workers=2, **cfg), max_rounds=2),
        problem=p)
    assert len(res.trace) == 2 and np.all(np.isfinite(res.z))
    assert not any(tmp_path.iterdir())


def test_second_order_problems_raise():
    """Second-order problems run since the second-order slice; what they
    cannot take raises: the fused kernels, async_, compression."""
    class _Newton:
        second_order = True
        n_features = 4
        redundancy = 1
        dtype = torch.float32
    for cfg, msg in ((dict(kernel="cuda"), "second-order"),
                     (dict(mode="async_"), "second-order"),
                     (dict(compress="topk"), "second-order")):
        with pytest.raises(ValueError, match=msg):
            t_api.Scheduler(_Newton(), SchedulerConfig(n_workers=2, **cfg))


def test_entry_points_default_to_the_card():
    spec = t_api.ExperimentSpec(scheduler=SchedulerConfig(n_workers=2),
                                max_rounds=1)
    if torch.cuda.is_available():
        assert t_problems.make("logreg").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_api.run(spec)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_problems.make("logreg")


if __name__ == "__main__":
    # print chip_smoke.ENGINE_ANCHOR from the reference
    trace, _, _ = jax_run(GOLDEN_KW, 4, "loop", "xla")
    print([(r["r_norm"], r["s_norm"], r["rho"]) for r in trace])
