"""The six example twins (``examples/*_torch.py``) against the reference
examples they mirror, on the CPU.

Each reference example and its twin are loaded by path and shrunk to the
same reduced float64 instance by patching module constants here, not in the
files (``quickstart`` builds its spec inside ``main()``, so its ``run`` is
wrapped to swap the problem's kwargs).  The reference's shards are carried
into the port's problems (``problems.carry_shards``), so the two runs solve
the same rows.  Both print to ``capsys``, and their outputs are held line
for line: the text equal, and each printed number within 1e-9 relative.

The LM twins run through ``runpy`` with ``--device cpu`` against their
references at tiny sizes, on the reference's weights (and state) carried
across: ``serve_model`` prints the same sample ids, ``train_admm_lm
--quick`` the same round lines, with their timings masked, as the CLI
tests in ``test_torch_train.py`` and ``test_torch_families.py`` hold them.

Without a card, each twin's default run raises.
"""
import dataclasses
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import problems as j_problems                      # noqa: E402
from repro.core import admm as j_admm                         # noqa: E402
from repro.core import trainer as j_trainer                   # noqa: E402
from repro.models import model as j_model                     # noqa: E402
from repro_torch import problems as t_problems                # noqa: E402
from repro_torch.core import admm as t_admm                   # noqa: E402
from repro_torch.core import trainer as t_trainer             # noqa: E402
from repro_torch.launch import serve as t_serve               # noqa: E402
from repro_torch.models import model as t_model               # noqa: E402
from repro_torch.models.convert import state_from_jax         # noqa: E402
from test_torch_data import jax_config                        # noqa: E402
from test_torch_families import (_carried, _cfgs,             # noqa: E402
                                 _reference_prompt, _tb)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
FIRST_ORDER = ("quickstart", "cost_aware", "elastic_faults", "double_ml")
TWINS = FIRST_ORDER + ("serve_model", "train_admm_lm")
# the reduced instance every first-order example pair runs here
SMALL_KW = dict(n_samples=512, n_features=32, density=0.1, lam1=0.5,
                fista=dict(min_iters=1), dtype="float64")
DML_SMALL = dict(N=256, P=12, K=2)
NUMBER_RTOL = 1e-9
NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def load(name: str):
    """The example ``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hold_lines(got: str, want: str):
    """Line for line: the text equal with the numbers masked, and each
    number within NUMBER_RTOL relative."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(got_lines, want_lines):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        gn = [float(x) for x in NUMBER.findall(g)]
        wn = [float(x) for x in NUMBER.findall(w)]
        np.testing.assert_allclose(gn, wn, rtol=NUMBER_RTOL, atol=0,
                                   err_msg=f"{g!r} vs {w!r}")


def carrying_make(monkeypatch):
    """Patch both packages' ``problems.make``: each reference instance is
    recorded, and the i-th port instance takes the i-th reference
    instance's shards."""
    made = []
    j_make, t_make = j_problems.make, t_problems.make

    def ref_make(name, **kw):
        made.append(j_make(name, **kw))
        return made[-1]

    def port_make(name, **kw):
        p = t_make(name, **kw)
        ref = made[port_make.calls]
        port_make.calls += 1
        t_problems.carry_shards(p, {
            k: tuple(np.asarray(a) for a in v)
            for k, v in ref._shard_cache.items()})
        return p
    port_make.calls = 0
    monkeypatch.setattr(j_problems, "make", ref_make)
    monkeypatch.setattr(t_problems, "make", port_make)
    return made


def run_pair(name, capsys, patch):
    """The reference example under x64 and the partitionable threefry, then
    its twin on the CPU; each patched by ``patch(module, package)``.
    Returns (twin's output, reference's output)."""
    ref, twin = load(name), load(f"{name}_torch")
    patch(ref, "ref")
    patch(twin, "port")
    with jax_config(jax_threefry_partitionable=True, jax_enable_x64=True):
        ref.main()
    want = capsys.readouterr().out
    twin.main(device="cpu")
    got = capsys.readouterr().out
    return got, want


def _small_constants(mod, pkg):
    mod.PROBLEM_KW = SMALL_KW
    admm = j_admm if pkg == "ref" else t_admm
    mod.ADMM = admm.AdmmOptions(max_iters=12)


@pytest.mark.parametrize("name", ["cost_aware", "elastic_faults"])
def test_first_order_twin_prints_what_the_reference_prints(name, capsys,
                                                           monkeypatch):
    carrying_make(monkeypatch)
    got, want = run_pair(name, capsys, _small_constants)
    assert "respawns=" in got and got.count("\n") > 8
    hold_lines(got, want)


def test_quickstart_twin_prints_what_the_reference_prints(capsys,
                                                          monkeypatch):
    made = carrying_make(monkeypatch)

    def patch(mod, pkg):
        real = mod.run

        def run(spec, **kw):
            return real(dataclasses.replace(spec, problem_kwargs=SMALL_KW),
                        **kw)
        mod.run = run
    got, want = run_pair("quickstart", capsys, patch)
    assert len(made) == 1 and "converged in" in got
    hold_lines(got, want)


def test_double_ml_twin_prints_what_the_reference_prints(capsys,
                                                         monkeypatch):
    """Every stage in float64 (``dtype`` added to each stage's kwargs), at
    a reduced (N, P, K)."""
    def patch(mod, pkg):
        for k, v in DML_SMALL.items():
            setattr(mod, k, v)
        real = mod.submit_dag

        def submit_dag(dag, **kw):
            dag = dataclasses.replace(dag, stages=tuple(
                dataclasses.replace(s, spec=dataclasses.replace(
                    s.spec, problem_kwargs=dict(s.spec.problem_kwargs,
                                                dtype="float64")))
                for s in dag.stages))
            return real(dag, **kw)
        mod.submit_dag = submit_dag
    got, want = run_pair("double_ml", capsys, patch)
    assert got.count("rounds=") == 2 * DML_SMALL["K"] + 1
    hold_lines(got, want)


# ---------------------------------------------------------------------------
# the LM twins, through runpy
# ---------------------------------------------------------------------------


def run_script(name, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


# the timing lines' numbers and the reference's "incl. compile" note
TIMING = re.compile(r"\d+ tokens in [\d.]+s \(\d+ tok/s[^)]*\)")


@pytest.mark.parametrize("arch", [None, "rwkv6_1_6b"])
def test_serve_twin_prints_the_references_sample_ids(arch, monkeypatch,
                                                     capsys):
    """The twin's default (mixtral_8x7b's tiny preset, batch 4, prompt 48,
    16 tokens) and ``--arch rwkv6_1_6b``, on the reference's weights and
    prompt."""
    argv = [] if arch is None else ["--arch", arch]
    jcfg, tcfg = _cfgs(arch or "mixtral_8x7b")
    jp, tp = _carried(jcfg, tcfg)
    monkeypatch.setattr(j_model, "init_params", lambda key, cfg: jp)
    monkeypatch.setattr(t_model, "init_params",
                        lambda cfg, generator=None, device=None: tp)
    prompt = {k: np.array(v) for k, v in
              _reference_prompt(jcfg, 4, 48, 0).items()}
    monkeypatch.setattr(t_serve, "synthetic_prompt",
                        lambda cfg, b, n, s, dev: _tb(prompt))
    want = run_script("serve_model", argv, monkeypatch, capsys)
    got = run_script("serve_model_torch", argv + ["--device", "cpu"],
                     monkeypatch, capsys)
    assert "sample output ids" in got
    assert TIMING.sub("#", got) == TIMING.sub("#", want)


def test_train_twin_quick_prints_the_references_rounds(tmp_path, monkeypatch,
                                                       capsys):
    """``--quick --steps 2`` from the reference's initial state: the same
    round lines (timings masked); the echoed CLI names the port's module
    and its own checkpoint directory."""
    drawn = []
    real_init = j_trainer.init_state

    def record(*a, **kw):
        drawn.append(jax.tree.map(np.asarray, real_init(*a, **kw)))
        return drawn[-1]
    monkeypatch.setattr(j_trainer, "init_state", record)
    monkeypatch.setattr(
        t_trainer, "init_state",
        lambda cfg, ccfg, generator=None, device=None: state_from_jax(
            drawn[0], cfg, device=device))
    args = ["--quick", "--steps", "2", "--checkpoint-dir"]
    with jax_config(jax_threefry_partitionable=True):
        want = run_script("train_admm_lm", args + [str(tmp_path / "ref")],
                          monkeypatch, capsys)
    got = run_script("train_admm_lm_torch",
                     args + [str(tmp_path / "port"), "--device", "cpu"],
                     monkeypatch, capsys)
    assert len(drawn) == 1 and got.count("round ") == 2
    strip = [line.rsplit(" [", 1)[0] for line in got.splitlines()]
    want_strip = [line.rsplit(" [", 1)[0] for line in want.splitlines()]
    assert strip[0] == want_strip[0].replace(
        "repro.launch", "repro_torch.launch").replace(
        "/tmp/repro_admm_ck", "/tmp/repro_torch_admm_ck")
    assert strip[1:] == want_strip[1:]
    assert (tmp_path / "port" / "step_00000002").is_dir()


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14's plan
# ---------------------------------------------------------------------------


def _smoke():
    from test_torch_slice import _chip_smoke
    return _chip_smoke()


def _reference_config(fields, W):
    """A regime of the smoke's TWIN_REGIMES built with the reference's
    config classes, field names as they are."""
    from repro.runtime import (AutoscaleConfig, PoolConfig, ProviderConfig,
                               SchedulerConfig)
    fields = dict(fields)
    W = fields.pop("n_workers", W)
    pool = dict(fields.pop("pool", {}))
    if "provider" in pool:
        pool["provider"] = ProviderConfig(**pool["provider"])
    if "autoscale" in fields:
        fields["autoscale"] = AutoscaleConfig(**fields["autoscale"])
    return SchedulerConfig(n_workers=W, engine="batched", kernel="xla",
                           admm=j_admm.AdmmOptions(max_iters=40),
                           pool=PoolConfig(**pool), **fields)


def test_chip_smoke_twin_regimes_match_the_references_names():
    """Phase 14b's regimes are the examples' (elastic_faults.py,
    cost_aware.py) at W=64 on the paper's instance: every field exists in
    both packages' configs and holds the same value, but the kernel."""
    from repro_torch import runtime as t_rt
    smoke = _smoke()
    assert smoke.TWIN_W == 64 and smoke.TWIN_ASYNC_UPDATES * 4 == 64
    assert set(smoke.TWIN_REGIMES) >= {
        "sync + failures/lifetimes", "replicated r=2 (coded)",
        "async S=4, tau=4", "checkpoint at round 2"}
    drives = set()
    for name, (drive, fields) in smoke.TWIN_REGIMES.items():
        drives.add(drive)
        got = dataclasses.asdict(smoke.twin_config(
            t_rt, t_admm.AdmmOptions, fields, "cuda"))
        want = dataclasses.asdict(_reference_config(fields, smoke.TWIN_W))
        assert got.pop("kernel") == "cuda" and want.pop("kernel") == "xla"
        assert got == want, name
    assert drives == {"rounds", "async", "rescale", "checkpoint"}
    modes = {f.get("mode", "sync") for _, f in smoke.TWIN_REGIMES.values()}
    assert modes == {"sync", "replicated", "async_"}
    auto = smoke.TWIN_REGIMES["warm + autoscale(eff) 32..64"][1]["autoscale"]
    assert (auto["policy"], auto["min_workers"], auto["max_workers"]) == (
        "target_efficiency", 32, 64)


@pytest.mark.parametrize("fail_rate", [None, 0.0])
def test_chip_smoke_lifetime_makes_a_respawn(fail_rate):
    """The sync regime's lifetime respawns workers within phase 14b's
    rounds: a reduced run on the CPU (W=2 workers of the paper's 9 375 rows
    each, d = 10 000, the reference's rows carried across) respawns, with
    the regime's failure rate and without it (the lifetime alone)."""
    from repro_torch import api as t_api
    from repro_torch import runtime as t_rt
    smoke = _smoke()
    drive, fields = smoke.TWIN_REGIMES["sync + failures/lifetimes"]
    assert drive == "rounds" and fields["pool"]["fail_rate_per_round"] > 0
    if fail_rate is not None:
        fields = dict(fields, pool=dict(fields["pool"],
                                        fail_rate_per_round=fail_rate))
    W = 2
    kw = dict(smoke.PAPER_KW, n_samples=W * 9375)
    with jax_config(jax_threefry_partitionable=True):
        ref = j_problems.make("logreg", **kw)
        shards = {(w, W): tuple(np.asarray(a) for a in ref._shard(w, W))
                  for w in range(W)}
    problem = t_problems.make("logreg", device="cpu", **kw)
    t_problems.carry_shards(problem, shards)
    scfg = dataclasses.replace(smoke.twin_config(
        t_rt, t_admm.AdmmOptions, fields, "torch"), n_workers=W)
    res = t_api.run(t_api.ExperimentSpec(
        problem="logreg", problem_kwargs=kw, scheduler=scfg,
        max_rounds=smoke.TWIN_ROUNDS), problem=problem)
    assert len(res.trace) == smoke.TWIN_ROUNDS
    assert res.n_respawns >= 1


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    twin = load(f"{name}_torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        if name in FIRST_ORDER:
            twin.main()
        else:
            twin.main(["--quick"] if name == "train_admm_lm" else [])


def test_each_example_has_a_twin():
    refs = {p.stem for p in EXAMPLES.glob("*.py")
            if not p.stem.endswith("_torch")}
    twins = {p.stem[:-len("_torch")] for p in EXAMPLES.glob("*_torch.py")}
    assert refs == twins == set(TWINS)
