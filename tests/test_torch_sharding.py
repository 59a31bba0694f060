"""The port's sharding rules against the JAX package's, on the CPU.

For every arch and both production meshes, the port's parameter (with and
without FSDP), ZeRO-1, stacked (ADMM worker), cache, batch and activation
specs equal the reference's leaf for leaf; the reference's side is built
on JAX ``AbstractMesh``es, the port's on ``MeshShape``s, so neither needs a
device.  Then every port spec divides its leaf, ``to_placements`` gives each
rank of a fake 512-rank group the chunk JAX's major-to-minor order gives
it, and the dry-run runs a reduced model's cells at (16, 16) in a process
of its own.  Exact comparisons throughout: specs are names, not numbers.
"""
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from jax.sharding import AbstractMesh as JMesh                # noqa: E402

from repro import configs as j_configs                        # noqa: E402
from repro.launch import steps as j_steps                     # noqa: E402
from repro.models import model as j_model                     # noqa: E402
from repro.parallel import sharding as j_sh                   # noqa: E402
from repro_torch import configs as t_configs                  # noqa: E402
from repro_torch.launch import mesh as t_mesh                 # noqa: E402
from repro_torch.launch import steps as t_steps               # noqa: E402
from repro_torch.models import model as t_model               # noqa: E402
from repro_torch.parallel import sharding as t_sh             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {
    "pod": (JMesh((16, 16), ("data", "model")),
            t_sh.MeshShape(("data", "model"), (16, 16))),
    "multipod": (JMesh((2, 16, 16), ("pod", "data", "model")),
                 t_sh.MeshShape(("pod", "data", "model"), (2, 16, 16))),
}


def _j_flat(spec_tree):
    """{keystr: spec tuple} of a JAX PartitionSpec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]
    return {jax.tree_util.keystr(k): tuple(v) for k, v in flat}


def _t_flat(spec_tree, path=""):
    """The port's ``P`` tree in the same key format."""
    if isinstance(spec_tree, dict):
        out = {}
        for k, v in spec_tree.items():
            out.update(_t_flat(v, f"{path}[{k!r}]"))
        return out
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        out = {}
        for f, v in zip(spec_tree._fields, spec_tree):
            out.update(_t_flat(v, f"{path}.{f}"))
        return out
    assert isinstance(spec_tree, t_sh.P), (path, spec_tree)
    return {path: tuple(spec_tree)}


def _same(got, want, what):
    g, w = _t_flat(got), _j_flat(want)
    assert sorted(g) == sorted(w), what
    bad = {k: (g[k], w[k]) for k in w if g[k] != w[k]}
    assert not bad, f"{what}: {bad}"


def _cfgs(arch):
    return j_configs.get_config(arch), t_configs.get_config(arch)


def _j_params(cfg):
    return jax.eval_shape(functools.partial(j_model.init_params, cfg=cfg),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_specs_equal_the_reference(arch, mesh):
    """Parameters (fsdp off and on), ZeRO-1, the stacked worker state,
    every applicable cache, the batch and the activation rules."""
    jm, tm = MESHES[mesh]
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _j_params(jcfg), t_model.param_specs(tcfg)
    for fsdp in (False, True):
        _same(t_sh.param_spec_tree(tcfg, tp, tm, fsdp=fsdp),
              j_sh.param_spec_tree(jcfg, jp, jm, fsdp=fsdp),
              f"params fsdp={fsdp}")
    _same(t_sh.zero1_spec_tree(tcfg, tp, tm),
          j_sh.zero1_spec_tree(jcfg, jp, jm), "zero1")
    waxes = j_steps.admm_worker_axes(jcfg, jm)
    assert t_steps.admm_worker_axes(tcfg, tm) == waxes
    if waxes is not None:
        inner_t = t_sh.param_spec_tree(tcfg, tp, tm, worker_axes=waxes)
        inner_j = j_sh.param_spec_tree(jcfg, jp, jm, worker_axes=waxes)
        _same(inner_t, inner_j, "inner")
        _same(t_sh.stacked_spec_tree(inner_t, waxes),
              j_sh.stacked_spec_tree(inner_j, waxes), "stacked")
        _same(t_sh.zero1_spec_tree(tcfg, tp, tm, worker_axes=waxes),
              j_sh.zero1_spec_tree(jcfg, jp, jm, worker_axes=waxes),
              "zero1 beside the workers")
    for jshape, tshape in zip(j_configs.LM_SHAPES, t_configs.LM_SHAPES):
        if not j_configs.cell_is_applicable(jcfg, jshape)[0]:
            continue
        jin = j_configs.input_specs(jcfg, jshape)
        tin = t_configs.input_specs(tcfg, tshape)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tin.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in jin.items()}, tshape.name
        _same(t_sh.batch_spec_tree(tin, tm), j_sh.batch_spec_tree(jin, jm),
              f"batch {tshape.name}")
        if tshape.kind == "train":
            continue
        jc = j_model.init_cache(jcfg, jshape.global_batch, jshape.seq_len,
                                abstract=True)
        tc = t_model.init_cache(tcfg, tshape.global_batch, tshape.seq_len,
                                abstract=True)
        assert {k: tuple(v.shape) for k, v in tc.items()} == {
            k: v.shape for k, v in jc.items()}
        assert all(v.device.type == "meta" for v in tc.values())
        _same(t_sh.cache_spec_tree(tcfg, tc, tm),
              j_sh.cache_spec_tree(jcfg, jc, jm), f"cache {tshape.name}")
    for gb in (1, 256, None):
        got = t_sh.activation_rules(tcfg, tm, gb)
        want = j_sh.activation_rules(jcfg, jm, gb)
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}, gb


def _divides(spec_tree, shape_tree, mesh, what):
    sizes = mesh.shape

    def one(path, spec, leaf):
        assert len(spec) == leaf.dim(), (what, path, spec, leaf.shape)
        for i, part in enumerate(spec):
            if part is None:
                continue
            axes = part if isinstance(part, tuple) else (part,)
            n = math.prod(sizes[a] for a in axes)
            assert leaf.shape[i] % n == 0, (what, path, i, leaf.shape, spec)
    t_sh.map_with_path(one, spec_tree, shape_tree)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_every_port_spec_divides_its_leaf(arch, mesh):
    tm = MESHES[mesh][1]
    cfg = t_configs.get_config(arch)
    params = t_model.param_specs(cfg)
    for fsdp in (False, True):
        _divides(t_sh.param_spec_tree(cfg, params, tm, fsdp=fsdp), params, tm,
                 f"params fsdp={fsdp}")
    _divides(t_sh.zero1_spec_tree(cfg, params, tm), params, tm, "zero1")
    for shape in t_configs.LM_SHAPES:
        if not t_configs.cell_is_applicable(cfg, shape)[0]:
            continue
        ins = t_configs.input_specs(cfg, shape)
        _divides(t_sh.batch_spec_tree(ins, tm), ins, tm, shape.name)
        if shape.kind != "train":
            cache = t_model.init_cache(cfg, shape.global_batch, shape.seq_len,
                                       abstract=True)
            _divides(t_sh.cache_spec_tree(cfg, cache, tm), cache, tm,
                     f"cache {shape.name}")


def test_role_classification_and_rules_guard():
    cfg = t_configs.get_config("granite_8b")
    tm = MESHES["pod"][1]
    specs = t_sh.param_spec_tree(cfg, t_model.param_specs(cfg), tm)
    assert specs["blocks"]["attn"]["wq"]["w"][-1] == "model"     # column
    assert specs["blocks"]["attn"]["wo"]["w"][-2] == "model"     # row
    assert specs["head"][0] == "model" and specs["embed"][1] == "model"
    assert t_sh.activation_rules(cfg, tm, 1)["btd"][0] is None
    assert t_sh.activation_rules(cfg, tm, 256)["btd"][0] == "data"
    assert t_sh.dp_axes(MESHES["multipod"][1]) == ("pod", "data")
    assert t_sh.dp_size(MESHES["multipod"][1]) == 32
    assert t_mesh.make_production_mesh() == tm     # no group of 256 here


# ---------------------------------------------------------------------------
# placements on a fake 512-rank group
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_group_512():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("rank", [0, 1, 17, 255, 256, 300, 511])
def test_to_placements_gives_jax_major_to_minor_chunks(fake_group_512,
                                                       rank):
    """Rank (p, d, m) of the (2, 16, 16) mesh holds, of a tensor split
    P(("pod", "data"), None, "model"), rows chunk p * 16 + d and columns
    chunk m: JAX's device order for that spec."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = DeviceMesh("cpu", torch.arange(512).reshape(2, 16, 16),
                      mesh_dim_names=("pod", "data", "model"),
                      _init_backend=False, _rank=rank)
    spec = t_sh.P(("pod", "data"), None, "model")
    assert t_sh.to_placements(mesh, spec) == (Shard(0), Shard(0), Shard(2))
    assert t_sh.to_placements(mesh, t_sh.P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    x = torch.arange(64 * 3 * 32).reshape(64, 3, 32)
    local = distribute_tensor(x, mesh, t_sh.to_placements(mesh, spec),
                              src_data_rank=None).to_local()
    p, d, m = rank // 256, (rank // 16) % 16, rank % 16
    row = p * 16 + d
    np.testing.assert_array_equal(
        local.numpy(), x[2 * row:2 * row + 2, :, 2 * m:2 * m + 2].numpy())
    with pytest.raises(ValueError, match="mesh's order"):
        t_sh.to_placements(mesh, t_sh.P(("data", "pod"), None, None))
    with pytest.raises(ValueError, match="not in the mesh"):
        t_sh.to_placements(mesh, t_sh.P("expert"))


# ---------------------------------------------------------------------------
# the dry-run, in a process of its own
# ---------------------------------------------------------------------------

DRYRUN = """
import json, sys
from repro_torch import configs
from repro_torch.launch import dryrun
dryrun.start_fake_group(256)
cfg = configs.reduced(configs.get_config("granite_8b"))
out = []
for shape, mode in (("train_4k", "sgd"), ("train_4k", "admm"),
                    ("decode_32k", "decode")):
    r = dryrun.run_cell("granite_8b", shape, "pod", mode, cfg=cfg,
                        save=False, verbose=False)
    out.append({k: r.get(k) for k in ("mode", "status", "error",
                                        "summary", "fits_hbm")})
print(json.dumps(out))
"""


def test_dryrun_reduced_granite_at_16x16_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", DRYRUN], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    cells = json.loads(res.stdout.strip().splitlines()[-1])
    for c in cells:
        assert c["status"] == "ok", (c["mode"], c["error"])
        s = c["summary"]
        assert s["flops_per_chip"] > 0 and s["bytes_per_chip"] > 0
        assert s["unknown_trip_loops"] == 0 and c["fits_hbm"]
    by_mode = {c["mode"]: c["summary"] for c in cells}
    # data parallel over 16 ranks: the gradient is reduced, the consensus
    # mean is all-reduced over the workers
    assert by_mode["sgd"]["n_collective_ops"] > 0
    assert by_mode["admm"]["by_type"].get("all-reduce", 0) > 0
