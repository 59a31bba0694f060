"""The port's checkpoint store against the JAX package's, on the CPU.

The two packages share one on-disk format, so each restores what the
other wrote, bit for bit and bfloat16 leaves included: a small mixed tree
and a whole training state (the trainer's ``ConsensusState`` and the
baseline's ``(params, opt)`` pair, bfloat16 parameters).  Then the
reference's own checks (tests/test_checkpoint.py) on the port's store:
roundtrip, latest step, corruption, structure mismatch, rotation, async
save and the atomic rename.
"""
import gc
import json
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro import checkpoint as j_ck                          # noqa: E402
from repro import configs as j_configs                        # noqa: E402
from repro.core import trainer as j_trainer                   # noqa: E402
from repro.models import model as j_model                     # noqa: E402
from repro.optim import optimizers as j_opt                   # noqa: E402
from repro_torch import checkpoint as t_ck                    # noqa: E402
from repro_torch import configs as t_configs                  # noqa: E402
from repro_torch.core import trainer as t_trainer             # noqa: E402
from repro_torch.models.convert import (                      # noqa: E402
    sgd_state_from_jax, state_from_jax)
from repro_torch.tree import (                                # noqa: E402
    describe, flatten, leaves, tree_map)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax_state(seed=0):
    k = jax.random.PRNGKey(seed)
    return {
        "params": {"w": jax.random.normal(k, (8, 8)),
                   "b": jax.random.normal(k, (8,)).astype(jnp.bfloat16)},
        "step": jnp.int32(7),
        "nested": [jnp.arange(4), {"deep": jnp.ones((2, 2))}],
    }


def _state(seed=0):
    return jax.tree.map(_to_torch, _jax_state(seed))


def _same(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _bits(x) -> np.ndarray:
    """Raw bytes of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _same_bits(port_tree, jax_tree):
    lp, lj = leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(lp) == len(lj)
    for i, (p, j) in enumerate(zip(lp, lj)):
        assert tuple(p.shape) == np.shape(j), i
        assert str(p.dtype).split(".")[-1] == np.asarray(j).dtype.name, i
        assert _bits(p) == _bits(j), f"leaf {i}"


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def test_tree_helpers_free_their_leaves_without_the_cycle_collector():
    """A tensor that only flatten, leaves or tree_map saw is freed as soon
    as its last reference goes, with the cyclic collector off."""
    refs = []

    def made():
        t = torch.ones(3)
        refs.append(weakref.ref(t))
        return t
    gc.disable()
    try:
        ls, build = flatten({"a": made(), "b": [made(), (made(), None)]})
        tree_map(lambda t: t + 1, {"a": made(), "b": [made()]})
        leaves({"c": made()})
        del ls, build
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


def test_tree_flatten_order_is_jax_order():
    js = _jax_state()
    jl = jax.tree_util.tree_leaves(js)
    tl, build = flatten(_state())
    _same_bits(build(tl), js)
    assert len(tl) == len(jl) == 5
    assert describe(_state()).startswith("{'nested': [*, {'deep': *}]")


def test_port_written_restored_by_the_reference(tmp_path):
    t_ck.save(_state(), tmp_path, 3, {"note": "x"})
    restored, meta = j_ck.restore(_jax_state(), tmp_path)
    assert meta == {"note": "x"}
    _same_bits(_state(), restored)
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    assert manifest["dtypes"] == ["int32", "float32", "bfloat16", "float32",
                                  "int32"]


def test_reference_written_restored_by_the_port(tmp_path):
    j_ck.save(_jax_state(), tmp_path, 4, {"note": "y"})
    restored, meta = t_ck.restore(_state(), tmp_path)
    assert meta == {"note": "y"}
    _same_bits(restored, _jax_state())


def _training_states():
    jcfg = j_configs.reduced(j_configs.get_config("granite_8b"),
                             dtype="bfloat16")
    tcfg = t_configs.reduced(t_configs.get_config("granite_8b"),
                             dtype="bfloat16")
    ccfg = j_trainer.ConsensusConfig(n_workers=2)
    js = jax.tree.map(np.asarray, j_trainer.init_state(
        jax.random.PRNGKey(5), jcfg, ccfg))
    # make every leaf distinct from its initial value
    rng = np.random.RandomState(0)
    js = jax.tree.map(lambda a: (a + rng.rand(*np.shape(a))).astype(a.dtype)
                      if a.dtype.name in ("float32", "bfloat16")
                      else (a + 3).astype(a.dtype), js)
    js = js._replace(r_norm=np.float32(0.25), s_norm=np.float32(0.5))
    jp = jax.tree.map(np.asarray, j_model.init_params(jax.random.PRNGKey(6),
                                                      jcfg))
    jopt = jax.tree.map(np.asarray, j_opt.adamw_init(jp))
    return (js, state_from_jax(js, tcfg, device="cpu"), (jp, jopt),
            sgd_state_from_jax((jp, jopt), tcfg, device="cpu"))


@pytest.mark.parametrize("which", ["admm", "sgd"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_training_state_round_trips_across_packages(which, writer, tmp_path):
    js, ts, jpair, tpair = _training_states()
    j_tree, t_tree = (js, ts) if which == "admm" else (jpair, tpair)
    _same_bits(t_tree, j_tree)
    if writer == "port":
        t_ck.save(t_tree, tmp_path, 2, {"step": 2, "mode": which})
        restored, meta = j_ck.restore(j_tree, tmp_path)
        _same_bits(t_tree, restored)
    else:
        j_ck.save(j_tree, tmp_path, 2, {"step": 2, "mode": which})
        zeros = jax.tree.map(torch.zeros_like, t_tree)
        restored, meta = t_ck.restore(zeros, tmp_path)
        _same_bits(restored, j_tree)
        if which == "admm":
            assert type(restored) is t_trainer.ConsensusState
    assert meta == {"step": 2, "mode": which}


# ---------------------------------------------------------------------------
# the reference's checks, on the port's store
# ---------------------------------------------------------------------------


def test_roundtrip_identity(tmp_path):
    s = _state()
    t_ck.save(s, tmp_path, 3, {"note": "x"})
    restored, meta = t_ck.restore(s, tmp_path)
    assert _same(s, restored)
    assert meta == {"note": "x"}


def test_latest_step_and_multiple(tmp_path):
    s = _state()
    assert t_ck.latest_step(tmp_path / "missing") is None
    for step in (1, 5, 3):
        t_ck.save(s, tmp_path, step)
    assert t_ck.latest_step(tmp_path) == 5
    t_ck.restore(s, tmp_path, step=3)
    with pytest.raises(FileNotFoundError):
        t_ck.restore(s, tmp_path / "empty")


def test_corruption_detected(tmp_path):
    s = _state()
    path = t_ck.save(s, tmp_path, 1)
    f = path / "arrays.npz"
    data = bytearray(f.read_bytes())
    data[len(data) // 2] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(Exception):
        t_ck.restore(s, tmp_path)


def test_corrupt_leaf_fails_its_hash(tmp_path):
    s = _state()
    path = t_ck.save(s, tmp_path, 1)
    with np.load(path / "arrays.npz") as npz:
        arrays = dict(npz)
    arrays["leaf_1"] = arrays["leaf_1"] + 1
    np.savez(path / "arrays.npz", **arrays)
    with pytest.raises(IOError, match="leaf 1 hash"):
        t_ck.restore(s, tmp_path)


def test_structure_mismatch_raises(tmp_path):
    t_ck.save(_state(), tmp_path, 1)
    with pytest.raises(ValueError):
        t_ck.restore({"just_one": torch.zeros(3)}, tmp_path)
    bad = _state()
    bad["params"]["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        t_ck.restore(bad, tmp_path)


def test_rotation(tmp_path):
    mgr = t_ck.CheckpointManager(tmp_path, keep_last=2)
    s = _state()
    for step in range(5):
        mgr.save(s, step)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [3, 4]


def test_async_save(tmp_path):
    mgr = t_ck.CheckpointManager(tmp_path, async_save=True)
    s = _state()
    mgr.save(s, 1)
    s["params"]["w"] += 1.0            # the snapshot was taken at save()
    mgr.wait()
    restored, _ = mgr.restore_latest(s)
    assert _same(_state(), restored)


def test_async_save_error_surfaces_in_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = t_ck.CheckpointManager(blocker, async_save=True)
    mgr.save(_state(), 1)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                         # reported once


def test_atomicity_tmpdir_never_visible(tmp_path):
    t_ck.save(_state(), tmp_path, 9)
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
