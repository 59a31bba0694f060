"""The port's serving slice against the JAX package, on the CPU.

``reduced(granite_8b)`` in float32 with the reference's own parameters
(``repro.models.model.init_params(PRNGKey(0))``) carried across by
``params_from_jax``: ``forward``, ``prefill`` (logits and caches) and eight
greedy ``decode_step``s, with full attention and with a 16-token sliding
window (a ring cache written at prefill), then ``serve.main`` end to end.
Tolerances rtol 1e-4, atol 1e-5: float32 sums in other orders across two
layers.  Also the config registry, the carrying of every leaf and the
no-JAX rule for the new modules (the other families are held in
``test_torch_families.py``).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro import configs as j_configs                        # noqa: E402
from repro.models import layers as j_layers                   # noqa: E402
from repro.models import model as j_model                     # noqa: E402
from repro_torch import configs as t_configs                  # noqa: E402
from repro_torch.kernels import decode_attention as t_dec     # noqa: E402
from repro_torch.kernels import flash_attention as t_fa       # noqa: E402
from repro_torch.launch import serve as t_serve               # noqa: E402
from repro_torch.models import layers as t_layers             # noqa: E402
from repro_torch.models import model as t_model               # noqa: E402
from repro_torch.models.convert import params_from_jax        # noqa: E402
from test_torch_data import _imported_modules                 # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
B, P, STEPS = 2, 24, 8
WINDOWS = [None, 16]


def _cfgs(arch="granite_8b", **kw):
    return (j_configs.reduced(j_configs.get_config(arch), **kw),
            t_configs.reduced(t_configs.get_config(arch), **kw))


def _carried(jcfg, tcfg, seed=0):
    jp = j_model.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")


def _tokens(n, seed=1):
    return np.random.RandomState(seed).randint(0, 128, (B, n)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_config_registry_matches_the_reference(arch):
    jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.hd, tc.padded_vocab, tc.param_count(),
            tc.active_param_count(), tc.subquadratic) == \
        (jc.hd, jc.padded_vocab, jc.param_count(), jc.active_param_count(),
         jc.subquadratic)
    jr, tr = _cfgs(arch)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert t_configs.get_config(arch.replace("_", "-")) == tc


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_rope_and_norm_match_the_reference(theta):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 4, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    pos = np.asarray([[0, 7, 100, 2047, 40000]] * 3, np.int32)
    np.testing.assert_allclose(
        t_layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                            theta).numpy(),
        np.asarray(j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       theta)), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(
        t_layers.rms_norm(torch.as_tensor(x), torch.as_tensor(w)).numpy(),
        np.asarray(j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# carrying the parameters across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", [
    ("granite_8b", {}),
    ("qwen2_7b", {}),                          # qkv biases
    ("stablelm_3b", dict(tie_embeddings=True)),
])
def test_params_from_jax_carries_every_leaf(arch, kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _carried(jcfg, tcfg)
    jflat = {jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, val in node.items():
                walk(val, path + f"[{key!r}]")
        else:
            tflat[path] = node
    walk(tp, "")
    assert sorted(tflat) == sorted(jflat)
    for path, arr in jflat.items():
        assert tflat[path].dtype == torch.float32
        np.testing.assert_array_equal(tflat[path].numpy(), arr)
    assert ("head" in tp) == (not tcfg.tie_embeddings)


def test_params_from_jax_refuses_unknown_and_misshapen_leaves():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray,
                        j_model.init_params(jax.random.PRNGKey(0), jcfg))
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(bad, tcfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(missing, tcfg, device="cpu")
    blocks = dict(tree["blocks"], ln1=tree["blocks"]["ln1"][:1])
    with pytest.raises(ValueError, match="ln1"):
        params_from_jax(dict(tree, blocks=blocks), tcfg, device="cpu")


# ---------------------------------------------------------------------------
# the slice: forward, prefill, greedy decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", WINDOWS)
def test_forward_matches_jax(window):
    jcfg, tcfg = _cfgs(sliding_window=window)
    jp, tp = _carried(jcfg, tcfg)
    toks = _tokens(P)
    want, _ = j_model.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              remat=False)
    got, aux = t_model.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("window", WINDOWS)
def test_prefill_and_greedy_decode_match_jax(window):
    """Prefill (logits and caches), then 8 greedy decode steps fed the
    reference's tokens: logits per step, and the same argmax."""
    jcfg, tcfg = _cfgs(sliding_window=window)
    jp, tp = _carried(jcfg, tcfg)
    toks = _tokens(P)
    jcache = j_model.init_cache(jcfg, B, P + STEPS)
    tcache = t_model.init_cache(tcfg, B, P + STEPS, device="cpu")
    assert tcache["k"].shape == jcache["k"].shape
    j_prefill = jax.jit(lambda p, b, c: j_model.prefill(p, jcfg, b, c))
    j_decode = jax.jit(lambda p, b, c: j_model.decode_step(p, jcfg, b, c))

    jl, jcache = j_prefill(jp, {"tokens": jnp.asarray(toks)}, jcache)
    tl, out = t_model.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)},
                              tcache)
    assert out is tcache                       # filled in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)

    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1))
    for i in range(STEPS):
        pos = np.full((B,), P + i, np.int32)
        jl, jcache = j_decode(jp, {"tokens": jnp.asarray(nxt[:, None]),
                                   "positions": jnp.asarray(pos)}, jcache)
        tl, _ = t_model.decode_step(
            tp, tcfg, {"tokens": torch.as_tensor(nxt[:, None]),
                       "positions": torch.as_tensor(pos)}, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        nxt = np.array(jnp.argmax(jl[:, 0], axis=-1))
        np.testing.assert_array_equal(tl[:, 0].argmax(-1).numpy(), nxt)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_serve_main_returns_the_reference_greedy_tokens():
    jcfg, tcfg = _cfgs()
    jp, tp = _carried(jcfg, tcfg)
    t_fa.reset_launches()
    t_dec.reset_launches()
    gen = 6
    got = t_serve.main(["--arch", "granite_8b", "--device", "cpu",
                        "--batch", str(B), "--prompt-len", str(P),
                        "--gen-len", str(gen)], params=tp)
    prompt = t_serve.synthetic_prompt(tcfg, B, P, 0, torch.device("cpu"))
    cache = j_model.init_cache(jcfg, B, P + gen)
    logits, cache = jax.jit(lambda p, b, c: j_model.prefill(
        p, jcfg, b, c, last_only=True))(
            jp, {"tokens": jnp.asarray(prompt["tokens"].numpy())}, cache)
    decode = jax.jit(lambda p, b, c: j_model.decode_step(p, jcfg, b, c))
    toks = [jnp.argmax(logits[:, -1], axis=-1)]
    for i in range(gen - 1):
        logits, cache = decode(jp, {"tokens": toks[-1][:, None],
                                    "positions": jnp.full((B,), P + i,
                                                          jnp.int32)}, cache)
        toks.append(jnp.argmax(logits[:, -1], axis=-1))
    np.testing.assert_array_equal(got.numpy(), np.stack(toks, axis=1))
    assert got.shape == (B, gen) and got.device.type == "cpu"
    # the CPU run went through the plain versions, not the kernels
    assert t_fa.LAUNCHES["flash_attention"] == 0
    assert t_dec.LAUNCHES["decode_attention"] == 0


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.main(["--arch", "granite_8b"])
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_model.init_cache(tcfg, 1, 4)


def test_init_params_draws_the_reference_tree():
    _, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    tp = t_model.init_params(tcfg, generator=gen, device="cpu")
    shapes = t_model.param_shapes(tcfg)

    def walk(node, spec):
        if isinstance(spec, dict):
            assert sorted(node) == sorted(spec)
            for k in spec:
                walk(node[k], spec[k])
        else:
            assert tuple(node.shape) == spec and node.dtype == torch.float32
    walk(tp, shapes)
    w = tp["blocks"]["mlp"]["w_up"]["w"]
    assert w[0].std().item() == pytest.approx(tcfg.d_model ** -0.5, rel=0.1)
    assert not torch.equal(w[0], w[1])         # layers drawn one by one
    assert torch.equal(tp["blocks"]["ln1"], torch.ones_like(
        tp["blocks"]["ln1"]))


# ---------------------------------------------------------------------------
# the no-JAX rule, for the slice's modules
# ---------------------------------------------------------------------------

SLICE_MODULES = [
    "configs/__init__.py", "configs/base.py", "configs/granite_8b.py",
    "models/layers.py", "models/attention.py", "models/model.py",
    # the other families
    "models/moe.py", "models/ssm.py", "configs/granite_moe_3b_a800m.py",
    "configs/mixtral_8x7b.py", "configs/musicgen_large.py",
    "configs/llama3_2_vision_90b.py", "configs/zamba2_1_2b.py",
    "configs/rwkv6_1_6b.py",
    "models/convert.py", "launch/serve.py", "kernels/flash_attention.py",
    "kernels/decode_attention.py", "kernels/ops.py", "kernels/ref.py",
    # the training slice
    "tree.py", "device.py", "optim/optimizers.py", "optim/schedules.py",
    "data/lm.py", "core/trainer.py", "checkpoint/__init__.py",
    "checkpoint/store.py", "launch/train.py",
]


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_module_imports_no_jax(rel):
    path = ROOT / "src" / "repro_torch" / rel
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{rel} imports {bad}"


def test_serving_slice_loads_without_jax():
    """Importing the slice (every arch config, the model, the kernels'
    wrappers and the server) pulls in no JAX module."""
    code = ("import sys\n"
            "from repro_torch import configs\n"
            "from repro_torch.launch import serve\n"
            "from repro_torch.models import convert, model\n"
            "[configs.get_config(a) for a in configs.ARCH_IDS]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT)
