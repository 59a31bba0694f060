"""The port's other LM families (moe, audio, vlm, hybrid, ssm) against the
JAX package's, on the CPU.

For each reduced config (float32) the reference's own parameters
(``repro.models.model.init_params``) are carried across by
``params_from_jax`` after every leaf the reference initialises to zeros
(the VLM's tanh gates, RWKV6's decay ``lora_b``, biases) is replaced by
drawn values: at zero those leaves would hide a broken cross-attention or
decay path.  Then ``forward``, ``loss_fn`` (value, aux and every gradient
leaf), ``prefill`` with three greedy ``decode_step``s (logits and caches),
and ``serve.main`` against the reference's ``serve.main`` on one prompt.
Tolerances: logits rtol 1e-4, atol 1e-5 (float32 sums in other orders
over a few layers and the chunked scans); a gradient within 1e-5 of its
leaf's largest entry; greedy tokens equal.  Also the parameter trees and
dtypes (float32 leaves in a bf16 model) and ``cross_attention``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro import configs as j_configs                        # noqa: E402
from repro.launch import serve as j_serve                     # noqa: E402
from repro.models import attention as j_attention             # noqa: E402
from repro.models import model as j_model                     # noqa: E402
from repro_torch import configs as t_configs                  # noqa: E402
from repro_torch.kernels import decode_attention as t_dec     # noqa: E402
from repro_torch.kernels import flash_attention as t_fa       # noqa: E402
from repro_torch.launch import serve as t_serve               # noqa: E402
from repro_torch.models import attention as t_attention       # noqa: E402
from repro_torch.models import model as t_model              # noqa: E402
from repro_torch.models.convert import params_from_jax        # noqa: E402
from repro_torch.tree import flatten, leaves                  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-5
B, P, STEPS = 2, 40, 3

# (arch, overrides of ``reduced``): each family; zamba2 also with a tail
# of one mamba block after its groups
CASES = [("granite_moe_3b_a800m", {}), ("mixtral_8x7b", {}),
         ("musicgen_large", {}), ("llama3_2_vision_90b", {}),
         ("zamba2_1_2b", {}), ("zamba2_1_2b", dict(n_layers=5)),
         ("rwkv6_1_6b", {})]
IDS = [a + ("_tail" if kw else "") for a, kw in CASES]
JAX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(arch, **kw):
    return (j_configs.reduced(j_configs.get_config(arch), **kw),
            t_configs.reduced(t_configs.get_config(arch), **kw))


def nonzero(tree, seed=0):
    """The reference's parameters as numpy, with every all-zero leaf drawn
    anew (normal, std 0.5)."""
    rng = np.random.RandomState(seed)

    def fill(a):
        a = np.asarray(a)
        if a.size and not a.any():
            return (0.5 * rng.randn(*a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(fill, tree)


def _carried(jcfg, tcfg, seed=0):
    jp = nonzero(j_model.init_params(jax.random.PRNGKey(seed), jcfg))
    return jax.tree.map(jnp.asarray, jp), params_from_jax(jp, tcfg,
                                                          device="cpu")


def _batch(cfg, S, seed=1, labels=False):
    """Numpy inputs: tokens or frame embeddings, the VLM's image
    embeddings, labels."""
    rng = np.random.RandomState(seed)
    out = {}
    if cfg.family == "audio":
        out["embeds"] = (0.02 * rng.randn(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.randint(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.family == "vlm":
        out["img_embeds"] = (0.02 * rng.randn(
            B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if labels:
        out["labels"] = rng.randint(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}[{k!r}]")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_init_params_draws_the_reference_tree(arch, kw):
    """The port's tree, its shapes and its dtypes are the reference's, in
    bf16 (where the mamba and rwkv leaves stay float32)."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16", **kw)
    want = jax.eval_shape(lambda: j_model.init_params(
        jax.random.PRNGKey(0), jcfg))
    wflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    got = t_model.init_params(tcfg, generator=torch.Generator(), device="cpu")
    gflat = dict(_walk(got))
    assert sorted(gflat) == sorted(wflat)
    specs = dict(_walk(t_model.param_specs(tcfg)))
    for path, w in wflat.items():
        want_dtype = JAX_DTYPES[str(w.dtype)]
        for t in (gflat[path], specs[path]):
            assert (tuple(t.shape), t.dtype) == (w.shape, want_dtype), path
    assert any(t.dtype == torch.float32 for t in gflat.values()) == (
        tcfg.family in ("hybrid", "ssm"))


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_params_from_jax_keeps_the_float32_leaves_of_a_bf16_model(arch, kw):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16", **kw)
    jp = nonzero(j_model.init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_jax(jp, tcfg, device="cpu")
    jflat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    for path, t in _walk(tp):
        j = jflat.pop(path)
        assert t.dtype == JAX_DTYPES[str(j.dtype)], path
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32), err_msg=path)
    assert not jflat
    with pytest.raises(ValueError, match=f"{tcfg.family} family"):
        params_from_jax(dict(jp, extra=np.zeros(2)), tcfg, device="cpu")


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_forward_matches_jax(arch, kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _carried(jcfg, tcfg)
    batch = _batch(jcfg, P)
    want, want_aux = j_model.forward(jp, jcfg, _jb(batch), remat=False)
    with torch.no_grad():
        got, aux = t_model.forward(tp, tcfg, _tb(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert (float(aux) > 0) == (tcfg.family == "moe")


def _loss_grads(params, cfg, batch, remat):
    ps, build = flatten(params)
    req = [p.detach().requires_grad_() for p in ps]
    loss, parts = t_model.loss_fn(build(req), cfg, batch, remat=remat)
    # the audio model never reads its embedding table: no gradient
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, [
        torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_loss_fn_value_aux_and_gradients_match_jax(arch, kw):
    """The loss, its ce and aux parts, and the gradient of every leaf,
    with remat (the reference's default) and without it (bit for bit the
    same)."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _carried(jcfg, tcfg)
    batch = _batch(jcfg, P, labels=True)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: j_model.loss_fn(p, jcfg, _jb(batch)), has_aux=True)(jp)
    loss, parts, grads = _loss_grads(tp, tcfg, _tb(batch), remat=True)
    _, _, grads2 = _loss_grads(tp, tcfg, _tb(batch), remat=False)
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    for k in ("ce", "aux"):
        assert float(parts[k]) == pytest.approx(float(jparts[k]), rel=1e-6)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for i, (g, g2, j) in enumerate(zip(grads, grads2, jleaves)):
        assert torch.equal(g, g2), f"leaf {i}: remat changed the gradient"
        j = np.asarray(j)
        assert (np.abs(j).max() > 0) == bool(g.abs().max() > 0), f"leaf {i}"
        np.testing.assert_allclose(g.numpy(), j, rtol=0,
                                   atol=GRAD_RTOL * np.abs(j).max(),
                                   err_msg=f"leaf {i} of {len(jleaves)}")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _step(cfg, params_embed, nxt, pos, batch, lib):
    step = {"positions": lib(np.full((B,), pos, np.int32))}
    if cfg.family == "audio":
        step["embeds"] = lib(params_embed[nxt][:, None, :])
    else:
        step["tokens"] = lib(nxt[:, None].astype(np.int32))
    if cfg.family == "vlm":
        step["img_embeds"] = lib(batch["img_embeds"])
    return step


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_prefill_and_greedy_decode_match_jax(arch, kw):
    """Prefill (logits and every cache leaf), then three greedy decode
    steps fed the reference's tokens: logits per step, the same argmax,
    and the caches after the last step.  mixtral's 32-slot ring wraps at
    the prompt's 40 tokens."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _carried(jcfg, tcfg)
    batch = _batch(jcfg, P)
    jcache = j_model.init_cache(jcfg, B, P + STEPS)
    tcache = t_model.init_cache(tcfg, B, P + STEPS, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    jl, jcache = jax.jit(lambda p, b, c: j_model.prefill(p, jcfg, b, c))(
        jp, _jb(batch), jcache)
    with torch.no_grad():
        tl, out = t_model.prefill(tp, tcfg, _tb(batch), tcache)
    assert out is tcache
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in jcache:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL,
                                   err_msg=name)
    decode = jax.jit(lambda p, b, c: j_model.decode_step(p, jcfg, b, c))
    embed = np.asarray(jp["embed"])
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for i in range(STEPS):
        jl, jcache = decode(jp, _step(jcfg, embed, nxt, P + i, batch,
                                      jnp.asarray), jcache)
        with torch.no_grad():
            tl, _ = t_model.decode_step(
                tp, tcfg, _step(tcfg, embed, nxt, P + i, batch,
                                torch.as_tensor), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        nxt = np.asarray(jnp.argmax(jl[:, 0], axis=-1))
        np.testing.assert_array_equal(tl[:, 0].argmax(-1).numpy(), nxt)
    for name in jcache:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL,
                                   err_msg=name)


def _reference_prompt(cfg, batch, prompt_len, seed):
    """The prompt the reference's ``serve.main`` draws
    (``repro/launch/serve.py``), as numpy."""
    key = jax.random.PRNGKey(seed + 1)
    out = {}
    if cfg.family == "audio":
        out["embeds"] = (jax.random.normal(
            key, (batch, prompt_len, cfg.d_model), jnp.float32) * 0.02
        ).astype(jnp.dtype(cfg.dtype))
    else:
        out["tokens"] = jax.random.randint(key, (batch, prompt_len), 0,
                                           cfg.vocab_size)
    if cfg.family == "vlm":
        out["img_embeds"] = (jax.random.normal(
            jax.random.fold_in(key, 1), (batch, cfg.n_img_tokens,
                                         cfg.d_model), jnp.float32) * 0.02
        ).astype(jnp.dtype(cfg.dtype))
    return {k: np.asarray(v) for k, v in out.items()}


SERVED = [a for a, kw in CASES if not kw]


@pytest.mark.parametrize("arch", SERVED)
def test_serve_main_returns_the_reference_serve_mains_tokens(arch,
                                                             monkeypatch):
    """Both packages' ``serve.main`` on the reference's prompt and
    (nonzero-gated) parameters: the same greedy tokens, and no kernel
    launched on the CPU."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _carried(jcfg, tcfg)
    gen, seed = 5, 0
    argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
            "--gen-len", str(gen), "--seed", str(seed)]
    monkeypatch.setattr(j_model, "init_params", lambda key, cfg: jp)
    want = j_serve.main(argv)
    prompt = _reference_prompt(jcfg, B, P, seed)
    monkeypatch.setattr(t_serve, "synthetic_prompt",
                        lambda cfg, b, n, s, dev: _tb(prompt))
    t_fa.reset_launches()
    t_dec.reset_launches()
    got = t_serve.main(argv + ["--device", "cpu"], params=tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (B, gen)
    assert set(t_fa.LAUNCHES.values()) == {0}
    assert t_dec.LAUNCHES["decode_attention"] == 0


def _prefill_then_decode_gap(prefill, decode, params, cfg, toks, lib):
    """Relative L2 of a decode step after a prefill of all but the last
    token against the last logits of a prefill of all of them."""
    n = toks.shape[1] - 1
    _, cache = prefill(params, cfg, {"tokens": lib(toks[:, :n])}, n + 2)
    got = decode(params, cfg, {"tokens": lib(toks[:, n:]), "positions": lib(
        np.full((B,), n, np.int32))}, cache)[0]
    want, _ = prefill(params, cfg, {"tokens": lib(toks)}, n + 1)
    got, want = np.asarray(got)[:, 0], np.asarray(want)[:, -1]
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_zamba2_prefill_then_decode_gap_is_the_references():
    """zamba2's float32 prefill-then-decode gap comes from the chunked
    SSD, and the reference has it too: after a 256-token prefill (chunks
    of 128) a decode step differs from a 257-token prefill (chunks of 1,
    257 being prime) by the same order in both packages, and by less in
    both at chunk 16.  12 mamba blocks, two shared-attention groups."""
    gaps = {}
    for chunk in (128, 16):
        jcfg, tcfg = _cfgs("zamba2_1_2b", n_layers=12, attn_every=6,
                           d_model=128, ssm_chunk=chunk, ssm_state=16,
                           ssm_head_dim=16, head_dim=32)
        jp, tp = _carried(jcfg, tcfg)
        toks = np.random.RandomState(1).randint(0, 128, (B, 257)).astype(
            np.int32)

        def j_prefill(p, cfg, batch, n):
            return j_model.prefill(p, cfg, batch, j_model.init_cache(
                cfg, B, n))

        def t_prefill(p, cfg, batch, n):
            return t_model.prefill(p, cfg, batch, t_model.init_cache(
                cfg, B, n, device="cpu"))
        with torch.no_grad():
            gaps[chunk] = (
                _prefill_then_decode_gap(j_prefill, j_model.decode_step, jp,
                                         jcfg, toks, jnp.asarray),
                _prefill_then_decode_gap(t_prefill, t_model.decode_step, tp,
                                         tcfg, toks, torch.as_tensor))
    (j128, t128), (j16, t16) = gaps[128], gaps[16]
    assert 0.5 * j128 <= t128 <= 2.0 * j128, gaps
    assert j16 < j128 / 2 and t16 < t128 / 2, gaps
    assert t128 < 1e-4, gaps


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,T,chunk", [(40, 8, 512), (1, 33, 512),
                                        (24, 17, 8), (30, 9, 8)])
def test_cross_attention_matches_jax(Sq, T, chunk):
    """No mask, over query chunks (30 queries do not split into chunks of
    8: one chunk, as in the reference); the flash kernel's causal=False
    plain version (``block_attention``) agrees too."""
    rng = np.random.RandomState(Sq + T)
    q = (2 * rng.randn(2, Sq, 8, 16)).astype(np.float32)
    k, v = (rng.randn(2, T, 2, 16).astype(np.float32) for _ in range(2))
    want = np.asarray(j_attention.cross_attention(
        *map(jnp.asarray, (q, k, v)), chunk_q=chunk))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = t_attention.cross_attention(tq, tk, tv, chunk_q=chunk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        t_attention.block_attention(tq, tk, tv, causal=False, chunk=8)
        .numpy(), want, **TOL)


def test_every_family_is_served():
    """No family is refused: a reduced model of every arch runs one
    prefill and one decode step on the CPU."""
    for arch in t_configs.ARCH_IDS:
        cfg = t_configs.reduced(t_configs.get_config(arch))
        params = t_model.init_params(cfg, generator=torch.Generator()
                                     .manual_seed(0), device="cpu")
        prompt = t_serve.synthetic_prompt(cfg, 1, 4, 0, torch.device("cpu"))
        with torch.no_grad():
            got = t_serve.generate(params, cfg, prompt, 2, {})
        assert got.shape == (1, 2)
        assert all(l.device.type == "cpu" for l in leaves(params))
