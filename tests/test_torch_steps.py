"""The port's sharded steps (``launch/steps.py``) against the JAX
package's, on a 1x1 CPU mesh (a gloo group of one rank), and against the
port's own unsharded step on 2x2 and 1x4 meshes (a gloo group of four
spawned processes), where the rules of ``parallel/shards.py`` split real
work and DTensor runs real collectives.

(iv) Each mode's step — sgd, admm, prefill, decode — on reduced granite_8b
and granite_moe, the reference's weights carried across by
``models/convert.py``, equals the reference's ``jax.jit(bundle.fn)`` on
the same seeded inputs, within the tolerances of
``tests/test_torch_train.py`` and ``tests/test_torch_families.py``:
rtol 1e-4, atol 1e-5 for logits, caches and training state (float32 sums
in other orders; Adam divides by sqrt(v), so a gradient's last-bit
differences reach the parameters scaled by lr), 1e-5 relative for the
round's metrics.  The sharded step also equals the port's own unsharded
functions bit for bit: at 1x1 every local shard is the whole tensor.

(v) The matmul FLOPs that ``launch/op_analysis.py`` counts equal the
reference's ``hlo_analysis.analyze_module`` within 1e-6 relative.  For
granite_8b nothing is left over.  For granite_moe the difference is
accounted for term by term (``moe_flop_gap``): the reference's one-hot
dispatch and combine einsums, and its attention over
``attn_head_pad`` = 32 padded query heads (the reduced config keeps the
full config's pad; the port ignores it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import configs as j_configs                        # noqa: E402
from repro.core import trainer as j_trainer                   # noqa: E402
from repro.launch import hlo_analysis as j_hlo                # noqa: E402
from repro.launch import mesh as j_mesh                       # noqa: E402
from repro.launch import steps as j_steps                     # noqa: E402
from repro.models import model as j_model                     # noqa: E402
from repro.optim import optimizers as j_opt                   # noqa: E402
from repro_torch import configs as t_configs                  # noqa: E402
from repro_torch.core import trainer as t_trainer             # noqa: E402
from repro_torch.kernels import ops as t_ops                  # noqa: E402
from repro_torch.launch import op_analysis as t_oa            # noqa: E402
from repro_torch.launch import mesh as t_mesh                 # noqa: E402
from repro_torch.launch import steps as t_steps               # noqa: E402
from repro_torch.models import attention as t_attn           # noqa: E402
from repro_torch.models import model as t_model               # noqa: E402
from repro_torch.models.convert import (                      # noqa: E402
    params_from_jax, sgd_state_from_jax, state_from_jax)
from repro_torch.tree import flatten, leaves, tree_map       # noqa: E402
from test_torch_data import partitionable                     # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
METRIC_RTOL = 1e-5
FLOP_RTOL = 1e-6
B, S, P = 2, 16, 12                 # batch, sequence (cache) length, prompt
ARCHS = ["granite_8b", "granite_moe_3b_a800m"]
MODES = ["sgd", "admm", "prefill", "decode"]
KIND = {"sgd": "train", "admm": "train", "prefill": "prefill",
        "decode": "decode", "grads": "train"}


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    assert not dist.is_initialized()
    m = t_mesh.make_host_mesh(device="cpu")
    try:
        yield m
    finally:
        t_mesh.close_host_mesh()


def _cfgs(arch):
    return (j_configs.reduced(j_configs.get_config(arch)),
            t_configs.reduced(t_configs.get_config(arch)))


def _f64(x):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def _hold(got, want, tol=TOL, what=""):
    gl, wl = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(_f64(g), _f64(w), **tol,
                                   err_msg=f"{what} leaf {i}")


def _inputs(cfg, kind, seed=1):
    """Numpy inputs of one step: tokens (and labels) or, for decode, one
    token at position P."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if kind == "train":
        return {"tokens": tok,
                "labels": rng.randint(0, cfg.vocab_size,
                                      (B, S)).astype(np.int32)}
    if kind == "prefill":
        return {"tokens": tok}
    return {"tokens": tok[:, P:P + 1],
            "positions": np.full((B,), P, np.int32), "prompt": tok[:, :P]}


def _step_pair(arch, mode, mesh):
    """(the reference's outputs, the port's sharded outputs, the port's
    unsharded outputs) of one step from one state."""
    jcfg, tcfg = _cfgs(arch)
    kind = KIND[mode]
    jshape = j_configs.ShapeConfig("s", S, B, kind)
    tshape = t_configs.ShapeConfig("s", S, B, kind)
    jb = j_steps.build_step(jcfg, jshape, j_mesh.make_host_mesh(), mode)
    tb = t_steps.build_step(tcfg, tshape, mesh, mode)
    with partitionable():
        jp = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    npp = jax.tree.map(np.asarray, jp)
    inp = _inputs(tcfg, kind)
    tcpu = lambda b: {k: torch.as_tensor(v) for k, v in b.items()}
    if mode == "sgd":
        jargs = (jp, j_opt.adamw_init(jp), inp)
        make = lambda: sgd_state_from_jax(
            (npp, jax.tree.map(np.asarray, jargs[1])), tcfg, device="cpu") \
            + (tcpu(inp),)
        plain = t_trainer.make_sgd_step(tcfg)
    elif mode == "admm":
        ccfg = j_trainer.ConsensusConfig(n_workers=1, local_steps=4)
        with partitionable():
            js = j_trainer.init_state(jax.random.PRNGKey(0), jcfg, ccfg)
        wb = {k: v[None] for k, v in inp.items()}
        jargs = (js, wb)
        make = lambda: (state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                                       device="cpu"), tcpu(wb))
        plain = t_trainer.make_round_step(
            tcfg, t_trainer.ConsensusConfig(n_workers=1, local_steps=4))
    else:
        cache = j_model.init_cache(jcfg, B, S)
        if mode == "decode":
            _, cache = j_model.prefill(jp, jcfg,
                                       {"tokens": inp.pop("prompt")}, cache)
        npc = jax.tree.map(np.asarray, cache)
        jargs = (jp, inp, cache)
        make = lambda: (params_from_jax(npp, tcfg, device="cpu"), tcpu(inp),
                        {k: torch.tensor(v) for k, v in npc.items()})
        if mode == "prefill":
            plain = lambda p, b, c: t_model.prefill(p, tcfg, b, c,
                                                    last_only=True)
        else:
            plain = lambda p, b, c: t_model.decode_step(p, tcfg, b, c)
    want = jax.jit(jb.fn)(*jargs)
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with grad:
        got = t_steps.lower_step(tb, mesh, make()).run()
        again = plain(*make())
    return want, got, again


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_the_reference_at_1x1(arch, mode, mesh):
    want, got, again = _step_pair(arch, mode, mesh)
    if mode in ("prefill", "decode"):
        (jl, jc), (tl, tc), (pl, pc) = want, got, again
        np.testing.assert_allclose(_f64(tl), _f64(jl), **TOL)
        for k in jc:
            np.testing.assert_allclose(_f64(tc[k]), _f64(jc[k]), **TOL,
                                       err_msg=k)
        # bit for bit against the unsharded port
        assert np.array_equal(_f64(tl), _f64(pl))
        assert all(np.array_equal(_f64(tc[k]), _f64(pc[k])) for k in pc)
        return
    *jstate, jm = want
    *tstate, tm = got
    *pstate, pm = again
    for name in jm:
        if name in tm:
            np.testing.assert_allclose(_f64(tm[name]), _f64(jm[name]),
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=name)
            assert np.array_equal(_f64(tm[name]), _f64(pm[name])), name
    _hold(tstate, jstate, what=mode)
    for a, b in zip(leaves(tstate), leaves(pstate)):
        assert np.array_equal(_f64(a), _f64(b))


def moe_flop_gap(cfg, mode):
    """The reference's matmul FLOPs that the port's MoE and attention do
    not do, per step, at (B, S) on reduced granite_moe:
      * dispatch "td,tec->ecd" and combine "ecd,tec->td": 2 gs E cap d
        each per group of gs tokens (G groups) — at decode a group is one
        token, and XLA rewrites the dispatch's contraction over that one
        token as a multiply, so only the combine counts;
      * attention over Hp = attn_head_pad query heads instead of H: each
        of Q K^T and P V costs 2 B S S (Hp - H) hd more (prefill and
        training only: the reference pads in ``_attn_seq``);
    in training (remat): the forward, its recomputation and the backward
    (two matmuls per matmul) of each attention einsum (x 8 for the pair);
    the dispatch forward, recomputed and one backward (its one-hot has no
    gradient) (x 3); the combine forward and two backward, its recomputed
    output being dead (x 3); the ADMM round runs K = 4 such steps."""
    L, d, E = cfg.n_layers, cfg.d_model, cfg.n_experts
    if mode == "decode":
        return L * 2.0 * B * E * 1 * d
    gs = min(cfg.moe_group_size or S, S)
    G = B * S // gs
    cap = min(int(max(cfg.top_k * gs * cfg.capacity_factor / E, 1)), gs)
    route = 2.0 * G * gs * E * cap * d
    pad = 2.0 * B * S * S * (cfg.attn_head_pad - cfg.n_heads) * cfg.hd
    if mode == "prefill":
        return L * (2 * pad + 2 * route)
    step = L * (8 * pad + 3 * route + 3 * route)
    return step if mode == "sgd" else 4 * step


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_matmul_flops_match_analyze_module(arch, mode, mesh):
    jcfg, tcfg = _cfgs(arch)
    kind = KIND[mode]
    jmesh = j_mesh.make_host_mesh()
    jb = j_steps.build_step(jcfg, j_configs.ShapeConfig("s", S, B, kind),
                            jmesh, mode)
    want = j_hlo.analyze_module(
        j_steps.lower_step(jb, jmesh).compile().as_text())["flops_per_chip"]
    tb = t_steps.build_step(tcfg, t_configs.ShapeConfig("s", S, B, kind),
                            mesh, mode)
    args = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), tb.args)
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with grad:
        _, summary = t_steps.lower_step(tb, mesh, args).cost()
    assert summary["unknown_trip_loops"] == 0
    assert summary["n_collective_ops"] == 0 or mode == "admm"
    gap = moe_flop_gap(tcfg, mode) if tcfg.n_experts else 0.0
    assert tcfg.n_experts or not tcfg.attn_head_pad
    assert summary["flops_per_chip"] + gap == pytest.approx(
        want, rel=FLOP_RTOL)


def test_admm_bundle_specs_and_skip_rules(mesh):
    cfg = t_configs.reduced(t_configs.get_config("granite_8b"))
    b = t_steps.build_step(cfg, t_configs.ShapeConfig("s", S, B, "train"),
                           mesh, "admm", consensus=dict(prox="l1"))
    assert b.meta == {"mode": "admm", "n_workers": 1, "local_steps": 4,
                      "tokens": B * S * 4}
    assert b.in_specs[0].x["blocks"]["attn"]["wq"]["w"] == (
        "data", None, None, "model")
    assert "z_nnz" in b.out_specs[1]
    assert b.args[1]["tokens"].shape == (1, B, S)
    long = t_configs.get_shape("long_500k")
    assert t_steps.build_step(t_configs.get_config("granite_8b"), long,
                              mesh, "decode") is None
    assert t_steps.default_modes(long) == ("decode",)
    with pytest.raises(ValueError, match="unknown mode"):
        t_steps.build_step(cfg, t_configs.ShapeConfig("s", S, B, "train"),
                           mesh, "rl")


@pytest.mark.parametrize("mode", ["sgd", "admm"])
def test_sharded_updates_sum_in_the_unsharded_chunks(mode, mesh,
                                                     monkeypatch):
    """The optimizer and the round sum in flat chunks of ``CHUNK``
    elements (the global norm, q): a sharded step chunks each shard the
    same way, so at 1x1 it stays bit for bit equal to the unsharded step
    when the leaves span many chunks (as granite_8b's do on the card)."""
    from repro_torch.optim import optimizers as t_opt
    monkeypatch.setattr(t_opt, "CHUNK", 1000)
    _, got, again = _step_pair("granite_8b", mode, mesh)
    for a, b in zip(leaves(got), leaves(again)):
        assert np.array_equal(_f64(a), _f64(b))


def test_host_mesh_needs_the_card_it_is_asked_for():
    import torch.distributed as dist
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    before = dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mesh.make_host_mesh()
    assert dist.is_initialized() == before      # no group was started


# ---------------------------------------------------------------------------
# more than one rank: a real gloo group of four processes on the CPU
# ---------------------------------------------------------------------------

MESHES = [(2, 2), (1, 4)]
MB = 4                              # batch: splits over data 2 and W = 2
# (mesh, arch, overrides of ``reduced``, mode, batch, sequence): where the
# sharded step once raised.  granite_moe with 6 query heads of 64 on a
# 4-wide model axis, as its 24 on 16 (the row-parallel output projection
# hands the merged heads' cotangent back split 6 ways over 4), through the
# sgd step's loss and gradients ("grads"); zamba2 and rwkv6 prefills whose
# batch does not split over the model axis, so DTensor splits the sequence
# there (all of the SSD's operands; RWKV6's decay)
REPAIRS = [((1, 4), "granite_moe_3b_a800m",
            dict(n_heads=6, head_dim=64, d_model=384), "grads", MB, S),
           ((1, 4), "zamba2_1_2b", {}, "prefill", 2, 128),
           ((2, 2), "rwkv6_1_6b", {}, "prefill", 2, S)]
# (mesh, arch, sequence, prompt): decode over a cache whose slots split over
# the model axis, each rank's partial decode combined across ranks (rule
# "decode"): the hybrid's shared attention, the VLM's self-attention beside
# its replicated image cache, mixtral's 32-slot ring wrapped (position 40),
# and granite_8b on 2x2 at position 40 of 128 slots, so the second model
# rank's 64 slots hold no live one
DECODES = [((1, 4), "zamba2_1_2b", 64, 40),
           ((1, 4), "llama3_2_vision_90b", 64, 40),
           ((1, 4), "mixtral_8x7b", 48, 40),
           ((2, 2), "granite_8b", 128, 40)]


def _state(cfg, mode, n_workers, B=MB, seq_len=S, prompt=P):
    """A fresh (args, plain step) of ``mode`` on reduced ``cfg`` at batch
    ``B`` and sequence ``seq_len`` (a decode at position ``prompt``, after a
    prefill of that many tokens): weights from seed 0, numpy inputs from
    seeds 1 and 3 (the VLM's image embeddings from seed 2)."""
    from repro_torch.optim import optimizers as t_opt
    tok = lambda a: torch.as_tensor(a.astype(np.int32))
    gen = lambda: torch.Generator().manual_seed(0)
    rng = np.random.RandomState(1)
    seq = rng.randint(0, cfg.vocab_size, (B, seq_len))
    if mode in ("sgd", "grads"):
        p = t_model.init_params(cfg, generator=gen(), device="cpu")
        lab = rng.randint(0, cfg.vocab_size, (B, seq_len))
        return ((p, t_opt.adamw_init(p), {"tokens": tok(seq),
                                          "labels": tok(lab)}),
                t_trainer.make_sgd_step(cfg) if mode == "sgd"
                else _loss_and_grads(cfg))
    if mode == "admm":
        ccfg = t_trainer.ConsensusConfig(n_workers=n_workers, local_steps=2)
        st = t_trainer.init_state(cfg, ccfg, generator=gen(), device="cpu")
        r3 = np.random.RandomState(3)
        wb = {k: tok(r3.randint(0, cfg.vocab_size,
                                (n_workers, B // n_workers, seq_len)))
              for k in ("tokens", "labels")}
        return (st, wb), t_trainer.make_round_step(cfg, ccfg)
    p = t_model.init_params(cfg, generator=gen(), device="cpu")
    cache = t_model.init_cache(cfg, B, seq_len, device="cpu")
    if mode == "prefill":
        return ((p, {"tokens": tok(seq)}, cache),
                lambda p, b, c: t_model.prefill(p, cfg, b, c, last_only=True))
    first = {"tokens": tok(seq[:, :prompt])}
    if cfg.family == "vlm":
        first["img_embeds"] = torch.as_tensor(np.random.RandomState(2).randn(
            B, cfg.n_img_tokens, cfg.d_model).astype(np.float32))
    t_model.prefill(p, cfg, first, cache)
    return ((p, {"tokens": tok(seq[:, prompt:prompt + 1]),
                 "positions": torch.full((B,), prompt, dtype=torch.int32)},
             cache),
            lambda p, b, c: t_model.decode_step(p, cfg, b, c))


def _loss_and_grads(cfg):
    """The sgd step up to its AdamW update: (params, opt, batch) -> (loss,
    gradients).  A repair of the backward is held here and not on the
    updated parameters: AdamW's first step moves each parameter by about
    lr times the sign of its gradient, so an entry within float32 noise of
    zero (3e-8 against a leaf's largest 1.8e-2, measured on the CPU) lands
    up to 2 lr apart between two summation orders."""
    def fn(params, opt, batch):
        ps, build = flatten(params)
        return t_trainer.value_and_grads(
            lambda p, b: t_model.loss_fn(p, cfg, b)[0], ps, build, batch)
    return fn


class _AttentionGathers(t_oa.OpCounter):
    """An ``OpCounter`` that also keeps the largest all-gather (in elements)
    issued while ``inside`` is set (inside ``ops.decode_attention``)."""

    def __init__(self):
        super().__init__()
        self.inside = False
        self.largest = 0

    def _collective(self, kind, args, outs):
        super()._collective(kind, args, outs)
        if self.inside and kind == "all-gather":
            self.largest = max(self.largest, sum(t.numel() for t in outs))


def _decode_counted(b, mesh, args):
    """The sharded decode step under an ``_AttentionGathers`` -> (its
    outputs, the largest all-gather inside its attention calls, the
    all-reduces' link bytes, and the control: the largest all-gather of
    the plain attention, which the rule replaced, on the first call's
    DTensors)."""
    counter = _AttentionGathers()
    seen = []
    real = t_ops.decode_attention

    def spied(*operands):
        seen.append(operands)
        counter.inside = True
        try:
            return real(*operands)
        finally:
            counter.inside = False
    lowered = t_steps.lower_step(b, mesh, args)
    counter.add_args(lowered.args)
    t_ops.decode_attention = spied
    try:
        with counter:
            got = lowered.run()
    finally:
        t_ops.decode_attention = real
    from torch.distributed.tensor.experimental import implicit_replication
    control = _AttentionGathers()
    control.inside = True
    with control, implicit_replication():
        t_attn.decode_attention(*seen[0])
    return (got, counter.largest,
            counter.summary()["by_type"].get("all-reduce", 0.0),
            control.largest)


def _rank_main(rank, world, port, shape, out):
    """One rank: every (arch, mode) step, the mesh's ``REPAIRS`` and
    ``DECODES``, sharded on a ``shape`` mesh, then the unsharded port on the
    same state; rank 0 saves both, gathered."""
    import pickle
    import traceback

    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = t_mesh.make_host_mesh(*shape, device="cpu")
    cases = [(arch, {}, mode, MB, S) for arch in ARCHS for mode in MODES]
    cases += [c[1:] for c in REPAIRS if c[0] == shape]
    res = {}
    for _, arch, seq_len, prompt in (c for c in DECODES if c[0] == shape):
        cfg = t_configs.reduced(t_configs.get_config(arch))
        try:
            b = t_steps.build_step(cfg, t_configs.ShapeConfig(
                "s", seq_len, MB, "decode"), mesh, "decode")
            with torch.no_grad():
                args, _ = _state(cfg, "decode", 1, MB, seq_len, prompt)
                got, largest, reduced, control = _decode_counted(b, mesh,
                                                                 args)
                args, plain = _state(cfg, "decode", 1, MB, seq_len, prompt)
                want = plain(*args)
            slots = args[2]["k" if "k" in args[2] else "attn_k"].shape[-3]
            scores = MB // shape[0] * cfg.n_heads * slots
            res["decode", arch] = (
                1, [_f64(t) for t in leaves(got)],
                [_f64(t) for t in leaves(want)], largest, reduced, control,
                scores)
        except Exception:
            res["decode", arch] = traceback.format_exc()
    for arch, kw, mode, batch, seq_len in cases:
        cfg = t_configs.reduced(t_configs.get_config(arch), **kw)
        try:
            b = t_steps.build_step(cfg, t_configs.ShapeConfig(
                "s", seq_len, batch, KIND[mode]), mesh,
                "sgd" if mode == "grads" else mode,
                consensus=dict(local_steps=2))
            if mode == "grads":
                b = b._replace(fn=_loss_and_grads(cfg), out_specs=None)
            W = b.meta.get("n_workers", 1)
            grad = torch.enable_grad() if KIND[mode] == "train" \
                else torch.no_grad()
            with grad:
                args, _ = _state(cfg, mode, W, batch, seq_len)
                got = t_steps.lower_step(b, mesh, args).run()
                args, plain = _state(cfg, mode, W, batch, seq_len)
                want = plain(*args)
            res[arch, str(kw), mode] = (
                W, [_f64(t) for t in leaves(got)],
                [_f64(t) for t in leaves(want)])
        except Exception:
            res[arch, str(kw), mode] = traceback.format_exc()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """{mesh shape: {(arch, str(overrides), mode): (W, sharded leaves,
    unsharded leaves) or a traceback}}, from four spawned processes per
    mesh."""
    import pickle
    import socket

    import torch.multiprocessing as mp
    found = {}
    for shape in MESHES:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out = tmp_path_factory.mktemp("ranks") / "res.pkl"
        mp.spawn(_rank_main, args=(4, port, shape, str(out)), nprocs=4)
        with open(out, "rb") as f:
            found[shape] = pickle.load(f)
    return found


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_sharded_step_matches_unsharded_on_four_ranks(shape, arch, mode,
                                                      multi_rank):
    """Each mode's sharded step on a real four-rank group equals the
    unsharded port on the same state at ``TOL`` (its metrics at
    ``METRIC_RTOL``).  2x2: the batch split over "data" (the ADMM workers,
    W = 2, the round's cross-worker sums all-reduced), the model over
    "model" (K/V heads split alike). 1x4: four query heads on four ranks
    against two K/V heads (gathered, their gradient partial), the MoE's
    d_ff over four, the decode cache's slots over four.  Nothing else of a
    multi-rank step is left for the chip's 1x1 mesh to show."""
    _hold_ranks(multi_rank[shape][arch, "{}", mode], shape, mode)


@pytest.mark.parametrize("shape,arch,seq_len,prompt", DECODES,
                         ids=[c[1] for c in DECODES])
def test_decode_over_slot_shards_on_four_ranks(shape, arch, seq_len, prompt,
                                               multi_rank):
    """The cases of ``DECODES`` on a real four-rank group: each rank decodes
    over its own slots of the cache and the ranks combine their softmax
    states (rule "decode"), which equals the unsharded port at ``TOL``
    (logits and every cache leaf).  Inside the attention calls no
    all-gather is as large as a rank's float32 scores (B_local H Smax),
    while the plain attention on the same DTensors, the path the rule
    replaced, gathers at least that much; the combine's all-reduces ran."""
    res = multi_rank[shape]["decode", arch]
    assert not isinstance(res, str), res
    *kept, largest, reduced, control, scores = res
    _hold_ranks(tuple(kept), shape, "decode")
    assert largest < scores, (largest, scores)
    assert control >= scores, (control, scores)
    assert reduced > 0


@pytest.mark.parametrize("shape,arch,kw,mode,batch,seq_len", REPAIRS,
                         ids=[c[1] for c in REPAIRS])
def test_sharded_step_splits_no_head_or_scan_on_four_ranks(
        shape, arch, kw, mode, batch, seq_len, multi_rank):
    """The cases of ``REPAIRS`` on a real four-rank group equal the
    unsharded port on the same state, as the step's other modes do: the
    merged heads' cotangent is gathered before it is cut into 6 heads again
    (rule "merge_dims"), and each rank scans its own batch rows and heads
    over the whole sequence (rule "scan")."""
    _hold_ranks(multi_rank[shape][arch, str(kw), mode], shape, mode)


def _hold_ranks(res, shape, mode):
    assert not isinstance(res, str), res
    W, got, want = res
    assert W == (shape[0] if mode == "admm" else 1)
    assert len(got) == len(want)
    n_metrics = {"sgd": 2, "admm": 4}.get(mode, 0)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        tol = dict(rtol=METRIC_RTOL, atol=1e-7) \
            if i >= len(got) - n_metrics else TOL
        np.testing.assert_allclose(g, w, **tol, err_msg=f"leaf {i}")
