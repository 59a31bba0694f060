"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's, on the CPU.

Router and expert weights and the tokens are drawn with numpy and handed
to both.  ``moe_ff`` is held at capacity factors where assignments drop
(and one where none do, and single-token groups, as at decode): outputs
and aux loss at rtol 1e-5, atol 1e-6 (float32, summed in other orders),
the experts each token chose and the set of dropped assignments exactly,
the latter recomputed from the reference's own routing expressions.  A
tie in the router's probabilities goes to the lower expert index, as
``jax.lax.top_k`` breaks it.  Gradients through routing, dispatch,
combine and the aux loss at 1e-5 of each leaf's largest entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.models import moe as j_moe                         # noqa: E402
from repro_torch.models import moe as t_moe                   # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL = 1e-5
D, FF, E = 32, 16, 8


def _params(kind, seed=0):
    rng = np.random.RandomState(seed)
    p = {"router": rng.randn(D, E) * D ** -0.5,
         "w_up": rng.randn(E, D, FF) * D ** -0.5,
         "w_down": rng.randn(E, FF, D) * FF ** -0.5}
    if kind == "swiglu":
        p["w_gate"] = rng.randn(E, D, FF) * D ** -0.5
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(B, S, seed=1):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


def _reference_routing(p, x, top_k, cf, group_size):
    """The experts each token chose and which assignments dropped, by the
    reference's expressions (``repro/models/moe.py`` ``_moe_group``)."""
    B, S, d = x.shape
    E = p["router"].shape[-1]
    gs = t_moe.group_len(S, group_size)
    cap = min(int(max(top_k * gs * cf / E, 1)), gs)
    xg = jnp.asarray(x).reshape(-1, gs, d)
    probs = jax.nn.softmax(xg @ jnp.asarray(p["router"]), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, top_k)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    active = onehot.sum(axis=2)
    pos = jnp.cumsum(active, axis=1) * active - 1
    in_cap = (pos < cap) & (pos >= 0)
    kept = jnp.take_along_axis(in_cap, gate_idx, axis=2)
    return np.asarray(gate_idx), ~np.asarray(kept), cap


CASES = [  # (mlp, top_k, capacity factor, group size, B, S)
    ("swiglu", 2, 1.0, 8, 2, 24),        # cap 2: drops
    ("swiglu", 2, 0.5, None, 2, 24),     # one group per sequence, cap 3
    ("gelu", 3, 1.25, 12, 3, 36),
    ("swiglu", 2, 8.0, 8, 2, 24),        # dropless
    ("swiglu", 2, 1.25, 512, 4, 1),      # decode: one token a group, cap 1
    ("gelu", 2, 1.0, 7, 2, 24),          # group shrunk to a divisor: 6
]


@pytest.mark.parametrize("kind,top_k,cf,gsize,B,S", CASES)
def test_moe_ff_matches_jax_with_drops(kind, top_k, cf, gsize, B, S):
    p, x = _params(kind), _x(B, S)
    want, want_aux = j_moe.moe_ff(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        top_k=top_k, capacity_factor=cf, group_size=gsize)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    got, aux = t_moe.moe_ff(tp, torch.as_tensor(x), top_k=top_k,
                            capacity_factor=cf, group_size=gsize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)

    gate_idx, dropped, cap = _reference_routing(p, x, top_k, cf, gsize)
    gs = t_moe.group_len(S, gsize)
    r = t_moe.route(tp["router"], torch.as_tensor(x).reshape(-1, gs, D),
                    top_k, cap)
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)
    np.testing.assert_array_equal((~r.kept).numpy(), dropped)
    if cf >= 8.0 or S == 1:
        assert not dropped.any()
    elif (kind, cf) != ("swiglu", 0.5):
        assert dropped.any(), "the case was meant to drop assignments"


def test_router_ties_go_to_the_lower_expert():
    """Experts 1 and 5, and 2 and 6, have identical router columns: the
    tied probabilities are equal, and both packages take the lower index
    first."""
    p, x = _params("swiglu"), _x(2, 16)
    p["router"][:, 5] = p["router"][:, 1]
    p["router"][:, 6] = p["router"][:, 2]
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    for top_k in (2, 4, 7):
        _, want = jax.lax.top_k(probs, top_k)
        r = t_moe.route(torch.as_tensor(p["router"]), torch.as_tensor(x),
                        top_k, cap=16)
        np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(want))
    assert (np.asarray(probs)[..., 1] == np.asarray(probs)[..., 5]).all()


def test_moe_ff_gradients_match_jax():
    """Through a routing that drops: the gradients of the router, experts
    and input under a cotangent on the output, plus the aux loss."""
    p, x = _params("swiglu"), _x(2, 24)
    ct = np.random.RandomState(2).randn(2, 24, D).astype(np.float32)

    def jf(p, x):
        out, aux = j_moe.moe_ff(p, x, top_k=2, capacity_factor=1.0,
                                group_size=8)
        return jnp.sum(out * ct) + aux
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jg = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = t_moe.moe_ff(tp, tx, top_k=2, capacity_factor=1.0,
                            group_size=8)
    (torch.sum(out * torch.as_tensor(ct)) + aux).backward()
    for name, t in list(tp.items()) + [("x", tx)]:
        j = np.asarray(jg[1] if name == "x" else jg[0][name])
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0,
                                   atol=GRAD_RTOL * np.abs(j).max(),
                                   err_msg=name)


def test_moe_ff_in_bf16_matches_jax():
    """bf16 weights and tokens: the router still runs in float32, and the
    output agrees to bf16's rounding (the combine weights are rounded to
    bf16 in both)."""
    p, x = _params("swiglu"), _x(2, 24)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    want, want_aux = j_moe.moe_ff(jp, jnp.asarray(x, jnp.bfloat16), top_k=2,
                                  capacity_factor=1.0, group_size=8)
    tp = {k: torch.as_tensor(v).to(torch.bfloat16) for k, v in p.items()}
    got, aux = t_moe.moe_ff(tp, torch.as_tensor(x).to(torch.bfloat16),
                            top_k=2, capacity_factor=1.0, group_size=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def _index_form(table, idx, inv):
    """The dispatch and combine as plain index gathers: autograd's own
    backward, an index accumulation."""
    return torch.cat([table, table.new_zeros((1, table.shape[-1]))])[idx]


@pytest.mark.parametrize("kind,top_k,cf,gsize,B,S", [CASES[0], CASES[2]])
def test_moe_ff_backward_is_a_fixed_order_gather(kind, top_k, cf, gsize, B,
                                                 S, monkeypatch):
    """Capacity below demand (drops) and every token routed to k > 1
    experts: the gradients of the gather backward match the reference's
    at ``GRAD_RTOL`` of each leaf's largest entry, run under deterministic
    algorithms, and match the index-gather form's autograd within 1e-6 of
    each leaf's largest entry (float32, the k terms of a token summed in
    another order); the forward is that form's bit for bit."""
    p, x = _params(kind), _x(B, S)
    ct = np.random.RandomState(2).randn(B, S, D).astype(np.float32)

    def jf(p, x):
        out, aux = j_moe.moe_ff(p, x, top_k=top_k, capacity_factor=cf,
                                group_size=gsize)
        return jnp.sum(out * ct) + aux
    jg = jax.grad(jf, argnums=(0, 1))({k: jnp.asarray(v)
                                       for k, v in p.items()},
                                      jnp.asarray(x))

    def grads():
        tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
        tx = torch.tensor(x, requires_grad=True)
        out, aux = t_moe.moe_ff(tp, tx, top_k=top_k, capacity_factor=cf,
                                group_size=gsize)
        (torch.sum(out * torch.as_tensor(ct)) + aux).backward()
        return out.detach(), {**{k: t.grad for k, t in tp.items()},
                              "x": tx.grad}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out, got = grads()
    finally:
        torch.use_deterministic_algorithms(was)
    _, dropped, _ = _reference_routing(p, x, top_k, cf, gsize)
    assert dropped.any() and top_k > 1
    for name, g in got.items():
        j = np.asarray(jg[1] if name == "x" else jg[0][name])
        np.testing.assert_allclose(g.numpy(), j, rtol=0,
                                   atol=GRAD_RTOL * np.abs(j).max(),
                                   err_msg=name)
    monkeypatch.setattr(t_moe, "gather_rows", _index_form)
    out_i, want = grads()
    assert torch.equal(out, out_i)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("shared", [0.0, 0.9])
def test_full_width_routing_drops_what_the_references_drops(shared):
    """granite_moe_3b_a800m's router at full width (d_model 1536, 40
    experts, top 8, capacity factor 1.25, groups of 512), both packages on
    one seeded router (normal, std d^-0.5, rounded to bf16 as the model
    holds it) and one seeded batch of 2 x 1024 hidden states: independent
    tokens, and tokens sharing a direction with weight ``shared`` (the
    residual stream of a randomly initialised deep model is such a batch).
    The experts chosen and the kept masks are equal, so the drop share is
    the reference's; it stays small on independent tokens and climbs on
    correlated ones."""
    from repro_torch import configs as t_configs
    cfg = t_configs.get_config("granite_moe_3b_a800m")
    d, E, k = cfg.d_model, cfg.n_experts, cfg.top_k
    rng = np.random.RandomState(5)
    bf16 = lambda a: torch.as_tensor(a.astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    router = bf16(rng.randn(d, E) * d ** -0.5)
    x = rng.randn(2, 1024, d)
    x = bf16(shared * rng.randn(d) + np.sqrt(1 - shared ** 2) * x)
    gate_idx, dropped, cap = _reference_routing(
        {"router": router}, x, k, cfg.capacity_factor, cfg.moe_group_size)
    gs = t_moe.group_len(1024, cfg.moe_group_size)
    assert (gs, cap) == (512, 128)
    r = t_moe.route(torch.as_tensor(router),
                    torch.as_tensor(x).reshape(-1, gs, d), k, cap)
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)
    np.testing.assert_array_equal((~r.kept).numpy(), dropped)
    share = float((~r.kept).float().mean())
    assert share == dropped.mean()
    assert (share < 0.1) if shared == 0.0 else (share > 0.3)
