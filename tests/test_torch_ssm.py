"""The port's state-space mixers (``repro_torch/models/ssm.py``) against the
JAX package's, on the CPU.

Inputs are drawn with numpy at the decays the models give them: SSD's
``A = -linspace(1, 16)`` with ``dt = softplus(.)``, so the cumulative
log-decay of a 128-token chunk reaches the -30 floor; WKV6's
``w = -exp(-2 + .)``.  Each chunked scan is held against the reference's
chunked scan and against the sequential per-token scans of both packages,
with and without a carried state, at the models' chunk lengths (128 for
zamba2, 32 for rwkv6) and at lengths the chunk does not divide; the
one-token steps against the reference's.  Tolerance: every entry within
5e-5 of the largest |entry| of the reference's output.  Everything is
float32, and the forms sum in other orders, with cancellation: here the
reference's own chunked and sequential scans differ by up to 9.8e-6 of
the largest output (bf16 inputs: the outputs round to bf16 in both).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.models import ssm as j_ssm                         # noqa: E402
from repro_torch.models import ssm as t_ssm                   # noqa: E402

SCALE_RTOL = 5e-5


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _ssd_inputs(B, S, nh, hd, N, seed, state):
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(B, S, nh, hd).astype(f)
    dt = _softplus(rng.randn(B, S, nh) - 1.0).astype(f)
    A = -np.linspace(1.0, 16.0, nh).astype(f)
    Bm = rng.randn(B, S, N).astype(f)
    Cm = rng.randn(B, S, N).astype(f)
    s0 = rng.randn(B, nh, hd, N).astype(f) if state else None
    return x, dt, A, Bm, Cm, s0


def _wkv_inputs(B, S, H, K, seed, state):
    rng = np.random.RandomState(seed)
    f = np.float32
    r, k, v = (rng.randn(B, S, H, K).astype(f) for _ in range(3))
    w = -np.exp(-2.0 + 0.5 * rng.randn(B, S, H, K)).astype(f)
    u = (0.1 * rng.randn(H, K)).astype(f)
    s0 = rng.randn(B, H, K, K).astype(f) if state else None
    return r, k, v, w, u, s0


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _hold(got, want, rtol=SCALE_RTOL, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


# (S, chunk, state): zamba2's chunk over two chunks; a chunk S does not
# divide (128 -> 100 at S = 200, 16 -> 10 at 40); one token
SSD_CASES = [(256, 128, False), (256, 128, True), (200, 128, True),
             (40, 16, False), (1, 128, True)]


@pytest.mark.parametrize("S,chunk,state", SSD_CASES)
def test_ssd_chunked_matches_jax_chunked_and_sequential(S, chunk, state):
    args = _ssd_inputs(2, S, 4, 8, 16, seed=S + state, state=state)
    *ins, s0 = args
    want_y, want_s = j_ssm.ssd_chunked(*map(_j, ins), chunk=chunk,
                                       initial_state=_j(s0))
    seq_y, seq_s = j_ssm.ssd_reference(*map(_j, ins), initial_state=_j(s0))
    y, s = t_ssm.ssd_chunked(*map(_t, ins), chunk=chunk,
                             initial_state=_t(s0))
    ty, ts = t_ssm.ssd_reference(*map(_t, ins), initial_state=_t(s0))
    assert y.dtype == s.dtype == torch.float32
    for name, a, b in (("chunked y", y, want_y), ("chunked state", s, want_s),
                       ("chunked y vs sequential", y, seq_y),
                       ("chunked state vs sequential", s, seq_s),
                       ("sequential y", ty, seq_y),
                       ("sequential state", ts, seq_s)):
        _hold(a, b, what=name)


def test_ssd_decode_step_matches_jax():
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(3, 1, 4, 8, 16, seed=7, state=True)
    want = j_ssm.ssd_decode_step(_j(x[:, 0]), _j(dt[:, 0]), _j(A),
                                 _j(Bm[:, 0]), _j(Cm[:, 0]), _j(s0))
    got = t_ssm.ssd_decode_step(_t(x[:, 0]), _t(dt[:, 0]), _t(A),
                                _t(Bm[:, 0]), _t(Cm[:, 0]), _t(s0))
    for a, b in zip(got, want):
        _hold(a, b)


def test_ssd_chunked_rounds_bf16_inputs_like_jax():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(2, 64, 4, 8, 16, seed=3, state=False)
    xb = x.astype(jnp.bfloat16)
    want_y, want_s = j_ssm.ssd_chunked(jnp.asarray(xb), _j(dt), _j(A),
                                       _j(Bm), _j(Cm), chunk=32)
    y, s = t_ssm.ssd_chunked(torch.as_tensor(x).to(torch.bfloat16), _t(dt),
                             _t(A), _t(Bm), _t(Cm), chunk=32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _hold(y, want_y, rtol=1e-2)
    _hold(s, want_s)


# rwkv6's chunk of 32 over two chunks; 16 -> 10 at S = 40; one token
WKV_CASES = [(64, 32, False), (64, 32, True), (40, 16, True), (1, 32, True)]


@pytest.mark.parametrize("S,chunk,state", WKV_CASES)
def test_wkv6_chunked_matches_jax_chunked_and_sequential(S, chunk, state):
    *ins, s0 = _wkv_inputs(2, S, 3, 8, seed=S + state, state=state)
    want_o, want_s = j_ssm.wkv6_chunked(*map(_j, ins), chunk=chunk,
                                        initial_state=_j(s0))
    seq_o, seq_s = j_ssm.wkv6_reference(*map(_j, ins), initial_state=_j(s0))
    o, s = t_ssm.wkv6_chunked(*map(_t, ins), chunk=chunk,
                              initial_state=_t(s0))
    to, ts = t_ssm.wkv6_reference(*map(_t, ins), initial_state=_t(s0))
    assert o.dtype == s.dtype == torch.float32
    for name, a, b in (("chunked o", o, want_o), ("chunked state", s, want_s),
                       ("chunked o vs sequential", o, seq_o),
                       ("chunked state vs sequential", s, seq_s),
                       ("sequential o", to, seq_o),
                       ("sequential state", ts, seq_s)):
        _hold(a, b, what=name)


def test_wkv6_decode_step_matches_jax():
    r, k, v, w, u, s0 = _wkv_inputs(3, 1, 3, 8, seed=5, state=True)
    one = [a[:, 0] for a in (r, k, v, w)]
    want = j_ssm.wkv6_decode_step(*map(_j, one), _j(u), _j(s0))
    got = t_ssm.wkv6_decode_step(*map(_t, one), _t(u), _t(s0))
    for a, b in zip(got, want):
        _hold(a, b)
