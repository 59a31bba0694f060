"""State-space sequence mixers: Mamba2 (SSD) and RWKV6 (Finch), a port of
``repro/models/ssm.py``.

Both run in chunked form for prefill and training: the sequence is split
into chunks of C tokens; within a chunk the recurrence is a masked,
decayed attention-like product, and one dense state is carried between
chunks by a Python loop (the reference's ``lax.scan``).  Everything is
computed in float32, as in the reference, and the outputs are cast back
to the inputs' dtype.  ``*_decode_step`` advances the state by one token;
``*_reference`` is the plain per-token scan the tests hold both against.
No kernel backs these functions, here or in the reference.  On DTensors
(a sharded step) each rank scans its own batch rows and heads over the
whole sequence (the rule "scan" of ``parallel/shards.py``).

Mamba2 SSD (per head h, scalar decay):
    a_t = exp(dt_t * A_h)            # A_h < 0, dt_t = softplus(...)
    S_t = a_t * S_{t-1} + (dt_t * x_t) B_t^T        # S: (hd, N)
    y_t = S_t C_t

RWKV6 WKV (per head, per-key-channel decay w_t in (0, 1)):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t             # S: (hd_k, hd_v)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.parallel.shards import on_shards

LOG_EPS = -30.0  # floor for log-decays; exp(-30) ~ 1e-13


def _chunk_len(S: int, chunk: int) -> int:
    C = min(chunk, S)
    while S % C:
        C -= 1
    return C


def _chunks(x: torch.Tensor, C: int) -> torch.Tensor:
    """(B, S, ...) float32 -> (nc, B, C, ...)."""
    B, S = x.shape[:2]
    return x.float().reshape(B, S // C, C, *x.shape[2:]).movedim(1, 0)


def _exp(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(t, min=LOG_EPS))


# ===========================================================================
# Mamba2 SSD
# ===========================================================================

@on_shards("scan")
def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, nh, hd), dt (B, S, nh) > 0, A (nh,) < 0, Bm and Cm (B, S, N),
    initial_state (B, nh, hd, N) -> (y (B, S, nh, hd) in x's dtype, final
    state (B, nh, hd, N) float32)."""
    Bb, S, nh, hd = x.shape
    N = Bm.shape[-1]
    C = _chunk_len(S, chunk)
    xg = _chunks(x * dt[..., None], C)                     # (nc,B,C,nh,hd)
    Bc, Cc = _chunks(Bm, C), _chunks(Cm, C)                      # (nc,B,C,N)
    lcum = torch.cumsum(_chunks(dt, C) * A.float(), dim=2)       # (nc,B,C,nh)
    state = (torch.zeros((Bb, nh, hd, N), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    ys = []
    for xg_i, Bc_i, Cc_i, lc_i in zip(xg, Bc, Cc, lcum):
        # intra-chunk: att[t, s] = exp(lcum[t] - lcum[s]) <C_t, B_s>, s <= t
        rel = lc_i[:, :, None, :] - lc_i[:, None, :, :]          # (B,C,C,nh)
        dec = _exp(torch.where(causal, rel, LOG_EPS))
        cb = torch.einsum("btn,bsn->bts", Cc_i, Bc_i)
        y = torch.einsum("btsh,bshd->bthd", dec * cb[..., None], xg_i)
        # inter-chunk: the carried state decayed to each position
        y = y + torch.einsum("btn,bhdn->bthd", Cc_i, state) \
            * _exp(lc_i)[..., None]
        # state' = exp(sum la) state + sum_s exp(lcum[-1] - lcum[s]) xg_s B_s^T
        tot = lc_i[:, -1]                                        # (B,nh)
        w_s = _exp(tot[:, None, :] - lc_i)                       # (B,C,nh)
        upd = torch.einsum("bshd,bsn->bhdn", xg_i * w_s[..., None], Bc_i)
        state = state * _exp(tot)[:, :, None, None] + upd
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bb, S, nh, hd)
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, A, Bm, Cm, state
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: x (B, nh, hd), dt (B, nh), Bm and Cm (B, N), state
    (B, nh, hd, N) float32 -> (y (B, nh, hd), new state)."""
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    a = torch.exp(dtf * A.float())                               # (B,nh)
    upd = torch.einsum("bhd,bn->bhdn", xf * dtf[..., None], Bf)
    state = state * a[:, :, None, None] + upd
    y = torch.einsum("bhdn,bn->bhd", state, Cf)
    return y.to(x.dtype), state


def ssd_reference(x, dt, A, Bm, Cm, *, initial_state=None):
    """The per-token scan: the oracle for tests."""
    Bb, S, nh, hd = x.shape
    state = (torch.zeros((Bb, nh, hd, Bm.shape[-1]), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        y, state = ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                   state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


# ===========================================================================
# RWKV6 WKV (Finch): per-key-channel data-dependent decay
# ===========================================================================

@on_shards("scan")
def wkv6_chunked(r, k, v, w, u, *, chunk: int = 64,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k (B, S, H, K), v (B, S, H, V), w (B, S, H, K) log-decays <= 0,
    u (H, K), initial_state (B, H, K, V) -> (o (B, S, H, V) in r's dtype,
    final state (B, H, K, V) float32)."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    C = _chunk_len(S, chunk)
    rc, kc, vc = _chunks(r, C), _chunks(k, C), _chunks(v, C)
    lcum = torch.cumsum(_chunks(w, C), dim=2)                    # inclusive
    state = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state.float())
    uf = u.float()
    strict = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    strict = strict[None, :, :, None, None]
    os_ = []
    for r_i, k_i, v_i, lc_i in zip(rc, kc, vc, lcum):            # (B,C,H,*)
        # the exclusive cumsum: the log-decay up to token t - 1
        lexc = torch.cat([torch.zeros_like(lc_i[:, :1]), lc_i[:, :-1]], 1)
        # intra, s < t: (r_t exp(lexc[t] - lcum[s]) . k_s) v_s
        rel = lexc[:, :, None] - lc_i[:, None, :]                # (B,t,s,H,K)
        dec = _exp(torch.where(strict, rel, LOG_EPS))
        att = (r_i[:, :, None] * dec * k_i[:, None]).sum(-1)     # (B,t,s,H)
        o = torch.einsum("btsh,bshv->bthv", att, v_i)
        # the current token, with its bonus u
        diag = (r_i * uf * k_i).sum(-1)                          # (B,C,H)
        o = o + diag[..., None] * v_i
        # inter: r_t decayed to the chunk's start, against the state
        o = o + torch.einsum("bthk,bhkv->bthv", r_i * _exp(lexc), state)
        tot = lc_i[:, -1]                                        # (B,H,K)
        wk = _exp(tot[:, None] - lc_i) * k_i                     # (B,C,H,K)
        upd = torch.einsum("bshk,bshv->bhkv", wk, v_i)
        state = state * _exp(tot)[..., None] + upd
        os_.append(o)
    o = torch.stack(os_, dim=1).reshape(B, S, H, V)
    return o.to(r.dtype), state


def wkv6_decode_step(r, k, v, w, u, state
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: r, k, w (B, H, K), v (B, H, V), u (H, K), state
    (B, H, K, V) float32 -> (o (B, H, V), new state)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    o = torch.einsum("bhk,bhkv->bhv", rf,
                     state + u.float()[None, :, :, None] * kv)
    state = state * _exp(wf)[..., None] + kv
    return o.to(r.dtype), state


def wkv6_reference(r, k, v, w, u, *, initial_state=None):
    """The per-token scan: the oracle for tests."""
    B, S, H, K = r.shape
    state = (torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32,
                         device=r.device)
             if initial_state is None else initial_state.float())
    os_ = []
    for t in range(S):
        o, state = wkv6_decode_step(r[:, t], k[:, t], v[:, t], w[:, t], u,
                                    state)
        os_.append(o)
    return torch.stack(os_, dim=1), state
