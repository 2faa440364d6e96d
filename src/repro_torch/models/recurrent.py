"""Recurrent mixers: mLSTM / sLSTM (xLSTM, arXiv:2405.04517) and RG-LRU
(RecurrentGemma / Griffin, arXiv:2402.19427).  Port of
``src/repro/models/recurrent.py``; no Pallas kernel exists for them, so
plain PyTorch is their port.

Prefill uses parallel forms: chunkwise mLSTM with a carried (C, n, m)
state (a Python loop over chunks where the reference has ``lax.scan``) and
RG-LRU's linear recurrence as a log-step (Hillis-Steele) scan written with
tensor ops where the reference has ``lax.associative_scan``: the same
products and sums, grouped differently, so the two agree to fp32 rounding.
sLSTM has no parallel form and runs a Python loop over time.  Decode uses
O(1) recurrent state updates, written into the given state in place (the
decoder passes views of its stacked caches), and returns that state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..sharding import Ax, shard_as
from .layers import causal_conv1d, conv1d_init, dense_init

# ---------------------------------------------------------------------------
# mLSTM — matrix-memory LSTM
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (b, h, hd, hd) matrix memory
    n: torch.Tensor  # (b, h, hd) normalizer
    m: torch.Tensor  # (b, h) stabilizer (log-space)


def init_mlstm(gen: torch.Generator, cfg):
    d = cfg.d_model
    h = cfg.num_heads
    hd = cfg.resolved_head_dim
    params = {
        "wq": dense_init(gen, d, h * hd, "embed", "heads")[0],
        "wk": dense_init(gen, d, h * hd, "embed", "heads")[0],
        "wv": dense_init(gen, d, h * hd, "embed", "heads")[0],
        "wo": dense_init(gen, h * hd, d, "heads", "embed")[0],
        "wi_gate": dense_init(gen, d, h, "embed", "heads")[0],
        "wf_gate": dense_init(gen, d, h, "embed", "heads")[0],
        "f_bias": torch.full((h,), 3.0, device=gen.device),  # forget-open
        "i_bias": torch.zeros((h,), device=gen.device),
    }
    axes = {
        "wq": Ax("embed", "heads"), "wk": Ax("embed", "heads"),
        "wv": Ax("embed", "heads"), "wo": Ax("heads", "embed"),
        "wi_gate": Ax("embed", "heads"), "wf_gate": Ax("embed", "heads"),
        "f_bias": Ax("heads"), "i_bias": Ax("heads"),
    }
    return params, axes


def init_mlstm_state(cfg, batch: int, dtype=torch.float32, *,
                     device=None) -> MLSTMState:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    return MLSTMState(
        c=torch.zeros((batch, h, hd, hd), dtype=dtype, device=device),
        n=torch.zeros((batch, h, hd), dtype=dtype, device=device),
        m=torch.full((batch, h), -1e30, dtype=dtype, device=device),
    )


def mlstm_state_specs(cfg, batch: int, dtype=torch.float32) -> MLSTMState:
    """``init_mlstm_state``'s tensors on the meta device (no storage)."""
    return init_mlstm_state(cfg, batch, dtype, device="meta")


def _mlstm_proj(params, cfg, x):
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(b, s, h, hd) / (hd ** 0.5)
    k = (x @ params["wk"].to(dt)).reshape(b, s, h, hd) / (hd ** 0.5)
    v = (x @ params["wv"].to(dt)).reshape(b, s, h, hd)
    xf = x.float()
    logi = (xf @ params["wi_gate"]) + params["i_bias"]
    logf = F.logsigmoid((xf @ params["wf_gate"]) + params["f_bias"])
    return q, k, v, logi, logf  # gates: (b, s, h) in log space


def mlstm_parallel(params, cfg, x, chunk: int = 256,
                   state: Optional[MLSTMState] = None):
    """Chunkwise-parallel mLSTM: intra-chunk quadratic + carried state.

    Memory O(s * chunk); matches the recurrent form up to rounding.
    Returns (y, final_state).
    """
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    f32 = torch.float32
    q, k, v, logi, logf = _mlstm_proj(params, cfg, x)
    if state is None:
        state = init_mlstm_state(cfg, b, device=x.device)
    nchunk = (s + chunk - 1) // chunk
    pad = nchunk * chunk - s
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=-1e30)
        logf = F.pad(logf, (0, 0, 0, pad))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    c, n, m = state.c, state.n, state.m  # (b,h,hd,hd), (b,h,hd), (b,h)
    ys = []
    for j in range(nchunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        qj, kj, vj, li, lf = q[:, sl], k[:, sl], v[:, sl], logi[:, sl], \
            logf[:, sl]                      # (b, chunk, h, ...)
        csum = torch.cumsum(lf, dim=1)       # (b, chunk, h)
        total = csum[:, -1]                  # (b, h)
        # intra-chunk pair weights: D[t,s'] = csum[t]-csum[s'] + li[s']
        a_pair = (csum[:, :, None, :] - csum[:, None, :, :]
                  + li[:, None, :, :])       # (b, t, s', h)
        a_pair = torch.where(tri[None, :, :, None], a_pair, -torch.inf)
        # inter-chunk: contribution of carried state to position t
        a_carry = csum + m[:, None, :]       # (b, t, h)
        m_intra = a_pair.amax(dim=2)         # (b, t, h)
        m_new_t = torch.maximum(a_carry, m_intra)
        # stabilized weights
        w_pair = torch.exp(a_pair - m_new_t[:, :, None, :])
        w_carry = torch.exp(a_carry - m_new_t)
        # scores
        sc = torch.einsum("bthd,bshd->btsh", qj, kj).float()
        sc = sc * w_pair
        num_intra = torch.einsum("btsh,bshd->bthd", sc.to(qj.dtype), vj)
        den_intra = sc.sum(dim=2)                                  # (b,t,h)
        qw = qj.float() * w_carry[..., None]
        num_carry = torch.einsum("bthd,bhde->bthe", qw, c)
        den_carry = torch.einsum("bthd,bhd->bth", qw, n)
        # xLSTM normalizer: max(|q . n_cum|, exp(-m)) on the *signed* sum
        den = torch.maximum(torch.abs(den_intra + den_carry),
                            torch.exp(-m_new_t))
        y = (num_intra.float() + num_carry) / den[..., None]
        # ---- update carried state to end of chunk -----------------------
        tail = total[:, None] - csum + li                         # (b,t,h)
        m_end = torch.maximum(total + m, tail.amax(dim=1))
        decay_c = torch.exp(total + m - m_end)                    # (b, h)
        kw = torch.exp(tail - m_end[:, None])                     # (b,t,h)
        kf = kj.to(f32)
        c = c * decay_c[..., None, None] + torch.einsum(
            "bthd,bthe->bhde", kf * kw[..., None], vj.to(f32))
        n = n * decay_c[..., None] + torch.einsum("bth,bthd->bhd", kw, kf)
        m = m_end
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :s].reshape(b, s, h * hd)
    out = y @ params["wo"].to(x.dtype)
    out = shard_as(out, "batch", "seq", "embed_act")
    return out, MLSTMState(c=c, n=n, m=m)


def mlstm_decode(params, cfg, x, state: MLSTMState):
    """One-token recurrent update (O(1) state), written into ``state``."""
    b, s, d = x.shape
    assert s == 1
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v, logi, logf = _mlstm_proj(params, cfg, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]          # (b, h, hd)
    li, lf = logi[:, 0], logf[:, 0]              # (b, h)
    m_new = torch.maximum(lf + state.m, li)
    f = torch.exp(lf + state.m - m_new)
    i = torch.exp(li - m_new)
    kf, vf = k.float(), v.float()
    c = state.c * f[..., None, None] + i[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = state.n * f[..., None] + i[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, c)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).to(x.dtype).reshape(b, 1, h * hd)
    out = y @ params["wo"].to(x.dtype)
    out = shard_as(out, "batch", "seq", "embed_act")
    state.c.copy_(c)
    state.n.copy_(n)
    state.m.copy_(m_new)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM — scalar-memory LSTM with block-diagonal recurrence
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (b, d) cell
    n: torch.Tensor  # (b, d) normalizer
    h: torch.Tensor  # (b, d) hidden
    m: torch.Tensor  # (b, d) stabilizer


def init_slstm(gen: torch.Generator, cfg):
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    dev = gen.device
    params = {
        # input projections for 4 gates (i, f, z, o)
        "w": dense_init(gen, d, 4 * d, "embed", "mlp")[0],
        # block-diagonal recurrent weights per head: (4, h, hd, hd)
        "r": torch.randn((4, h, hd, hd), generator=gen, device=dev)
        .mul_((1.0 / hd) ** 0.5),
        "b": torch.cat([
            torch.zeros((d,), device=dev),            # i
            torch.full((d,), 3.0, device=dev),        # f (open)
            torch.zeros((2 * d,), device=dev),        # z, o
        ]),
    }
    axes = {"w": Ax("embed", "mlp"), "r": Ax(None, "heads", None, None),
            "b": Ax("mlp")}
    return params, axes


def init_slstm_state(cfg, batch: int, dtype=torch.float32, *,
                     device=None) -> SLSTMState:
    d = cfg.d_model

    def z():
        return torch.zeros((batch, d), dtype=dtype, device=device)

    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((batch, d), -1e30, dtype=dtype,
                                   device=device))


def slstm_state_specs(cfg, batch: int, dtype=torch.float32) -> SLSTMState:
    """``init_slstm_state``'s tensors on the meta device (no storage)."""
    return init_slstm_state(cfg, batch, dtype, device="meta")


def _slstm_step(params, cfg, state: SLSTMState, zx) -> SLSTMState:
    """zx: (b, 4d) pre-activations from the input projection."""
    b = zx.shape[0]
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    hh = state.h.reshape(b, h, hd)
    rec = torch.einsum("bhd,ghde->gbhe", hh.float(), params["r"])
    rec = rec.reshape(4, b, d)
    z = zx.float().reshape(b, 4, d).transpose(0, 1) + rec
    li = z[0]
    lf = F.logsigmoid(z[1])
    cell_in = torch.tanh(z[2])
    o = torch.sigmoid(z[3])
    m_new = torch.maximum(lf + state.m, li)
    f = torch.exp(lf + state.m - m_new)
    i = torch.exp(li - m_new)
    c = f * state.c + i * cell_in
    n = torch.clamp_min(f * state.n + i, 1e-6)
    hnew = o * (c / n)
    return SLSTMState(c=c, n=n, h=hnew, m=m_new)


def slstm(params, cfg, x, state: Optional[SLSTMState] = None):
    """Sequential loop over time (no parallel form exists)."""
    b, s, d = x.shape
    if state is None:
        state = init_slstm_state(cfg, b, device=x.device)
    zx = x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)
    hs = []
    for t in range(s):
        state = _slstm_step(params, cfg, state, zx[:, t])
        hs.append(state.h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    return shard_as(y, "batch", "seq", "embed_act"), state


def slstm_decode(params, cfg, x, state: SLSTMState):
    """One-token update, written into ``state``."""
    b, s, d = x.shape
    assert s == 1
    zx = (x @ params["w"].to(x.dtype) + params["b"].to(x.dtype))[:, 0]
    st = _slstm_step(params, cfg, state, zx)
    for dst, src in zip(state, st):
        dst.copy_(src)
    return st.h[:, None, :].to(x.dtype), state


# ---------------------------------------------------------------------------
# RG-LRU — real-gated linear recurrent unit (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (b, w) recurrent state
    conv: torch.Tensor    # (b, conv_width-1, w) conv tail


def init_rglru(gen: torch.Generator, cfg):
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = gen.device
    # a-parameter initialized so a ~ U(0.9, 0.999) at r=1
    u = torch.empty((w,), device=dev).uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    params = {
        "wx": dense_init(gen, d, w, "embed", "lru")[0],
        "wgate": dense_init(gen, d, w, "embed", "lru")[0],
        "conv": conv1d_init(gen, cfg.conv_width, w)[0],
        "w_r": dense_init(gen, w, w, "lru", "lru")[0],
        "w_i": dense_init(gen, w, w, "lru", "lru")[0],
        "lam": lam,
        "wo": dense_init(gen, w, d, "lru", "embed")[0],
    }
    axes = {
        "wx": Ax("embed", "lru"), "wgate": Ax("embed", "lru"),
        "conv": Ax("conv", "lru"), "w_r": Ax("lru", "lru"),
        "w_i": Ax("lru", "lru"), "lam": Ax("lru"),
        "wo": Ax("lru", "embed"),
    }
    return params, axes


def init_rglru_state(cfg, batch: int, dtype=torch.float32, *,
                     device=None) -> RGLRUState:
    w = cfg.lru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                         device=device))


def rglru_state_specs(cfg, batch: int, dtype=torch.float32) -> RGLRUState:
    """``init_rglru_state``'s tensors on the meta device (no storage)."""
    return init_rglru_state(cfg, batch, dtype, device="meta")


_LRU_C = 8.0


def _rglru_coeffs(params, u):
    """u: (b, s, w) conv output -> per-step (a, bx) of h = a*h + bx."""
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_r"])
    i = torch.sigmoid(uf @ params["w_i"])
    log_a = -_LRU_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) multiplier keeps the state norm bounded
    bx = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * uf)
    return a, bx


def _linear_scan(a, bx, h0):
    """h_t = a_t h_{t-1} + bx_t along dim 1 from h0, for every t: the
    log-step inclusive scan of the pairs (a, bx) under
    (al, bl) . (ar, br) = (al ar, bl ar + br)."""
    a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    hs = torch.cat([h0[:, None, :].to(bx.dtype), bx], dim=1)
    shift = 1
    while shift < a.shape[1]:
        hs = torch.cat([hs[:, :shift],
                        hs[:, :-shift] * a[:, shift:] + hs[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return hs[:, 1:]  # drop the injected initial state


def rglru(params, cfg, x, state: Optional[RGLRUState] = None):
    """Griffin recurrent block: gate branch * (conv -> RG-LRU) branch."""
    b, s, d = x.shape
    if state is None:
        state = init_rglru_state(cfg, b, device=x.device)
    dt = x.dtype
    gate = F.gelu(x @ params["wgate"].to(dt), approximate="tanh")
    u = x @ params["wx"].to(dt)
    u, conv_state = causal_conv1d(u, params["conv"], state.conv
                                  if state.conv.shape[1] else None)
    a, bx = _rglru_coeffs(params, u)
    hs = _linear_scan(a, bx, state.h)
    y = (hs.to(dt) * gate) @ params["wo"].to(dt)
    y = shard_as(y, "batch", "seq", "embed_act")
    return y, RGLRUState(h=hs[:, -1], conv=conv_state.to(state.conv.dtype))


def rglru_decode(params, cfg, x, state: RGLRUState):
    """One-token update, written into ``state``."""
    b, s, d = x.shape
    assert s == 1
    dt = x.dtype
    gate = F.gelu(x @ params["wgate"].to(dt), approximate="tanh")
    u = x @ params["wx"].to(dt)
    u, conv_state = causal_conv1d(u, params["conv"], state.conv)
    a, bx = _rglru_coeffs(params, u)
    h = a[:, 0] * state.h + bx[:, 0]
    y = (h[:, None, :].to(dt) * gate) @ params["wo"].to(dt)
    y = shard_as(y, "batch", "seq", "embed_act")
    state.h.copy_(h)
    state.conv.copy_(conv_state)
    return y, state
