"""Grouped-query attention (+RoPE, local windows, softcaps, biases) with
full-sequence (prefill) and single-token decode paths.

The port's counterpart of the GQA part of the reference's
``repro/models/attention.py``. Projections and the dense ``_sdpa`` are
plain tensor code, as the reference leaves them to XLA; sequences longer
than :data:`FLASH_THRESHOLD` take the flash path, which on the card is the
Hopper kernel of :mod:`repro_torch.kernels.attention`. MLA, encoder and
cross attention are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.attention import flash_attention

from .common import Tensor, apply_rope, dense_init, softcap

NEG_INF = -2.3819763e38  # finite: avoids NaN in softmax (see kernels/attention/ref.py)


@dataclasses.dataclass(frozen=True)
class PhysPlan:
    """Physical attention layout. The port runs on one device (tp = 1):
    query and kv heads are the logical ones, with no padding or
    replication."""

    num_q: int
    num_kv: int

    @staticmethod
    def make(cfg, tp: int = 1) -> "PhysPlan":
        if tp != 1:
            raise NotImplementedError(
                "tensor parallelism is not ported (ROADMAP queue 1, item 10)")
        if cfg.use_mla:
            raise NotImplementedError("MLA attention is not ported yet (ROADMAP queue 1, item 12)")
        return PhysPlan(cfg.num_heads, cfg.num_kv_heads)


# -- parameter init -----------------------------------------------------------
def init_attention(gen, cfg, plan: PhysPlan, dtype=torch.float32, device=None) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = {"dtype": dtype, "device": device}
    p = {
        "wq": dense_init(gen, d, plan.num_q, hd, **kw),
        "wk": dense_init(gen, d, plan.num_kv, hd, **kw),
        "wv": dense_init(gen, d, plan.num_kv, hd, **kw),
        "wo": dense_init(gen, plan.num_q, hd, d, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((plan.num_q, hd), **kw)
        p["bk"] = torch.zeros((plan.num_kv, hd), **kw)
        p["bv"] = torch.zeros((plan.num_kv, hd), **kw)
    return p


def _qkv(p, cfg, x: Tensor, positions: Tensor):
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scale(cfg) -> float:
    if cfg.query_pre_attn_scalar is not None:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.resolved_head_dim ** -0.5


def _sdpa(cfg, q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """Grouped scaled-dot-product attention.

    q: [B,S,nq,hd]; k,v: [B,T,nkv,hd]; mask: bool broadcastable to [B,S,T].
    """
    nq, nkv = q.shape[2], k.shape[2]
    g = nq // nkv
    B, S = q.shape[0], q.shape[1]
    qg = q.reshape(B, S, nkv, g, q.shape[3])
    scores = torch.einsum("bsngh,btnh->bnsgt", qg * _scale(cfg), k)
    scores = softcap(scores, cfg.attn_logit_softcap)
    m5 = mask[:, None, :, None, :]  # [B?,1,S,1,T]
    scores = torch.where(m5, scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    ctx = torch.einsum("bnsgt,btnh->bsngh", probs, v)
    return ctx.reshape(B, S, nq, q.shape[3])


def causal_mask(S: int, T: int, window: int | None = None, device=None) -> Tensor:
    """[1,S,T] boolean mask; query i attends keys j with j <= i and, if
    windowed, j > i-window."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m[None]


# -- full-sequence (prefill) -----------------------------------------------------
FLASH_THRESHOLD = 2048  # sequences beyond this use the flash path


def _flash(cfg, q, k, v, *, causal: bool, window: int | None, use_kernel: bool = True):
    return flash_attention(q, k, v, _scale(cfg), causal, window, cfg.attn_logit_softcap,
                           use_kernel=use_kernel)


def attention(p, cfg, x: Tensor, positions: Tensor, *, window: int | None = None,
              return_kv: bool = False, use_kernel: bool = True):
    """Causal (optionally windowed) self-attention over a full sequence.
    Long sequences take the flash path — the dense path would materialize
    the [S,T] score matrix. ``use_kernel=False`` runs the flash path's plain
    version on the card."""
    S = x.shape[1]
    q, k, v = _qkv(p, cfg, x, positions)
    if S > FLASH_THRESHOLD:
        ctx = _flash(cfg, q, k, v, causal=True, window=window, use_kernel=use_kernel)
    else:
        ctx = _sdpa(cfg, q, k, v, causal_mask(S, S, window=window, device=x.device))
    out = torch.einsum("bsnh,nhd->bsd", ctx, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


# -- single-token decode ---------------------------------------------------------
def attention_decode(p, cfg, x: Tensor, pos: int, kcache: Tensor, vcache: Tensor,
                     *, window: int | None = None) -> Tensor:
    """One decode step with a preallocated KV cache, written in place.

    x: [B,1,d]; pos: int (synchronized batch decode); kcache/vcache:
    [B,S_max,nkv,hd]. For windowed attention the cache is a RING BUFFER of
    length ``window`` (slot = pos % window; every resident key carries its
    RoPE rotation from write time, so slot order is irrelevant to the
    softmax). The reference returns new caches; here the new key and value
    are written into ``kcache``/``vcache`` at the slot. Returns out [B,1,d].
    """
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    T = kcache.shape[1]
    kj = torch.arange(T, device=x.device)[None, None, :]
    if window is not None:
        slot = pos % T
        mask = (kj <= pos) | (pos >= T)  # ring full -> all slots live
    else:
        # as the reference's dynamic_update_slice clamps its start index:
        # a decode past the cache's end (a fully cached prompt whose stored
        # KV was not re-padded, ROADMAP F2) writes into the last slot
        slot = min(pos, T - 1)
        mask = kj <= pos
    kcache[:, slot] = k[:, 0].to(kcache.dtype)
    vcache[:, slot] = v[:, 0].to(vcache.dtype)
    ctx = _sdpa(cfg, q, kcache.to(q.dtype), vcache.to(q.dtype), mask)
    return torch.einsum("bsnh,nhd->bsd", ctx, p["wo"])
