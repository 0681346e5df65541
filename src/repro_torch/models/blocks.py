"""Layer definitions and the per-segment layer loops.

The port's counterpart of the reference's ``repro/models/blocks.py`` for
the attention kinds ``dense`` (global attention + FFN) and ``dense_local``
(windowed attention + FFN) and the recurrent kind ``rwkv`` (RWKV-6
time-mix + channel-mix, :mod:`.rwkv`). A model is a list of homogeneous
segments (``configs.base.layer_plan``); each segment stores its per-layer
params stacked on a leading ``[repeat]`` axis, as in the reference, and a
Python loop over the layers takes the place of ``lax.scan``. The
reference's sharding constraints (``maybe_constrain``) do nothing on one
device and are left out. Every other sub-layer kind raises
``NotImplementedError`` that names its ROADMAP item.
"""

from __future__ import annotations

import torch

from .attention import PhysPlan, attention, attention_decode, init_attention
from .common import Tensor, apply_ffn, apply_norm, init_ffn, init_norm
from .rwkv import init_rwkv_block, rwkv_block, rwkv_decode

PORTED_KINDS = ("dense", "dense_local", "rwkv")
_UNPORTED = {
    "moe": "MoE (ROADMAP queue 1, item 12)",
    "mla_dense": "MLA (ROADMAP queue 1, item 12)",
    "mla_moe": "MLA and MoE (ROADMAP queue 1, item 12)",
    "rglru": "the Griffin recurrent block (ROADMAP queue 1, item 12)",
    "enc": "the encoder-decoder kinds (ROADMAP queue 1, item 12)",
    "dec": "the encoder-decoder kinds (ROADMAP queue 1, item 12)",
}


def check_kind(kind: str) -> None:
    if kind in PORTED_KINDS:
        return
    if kind in _UNPORTED:
        raise NotImplementedError(f"sub-layer kind {kind!r}: {_UNPORTED[kind]} is not ported yet")
    raise ValueError(f"unknown sublayer kind {kind}")


def layer(tree, r: int):
    """Layer ``r`` of a segment's stacked params or caches (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_sublayer(gen, cfg, kind: str, plan: PhysPlan, dtype, device=None) -> dict:
    check_kind(kind)
    if kind == "rwkv":
        return {
            "norm1": init_norm(cfg, dtype, device),
            "rwkv": init_rwkv_block(gen, cfg, dtype, device),
            "norm2": init_norm(cfg, dtype, device),
        }
    return {
        "norm1": init_norm(cfg, dtype, device),
        "attn": init_attention(gen, cfg, plan, dtype, device),
        "norm2": init_norm(cfg, dtype, device),
        "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_act, dtype, device),
    }


def _fill(dst, src, r: int) -> None:
    """Copy one layer's tree into slot ``r`` of the stacked tree."""
    if isinstance(src, dict):
        for k in src:
            _fill(dst[k], src[k], r)
    else:
        dst[r].copy_(src)


def _empty_stack(tree, repeat: int):
    if isinstance(tree, dict):
        return {k: _empty_stack(v, repeat) for k, v in tree.items()}
    return tree.new_empty((repeat, *tree.shape))


def init_segment(gen, cfg, seg, plan: PhysPlan, dtype, device=None) -> dict:
    """Params of ``seg.repeat`` super-blocks, stacked on a leading axis.
    Layers are drawn one after another and copied into preallocated
    stacked tensors, so the parameters are never held twice."""
    def superblock():
        return {str(i): init_sublayer(gen, cfg, kind, plan, dtype, device)
                for i, kind in enumerate(seg.kinds)}

    first = superblock()
    stacked = _empty_stack(first, seg.repeat)
    _fill(stacked, first, 0)
    del first
    for r in range(1, seg.repeat):
        _fill(stacked, superblock(), r)
    return stacked


# ---------------------------------------------------------------------------
# full-sequence application (prefill)
# ---------------------------------------------------------------------------
def apply_sublayer(p, cfg, kind: str, x: Tensor, positions: Tensor, *,
                   collect_kv: bool = False, use_kernel: bool = True):
    """Returns (x, kv_or_state_or_None); with ``collect_kv`` the second
    return is the sub-layer's decode-cache payload: (k, v) for the attention
    kinds, the recurrent state dict ``{"S", "tm_prev", "cm_prev"}`` for
    ``rwkv``."""
    check_kind(kind)
    h = apply_norm(p["norm1"], x)
    if kind == "rwkv":
        h2 = apply_norm(p["norm2"], x)
        if collect_kv:
            tm, cm, state = rwkv_block(p["rwkv"], cfg, h, h2, return_state=True,
                                       use_kernel=use_kernel)
            return x + tm + cm, state
        tm, cm = rwkv_block(p["rwkv"], cfg, h, h2, use_kernel=use_kernel)
        return x + tm + cm, None
    window = cfg.local_window if kind == "dense_local" else None
    a, kv = attention(p["attn"], cfg, h, positions, window=window, return_kv=True,
                      use_kernel=use_kernel)
    if not collect_kv:
        kv = None
    if cfg.parallel_block:
        f = apply_ffn(p["ffn"], h, cfg.ffn_act)  # same norm input (Cohere)
        return x + a + f, kv
    x = x + a
    x = x + apply_ffn(p["ffn"], apply_norm(p["norm2"], x), cfg.ffn_act)
    return x, kv


def apply_superblock(p, cfg, kinds, x, positions, **kw):
    kvs = {}
    for i, kind in enumerate(kinds):
        x, kv = apply_sublayer(p[str(i)], cfg, kind, x, positions, **kw)
        if kv is not None:
            kvs[str(i)] = kv
    return x, kvs


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------
def init_sublayer_cache(cfg, kind: str, plan: PhysPlan, repeat: int, batch: int, max_seq: int,
                        dtype, device=None) -> dict:
    """Zeros for ``repeat`` layers of ``kind``: ``{"k", "v": [repeat, batch,
    S, nkv, hd]}`` for the attention kinds, with S the window for
    ``dense_local`` (a ring buffer); for ``rwkv`` the recurrent state
    ``{"S": [repeat, batch, H, hd, hd]}`` in float32 whatever ``dtype``, and
    ``{"tm_prev", "cm_prev": [repeat, batch, d_model]}`` in ``dtype``."""
    check_kind(kind)
    if kind == "rwkv":
        H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {"S": torch.zeros((repeat, batch, H, hd, hd), dtype=torch.float32, device=device),
                "tm_prev": torch.zeros((repeat, batch, cfg.d_model), dtype=dtype, device=device),
                "cm_prev": torch.zeros((repeat, batch, cfg.d_model), dtype=dtype, device=device)}
    S = min(max_seq, cfg.local_window) if kind == "dense_local" else max_seq
    shape = (repeat, batch, S, plan.num_kv, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_segment_cache(cfg, seg, plan, batch, max_seq, dtype, device=None) -> dict:
    return {str(i): init_sublayer_cache(cfg, kind, plan, seg.repeat, batch, max_seq, dtype,
                                        device)
            for i, kind in enumerate(seg.kinds)}


# ---------------------------------------------------------------------------
# single-token decode
# ---------------------------------------------------------------------------
def decode_sublayer(p, cache, cfg, kind: str, x: Tensor, pos: int) -> Tensor:
    """x: [B,1,d]. Writes this position's K/V (or, for ``rwkv``, the new
    recurrent state) into ``cache`` in place."""
    h = apply_norm(p["norm1"], x)
    if kind == "rwkv":
        tm, cm, state = rwkv_decode(p["rwkv"], cfg, h, apply_norm(p["norm2"], x), cache)
        for name, value in state.items():
            cache[name].copy_(value)
        return x + tm + cm
    window = cfg.local_window if kind == "dense_local" else None
    a = attention_decode(p["attn"], cfg, h, pos, cache["k"], cache["v"], window=window)
    if cfg.parallel_block:
        f = apply_ffn(p["ffn"], h, cfg.ffn_act)
        return x + a + f
    x = x + a
    return x + apply_ffn(p["ffn"], apply_norm(p["norm2"], x), cfg.ffn_act)


def scan_segment_decode(seg_params, seg_caches, cfg, seg, x, pos: int) -> Tensor:
    for r in range(seg.repeat):
        lp, lc = layer(seg_params, r), layer(seg_caches, r)
        for i, kind in enumerate(seg.kinds):
            x = decode_sublayer(lp[str(i)], lc[str(i)], cfg, kind, x, pos)
    return x
