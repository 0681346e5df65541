"""Layer definitions and the per-segment layer loops.

The port's counterpart of the reference's ``repro/models/blocks.py`` for
the attention kinds ``dense`` (global attention + FFN) and ``dense_local``
(windowed attention + FFN). A model is a list of homogeneous segments
(``configs.base.layer_plan``); each segment stores its per-layer params
stacked on a leading ``[repeat]`` axis, as in the reference, and a Python
loop over the layers takes the place of ``lax.scan``. The reference's
sharding constraints (``maybe_constrain``) do nothing on one device and are
left out. Every other sub-layer kind raises ``NotImplementedError`` that
names its ROADMAP item.
"""

from __future__ import annotations

import torch

from .attention import PhysPlan, attention, attention_decode, init_attention
from .common import Tensor, apply_ffn, apply_norm, init_ffn, init_norm

PORTED_KINDS = ("dense", "dense_local")
_UNPORTED = {
    "moe": "MoE (ROADMAP queue 1, item 12)",
    "mla_dense": "MLA (ROADMAP queue 1, item 12)",
    "mla_moe": "MLA and MoE (ROADMAP queue 1, item 12)",
    "rglru": "the Griffin recurrent block (ROADMAP queue 1, item 12)",
    "rwkv": "RWKV-6 (ROADMAP queue 1, item 12)",
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
    return {
        "norm1": init_norm(cfg, dtype, device),
        "attn": init_attention(gen, cfg, plan, dtype, device),
        "norm2": init_norm(cfg, dtype, device),
        "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_act, dtype, device),
    }


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_segment(gen, cfg, seg, plan: PhysPlan, dtype, device=None) -> dict:
    """Params of ``seg.repeat`` super-blocks, stacked on a leading axis."""
    return _stack([
        {str(i): init_sublayer(gen, cfg, kind, plan, dtype, device)
         for i, kind in enumerate(seg.kinds)}
        for _ in range(seg.repeat)
    ])


# ---------------------------------------------------------------------------
# full-sequence application (prefill)
# ---------------------------------------------------------------------------
def apply_sublayer(p, cfg, kind: str, x: Tensor, positions: Tensor, *,
                   collect_kv: bool = False, use_kernel: bool = True):
    """Returns (x, kv_or_None); with ``collect_kv`` the second return is the
    sub-layer's decode-cache payload (k, v)."""
    check_kind(kind)
    h = apply_norm(p["norm1"], x)
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
    """``{"k", "v": [repeat, batch, S, nkv, hd]}`` zeros for ``repeat``
    layers of ``kind``; S is the window for ``dense_local`` (a ring buffer)."""
    check_kind(kind)
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
    """x: [B,1,d]. Writes this position's K/V into ``cache`` in place."""
    h = apply_norm(p["norm1"], x)
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
