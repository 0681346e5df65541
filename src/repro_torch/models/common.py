"""Shared model building blocks: norms, RoPE, initializers, FFNs.

The port's counterpart of the reference's ``repro/models/common.py``.
Models are functional: params are nested dicts of tensors, created by
``init_*`` functions and consumed by plain ``apply`` functions. Layer stacks
are stored with a leading ``[repeat]`` dim, as in the reference, and walked
layer by layer (see blocks.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# -- initializers -----------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, *out_dims: int, scale: float = 1.0,
               dtype=torch.float32, device=None) -> Tensor:
    """Normal weights with the reference's ``std = scale / sqrt(in_dim)``,
    drawn from ``gen`` on its own device and placed on ``device``."""
    std = scale / (in_dim ** 0.5)
    w = torch.randn((in_dim, *out_dims), generator=gen, device=gen.device) * std
    return w.to(device=device if device is not None else gen.device, dtype=dtype)


# -- norms -------------------------------------------------------------------
def init_norm(cfg, dtype=torch.float32, device=None) -> dict:
    scale = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    if cfg.norm == "layernorm":
        return {"scale": scale, "bias": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    return {"scale": scale}


def apply_norm(p: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# -- RoPE ---------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim/2]


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int).

    Angles are float32 products ``position * freq`` in the reference's
    order, so they agree with it bit for bit at thousands of positions."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)  # [hd/2]
    angles = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- soft capping (gemma2) -----------------------------------------------------
def softcap(x: Tensor, cap: float | None) -> Tensor:
    if cap is None:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)


# -- FFN -----------------------------------------------------------------------
def init_ffn(gen, d_model: int, d_ff: int, act: str, dtype=torch.float32, device=None) -> dict:
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
         "w_out": dense_init(gen, d_ff, d_model, dtype=dtype, device=device)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype=dtype, device=device)
    return p


def apply_ffn(p: dict, x: Tensor, act: str) -> Tensor:
    h = x @ p["w_in"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif act == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * h  # jax.nn.gelu's default
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_out"]


# -- embeddings -----------------------------------------------------------------
def init_embed(gen, cfg, dtype=torch.float32, device=None) -> dict:
    p = {"table": dense_init(gen, cfg.padded_vocab, cfg.d_model, dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype=dtype, device=device)
    return p


def embed_tokens(p: dict, tokens: Tensor) -> Tensor:
    return p["table"][tokens]


def lm_logits(p: dict, x: Tensor, cfg) -> Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["table"].T
    else:
        logits = x @ p["lm_head"]
    return softcap(logits, cfg.final_logit_softcap)
