"""RWKV-6 "Finch" [arXiv:2404.05892]: attention-free time-mix with
data-dependent decay (wkv6) + channel-mix, with full-sequence and
single-step decode paths.

The port's counterpart of the reference's ``repro/models/rwkv.py``, with
its names, constants and parameter keys. Time-mix recurrence per head
(state S: [dk, dv])::

    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t
    o_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)

``w_t`` is data-dependent (ddlerp + LoRA). The full-sequence path
(``chunked=True``) goes through :func:`repro_torch.kernels.wkv.ops.wkv6`:
on the card that is the Hopper wkv6 kernel; on the CPU, or with
``use_kernel=False``, the chunked plain version at ``CHUNK``, as the
reference model computes it. ``chunked=False`` runs the stepwise scan.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv.ops import wkv6
from repro_torch.kernels.wkv.ref import CHUNK, wkv6_scan

from .common import Tensor, dense_init

__all__ = ["CHUNK", "LORA_R", "init_rwkv_block", "rwkv_block", "rwkv_decode"]

LORA_R = 32


def init_rwkv_block(gen: torch.Generator, cfg, dtype=torch.float32, device=None) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    device = device if device is not None else gen.device

    def draw(fn, *shape):  # on the generator's device, then placed on ``device``
        return fn(shape, generator=gen, device=gen.device).to(device)

    def mix(rows):
        return (draw(torch.rand, rows, d) * 0.5 + 0.25).to(dtype)

    return {
        # time-mix
        "mu": mix(5),  # ddlerp base mixes for r,k,v,w,g
        "ddlerp_w1": dense_init(gen, d, 5 * LORA_R, dtype=dtype, device=device),
        "ddlerp_w2": _stack5(draw, LORA_R, d, dtype),
        "w_r": dense_init(gen, d, d, dtype=dtype, device=device),
        "w_k": dense_init(gen, d, d, dtype=dtype, device=device),
        "w_v": dense_init(gen, d, d, dtype=dtype, device=device),
        "w_g": dense_init(gen, d, d, dtype=dtype, device=device),
        "w_o": dense_init(gen, d, d, dtype=dtype, device=device),
        "decay_base": torch.full((d,), -6.0, dtype=dtype, device=device),  # w ~ 0.9975
        "decay_w1": dense_init(gen, d, LORA_R * 2, dtype=dtype, device=device),
        "decay_w2": dense_init(gen, LORA_R * 2, d, dtype=dtype, device=device),
        "bonus_u": (draw(torch.randn, H, hd) * 0.1).to(dtype),
        "ln_x_scale": torch.ones((d,), dtype=dtype, device=device),  # per-head group norm
        # channel-mix
        "cm_mu": mix(2),
        "cm_k": dense_init(gen, d, cfg.d_ff, dtype=dtype, device=device),
        "cm_v": dense_init(gen, cfg.d_ff, d, dtype=dtype, device=device),
        "cm_r": dense_init(gen, d, d, dtype=dtype, device=device),
    }


def _stack5(draw, r: int, d: int, dtype) -> Tensor:
    return (draw(torch.randn, 5, r, d) * (r ** -0.5)).to(dtype)


# -- block application ---------------------------------------------------------
def _ddlerp(p, x: Tensor, x_prev: Tensor):
    """Data-dependent token-shift interpolation producing r,k,v,w,g inputs.

    RWKV6 ddlerp: z_i = x + delta * (mu_i + lora_i(x + delta*mu_base))."""
    delta = x_prev - x
    mix = x + delta * p["mu"][0]
    lora = (torch.tanh(mix) @ p["ddlerp_w1"]).reshape(*x.shape[:-1], 5, LORA_R)
    return [x + delta * (p["mu"][i] + lora[..., i, :] @ p["ddlerp_w2"][i]) for i in range(5)]


def _decay(p, xw: Tensor) -> Tensor:
    """w = exp(-exp(decay_base + lora(xw))) in (0, 1), float32."""
    logit = p["decay_base"] + torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    return torch.exp(-torch.exp(logit.float()))


def _time_mix(p, cfg, x: Tensor, x_prev: Tensor, wkv_fn, return_state: bool = False):
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = (xr @ p["w_r"]).reshape(B, S, H, hd)
    k = (xk @ p["w_k"]).reshape(B, S, H, hd)
    v = (xv @ p["w_v"]).reshape(B, S, H, hd)
    g = F.silu(xg @ p["w_g"])
    w = _decay(p, xw)
    out = wkv_fn(r, k, v, w.reshape(B, S, H, hd), p["bonus_u"], return_state)
    o, S_final = out if return_state else (out, None)
    o = _group_norm(o.reshape(B, S, d), H, p["ln_x_scale"])
    o = (o * g) @ p["w_o"]
    return (o, S_final) if return_state else o


def _group_norm(x: Tensor, groups: int, scale: Tensor, eps: float = 1e-5) -> Tensor:
    B, S, d = x.shape
    xg = x.reshape(B, S, groups, d // groups).float()
    mu = xg.mean(-1, keepdim=True)
    var = ((xg - mu) ** 2).mean(-1, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(B, S, d)
    return (y * scale).to(x.dtype)


def _channel_mix(p, x: Tensor, x_prev: Tensor) -> Tensor:
    xk = x + (x_prev - x) * p["cm_mu"][0]
    xr = x + (x_prev - x) * p["cm_mu"][1]
    kk = torch.square(F.relu(xk @ p["cm_k"]))
    rr = torch.sigmoid(xr @ p["cm_r"])
    return rr * (kk @ p["cm_v"])


def _shift(x: Tensor) -> Tensor:
    """x_prev[t] = x[t-1] (zeros at t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv_block(p, cfg, x_tm_in: Tensor, x_cm_in: Tensor, chunked: bool = True,
               return_state: bool = False, *, use_kernel: bool = True):
    """Full-sequence RWKV block pieces: returns (tm_out, cm_out[, state])
    given the *normalized* inputs to each sub-layer (residual wiring in
    blocks.py). ``state`` matches the rwkv_decode state dict."""
    if chunked:
        def wkv_fn(r, k, v, w, u, rs):
            return wkv6(r, k, v, w, u, chunk=CHUNK, return_state=rs, use_kernel=use_kernel)
    else:
        def wkv_fn(r, k, v, w, u, rs):
            return wkv6_scan(r, k, v, w, u, return_state=rs)
    cm = _channel_mix(p, x_cm_in, _shift(x_cm_in))
    if not return_state:
        return _time_mix(p, cfg, x_tm_in, _shift(x_tm_in), wkv_fn), cm
    tm, S = _time_mix(p, cfg, x_tm_in, _shift(x_tm_in), wkv_fn, return_state=True)
    return tm, cm, {"S": S, "tm_prev": x_tm_in[:, -1], "cm_prev": x_cm_in[:, -1]}


# -- decode ------------------------------------------------------------------------
def rwkv_decode(p, cfg, x_tm_in: Tensor, x_cm_in: Tensor, state: dict):
    """Single-token step, plain PyTorch. state: {"S": [B,H,K,V] float32,
    "tm_prev": [B,d], "cm_prev": [B,d]}. Inputs are [B,1,d] normalized
    sub-layer inputs. Returns (tm_out, cm_out, new_state); ``state`` is not
    written."""
    B, _, d = x_tm_in.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    xr, xk, xv, xw, xg = _ddlerp(p, x_tm_in, state["tm_prev"][:, None, :])
    r = (xr @ p["w_r"]).reshape(B, H, hd).float()
    k = (xk @ p["w_k"]).reshape(B, H, hd).float()
    v = (xv @ p["w_v"]).reshape(B, H, hd).float()
    g = F.silu(xg @ p["w_g"])[:, 0]
    w = _decay(p, xw).reshape(B, H, hd)
    S = state["S"]
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r, S + p["bonus_u"].float()[None, :, :, None] * kv)
    S = w[..., None] * S + kv
    o = _group_norm(o.reshape(B, 1, d).to(x_tm_in.dtype), H, p["ln_x_scale"])[:, 0]
    tm_out = ((o * g) @ p["w_o"])[:, None]
    cm_out = _channel_mix(p, x_cm_in, state["cm_prev"][:, None, :])
    return tm_out, cm_out, {"S": S, "tm_prev": x_tm_in[:, 0], "cm_prev": x_cm_in[:, 0]}
