"""RWKV-6 wkv6 recurrence, plain PyTorch versions.

The port's own twins of the reference's ``wkv6_scan`` and ``wkv6_chunked``
(``repro/models/rwkv.py``; the reference's ``kernels/wkv/ref.py`` only
re-exports them) and the plain version of the Hopper kernel in
``csrc/wkv6.cu``. Per head, with state ``S`` ``[K, V]``::

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

Shapes (model layout): r, k, w ``[B,T,H,K]``; v ``[B,T,H,V]``; u ``[H,K]``.
Arithmetic is float32, as in the reference; ``o`` is returned in ``r``'s
type and the final state ``[B,H,K,V]`` in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "wkv6_scan", "wkv6_chunked"]

#: The reference model's chunk (``repro/models/rwkv.py::CHUNK``).
CHUNK = 32


def wkv6_scan(r, k, v, w, u, S0=None, return_state: bool = False):
    """Naive stepwise oracle. Returns o (and the final state if asked)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device) if S0 is None
         else S0.float())
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # [B,H,K,V]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    o = (torch.stack(outs, 1) if T else vf.new_zeros((B, 0, H, V))).to(r.dtype)
    return (o, S) if return_state else o


def wkv6_chunked(r, k, v, w, u, chunk: int = CHUNK, return_state: bool = False):
    """Chunked (block-parallel) wkv6, the algorithm the kernel implements.

    Within a chunk, decays are applied in log space (log w <= 0, so every
    relative decay factor is <= 1); across chunks a ``[B,H,K,V]`` state is
    carried by a loop. T is padded to the chunk with zeros for r, k, v and
    1.0 for w, so the padding neither decays nor feeds the state.
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    pad = (-T) % chunk
    if pad:
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = r.shape[1] // chunk

    def resh(x):  # [B,T,H,*] -> [n,B,H,C,*]
        return x.float().reshape(B, n, chunk, H, x.shape[-1]).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    logw = torch.log(torch.clamp(wc, min=1e-12))
    cum = torch.cumsum(logw, dim=3)  # inclusive over chunk positions
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    uf = u.float()[None, :, None, :]
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    outs = []
    for i in range(n):
        rt, kt, vt, cumt = rc[i], kc[i], vc[i], cum[i]
        cprev = cumt - logw[i]  # cum[t-1], exclusive; <= 0
        total = cumt[:, :, -1:, :]  # [B,H,1,K]
        o_inter = torch.einsum("bhck,bhkv->bhcv", rt * torch.exp(cprev), S)
        # intra-chunk, strictly lower triangular: the relative decay
        # exp(cprev[t] - cum[s]) pairwise per k-channel, an exponent <= 0
        # for s < t (a two-factor form r·exp(cprev) x k·exp(-cum) overflows
        # for strong decays)
        delta = cprev[:, :, :, None, :] - cumt[:, :, None, :, :]  # [B,H,C,C,K]
        pair = torch.exp(torch.where(tri[None, None, :, :, None], delta,
                                     torch.tensor(float("-inf"), device=r.device)))
        scores = torch.einsum("bhck,bhdk,bhcdk->bhcd", rt, kt, pair)
        o_intra = torch.einsum("bhcd,bhdv->bhcv", scores, vt)
        bonus = (rt * uf * kt).sum(-1, keepdim=True)  # the current token's (r ⊙ u ⊙ k)·v
        outs.append(o_inter + o_intra + bonus * vt)
        S = torch.exp(total[:, :, 0, :])[..., None] * S + torch.einsum(
            "bhck,bhcv->bhkv", kt * torch.exp(total - cumt), vt)
    o = torch.stack(outs, 0).permute(1, 0, 3, 2, 4).reshape(B, n * chunk, H, V)[:, :T]
    o = o.to(r.dtype)
    return (o, S) if return_state else o
