"""Flash attention, plain PyTorch versions (forward only).

The port's counterpart of the reference's ``repro/kernels/attention/ref.py``
and the plain version of the Hopper kernel in ``csrc/flash_fwd.cu``:

* :func:`flash_attention_ref` — chunked online-softmax attention; never
  materializes the ``[S, T]`` score matrix, only ``[S, chunk]`` at a time;
* :func:`attention_dense_ref` — the naive O(S·T) oracle.

Both support GQA (q heads grouped over kv heads), causal and sliding-window
masks, and gemma2-style tanh score soft-capping. Arithmetic is float32 (the
inputs are cast up front, as the kernel does); the output is in ``q``'s
type. The backward (the reference's recomputation VJP) comes with training.

Shapes (model layout): q ``[B,S,nq,hd]``; k ``[B,T,nkv,hd]``;
v ``[B,T,nkv,hd_v]`` with ``nq % nkv == 0``.
"""

from __future__ import annotations

import torch

#: Finite, as in the reference: a row whose first kv chunks are all masked
#: gets ``exp(0) = 1`` rubbish, which ``exp(NEG_INF - m_real) = 0`` wipes
#: exactly once a live key arrives; ``-inf`` would give NaN there instead.
NEG_INF = -2.3819763e38
DEFAULT_CHUNK = 1024


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int | None,
          t_real: int) -> torch.Tensor:
    """``[S, C]`` boolean mask for one kv chunk."""
    m = (kpos < t_real)[None, :].expand(qpos.shape[0], -1)
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def flash_attention_ref(q, k, v, scale, causal=True, window=None, softcap=None,
                        chunk=DEFAULT_CHUNK):
    """Chunked online-softmax attention; returns ``[B,S,nq,hd_v]``."""
    B, S, nq, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    hd_v = v.shape[3]
    g = nq // nkv
    C = min(chunk, T)
    qg = q.float().reshape(B, S, nkv, g, hd)
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, nkv, S, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nkv, S, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nkv, S, g, hd_v), dtype=torch.float32, device=q.device)
    for start in range(0, T, C):
        kci = k[:, start:start + C].float()
        vci = v[:, start:start + C].float()
        s = torch.einsum("bsngh,bcnh->bnsgc", qg, kci) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        kpos = start + torch.arange(kci.shape[1], device=q.device)
        msk = _mask(qpos, kpos, causal, window, T)
        s = torch.where(msk[None, None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bnsgc,bcnh->bnsgh", p, vci)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).transpose(1, 2).reshape(B, S, nq, hd_v)
    return out.to(q.dtype)


def attention_dense_ref(q, k, v, scale, causal=True, window=None, softcap=None):
    """Naive O(S·T) oracle used by the kernel tests."""
    B, S, nq, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    hd_v = v.shape[3]
    g = nq // nkv
    qg = q.float().reshape(B, S, nkv, g, hd)
    s = torch.einsum("bsngh,btnh->bnsgt", qg, k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    m = _mask(torch.arange(S, device=q.device), torch.arange(T, device=q.device),
              causal, window, T)
    s = torch.where(m[None, None, :, None, :], s, NEG_INF)
    p = torch.softmax(s, -1)
    o = torch.einsum("bnsgt,btnh->bnsgh", p, v.float())
    return o.transpose(1, 2).reshape(B, S, nq, hd_v).to(q.dtype)
