"""Plain PyTorch versions of the count-min-sketch kernels.

The semantics are those of the device sketch of the reference package
(``repro/kernels/cms/ref.py``):

* 4 rows, width a power of two;
* Kirsch-Mitzenmacher double hashing ``(h1 + r*h2) & (W-1)`` from two
  32-bit murmur3 finalizers of the int32 key;
* batched, non-conservative increment: every key of a batch is applied at
  once (duplicate keys sum) and counters saturate at ``cap``;
* estimate = min over the 4 rows.

PyTorch on the CPU has no ``>>`` or ``*`` for ``uint32``, so the 32-bit hash
is computed in int64 and masked to 32 bits after each step: the product of
two values below 2**32 wraps mod 2**64 and its low 32 bits stay exact.

These functions are what a kernel wrapper in :mod:`.cms` runs for a CPU
tensor (and on the card only when the caller passes ``use_kernel=False``),
and what the kernels are held against.
"""

from __future__ import annotations

import torch

__all__ = [
    "ROWS",
    "mix32",
    "row_indexes",
    "cms_update_ref",
    "cms_estimate_ref",
    "cms_update_estimate_ref",
]

ROWS = 4
_M32 = 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over int64 tensors holding uint32 values."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def row_indexes(keys: torch.Tensor, width: int) -> torch.Tensor:
    """keys ``[N]`` int32 -> ``[ROWS, N]`` int64 column indexes."""
    u = keys.to(torch.int64) & _M32  # int32 -> uint32, two's complement
    h = mix32(torch.stack((u, u ^ 0x9E3779B9)))  # both hashes in one pass
    h1, h2 = h[0], h[1] | 1
    r = torch.arange(ROWS, dtype=torch.int64, device=keys.device)[:, None]
    return (h1 + r * h2) & (width - 1)


def cms_update_ref(table: torch.Tensor, keys: torch.Tensor, cap: int = 15) -> torch.Tensor:
    """table ``[ROWS, W]`` int32; keys ``[N]`` int32. Returns a new table:
    ``min(table + counts, cap)``, duplicate keys summed."""
    width = table.shape[1]
    idx = row_indexes(keys, width)
    cells = (idx + torch.arange(ROWS, device=table.device)[:, None] * width).flatten()
    counts = torch.bincount(cells, minlength=ROWS * width).view(ROWS, width)
    return torch.clamp(table + counts, max=cap).to(table.dtype)


def cms_estimate_ref(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Returns ``[N]`` int32 min-over-rows estimates."""
    idx = row_indexes(keys, table.shape[1])
    rows = torch.arange(ROWS, device=table.device)[:, None]
    return table[rows, idx].min(0).values


def cms_update_estimate_ref(table: torch.Tensor, upd_keys: torch.Tensor,
                            est_keys: torch.Tensor, cap: int = 15):
    """Apply ``upd_keys``, then estimate ``est_keys`` on the updated table.
    Returns ``(new_table, estimates[N])``."""
    new_table = cms_update_ref(table, upd_keys, cap=cap)
    return new_table, cms_estimate_ref(new_table, est_keys)
