"""Public ops of the device count-min sketch (counterpart of
``repro/kernels/cms/ops.py``: ``make_table``, ``update``, ``estimate``,
``update_estimate``, ``reset``).

Keys are ``[N]`` int32 tensors on the table's device. Unlike the JAX ops,
which return new arrays, these update the table in place and return it.
``use_kernel`` is the counterpart of the reference's ``use_pallas``: ``None``
launches the Hopper kernel for CUDA tensors and runs the plain version for
CPU tensors; ``False`` runs the plain version on either.
"""

from __future__ import annotations

import torch

from .cms import cms_estimate, cms_update, cms_update_estimate
from .ref import ROWS

__all__ = ["make_table", "update", "estimate", "update_estimate", "reset"]


def make_table(width: int, device: "torch.device | str") -> torch.Tensor:
    if width < 1 or width & (width - 1):
        raise ValueError(f"width must be a power of two, got {width}")
    return torch.zeros((ROWS, width), dtype=torch.int32, device=device)


def update(table: torch.Tensor, keys: torch.Tensor, *, cap: int = 15,
           use_kernel: bool | None = None) -> torch.Tensor:
    return cms_update(table, keys, cap=cap, use_kernel=use_kernel)


def estimate(table: torch.Tensor, keys: torch.Tensor, *,
             use_kernel: bool | None = None) -> torch.Tensor:
    return cms_estimate(table, keys, use_kernel=use_kernel)


def update_estimate(table: torch.Tensor, upd_keys: torch.Tensor, est_keys: torch.Tensor, *,
                    cap: int = 15, use_kernel: bool | None = None):
    """Fused flush + score: returns ``(table, vals[N])``, ``table`` updated
    in place — the admission data plane's one launch per decision."""
    vals = cms_update_estimate(table, upd_keys, est_keys, cap=cap, use_kernel=use_kernel)
    return table, vals


def reset(table: torch.Tensor) -> torch.Tensor:
    """TinyLFU aging: halve every counter, in place (paper §3). The JAX
    package leaves this shift to XLA outside Pallas; here it is a tensor op
    for the plain path, and a kernel inside the one C call of a staged
    flush on the card (``cms_halve_kernel``)."""
    return table.bitwise_right_shift_(1)
