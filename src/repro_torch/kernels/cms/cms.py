"""Hopper kernels of the count-min sketch: build, bind and wrappers.

``csrc/cms.cu`` holds three hand-written CUDA kernels for ``sm_90a`` that
replace the Pallas kernels of ``repro/kernels/cms/cms.py`` (the source says
how each is designed and what bounds it). At first use :func:`load_library`
compiles them with ``nvcc`` (:mod:`repro_torch.kernels._nvcc`) into a shared
library with a plain C interface under ``_build/`` beside this file (listed
in ``.gitignore``) and loads it with ``ctypes``. Importing this module
needs neither ``nvcc`` nor a card.

Each wrapper checks its tensors and then

* for CUDA tensors launches its kernel on the current stream, without
  synchronising, and adds one to its ``launches`` count; a refused launch
  raises. It runs the plain version on the card only when the caller passes
  ``use_kernel=False``;
* for CPU tensors runs the plain version of :mod:`.ref`; ``use_kernel=True``
  with a CPU tensor raises.

The table is updated in place, where the JAX reference returns a new array.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import kernel_wanted
from .._nvcc import build_library
from .ref import ROWS, cms_estimate_ref, cms_update_estimate_ref, cms_update_ref

__all__ = [
    "FUSED_MAX_UPDATES",
    "load_library",
    "cms_update",
    "cms_estimate",
    "cms_update_estimate",
    "reset_launch_counts",
    "launch_counts",
]

#: The fused kernel is one CTA; the sketch takes it only while the pending
#: increments fit one flush block (``CMSSketch.flush_block`` = 512).
FUSED_MAX_UPDATES = 512

_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library("cms", pathlib.Path(__file__).parent)))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.cms_update_launch.argtypes = [p, i64, p, i64, i32, p]
        lib.cms_estimate_launch.argtypes = [p, i64, p, i64, p, p]
        lib.cms_update_estimate_launch.argtypes = [p, i64, p, i64, p, i64, i32, p, p]
        for fn in (lib.cms_update_launch, lib.cms_estimate_launch, lib.cms_update_estimate_launch):
            fn.restype = i32
        lib.cms_error_string.argtypes = [i32]
        lib.cms_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(table: torch.Tensor, *keys: torch.Tensor) -> None:
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != ROWS:
        raise ValueError(f"table must be [{ROWS}, W] int32, got {tuple(table.shape)} {table.dtype}")
    width = table.shape[1]
    if width < 1 or width & (width - 1):
        raise ValueError(f"table width must be a power of two, got {width}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    for k in keys:
        if k.dtype != torch.int32 or k.dim() != 1 or not k.is_contiguous():
            raise ValueError(f"keys must be contiguous [N] int32, got {tuple(k.shape)} {k.dtype}")
        if k.device != table.device:
            raise ValueError(f"keys on {k.device}, table on {table.device}")


def _raise_if(code: int, what: str) -> None:
    if code != 0:
        msg = load_library().cms_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cms_update(table: torch.Tensor, keys: torch.Tensor, *, cap: int = 15,
               use_kernel: bool | None = None) -> torch.Tensor:
    """Saturating increment of every key's 4 cells, in place. Returns ``table``."""
    _check(table, keys)
    if not kernel_wanted(table, use_kernel):
        table.copy_(cms_update_ref(table, keys, cap=cap))
        return table
    n = keys.numel()
    if n:
        code = load_library().cms_update_launch(
            table.data_ptr(), table.shape[1], keys.data_ptr(), n, cap, _stream(table))
        _raise_if(code, "cms_update")
        cms_update.launches += 1
    return table


def cms_estimate(table: torch.Tensor, keys: torch.Tensor, *,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """``[N]`` int32 min-over-rows estimates of ``keys``."""
    _check(table, keys)
    if not kernel_wanted(table, use_kernel):
        return cms_estimate_ref(table, keys)
    n = keys.numel()
    out = torch.empty(n, dtype=torch.int32, device=table.device)
    if n:
        code = load_library().cms_estimate_launch(
            table.data_ptr(), table.shape[1], keys.data_ptr(), n, out.data_ptr(),
            _stream(table))
        _raise_if(code, "cms_estimate")
        cms_estimate.launches += 1
    return out


def cms_update_estimate(table: torch.Tensor, upd_keys: torch.Tensor, est_keys: torch.Tensor,
                        *, cap: int = 15, use_kernel: bool | None = None) -> torch.Tensor:
    """Apply ``upd_keys`` in place, then return the ``[N]`` int32 estimates
    of ``est_keys`` on the updated table, in one launch."""
    _check(table, upd_keys, est_keys)
    m, n = upd_keys.numel(), est_keys.numel()
    if m > FUSED_MAX_UPDATES:
        raise ValueError(f"fused update takes at most {FUSED_MAX_UPDATES} keys, got {m}")
    if not kernel_wanted(table, use_kernel):
        new_table, vals = cms_update_estimate_ref(table, upd_keys, est_keys, cap=cap)
        table.copy_(new_table)
        return vals
    out = torch.empty(n, dtype=torch.int32, device=table.device)
    if m or n:
        code = load_library().cms_update_estimate_launch(
            table.data_ptr(), table.shape[1], upd_keys.data_ptr(), m, est_keys.data_ptr(), n,
            cap, out.data_ptr(), _stream(table))
        _raise_if(code, "cms_update_estimate")
        cms_update_estimate.launches += 1
    return out


_WRAPPERS = (cms_update, cms_estimate, cms_update_estimate)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
