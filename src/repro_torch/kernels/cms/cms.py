"""Hopper kernels of the count-min sketch: build, bind and wrappers.

``csrc/cms.cu`` holds three hand-written CUDA kernels for ``sm_90a`` that
replace the Pallas kernels of ``repro/kernels/cms/cms.py`` (the source says
how each is designed and what bounds it). At first use :func:`load_library`
compiles them with ``nvcc`` (:mod:`repro_torch.kernels._nvcc`) into a shared
library with a plain C interface under ``_build/`` beside this file (listed
in ``.gitignore``) and loads it with ``ctypes``. Importing this module
needs neither ``nvcc`` nor a card.

Each tensor wrapper checks its tensors and then

* for CUDA tensors launches its kernel on the current stream, without
  synchronising, and adds one to its ``launches`` count; a refused launch
  raises. It runs the plain version on the card only when the caller passes
  ``use_kernel=False``;
* for CPU tensors runs the plain version of :mod:`.ref`; ``use_kernel=True``
  with a CPU tensor raises.

:class:`Staging` is the sketch's own way to the same kernels: numpy keys in,
numpy estimates out, one C call per sketch call through pinned buffers it
owns. Its launches count on the same wrappers' ``launches`` (the halving at
an aging reset, which replaces no Pallas kernel, is not counted).

The table is updated in place, where the JAX reference returns a new array.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np
import torch

from .. import kernel_wanted
from .._nvcc import build_library
from .ref import ROWS, cms_estimate_ref, cms_update_estimate_ref, cms_update_ref

__all__ = [
    "FUSED_MAX_UPDATES",
    "STAGING_KEYS",
    "Staging",
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
#: Keys a sketch's staging buffers hold at first: a flush block and the
#: main path's largest estimate (60 keys on full msr2) fit; a call that
#: needs more doubles them.
STAGING_KEYS = 1024

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
        lib.cms_flush_call.argtypes = [p, i64, p, p, p, i64, i32, p, p]
        lib.cms_estimate_call.argtypes = [p, i64, p, p, p, i64, i64, i32, p, p, p]
        lib.cms_update_estimate_call.argtypes = [p, i64, p, p, i64, i64, i32, p, p, p]
        for fn in (lib.cms_update_launch, lib.cms_estimate_launch, lib.cms_update_estimate_launch,
                   lib.cms_flush_call, lib.cms_estimate_call, lib.cms_update_estimate_call):
            fn.restype = i32
        lib.cms_error_string.argtypes = [i32]
        lib.cms_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(table: torch.Tensor, *keys: torch.Tensor, use_kernel: bool | None) -> bool:
    """Checks the tensors; returns whether to launch the kernel."""
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != ROWS:
        raise ValueError(f"table must be [{ROWS}, W] int32, got {tuple(table.shape)} {table.dtype}")
    width = table.shape[1]
    if width < 1 or width & (width - 1):
        raise ValueError(f"table width must be a power of two, got {width}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    device = table.device
    for k in keys:
        if k.dtype != torch.int32 or k.dim() != 1 or not k.is_contiguous():
            raise ValueError(f"keys must be contiguous [N] int32, got {tuple(k.shape)} {k.dtype}")
        if k.device != device:
            raise ValueError(f"keys on {k.device}, table on {device}")
    return kernel_wanted(table, use_kernel)


def _raise_if(code: int, what: str) -> None:
    if code != 0:
        msg = load_library().cms_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def _stream(index: int) -> int:
    """The raw handle of the current stream of device ``index``, without
    building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def cms_update(table: torch.Tensor, keys: torch.Tensor, *, cap: int = 15,
               use_kernel: bool | None = None) -> torch.Tensor:
    """Saturating increment of every key's 4 cells, in place. Returns ``table``."""
    if not _check(table, keys, use_kernel=use_kernel):
        table.copy_(cms_update_ref(table, keys, cap=cap))
        return table
    n = keys.numel()
    if n:
        code = load_library().cms_update_launch(
            table.data_ptr(), table.shape[1], keys.data_ptr(), n, cap, _stream(table.get_device()))
        _raise_if(code, "cms_update launch")
        cms_update.launches += 1
    return table


def cms_estimate(table: torch.Tensor, keys: torch.Tensor, *,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """``[N]`` int32 min-over-rows estimates of ``keys``."""
    if not _check(table, keys, use_kernel=use_kernel):
        return cms_estimate_ref(table, keys)
    n = keys.numel()
    out = torch.empty(n, dtype=torch.int32, device=table.device)
    if n:
        code = load_library().cms_estimate_launch(
            table.data_ptr(), table.shape[1], keys.data_ptr(), n, out.data_ptr(),
            _stream(table.get_device()))
        _raise_if(code, "cms_estimate launch")
        cms_estimate.launches += 1
    return out


def cms_update_estimate(table: torch.Tensor, upd_keys: torch.Tensor, est_keys: torch.Tensor,
                        *, cap: int = 15, use_kernel: bool | None = None) -> torch.Tensor:
    """Apply ``upd_keys`` in place, then return the ``[N]`` int32 estimates
    of ``est_keys`` on the updated table, in one launch."""
    launch = _check(table, upd_keys, est_keys, use_kernel=use_kernel)
    m, n = upd_keys.numel(), est_keys.numel()
    if m > FUSED_MAX_UPDATES:
        raise ValueError(f"fused update takes at most {FUSED_MAX_UPDATES} keys, got {m}")
    if not launch:
        new_table, vals = cms_update_estimate_ref(table, upd_keys, est_keys, cap=cap)
        table.copy_(new_table)
        return vals
    out = torch.empty(n, dtype=torch.int32, device=table.device)
    if m or n:
        code = load_library().cms_update_estimate_launch(
            table.data_ptr(), table.shape[1], upd_keys.data_ptr(), m, est_keys.data_ptr(), n,
            cap, out.data_ptr(), _stream(table.get_device()))
        _raise_if(code, "cms_update_estimate launch")
        cms_update_estimate.launches += 1
    return out


class Staging:
    """Pinned host and device buffers through which a CUDA sketch moves its
    keys and estimates: one C call per sketch call, on the current stream of
    the table's device.

    The int32 key buffer holds a call's keys as ``[pending | estimated]``,
    written straight into its numpy view (int64 keys truncated to int32, as
    the reference does); the C entry copies them to the device key buffer
    with ``cudaMemcpyAsync``, runs the kernels and, for an estimate, copies
    the estimates into the pinned output buffer and synchronises once. The
    buffers are allocated once and grow by doubling when a call needs more.

    Ordering: a pinned key slot is rewritten only after the copy that reads
    it has completed. An estimating call's synchronisation covers its own
    copy. A flush does not synchronise; its entry records ``_copied`` right
    after its key copy, and the next call waits on that event before it
    writes a key. The estimates are copied out of the pinned buffer before
    the call returns.
    """

    def __init__(self, table: torch.Tensor):
        self._lib = load_library()
        self.index = table.get_device()
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(table.device))  # creates the event
        self._flush_in_flight = False
        self._alloc(STAGING_KEYS, table.device)

    def _alloc(self, capacity: int, device: torch.device) -> None:
        self.capacity = capacity
        h_keys = torch.empty(capacity, dtype=torch.int32, pin_memory=True)
        h_out = torch.empty(capacity, dtype=torch.int32, pin_memory=True)
        d_keys = torch.empty(capacity, dtype=torch.int32, device=device)
        d_out = torch.empty(capacity, dtype=torch.int32, device=device)
        self._tensors = (h_keys, h_out, d_keys, d_out)  # owners of the memory
        self.keys, self.out = h_keys.numpy(), h_out.numpy()
        self._plan = np.zeros(2 * capacity, dtype=np.int64)  # a plan has <= 1 step a key
        self._h_keys, self._h_out, self._d_keys, self._d_out = (
            t.data_ptr() for t in self._tensors)
        self._plan_ptr = self._plan.ctypes.data

    def _stage(self, table: torch.Tensor, pending: list[int], keys, steps) -> tuple[int, int]:
        """Writes ``[pending | keys]`` and the plan ``steps``; returns the
        lengths of ``pending`` and ``keys``."""
        if self._flush_in_flight:
            self._copied.synchronize()
            self._flush_in_flight = False
        if torch.cuda.current_device() != self.index:
            raise ValueError(f"sketch on cuda:{self.index}, current device is "
                             f"cuda:{torch.cuda.current_device()}")
        m, n = len(pending), len(keys)
        if m + n > self.capacity:
            torch.cuda.synchronize(self.index)  # nothing in flight reads the old buffers
            capacity = self.capacity
            while capacity < m + n:
                capacity *= 2
            self._alloc(capacity, table.device)
        if m:
            self.keys[:m] = np.asarray(pending, dtype=np.int64)
        if n:
            self.keys[m:m + n] = np.asarray(keys, dtype=np.int64)
        for i, (take, reset) in enumerate(steps):
            self._plan[2 * i] = take
            self._plan[2 * i + 1] = reset
        return m, n

    def flush(self, table: torch.Tensor, cap: int, pending: list[int], steps) -> None:
        """Applies ``pending`` by the flush plan ``steps`` (see
        ``core.cms_sketch.plan_flush``), without synchronising."""
        self._stage(table, pending, (), steps)
        code = self._lib.cms_flush_call(
            table.data_ptr(), table.shape[1], self._h_keys, self._d_keys, self._plan_ptr,
            len(steps), cap, self._copied.cuda_event, _stream(self.index))
        self._flush_in_flight = True
        _raise_if(code, "cms_flush_call")
        cms_update.launches += len(steps)

    def estimate(self, table: torch.Tensor, cap: int, pending: list[int], keys, steps) -> np.ndarray:
        """Applies ``pending`` by the plan ``steps`` (which may be empty),
        then returns the int32 estimates of ``keys``."""
        m, n = self._stage(table, pending, keys, steps)
        if not m and not n:
            return np.empty(0, dtype=np.int32)
        code = self._lib.cms_estimate_call(
            table.data_ptr(), table.shape[1], self._h_keys, self._d_keys, self._plan_ptr,
            len(steps), n, cap, self._h_out, self._d_out,
            _stream(self.index))
        _raise_if(code, "cms_estimate_call")
        cms_update.launches += len(steps)
        if n:
            cms_estimate.launches += 1
        return self.out[:n].copy()

    def update_estimate(self, table: torch.Tensor, cap: int, pending: list[int], keys) -> np.ndarray:
        """Applies ``pending`` (at most ``FUSED_MAX_UPDATES`` keys, no aging
        reset due) and returns the estimates of ``keys``, in one launch."""
        if len(pending) > FUSED_MAX_UPDATES:
            raise ValueError(f"fused update takes at most {FUSED_MAX_UPDATES} keys, "
                             f"got {len(pending)}")
        m, n = self._stage(table, pending, keys, ())
        code = self._lib.cms_update_estimate_call(
            table.data_ptr(), table.shape[1], self._h_keys, self._d_keys, m, n, cap,
            self._h_out, self._d_out, _stream(self.index))
        _raise_if(code, "cms_update_estimate_call")
        cms_update_estimate.launches += 1
        return self.out[:n].copy()


_WRAPPERS = (cms_update, cms_estimate, cms_update_estimate)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


reset_launch_counts()
