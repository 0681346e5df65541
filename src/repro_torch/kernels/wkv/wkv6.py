"""Hopper wkv6 kernel: build, bind and wrapper.

``csrc/wkv6.cu`` holds a hand-written CUDA kernel for ``sm_90a`` that
replaces the Pallas kernel ``wkv6_pallas`` of ``repro/kernels/wkv/wkv6.py``
(the source says how it is designed and what bounds it). At first use
:func:`load_library` compiles it with ``nvcc`` (:mod:`repro_torch.kernels._nvcc`)
into a shared library with a plain C interface under ``_build/`` beside this
file (listed in ``.gitignore``) and loads it with ``ctypes``. Importing this
module needs neither ``nvcc`` nor a card.

:func:`wkv6_fwd` takes the model layout ``[B,T,H,K]``, which the kernel
reads in place through strides (the last dim must be contiguous), and any
``T >= 1``: the kernel masks the ragged end of its last chunk itself. It
checks its tensors and then

* for CUDA tensors launches the kernel on the current stream, without
  synchronising, and adds one to its ``launches`` count; a refused launch
  raises. It runs the plain version on the card only when the caller
  passes ``use_kernel=False``;
* for CPU tensors runs the plain version of :mod:`.ref`; ``use_kernel=True``
  with a CPU tensor raises.

The kernel is forward only: a CUDA call whose inputs require grad raises.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import kernel_wanted
from .._nvcc import build_library
from .ref import wkv6_chunked

__all__ = ["DEFAULT_CHUNK", "HEAD_SIZE", "load_library", "wkv6_fwd", "reset_launch_counts",
           "launch_counts"]

#: Tokens a chunk of the kernel (the TPU kernel's, by the same name), and the
#: key and value size it is built for (rwkv6-7b's head size).
DEFAULT_CHUNK = 64
HEAD_SIZE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library("wkv6", pathlib.Path(__file__).parent)))
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_launch.argtypes = [p, p, p, p, p, p, p, ctypes.POINTER(ctypes.c_int64),
                                    i32, i32, i32, i32, i32, i32, i32, p]
        lib.wkv6_launch.restype = i32
        lib.wkv6_error_string.argtypes = [i32]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4 or k.dim() != 4 or v.dim() != 4 or w.dim() != 4:
        raise ValueError("r, k, v, w must be [B,T,H,*] (model layout)")
    B, T, H, K = r.shape
    if k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, w {tuple(w.shape)} differ")
    if v.shape[:3] != (B, T, H):
        raise ValueError(f"v {tuple(v.shape)} does not fit r {tuple(r.shape)}")
    if u.shape != (H, K):
        raise ValueError(f"u {tuple(u.shape)} is not [H, K] = [{H}, {K}]")
    if not (r.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes of r, k, v differ: {r.dtype}, {k.dtype}, {v.dtype}")
    if len({x.device for x in (r, k, v, w, u)}) != 1:
        raise ValueError(f"devices differ: {[str(x.device) for x in (r, k, v, w, u)]}")


def wkv6_fwd(r, k, v, w, u, *, chunk: int = DEFAULT_CHUNK, return_state: bool = False,
             use_kernel: bool | None = None):
    """r, k, w ``[B,T,H,K]``; v ``[B,T,H,V]``; u ``[H,K]`` -> o ``[B,T,H,V]``
    in r's type (and the final state ``[B,H,K,V]`` in float32 if asked).

    ``chunk`` is the plain version's. The kernel walks chunks of
    ``DEFAULT_CHUNK`` tokens whatever ``chunk`` says: the chunk changes only
    the order of the float32 sums, not the function."""
    _check(r, k, v, w, u)
    if not kernel_wanted(r, use_kernel):
        return wkv6_chunked(r, k, v, w, u, chunk=chunk, return_state=return_state)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, w, u)):
        raise RuntimeError("the wkv6 kernel is forward only; training waits for ROADMAP "
                           "queue 1, item 13. Run under torch.inference_mode() or detach "
                           "the inputs")
    if r.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got r {r.dtype}, w {w.dtype}")
    if r.dtype == torch.float32 and w.dtype != torch.float32:
        raise ValueError("float32 r, k, v need float32 w")
    B, T, H, K = r.shape
    if K != HEAD_SIZE or v.shape[3] != HEAD_SIZE:
        raise ValueError(f"the kernel takes K = V = {HEAD_SIZE}, got K={K}, V={v.shape[3]}")
    if any(x.stride(3) != 1 for x in (r, k, v, w)):
        raise ValueError("r, k, v, w must be contiguous in their last dim")
    if T == 0:
        raise ValueError("r, k, v, w hold no tokens")
    o = torch.empty((B, T, H, HEAD_SIZE), dtype=r.dtype, device=r.device)
    state = (torch.empty((B, H, K, HEAD_SIZE), dtype=torch.float32, device=r.device)
             if return_state else None)
    u32 = u.float().contiguous()  # [H, K]: 16 KB at full width
    strides = (ctypes.c_int64 * 15)(*(x.stride(i) for x in (r, k, v, w, o) for i in (0, 1, 2)))
    code = load_library().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u32.data_ptr(), o.data_ptr(),
        None if state is None else state.data_ptr(), strides, B, T, H, K, HEAD_SIZE,
        _DTYPES[r.dtype], _DTYPES[w.dtype], torch.cuda.current_stream(r.device).cuda_stream)
    if code != 0:
        msg = load_library().wkv6_error_string(code).decode()
        raise RuntimeError(f"wkv6_fwd launch failed: CUDA error {code} ({msg})")
    wkv6_fwd.launches += 1
    return (o, state) if return_state else o


def reset_launch_counts() -> None:
    wkv6_fwd.launches = 0


def launch_counts() -> dict[str, int]:
    return {"wkv6_fwd": wkv6_fwd.launches}


reset_launch_counts()
