"""Hopper flash-attention forward kernel: build, bind and wrapper.

``csrc/flash_fwd.cu`` holds a hand-written CUDA kernel for ``sm_90a`` that
replaces the Pallas kernel ``flash_attention_fwd_pallas`` of
``repro/kernels/attention/flash.py`` (the source says how it is designed and
what bounds it). At first use :func:`load_library` compiles it with ``nvcc``
(:mod:`repro_torch.kernels._nvcc`) into a shared library with a plain C
interface under ``_build/`` beside this file (listed in ``.gitignore``) and
loads it with ``ctypes``. Importing this module needs neither ``nvcc`` nor a
card.

:func:`flash_attention_fwd` takes the model layout ``[B,S,H,D]``, which the
kernel reads in place through strides (the last dim must be contiguous). It
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
from .ref import flash_attention_ref

__all__ = ["HEAD_DIMS", "load_library", "flash_attention_fwd", "reset_launch_counts",
           "launch_counts"]

#: Head dims the kernel is built for; q/k and v dims are chosen separately.
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library("flash", pathlib.Path(__file__).parent)))
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd_launch.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_int64),
                                         i32, i32, i32, i32, i32, i32, i32,
                                         f32, f32, i32, i32, i32, p]
        lib.flash_fwd_launch.restype = i32
        lib.flash_error_string.argtypes = [i32]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B,S,H,D] (model layout)")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or v.shape[0] != B:
        raise ValueError(f"batch sizes differ: {q.shape[0]}, {k.shape[0]}, {v.shape[0]}")
    if k.shape[1] != v.shape[1] or k.shape[2] != v.shape[2] or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"{Hq} query heads are not a multiple of {k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        use_kernel: bool | None = None) -> torch.Tensor:
    """q ``[B,S,Hq,D]``; k ``[B,T,Hkv,D]``; v ``[B,T,Hkv,Dv]`` -> ``[B,S,Hq,Dv]``."""
    _check(q, k, v)
    if not kernel_wanted(q, use_kernel):
        return flash_attention_ref(q, k, v, scale, causal, window, softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("the flash kernel is forward only; its backward comes with the "
                           "training slice (ROADMAP queue 1, item 13). Run under "
                           "torch.inference_mode() or detach the inputs")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    D, Dv = q.shape[3], v.shape[3]
    if D not in HEAD_DIMS or Dv not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims in {HEAD_DIMS}, got D={D}, Dv={Dv}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k, v must be contiguous in their last dim")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    B, S, Hq, _ = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if T == 0:
        raise ValueError("k and v hold no keys")
    out = torch.empty((B, S, Hq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)))
    code = load_library().flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        B, Hq, Hkv, S, T, D, Dv, float(scale), float(softcap or 0.0), int(bool(causal)),
        int(window or 0), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        msg = load_library().flash_error_string(code).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {code} ({msg})")
    flash_attention_fwd.launches += 1
    return out


def reset_launch_counts() -> None:
    flash_attention_fwd.launches = 0


def launch_counts() -> dict[str, int]:
    return {"flash_attention_fwd": flash_attention_fwd.launches}


reset_launch_counts()
