"""Hand-written Hopper kernels of the port, each beside its plain version."""

from __future__ import annotations

import torch


def kernel_wanted(x: torch.Tensor, use_kernel: bool | None) -> bool:
    """Whether a wrapper launches its kernel for ``x``: always on a CUDA
    tensor unless the caller passes ``use_kernel=False`` (the plain version
    on the card), never on a CPU tensor, where ``use_kernel=True`` raises."""
    if x.is_cuda:
        if x.device.index != torch.cuda.current_device():
            raise ValueError(f"tensor on {x.device}, current device is "
                             f"cuda:{torch.cuda.current_device()}")
        return use_kernel is not False
    if use_kernel:
        raise ValueError("use_kernel=True needs CUDA tensors; these lie on the CPU")
    return False
