"""Flash attention: the Hopper forward kernel (:mod:`.flash`) beside its
plain PyTorch versions (:mod:`.ref`).

``flash_attention`` takes the model layout ``[B,S,H,D]``. On a CUDA tensor
it launches the kernel; it runs the plain version on the card only when the
caller passes ``use_kernel=False``, and on a CPU tensor always. (The
reference dispatches on ``jax.default_backend()``; the port dispatches on
the tensor's device.)
"""

from .flash import flash_attention_fwd
from .ref import attention_dense_ref, flash_attention_ref


def flash_attention(q, k, v, scale, causal=True, window=None, softcap=None, *,
                    use_kernel: bool = True):
    """q ``[B,S,nq,hd]``; k, v ``[B,T,nkv,hd*]`` -> ``[B,S,nq,hd_v]``."""
    return flash_attention_fwd(q, k, v, scale, causal=causal, window=window, softcap=softcap,
                               use_kernel=False if not (use_kernel and q.is_cuda) else None)


__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "attention_dense_ref"]
