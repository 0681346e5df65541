"""The port's ``wkv6`` entry point, mirroring the reference's
``repro/kernels/wkv/ops.py``: one signature for the Hopper kernel and its
plain version.

On a CUDA tensor it launches the kernel (:func:`.wkv6.wkv6_fwd`); it runs
the plain version on the card only when the caller passes
``use_kernel=False``, and on a CPU tensor always. (The reference dispatches
on ``jax.default_backend()``; the port dispatches on the tensor's device,
as ``kernels.attention.flash_attention`` does.)

T need not be a multiple of the chunk. The reference's wrapper pads T to
the chunk (zeros for r, k and v, 1.0 for w, so the padding neither decays
nor feeds the state) and slices the output back. The plain version pads so;
the kernel reads ``[B,T,H,*]`` in place and masks its last chunk the same
way, so r, k, v and w are not copied on the card.
"""

from __future__ import annotations

from .wkv6 import DEFAULT_CHUNK, wkv6_fwd

__all__ = ["DEFAULT_CHUNK", "wkv6"]


def wkv6(r, k, v, w, u, *, chunk: int = DEFAULT_CHUNK, return_state: bool = False,
         use_kernel: bool = True):
    """r, k, w ``[B,T,H,K]``; v ``[B,T,H,V]``; u ``[H,K]`` -> o ``[B,T,H,V]``
    (and the final ``[B,H,K,V]`` float32 state with ``return_state``).
    ``chunk`` is the plain version's (see :func:`.wkv6.wkv6_fwd`)."""
    return wkv6_fwd(r, k, v, w, u, chunk=chunk, return_state=return_state,
                    use_kernel=False if not (use_kernel and r.is_cuda) else None)
