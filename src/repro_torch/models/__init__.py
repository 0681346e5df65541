"""Model substrate of the port: the decoder-only LM for the dense attention
kinds (``dense``, ``dense_local``), with its flash path on the Hopper
kernel of :mod:`repro_torch.kernels.attention`, and for RWKV-6 (``rwkv``),
with its time-mix on the Hopper wkv6 kernel of
:mod:`repro_torch.kernels.wkv`."""

from .attention import PhysPlan
from .convert import params_from_jax
from .transformer import LM

__all__ = ["LM", "PhysPlan", "params_from_jax"]
