"""Model substrate of the port: the decoder-only LM for the dense attention
kinds (``dense``, ``dense_local``), with its flash path on the Hopper
kernel of :mod:`repro_torch.kernels.attention`."""

from .attention import PhysPlan
from .convert import params_from_jax
from .transformer import LM

__all__ = ["LM", "PhysPlan", "params_from_jax"]
