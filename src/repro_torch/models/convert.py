"""Carry the reference's model parameters over to the port.

:func:`params_from_jax` takes the parameter tree of the reference's
``LM.init`` with its leaves as numpy arrays (``jax.tree.map(np.asarray,
params)``; segment-stacked, a leading ``[repeat]`` axis per segment) and
returns the port's tree of the same structure and values on ``device``.
The two packages then compute on identical weights, which is how the tests
hold the port's model against the reference.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(tree, device: torch.device | str = "cuda"):
    """Nested dicts/lists of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)  # a copy: the port owns its memory
