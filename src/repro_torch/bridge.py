"""Load a JAX param tree into the port.

A tree of nested dicts and lists whose leaves are arrays numpy can copy
(numpy arrays, or ``jax.Array`` leaves as the JAX package returns them:
this module never imports JAX).  A packed weight is any object with the
fields ``planes``, ``sign``, ``scale``, ``n_bits``, ``k`` and
``denom_bits`` (a ``repro.core.packing.PackedWeight``) and is copied
byte for byte into a :class:`~repro_torch.core.packing.PackedWeight`.
Every array is copied (``np.array``), so read-only JAX buffers never
reach ``torch.from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.packing import PackedWeight

_PACKED_FIELDS = ("planes", "sign", "scale", "n_bits", "k", "denom_bits")


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def from_numpy_tree(tree, device="cpu"):
    """The same tree with torch tensors and PackedWeights on ``device``."""
    if all(hasattr(tree, f) for f in _PACKED_FIELDS):
        return PackedWeight(
            planes=_tensor(tree.planes, device),
            sign=_tensor(tree.sign, device),
            scale=_tensor(np.asarray(tree.scale, np.float32), device),
            n_bits=int(tree.n_bits),
            k=int(tree.k),
            denom_bits=tree.denom_bits,
        )
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    return _tensor(tree, device)
