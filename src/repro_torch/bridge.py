"""Load a JAX param tree or BSQ train state into the port.

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


def _leaf_to(x, device):
    """A 0-d integer counter (the step, AdamW's count) stays on the CPU,
    where the port keeps it; every other array goes to ``device``."""
    a = np.array(x)
    if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a)
    return torch.from_numpy(a).to(device)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return _leaf_to(tree, device)


def bsq_state_from_jax(state, ctx_meta, device="cpu"):
    """The port's BSQ state from a JAX one (``repro.train.step.init_bsq_state``
    or a JAX train step's output): trainable reps, float params, masks,
    optimizer state and step, every array copied.  ``ctx_meta`` is the JAX
    context's ``meta`` (name -> (n_denom, group_axes)); each rep's planes
    and mask are checked against it."""
    reps, masks = state["trainable"]["reps"], state["masks"]
    if set(reps) != set(ctx_meta) or set(masks) != set(ctx_meta):
        raise ValueError(f"state reps {sorted(reps)} / masks {sorted(masks)} do not match "
                         f"the context's {sorted(ctx_meta)}")
    for name, (_, group_axes) in ctx_meta.items():
        wp, mask = np.shape(reps[name]["wp"]), np.shape(masks[name])
        gb = tuple(d if i in group_axes else 1 for i, d in enumerate(wp[1:]))
        if tuple(mask) != (wp[0],) + gb:
            raise ValueError(f"{name}: mask {tuple(mask)} does not fit planes {tuple(wp)} "
                             f"with group axes {group_axes}")
    return _tree_to(state, device)
