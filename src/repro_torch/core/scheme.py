"""Quantisation-scheme bookkeeping: per-group precision, compression stats
(a copy of ``repro.core.scheme``; it imports only numpy and the port's
``bitrep``).

The paper reports ``#Bits per Para`` and ``Comp (x)`` relative to the
32-bit float model (Tables 1-5).  A scheme here is a plain dict
``name -> int ndarray of per-group bits`` plus the per-group element
counts, so it can be serialised, diffed and applied to a fresh model
(the Table 1 "train from scratch under the BSQ scheme" baseline).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional

import numpy as np

from .bitrep import BitRep, effective_bits, group_shape, numel_per_group


@dataclasses.dataclass
class QuantScheme:
    """Frozen mixed-precision scheme extracted from a BSQ run."""

    bits: Dict[str, np.ndarray]  # per-group precision, shape group_shape (possibly ())
    group_numel: Dict[str, int]  # weight elements per group
    float_params: int = 0  # params intentionally kept float (norms etc.)

    # -- stats ------------------------------------------------------------
    @property
    def quantized_params(self) -> int:
        return sum(int(b.size) * self.group_numel[k] for k, b in self.bits.items())

    @property
    def total_bits(self) -> float:
        return float(
            sum(float(b.sum()) * self.group_numel[k] for k, b in self.bits.items())
        )

    @property
    def bits_per_param(self) -> float:
        n = self.quantized_params
        return self.total_bits / n if n else 0.0

    @property
    def compression(self) -> float:
        """Comp(x) vs 32-bit float over the quantised parameters (paper's metric)."""
        if self.total_bits == 0:
            return float("inf")
        return 32.0 * self.quantized_params / self.total_bits

    def layer_bits(self) -> Dict[str, float]:
        """Mean per-group precision per tensor — the Fig. 2/3 bar charts."""
        return {k: float(b.mean()) for k, b in self.bits.items()}

    # -- (de)serialisation -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "bits": {k: v.tolist() for k, v in self.bits.items()},
                "group_numel": self.group_numel,
                "float_params": self.float_params,
            }
        )

    @staticmethod
    def from_json(s: str) -> "QuantScheme":
        d = json.loads(s)
        return QuantScheme(
            bits={k: np.asarray(v, dtype=np.int32) for k, v in d["bits"].items()},
            group_numel={k: int(v) for k, v in d["group_numel"].items()},
            float_params=int(d.get("float_params", 0)),
        )


def scheme_from_reps(reps: Mapping[str, BitRep], float_params: int = 0,
                     group_numel: Optional[Mapping[str, int]] = None) -> QuantScheme:
    """The scheme of ``reps``; ``group_numel`` gives the whole tensors'
    elements per group where the reps are blocks of them (on a mesh)."""
    bits = {}
    for k, r in reps.items():
        # the mask's groups (whole where the planes are a mesh block)
        bits[k] = effective_bits(r).cpu().numpy().astype(np.int32).reshape(group_shape(r))
    numel = {k: numel_per_group(r) if group_numel is None else int(group_numel[k])
             for k, r in reps.items()}
    return QuantScheme(bits=bits, group_numel=numel, float_params=float_params)
