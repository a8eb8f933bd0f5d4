"""Fixed-scheme quantisation-aware training (paper §3.3 finetune phase):
PyTorch port of ``repro.core.qat``.

After BSQ freezes the mixed-precision scheme, the paper finetunes with
DoReFa-Net under that scheme; Table 1 also trains the same scheme *from
scratch* as a baseline (which BSQ beats).  Both are provided here, as a
params-transform that can wrap any model's loss function.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .scheme import QuantScheme
from .ste import dorefa_weight


def apply_scheme_dorefa(
    qparams: Dict[str, torch.Tensor], scheme: QuantScheme
) -> Dict[str, torch.Tensor]:
    """Quantise each tensor to its scheme precision with the DoReFa STE.

    Per-group precision on stacked tensors is honoured by quantising each
    leading-group slice at its own bit width (unrolled: group counts are
    small, L or L*E).
    """
    out = {}
    for name, w in qparams.items():
        bits = scheme.bits[name]
        if bits.ndim == 0:
            out[name] = dorefa_weight(w, int(bits))
            continue
        flat_bits = bits.reshape(-1)
        gshape = bits.shape
        lead = int(np.prod(gshape))
        w2 = w.reshape((lead,) + tuple(w.shape[len(gshape):]))
        slices = [dorefa_weight(w2[i], int(flat_bits[i])) for i in range(lead)]
        out[name] = torch.stack(slices).reshape(w.shape)
    return out


def finetune_loss_fn(
    task_loss: Callable[..., torch.Tensor],
    scheme: QuantScheme,
    merge: Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]], object],
) -> Callable[..., torch.Tensor]:
    """Wrap a task loss so quantised params go through the frozen scheme."""

    def loss(qparams, fparams, *args, **kwargs):
        wq = apply_scheme_dorefa(qparams, scheme)
        return task_loss(merge(wq, fparams), *args, **kwargs)

    return loss
