"""ResNet-20 for CIFAR (He et al. 2016), the paper's own benchmark model:
PyTorch port of ``repro.models.resnet``.

3 stages x 3 basic blocks, widths 16/32/64, BatchNorm kept in float
throughout BSQ training (paper App. A.1), ReLU6 activations when
activation quantisation is on.  Plain functions over the JAX package's
nested param dict, in its layouts: conv kernels HWIO, images NHWC
``(B, 32, 32, 3)``, so ``core.bsq.partition_params`` picks up the same
tensors under the same names (and the same packed bytes) as in JAX.
The forward moves the images to NCHW once and each kernel to OIHW at
its conv; the logits are layout-free.

Two places where PyTorch's own layers differ from ``lax``:

* ``"SAME"`` padding is asymmetric for a 3x3 stride-2 conv on an even
  input (0 before, 1 after); ``F.conv2d(padding=1)`` pads 1 on both
  sides and shifts every output.  :func:`_conv` pads as lax does.
* ``_bn`` normalises and updates its running variance with the biased
  batch variance (``jnp.var``); ``F.batch_norm`` updates with the
  unbiased one.  :func:`_bn` is written out as in JAX.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.ste import relu6_act_quantize
from ..device import resolve_device

Params = Dict[str, object]


def _conv_init(gen, kh, kw, cin, cout, device):
    fan_in = kh * kw * cin
    return torch.randn((kh, kw, cin, cout), generator=gen, device=device) * (2.0 / fan_in) ** 0.5


def _bn_init(c, device):
    return {
        "bnscale": torch.ones((c,), device=device),
        "bnbias": torch.zeros((c,), device=device),
        "mean": torch.zeros((c,), device=device),
        "var": torch.ones((c,), device=device),
    }


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of lax's "SAME" along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, C, H, W) conv an HWIO kernel, "SAME" padding as lax pads it."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _bn(p, x: torch.Tensor, train: bool, momentum=0.9, eps=1e-5):
    if train:
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.var(x, dim=(0, 2, 3), correction=0)
        new_stats = {
            "mean": momentum * p["mean"] + (1 - momentum) * mean,
            "var": momentum * p["var"] + (1 - momentum) * var,
        }
    else:
        mean, var = p["mean"], p["var"]
        new_stats = {"mean": p["mean"], "var": p["var"]}

    def c(v):
        return v[None, :, None, None]

    y = (x - c(mean)) * torch.rsqrt(c(var) + eps) * c(p["bnscale"]) + c(p["bnbias"])
    return y, new_stats


def _act(x: torch.Tensor, act_bits: int) -> torch.Tensor:
    if act_bits >= 32:
        return F.relu(x)
    return relu6_act_quantize(x, act_bits)


def init_resnet20(generator: torch.Generator, num_classes: int = 10, width: int = 16,
                  device=None) -> Params:
    """Random params (He-normal convs, 1/sqrt(cin)-normal fc, unit BN) drawn
    on ``device`` (the card unless ``device="cpu"``) from ``generator``."""
    device = resolve_device(device)
    p: Params = {"conv0": _conv_init(generator, 3, 3, 3, width, device),
                 "bn0": _bn_init(width, device)}
    cin = width
    for stage in range(3):
        cout = width * (2**stage)
        for blk in range(3):
            stride = 2 if (stage > 0 and blk == 0) else 1
            name = f"s{stage}b{blk}"
            p[f"{name}_conv1"] = _conv_init(generator, 3, 3, cin, cout, device)
            p[f"{name}_bn1"] = _bn_init(cout, device)
            p[f"{name}_conv2"] = _conv_init(generator, 3, 3, cout, cout, device)
            p[f"{name}_bn2"] = _bn_init(cout, device)
            if stride != 1 or cin != cout:
                p[f"{name}_proj"] = _conv_init(generator, 1, 1, cin, cout, device)
                p[f"{name}_bnp"] = _bn_init(cout, device)
            cin = cout
    p["fc"] = torch.randn((cin, num_classes), generator=generator, device=device) \
        * (1.0 / cin) ** 0.5
    p["fc_bias"] = torch.zeros((num_classes,), device=device)
    return p


def resnet20_forward(p: Params, images: torch.Tensor, train: bool = False, act_bits: int = 32,
                     width: int = 16) -> Tuple[torch.Tensor, Params]:
    """images: (B, 32, 32, 3). Returns (logits, new_bn_stats)."""
    stats: Params = {}
    x = _conv(images.permute(0, 3, 1, 2), p["conv0"])
    x, stats["bn0"] = _bn(p["bn0"], x, train)
    x = _act(x, act_bits)
    for stage in range(3):
        for blk in range(3):
            stride = 2 if (stage > 0 and blk == 0) else 1
            name = f"s{stage}b{blk}"
            sc = x
            y = _conv(x, p[f"{name}_conv1"], stride)
            y, stats[f"{name}_bn1"] = _bn(p[f"{name}_bn1"], y, train)
            y = _act(y, act_bits)
            y = _conv(y, p[f"{name}_conv2"])
            y, stats[f"{name}_bn2"] = _bn(p[f"{name}_bn2"], y, train)
            if f"{name}_proj" in p:
                sc = _conv(sc, p[f"{name}_proj"], stride)
                sc, stats[f"{name}_bnp"] = _bn(p[f"{name}_bnp"], sc, train)
            x = _act(y + sc, act_bits)
    x = torch.mean(x, dim=(2, 3))
    return x @ p["fc"] + p["fc_bias"], stats


def merge_bn_stats(params: Params, stats: Params) -> Params:
    out = dict(params)
    for bn_name, s in stats.items():
        out[bn_name] = {**params[bn_name], **s}
    return out


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))
