"""Quantization-quality probe: packed model at k active planes vs full.

PyTorch port of ``repro.obs.quality``.  BSQ's packed planes are
independent summands, so "run the model at k active bit planes" is a
*view* of the same weights: keep the k most significant planes and fold
the dropped planes' scale into the scale row
(``core.packing.truncate_packed``, bitwise equal to the kernels' runtime
``active_planes=k``).  The probe runs a token batch through the full
packed model and through each truncated view and records, per plane
count (and optionally per layer group), the logit MSE against full
precision and the greedy top-1 agreement.

The serve-time precision tiers pick their plane counts from these rows
(:func:`precision_tiers_from_probe`), and :func:`replay_plane_log` is the
token oracle of a tiered run.  Results land in a metrics registry
(``serve_quality_logit_mse{planes=,group=}`` /
``serve_quality_top1{planes=,group=}``) and are returned as rows.

torch and the model stack are imported inside the functions, so
importing :mod:`repro_torch.obs` stays light.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import Registry

# Layer-group partition of the packable leaves (core.packing.PACKABLE_SUFFIXES)
LAYER_GROUPS: Dict[str, Tuple[str, ...]] = {
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("w_gate", "w_up", "w_down"),
    "head": ("lm_head",),
}


def truncate_model_planes(params, k: int, suffixes: Optional[Sequence[str]] = None):
    """Truncate every PackedWeight leaf of a param tree to ``k`` planes.

    ``suffixes`` restricts truncation to leaves whose name's last segment
    matches (e.g. ``LAYER_GROUPS['attn']``); ``None`` truncates every
    packed leaf.  Float leaves pass through.  The planes of a truncated
    leaf are a view of the same bytes."""
    from ..core.packing import PackedWeight, tree_map_with_path, truncate_packed

    def leaf(path, x):
        if isinstance(x, PackedWeight):
            name = path.rsplit("/", 1)[-1].lower()
            if suffixes is None or name in suffixes:
                return truncate_packed(x, k)
        return x

    return tree_map_with_path(leaf, params)


@dataclasses.dataclass
class QualityRow:
    planes: int
    group: str  # "all" or a LAYER_GROUPS key
    logit_mse: float
    top1_agreement: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _device_of(params):
    from ..core.packing import PackedWeight, tree_leaves

    for x in tree_leaves(params):
        return x.planes.device if isinstance(x, PackedWeight) else x.device
    raise ValueError("empty param tree")


def quality_probe(params, cfg, tokens, plane_counts: Optional[Sequence[int]] = None,
                  groups: Sequence[str] = ("all",),
                  registry: Optional[Registry] = None) -> List[QualityRow]:
    """Probe a packed model's logit quality at reduced active planes.

    ``tokens``: a (B, S) int token batch; the probe compares the
    full-sequence logits (``transformer.forward``, on the params' device).
    ``plane_counts`` defaults to every count from 1 to the model's max
    ``n_bits``.  ``groups``: "all" truncates every packed leaf; a
    :data:`LAYER_GROUPS` key truncates only that group.

    Returns rows sorted by (group, planes); with ``registry``, also sets
    the ``serve_quality_logit_mse`` / ``serve_quality_top1`` gauges
    labelled ``{planes, group}``."""
    import numpy as np
    import torch

    from ..core.packing import packed_leaves
    from ..models import transformer

    packed = packed_leaves(params)
    if not packed:
        raise ValueError("quality_probe needs a packed model (no PackedWeight leaves found)")
    max_bits = max(pw.n_bits for pw in packed)
    if plane_counts is None:
        plane_counts = range(1, max_bits + 1)
    plane_counts = sorted(set(int(k) for k in plane_counts))
    if any(k < 1 for k in plane_counts):
        raise ValueError(f"plane_counts must be >= 1, got {plane_counts}")
    for g in groups:
        if g != "all" and g not in LAYER_GROUPS:
            raise ValueError(f"unknown layer group {g!r} "
                             f"(want 'all' or one of {sorted(LAYER_GROUPS)})")

    toks = torch.from_numpy(np.asarray(tokens, np.int64)).to(_device_of(params))

    def fwd(p):
        with torch.inference_mode():
            logits = transformer.forward(p, {"tokens": toks}, cfg)[0]
        return logits[..., : cfg.vocab_size].float().cpu().numpy()

    full_logits = fwd(params)
    full_top1 = full_logits.argmax(axis=-1)

    rows: List[QualityRow] = []
    g_mse = g_top1 = None
    if registry is not None:
        # the label space is planes x group, known up front: size the
        # families to it so a wide probe never trips the cardinality cap
        needed = len(plane_counts) * len(groups)
        g_mse = registry.gauge(
            "serve_quality_logit_mse",
            "logit MSE vs full-precision packed weights at k active planes",
            labels=("planes", "group"), max_children=needed)
        g_top1 = registry.gauge(
            "serve_quality_top1",
            "greedy top-1 agreement vs full precision at k active planes",
            labels=("planes", "group"), max_children=needed)
        g_mse.ensure_capacity(len(g_mse._children) + needed)
        g_top1.ensure_capacity(len(g_top1._children) + needed)
    for group in groups:
        suffixes = None if group == "all" else LAYER_GROUPS[group]
        for k in plane_counts:
            logits = fwd(truncate_model_planes(params, k, suffixes))
            mse = float(np.mean((logits - full_logits) ** 2))
            top1 = float(np.mean(logits.argmax(axis=-1) == full_top1))
            rows.append(QualityRow(planes=k, group=group, logit_mse=mse, top1_agreement=top1))
            if registry is not None:
                g_mse.labels(planes=str(k), group=group).set(mse)
                g_top1.labels(planes=str(k), group=group).set(top1)
    rows.sort(key=lambda r: (r.group, r.planes))
    return rows


def replay_plane_log(params, cfg, prompt, plane_log, max_len: int):
    """Re-generate one lane's greedy tokens by STATIC plane truncation.

    The tiered scheduler serves every precision level with the plane
    count as a runtime operand of the kernel and records the count of
    each token in ``Result.plane_log``.  This replay is the independent
    oracle for that path: token ``t`` comes from a single-lane greedy
    decode step (a contiguous cache, M = 1) whose packed weights are
    statically truncated to ``plane_log[t]`` planes
    (:func:`truncate_model_planes`), carrying the KV cache across every
    switch; ``plane_log[0]`` is the prefill's count.  The runtime path is
    bitwise equal to static truncation at the same shapes, so on the CPU
    the replay reproduces the served tokens exactly; on the card the
    served lanes ran at M = n_slots through other kernel tiles, so there
    it agrees where no near-tie flips an argmax."""
    import numpy as np
    import torch

    from ..core.packing import packed_leaves
    from ..models import transformer

    plane_log = [int(k) for k in plane_log]
    if not plane_log:
        return np.zeros((0,), np.int32)
    packed = packed_leaves(params)
    if not packed:
        raise ValueError("replay_plane_log needs a packed model")
    n_bits = max(pw.n_bits for pw in packed)
    views = {n_bits: params}

    def at(k):
        if k not in views:
            views[k] = truncate_model_planes(params, k)
        return views[k]

    dev = _device_of(params)
    V = cfg.vocab_size
    with torch.inference_mode():
        toks = torch.from_numpy(np.asarray(prompt, np.int64)[None, :]).to(dev)
        logits, cache = transformer.prefill(at(plane_log[0]), {"tokens": toks}, cfg, max_len)
        out = [int(torch.argmax(logits[0, :V]))]
        plen = len(prompt)
        for t, k in enumerate(plane_log[1:], start=1):
            tok = torch.tensor([[out[-1]]], dtype=torch.int64, device=dev)
            logits, cache = transformer.decode_step(at(k), cache, tok, plen + t - 1, cfg)
            out.append(int(torch.argmax(logits[0, :V])))
    return np.asarray(out, np.int32)


def precision_tiers_from_probe(rows: Sequence[QualityRow],
                               thresholds: Dict[str, float]) -> Dict[str, int]:
    """Choose a serve-time precision-tier table from quality-probe rows.

    ``thresholds`` maps a precision-class name to the minimum greedy
    top-1 agreement it tolerates, e.g. ``{"economy": 0.95}``.  Each class
    gets the SMALLEST probed plane count whose all-layers agreement meets
    its threshold (the largest probed count when none does); the result
    is what ``SchedulerPolicy(precision_tiers=...)`` takes."""
    all_rows = sorted((r for r in rows if r.group == "all"), key=lambda r: r.planes)
    if not all_rows:
        raise ValueError("precision_tiers_from_probe needs 'all'-group rows "
                         "(run quality_probe with groups containing 'all')")
    tiers: Dict[str, int] = {}
    for name, thr in thresholds.items():
        if not 0.0 <= float(thr) <= 1.0:
            raise ValueError(f"tier {name!r}: threshold {thr} not in [0, 1]")
        tiers[name] = next((r.planes for r in all_rows if r.top1_agreement >= float(thr)),
                           all_rows[-1].planes)
    return tiers
