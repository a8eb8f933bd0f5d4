"""Drive a cell once and print its result line."""
from __future__ import annotations

import sys
from typing import Callable, Optional

from . import device as dev_mod
from .imports import forbidden_loaded
from .result import emit


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            patches: Optional[Callable] = None, control: bool = False) -> dict:
    """The driver's run plus the metrics the line reports."""
    out = cell.driver().run(cell, seed, seconds, trace, device, t_start, patches=patches,
                            control=control)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers()[m["name"]].read(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if out["end_to_end"].get(m["name"]) is not None}
    out["metrics"] = metrics
    return out


def report(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> int:
    out = measure(cell, seed, seconds, trace, device, t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the process holds forbidden modules {bad}", file=sys.stderr)
        return 4
    dev = dict(dev_mod.describe(device), memory_peak_bytes=out["memory_peak_bytes"],
               power_limit=dev_mod.power_limit())
    breakdown = None
    slc = out.get("slice")
    if trace and slc is not None:
        dev.update(busy_s=slc.busy_s(), window_s=slc.window_s)
        breakdown = {"device_ops": slc.device_ops(), "idle_gaps": slc.idle_gaps()}
    emit(correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
         metrics=out["metrics"], device=dev, checks=out["checks"], breakdown=breakdown)
    return 0
