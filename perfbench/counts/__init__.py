"""The yardstick: operations and bytes of each kernel launch and of a
whole step, computed from shapes, against a frozen copy of the H100
data sheet's peaks (``peaks.json``).  Nothing here imports the program.

A share of a roofline or of a peak divides a least time by a measured
time, so every count here is the least the work needs: each input byte
read once, each output byte written once, each useful operation once.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
HBM_BW = float(PEAKS["hbm_bytes_per_s"])


def peak_flops(dtype: str) -> float:
    """The data sheet's dense rate of ``dtype`` ("bfloat16", "float32", ...)."""
    return float(PEAKS["flops_per_s"][dtype])


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    at the dtype's peak and the bytes at the HBM rate."""
    return max(flops / peak_flops(dtype), nbytes / HBM_BW)
