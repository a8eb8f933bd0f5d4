"""The cells of ``BENCHMARK.json`` at a size a CPU test run can hold: each
loaded as a run loads it (``load_cell``), then cut by the kind of its
traffic; its per-layer metrics are the cell's, its limits this size's."""
from __future__ import annotations

import json
from typing import List, Optional

from perfbench.harness.cell import ROOT, Cell, load_cell

TINY_PROGRAM = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
                "vocab_size": 512, "vocab_pad_multiple": 8, "dtype": "float32",
                "kv_cache_dtype": "float32"}

TINY_LIMITS = {"max_logit_gap": 0.002, "mean_logit_gap": 1e-4, "grad_norm_gap": 0.08,
               "change_norm_gap": 0.06}


def workloads(kind: Optional[str] = None) -> List[str]:
    """The cells of ``BENCHMARK.json``, or those whose traffic is of ``kind``."""
    names = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    return [n for n in names if kind is None or load_cell(n).traffic["kind"] == kind]


def tiny_cell(workload: str, **traffic) -> Cell:
    cell = load_cell(workload)
    _shrink(cell.config, cell.traffic)
    cell.traffic.update(traffic)
    return cell


def _shrink(conf: dict, tr: dict) -> None:
    p = conf["program"]
    p.update(TINY_PROGRAM)
    p["d_ff"] = 32 if p.get("n_experts") else 128
    if p.get("n_experts"):
        p.update(n_experts=6, top_k=2, n_shared_experts=1, capacity_factor=3.0)
    if "serve" in conf:
        # a pool below every lane at its longest (4 x 12 blocks), as the cells' are
        conf["serve"].update(n_slots=4, max_len=96, block_size=8, pool_blocks=32,
                             chunk_sizes=[16])
    if tr["kind"] == "serve_closed_loop":
        tr.update(prompt_tokens={"median": 24, "sigma": 0.7, "min": 8, "max": 64},
                  output_tokens={"median": 6, "sigma": 0.7, "min": 2, "max": 24},
                  backlog=200, check_tokens=100000, check_min_requests=100000,
                  profile_seconds=0.5)
    else:
        tr.update(seq_len=32, distinct_rows=4, profile_steps=1)
    # limits at this size: the program runs in float32 here (training's
    # reconstructed weights in bf16), and agrees with the reference to
    # rounding; see test_perfbench_faults.py for what the faults read
    conf["check"]["limits"] = {k: TINY_LIMITS[k] for k in conf["check"]["limits"]}
