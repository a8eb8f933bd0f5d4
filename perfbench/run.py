"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` from its files, makes its
weights and traffic from the seed, sets up, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last: the end-to-end metrics with
``--trace 0``, the per-layer metrics (and the profile's breakdown) with
``--trace 1``.  Needs an NVIDIA card; exits non-zero without one.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "perfbench"


def _prepare_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(ROOT / "build" / "repro_torch"))
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "nv_compute_cache")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _prepare_env()
    import torch

    from perfbench.harness.cell import load_cell

    cell = load_cell(args.workload, ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: cell {cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from perfbench.harness.report import report

    return report(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                  T_START)


if __name__ == "__main__":
    sys.exit(main())
