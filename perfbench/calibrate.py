"""Read a cell's compared numbers over many seeds in one process, and the
control's beside them: the readings its limits are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 5 [--control]

Prints one JSON line a seed: the program's readings, the control's (the
plain reference computed in float8 in the program's place), ``correct``
and the end-to-end numbers of that run's (short) window."""
from __future__ import annotations

import argparse
import json
import sys
import time

sys.path[:0] = [str(__import__("pathlib").Path(__file__).resolve().parents[1] / "src"),
                str(__import__("pathlib").Path(__file__).resolve().parents[1])]

from perfbench import run as run_mod  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of tests/test_perfbench_faults.py by its name")
    args = ap.parse_args(argv)
    run_mod._prepare_env()
    import torch

    from perfbench.harness.cell import load_cell
    from perfbench.harness.report import measure

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cell = load_cell(args.workload, run_mod.ROOT / "BENCHMARK.json")
    patches = None
    if args.fault:
        from perfbench.tests import test_perfbench_faults as faults

        patches = getattr(faults, args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = measure(cell, seed, args.seconds, False, torch.device("cuda:0"), t,
                      patches=patches, control=args.control)
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": out["correct"],
                          "readings": {k: v["value"] for k, v in out["checks"].items()},
                          "control": out["control"], "end_to_end": out["end_to_end"],
                          "memory_peak_bytes": out["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
