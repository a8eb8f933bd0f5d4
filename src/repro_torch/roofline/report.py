"""Render the dry run's JSON (``launch.dryrun --out``) into roofline
tables.  Reads the records of either package's dry run: they share their
keys.

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun.json
"""
from __future__ import annotations

import json
import sys

from . import hw


def render(path: str, mesh_filter: str | None = None) -> str:
    """A markdown row per record; "fits" compares argument plus temporary
    bytes against one card's ``hw.HBM_BYTES``."""
    with open(path) as f:
        recs = json.load(f)
    rows = []
    header = (
        "| arch | shape | mesh | mb | fits (args+temp GB) | compute ms | memory ms | "
        "collective ms | bottleneck | useful FLOP ratio | MFU-bound |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|"
    )
    for r in recs:
        if mesh_filter and r["mesh"] != mesh_filter:
            continue
        if r["status"] != "ok":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | FAIL: "
                f"{r.get('error', '')[:60]} | | | | | | |"
            )
            continue
        t = r["roofline"]
        m = r["memory"]
        args = m["argument_bytes"] or 0
        temp = m["temp_bytes"] or 0
        fits = "yes" if args + temp <= hw.HBM_BYTES else "NO"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('microbatches', '-')} | "
            f"{fits} ({args / 1e9:.1f}+{temp / 1e9:.1f}) | "
            f"{t['compute_s'] * 1e3:.1f} | {t['memory_s'] * 1e3:.1f} | "
            f"{t['collective_s'] * 1e3:.1f} | {t['bottleneck']} | "
            f"{(r.get('useful_ratio') or 0):.3f} | "
            f"{(r.get('roofline_fraction') or 0) * 100:.2f}% |"
        )
    return header + "\n" + "\n".join(rows)


def summary(path: str) -> str:
    with open(path) as f:
        recs = json.load(f)
    ok = [r for r in recs if r["status"] == "ok"]
    by_bneck = {}
    for r in ok:
        by_bneck.setdefault(r["roofline"]["bottleneck"], []).append(r)
    lines = [f"cells ok: {len(ok)}/{len(recs)}"]
    for k, v in sorted(by_bneck.items()):
        lines.append(f"  {k}-bound: {len(v)}")
    worst = sorted(ok, key=lambda r: r.get("roofline_fraction") or 0)[:5]
    lines.append("worst MFU-bound cells:")
    for r in worst:
        lines.append(
            f"  {r['arch']} x {r['shape']} x {r['mesh']}: "
            f"{(r.get('roofline_fraction') or 0) * 100:.2f}% ({r['roofline']['bottleneck']})"
        )
    coll = sorted(ok, key=lambda r: -r["roofline"]["collective_s"])[:5]
    lines.append("most collective-bound cells:")
    for r in coll:
        lines.append(
            f"  {r['arch']} x {r['shape']} x {r['mesh']}: "
            f"coll {r['roofline']['collective_s'] * 1e3:.1f} ms"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    print(render(sys.argv[1]))
    print()
    print(summary(sys.argv[1]))
