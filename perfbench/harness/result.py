"""The result line: one JSON object, the last line of standard output,
with the numbers compared for ``correct`` printed beside their limits as
the last lines of standard error and under the line's last key."""
from __future__ import annotations

import json
import sys
from typing import Dict, Optional


def check_lines(checks: Dict[str, dict]) -> str:
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r}"
                     for k, v in checks.items())


def emit(*, correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
         device: dict, checks: Dict[str, dict], breakdown: Optional[dict] = None,
         extra: Optional[dict] = None) -> None:
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if extra:
        line.update(extra)
    line["check"] = checks  # the numbers compared, last
    sys.stdout.flush()
    print(check_lines(checks), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
