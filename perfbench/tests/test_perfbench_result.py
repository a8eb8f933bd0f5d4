"""The result line: its keys, the compared numbers last, and a whole run
of a small cell on the CPU printing it."""
import json

import torch

from perfbench.harness import report as report_mod
from perfbench.harness.result import emit
from perfbench.tests._tiny import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_line_keys_and_checks_last(capsys):
    emit(correct=True, attempted=3, failed=0,
         metrics={"setup_s": {"value": 1.5, "unit": "s"}},
         device={"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1},
         checks={"max_logit_gap": {"value": 0.25, "limit": 1.0}},
         breakdown={"device_ops": [["k", 0.1]], "idle_gaps": [["h", 0.2]]})
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "check"
    assert line["check"]["max_logit_gap"] == {"value": 0.25, "limit": 1.0}
    assert err.strip().splitlines()[-1] == "check max_logit_gap: 0.25 limit 1.0"


def test_a_small_serving_cell_prints_its_line(capsys, monkeypatch):
    monkeypatch.setattr(report_mod.dev_mod, "power_limit", lambda: "")
    cell = tiny_cell("granite-serve-chat")
    import time

    assert report_mod.report(cell, 2**31 + 3, 1.0, False, torch.device("cpu"),
                             time.perf_counter()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(k in line for k in KEYS) and line["correct"] is True
    assert set(line["metrics"]) == {"serve_tokens_per_s", "ttft_p90_ms", "itl_p95_ms", "setup_s"}
    assert line["device"]["count"] == 1 and "memory_peak_bytes" in line["device"]


def test_a_small_training_cell_traced_prints_per_layer_metrics(capsys, monkeypatch):
    monkeypatch.setattr(report_mod.dev_mod, "power_limit", lambda: "")
    cell = tiny_cell("granite-bsq-train")
    import time

    assert report_mod.report(cell, 5, 1.0, True, torch.device("cpu"), time.perf_counter()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the CPU has no device trace: only the readers of host numbers report
    assert set(line["metrics"]) == {"mfu.train", "step_roofline.train"}
    assert line["correct"] is True and "breakdown" in line
