"""BENCHMARK.json against the shape the benchmark's contract asks for,
and every name in it found in a file of its own."""
import json
import re

from perfbench.harness.cell import BENCH, ROOT, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state|proj|head_dim|_dim$|_rank$|expan|"
                   r"experts_per_tok)", re.I)
B = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "perfbench/run.py"] and B["paths"] == ["perfbench"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs_and_their_files():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/configs/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        assert len(c["reduced"]) <= 16 and len(c["why"]) <= 200


def test_cells():
    seen = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        cell = load_cell(w["name"])
        assert (BENCH / "drivers" / f"{cell.traffic['kind']}.py").exists()
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_metrics():
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert m["bound"] >= 0.01 and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            moved = next(x for x in B["end_to_end"] if x["name"] == m["moves"])
            assert w in moved.get("workloads", [w])
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(json.dumps(B)) < 64 * 1024
