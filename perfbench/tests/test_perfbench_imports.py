"""Nothing the harness or the reference loads has the whole top-level
name jax or repro (repro_torch is the code under test), and the reference
loads nothing of repro_torch."""
import subprocess
import sys
from pathlib import Path

from perfbench.harness.imports import forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]
HARNESS = ["perfbench.run", "perfbench.harness.cell", "perfbench.harness.report",
           "perfbench.harness.traffic", "perfbench.harness.window", "perfbench.harness.weights",
           "perfbench.harness.profile", "perfbench.harness.program", "perfbench.counts.model",
           "perfbench.drivers.serve_closed_loop", "perfbench.drivers.train_steps"]
REFERENCE = ["perfbench.reference.lm", "perfbench.reference.bsq", "perfbench.reference.quant"]


def _modules_after(imports, run_cell: bool = False):
    code = ["import sys", f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]"]
    code += [f"import {m}" for m in imports]
    if run_cell:
        code += ["import time, torch", "from perfbench.tests._tiny import tiny_cell, workloads",
                 "from perfbench.harness.report import measure",
                 "for w in workloads():",
                 "    measure(tiny_cell(w), 11, 0.5, False, torch.device('cpu'), time.perf_counter())"]
        code += ["import glob, importlib.util, os",
                 "[importlib.util.spec_from_file_location('m' + str(i), p).loader.load_module()"
                 " for i, p in enumerate(glob.glob(os.path.join(sys.path[0], 'perfbench', "
                 "'metrics', '*.py')))]"]
    code += ["print('\\n'.join(sorted(sys.modules)))"]
    out = subprocess.run([sys.executable, "-c", "\n".join(code)], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_whole_names_are_compared():
    assert forbidden_loaded(["repro_torch.serve", "reprox", "jax_like", "numpy"]) == []
    assert forbidden_loaded(["repro.models", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_the_harness_and_a_run_load_neither_jax_nor_repro():
    assert forbidden_loaded(_modules_after(HARNESS, run_cell=True)) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after(REFERENCE)
    assert forbidden_loaded(mods, forbidden=("jax", "jaxlib", "flax", "repro",
                                             "repro_torch")) == []
    src = "".join(p.read_text() for p in (ROOT / "perfbench" / "reference").glob("*.py"))
    assert "repro" not in src.replace("reproduc", "")
