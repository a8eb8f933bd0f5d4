"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to fall back to the CPU quietly, and chip_smoke.py
refuses to run without a card."""
import contextlib
import io
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import reduced_config
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.kernels.ops", "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.bridge",
            "repro_torch.kernels.paged_attention", "repro_torch.serve.slots",
            "repro_torch.serve.scheduler", "repro_torch.kernels.bgl_sumsq",
            "repro_torch.kernels.ref", "repro_torch.kernels._build",
            "repro_torch.core.bitrep", "repro_torch.core.ste", "repro_torch.core.regularizer",
            "repro_torch.core.requant", "repro_torch.core.scheme", "repro_torch.core.bsq",
            "repro_torch.optim.optimizers", "repro_torch.data.pipeline",
            "repro_torch.ckpt.checkpoint", "repro_torch.train.step",
            "repro_torch.train.trainer", "repro_torch.launch.train",
            "repro_torch.tree", "repro_torch.kernels.flash_attention",
            "repro_torch.models.resnet", "repro_torch.core.qat", "repro_torch.train.ft",
            "repro_torch.examples.resnet20_bsq_paper", "repro_torch.examples.quickstart",
            "repro_torch.examples.serve_quantized", "repro_torch.examples.train_lm_bsq",
            "repro_torch.examples.fault_tolerance", "repro_torch.models.ssm",
            "repro_torch.models.rglru", "repro_torch.roofline.hw",
            "repro_torch.roofline.analysis", "repro_torch.roofline.report",
            "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
            "repro_torch.dist.sharding", "repro_torch.dist.elastic",
            "repro_torch.launch.mesh"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'repro' or k.startswith('repro.')"
        " or k == 'jax' and sys.modules[k] is not None or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('IMPORTS_OK', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                          timeout=120)
    assert proc.returncode == 0 and "IMPORTS_OK" in proc.stdout, proc.stderr[-2000:]


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "init_cache_gemma3", "engine",
                                   "launcher", "init_bsq_state", "train_launcher",
                                   "lm_iterator"])
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(entry, monkeypatch):
    from repro_torch.core import BSQConfig
    from repro_torch.data import MarkovLM, sharded_lm_iterator
    from repro_torch.launch import serve as launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import transformer
    from repro_torch.optim import SGDM
    from repro_torch.serve import ServeEngine
    from repro_torch.train import init_bsq_state

    cfg = reduced_config("granite-3-2b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "init_params": lambda dev: transformer.init_params(cfg, torch.Generator(), dev),
        "init_cache": lambda dev: transformer.init_cache(cfg, 1, 8, device=dev),
        "init_cache_gemma3": lambda dev: transformer.init_cache(
            reduced_config("gemma3-12b"), 1, 8, device=dev),
        "engine": lambda dev: ServeEngine(
            transformer.init_params(cfg, torch.Generator(), "cpu"), cfg, max_len=8, device=dev),
        "launcher": lambda dev: launcher.main(
            ["--requests", "1", "--prompt-len", "4", "--max-new", "2", "--max-len", "8"]
            + ([] if dev is None else ["--device", dev])),
        "init_bsq_state": lambda dev: init_bsq_state(torch.Generator(), cfg, BSQConfig(),
                                                     SGDM(), dev),
        "train_launcher": lambda dev: train_launcher.main(
            ["--steps", "1", "--batch", "2", "--seq", "4"]
            + ([] if dev is None else ["--device", dev])),
        "lm_iterator": lambda dev: sharded_lm_iterator(MarkovLM(vocab=16), 2, 4, device=dev),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry](None)
    assert calls[entry]("cpu") is not None


def test_unported_paths_say_so():
    """The serve launcher's mesh flags run (4 gloo ranks on the CPU, tokens
    equal to the same command without a mesh), on an "attn" arch and on
    recurrentgemma-9b's rglru and local layers; the training launcher
    trains that pattern on the 2x2 mesh (one BSQ step, its losses those of
    the same command without a mesh) and refuses a batch its data axis
    does not divide, as JAX's does;
    the dry run's meshes still say "mesh slice" (the next mesh slice
    brings them); every layer kind and frontend is ported, so
    ``init_params`` builds all ten reduced configs on the CPU."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import serve as launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import transformer

    argv = ["--device", "cpu", "--packed-bits", "6", "--smoke"]
    mesh = launcher.main(argv + ["--data-parallel", "2", "--model-parallel", "2"])
    single = launcher.main(argv)
    assert len(mesh) == len(single) == 8
    for a, b in zip(sorted(mesh, key=lambda r: r.uid), sorted(single, key=lambda r: r.uid)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    # a pattern of rglru and local layers serves on the mesh too, with the
    # tokens of the same command without one, and BSQ-trains there with
    # the losses of the same command without one
    argv = ["--device", "cpu", "--arch", "recurrentgemma-9b", "--packed-bits", "6",
            "--requests", "4", "--prompt-len", "20", "--max-new", "6"]
    mesh = launcher.main(argv + ["--data-parallel", "2", "--model-parallel", "2"])
    single = launcher.main(argv)
    assert len(mesh) == len(single) == 4
    for a, b in zip(sorted(mesh, key=lambda r: r.uid), sorted(single, key=lambda r: r.uid)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    argv = ["--device", "cpu", "--arch", "recurrentgemma-9b", "--steps", "1", "--batch", "4",
            "--seq", "16"]
    with contextlib.redirect_stdout(io.StringIO()):
        trained = train_launcher.main(argv + ["--data-parallel", "2", "--model-parallel", "2"])
        one = train_launcher.main(argv)
    got, want = trained["history"][-1], one["history"][-1]
    assert got["step"] == want["step"] == 1
    for k in ("ce", "reg", "total"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
    for flags in (["--data-parallel", "2"], ["--model-parallel", "2"]):
        with pytest.raises(SystemExit, match="must be given together"):
            launcher.main(flags + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="does not divide over the mesh's data axes"):
        train_launcher.main(["--device", "cpu", "--data-parallel", "2", "--model-parallel", "2",
                             "--batch", "3"])
    from repro_torch.launch import dryrun

    for flag in ("--single-pod", "--multi-pod"):
        with pytest.raises(SystemExit, match="mesh slice of the port"):
            dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k", flag])
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        params = transformer.init_params(reduced_config(arch), torch.Generator(), "cpu")
        assert params["blocks"] and params["final_norm"], arch


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result; alone in
    a directory (without the repo's package) it fails too."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              cwd=cwd, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
