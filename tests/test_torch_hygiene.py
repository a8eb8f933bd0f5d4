"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to fall back to the CPU quietly, and chip_smoke.py
refuses to run without a card."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import reduced_config

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.kernels.ops", "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.bridge"} <= set(mods)
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


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "engine", "launcher"])
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(entry, monkeypatch):
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = reduced_config("granite-3-2b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "init_params": lambda dev: transformer.init_params(cfg, torch.Generator(), dev),
        "init_cache": lambda dev: transformer.init_cache(cfg, 1, 8, device=dev),
        "engine": lambda dev: ServeEngine(
            transformer.init_params(cfg, torch.Generator(), "cpu"), cfg, max_len=8, device=dev),
        "launcher": lambda dev: launcher.main(
            ["--requests", "1", "--prompt-len", "4", "--max-new", "2", "--max-len", "8"]
            + ([] if dev is None else ["--device", dev])),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry](None)
    assert calls[entry]("cpu") is not None


def test_unported_paths_say_so():
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    with pytest.raises(SystemExit, match="not yet ported"):
        launcher.main(["--continuous", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="later slice"):
        transformer.init_params(reduced_config("gemma3-12b"), torch.Generator(), "cpu")
    cfg = reduced_config("granite-3-2b")
    params = transformer.init_params(cfg, torch.Generator(), "cpu", pack_bits=4)
    with pytest.raises(NotImplementedError, match="next slice"):
        ServeEngine(params, cfg, device="cpu", continuous=True)


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
