"""The port's example programs, the heartbeat module and
``dequantize_packed_params`` on the CPU, against the JAX package where
it has the same function.

* ``serve_quantized`` serves the packed export: its greedy tokens equal
  JAX's ``ServeEngine`` on the same packed tree, and the port's own
  float route (``dequantize_packed_params``), at reduced granite-3-2b
  in f32;
* ``dequantize_packed_params`` on a JAX ``export_packed`` tree equals
  JAX's bitwise (both multiply the same integer codes by the same f32
  scale);
* the ResNet-20 pipeline, the DoReFa finetune and the LM examples run at
  a few steps; every ``main`` refuses to run without a card unless it
  is given ``device="cpu"``.
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import bitrep as jbitrep
from repro.core import export_packed as j_export_packed
from repro.core.packing import PackedWeight as JPackedWeight
from repro.core.packing import truncate_packed as j_truncate_packed
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import dequantize_packed_params as j_dequantize_packed_params
from repro_torch import bridge
from repro_torch.core.packing import PackedWeight
from repro_torch.examples import (fault_tolerance, quickstart, resnet20_bsq_paper,
                                  serve_quantized, train_lm_bsq)
from repro_torch.serve import Request, ServeEngine, dequantize_packed_params
from repro_torch.train.ft import FailureDetector, Heartbeat
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _to_jax(tree):
    """A port param tree as the JAX package's (PackedWeight bytes as they are)."""
    if isinstance(tree, PackedWeight):
        return JPackedWeight(planes=jnp.asarray(tree.planes.numpy()),
                             sign=jnp.asarray(tree.sign.numpy()),
                             scale=jnp.asarray(tree.scale.numpy()), n_bits=tree.n_bits, k=tree.k,
                             denom_bits=tree.denom_bits)
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


@pytest.fixture(scope="module")
def served():
    return serve_quantized.main(["--steps", "6", "--requant-interval", "3", "--requests", "4",
                                 "--max-new", "6"], device="cpu")


def test_serve_quantized_serves_the_packed_export(served):
    params = served["params"]
    mixer = params["blocks"]["p0"]["mixer"]
    assert all(isinstance(mixer[k], PackedWeight) for k in ("wq", "wk", "wv", "wo"))
    assert all(isinstance(params["blocks"]["p0"]["mlp"][k], PackedWeight)
               for k in ("w_gate", "w_up", "w_down"))
    assert isinstance(params["embed"], torch.Tensor)
    results = sorted(served["results"], key=lambda r: r.uid)
    assert [len(r.tokens) for r in results] == [6] * 4
    assert serve_quantized.tree_bytes(params) < serve_quantized.tree_bytes(served["float_params"])


def test_serve_quantized_tokens_match_jax_and_the_float_route(served):
    prompts = served["prompts"]
    got = {r.uid: r.tokens for r in served["results"]}
    jres = JServeEngine(_to_jax(served["params"]), j_reduced_config("granite-3-2b"),
                        max_len=128).generate(
        [JRequest(uid=i, tokens=p, max_new=6) for i, p in enumerate(prompts)])
    assert {r.uid: r.tokens.tolist() for r in jres} == {k: v.tolist() for k, v in got.items()}
    fres = ServeEngine(served["float_params"], served["cfg"], max_len=128, device="cpu").generate(
        [Request(uid=i, tokens=p, max_new=6) for i, p in enumerate(prompts)])
    assert {r.uid: r.tokens.tolist() for r in fres} == {k: v.tolist() for k, v in got.items()}


def test_dequantize_packed_params_matches_jax_bitwise():
    """A stacked tensor with per-layer groups (one of its layers packed as
    a truncated view, which keeps its original denominator), a 2-D one,
    and a float leaf."""
    rng = np.random.default_rng(1)
    ws = {"blocks/wq": (rng.standard_normal((2, 64, 48)), (0,)),
          "embed": (rng.standard_normal((40, 16)), ())}
    reps = {name: jax.jit(functools.partial(jbitrep.decompose, n_bits=6, group_axes=ga))(
        jnp.asarray(w, jnp.float32)) for name, (w, ga) in ws.items()}
    packed = dict(j_export_packed(reps))
    packed["embed"] = j_truncate_packed(packed["embed"], 4)
    floats = {"blocks/norm": jnp.asarray(rng.standard_normal(16), jnp.float32)}
    template = {"blocks": {"wq": ws["blocks/wq"][0], "norm": floats["blocks/norm"]},
                "embed": ws["embed"][0]}
    want = j_dequantize_packed_params(template, packed, floats)
    got = dequantize_packed_params(bridge.from_numpy_tree(template),
                                   bridge.from_numpy_tree(packed), bridge.from_numpy_tree(floats))
    assert packed["embed"].denom_bits == 6 and packed["blocks/wq"].scale.shape == (2, 1, 1)
    for a, b in ((got["blocks"]["wq"], want["blocks"]["wq"]), (got["embed"], want["embed"]),
                 (got["blocks"]["norm"], want["blocks"]["norm"])):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), np.array(b))


def test_heartbeat_and_failure_detection(tmp_path):
    hb0 = Heartbeat(str(tmp_path), 0, interval=0.05)
    hb1 = Heartbeat(str(tmp_path), 1, interval=0.05)
    hb0.start()
    hb1.start()
    time.sleep(0.2)
    det = FailureDetector(str(tmp_path), suspect_after=1.0, dead_after=2.0)
    assert det.check([0, 1]) == {0: "healthy", 1: "healthy"}
    hb1.stop()
    # host 2 never heartbeated -> dead; host 1 will age into suspect/dead
    status = det.check([0, 1, 2])
    assert status[2] == "dead"
    assert det.surviving([0, 2]) == [0]
    hb0.stop()
    assert not hb0._thread.is_alive() and not hb1._thread.is_alive()


def test_fault_tolerance_resumes_to_its_final_step(capsys):
    out = fault_tolerance.main(["--steps", "4"], device="cpu")
    assert out["phase1_step"] == 4 and out["resumed_from"] == 4 and out["phase2_step"] == 6
    assert out["status"][2] == "dead" and out["survivors"] == [0, 1, 3]
    assert "[trainer] resumed from step 4" in capsys.readouterr().out
    assert all(np.isfinite(h["total"]) for h in out["history"])


def test_quickstart_and_train_lm_bsq_run():
    out = quickstart.main(["--steps", "4", "--requant-interval", "2"], device="cpu")
    assert [h["step"] for h in out["history"]] == [2, 4]
    assert 0 < out["scheme"].bits_per_param <= 9
    assert int(out["state"]["step"]) == 4

    args = train_lm_bsq.build_parser().parse_args(
        ["--steps", "4", "--requant-interval", "2", "--batch", "2", "--seq", "16",
         "--workdir", ""])
    cfg = train_lm_bsq.LM_100M.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                                      vocab_size=512)
    out = train_lm_bsq.run(cfg, args, device="cpu")
    assert [h["step"] for h in out["history"]] == [4]
    assert np.isfinite(out["history"][-1]["total"])


def test_resnet_pipeline_and_finetune_run(monkeypatch):
    # a requant every 5 steps: the loop's requant runs twice in 10 steps
    monkeypatch.setattr(resnet20_bsq_paper, "REQUANT_INTERVAL", 5)
    out = resnet20_bsq_paper.main(device="cpu", steps=10, width=8, batch=8)
    hist = out["history"]
    assert len(hist) == 10 and "bits_per_param" in hist[4] and "bits_per_param" in hist[9]
    assert "bits_per_param" not in hist[3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    scheme = out["scheme"]
    assert len(scheme.layer_bits()) == 22 and 0 < scheme.bits_per_param <= 9
    ft = resnet20_bsq_paper.finetune(scheme, out["params"], device="cpu", steps=3, width=8,
                                     batch=8)
    assert all(np.isfinite(h["ce"]) for h in ft["history"]) and 0 <= ft["eval_acc"] <= 1
    # each quantised tensor holds at most 2^bits + 1 DoReFa levels
    fc = ft["params"]["fc"]
    assert len(torch.unique(fc)) <= 2 ** int(scheme.bits["fc"]) + 1
    # the BN running statistics moved away from their initial values
    assert not torch.equal(ft["params"]["bn0"]["var"], out["params"]["bn0"]["var"])


MAINS = {
    "resnet20_bsq_paper": lambda dev: resnet20_bsq_paper.main(device=dev, steps=1, width=8,
                                                              batch=2),
    "quickstart": lambda dev: quickstart.main(["--steps", "1"], device=dev),
    "serve_quantized": lambda dev: serve_quantized.main(
        ["--steps", "1", "--requests", "1", "--max-new", "2"], device=dev),
    "fault_tolerance": lambda dev: fault_tolerance.main(["--steps", "4"], device=dev),
    "train_lm_bsq": lambda dev: train_lm_bsq.main(["--steps", "1", "--workdir", ""],
                                                  device=dev),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_mains_refuse_to_run_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MAINS[name](None)
