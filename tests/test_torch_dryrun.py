"""The port's dry run (``repro_torch.launch.dryrun``), its abstract shapes
(``core.packing.abstract_packed``, ``train.step.abstract_bsq_state`` /
``abstract_plain_state``), ``roofline.report`` and ``launch.hillclimb``,
against the JAX package's twins.

JAX's ``launch.dryrun`` and ``launch.hillclimb`` set ``XLA_FLAGS`` to 512
host devices when imported, which would leak into this process, so the
JAX side here is recomputed from ``jax.eval_shape`` trees, and those two
modules are read with ``ast``.  Every comparison is exact: paths, shapes,
dtypes, parameter counts, record keys.
"""
import ast
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core import BSQConfig as JBSQConfig
from repro.core.packing import abstract_packed as j_abstract_packed
from repro.core.packing import pack_model_params as j_pack_model_params
from repro.models import transformer as jtransformer
from repro.optim import SGDM as JSGDM
from repro.optim import AdamW as JAdamW
from repro.roofline.analysis import RooflineTerms as JRooflineTerms
from repro.train import step as jstep
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core import BSQConfig
from repro_torch.core.packing import (PackedWeight, abstract_packed, pack_model_params,
                                      pack_stacked_from_float)
from repro_torch.launch import dryrun, hillclimb
from repro_torch.models import transformer
from repro_torch.optim import SGDM, AdamW
from repro_torch.roofline import report
from repro_torch.train import abstract_bsq_state, abstract_plain_state, init_bsq_state
from repro_torch.tree import flatten_with_path
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _jax_module_ast(name):
    return ast.parse((ROOT / "src" / "repro" / "launch" / f"{name}.py").read_text())


def _jax_active_params():
    """JAX's ``dryrun._active_params``, compiled from its source."""
    fn = next(n for n in _jax_module_ast("dryrun").body
              if isinstance(n, ast.FunctionDef) and n.name == "_active_params")
    ns = {"jax": jax, "math": math}
    exec(compile(ast.Module([fn], []), "repro/launch/dryrun.py", "exec"), ns)
    return ns["_active_params"]


def _jax_leaves(tree):
    """{path: (shape, dtype)} of a JAX tree, PackedWeight fields as
    ``.../planes``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                        for p in path)
        out[name] = (tuple(leaf.shape), str(jnp.dtype(leaf.dtype)))
    return out


def _port_leaves(tree):
    out = {}
    for name, leaf in flatten_with_path(tree):
        fields = ({f"{name}/{k}": getattr(leaf, k) for k in ("planes", "sign", "scale")}
                  if isinstance(leaf, PackedWeight) else {name: leaf})
        for n, t in fields.items():
            out[n] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return out


def _j_params(cfg):
    return jax.eval_shape(lambda k: jtransformer.init_params(k, cfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("shape", [(64, 128), (3, 64, 128), (2, 4, 60, 96), (8, 8)])
def test_abstract_packed_matches_jax_and_real_packing(shape):
    want = j_abstract_packed(shape, 5)
    got = abstract_packed(shape, 5)
    real = pack_stacked_from_float(torch.randn(shape), 5)
    for field in ("planes", "sign", "scale"):
        j, a, r = getattr(want, field), getattr(got, field), getattr(real, field)
        assert tuple(j.shape) == tuple(a.shape) == tuple(r.shape), field
        assert str(jnp.dtype(j.dtype)) == str(a.dtype)[6:] == str(r.dtype)[6:], field
        assert a.device.type == "meta"
    assert (want.n_bits, want.k) == (got.n_bits, got.k) == (real.n_bits, real.k)


@pytest.mark.parametrize("arch", ARCH_IDS + ["granite-3-2b-full"])
def test_abstract_packed_tree_matches_jax(arch):
    full = arch.endswith("-full")
    arch = arch.removesuffix("-full")
    jcfg, cfg = ((j_get_config(arch), get_config(arch)) if full
                 else (j_reduced_config(arch), reduced_config(arch)))
    want = _jax_leaves(j_pack_model_params(_j_params(jcfg), 6, abstract=True))
    meta = transformer.init_params(cfg, torch.Generator(), "meta")
    assert _port_leaves(pack_model_params(meta, 6, abstract=True)) == want
    if not full:  # the port's real packing gives the same shapes
        real = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert _port_leaves(pack_model_params(real, 6)) == want


@pytest.mark.parametrize("arch", ARCH_IDS + ["granite-3-2b-full"])
def test_abstract_states_match_jax_and_the_concrete_ones(arch):
    full = arch.endswith("-full")
    arch = arch.removesuffix("-full")
    jcfg, cfg = ((j_get_config(arch), get_config(arch)) if full
                 else (j_reduced_config(arch), reduced_config(arch)))
    jstate, jctx = jstep.abstract_bsq_state(jcfg, JBSQConfig(n_init=8), JSGDM())
    state, ctx = abstract_bsq_state(cfg, BSQConfig(n_init=8), SGDM())
    assert _port_leaves(state) == _jax_leaves(jstate)
    assert ctx.meta == jctx.meta and ctx.total_quant_params == jctx.total_quant_params
    assert state["step"].device.type == "cpu" and state["step"].dtype == torch.int32
    assert all(t.device.type == "meta" for n, t in flatten_with_path(state) if n != "step")
    plain = abstract_plain_state(cfg, AdamW())
    assert _port_leaves(plain) == _jax_leaves(jstep.abstract_plain_state(jcfg, JAdamW()))
    if not full:
        concrete, cctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, BSQConfig(n_init=8),
                                        SGDM(), "cpu")
        assert _port_leaves(concrete) == _port_leaves(state)
        assert cctx.meta == ctx.meta


def test_active_params_match_jax_for_every_full_config():
    j_active = _jax_active_params()
    for arch in ARCH_IDS:
        want = j_active(j_get_config(arch), _j_params(j_get_config(arch)))
        params = transformer.init_params(get_config(arch), torch.Generator(), "meta")
        assert dryrun._active_params(get_config(arch), params) == want, arch
    # a packed tree counts the weights its PackedWeights stand for
    cfg = reduced_config("granite-3-2b")
    meta = transformer.init_params(cfg, torch.Generator(), "meta")
    assert dryrun._active_params(cfg, pack_model_params(meta, 4, abstract=True)) == \
        dryrun._active_params(cfg, meta)


def _jax_record_keys():
    """The keys JAX's ``run_cell`` writes on success: the initial dict and
    the ``rec.update(...)`` keywords."""
    fn = next(n for n in _jax_module_ast("dryrun").body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) == "rec":
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "update" \
                and any(k.arg == "status" and getattr(k.value, "value", None) == "ok"
                        for k in node.keywords):
            keys |= {k.arg for k in node.keywords}
    return keys


CELLS = [("granite-3-2b", "train_4k", "bsq", 2, 0), ("granite-3-2b", "train_4k", "plain", None, 0),
         ("llama-3.2-vision-11b", "prefill_32k", "bsq", None, 0),
         ("granite-3-2b", "decode_32k", "bsq", None, 6)]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    recs = [dryrun.run_cell(arch, shape, technique=tech, microbatches=mb, verbose=False,
                            cfg_override=reduced_config(arch), packed_bits=bits)
            for arch, shape, tech, mb, bits in CELLS]
    path = tmp_path_factory.mktemp("dryrun") / "dryrun.json"
    path.write_text(json.dumps(recs))
    return recs, str(path)


def test_run_cell_records_jax_keys(records):
    recs, _ = records
    j_terms = JRooflineTerms(1.0, 1.0, 0.0, {}, 1).to_dict()
    for rec, (arch, shape, tech, mb, bits) in zip(recs, CELLS):
        assert rec["status"] == "ok", rec.get("traceback")
        assert _jax_record_keys() <= set(rec), set(rec)
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                      "peak_bytes"}
        assert set(j_terms) <= set(rec["roofline"])
        assert rec["mesh"] == "1" and rec["arch"] == arch and rec["shape"] == shape
        assert rec["roofline"]["flops_per_device"] > 0 and rec["memory"]["temp_bytes"] > 0
        assert rec["microbatches"] == (mb if mb else 16 if shape == "train_4k" else 1)
    train, plain, prefill, decode = recs
    assert train["roofline"]["kernel_launches"] == {"bgl_sumsq": 1, "bgl_sumsq_backward": 1}
    assert plain["roofline"]["kernel_launches"] == {} and plain["technique"] == "plain"
    assert prefill["technique"] == "serve" and prefill["roofline"]["kernel_launches"] == {}
    assert decode["roofline"]["kernel_launches"]["bitserial_matmul"] > 0


def test_report_renders_and_summarises(records):
    recs, path = records
    table = report.render(path)
    assert table.count("\n") == len(recs) + 1
    assert "granite-3-2b | train_4k | 1 | 2 | NO" in table  # 256 x 4096 tokens
    assert "llama-3.2-vision-11b | prefill_32k" in table
    assert report.render(path, mesh_filter="16x16").endswith("|---|\n")  # header only
    s = report.summary(path)
    assert s.startswith(f"cells ok: {len(recs)}/{len(recs)}")
    assert "memory-bound" in s or "compute-bound" in s


def test_multi_pod_cell_fails_naming_the_mesh_slice():
    """The 2x16x16 cell, once refused, runs: full-width granite-3-2b x
    decode_32k as rank 0 of the pod mesh, its collective bytes non-zero by
    kind and its per-device figures rank 0's (512 devices)."""
    rec = dryrun.run_cell("granite-3-2b", "decode_32k", multi_pod=True, verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16", rec.get("traceback")
    coll = rec["roofline"]["collectives"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert rec["roofline"]["n_devices"] == 512
    assert rec["roofline"]["kernel_launches"] == {}


def _jax_literal(module, name):
    node = next(n for n in _jax_module_ast(module).body
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == name)
    return ast.literal_eval(node.value)


def test_hillclimb_keeps_jax_cells_labels_and_overrides_without_tpu_figures(tmp_path,
                                                                            monkeypatch):
    assert hillclimb.CELLS == _jax_literal("hillclimb", "CELLS")
    j_variants = _jax_literal("hillclimb", "VARIANTS")
    assert {c: [(v[0], v[2], v[3]) for v in vs] for c, vs in hillclimb.VARIANTS.items()} == \
        {c: [(v[0], v[2], v[3]) for v in vs] for c, vs in j_variants.items()}
    for vs in hillclimb.VARIANTS.values():
        for label, hyp, _, _ in vs:
            assert not re.search(r"\d+\s*(ms|GiB|MB|GB|chips)\b|TPU", hyp), (label, hyp)
    # A6 runs the 2x16x16 cell (reduced widths here: a full-width train cell
    # takes minutes on the host; chip_smoke.py's phase 6e runs it at full width)
    monkeypatch.setattr(hillclimb, "get_config", reduced_config)
    out = tmp_path / "hc.json"
    hillclimb.main(["--cell", "A", "--only", "dots_bf16_multipod", "--out", str(out)])
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["label"] == "dots_bf16_multipod" and rec["cell"] == "A"
    assert rec["mesh"] == "2x16x16" and rec["microbatches"] == 8
    assert rec["roofline"]["collectives"]["all-gather"] > 0


def test_hillclimb_aliases_copy_their_source_record(tmp_path, monkeypatch):
    """'spmd_ce' and 'spmd_ce_dots_bf16' would rerun 'baseline' and
    'dots+bf16' exactly (the port has no sharded cross entropy): they copy
    those records instead of running the cell again."""
    calls = []

    def fake_run_cell(arch, shape, cfg_override=None, **kw):
        calls.append((arch, shape, cfg_override.remat_policy, cfg_override.attn_scores_dtype))
        return {"arch": arch, "shape": shape, "status": "ok", "n": len(calls)}

    monkeypatch.setattr(hillclimb, "run_cell", fake_run_cell)
    out = tmp_path / "hc.json"
    hillclimb.main(["--cell", "A", "--only", "baseline,spmd_ce,dots+bf16,spmd_ce_dots_bf16",
                    "--out", str(out)])
    assert calls == [("granite-3-2b", "train_4k", "nothing", "float32"),
                     ("granite-3-2b", "train_4k", "dots", "bfloat16")]
    recs = {r["label"]: r for r in json.loads(out.read_text())}
    assert set(recs) == {"baseline", "spmd_ce", "dots+bf16", "spmd_ce_dots_bf16"}
    assert recs["spmd_ce"]["alias_of"] == "baseline" and recs["spmd_ce"]["n"] == 1
    assert recs["spmd_ce_dots_bf16"]["alias_of"] == "dots+bf16"
    assert recs["spmd_ce_dots_bf16"]["n"] == 2
    assert "alias_of" not in recs["baseline"]
    assert set(hillclimb.ALIASES) <= {(c, v[0]) for c, vs in hillclimb.VARIANTS.items()
                                      for v in vs}


@pytest.mark.parametrize("hoist", [True, False])
def test_microbatched_bsq_step_of_an_embeds_model(hoist):
    """The dry run's musicgen-large x train_4k cell found the hoisted
    microbatched BSQ step raising on the embedding, which an ``embeds``
    batch never reads: it now takes a zero gradient there, as one batch
    does.  microbatches=2 against 1 on reduced musicgen, f32, CPU, at
    ``test_torch_train.py``'s accumulation tolerance."""
    from repro_torch.models.frontends import synthetic_batch
    from repro_torch.optim import step_decay
    from repro_torch.train import make_bsq_train_step

    cfg = reduced_config("musicgen-large")
    batch = synthetic_batch(cfg, 4, 8, torch.Generator().manual_seed(3), "cpu")
    batch["labels"] = batch["labels"].long()
    out = []
    for mb in (1, 2):
        state, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg,
                                    BSQConfig(n_init=8, compute_dtype=torch.float32), SGDM(),
                                    "cpu")
        step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [2]), microbatches=mb,
                                   hoist_reconstruct=hoist)
        out.append(step(state, batch))
    (s1, m1), (s2, m2) = out
    for k in ("ce", "reg", "total", "grad_norm"):
        assert abs(float(m2[k]) - float(m1[k])) <= 1e-5 * abs(float(m1[k])), k
    for (name, x), (_, y) in zip(flatten_with_path(s1), flatten_with_path(s2)):
        torch.testing.assert_close(y, x, rtol=0, atol=1e-5, msg=name)
