"""The port's quality probe (``repro_torch.obs.quality``) against
``repro.obs.quality`` on reduced granite-3-2b, f32, 6-bit packed, params
bridged from JAX ``init_params``:

* ``truncate_model_planes``: the same bytes, leaf for leaf, as JAX's,
  whole-model and per layer group;
* ``quality_probe``: the same rows (logit MSE within 1e-5 relative and
  absolute, the f32 sums running in another order; top-1 agreement
  exact) and the same gauges under the same names;
* ``precision_tiers_from_probe``: the same tier table from those rows;
* ``replay_plane_log``: the tokens JAX's replay gives for one plane log.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as j_reduced_config
from repro.core.packing import PackedWeight as JPackedWeight
from repro.core.packing import pack_model_params as j_pack_model_params
from repro.models import transformer as jtf
from repro.obs import metrics as j_metrics
from repro.obs import quality as jq
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.packing import PackedWeight, tree_leaves
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import quality as tq
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_BITS = 6
TOL = 1e-5


@pytest.fixture(scope="module")
def packed():
    jcfg = j_reduced_config("granite-3-2b")
    jparams = jax.jit(functools.partial(jtf.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    jpacked = jax.jit(functools.partial(j_pack_model_params, n_bits=N_BITS))(jparams)
    return jcfg, jpacked, reduced_config("granite-3-2b"), bridge.from_numpy_tree(jpacked)


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, JPackedWeight))


@pytest.mark.parametrize("group", [None, "attn", "mlp"])
def test_truncate_model_planes_bytes_match_jax(packed, group):
    jcfg, jp, cfg, tp = packed
    suffixes = None if group is None else tq.LAYER_GROUPS[group]
    for k in range(1, N_BITS + 1):
        ours = tree_leaves(tq.truncate_model_planes(tp, k, suffixes))
        theirs = _jax_leaves(jq.truncate_model_planes(jp, k, suffixes))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            if isinstance(a, PackedWeight):
                assert (a.n_bits, a.k, a.denom_bits) == (b.n_bits, b.k, b.denom_bits)
                for f in ("planes", "sign", "scale"):
                    want = np.array(getattr(b, f))
                    got = getattr(a, f).contiguous().numpy()
                    assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (k, f)
            else:
                assert a.numpy().tobytes() == np.array(b).tobytes()


@pytest.fixture(scope="module")
def probes(packed):
    jcfg, jp, cfg, tp = packed
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    groups = ("all", "mlp")
    treg, jreg = t_metrics.Registry(), j_metrics.Registry()
    return (tq.quality_probe(tp, cfg, tokens, groups=groups, registry=treg),
            jq.quality_probe(jp, jcfg, tokens, groups=groups, registry=jreg), treg, jreg)


def test_quality_probe_rows_and_gauges_match_jax(probes):
    ours, theirs, treg, jreg = probes
    assert [(r.group, r.planes) for r in ours] == [(r.group, r.planes) for r in theirs]
    assert len(ours) == 2 * N_BITS
    for a, b in zip(ours, theirs):
        assert abs(a.logit_mse - b.logit_mse) <= TOL * max(1.0, abs(b.logit_mse)), (a, b)
        assert a.top1_agreement == b.top1_agreement, (a, b)
        assert a.to_dict().keys() == b.to_dict().keys()
    # full planes reproduce the full model
    full = [r for r in ours if r.planes == N_BITS]
    assert all(r.logit_mse == 0.0 and r.top1_agreement == 1.0 for r in full)
    snap = {"torch": treg.snapshot(), "jax": jreg.snapshot()}
    for name in ("serve_quality_logit_mse", "serve_quality_top1"):
        got, want = snap["torch"][name], snap["jax"][name]
        assert (got["type"], got["help"]) == (want["type"], want["help"])
        assert len(got["samples"]) == len(want["samples"]) == 2 * N_BITS
        for g, w in zip(got["samples"], want["samples"]):
            assert g["labels"] == w["labels"]
            assert abs(g["value"] - w["value"]) <= TOL * max(1.0, abs(w["value"])), (name, g)


@pytest.mark.parametrize("thresholds", [{"economy": 0.9}, {"economy": 0.5, "draft": 0.2},
                                        {"never": 1.0}, {"any": 0.0}])
def test_precision_tiers_from_probe_matches_jax(probes, thresholds):
    ours, theirs, _, _ = probes
    assert tq.precision_tiers_from_probe(ours, thresholds) \
        == jq.precision_tiers_from_probe(theirs, thresholds)


def test_probe_and_table_refusals_match_jax(packed, probes):
    jcfg, jp, cfg, tp = packed
    ours, theirs, _, _ = probes
    toks = np.zeros((1, 4), np.int32)
    for call in (lambda q, p, c, rows: q.quality_probe(p, c, toks, plane_counts=[0]),
                 lambda q, p, c, rows: q.quality_probe(p, c, toks, groups=("lm",)),
                 lambda q, p, c, rows: q.precision_tiers_from_probe(rows, {"x": 1.5}),
                 lambda q, p, c, rows: q.precision_tiers_from_probe(
                     [r for r in rows if r.group != "all"], {"x": 0.5})):
        for args in ((tq, tp, cfg, ours), (jq, jp, jcfg, theirs)):
            with pytest.raises(ValueError):
                call(*args)


def test_replay_plane_log_matches_jax(packed):
    """One plane log with switches in both directions, replayed by both
    packages from the same prompt: the same greedy tokens."""
    jcfg, jp, cfg, tp = packed
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=9).astype(np.int32)
    log = [6, 6, 3, 3, 2, 6, 3, 2]
    ours = tq.replay_plane_log(tp, cfg, prompt, log, 32)
    theirs = jq.replay_plane_log(jp, jcfg, prompt, log, 32)
    assert ours.dtype == np.int32 and len(ours) == len(log)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    assert len(tq.replay_plane_log(tp, cfg, prompt, [], 32)) == 0
