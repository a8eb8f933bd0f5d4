"""The paper's own model: the port's ResNet-20, its BSQ pipeline and the
DoReFa finetune functions against the JAX package.

Inputs are made with numpy from a seed (``gaussian_blobs``) and handed to
both; the port runs on JAX's params carried across by ``bridge``.
Tolerances:

* forward logits: 1e-4 of max |JAX logit| (f32 convs summed in another
  order); BN statistics 1e-5 absolute;
* BSQ losses: 1e-4 relative at every step; masks and per-layer bits
  after requant: exact;
* ``apply_scheme_dorefa``: 1e-6 absolute (the DoReFa levels are f32
  divisions; no element may land on another level at a rounding tie);
  ``finetune_loss_fn``: 1e-5 relative.

Activation quantisation is discontinuous: an f32 rounding difference at
a level boundary moves one activation by a whole level (0.4) and the
change spreads.  At these batch sizes and seeds no activation sits that
close to a boundary; the card-against-CPU check (``chip_smoke.py`` phase
6b) handles larger batches by feeding both sides the same quantised
activations and counting the ties.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import reduced_config as j_reduced_config
from repro.core import BSQConfig as JBSQConfig
from repro.core import extract_scheme as j_extract_scheme
from repro.core import bsq as jbsq
from repro.core.qat import apply_scheme_dorefa as j_apply_scheme_dorefa
from repro.core.qat import finetune_loss_fn as j_finetune_loss_fn
from repro.core.scheme import QuantScheme
from repro.data import gaussian_blobs as j_gaussian_blobs
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models import resnet as jresnet
from repro.optim import SGDM as JSGDM
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core import bsq
from repro_torch.core.qat import apply_scheme_dorefa, finetune_loss_fn
from repro_torch.data import gaussian_blobs
from repro_torch.examples import resnet20_bsq_paper as paper
from repro_torch.models import resnet, transformer
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL, BN_TOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _jax_params(width):
    return jax.jit(functools.partial(jresnet.init_resnet20, width=width))(jax.random.PRNGKey(0))


def _images(batch, seed=1):
    b = gaussian_blobs(np.random.default_rng(seed), batch)
    jb = j_gaussian_blobs(np.random.default_rng(seed), batch)
    assert np.array_equal(b["images"], jb["images"]) and np.array_equal(b["labels"], jb["labels"])
    return b


def _forward_both(jp, images, width, train, act_bits):
    jl, jstats = jresnet.resnet20_forward(jp, jnp.asarray(images), train=train,
                                          act_bits=act_bits, width=width)
    with torch.no_grad():
        tl, tstats = resnet.resnet20_forward(bridge.from_numpy_tree(jp), torch.from_numpy(images),
                                             train=train, act_bits=act_bits, width=width)
    return np.array(jl), jstats, tl.numpy(), tstats


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("act_bits", [32, 4])
@pytest.mark.parametrize("width", [8, 16])
def test_forward_matches_jax(width, act_bits, train):
    jl, jstats, tl, tstats = _forward_both(_jax_params(width), _images(4)["images"], width, train,
                                           act_bits)
    assert tl.shape == jl.shape == (4, 10)
    np.testing.assert_allclose(tl, jl, atol=TOL * np.abs(jl).max(), rtol=0)
    assert sorted(tstats) == sorted(jstats)
    for name, s in jstats.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(tstats[name][k].numpy(), np.array(s[k]), atol=BN_TOL,
                                       rtol=0)


def test_stride2_same_padding_matches_lax():
    """lax's "SAME" pads a 3x3 stride-2 conv on an even input by (0, 1):
    with only the last row and column nonzero, symmetric padding would
    read them at other output positions.  The whole width-8 model and
    the conv alone both agree with JAX; ``padding=1`` does not."""
    img = np.zeros((2, 32, 32, 3), np.float32)
    rng = np.random.default_rng(3)
    img[:, -1, :, :] = rng.standard_normal((2, 32, 3))
    img[:, :, -1, :] = rng.standard_normal((2, 32, 3))
    jl, _, tl, _ = _forward_both(_jax_params(8), img, 8, False, 32)
    np.testing.assert_allclose(tl, jl, atol=TOL * np.abs(jl).max(), rtol=0)

    jw = _jax_params(8)["s1b0_conv1"]  # 3x3, 8 -> 16, stride 2
    x = np.zeros((2, 16, 16, 8), np.float32)
    x[:, -1, :, :] = rng.standard_normal((2, 16, 8))
    x[:, :, -1, :] = rng.standard_normal((2, 16, 8))
    want = np.array(jresnet._conv(jnp.asarray(x), jw, 2))
    xt, wt = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(np.array(jw))
    got = resnet._conv(xt, wt, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    symmetric = F.conv2d(xt, wt.permute(3, 2, 0, 1), stride=2, padding=1).permute(0, 2, 3, 1)
    assert symmetric.shape == got.shape and np.abs(symmetric.numpy() - want).max() > 0.1


def test_bn_kept_float_convs_quantized():
    p = resnet.init_resnet20(torch.Generator().manual_seed(0), device="cpu")
    qp, fp = bsq.partition_params(p, bsq.default_quant_predicate)
    assert any("conv" in k for k in qp) and "fc" in qp and len(qp) == 22
    assert all("bn" not in k for k in qp) and "fc_bias" in fp
    assert any("bnscale" in k for k in fp) and any(k.endswith("/var") for k in fp)
    assert sum(v.numel() for v in qp.values()) == 270_896
    # the layouts stay JAX's: HWIO kernels, the same tree
    jp = _jax_params(16)
    assert {k: tuple(v.shape) for k, v in qp.items()} == {
        k: tuple(v.shape) for k, v in jbsq.partition_params(jp, jbsq.default_quant_predicate)[0]
        .items()}


def test_act_quant_changes_forward():
    p = resnet.init_resnet20(torch.Generator().manual_seed(0), width=8, device="cpu")
    x = torch.from_numpy(gaussian_blobs(np.random.default_rng(1), 4)["images"])
    with torch.no_grad():
        l32, _ = resnet.resnet20_forward(p, x, act_bits=32, width=8)
        l2, _ = resnet.resnet20_forward(p, x, act_bits=2, width=8)
    assert float(torch.max(torch.abs(l32 - l2))) > 1e-4


def test_merge_bn_stats_and_loss_match_jax():
    jp = _jax_params(8)
    b = _images(6, seed=2)
    jl, jstats = jresnet.resnet20_forward(jp, jnp.asarray(b["images"]), train=True, width=8)
    tp = bridge.from_numpy_tree(jp)
    with torch.no_grad():
        tl, tstats = resnet.resnet20_forward(tp, torch.from_numpy(b["images"]), train=True,
                                             width=8)
    merged, jmerged = resnet.merge_bn_stats(tp, tstats), jresnet.merge_bn_stats(jp, jstats)
    assert sorted(merged["bn0"]) == sorted(jmerged["bn0"]) == ["bnbias", "bnscale", "mean", "var"]
    np.testing.assert_allclose(merged["s2b2_bn2"]["var"].numpy(),
                               np.array(jmerged["s2b2_bn2"]["var"]), atol=BN_TOL)
    want = float(jresnet.classification_loss(jl, jnp.asarray(b["labels"])))
    got = float(resnet.classification_loss(tl, torch.from_numpy(b["labels"])))
    assert abs(got - want) <= TOL * abs(want)


def _jax_pipeline(jp, images, labels, steps, width):
    """The JAX example's BSQ loop (``examples/resnet20_bsq_paper.py``) on
    one batch: losses per step, then the requantised reps."""
    qp, fp = jbsq.partition_params(jp, jbsq.default_quant_predicate)
    cfg = JBSQConfig(n_init=8, alpha=paper.ALPHA, mode="static", compute_dtype=jnp.float32)
    # jitted: eager JAX compiles each op anew for each of the 22 shapes
    reps = jax.jit(lambda q: jbsq.init_bitreps(q, cfg, group_axes_fn=lambda n, w: ()))(qp)
    opt = JSGDM(momentum=0.9, weight_decay=1e-4)
    trainable = {k: r.trainable() for k, r in reps.items()}
    opt_state = opt.init(trainable)

    def replace(trainable):
        return {k: dataclasses.replace(reps[k], wp=t["wp"], wn=t["wn"], scale=t["scale"])
                for k, t in trainable.items()}

    def loss_fn(trainable):
        rs = replace(trainable)
        p = jbsq.merge_params(jp, jbsq.reconstruct(rs, cfg), fp)
        logits, _ = jresnet.resnet20_forward(p, images, train=False, act_bits=paper.ACT_BITS,
                                             width=width)
        return jresnet.classification_loss(logits, labels) + cfg.alpha * jbsq.regularizer(rs, cfg)

    step = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for _ in range(steps):
        loss, g = step(trainable)
        losses.append(float(loss))
        trainable, opt_state = opt.update(g, opt_state, trainable, paper.LR)
        for k in trainable:
            trainable[k]["wp"] = jnp.clip(trainable[k]["wp"], 0, 2)
            trainable[k]["wn"] = jnp.clip(trainable[k]["wn"], 0, 2)
    return losses, jax.jit(lambda r: jbsq.requantize_tree(r, "static"))(replace(trainable))


def test_bsq_pipeline_matches_jax():
    """8 BSQ steps of the paper's pipeline at width 8 on one batch of 32
    (``tests/test_resnet_repro.py``'s setup): every loss, then the masks
    and the per-layer scheme after requant."""
    width, steps = 8, 8
    jp = _jax_params(width)
    b = _images(32, seed=0)
    jlosses, jreps = _jax_pipeline(jp, jnp.asarray(b["images"]), jnp.asarray(b["labels"]),
                                   steps, width)
    run = paper.PaperBSQ(bridge.from_numpy_tree(jp), width)
    images, labels = torch.from_numpy(b["images"]), torch.from_numpy(b["labels"]).long()
    losses = [float(run.step(images, labels)["loss"]) for _ in range(steps)]
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=0)
    assert losses[-1] < losses[0]
    scheme = run.requant()
    assert sorted(run.reps) == sorted(jreps)
    for name, r in run.reps.items():
        assert torch.equal(r.mask, torch.from_numpy(np.array(jreps[name].mask))), name
    assert scheme.layer_bits() == j_extract_scheme(jreps).layer_bits()
    assert 0 < scheme.bits_per_param <= 9


# ----------------------------------------------------------------- core.qat


@functools.lru_cache(maxsize=None)
def _jax_granite():
    jcfg = j_reduced_config("granite-3-2b")
    return jcfg, jax.jit(functools.partial(j_init_params, cfg=jcfg))(jax.random.PRNGKey(0))


def _granite_scheme(per_group, seed=0):
    """Reduced granite-3-2b's JAX params, their quantised part, and a
    scheme with random precisions (0..8 and 32): one per tensor, or one
    per layer of each stacked tensor."""
    jcfg, jp = _jax_granite()
    qp, fp = jbsq.partition_params(jp)
    rng = np.random.default_rng(seed)
    bits, numel = {}, {}
    for name, w in qp.items():
        gshape = tuple(w.shape[:1]) if per_group and w.ndim == 3 else ()
        bits[name] = rng.choice([0, 1, 2, 3, 4, 5, 6, 8, 32], size=gshape).astype(np.int32)
        numel[name] = int(np.prod(w.shape[len(gshape):]))
    return jcfg, jp, qp, fp, QuantScheme(bits=bits, group_numel=numel)


@pytest.mark.parametrize("per_group", [False, True])
def test_apply_scheme_dorefa_matches_jax(per_group):
    _, _, qp, _, scheme = _granite_scheme(per_group)
    want = j_apply_scheme_dorefa(qp, scheme)
    got = apply_scheme_dorefa({k: torch.from_numpy(np.array(v)) for k, v in qp.items()}, scheme)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w, g = np.array(w), got[name].numpy()
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=name)
        bits = scheme.bits[name]
        if bits.ndim == 0 and 0 < int(bits) < 32:
            # levels 2/(2^k - 1) apart: a tie rounded the other way moves a whole level
            assert np.sum(np.abs(g - w) > 1.0 / (2 ** int(bits) - 1)) == 0, name
            assert len(np.unique(g)) <= 2 ** int(bits) + 1
        elif per_group and bits.ndim == 1:
            for i, k in enumerate(bits):
                if 0 < k < 32:
                    assert np.sum(np.abs(g[i] - w[i]) > 1.0 / (2 ** int(k) - 1)) == 0, name


def test_finetune_loss_fn_matches_jax():
    jcfg, jp, qp, fp, scheme = _granite_scheme(True, seed=1)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 17))
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    jloss = j_finetune_loss_fn(lambda p, b: j_loss_fn(p, b, jcfg)[0], scheme,
                               lambda wq, f: jbsq.merge_params(jp, wq, f))(qp, fp, jbatch)
    cfg = reduced_config("granite-3-2b")
    tp = bridge.from_numpy_tree(jp)
    tq, tf = bsq.partition_params(tp)
    batch = {k: torch.from_numpy(np.array(v)).long() for k, v in jbatch.items()}
    loss = finetune_loss_fn(lambda p, b: transformer.loss_fn(p, b, cfg)[0], scheme,
                            lambda wq, f: bsq.merge_params(tp, wq, f))(tq, tf, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
