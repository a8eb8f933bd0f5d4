"""Superblock rematerialisation in the port's ``forward`` (``cfg.remat``,
``cfg.remat_policy``) on reduced granite-3-2b, qwen2-moe-a2.7b and
llama-3.2-vision-11b, f32, on the CPU.

Every policy gives gradients bitwise equal to remat off (the recompute
runs the same ops on the same inputs).  Against JAX's remat gradients
(``jax.checkpoint``, policy "nothing"; JAX's policies give it the same
values): loss and global gradient norm within 1e-5 relative, the
per-step metric tolerance of ``test_torch_train.py``, every gradient leaf
within 2e-4 absolute and relative, the model tolerance of
``test_torch_model.py`` and ``test_torch_frontends.py`` (f32 sums in
another order).  And each policy saves what it names: the products the
backward recomputes are counted.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import transformer as jtransformer
from repro_torch.configs import reduced_config
from repro_torch.models import transformer
from repro_torch.roofline import analysis
from repro_torch.train.step import value_and_grad
from repro_torch.tree import flatten_with_path, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["granite-3-2b", "qwen2-moe-a2.7b", "llama-3.2-vision-11b"]
POLICIES = ["nothing", "dots", "mlp_names", "dots_offload"]
B, S = 2, 16
STEP_TOL = 1e-5
GRAD_TOL = 2e-4

_MODELS = {}


def _model(arch):
    """Port params drawn from a seed, their numpy copy, a numpy batch and
    the port's loss and gradients with remat off."""
    if arch not in _MODELS:
        cfg = reduced_config(arch)
        assert not cfg.remat
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
        if cfg.frontend == "vision":
            batch["cross_embeds"] = rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        _MODELS[arch] = {"cfg": cfg, "params": params, "batch": batch,
                         "off": _grads(params, batch, cfg)}
    return _MODELS[arch]


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _grads(params, batch, cfg):
    loss, _, g = value_and_grad(lambda p: transformer.loss_fn(p, _port_batch(batch), cfg),
                                params)
    return loss, dict(flatten_with_path(g))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bitwise_equal_remat_off(arch, policy):
    m = _model(arch)
    loss, grads = _grads(m["params"], m["batch"], m["cfg"].scaled(remat=True,
                                                                 remat_policy=policy))
    off_loss, off = m["off"]
    assert torch.equal(loss, off_loss)
    assert grads.keys() == off.keys()
    for name, g in grads.items():
        assert torch.equal(g, off[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_match_jax(arch):
    m = _model(arch)
    jcfg = dataclasses.replace(j_reduced_config(arch), remat=True, remat_policy="nothing")
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        functools.partial(jtransformer.loss_fn, cfg=jcfg), has_aux=True))(
        tree_map(lambda t: jnp.asarray(t.numpy()), m["params"]),
        {k: jnp.asarray(v) for k, v in m["batch"].items()})
    jflat = {k: np.array(v) for k, v in flatten_with_path(jgrad)}
    loss, grads = _grads(m["params"], m["batch"], m["cfg"].scaled(remat=True,
                                                                 remat_policy="nothing"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_TOL)
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    jnorm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in jflat.values()))
    np.testing.assert_allclose(norm, jnorm, rtol=STEP_TOL)
    assert grads.keys() == jflat.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[name], atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def _backward_products(policy):
    """aten.mm calls of reduced granite-3-2b's backward under ``policy``:
    the gradient products plus the forward products it recomputes."""
    m = _model("granite-3-2b")
    cfg = m["cfg"] if policy == "none" else m["cfg"].scaled(remat=True, remat_policy=policy)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), m["params"])
    loss, _ = transformer.loss_fn(params, _port_batch(m["batch"]), cfg)
    leaves = [t for _, t in flatten_with_path(params)]
    with analysis.Counter() as c:
        torch.autograd.grad(loss, leaves)
    return c.terms().op_bytes["aten.mm"][1]


def test_policies_recompute_what_they_do_not_save():
    """Per superblock (one layer) granite's forward runs 7 products, 2 of
    them the MLP's gate and up ("mlp_wide"); the recompute stops once it
    has every tensor the backward saved, so the last one (``w_down``,
    whose output only the residual add reads) is never rerun: "nothing"
    recomputes 6, "dots" and "dots_offload" none, "mlp_names" 4."""
    off = _backward_products("none")
    n_layers = reduced_config("granite-3-2b").n_layers
    assert _backward_products("nothing") == off + 6 * n_layers
    assert _backward_products("dots") == _backward_products("dots_offload") == off
    assert _backward_products("mlp_names") == off + 4 * n_layers


def test_no_remat_without_autograd(monkeypatch):
    """Under ``torch.no_grad`` (serving, the dry run's prefill) the forward
    never checkpoints; with grad it wraps each superblock once."""
    m = _model("granite-3-2b")
    cfg = m["cfg"].scaled(remat=True, remat_policy="nothing")
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batch = _port_batch(m["batch"])
    with torch.no_grad():
        transformer.forward(m["params"], batch, cfg)
    assert calls == []
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), m["params"])
    transformer.forward(params, batch, cfg)
    assert len(calls) == cfg.n_superblocks
    with pytest.raises(ValueError, match="remat_policy"):
        transformer.forward(params, batch, cfg.scaled(remat_policy="bogus"))


def test_policies_order_the_counted_peak():
    """What remat is for: the live bytes of a loss-and-gradient pass, as
    the dry run's counter estimates them on meta (full-width granite-3-2b
    cut to 4 layers, one 1024-token sequence).  "nothing" keeps the least,
    "mlp_names" the gate and up products on top, "dots" every 2-D
    product, and no remat keeps every activation; "dots_offload" keeps the
    "dots" set where the tensors live (the card moves it to the host)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import SGDM
    from repro_torch.train import abstract_plain_state

    cfg = get_config("granite-3-2b").scaled(n_layers=4)
    params = abstract_plain_state(cfg, SGDM())["params"]
    batch = {k: torch.empty((1, 1024), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    peak = {}
    for pol in ["none"] + POLICIES:
        c = cfg.scaled(remat_policy=pol)
        with analysis.Counter() as counter:
            value_and_grad(lambda p: transformer.loss_fn(p, batch, c), params)
        peak[pol] = counter.peak_live
    assert peak["nothing"] < peak["mlp_names"] < peak["dots"] < peak["none"]
    assert peak["dots_offload"] == peak["dots"]
    assert peak["none"] > 1.5 * peak["nothing"]
