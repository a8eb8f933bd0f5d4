"""The port's Mamba-2 SSD block (``models/ssm.py``) and the "ssm" layer
kind against the JAX package, on the CPU, at f32 (params drawn as numpy
arrays and carried to both packages, inputs from numpy with a seed):

* ``ssd_chunked`` at chunks 4, 8 and 16 and with an entering state;
* ``ssm_apply``, ``ssm_prefill_chunk`` (pad positions, and an
  ``n_valid = 0`` lane whose state and conv tail pass through bitwise)
  and ``ssm_decode``; decode continuing a prefill
  (``tests/test_mixers.py::test_ssm_decode_continues_prefill``);
* reduced mamba2-130m (2 layers, d_model 64, 8 heads of 16, state 16):
  forward, ``loss_fn`` and its gradients, prefill plus decode logits and
  caches;
* the bucketed, legacy, chunked and paged engines give the JAX bucketed
  oracle's greedy tokens (the mamba2 cases of
  ``tests/test_chunked_prefill.py::test_chunked_ring_and_recurrent_archs``
  and ``tests/test_paged_serve.py::test_paged_ring_and_recurrent_archs``),
  the allocator drained.

Tolerances: the mixer functions 1e-5 absolute plus 1e-4 relative (f32;
the two frameworks sum the einsums in other orders); the model's logits,
caches and gradients 2e-4 absolute and relative, as
``tests/test_torch_model.py``; tokens exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.scheduler import SchedulerPolicy
from repro_torch.tree import flatten_with_path, tree_map

ARCH = "mamba2-130m"
TOL = (1e-5, 1e-4)  # (absolute, relative): mixer functions
MODEL_TOL = (2e-4, 2e-4)  # logits, caches, gradients
MAX_LEN = 64
D, EXPAND, HD, STATE, W = 16, 2, 8, 8, 4  # a mixer of d_inner 32, 4 heads


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.array(want), atol=tol[0], rtol=tol[1])


@pytest.fixture(scope="module")
def mixer():
    p = tree_map(lambda t: t.numpy(),
                 tssm.ssm_init(torch.Generator().manual_seed(0), D, EXPAND, HD, STATE, W, "cpu"))
    # a non-trivial gated norm, dt bias and conv bias (the init's are 0)
    rng = np.random.default_rng(1)
    d_inner, H, conv_dim = tssm.ssm_dims(D, EXPAND, HD, STATE)
    p.update(norm={"scale": (rng.standard_normal(d_inner) * 0.1).astype(np.float32)},
             dt_bias=(rng.standard_normal(H) * 0.5).astype(np.float32),
             conv_b=(rng.standard_normal(conv_dim) * 0.1).astype(np.float32))
    return jax.tree.map(jnp.asarray, p), bridge.from_numpy_tree(p)


KW = dict(expand=EXPAND, head_dim=HD, state=STATE)


@pytest.mark.parametrize("chunk,with_h0", [(4, False), (8, False), (16, False), (4, True)])
def test_ssd_chunked_matches_jax(chunk, with_h0):
    Bsz, S, H, P, N = 2, 16, 3, 4, 8
    rng = np.random.default_rng(chunk + 10 * with_h0)
    xs = (rng.standard_normal((Bsz, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm, Cm = ((rng.standard_normal((Bsz, S, N)) * 0.5).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((Bsz, H, P, N)).astype(np.float32) if with_h0 else None
    jy, jh = jax.jit(functools.partial(jssm.ssd_chunked, chunk=chunk))(
        *map(jnp.asarray, (xs, dt, a, Bm, Cm)), h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(torch.from_numpy, (xs, dt, a, Bm, Cm)), chunk=chunk,
                              h0=None if h0 is None else torch.from_numpy(h0))
    _close(ty, jy)
    _close(th, jh)


def test_ssm_apply_matches_jax(mixer):
    jp, tp = mixer
    x = (np.random.default_rng(2).standard_normal((2, 12, D)) * 0.5).astype(np.float32)
    jy, jh = jax.jit(functools.partial(jssm.ssm_apply, chunk=4, **KW))(jp, jnp.asarray(x))
    ty, th = tssm.ssm_apply(tp, torch.from_numpy(x), chunk=4, **KW)
    _close(ty, jy)
    _close(th, jh)


def test_ssm_prefill_chunk_matches_jax_and_passes_idle_lanes_through(mixer):
    """Lane 0 has 8 real tokens, lane 1 three behind pads, lane 2 none:
    its state and conv tail come back bitwise, the pads are no-ops."""
    jp, tp = mixer
    d_inner, H, conv_dim = jssm.ssm_dims(D, EXPAND, HD, STATE)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 8, D)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((3, H, HD, STATE)) * 0.5).astype(np.float32)
    conv = (rng.standard_normal((3, W - 1, conv_dim)) * 0.5).astype(np.float32)
    nv = np.array([8, 3, 0], np.int32)
    jy, jh, jc = jax.jit(functools.partial(jssm.ssm_prefill_chunk, **KW))(
        jp, *map(jnp.asarray, (x, h0, conv, nv)))
    ty, th, tc = tssm.ssm_prefill_chunk(tp, *map(torch.from_numpy, (x, h0, conv, nv)), **KW)
    _close(ty[0], np.array(jy)[0])
    _close(ty[1, :3], np.array(jy)[1, :3])
    _close(th, jh)
    _close(tc, jc)
    assert torch.equal(th[2], torch.from_numpy(h0[2]))
    assert torch.equal(tc[2], torch.from_numpy(conv[2]))
    # three real tokens behind pads leave the state three tokens leave
    _, th3, tc3 = tssm.ssm_prefill_chunk(tp, torch.from_numpy(x[1:2, :3]),
                                         torch.from_numpy(h0[1:2]),
                                         torch.from_numpy(conv[1:2]),
                                         torch.tensor([3], dtype=torch.int32), **KW)
    _close(th[1:2], th3.numpy())
    assert torch.equal(tc[1:2], tc3)


def test_ssm_decode_matches_jax_and_continues_prefill(mixer):
    """One decode step against JAX's, and ``ssm_apply`` over 10 tokens
    == ``ssm_apply`` over 9 plus one ``ssm_decode`` step (the conv tail
    from the 3 inputs before it through ``in_proj``)."""
    jp, tp = mixer
    d_inner, H, conv_dim = jssm.ssm_dims(D, EXPAND, HD, STATE)
    rng = np.random.default_rng(4)
    x1 = (rng.standard_normal((2, 1, D)) * 0.5).astype(np.float32)
    h = (rng.standard_normal((2, H, HD, STATE)) * 0.5).astype(np.float32)
    conv = (rng.standard_normal((2, W - 1, conv_dim)) * 0.5).astype(np.float32)
    want = jax.jit(functools.partial(jssm.ssm_decode, **KW))(jp, *map(jnp.asarray,
                                                                       (x1, h, conv)))
    got = tssm.ssm_decode(tp, *map(torch.from_numpy, (x1, h, conv)), **KW)
    for g, w in zip(got, want):
        _close(g, w)

    x = torch.from_numpy((rng.standard_normal((2, 10, D)) * 0.5).astype(np.float32))
    y_full, _ = tssm.ssm_apply(tp, x, chunk=5, **KW)
    _, h9 = tssm.ssm_apply(tp, x[:, :9], chunk=3, **KW)
    tail = (x[:, 6:9] @ tp["in_proj"])[..., d_inner:d_inner + conv_dim]
    y1, _, _ = tssm.ssm_decode(tp, x[:, 9:10], h9, tail, **KW)
    _close(y1[:, 0], y_full[:, 9].numpy(), (2e-4, 2e-3))


# ---------------------------------------------------------------------------
# Reduced mamba2-130m
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """Random params of JAX's layout and distributions as numpy arrays,
    drawn with the port's ``init_params`` (cheaper than a JAX draw)."""
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    params = tree_map(lambda t: t.numpy(),
                      ttf.init_params(cfg, torch.Generator().manual_seed(1), "cpu"))
    return jcfg, cfg, jax.tree.map(jnp.asarray, params), bridge.from_numpy_tree(params)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_forward_loss_and_gradients_match_jax(model):
    jcfg, cfg, jp, tp = model
    assert cfg.layer_pattern == ("ssm",) and cfg.d_ff == 0
    toks = _tokens((2, 17), 5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, _ = jax.jit(functools.partial(jtf.forward, cfg=jcfg))(jp, {"tokens": batch["tokens"]})
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        functools.partial(jtf.loss_fn, cfg=jcfg), has_aux=True))(jp, batch)
    tp = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tl, _ = ttf.forward(tp, tbatch, cfg)
    _close(tl, jl, MODEL_TOL)
    loss, _ = ttf.loss_fn(tp, tbatch, cfg)
    loss.backward()
    _close(loss, jloss, MODEL_TOL)
    jflat = dict(flatten_with_path(jgrad))
    for name, t in flatten_with_path(tp):
        assert t.grad is not None and torch.isfinite(t.grad).all(), name
        _close(t.grad, jflat[name], MODEL_TOL)


def test_prefill_and_decode_match_jax(model):
    """Prefill 24 tokens (an ssm_chunk of 256 takes them whole), then 6
    decode steps: logits and the whole cache (state f32, conv tail)."""
    jcfg, cfg, jp, tp = model
    toks, nxt = _tokens((2, 24), 6), _tokens((2, 6), 7)
    jl, jcache = jax.jit(functools.partial(jtf.prefill, cfg=jcfg, max_len=MAX_LEN,
                                           cache_dtype=jnp.float32))(jp, {"tokens": toks})
    with torch.no_grad():
        tl, tcache = ttf.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cfg, MAX_LEN)
    _close(tl, jl, MODEL_TOL)
    step = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    for t in range(nxt.shape[1]):
        jl, jcache = step(jp, jcache, jnp.asarray(nxt[:, t:t + 1]), jnp.int32(24 + t))
        with torch.no_grad():
            tl, _ = ttf.decode_step(tp, tcache, torch.from_numpy(nxt[:, t:t + 1]).long(),
                                    24 + t, cfg)
        _close(tl, jl, MODEL_TOL)
    for name, leaf in flatten_with_path(tcache):
        assert leaf.dtype == (torch.float32), name
        _close(leaf, dict(flatten_with_path(jcache))[name], MODEL_TOL)


def _requests(cls, cfg):
    """The prompts of test_chunked_ring_and_recurrent_archs: 4, 9, 14 and
    19 tokens, 8 new each."""
    return [cls(uid=i, tokens=(np.arange(4 + 5 * i, dtype=np.int32) + i) % cfg.vocab_size,
                max_new=8) for i in range(4)]


@pytest.fixture(scope="module")
def oracle(model):
    jcfg, _, jp, _ = model
    return {r.uid: r.tokens for r in
            JServeEngine(jp, jcfg, max_len=MAX_LEN).generate(_requests(JRequest, jcfg))}


@pytest.mark.parametrize("mode", ["bucketed", "legacy", "chunked", "chunked_long", "paged"])
def test_engines_match_the_jax_bucketed_oracle(model, oracle, mode):
    """``chunked`` streams chunks of (8, 4, 1) tokens, ``chunked_long``
    (32, 1), so that prompts span several chunks or one; ``paged`` pages
    nothing (no attention layer) but still reserves and drains blocks."""
    _, cfg, _, tp = model
    policy = {"legacy": {}, "chunked": dict(chunked_prefill=True, chunk_sizes=(8, 4, 1)),
              "chunked_long": dict(chunked_prefill=True, chunk_sizes=(32, 1)),
              "paged": dict(chunked_prefill=True, chunk_sizes=(8, 1), paged=True,
                            block_size=8)}
    if mode == "bucketed":
        eng = ServeEngine(tp, cfg, max_len=MAX_LEN, device="cpu")
    else:
        eng = ServeEngine(tp, cfg, max_len=MAX_LEN, device="cpu", continuous=True,
                          policy=SchedulerPolicy(n_slots=2, **policy[mode]))
    out = eng.generate(_requests(Request, cfg), arrival_steps=[0, 1, 2, 3])
    assert sorted(r.uid for r in out) == [0, 1, 2, 3]
    for r in out:
        np.testing.assert_array_equal(r.tokens, oracle[r.uid], err_msg=f"{mode} uid {r.uid}")
    if eng.scheduler is not None:
        pool = eng.scheduler.pool
        assert pool.n_active == 0 and eng.obs.recorder.leaked == []
        if pool.paged:
            assert pool.allocator.free_count == pool.n_blocks
            assert pool.allocator.committed == 0
            assert eng.scheduler.decode_steps > 0
