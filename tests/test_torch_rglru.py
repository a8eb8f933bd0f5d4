"""The port's RG-LRU block (``models/rglru.py``) and the "rglru" layer kind
against the JAX package, on the CPU, at f32 (params drawn as numpy arrays
and carried to both packages, inputs from numpy with a seed):

* ``rglru_scan`` (a doubling scan) against JAX's associative scan and a
  sequential loop, with and without an entering state;
* ``rglru_apply``, ``rglru_prefill_chunk`` (pad positions, and an
  ``n_valid = 0`` lane whose state and conv tail pass through bitwise)
  and ``rglru_decode``; decode continuing a prefill;
* reduced recurrentgemma-9b (7 layers: 2 x (rglru, rglru, local) + 1
  tail rglru; window 16, one KV head), float and 4-bit packed: forward,
  ``loss_fn`` and its gradients (float), prefill plus decode across the
  ring's wrap; the bucketed, legacy, chunked and paged engines against
  the JAX bucketed oracle; idle lanes' state and conv exactly zero after
  a drained run (``tests/test_chunked_prefill.py::
  test_idle_lane_state_stays_frozen``); degrade with forced sheds
  replayed bitwise by ``obs.quality.replay_plane_log``
  (``tests/test_precision_tiers.py::
  test_degrade_recurrent_arch_state_valid_across_switches``);
* for both recurrent archs: spec decode refused as in JAX, and serving
  holds the recurrent matrices in the compute dtype.

Tolerances as ``tests/test_torch_ssm.py``: the mixer functions 1e-5
absolute plus 1e-4 relative, the model 2e-4; tokens exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core.packing import pack_model_params as j_pack_model_params
from repro.models import rglru as jrg
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.packing import RECURRENT_MATRICES, PackedWeight, pack_model_params
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as ttf
from repro_torch.obs.quality import replay_plane_log
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import serving_params
from repro_torch.serve.scheduler import SchedulerPolicy
from repro_torch.tree import flatten_with_path, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "recurrentgemma-9b"
TOL = (1e-5, 1e-4)
MODEL_TOL = (2e-4, 2e-4)
MAX_LEN = 48
D = 16


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.array(want), atol=tol[0], rtol=tol[1])


def _normal(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("S,with_h0", [(12, False), (37, True)])
def test_rglru_scan_matches_jax_and_a_sequential_loop(S, with_h0):
    rng = np.random.default_rng(S)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, S, 8))))).astype(np.float32)
    b = rng.standard_normal((2, S, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32) if with_h0 else None
    got = trg.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         None if h0 is None else torch.from_numpy(h0))
    want = jax.jit(jrg.rglru_scan)(jnp.asarray(a), jnp.asarray(b),
                                   None if h0 is None else jnp.asarray(h0))
    _close(got, want)
    h = np.zeros((2, 8), np.float32) if h0 is None else h0
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        _close(got[:, t], h)


@pytest.fixture(scope="module")
def mixer():
    p = tree_map(lambda t: t.numpy(), trg.rglru_init(torch.Generator().manual_seed(0), D, D,
                                                     "cpu"))
    rng = np.random.default_rng(1)  # non-zero biases (the init's are 0)
    p.update({k: _normal(rng, (D,), 0.1) for k in ("conv_b", "b_rgate", "b_igate")})
    return jax.tree.map(jnp.asarray, p), bridge.from_numpy_tree(p)


def test_rglru_apply_matches_jax(mixer):
    jp, tp = mixer
    x = _normal(np.random.default_rng(2), (2, 11, D))
    jy, (jh, jc) = jax.jit(jrg.rglru_apply)(jp, jnp.asarray(x))
    ty, (th, tc) = trg.rglru_apply(tp, torch.from_numpy(x))
    for g, w in ((ty, jy), (th, jh), (tc, jc)):
        _close(g, w)


def test_rglru_prefill_chunk_matches_jax_and_passes_idle_lanes_through(mixer):
    jp, tp = mixer
    rng = np.random.default_rng(3)
    x, h0, conv = _normal(rng, (3, 8, D)), _normal(rng, (3, D)), _normal(rng, (3, 3, D))
    nv = np.array([8, 3, 0], np.int32)
    jy, jh, jc = jax.jit(jrg.rglru_prefill_chunk)(jp, *map(jnp.asarray, (x, h0, conv, nv)))
    ty, th, tc = trg.rglru_prefill_chunk(tp, *map(torch.from_numpy, (x, h0, conv, nv)))
    _close(ty[0], np.array(jy)[0])
    _close(ty[1, :3], np.array(jy)[1, :3])
    _close(th, jh)
    _close(tc, jc)
    assert torch.equal(th[2], torch.from_numpy(h0[2]))
    assert torch.equal(tc[2], torch.from_numpy(conv[2]))


def test_rglru_decode_matches_jax_and_continues_prefill(mixer):
    jp, tp = mixer
    rng = np.random.default_rng(4)
    x1, h, conv = _normal(rng, (2, 1, D)), _normal(rng, (2, D)), _normal(rng, (2, 3, D))
    want = jax.jit(jrg.rglru_decode)(jp, *map(jnp.asarray, (x1, h, conv)))
    got = trg.rglru_decode(tp, *map(torch.from_numpy, (x1, h, conv)))
    for g, w in zip(got, want):
        _close(g, w)
    x = torch.from_numpy(_normal(rng, (2, 9, D)))
    y_full, _ = trg.rglru_apply(tp, x)
    _, (h8, conv8) = trg.rglru_apply(tp, x[:, :8])
    y1, _, _ = trg.rglru_decode(tp, x[:, 8:9], h8, conv8)
    _close(y1[:, 0], y_full[:, 8].numpy(), (1e-4, 1e-3))


# ---------------------------------------------------------------------------
# Reduced recurrentgemma-9b
# ---------------------------------------------------------------------------


def _numpy_params(cfg, seed):
    """Random params of JAX's layout and distributions, as numpy arrays
    (drawn with the port's ``init_params``: a JAX draw of a 7-layer tree
    compiles for seconds)."""
    return tree_map(lambda t: t.numpy(),
                    ttf.init_params(cfg, torch.Generator().manual_seed(seed), "cpu"))


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    params = _numpy_params(cfg, 1)
    jp = jax.tree.map(jnp.asarray, params)
    jpacked = jax.jit(functools.partial(j_pack_model_params, n_bits=4))(jp)
    return {"jcfg": jcfg, "cfg": cfg, "float": (jp, bridge.from_numpy_tree(params)),
            "packed": (jpacked, bridge.from_numpy_tree(jpacked))}


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_bridge_carries_a_packed_recurrentgemma_tree(models):
    """Packing the bridged float tree in the port gives JAX's packed tree
    leaf for leaf (the pattern positions and the tail list), and the
    RG-LRU matrices stay float, as JAX's ``PACKABLE_SUFFIXES`` says."""
    ours = flatten_with_path(pack_model_params(models["float"][1], 4))
    theirs = flatten_with_path(models["packed"][1])
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    n_packed = 0
    for (name, a), (_, b) in zip(ours, theirs):
        assert type(a) is type(b), name
        if isinstance(b, PackedWeight):
            n_packed += 1
            for f in ("planes", "sign", "scale"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
        else:
            assert torch.equal(a, b), name
    # the GeGLU MLP of the three pattern positions (stacked) and the tail
    # layer; the reduced attention projections (64 x 32, 64 x 16) are too
    # narrow to pack
    assert n_packed == 4 * 3
    rg = models["packed"][1]["tail"][0]["mixer"]
    assert all(isinstance(rg[k], torch.Tensor) for k in RECURRENT_MATRICES & set(rg))


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_forward_matches_jax(models, kind):
    jp, tp = models[kind]
    toks = _tokens((2, 24), 5)
    jl, _ = jax.jit(functools.partial(jtf.forward, cfg=models["jcfg"]))(jp, {"tokens": toks})
    with torch.no_grad():
        tl, _ = ttf.forward(tp, {"tokens": torch.from_numpy(toks).long()}, models["cfg"])
    _close(tl, jl, MODEL_TOL)


def test_loss_and_gradients_match_jax(models):
    jp, tp = models["float"]
    jcfg, cfg = models["jcfg"], models["cfg"]
    toks = _tokens((2, 21), 6)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        functools.partial(jtf.loss_fn, cfg=jcfg), has_aux=True))(jp, batch)
    tp = tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss, _ = ttf.loss_fn(tp, {k: torch.from_numpy(v).long() for k, v in batch.items()}, cfg)
    loss.backward()
    _close(loss, jloss, MODEL_TOL)
    jflat = dict(flatten_with_path(jgrad))
    for name, t in flatten_with_path(tp):
        assert t.grad is not None and torch.isfinite(t.grad).all(), name
        _close(t.grad, jflat[name], MODEL_TOL)


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_prefill_and_decode_match_jax_across_the_wrap(models, kind):
    """A 20-token prompt wraps the 16-slot rings in prefill; 6 decode
    steps go on past it.  Logits at every step, and the whole cache (ring
    K/V, RG-LRU state and conv tail) at the end."""
    jp, tp = models[kind]
    jcfg, cfg = models["jcfg"], models["cfg"]
    toks, nxt = _tokens((2, 20), 7), _tokens((2, 6), 8)
    jl, jcache = jax.jit(functools.partial(jtf.prefill, cfg=jcfg, max_len=MAX_LEN,
                                           cache_dtype=jnp.float32))(jp, {"tokens": toks})
    with torch.no_grad():
        tl, tcache = ttf.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cfg, MAX_LEN)
    _close(tl, jl, MODEL_TOL)
    step = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    for t in range(nxt.shape[1]):
        jl, jcache = step(jp, jcache, jnp.asarray(nxt[:, t:t + 1]), jnp.int32(20 + t))
        with torch.no_grad():
            tl, _ = ttf.decode_step(tp, tcache, torch.from_numpy(nxt[:, t:t + 1]).long(),
                                    20 + t, cfg)
        _close(tl, jl, MODEL_TOL)
    jflat = dict(flatten_with_path(jcache))
    for name, leaf in flatten_with_path(tcache):
        _close(leaf, jflat[name], MODEL_TOL)


def _requests(cls, cfg):
    """Prompts of 9 and 22 tokens (two buckets; 22 is past the window),
    max_new = window + 4 so every lane's ring wraps while it decodes."""
    rng = np.random.default_rng(7)
    return [cls(uid=i, tokens=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                max_new=cfg.window + 4) for i, n in enumerate((9, 22, 22, 9))]


@pytest.fixture(scope="module")
def oracle(models):
    reqs = _requests(JRequest, models["jcfg"])
    return {r.uid: r.tokens for r in
            JServeEngine(models["float"][0], models["jcfg"], max_len=MAX_LEN).generate(reqs)}


@pytest.mark.parametrize("mode", ["bucketed", "legacy", "chunked", "paged"])
def test_engines_match_the_jax_bucketed_oracle(models, oracle, mode):
    cfg, tp = models["cfg"], models["float"][1]
    policy = {"legacy": {}, "chunked": dict(chunked_prefill=True, chunk_sizes=(8, 4, 1)),
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


def test_idle_lane_state_stays_frozen(models):
    """One live lane of four: after the run drains, the three idle lanes'
    RG-LRU state and conv tail are still exactly zero."""
    cfg, tp = models["cfg"], models["float"][1]
    eng = ServeEngine(tp, cfg, max_len=64, device="cpu", continuous=True, n_slots=4,
                      chunked_prefill=True)
    [res] = eng.generate([Request(uid=0, tokens=np.arange(6, dtype=np.int32), max_new=20)])
    assert len(res.tokens) == 20
    n = 0
    for name, leaf in flatten_with_path(eng.scheduler.pool.cache):
        if name.rsplit("/", 1)[-1] in ("state", "conv"):
            lanes = leaf[:, 1:] if name.startswith("blocks") else leaf[1:]
            assert torch.count_nonzero(lanes) == 0, name
            assert torch.count_nonzero(leaf[:, 0] if name.startswith("blocks") else leaf[0])
            n += 1
    assert n == 2 * 3  # state and conv of p0 and p1 (stacked) and of the tail layer


def test_degrade_with_forced_sheds_replays_bitwise(models):
    """Plane switches must not corrupt the recurrent state: every lane's
    plane log replays (static truncation, the recurrent cache carried
    across each switch) to its served tokens."""
    cfg, tp = models["cfg"], models["packed"][1]
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, size=4 + 2 * i)
                    .astype(np.int32), max_new=6) for i in range(3)]
    eng = ServeEngine(tp, cfg, max_len=MAX_LEN, device="cpu", continuous=True,
                      policy=SchedulerPolicy(n_slots=2, chunked_prefill=True,
                                             chunk_sizes=(8, 1), degrade=True))
    eng.scheduler.force_shed = lambda step: step % 3
    out = eng.generate(reqs, arrival_steps=[0, 1, 2])
    assert len(out) == len(reqs) and eng.obs.recorder.leaked == []
    prompts = {r.uid: r.tokens for r in reqs}
    for r in out:
        assert len(set(r.plane_log.tolist())) > 1, r.plane_log
        np.testing.assert_array_equal(
            replay_plane_log(tp, cfg, prompts[r.uid], r.plane_log, MAX_LEN), r.tokens)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_spec_decode_is_refused_for_recurrent_patterns(arch):
    cfg = reduced_config(arch)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu", pack_bits=4)
    with pytest.raises(ValueError, match="attention-only layer pattern"):
        ServeEngine(params, cfg, max_len=32, device="cpu", continuous=True, paged=True,
                    spec_decode=True)


F32_VECTORS = {"conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "scale", "rg_lambda",
               "b_rgate", "b_igate"}


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_serving_holds_the_recurrent_matrices_in_the_compute_dtype(arch):
    """``serving_params`` and ``init_params(pack_bits=)`` cast the seven
    recurrent matrices to a bf16 config's compute dtype; the conv
    weights, decay and gate vectors stay f32 (decode convolves in f32)."""
    cfg = reduced_config(arch).scaled(dtype="bfloat16")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    drawn = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu", pack_bits=4)
    for tree in (serving_params(params, cfg, torch.device("cpu")), drawn):
        seen = set()
        for name, leaf in flatten_with_path(tree):
            leaf_name = name.rsplit("/", 1)[-1]
            if leaf_name in RECURRENT_MATRICES:
                assert leaf.dtype == torch.bfloat16, name
                seen.add(leaf_name)
            elif leaf_name in F32_VECTORS:
                assert leaf.dtype == torch.float32, name
        assert seen & RECURRENT_MATRICES == (
            {"in_proj", "out_proj"} if arch == "mamba2-130m"
            else RECURRENT_MATRICES - {"in_proj", "out_proj"})
