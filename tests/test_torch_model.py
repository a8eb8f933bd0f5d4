"""Reduced granite-3-2b at f32: the port against the JAX package on the
same params (bridged from JAX ``init_params``), float and 6-bit packed.

Tolerance: logits within 2e-4 absolute (f32 at width 64; the two
frameworks sum matmuls and softmaxes in other orders), greedy tokens
identical."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core.packing import pack_model_params as j_pack_model_params
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.packing import PackedWeight, pack_model_params
from repro_torch.data import MarkovLM
from repro_torch.models import transformer as ttf
from repro_torch.obs.export import parse_prometheus, to_prometheus
from repro_torch.serve import Request, ServeEngine
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "granite-3-2b"
TOL = 2e-4
MAX_LEN = 32
PROMPT_LENS = (8, 12)  # two buckets of two requests
MAX_NEW = 8


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduced_config(ARCH)
    jparams = jax.jit(functools.partial(jtf.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    jpacked = jax.jit(functools.partial(j_pack_model_params, n_bits=6))(jparams)
    return {
        "jcfg": jcfg, "cfg": reduced_config(ARCH),
        "float": (jparams, bridge.from_numpy_tree(jparams)),
        "packed": (jpacked, bridge.from_numpy_tree(jpacked)),
    }


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S)).astype(np.int32)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.array(want), atol=TOL, rtol=TOL)


def test_bridged_packed_tree_equals_port_packing(models):
    """Packing the bridged float params in the port gives the bytes the
    JAX packer gave."""
    ours = pack_model_params(models["float"][1], 6)
    theirs = models["packed"][1]
    wq, jq = ours["blocks"]["p0"]["mixer"]["wq"], theirs["blocks"]["p0"]["mixer"]["wq"]
    assert isinstance(wq, PackedWeight) and tuple(wq.planes.shape) == (2, 6, 8, 64)
    for f in ("planes", "sign", "scale"):
        assert torch.equal(getattr(wq, f), getattr(jq, f))


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_forward_logits_match_jax(models, kind):
    jp, tp = models[kind]
    toks = _tokens(2, 12)
    want, _ = jax.jit(functools.partial(jtf.forward, cfg=models["jcfg"]))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = ttf.forward(tp, {"tokens": torch.from_numpy(toks).long()}, models["cfg"])
    _close(got, want)


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_prefill_and_decode_logits_match_jax(models, kind):
    jp, tp = models[kind]
    jcfg, cfg = models["jcfg"], models["cfg"]
    toks = _tokens(2, 8, seed=1)
    jl, jcache = jax.jit(functools.partial(jtf.prefill, cfg=jcfg, max_len=MAX_LEN,
                                           cache_dtype=jnp.float32))(
        jp, {"tokens": jnp.asarray(toks)})
    j_decode = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    with torch.inference_mode():
        tl, tcache = ttf.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cfg, MAX_LEN)
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, axis=-1)).astype(np.int32)
        for t in range(8):
            jl, jcache = j_decode(jp, jcache, jnp.asarray(nxt[:, None]), jnp.int32(8 + t))
            tl, tcache = ttf.decode_step(tp, tcache, torch.from_numpy(nxt[:, None]).long(),
                                         8 + t, cfg)
            _close(tl, jl)
            nxt = np.array(jnp.argmax(jl, axis=-1)).astype(np.int32)
    np.testing.assert_allclose(tcache["blocks"]["p0"]["k"].numpy(),
                               np.array(jcache["blocks"]["p0"]["k"]), atol=TOL, rtol=TOL)


def test_port_decode_matches_its_forward(models):
    """Within the port: prefill + decode reproduce the full forward."""
    _, tp = models["packed"]
    cfg = models["cfg"]
    toks = torch.from_numpy(_tokens(2, 10, seed=2)).long()
    with torch.inference_mode():
        full, _ = ttf.forward(tp, {"tokens": toks}, cfg)
        logits, cache = ttf.prefill(tp, {"tokens": toks[:, :6]}, cfg, MAX_LEN)
        torch.testing.assert_close(logits, full[:, 5], atol=1e-5, rtol=1e-5)
        for t in range(6, 10):
            logits, cache = ttf.decode_step(tp, cache, toks[:, t:t + 1], t, cfg)
            torch.testing.assert_close(logits, full[:, t], atol=1e-5, rtol=1e-5)


def _requests(cls, vocab):
    task = MarkovLM(vocab=vocab, seed=3)
    return [cls(uid=i, tokens=task.sample(np.random.default_rng(i), 1, 12)[0, :plen]
                .astype(np.int32), max_new=MAX_NEW)
            for i, plen in enumerate(PROMPT_LENS * 2)]


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_serve_engine_greedy_tokens_match_jax(models, kind):
    jp, tp = models[kind]
    jres = JServeEngine(jp, models["jcfg"], max_len=MAX_LEN).generate(
        _requests(JRequest, models["jcfg"].vocab_size))
    eng = ServeEngine(tp, models["cfg"], max_len=MAX_LEN, device="cpu")
    tres = eng.generate(_requests(Request, models["cfg"].vocab_size))
    want = {r.uid: r.tokens for r in jres}
    assert len(tres) == 4 and not eng.obs.recorder.leaked
    for r in tres:
        np.testing.assert_array_equal(r.tokens, want[r.uid], err_msg=f"uid {r.uid}")
        assert r.prefill_ms > 0
    families = parse_prometheus(to_prometheus(eng.obs.registry))
    assert families["serve_ttft_ms"]["samples"] and families["serve_requests_total"]["samples"]


def test_sampling_with_temperature_is_seeded(models):
    _, tp = models["packed"]
    reqs = [Request(uid=0, tokens=_tokens(1, 8)[0], max_new=4, temperature=1.0)]
    runs = [ServeEngine(tp, models["cfg"], max_len=MAX_LEN, seed=5, device="cpu")
            .generate(reqs)[0].tokens for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert all(0 <= t < models["cfg"].vocab_size for t in runs[0])


def test_per_slot_decode_attention_matches_jax(models):
    """Per-slot positions and an inactive lane (the continuous path's
    contiguous-cache branch): output and the in-place cache update."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    jp, tp = models["packed"]
    cfg = models["cfg"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((3, 16, cfg.n_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    pos = np.array([3, 7, 15], np.int32)
    active = np.array([True, False, True])
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
              rope_theta=cfg.rope_theta)
    jmixer = jax.tree.map(lambda a: a[0], jp["blocks"]["p0"]["mixer"])
    want, jk, jv = jattn.decode_attention(jmixer, jnp.asarray(x), jnp.asarray(ck),
                                          jnp.asarray(cv), jnp.asarray(pos),
                                          active=jnp.asarray(active), **kw)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.inference_mode():
        got = tattn.decode_attention(ttf.layer_slice(tp["blocks"], 0)["p0"]["mixer"],
                                     torch.from_numpy(x), tk, tv, torch.from_numpy(pos),
                                     active=torch.from_numpy(active), **kw)
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)
    np.testing.assert_array_equal(tk[1].numpy(), ck[1])  # the inactive lane kept its rows


def test_loss_matches_jax(models):
    jp, tp = models["float"]
    toks = _tokens(2, 8, seed=5)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jloss, _ = jtf.loss_fn(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
                           models["jcfg"])
    with torch.inference_mode():
        tloss, _ = ttf.loss_fn(tp, {"tokens": torch.from_numpy(toks).long(),
                                    "labels": torch.from_numpy(labels).long()}, models["cfg"])
    _close(tloss, jloss)
