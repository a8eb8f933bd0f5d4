"""Two settings the port now honours, against the JAX package on the CPU,
on the same numpy inputs made from a seed:

* ``act_bits < 32``: ``mlp_apply`` quantises the hidden activation
  (ReLU6, then ``act_bits`` uniform levels) before ``w_down``;
* ``attn_scores_dtype="bfloat16"``: whole-sequence and chunked prefill on
  the plain path take their scores, mask constant and softmax in bf16;
  the flash kernel path, which keeps f32 scores, raises instead.

Tolerances, of max |JAX output|: 1e-5 for the MLP and the attention
functions (f32 sums in another order; the bf16 scores come from the same
f32 sums, rounded once, and the bf16 softmax runs op by op as
``jax.nn.softmax`` does, so one bf16 ulp of a weight, 4e-3 of it, is the
most a rounding flip could move an output); 2e-4 absolute for the
reduced model's logits, as ``test_torch_model.py`` holds them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf

TOL = 1e-5
LOGIT_TOL = 2e-4
H, KV, HD = 4, 2, 16
D = H * HD


def _w(rng, i, o):
    return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)


def _attn_params(rng):
    return {"wq": _w(rng, D, H * HD), "wk": _w(rng, D, KV * HD), "wv": _w(rng, D, KV * HD),
            "wo": _w(rng, H * HD, D)}


def _both(p):
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a) for n, a in p.items()})


def _close(got, want, tol=TOL):
    want = np.array(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu_mlp"])
def test_mlp_activation_quantisation_matches_jax(kind):
    rng = np.random.default_rng(7)
    d, d_ff = 32, 64
    p = {"w_up": _w(rng, d, d_ff), "w_down": _w(rng, d_ff, d)}
    if kind != "gelu_mlp":
        p["w_gate"] = _w(rng, d, d_ff)
    x = (rng.standard_normal((2, 6, d)) * 2).astype(np.float32)
    jp, tp = _both(p)
    want = jcommon.mlp_apply(jp, jnp.asarray(x), kind, act_bits=4)
    got = tcommon.mlp_apply(tp, torch.from_numpy(x), kind, act_bits=4)
    _close(got, want)
    # the setting takes effect: 4-bit activations move the output
    full = jcommon.mlp_apply(jp, jnp.asarray(x), kind)
    assert np.abs(np.array(full) - np.array(want)).max() > 100 * TOL * np.abs(want).max()


@pytest.mark.parametrize("window", [None, 5])
def test_attention_bf16_scores_match_jax(window):
    rng = np.random.default_rng(11)
    jp, tp = _both(_attn_params(rng))
    x = (rng.standard_normal((2, 16, D)) * 2).astype(np.float32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=1e4, window=window)
    want, _ = jattn.attention(jp, jnp.asarray(x), scores_dtype=jnp.bfloat16, **kw)
    got, _ = tattn.attention(tp, torch.from_numpy(x), scores_dtype="bfloat16", **kw)
    _close(got, want)
    f32, _ = jattn.attention(jp, jnp.asarray(x), **kw)
    assert np.abs(np.array(f32) - np.array(want)).max() > 100 * TOL * np.abs(want).max()


@pytest.mark.parametrize("ring", [False, True])
def test_prefill_chunk_bf16_scores_match_jax(ring):
    """A contiguous cache (lane 1 starting mid-prompt, 5 real tokens of 8)
    and a ring of 6 slots with window 6 that the chunk wraps."""
    rng = np.random.default_rng(13)
    jp, tp = _both(_attn_params(rng))
    B, C, Wc = 2, 8, (6 if ring else 33)
    x = (rng.standard_normal((B, C, D)) * 2).astype(np.float32)
    ck, cv = (rng.standard_normal((B, Wc, KV, HD)).astype(np.float32) for _ in range(2))
    start = np.array([3, 10] if ring else [0, 12], np.int32)
    n_valid = np.array([8, 5], np.int32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=1e4, ring=ring,
              window=6 if ring else None)
    want, jk, jv = jattn.prefill_chunk_attention(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(start),
        jnp.asarray(n_valid), scores_dtype=jnp.bfloat16, **kw)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = tattn.prefill_chunk_attention(
        tp, torch.from_numpy(x), tk, tv, torch.from_numpy(start), torch.from_numpy(n_valid),
        scores_dtype="bfloat16", **kw)
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)


def test_flash_path_raises_for_bf16_scores():
    """The flash kernel (and its plain version, the CPU side of the same
    path) computes f32 scores: a bf16 setting raises rather than being
    ignored, at the attention call and at the model's serving prefill."""
    rng = np.random.default_rng(17)
    _, tp = _both(_attn_params(rng))
    x = torch.from_numpy(rng.standard_normal((1, 8, D)).astype(np.float32))
    with pytest.raises(ValueError, match="flash kernel computes its scores"):
        tattn.attention(tp, x, n_heads=H, n_kv=KV, head_dim=HD, rope_theta=1e4, flash=True,
                        scores_dtype="bfloat16")
    with pytest.raises(ValueError, match="attn_scores_dtype"):
        tattn.attention(tp, x, n_heads=H, n_kv=KV, head_dim=HD, rope_theta=1e4,
                        scores_dtype="float16")
    cfg = dataclasses.replace(reduced_config("granite-3-2b"), attn_scores_dtype="bfloat16")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.inference_mode(), pytest.raises(ValueError, match="flash kernel"):
        ttf.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long)}, cfg, 16)


@pytest.mark.parametrize("override", [{"act_bits": 4}, {"attn_scores_dtype": "bfloat16"}])
def test_reduced_model_forward_matches_jax(override):
    """Reduced granite-3-2b at f32 with each setting: the training forward
    (the plain attention) of both packages on the same params.

    With bf16 scores JAX runs eagerly: under ``jit`` XLA's CPU compiler
    drops some f32 -> bf16 -> f32 round trips that the JAX source writes
    (the softmax's quotient, for one), which moves the logits about as far
    from the eager result as f32 scores do.  The port follows the source."""
    jcfg = dataclasses.replace(j_reduced_config("granite-3-2b"), **override)
    cfg = dataclasses.replace(reduced_config("granite-3-2b"), **override)
    jparams = jax.jit(functools.partial(jtf.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    tparams = bridge.from_numpy_tree(jparams)
    toks = np.random.default_rng(3).integers(0, 512, size=(2, 12)).astype(np.int32)
    forward = functools.partial(jtf.forward, cfg=jcfg)
    if "attn_scores_dtype" in override:
        with jax.disable_jit():
            want, _ = forward(jparams, {"tokens": jnp.asarray(toks)})
    else:
        want, _ = jax.jit(forward)(jparams, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = ttf.forward(tparams, {"tokens": torch.from_numpy(toks).long()}, cfg)
    np.testing.assert_allclose(got.numpy(), np.array(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
