"""The port's flash attention against the JAX package, on the CPU: the
plain version (``kernels.ref.flash_attention_ref``, which
``kernels.ops.flash_attention`` runs for CPU tensors) against the JAX
Pallas kernel in interpret mode and against JAX's own plain version,
and the prefill ``attention(window=, flash=)`` against JAX ``attention``.
Inputs come from numpy seeds.

Tolerances: against the Pallas kernel, f32 2e-5 and bf16 2e-2 absolute
and relative (``tests/test_kernels.py``'s own, kernel against plain);
against JAX's plain version and JAX ``attention``, f32 2e-5 (the same
math, sums in another order).  The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import attention as jattention
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.models.attention import attention
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(BH, S, d, seed, kv_rows=None):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((BH, S, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((kv_rows or BH, S, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((kv_rows or BH, S, d)) * 0.5).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,d,window,causal,G", [
    # tests/test_kernels.py::test_flash_attention_sweep's five shapes
    (4, 256, 64, None, True, 1),
    (2, 512, 128, None, True, 1),
    (2, 512, 64, 128, True, 1),
    (1, 256, 128, None, False, 1),
    (2, 384, 64, 96, True, 1),
    # gemma3's head: d = 256, two query rows per K/V row, a window
    (4, 256, 256, 96, True, 2),
])
def test_plain_version_matches_the_pallas_kernel(BH, S, d, window, causal, G, dtype):
    q, k, v = _qkv(BH, S, d, seed=BH + S + d, kv_rows=BH // G)
    tq, tk, tv = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (BH, S, d)
    # JAX's callers broadcast K/V to every query row beforehand
    jq, jk, jv = (jnp.asarray(a).astype(JAX_DT[dtype]) for a in
                  (q, np.repeat(k, G, axis=0), np.repeat(v, G, axis=0)))
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window, use_pallas=True,
                                interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("BH,S,d,window,causal,G", [
    (3, 200, 64, 50, True, 1),     # ragged: not a multiple of any tile
    (4, 77, 16, None, False, 2),
    (2, 1000, 32, 1024, True, 2),  # a window wider than the sequence
    (2, 33, 8, 1, True, 1),        # window 1: each query sees itself
])
def test_ragged_lengths_match_jax_plain_version(BH, S, d, window, causal, G):
    q, k, v = _qkv(BH, S, d, seed=S, kv_rows=BH // G)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                               window=window, sm_scale=0.3)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=0)),
                                    jnp.asarray(np.repeat(v, G, axis=0)), causal=causal,
                                    window=window, sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def _attn_params(d_model, n_heads, n_kv, hd, seed):
    rng = np.random.default_rng(seed)

    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    return {"wq": w(d_model, n_heads * hd), "wk": w(d_model, n_kv * hd),
            "wv": w(d_model, n_kv * hd), "wo": w(n_heads * hd, d_model)}


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("S,window,q_chunk", [(48, 12, 16), (40, None, 1024), (64, 16, 64)])
def test_attention_with_window_matches_jax(S, window, q_chunk, flash):
    """The plain q-chunked path (training) and the flash path (serving
    prefill) against JAX ``attention``: output and the K/V it returns."""
    B, H, KV, hd = 2, 4, 2, 16
    p = _attn_params(H * hd, H, KV, hd, seed=S)
    x = (np.random.default_rng(S + 1).standard_normal((B, S, H * hd)) * 0.5).astype(np.float32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd, rope_theta=1e4, window=window, q_chunk=q_chunk)
    want, (jk, jv) = jattention({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), **kw)
    got, (k, v) = attention({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
                            flash=flash, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=2e-5, rtol=2e-5)


def test_attention_checks_the_chunk_and_refuses_grad_on_the_flash_path():
    B, H, hd = 1, 2, 8
    p = {n: torch.from_numpy(a) for n, a in _attn_params(H * hd, H, H, hd, seed=0).items()}
    kw = dict(n_heads=H, n_kv=H, head_dim=hd, rope_theta=1e4, q_chunk=16)
    x = torch.randn(B, 24, H * hd)
    for flash in (False, True):
        with pytest.raises(ValueError, match="q_chunk"):
            attention(p, x, flash=flash, **kw)
    xg = torch.randn(B, 16, H * hd, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        attention(p, xg, flash=True, **kw)
    out, _ = attention(p, xg, **kw)  # the plain path differentiates
    out.sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_no_launch():
    q = torch.randn(2, 16, 8)
    tflash.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_cuda(q, q, q)
    out = tops.flash_attention(q, q[:1], q[:1], window=4)  # CPU: the plain version
    assert out.shape == q.shape
    assert tflash.launches == 0 and tflash.windowed_launches == 0
