"""The port's roofline counter (``repro_torch.roofline``): the terms'
arithmetic on the H100 constants, what one op counts (a product, a view,
an in-place op, a gather, a scatter), the kernel entries' meta branches
against the bound formulas of ``chip_smoke.py``, and the products' FLOPs
of the reduced models' ``forward`` against XLA's ``cost_analysis`` of
JAX's ``forward`` (the same shapes, layers unrolled).

Exact where both sides count the same thing (every op's FLOPs and
bytes).  The FLOPs ratio is a band: the port counts products only, XLA
elementwise work too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import transformer as jtransformer
from repro_torch.configs import reduced_config
from repro_torch.core.packing import abstract_packed
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.analysis import RooflineTerms, _shape_bytes, collective_bytes
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_roofline_terms_math():
    t = RooflineTerms(
        flops_per_device=hw.PEAK_FLOPS_BF16,  # exactly 1 second of compute
        bytes_per_device=hw.HBM_BW / 2,  # 0.5 s
        collective_bytes_per_device=hw.LINK_BW / 4,  # 0.25 s
        collectives={},
        n_devices=1,
    )
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 0.5) < 1e-9
    assert abs(t.collective_s - 0.25) < 1e-9
    assert t.bottleneck == "compute"
    assert abs(t.step_time_lower_bound_s - 1.0) < 1e-9
    # if all counted flops were useful, the MFU bound is 100%
    assert abs(t.roofline_fraction(hw.PEAK_FLOPS_BF16) - 1.0) < 1e-9
    d = t.to_dict()
    assert {"flops_per_device", "bytes_per_device", "collective_bytes_per_device",
            "collectives", "n_devices", "compute_s", "memory_s", "collective_s",
            "bottleneck"} <= set(d)


def test_hw_states_the_h100_data_sheet():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_TF32) == (989e12, 67e12, 495e12)
    assert (hw.HBM_BW, hw.HBM_BYTES, hw.LINK_BW) == (3.35e12, 80e9, 450e9)
    assert (hw.SMEM_BYTES, hw.SM_COUNT) == (228 * 1024, 132)


def test_shape_bytes():
    assert _shape_bytes(_meta(16, 1024)) == 16 * 1024 * 4
    assert _shape_bytes({"a": _meta(4, 2048, dtype=torch.bfloat16), "b": [_meta(8), 3]}) \
        == 4 * 2048 * 2 + 8 * 4
    pw = abstract_packed((3, 64, 128), 6)
    assert _shape_bytes(pw) == 3 * (6 + 1) * 8 * 128 + 3 * 4


@pytest.mark.parametrize("case", ["mm", "view", "inplace", "gather", "scatter", "copy"])
def test_counter_on_one_op(case):
    x, w = _meta(8, 16), _meta(16, 4)
    table, idx = _meta(100, 16), _meta(5, dtype=torch.int64)
    fn, flops, nbytes = {
        "mm": (lambda: x @ w, 2 * 8 * 16 * 4, (8 * 16 + 16 * 4 + 8 * 4) * 4),
        "view": (lambda: x.view(16, 8).t()[2:], 0, 0),
        "inplace": (lambda: x.add_(1.0), 0, 2 * 8 * 16 * 4),  # self read and written
        "gather": (lambda: table[idx], 0, 2 * 5 * 16 * 4 + 5 * 8),  # rows, not the table
        "scatter": (lambda: table.index_put_((idx,), _meta(5, 16)), 0, 2 * 5 * 16 * 4 + 5 * 8),
        "copy": (lambda: x.copy_(_meta(8, 16)), 0, 2 * 8 * 16 * 4),  # src read, self written
    }[case]
    t = analysis.analyze(fn)
    assert (t.flops_per_device, t.bytes_per_device) == (flops, nbytes)
    assert t.launches == {} and t.collective_bytes_per_device == 0


def test_counter_profiles_and_peak_live_bytes():
    a = _meta(1024, 1024)

    def fn():
        b = a * 2.0  # 4 MiB live
        c = b + 1.0  # 8 MiB live
        del b
        return c.sum()

    t = analysis.analyze(fn)
    assert t.peak_live_bytes == 2 * 1024 * 1024 * 4
    prof = {name: (b, n) for name, b, n in t.op_byte_profile()}
    assert prof["aten.mul"] == (2 * 1024 * 1024 * 4, 1)
    assert t.biggest_ops(1)[0][1] == 2 * 1024 * 1024 * 4
    assert analysis.model_flops(10, 3) == 180 and analysis.model_flops_inference(10, 3) == 60


def test_collective_bytes_by_kind():
    recs = [("_c10d_functional.all_gather_into_tensor", 64), ("c10d.allreduce_", 32),
            ("_c10d_functional.reduce_scatter_tensor", 8), ("c10d.alltoall_", 4),
            ("c10d.send", 2), ("aten.mm", 1000)]
    c = collective_bytes(recs)
    assert c == {"all-gather": 64, "all-reduce": 32, "reduce-scatter": 8, "all-to-all": 4,
                 "collective-permute": 2}


@pytest.mark.parametrize("M,K,N,groups,dtype,active", [
    (4, 2048, 512, 1, torch.bfloat16, None), (512, 2048, 8192, 16, torch.float32, None),
    (8, 64, 128, 1, torch.bfloat16, 3), (8, 64, 128, 1, torch.float32, 9)])
def test_bitserial_meta_counts_its_bound(M, K, N, groups, dtype, active):
    """chip_smoke.bound_ms: 2MKN FLOPs; M K elt + (n+1) (K/8) N + 4 groups +
    M N elt bytes, n the live planes (``active`` clamped to [1, 6])."""
    pw = abstract_packed((K, N), 6)
    pw.scale = _meta(1, groups) if groups > 1 else pw.scale
    x = _meta(M, K, dtype=dtype)
    with analysis.Counter() as c:
        out = ops.bitserial_matmul(x, pw, active_planes=active)
    t = c.terms()
    elt = 4 if dtype == torch.float32 else 2
    n = 6 if active is None else min(active, 6)
    assert (out.shape, out.dtype, out.device.type) == ((M, N), dtype, "meta")
    assert t.flops_per_device == 2.0 * M * K * N
    assert t.bytes_per_device == M * K * elt + (n + 1) * (K // 8) * N + 4 * groups + M * N * elt
    assert t.launches == {"bitserial_matmul": 1}
    with pytest.raises(TypeError, match="Python int"):
        ops.bitserial_matmul(x, pw, active_planes=torch.tensor(3))


def _live_loop(S, window, causal):
    """chip_smoke.flash_bound's count of live (query, key) pairs."""
    live = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i if causal else S - 1
        live += hi - lo + 1
    return live


@pytest.mark.parametrize("S,window,causal", [(64, None, True), (64, 16, True), (64, 100, True),
                                             (64, None, False), (64, 16, False), (1, None, True)])
def test_flash_meta_counts_its_bound(S, window, causal):
    BH, BHkv, d = 8, 2, 32
    q, k, v = _meta(BH, S, d, dtype=torch.bfloat16), _meta(BHkv, S, d, dtype=torch.bfloat16), \
        _meta(BHkv, S, d, dtype=torch.bfloat16)
    assert ops.live_pairs(S, window, causal) == _live_loop(S, window, causal)
    with analysis.Counter() as c:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    t = c.terms()
    assert (out.shape, out.dtype) == (q.shape, q.dtype)
    assert t.flops_per_device == 4.0 * d * _live_loop(S, window, causal) * BH
    assert t.bytes_per_device == (2 * BH + 2 * BHkv) * S * d * 2
    assert t.launches == {"flash_attention": 1}


def test_bgl_sumsq_meta_counts_forward_and_backward():
    """chip_smoke.bgl_bound: views read once, the f32 sums written (2
    FLOPs per element); the backward reads each view and g and writes
    each gradient."""
    xs = [_meta(9, 64).requires_grad_(), _meta(7, 33, dtype=torch.float32).requires_grad_()]
    n = 9 * 64 + 7 * 33
    with analysis.Counter() as c:
        out = ops.bgl_sumsq_grouped(xs)
        fwd_bytes = c.bytes
        grads = torch.autograd.grad(out.sum(), xs)
    t = c.terms()
    assert out.shape == (16,) and [g.shape for g in grads] == [x.shape for x in xs]
    assert t.launches == {"bgl_sumsq": 1, "bgl_sumsq_backward": 1}
    assert fwd_bytes == 4 * n + 4 * 16
    assert t.op_bytes["kernel.bgl_sumsq_backward"] == (2 * 4 * n + 4 * 16, 1)
    assert c.kernel_flops == 2.0 * n * 2


def test_paged_attention_refuses_meta():
    with pytest.raises(NotImplementedError, match="positions"):
        ops.paged_attention(_meta(2, 2, 2, 16), _meta(4, 8, 2, 16), _meta(4, 8, 2, 16),
                            _meta(2, 2, dtype=torch.int32), _meta(2, dtype=torch.int32))


def _xla_forward_flops(arch, B, S):
    jcfg = dataclasses.replace(j_reduced_config(arch), scan_layers=False)
    params = jax.eval_shape(lambda k: jtransformer.init_params(k, jcfg), jax.random.PRNGKey(0))
    if jcfg.frontend == "audio":
        batch = {"embeds": jax.ShapeDtypeStruct((B, S, jcfg.d_model), jnp.float32)}
    else:
        batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if jcfg.frontend == "vision":
        batch["cross_embeds"] = jax.ShapeDtypeStruct((B, jcfg.frontend_tokens, jcfg.d_model),
                                                     jnp.float32)
    cost = jax.jit(lambda p, b: jtransformer.forward(p, b, jcfg)).lower(params, batch) \
        .compile().cost_analysis()
    return float((cost[0] if isinstance(cost, list) else cost)["flops"])


def _port_forward_flops(arch, B, S):
    cfg = reduced_config(arch)
    params = transformer.init_params(cfg, torch.Generator(), "meta")
    batch = ({"embeds": _meta(B, S, cfg.d_model)} if cfg.frontend == "audio"
             else {"tokens": _meta(B, S, dtype=torch.int32)})
    if cfg.frontend == "vision":
        batch["cross_embeds"] = _meta(B, cfg.frontend_tokens, cfg.d_model)
    with torch.no_grad():
        return analysis.analyze(transformer.forward, params, batch, cfg).flops_per_device


# The recurrent mixers' scans are elementwise (cumulative sums, exps, a
# doubling scan), which XLA counts and torch's registry does not: the
# products are 0.927 of XLA's FLOPs on both (measured at B 2, S 64).
RECURRENT_RATIO = {"mamba2-130m": 0.9267, "recurrentgemma-9b": 0.9267}


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b", "llama-3.2-vision-11b",
                                  "mamba2-130m", "recurrentgemma-9b"])
def test_forward_product_flops_against_xla(arch):
    ratio = _port_forward_flops(arch, 2, 64) / _xla_forward_flops(arch, 2, 64)
    if arch in RECURRENT_RATIO:
        assert abs(ratio - RECURRENT_RATIO[arch]) < 0.005, ratio
    else:
        assert 0.9 <= ratio <= 1.0, ratio
