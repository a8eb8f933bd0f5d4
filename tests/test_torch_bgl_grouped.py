"""The grouped bit-group sum of squares (``ops.bgl_sumsq_grouped``) and
the regulariser that makes one grouped call per evaluation, against the
JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both.  Tolerances:

* sums of squares: 1e-5 relative (f32 sums in another order; the JAX
  side is the Pallas kernel in interpret mode);
* regulariser values, norms and plane gradients: 1e-5 relative (f32 sums
  over the non-group axes in another order);
* the grouped plain version against per-tensor calls, and gradients
  against ``2 x g``: exact (the same arithmetic).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bitrep as jbitrep
import repro.core.bsq as jbsq
from repro.configs import reduced_config as j_reduced_config
from repro.core.regularizer import bgl as j_bgl
from repro.core.regularizer import bit_group_norms as j_bit_group_norms
from repro.core.regularizer import memory_reweighed_bgl as j_memory_reweighed_bgl
from repro.kernels import ops as jops
from repro.models import transformer as jtf
import repro_torch.core.bitrep as bitrep
from repro_torch.core.regularizer import bgl, bit_group_norms, memory_reweighed_bgl
from repro_torch.kernels import bgl_sumsq as tbgl
from repro_torch.kernels import ops, ref
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

regularizer = importlib.import_module("repro_torch.core.regularizer")

# ResNet-20's (9, numel) plane views at width 16 (the smaller ones) and
# ragged views: one element, rows shorter than a 16-byte vector, odd C
RESNET_VIEWS = [(9, 432), (9, 640), (9, 2304), (9, 4608)]
RAGGED_VIEWS = [(1, 1), (7, 33), (3, 1000), (2, 8)]


def _close(got: torch.Tensor, want, rtol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(), np.array(want, np.float32),
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_plain_matches_per_tensor_and_jax_pallas(dtype):
    rng = np.random.default_rng(0)
    jx = [jnp.asarray(rng.standard_normal(s), dtype) for s in RESNET_VIEWS + RAGGED_VIEWS]
    xs = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
          for x in jx]  # exact: bf16 values in f32
    got = ops.bgl_sumsq_grouped(xs)
    assert got.dtype == torch.float32 and got.shape == (sum(x.shape[0] for x in xs),)
    assert torch.equal(got, torch.cat([ops.bgl_sumsq(x) for x in xs]))
    want = np.concatenate([np.array(jops.bgl_sumsq(x, use_pallas=True, interpret=True))
                           for x in jx])
    _close(got, want)


def test_grouped_gradcheck_and_backward():
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(s, dtype=torch.float64, generator=gen, requires_grad=True)
          for s in ((3, 7), (1, 1), (2, 5))]
    assert torch.autograd.gradcheck(lambda *a: ops.bgl_sumsq_grouped(list(a)), tuple(xs))
    # a view that needs no gradient gets none; f32 and bf16: 2 x g per row, bit for bit
    for dt in (torch.float32, torch.bfloat16):
        vs = [x.detach().to(dt).requires_grad_(i != 1) for i, x in enumerate(xs)]
        g = torch.arange(1.0, 7.0)
        out = ops.bgl_sumsq_grouped(vs)
        gx = torch.autograd.grad(out, [vs[0], vs[2]], g)
        for v, gv, gi in zip((vs[0], vs[2]), gx, (g[:3], g[4:])):
            assert gv.dtype == dt
            assert torch.equal(gv, ref.bgl_sumsq_grad_ref(v.detach(), gi))
            assert torch.equal(gv, (v.detach().float() * (2 * gi)[:, None]).to(dt))


def test_launch_plan_chunks_by_row_length_alone_and_splits_long_tables():
    """What the card's wrapper launches, computed on the CPU: a row's
    chunking is its own (so a view's blocks are the same alone or in a
    group), and a table longer than one launch's parameters splits."""
    sizes = {C: tbgl.chunk_elems(C, 4) for C in (1, 432, 36864, 1_048_576, 101_187_584)}
    assert sizes == {1: 8192, 432: 8192, 36864: 8192, 1_048_576: 65536, 101_187_584: 65536}
    assert tbgl.chunk_elems(1_000_003, 2) == 65536  # 2 MB of bf16: 128 KB chunks
    xs = [torch.empty(s) for s in [(9, 36864), (0, 4), (3, 0), (18, 1_048_576 // 64)] * 40]
    plan = tbgl._launches(xs, range(len(xs)))
    assert [len(segs) for segs, _ in plan] == [tbgl.MAX_SEGMENTS, 120 - tbgl.MAX_SEGMENTS]
    alone = tbgl._launches(xs[:1], [0])[0][0][0]
    for segs, blocks in plan:
        b, row0 = 0, {}
        for i, C, block0, r0, n_chunks, chunk in segs:
            assert block0 == b and xs[i].shape[0] > 0
            assert (C, n_chunks, chunk) == (xs[i].shape[1], max(1, -(-C // chunk)),
                                            tbgl.chunk_elems(C, 4))
            b += xs[i].shape[0] * n_chunks
            row0[i] = r0
        assert blocks == b
    assert row0[len(xs) - 1] == sum(x.shape[0] for x in xs[:-1])
    assert plan[0][0][0][1:] == alone[1:] and plan[1][0][0][4:] == alone[4:]
    with pytest.raises(ValueError, match="CUDA"):
        tbgl.bgl_sumsq_grouped_cuda(xs[:1])


# ---------------------------------------------------------------------------
# the regulariser on the models' layouts
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _layout(arch):
    """JAX bit representations of reduced ``arch``'s quantised tensors (the
    default groups: per layer, and per (layer, expert) for routed experts)
    with planes moved off {0, 1} as after some training, one tensor
    requantised so #Bit differs; and the port's copies."""
    jcfg = j_reduced_config(arch)
    params = jax.jit(functools.partial(jtf.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    qp, _ = jbsq.partition_params(params)
    cfg = jbsq.BSQConfig(n_init=8, compute_dtype=jnp.float32)
    jreps = jax.jit(lambda q: jbsq.init_bitreps(q, cfg))(qp)
    rng = np.random.default_rng(1)
    out_j, out_t = {}, {}
    for k, r in jreps.items():
        noise = rng.uniform(-0.4, 0.4, size=(2,) + r.wp.shape).astype(np.float32)
        wp = np.clip(np.array(r.wp) + noise[0], 0.0, 2.0)
        wn = np.clip(np.array(r.wn) + noise[1], 0.0, 2.0)
        mask = np.array(r.mask)
        if len(out_j) == 1:
            mask[-3:] = 0  # the low planes pruned
        out_j[k] = jbitrep.BitRep(wp=jnp.asarray(wp), wn=jnp.asarray(wn), scale=r.scale,
                                  mask=jnp.asarray(mask), n_denom=r.n_denom,
                                  group_axes=r.group_axes)
        out_t[k] = bitrep.BitRep(wp=torch.from_numpy(wp), wn=torch.from_numpy(wn),
                                 scale=torch.from_numpy(np.array(r.scale)),
                                 mask=torch.from_numpy(mask), n_denom=r.n_denom,
                                 group_axes=tuple(r.group_axes))
    return out_j, out_t


@pytest.mark.parametrize("reweigh", [True, False])
@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b"])
def test_regulariser_matches_jax_on_model_layouts(arch, reweigh):
    jreps, reps = _layout(arch)
    if arch == "qwen2-moe-a2.7b":  # per-expert groups are there
        assert any(r.group_axes == (0, 1) for r in reps.values())
    norms = jax.jit(lambda rs: {k: (j_bit_group_norms(r), j_bgl(r)) for k, r in rs.items()})
    for k, (jn, jb) in norms(jreps).items():
        _close(bit_group_norms(reps[k]), jn)
        _close(bgl(reps[k]), jb)
    total = sum(bitrep.total_numel(r) for r in reps.values())

    def jfn(planes):
        rs = {k: jbitrep.BitRep(wp=planes[k][0], wn=planes[k][1], scale=r.scale, mask=r.mask,
                                n_denom=r.n_denom, group_axes=r.group_axes)
              for k, r in jreps.items()}
        return j_memory_reweighed_bgl(rs, total, reweigh=reweigh)

    jval, jgrad = jax.jit(jax.value_and_grad(jfn))({k: (r.wp, r.wn) for k, r in jreps.items()})
    leaves = {k: (r.wp.clone().requires_grad_(True), r.wn.clone().requires_grad_(True))
              for k, r in reps.items()}
    rs = {k: bitrep.BitRep(wp=leaves[k][0], wn=leaves[k][1], scale=r.scale, mask=r.mask,
                           n_denom=r.n_denom, group_axes=r.group_axes) for k, r in reps.items()}
    calls = []
    orig = ops.bgl_sumsq_grouped
    ops.bgl_sumsq_grouped = lambda xs: calls.append(len(xs)) or orig(xs)
    try:
        val = memory_reweighed_bgl(rs, total, reweigh=reweigh)
    finally:
        ops.bgl_sumsq_grouped = orig
    assert calls == [2 * len(rs)]  # one call: every wp, then every wn
    _close(val, jval)
    grads = torch.autograd.grad(val, [x for k in leaves for x in leaves[k]])
    for (k, i), g in zip([(k, i) for k in leaves for i in (0, 1)], grads):
        np.testing.assert_allclose(g.numpy(), np.array(jgrad[k][i]), rtol=1e-5, atol=0,
                                   err_msg=f"{k} {'wn' if i else 'wp'}")


def test_regulariser_sums_equal_per_tensor_calls():
    """The grouped split gives each tensor the bits that its own per-view
    calls give: wp's sums plus wn's, in that order."""
    _, reps = _layout("granite-3-2b")
    sqs = regularizer._sumsq(list(reps.values()))
    for r, sq in zip(reps.values(), sqs):
        want = (ops.bgl_sumsq(regularizer._rows(r.wp, r.group_axes))
                + ops.bgl_sumsq(regularizer._rows(r.wn, r.group_axes)))
        assert torch.equal(sq, want)
