"""The port's BSQ core against the JAX package: bit representation, STE,
the bit-group-Lasso regulariser (through the ``bgl_sumsq`` dispatcher)
and its gradients, requant, scheme and the packed export.

Inputs are made with numpy from a seed and handed to both.  Tolerances:

* ``bgl_sumsq``: 1e-5 relative (f32 sums of squares in another order;
  the JAX side is the Pallas kernel in interpret mode);
* regulariser values and gradients: 1e-5 relative (f32 sums over the
  non-group axes in another order);
* bit planes, masks, integer codes, packed bytes, scheme: exact;
* STE forward values and plane gradients: exact (the port sums the
  planes in the JAX order, and the backward only scales by powers of two
  and {0,1}); the scale gradient 1e-5 relative (an f32 sum over the
  group's elements in another order, with cancellation).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bitrep as jbitrep
import repro.core.bsq as jbsq
from repro.core.regularizer import bgl as j_bgl
from repro.core.regularizer import bit_group_norms as j_bit_group_norms
from repro.core.regularizer import memory_reweighed_bgl as j_memory_reweighed_bgl
from repro.core.regularizer import scheme_summary as j_scheme_summary
import repro.core.requant as jrq
import repro.core.scheme as jscheme
import repro.core.ste as jste
from repro.kernels import ops as jops
from repro_torch.configs import reduced_config
import repro_torch.core.bitrep as bitrep
import repro_torch.core.bsq as bsq
from repro_torch.core.regularizer import bgl, bit_group_norms, memory_reweighed_bgl
from repro_torch.core.regularizer import scheme_summary
import repro_torch.core.requant as requant
import repro_torch.core.scheme as scheme
import repro_torch.core.ste as ste
from repro_torch.core.packing import PackedWeight
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (w_shape, group_axes): one group, stacked layers, a non-leading group axis
CASES = [((24, 16), ()), ((2, 16, 24), (0,)), ((4, 6, 8), (2,))]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rep(jr) -> bitrep.BitRep:
    return bitrep.BitRep(wp=_t(jr.wp), wn=_t(jr.wn), scale=_t(jr.scale), mask=_t(jr.mask),
                         n_denom=jr.n_denom, group_axes=tuple(jr.group_axes))


@functools.lru_cache(maxsize=None)
def _j_decompose(n_bits, group_axes):
    return jax.jit(functools.partial(jbitrep.decompose, n_bits=n_bits, group_axes=group_axes))


def _continuous(shape, group_axes, n_bits=4, seed=0):
    """A JAX BitRep whose planes left {0, 1} (as after some training
    steps), with a masked headroom plane; and the port's copy."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    jr = _j_decompose(n_bits, group_axes)(jnp.asarray(w))
    noise = rng.uniform(-0.4, 0.4, size=(2,) + jr.wp.shape).astype(np.float32)
    wp = np.clip(np.array(jr.wp) + noise[0], 0.0, 2.0)
    wn = np.clip(np.array(jr.wn) + noise[1], 0.0, 2.0)
    jr = jbitrep.BitRep(wp=jnp.asarray(wp), wn=jnp.asarray(wn), scale=jr.scale, mask=jr.mask,
                        n_denom=jr.n_denom, group_axes=jr.group_axes)
    return jr, _rep(jr)


def _close(got: torch.Tensor, want, rtol):
    np.testing.assert_allclose(got.detach().numpy(), np.array(want), rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# kernel 4's plain version and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", [(8, 4096), (16, 8192), (2, 512), (18, 1024)])
def test_bgl_sumsq_matches_jax_pallas_interpret(R, C, dtype):
    x = jnp.asarray(np.random.default_rng(R * C).standard_normal((R, C)), dtype)
    want = jops.bgl_sumsq(x, use_pallas=True, interpret=True)
    xt = _t(x.astype(jnp.float32)).to(getattr(torch, dtype))  # exact: bf16 values in f32
    got = ops.bgl_sumsq(xt)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_bgl_sumsq_gradcheck_and_backward():
    x = torch.randn((3, 7), dtype=torch.float64, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    assert torch.autograd.gradcheck(ops.bgl_sumsq, (x,))
    torch.testing.assert_close(ops.bgl_sumsq(x.detach()), ref.bgl_sumsq_ref(x.detach()))
    # f32 and bf16 inputs: the plain version sums in f32, the gradient is 2 x g
    for dt in (torch.float32, torch.bfloat16):
        xd = x.detach().to(dt).requires_grad_(True)
        g = torch.arange(1.0, 4.0)
        (gx,) = torch.autograd.grad(ops.bgl_sumsq(xd), xd, g)
        assert gx.dtype == dt
        torch.testing.assert_close(gx, (xd.detach().float() * (2 * g)[:, None]).to(dt))


# ---------------------------------------------------------------------------
# bit representation and STE
# ---------------------------------------------------------------------------


def test_round_is_half_to_even_in_both():
    x = np.array([-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 0.49999997], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.array(jnp.round(jnp.asarray(x))))
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(ste.ste_round(xt).sum(), xt)
    np.testing.assert_array_equal(g.numpy(), np.ones_like(x))
    np.testing.assert_array_equal(ste.ste_round(xt).detach().numpy(), np.round(x))


@pytest.mark.parametrize("shape,group_axes", CASES)
def test_decompose_and_helpers_match_jax(shape, group_axes):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0
    jr = _j_decompose(5, group_axes)(jnp.asarray(w))
    r = bitrep.decompose(torch.from_numpy(w), 5, group_axes=group_axes)
    for f in ("wp", "wn", "scale", "mask"):
        np.testing.assert_array_equal(getattr(r, f).numpy(), np.array(getattr(jr, f)), err_msg=f)
    assert (r.n_denom, r.group_axes) == (jr.n_denom, tuple(jr.group_axes))
    np.testing.assert_array_equal(bitrep.effective_bits(r).numpy(),
                                  np.array(jbitrep.effective_bits(jr)))
    np.testing.assert_array_equal(bitrep.reconstruct_exact(r).numpy(),
                                  np.array(jbitrep.reconstruct_exact(jr)))
    q = np.abs(np.round(w * 31)).astype(np.int32) % 64
    planes = bitrep.int_to_planes(torch.from_numpy(q), 6)
    np.testing.assert_array_equal(planes.numpy(), np.array(jbitrep.int_to_planes(jnp.asarray(q), 6)))
    np.testing.assert_array_equal(bitrep.planes_to_int(planes).numpy(), q)
    assert (bitrep.numel_per_group(r), bitrep.num_groups(r), bitrep.total_numel(r)) == (
        jbitrep.numel_per_group(jr), jbitrep.num_groups(jr), jbitrep.total_numel(jr))


@pytest.mark.parametrize("shape,group_axes", CASES)
def test_bitrep_forward_values_and_grads_match_jax(shape, group_axes):
    jr, r = _continuous(shape, group_axes, seed=2)
    cot = np.random.default_rng(3).standard_normal(shape).astype(np.float32)

    def jloss(wp, wn, scale):
        return jnp.sum(jste.bitrep_forward(wp, wn, scale, jr.mask, jr.n_denom) * cot)

    jw = jste.bitrep_forward(jr.wp, jr.wn, jr.scale, jr.mask, jr.n_denom)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jr.wp, jr.wn, jr.scale)
    leaves = [x.clone().requires_grad_(True) for x in (r.wp, r.wn, r.scale)]
    w = ste.bitrep_forward(*leaves, r.mask, r.n_denom)
    g = torch.autograd.grad(torch.sum(w * torch.from_numpy(cot)), leaves)
    np.testing.assert_array_equal(w.detach().numpy(), np.array(jw))
    np.testing.assert_array_equal(g[0].numpy(), np.array(jg[0]))
    np.testing.assert_array_equal(g[1].numpy(), np.array(jg[1]))
    _close(g[2], jg[2], 1e-5)
    # a masked plane gets no gradient
    assert not g[0][-1].any()


# ---------------------------------------------------------------------------
# regulariser
# ---------------------------------------------------------------------------


def _rep_dicts(seed=4):
    jreps, reps = {}, {}
    for i, (shape, ga) in enumerate(CASES):
        jreps[f"t{i}"], reps[f"t{i}"] = _continuous(shape, ga, seed=seed + i)
    # a requantised tensor: a narrower mask, so #Bit differs per tensor
    j2 = jax.jit(jrq.requantize_static)(jreps["t1"])
    jreps["t1"], reps["t1"] = j2, _rep(j2)
    return jreps, reps


@pytest.mark.parametrize("reweigh", [True, False])
def test_regularizer_values_and_grads_match_jax(reweigh):
    jreps, reps = _rep_dicts()
    j_norms = jax.jit(lambda rs: {k: (j_bit_group_norms(r), j_bgl(r)) for k, r in rs.items()})
    for k, (jn, jb) in j_norms(jreps).items():
        _close(bit_group_norms(reps[k]), jn, 1e-5)
        _close(bgl(reps[k]), jb, 1e-5)
    total = sum(bitrep.total_numel(r) for r in reps.values()) + 17

    def jfn(planes):
        rs = {k: jbitrep.BitRep(wp=planes[k][0], wn=planes[k][1], scale=r.scale, mask=r.mask,
                                n_denom=r.n_denom, group_axes=r.group_axes)
              for k, r in jreps.items()}
        return j_memory_reweighed_bgl(rs, total, reweigh=reweigh)

    jplanes = {k: (r.wp, r.wn) for k, r in jreps.items()}
    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(jplanes)
    leaves = {k: (r.wp.clone().requires_grad_(True), r.wn.clone().requires_grad_(True))
              for k, r in reps.items()}
    rs = {k: bitrep.BitRep(wp=leaves[k][0], wn=leaves[k][1], scale=r.scale, mask=r.mask,
                           n_denom=r.n_denom, group_axes=r.group_axes) for k, r in reps.items()}
    val = memory_reweighed_bgl(rs, total, reweigh=reweigh)
    flat = [x for k in leaves for x in leaves[k]]
    grads = torch.autograd.grad(val, flat)
    _close(val, jval, 1e-5)
    for (k, i), g in zip([(k, i) for k in leaves for i in (0, 1)], grads):
        _close(g, jgrad[k][i], 1e-5)
    summary = scheme_summary(reps)
    for k, v in j_scheme_summary(jreps).items():
        np.testing.assert_array_equal(summary[k].numpy(), np.array(v))


# ---------------------------------------------------------------------------
# requant and scheme
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,group_axes", CASES)
def test_requantize_static_matches_jax(shape, group_axes):
    jr, r = _continuous(shape, group_axes, seed=5)
    j2, r2 = jax.jit(jrq.requantize_static)(jr), requant.requantize_static(r)
    for f in ("wp", "wn", "scale", "mask"):
        np.testing.assert_array_equal(getattr(r2, f).numpy(), np.array(getattr(j2, f)),
                                      err_msg=f)
    assert r2.n_denom == j2.n_denom
    assert requant.verify_equivalence(r2, requant.requantize_static(r2))
    # eager, as the JAX package's own tests call it (under jit XLA may
    # fold the division into a multiply by the reciprocal, 1 ulp apart)
    np.testing.assert_array_equal(requant.forward_value(r).numpy(),
                                  np.array(jrq.forward_value(jr)))


@pytest.mark.parametrize("seed", [6, 7])
def test_requantize_dynamic_and_headroom_match_jax(seed):
    rng = np.random.default_rng(seed)
    # small codes: the top planes are all zero and get stripped
    w = (rng.standard_normal((16, 12)) * (0.1 if seed == 6 else 1.0)).astype(np.float32)
    w[0, 0] = 1.0
    jr = jbitrep.decompose(jnp.asarray(w), 6, n_max=6)
    jr = jbitrep.BitRep(wp=jr.wp * 1.3, wn=jr.wn, scale=jr.scale, mask=jr.mask,
                        n_denom=jr.n_denom, group_axes=jr.group_axes)
    r = _rep(jr)
    j2, r2 = jrq.requantize_dynamic(jr), requant.requantize_dynamic(r)
    for f in ("wp", "wn", "scale", "mask"):
        np.testing.assert_array_equal(getattr(r2, f).numpy(), np.array(getattr(j2, f)),
                                      err_msg=f)
    assert r2.n_denom == j2.n_denom
    assert requant.verify_equivalence(r2, requant.grow_headroom(r2))
    j3, r3 = jrq.grow_headroom(j2, 2), requant.grow_headroom(r2, 2)
    for f in ("wp", "wn", "mask"):
        np.testing.assert_array_equal(getattr(r3, f).numpy(), np.array(getattr(j3, f)))
    with pytest.raises(ValueError, match="single-\ngroup|single-group|group"):
        requant.requantize_dynamic(_continuous((2, 8, 8), (0,))[1])


def test_scheme_matches_jax():
    jreps, reps = _rep_dicts(seed=8)
    js, s = jscheme.scheme_from_reps(jreps, float_params=3), scheme.scheme_from_reps(reps, 3)
    assert s.to_json() == js.to_json()
    assert (s.bits_per_param, s.compression) == (js.bits_per_param, js.compression)
    assert scheme.QuantScheme.from_json(s.to_json()).to_json() == s.to_json()
    assert bsq.extract_scheme(reps, 3).to_json() == jbsq.extract_scheme(jreps, 3).to_json()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _assert_same_packed(pw: PackedWeight, jpw):
    np.testing.assert_array_equal(pw.planes.numpy(), np.array(jpw.planes))
    np.testing.assert_array_equal(pw.sign.numpy(), np.array(jpw.sign))
    np.testing.assert_array_equal(pw.scale.numpy(), np.array(jpw.scale, np.float32))
    assert (pw.n_bits, pw.k, pw.planes.dtype, pw.sign.dtype) == (
        jpw.n_bits, jpw.k, torch.uint8, torch.uint8)


@pytest.mark.parametrize("shape,group_axes", [((24, 16), ()), ((2, 16, 24), (0,)),
                                              ((16, 24), (1,)), ((2, 12, 16), (0,))])
def test_export_packed_bytes_identical_to_jax(shape, group_axes):
    """2D, stacked, per-output-column groups and a ragged K (12 rows)."""
    jr, r = _continuous(shape, group_axes, n_bits=6, seed=9)
    _assert_same_packed(bsq.export_packed({"w": r})["w"], jbsq.export_packed({"w": jr})["w"])


def test_exported_model_serves_through_the_bitserial_path():
    """Reduced granite-3-2b: BSQ reps of the port's params, exported (the
    byte identity with JAX is held above), merged with the reconstructed
    embedding and the float params, run through the port's model on its
    bitserial path: logits within 1e-4 of the reconstructed float model's."""
    cfg = reduced_config("granite-3-2b")
    tparams = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    qp, fp = bsq.partition_params(tparams)
    reps = bsq.init_bitreps(qp, bsq.BSQConfig(n_init=6))
    packed = bsq.export_packed(reps)
    dense = {k: requant.forward_value(r) for k, r in reps.items()}
    served = dict(dense, **{k: v for k, v in packed.items() if k != "embed"})
    f_params = bsq.merge_params(tparams, dense, fp)
    p_params = bsq.merge_params(tparams, served, fp)
    assert isinstance(p_params["blocks"]["p0"]["mlp"]["w_up"], PackedWeight)
    assert packed["blocks/p0/mlp/w_up"].scale.shape == (2, 1, 1)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 12)))
    want, _ = transformer.forward(f_params, {"tokens": tokens}, cfg)
    got, _ = transformer.forward(p_params, {"tokens": tokens}, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
