"""The port's packer against the JAX packer: byte-identical planes, sign
and scales, equal dequantisation, and the bridge's byte copy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro_torch import bridge
from repro_torch.core import packing as tpack
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _w(seed, shape, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _assert_same(jpw, tpw):
    np.testing.assert_array_equal(np.array(jpw.planes), tpw.planes.numpy())
    np.testing.assert_array_equal(np.array(jpw.sign), tpw.sign.numpy())
    js = np.array(jpw.scale, np.float32)
    assert js.shape == tuple(tpw.scale.shape)
    np.testing.assert_array_equal(js.view(np.uint32), tpw.scale.numpy().view(np.uint32))
    assert (jpw.n_bits, jpw.k, jpw.denom_bits) == (tpw.n_bits, tpw.k, tpw.denom_bits)


@pytest.mark.parametrize("K,N,n_bits,groups", [
    (64, 128, 4, None), (128, 64, 8, None), (64, 128, 1, None), (256, 128, 6, 4),
    (64, 256, 3, 256),
])
def test_pack_from_float_byte_identical(K, N, n_bits, groups):
    w = _w(K * N + n_bits, (K, N))
    jpw = jax.jit(jpack.pack_from_float, static_argnums=(1, 2))(jnp.asarray(w), n_bits, groups)
    tpw = tpack.pack_from_float(torch.from_numpy(w), n_bits, group_cols=groups)
    _assert_same(jpw, tpw)
    np.testing.assert_array_equal(np.array(jpack.unpack_to_float(jpw)),
                                  tpack.unpack_to_float(tpw).numpy())


@pytest.mark.parametrize("K", [61, 64, 7])
def test_pack_quantized_byte_identical_with_k_padding(K):
    rng = np.random.default_rng(K)
    q = rng.integers(-31, 32, size=(K, 72)).astype(np.int32)
    s = np.float32(0.37)
    jpw = jpack.pack_quantized(jnp.asarray(q), jnp.asarray(s), 5)
    tpw = tpack.pack_quantized(torch.from_numpy(q), torch.tensor(s), 5)
    _assert_same(jpw, tpw)
    got = tpack.unpack_to_float(tpw).numpy()
    assert got.shape == (K, 72)
    np.testing.assert_array_equal(np.array(jpack.unpack_to_float(jpw)), got)
    np.testing.assert_array_equal(
        tpack.unpack_bits_axis0(tpw.sign, K).numpy(), (q < 0).astype(np.uint8))


def test_pack_stacked_and_truncate_byte_identical():
    w = _w(5, (3, 64, 128))
    jpw = jpack.pack_stacked_from_float(jnp.asarray(w), 6)
    tpw = tpack.pack_stacked_from_float(torch.from_numpy(w), 6)
    _assert_same(jpw, tpw)
    assert tuple(tpw.scale.shape) == (3, 1, 1)
    np.testing.assert_array_equal(np.array(jpack.unpack_to_float(jpw)),
                                  tpack.unpack_to_float(tpw).numpy())
    for a in range(1, 7):
        jt, tt = jpack.truncate_packed(jpw, a), tpack.truncate_packed(tpw, a)
        _assert_same(jt, tt)
        # each layer's slice of the truncated planes is what the kernel reads
        assert all(tt.planes[l].is_contiguous() for l in range(3))
        np.testing.assert_array_equal(np.array(jpack.unpack_to_float(jt)),
                                      tpack.unpack_to_float(tt).numpy())


def test_scale_row_forms():
    for s, n in [(np.float32(2.0), 16), (np.ones((1, 1), np.float32), 16),
                 (np.arange(4, dtype=np.float32).reshape(1, 4), 16)]:
        np.testing.assert_array_equal(np.array(jpack.scale_row(jnp.asarray(s), n)),
                                      tpack.scale_row(torch.from_numpy(np.array(s)), n).numpy())
    with pytest.raises(ValueError):
        tpack.scale_row(torch.ones(1, 3), 16)


def test_pack_model_params_and_bridge_copy_bytes():
    """The same float tree packs to the same leaves in both packages, and
    the bridge copies a JAX packed tree byte for byte."""
    tree = {"blocks": {"p0": {"mixer": {"wq": _w(1, (2, 64, 64)), "norm": _w(2, (2, 64))}}},
            "embed": _w(3, (96, 64)), "tail": [{"mlp": {"w_down": _w(4, (128, 64))}}]}
    jtree = jpack.pack_model_params({k: _to_jnp(v) for k, v in tree.items()}, 6)
    ttree = tpack.pack_model_params(bridge.from_numpy_tree(tree), 6)
    _assert_same(jtree["blocks"]["p0"]["mixer"]["wq"], ttree["blocks"]["p0"]["mixer"]["wq"])
    _assert_same(jtree["tail"][0]["mlp"]["w_down"], ttree["tail"][0]["mlp"]["w_down"])
    assert not isinstance(ttree["embed"], tpack.PackedWeight)
    bridged = bridge.from_numpy_tree(jtree)
    _assert_same(jtree["blocks"]["p0"]["mixer"]["wq"], bridged["blocks"]["p0"]["mixer"]["wq"])
    np.testing.assert_array_equal(bridged["embed"].numpy(), tree["embed"])
    assert len(tpack.packed_leaves(bridged)) == 2


def _to_jnp(t):
    if isinstance(t, dict):
        return {k: _to_jnp(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_jnp(v) for v in t]
    return jnp.asarray(t)
