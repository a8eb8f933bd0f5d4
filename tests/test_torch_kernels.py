"""The port's bitserial matmul: its plain version against the JAX
package's (jnp reference and interpret-mode Pallas), the active-plane
invariant and the wrapper's checks.  The CUDA kernel itself is tested
on the card by tests/test_torch_cuda.py."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.core import packing as tpack
from repro_torch.kernels import bitserial_matmul as tkern
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the shapes of tests/test_kernels.py::test_bitserial_matmul_sweep
SHAPES = [(8, 64, 128, 4), (128, 512, 128, 8), (16, 128, 256, 3), (8, 64, 128, 1),
          (32, 256, 128, 6)]


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    x = (rng.standard_normal((M, K)) * 0.5).astype(np.float32)
    return w, x


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("M,K,N,n_bits", SHAPES)
def test_ref_matches_jax_bitserial_matmul(M, K, N, n_bits, use_pallas):
    """f32, tol 2e-5 (the JAX sweep's own): same packed bytes, the same
    arithmetic up to the order of the matmul's sums."""
    w, x = _inputs(M, K, N, seed=M + K + n_bits)
    jpw = jpack.pack_from_float(jnp.asarray(w), n_bits)
    want = np.array(jops.bitserial_matmul(jnp.asarray(x), jpw, use_pallas=use_pallas,
                                          interpret=use_pallas))
    got = tops.bitserial_matmul(torch.from_numpy(x), bridge.from_numpy_tree(jpw)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_ref_matches_jax_with_group_scales_and_active_planes():
    w, x = _inputs(8, 128, 256, seed=7)
    jpw = jpack.pack_from_float(jnp.asarray(w), 6, group_cols=8)
    tpw = bridge.from_numpy_tree(jpw)
    for a in (None, 2, 6):
        want = np.array(jops.bitserial_matmul(jnp.asarray(x), jpw, active_planes=a,
                                              use_pallas=False))
        got = tops.bitserial_matmul(torch.from_numpy(x), tpw, active_planes=a).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n_bits", [3, 4, 8])
def test_active_planes_bitwise_equals_truncate(n_bits):
    """active_planes=a (an int or an int32 tensor) is bitwise equal to the
    static path over truncate_packed(pw, a), for every a."""
    w, x = _inputs(8, 64, 128, seed=n_bits)
    pw = tpack.pack_from_float(torch.from_numpy(w), n_bits)
    xt = torch.from_numpy(x)
    for a in range(1, n_bits + 1):
        want = tops.bitserial_matmul(xt, tpack.truncate_packed(pw, a)).numpy()
        for active in (a, torch.tensor(a, dtype=torch.int32)):
            got = tops.bitserial_matmul(xt, pw, active_planes=active).numpy()
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                          err_msg=f"a={a}")


def test_ref_equals_matmul_against_dequantised_weight():
    w, x = _inputs(8, 128, 128, seed=3)
    pw = tpack.pack_from_float(torch.from_numpy(w), 8)
    got = tref.bitserial_matmul_ref(torch.from_numpy(x), pw.planes, pw.sign, pw.scale, 8)
    want = torch.from_numpy(x) @ tpack.unpack_to_float(pw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    w, x = _inputs(4, 64, 128)
    pw = tpack.pack_from_float(torch.from_numpy(w), 6)
    with pytest.raises(ValueError, match="CUDA"):
        tkern.bitserial_matmul_cuda(torch.from_numpy(x), pw.planes, pw.sign, pw.scale, 6, 64)
    assert tkern.launches == 0


# (M, K, N): granite-3-2b's and gemma3-12b's projections at decode, and
# ragged shapes
SPLIT_SHAPES = [(4, 2048, 2048), (4, 2048, 512), (4, 2048, 8192), (4, 8192, 2048),
                (2, 3840, 4096), (2, 3840, 2048), (2, 4096, 3840), (2, 3840, 15360),
                (2, 15360, 3840), (8, 15360, 3840), (1, 64, 128), (3, 200, 132), (8, 8, 4)]


@pytest.mark.parametrize("M,K,N", SPLIT_SHAPES)
def test_split_plan_tiles_k(M, K, N):
    """The decode kernel's grid follows ``split_plan``: the splits tile the
    byte-rows [0, K8) with no gap, no overlap and no empty split, and are
    few enough to form one thread block cluster."""
    K8 = -(-K // 8)
    n_split, rows = tkern.split_plan(M, K8, N)
    spans = [(s * rows, min((s + 1) * rows, K8)) for s in range(n_split)]
    assert all(lo < hi for lo, hi in spans)
    starts, ends = [lo for lo, _ in spans], [hi for _, hi in spans]
    assert starts == [0] + ends[:-1] and ends[-1] == K8
    assert 1 <= n_split <= tkern.MAX_SPLITS


def test_split_plan_depends_on_the_shape_alone():
    """No runtime operand reaches the plan (so a call with ``active`` sums
    in the order of the static call of the same shape): its inputs are M,
    K8 and N.  On the main path's projections the grid of column blocks
    (128 columns, 64 at M > 4) stays within one wave of 264 blocks (two
    per SM) and every thread of a split gets the same whole number of
    byte-rows."""
    assert list(inspect.signature(tkern.split_plan).parameters) == ["M", "K8", "N"]
    for M, K, N in SPLIT_SHAPES[:10]:
        n_split, rows = tkern.split_plan(M, K // 8, N)
        cols = tkern.SPLIT_COLS if M <= 4 else tkern.SPLIT_COLS // 2
        assert n_split * -(-N // cols) <= tkern.SPLIT_TARGET_BLOCKS, (M, K, N)
        assert rows % tkern.SPLIT_K_THREADS == 0, (M, K, N)
    assert tkern.split_plan(4, 256, 2048) == (16, 16)  # granite-3-2b's q and o
    assert tkern.split_plan(4, 256, 8192) == (4, 64)  # granite-3-2b's gate and up
    assert tkern.split_plan(8, 256, 8192) == (2, 128)  # ... at 8 lanes
    assert tkern.split_plan(2, 1920, 3840) == (8, 240)  # gemma3-12b's down projection
    body = inspect.getsource(tkern.bitserial_matmul_cuda)
    for host_read in (".item(", ".tolist(", ".cpu(", "int(active", ".numpy("):
        assert host_read not in body, host_read
