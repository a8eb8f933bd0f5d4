"""The port's CUDA kernel on the card (marked ``cuda``; skips without one).

This file imports neither JAX nor ``repro``, so it runs on a machine
with a card and no JAX:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances of kernel vs plain version on the same CUDA tensors: f32,
1e-4 of the largest output (the order of the sums and the epilogue's
rounding differ); bf16, 2e-2 (the plain version rounds ``x @ w`` to
bf16 before the scale, the kernel scales the f32 sum).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import packing as tpack
from repro_torch.kernels import bitserial_matmul as tkern
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CPU runs the plain version only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _packed(M, K, N, n_bits, groups, seed, dev):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((K, N)) / K**0.5).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    return tpack.pack_from_float(w, n_bits, group_cols=groups).to(dev), x.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,n_bits,groups", [
    (4, 256, 384, 6, 4), (1, 64, 128, 8, None), (72, 512, 256, 3, None),
    (130, 200, 132, 1, 33), (8, 2048, 512, 6, None),
])
def test_kernel_matches_plain_version_and_active_is_truncate(cuda, M, K, N, n_bits, groups,
                                                             dtype):
    pw, x = _packed(M, K, N, n_bits, groups, seed=M + K, dev=cuda)
    x = x.to(dtype)
    got = tops.bitserial_matmul(x, pw).float()
    want = tref.bitserial_matmul_ref(x, pw.planes, pw.sign, pw.scale, n_bits).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    iview = torch.int32 if dtype == torch.float32 else torch.int16
    for a in range(1, n_bits + 1):
        dyn = tops.bitserial_matmul(x, pw, active_planes=a)
        static = tops.bitserial_matmul(x, tpack.truncate_packed(pw, a))
        assert torch.equal(dyn.view(iview), static.view(iview)), a
    assert torch.equal(tops.bitserial_matmul(x, pw), tops.bitserial_matmul(x, pw))


def test_stacked_layer_slices_and_launch_count(cuda):
    w = torch.randn((3, 128, 256), device=cuda)
    pw = tpack.pack_stacked_from_float(w, 6)
    x = torch.randn((4, 128), device=cuda)
    tkern.reset_launches()
    for layer in range(3):
        sl = transformer.layer_slice({"w": pw}, layer)["w"]
        for view in (sl, tpack.truncate_packed(sl, 2)):
            got = tops.bitserial_matmul(x, view)
            want = tref.bitserial_matmul_ref(x, view.planes, view.sign, view.scale,
                                             view.n_bits, view.denom_bits)
            assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert tkern.launches == 6


def test_wrapper_raises_instead_of_copying(cuda):
    pw, x = _packed(4, 64, 128, 6, None, seed=0, dev=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tkern.bitserial_matmul_cuda(x, pw.planes.transpose(1, 2).contiguous().transpose(1, 2),
                                    pw.sign, pw.scale, 6, 64)
    with pytest.raises(ValueError, match="n_bits"):
        tkern.bitserial_matmul_cuda(x, pw.planes, pw.sign, pw.scale, 9, 64)
    with pytest.raises(TypeError, match="dtype"):
        tkern.bitserial_matmul_cuda(x.half(), pw.planes, pw.sign, pw.scale, 6, 64)


def test_engine_on_card_matches_cpu_tokens(cuda):
    """Reduced granite-3-2b at f32, 6-bit packed: the same greedy tokens
    from the kernel on the card and the plain path on the CPU."""
    cfg = reduced_config("granite-3-2b")
    params = transformer.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                                     pack_bits=6)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new=8) for i, n in enumerate((8, 8, 12))]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        res = ServeEngine(tpack.tree_to(params, dev), cfg, max_len=32, device=dev).generate(reqs)
        out[dev.type] = {r.uid: r.tokens for r in res}
    for uid in out["cpu"]:
        np.testing.assert_array_equal(out["cuda"][uid], out["cpu"][uid])
