"""The port's paged decode attention (plain version and dispatch) against
the JAX package's: ``repro.kernels.ref.paged_attention_ref`` and the
Pallas kernel ``paged_attention_pallas`` in interpret mode, on the cases
of tests/test_paged_kernel.py.  The CUDA kernel itself is tested on the
card by tests/test_torch_cuda.py.

Tolerances: against the JAX reference 2e-5 (both gather and take an f32
softmax; the sums run in another order); against the Pallas kernel 2e-5
in f32 (the JAX suite's own) and 2e-2 with a bf16 pool (the kernel's
online softmax rounds p to bf16 before p.V)."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import paged_attention_ref as j_paged_attention_ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tkern
from repro_torch.kernels.ref import paged_attention_ref

TOL = 2e-5


def _case(seed, *, B=3, n_kv=2, G=2, d=16, bs=4, nb_lane=6, dtype=np.float32):
    """Seeded inputs with lane-disjoint SHUFFLED tables (logical block
    order != pool order) and a couple of never-referenced pool blocks."""
    rng = np.random.default_rng(seed)
    n_blocks = B * nb_lane + 2
    q = rng.normal(size=(B, n_kv, G, d)).astype(np.float32)
    k = rng.normal(size=(n_blocks, bs, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(n_blocks, bs, n_kv, d)).astype(np.float32)
    table = rng.permutation(n_blocks)[: B * nb_lane].reshape(B, nb_lane).astype(np.int32)
    return q, k, v, table, dtype


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _port(q, k, v, table, pos, window=None, kv_dtype=torch.float32):
    return tops.paged_attention(_torch(q), _torch(k, kv_dtype), _torch(v, kv_dtype),
                                torch.from_numpy(table),
                                torch.from_numpy(np.asarray(pos, np.int32)), window=window)


def _check(q, k, v, table, pos, window=None, pallas=True):
    pos = np.asarray(pos, np.int32)
    got = _port(q, k, v, table, pos, window)
    assert tuple(got.shape) == q.shape and got.dtype == torch.float32
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), jnp.asarray(pos))
    want = np.array(j_paged_attention_ref(*jargs, window=window))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if pallas:
        kern = np.array(jops.paged_attention(*jargs, window=window, use_pallas=True,
                                             interpret=True))
        np.testing.assert_allclose(got.numpy(), kern, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bs,nb_lane", [(2, 12), (4, 6), (8, 3)])
def test_block_sizes(bs, nb_lane):
    q, k, v, tbl, _ = _case(0, bs=bs, nb_lane=nb_lane)
    _check(q, k, v, tbl, [bs * nb_lane - 1, bs + 1, 0])


@pytest.mark.parametrize("seed", range(4))
def test_ragged_live_lengths(seed):
    q, k, v, tbl, _ = _case(seed)
    pos = np.random.default_rng(100 + seed).integers(0, 4 * 6, size=3)
    _check(q, k, v, tbl, pos, pallas=seed < 2)


@pytest.mark.parametrize("n_kv,G", [(1, 4), (2, 2), (4, 1), (2, 4)])
def test_gqa_ratios(n_kv, G):
    q, k, v, tbl, _ = _case(1, n_kv=n_kv, G=G)
    _check(q, k, v, tbl, [17, 5, 0])


@pytest.mark.parametrize("window", [1, 3, 5, 64])
def test_sliding_window(window):
    q, k, v, tbl, _ = _case(2)
    _check(q, k, v, tbl, [23, 7, 2], window=window)


def test_inactive_lanes_exact_zero():
    """pos < 0 marks an inactive lane: exact zeros there, the active
    neighbours as JAX computes them."""
    q, k, v, tbl, _ = _case(3)
    out = _port(q, k, v, tbl, [-1, 9, -1])
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    _check(q, k, v, tbl, [-1, 9, -1])
    assert torch.equal(_port(q, k, v, tbl, [-1, -1, -1]), torch.zeros(q.shape))


def test_stale_table_entries_do_not_change_the_output():
    """Entries past a lane's live length (stale ids of an evicted tenant)
    are masked: scrambling them leaves the output bitwise unchanged."""
    q, k, v, tbl, _ = _case(4)
    pos = [9, 3, 0]  # live blocks per lane: 3, 1, 1 (of 6)
    base = _port(q, k, v, tbl, pos)
    scrambled = tbl.copy()
    for b, live in enumerate([3, 1, 1]):
        scrambled[b, live:] = (scrambled[b, live:] + 5) % k.shape[0]
    assert torch.equal(base, _port(q, k, v, scrambled, pos))


def test_bf16_pool():
    """bf16 K/V pool with an f32 query: the port's plain version equals
    JAX's on the same bf16 values, and the Pallas kernel to bf16
    resolution."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 2, 2, 16)).astype(np.float32)
    k = jnp.asarray(rng.normal(size=(14, 4, 2, 16)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(14, 4, 2, 16)), jnp.bfloat16)
    tbl = rng.permutation(14)[:12].reshape(2, 6).astype(np.int32)
    pos = np.asarray([20, 6], np.int32)
    got = _port(q, np.array(k.astype(jnp.float32)), np.array(v.astype(jnp.float32)), tbl, pos,
                kv_dtype=torch.bfloat16)
    jargs = (jnp.asarray(q), k, v, jnp.asarray(tbl), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.array(j_paged_attention_ref(*jargs)),
                               atol=TOL, rtol=TOL)
    kern = np.array(jops.paged_attention(*jargs, use_pallas=True, interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, atol=2e-2, rtol=2e-2)


def test_ref_matches_dense_softmax():
    """With an identity block table the plain version is causal
    single-query attention."""
    rng = np.random.default_rng(6)
    B, KV, G, d, bs, nb = 2, 2, 2, 8, 4, 3
    q = torch.from_numpy(rng.normal(size=(B, KV, G, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B * nb, bs, KV, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B * nb, bs, KV, d)).astype(np.float32))
    tbl = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    pos = torch.tensor([bs * nb - 1, 5], dtype=torch.int32)
    out = paged_attention_ref(q, k, v, tbl, pos)
    keys, vals = k.reshape(B, nb * bs, KV, d), v.reshape(B, nb * bs, KV, d)
    for b in range(B):
        for kv in range(KV):
            for g in range(G):
                s = keys[b, : pos[b] + 1, kv] @ q[b, kv, g] * d**-0.5
                want = torch.softmax(s, 0) @ vals[b, : pos[b] + 1, kv]
                torch.testing.assert_close(out[b, kv, g], want, atol=1e-5, rtol=1e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v, tbl, _ = _case(0)
    tkern.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tkern.paged_attention_cuda(_torch(q), _torch(k), _torch(v), torch.from_numpy(tbl),
                                   torch.zeros(3, dtype=torch.int32))
    assert tkern.launches == 0


@pytest.mark.parametrize("nb_lane,bs", [(1, 1), (6, 4), (16, 32), (97, 32), (3, 256),
                                        (12, 48), (5, 1000), (0, 16)])
def test_split_plan_tiles_the_table(nb_lane, bs):
    """The kernel's grid and scratch follow ``split_plan``: whole table
    blocks per split, and splits that tile the lane's rows [0, nb_lane *
    bs) with no gap and no overlap."""
    n_split, rows = tkern.split_plan(nb_lane, bs)
    assert rows >= bs and rows % bs == 0
    L = nb_lane * bs
    spans = [(s * rows, min((s + 1) * rows, L)) for s in range(n_split)]
    assert all(lo < hi for lo, hi in spans)  # no empty split
    starts = [lo for lo, _ in spans]
    ends = [hi for _, hi in spans]
    assert starts == [0] + ends[:-1] if spans else L == 0  # contiguous, from row 0
    assert ends[-1:] == ([L] if L else [])


def test_split_plan_depends_on_the_table_shape_alone():
    """No decode-step argument reaches the plan: its inputs are the
    table's width and the block size, and the wrapper reads no position
    on the host (a CUDA graph can capture the decode step)."""
    assert list(inspect.signature(tkern.split_plan).parameters) == ["blocks_per_lane",
                                                                   "block_size"]
    assert tkern.split_plan(97, 32) == (25, 128)  # gemma3-12b's continuous table
    assert tkern.split_plan(16, 32) == (4, 128)   # granite-3-2b's
    body = inspect.getsource(tkern.paged_attention_cuda)
    for host_read in (".item(", ".tolist(", ".cpu(", "int(pos", ".numpy("):
        assert host_read not in body, host_read
