"""The port's CUDA kernels on the card (marked ``cuda``; skip without one).

This file imports neither JAX nor ``repro``, so it runs on a machine
with a card and no JAX:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances of kernel vs plain version on the same CUDA tensors, each of
the largest |output|:

* bitserial matmul: f32 1e-4 (the order of the sums and the epilogue's
  rounding differ); bf16 2e-2 (the plain version rounds ``x @ w`` to
  bf16 before the scale, the kernel scales the f32 sum);
* paged attention: f32 1e-5 (an online softmax against a one-pass one);
  bf16 2e-2 (the kernel rounds K to q's dtype and p to V's dtype, the
  plain version computes in f32);
* bgl_sumsq: 1e-5 of each row's plain value (f32 sums of non-negative
  terms in another order; bf16 widens exactly to f32 in both); its
  backward bitwise (the plain version's one product per element);
* flash attention: f32 1e-5 (an online softmax over key tiles against a
  one-pass one); bf16 2e-2 (the kernel rounds the unnormalised p to V's
  dtype, the plain version the normalised one).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import BSQConfig
from repro_torch.core import packing as tpack
from repro_torch.data import MarkovLM
from repro_torch.kernels import bgl_sumsq as tbgl
from repro_torch.kernels import bitserial_matmul as tkern
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer
from repro_torch.optim import SGDM, step_decay
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import init_bsq_state, make_bsq_train_step, make_requant_step
from repro_torch.tree import tree_map
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
    # decode (split K over blocks) at M 1 and 2; the large-M tiles at M 9,
    # 64, 129 (8 planes: the wide unpacking) and 1024
    (1, 2048, 2048, 6, None), (2, 2048, 8192, 6, 16), (9, 512, 384, 6, None),
    (64, 1024, 2048, 6, None), (129, 512, 256, 8, None), (1024, 2048, 2048, 6, 16),
    # gemma3-12b's projections at decode (M 2) and one at prefill
    (2, 3840, 4096, 6, None), (2, 3840, 2048, 6, None), (2, 4096, 3840, 6, None),
    (2, 3840, 15360, 6, None), (2, 15360, 3840, 6, None), (1024, 3840, 15360, 6, None),
    # K 200 (25 byte-rows: a partial K step) with ragged N
    (4, 200, 136, 6, None), (64, 200, 144, 6, None),
    # the MoE slices' shapes at the M their paths run: qwen2-moe-a2.7b's
    # untied head (N 152064) at a bucket of 4 and at 8 lanes (it runs on each
    # lane's last token only); phi3.5-moe's q/o, k/v and head (N 32256) at a
    # bucket of 4, and its k/v at the 4 x 256-token prefill
    (4, 2048, 152064, 6, None), (8, 2048, 152064, 6, None),
    (4, 4096, 4096, 6, None), (4, 4096, 1024, 6, None), (1024, 4096, 1024, 6, None),
    (4, 4096, 32256, 6, None),
    # a rank's blocks on the 2x2 mesh: gemma3-12b's q/o, k/v, gate/up and
    # down at a bucket of 4; recurrentgemma-9b's one K/V head cut to 128 of
    # its 256 columns at 8 lanes; qwen2-moe's shared MLP; llama-3.2-vision's
    # cross K/V over 4 lanes x 1600 tokens (M 6400)
    (4, 1920, 2048, 6, None), (4, 1920, 1024, 6, None), (4, 1920, 7680, 6, None),
    (4, 7680, 1920, 6, None), (8, 2048, 128, 6, None), (8, 1024, 2816, 6, None),
    (6400, 2048, 512, 6, None),
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
        active = torch.tensor([a], dtype=torch.int32, device=cuda)
        dyn = tops.bitserial_matmul(x, pw, active_planes=active)
        static = tops.bitserial_matmul(x, tpack.truncate_packed(pw, a))
        assert torch.equal(dyn.view(iview), static.view(iview)), a
    assert torch.equal(tops.bitserial_matmul(x, pw), tops.bitserial_matmul(x, pw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)])
@pytest.mark.parametrize("M", [8, 32, 40])
def test_active_is_truncate_at_the_serving_shapes(cuda, M, K, N, dtype):
    """The runtime plane count at the M of the policies' serving path
    (8 lanes: a grouped decode or a draft step at M 8; a verify chunk of
    width 4 at M 32; 40 rows) on granite-3-2b's projections: bitwise the
    static kernel over ``truncate_packed`` at the same M, for every a,
    with the count read from a device tensor and counted as such."""
    pw, x = _packed(M, K, N, 6, None, seed=M, dev=cuda)
    x = x.to(dtype)
    iview = torch.int32 if dtype == torch.float32 else torch.int16
    for a in range(1, 7):
        active = torch.tensor([a], dtype=torch.int32, device=cuda)
        tkern.reset_launches()
        dyn = tops.bitserial_matmul(x, pw, active_planes=active)
        assert (tkern.launches, tkern.active_launches) == (1, 1)
        static = tops.bitserial_matmul(x, tpack.truncate_packed(pw, a))
        assert tkern.active_launches == 1
        assert torch.equal(dyn.view(iview), static.view(iview)), a


def test_kernel_paths(cuda):
    """Decode takes the split-K kernel, bf16 at large M the wgmma tile;
    f32, and shapes the wgmma tile does not take, the SIMT tile."""
    for M, K, N, dtype, path in [(4, 2048, 2048, torch.bfloat16, "splitk"),
                                 (8, 256, 132, torch.float32, "splitk"),
                                 (512, 2048, 2048, torch.bfloat16, "wgmma"),
                                 (130, 200, 144, torch.bfloat16, "wgmma"),
                                 (512, 2048, 2048, torch.float32, "tiled"),
                                 (130, 200, 132, torch.bfloat16, "tiled")]:
        pw, x = _packed(M, K, N, 6, None, seed=1, dev=cuda)
        assert tkern.kernel_path(x.to(dtype), pw.planes, pw.sign) == path, (M, K, N, dtype)


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
    # a Python int plane count on the card would be a host-to-device copy
    # per launch: the entry point refuses it
    with pytest.raises(TypeError, match="int32 tensor"):
        tops.bitserial_matmul(x, pw, active_planes=3)


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


def _paged_case(B, KV, G, d, bs, nb_lane, dtype, seed, dev):
    """Shuffled lane-disjoint tables over a pool with spare blocks that no
    table names."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_blocks = B * nb_lane + 3
    q = torch.randn((B, KV, G, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((n_blocks, bs, KV, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((n_blocks, bs, KV, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_blocks, generator=gen, device=dev)[: B * nb_lane]
    return q, k, v, perm.reshape(B, nb_lane).to(torch.int32).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,bs,G,window,nb_lane,pos", [
    (16, 4, 2, None, 6, [-1, 0, 3, 23, 14]),
    (64, 32, 4, None, 6, [-1, 0, 31, 191, 98]),
    (64, 16, 4, 21, 6, [-1, 0, 15, 95, 50]),
    (16, 8, 1, 3, 6, [-1, 0, 7, 47, 26]),
    # 384 rows in three splits of 128: live ranges ending on a split edge
    # (127), one row past it (128), straddling two (300), at the table's end
    (64, 32, 1, None, 12, [-1, 127, 128, 300, 383]),
    (64, 32, 2, None, 12, [383, 0, 255, 256, -1]),
    (256, 32, 1, None, 12, [127, 128, 300, 383, 0]),
    (256, 32, 2, None, 12, [255, -1, 129, 383, 64]),
    # windows starting mid-split (100 rows at 300: 201..300), and wholly
    # inside the last split (50 rows at 383: 334..383)
    (64, 32, 8, 100, 12, [300, 383, 150, -1, 99]),
    (256, 32, 4, 50, 12, [383, 340, 129, 10, -1]),
    (256, 32, 8, 100, 12, [300, 0, 383, 200, 127]),
    (64, 16, 4, 200, 12, [191, 100, 129, -1, 5]),
    # a group of 12 heads: two blocks of 8 heads per (lane, KV head)
    (64, 32, 12, None, 12, [383, 127, -1, 200, 5]),
    # every lane inactive
    (64, 32, 4, None, 12, [-1, -1, -1, -1, -1]),
    # the MoE slices' d 128 on 33 table entries (1056 rows): qwen2-moe's
    # MHA (G 1) and phi3.5-moe's G 4
    (128, 32, 1, None, 33, [-1, 0, 31, 700, 1023]),
    (128, 32, 4, None, 33, [1023, 300, -1, 64, 0]),
    # a rank of the 2x2 mesh on gemma3-12b's global layer: 4 lanes of its
    # data shard, d 256, G 2, 16 table entries (512 rows)
    (256, 32, 2, None, 16, [-1, 0, 300, 511]),
])
def test_paged_kernel_matches_plain_version(cuda, d, bs, G, window, nb_lane, pos, dtype):
    B, KV = len(pos), 2
    q, k, v, tbl = _paged_case(B, KV, G, d, bs, nb_lane, dtype, seed=d + bs, dev=cuda)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    got = tops.paged_attention(q, k, v, tbl, pos_t, window=window)
    want = tref.paged_attention_ref(q, k, v, tbl, pos_t, window=window)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == dtype and err <= tol * want.float().abs().max().item(), err
    for b, p in enumerate(pos):
        if p < 0:  # an inactive lane: exact zeros
            assert torch.equal(got[b], torch.zeros_like(got[b])), b
    # a fixed sum order: the same bits again
    assert torch.equal(got, tops.paged_attention(q, k, v, tbl, pos_t, window=window))


@pytest.mark.parametrize("d,bs,nb_lane,pos", [
    (64, 8, 6, [3, 17, -1, 40]),
    (256, 32, 12, [3, 200, -1, 383]),  # several splits, a lane in its last
])
def test_paged_kernel_never_reads_stale_entries_or_dead_rows(cuda, d, bs, nb_lane, pos):
    """Entries past a lane's last live block are scrambled and the blocks
    no lane reaches are NaN: the kernel's output keeps its bits."""
    B, KV, G = len(pos), 2, 4
    q, k, v, tbl = _paged_case(B, KV, G, d, bs, nb_lane, torch.bfloat16, seed=7, dev=cuda)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    base = tops.paged_attention(q, k, v, tbl, pos)
    live = {b: (int(pos[b]) // bs + 1 if pos[b] >= 0 else 0) for b in range(B)}
    used = {int(tbl[b, j]) for b in range(B) for j in range(live[b])}
    stale = tbl.clone()
    for b in range(B):
        stale[b, live[b]:] = (stale[b, live[b]:] + 5) % k.shape[0]
    dead = torch.tensor([i for i in range(k.shape[0]) if i not in used], device=cuda)
    k2, v2 = k.clone(), v.clone()
    k2[dead] = float("nan")
    v2[dead] = float("nan")
    assert torch.equal(base, tops.paged_attention(q, k2, v2, stale, pos))


def test_paged_launch_counter_and_wrapper_checks(cuda):
    q, k, v, tbl = _paged_case(2, 2, 2, 16, 4, 3, torch.float32, seed=0, dev=cuda)
    pos = torch.tensor([5, 2], dtype=torch.int32, device=cuda)
    tpaged.reset_launches()
    for _ in range(3):
        tops.paged_attention(q, k, v, tbl, pos)
    tref.paged_attention_ref(q, k, v, tbl, pos)
    assert tpaged.launches == 3
    with pytest.raises(TypeError, match="dtype"):
        tpaged.paged_attention_cuda(q.half(), k, v, tbl, pos)
    with pytest.raises(TypeError, match="int32"):
        tpaged.paged_attention_cuda(q, k, v, tbl.long(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        tpaged.paged_attention_cuda(q, k.transpose(0, 1).contiguous().transpose(0, 1), v,
                                    tbl, pos)
    assert tpaged.launches == 3


def test_continuous_paged_kernel_engine_on_card_matches_cpu(cuda):
    """Reduced granite-3-2b at f32, 6-bit packed, through the paged
    continuous engine: the same greedy tokens from the kernels on the card
    and the plain versions on the CPU, with lanes reused."""
    cfg = reduced_config("granite-3-2b")
    params = transformer.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                                     pack_bits=6)
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new=m) for i, (n, m) in enumerate(((5, 6), (11, 4), (3, 7), (9, 5)))]
    arrivals = [0, 0, 2, 3]
    out = {}
    tpaged.reset_launches()
    for dev in (cuda, torch.device("cpu")):
        eng = ServeEngine(tpack.tree_to(params, dev), cfg, max_len=32, device=dev,
                          continuous=True, n_slots=2, paged=True, block_size=4,
                          paged_kernel=True)
        res = eng.generate(reqs, arrival_steps=arrivals)
        out[dev.type] = {r.uid: r.tokens for r in res}
        assert eng.scheduler.pool.allocator.free_count == eng.scheduler.pool.n_blocks
    assert tpaged.launches == eng.scheduler.decode_steps * cfg.n_layers
    for uid in out["cpu"]:
        np.testing.assert_array_equal(out["cuda"][uid], out["cpu"][uid])


def test_policy_engines_on_card_match_cpu(cuda):
    """Reduced granite-3-2b at f32, 6-bit packed, through the paged-kernel
    engine with tiers and a forced degrade schedule, and with spec decode
    under overcommit: the same tokens, plane logs and counts on the card
    and on the CPU, and one runtime-plane launch per packed projection of
    every call that passed a plane count."""
    cfg = reduced_config("granite-3-2b")
    params = transformer.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                                     pack_bits=6)
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, 10).astype(np.int32),
                    max_new=11, tier="latency" if i == 0 else "throughput",
                    precision="economy" if i % 2 else "full") for i in range(3)]
    runs = {"tiers": dict(precision_tiers={"economy": 4}, degrade=True),
            "spec": dict(spec_decode=True, draft_planes=3, gamma=4)}
    for name, kw in runs.items():
        out = {}
        for dev in (cuda, torch.device("cpu")):
            eng = ServeEngine(tpack.tree_to(params, dev), cfg, max_len=32, device=dev,
                              continuous=True, n_slots=3, paged=True, block_size=4,
                              n_blocks=8, overcommit=2.0, paged_kernel=True, **kw)
            sched = eng.scheduler
            sched.force_shed = (lambda step: (step // 2) % 3) if name == "tiers" else None
            tkern.reset_launches()
            work = reqs if name == "tiers" else [
                Request(uid=r.uid, tokens=r.tokens, max_new=r.max_new, tier=r.tier)
                for r in reqs]
            res = {r.uid: r for r in eng.generate(work)}
            out[dev.type] = ({u: (r.tokens.tolist(), None if r.plane_log is None
                                  else r.plane_log.tolist()) for u, r in res.items()},
                             sched.preemptions_total(), sched.spec_accepted,
                             sched.spec_drafted, sched.degrade_events_total())
            assert eng.scheduler.pool.allocator.free_count == 8
            if dev.type == "cuda":
                # packed projections per model call (stacked leaves: one per layer)
                n_proj = sum(pw.planes.shape[0] if pw.planes.ndim == 4 else 1
                             for pw in tpack.packed_leaves(params))
                assert tkern.active_launches == n_proj * sched.plane_dispatches() > 0
        assert out["cuda"] == out["cpu"], name
        assert out["cpu"][1] > 0, f"{name}: never preempted"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(1, 1), (1, 33), (7, 1_000_003), (18, 65_536), (3, 262_147),
                                 (2, 8)])
def test_bgl_sumsq_kernel_matches_plain_version(cuda, R, C, dtype):
    """Ragged rows (unaligned 16-byte vectors at chunk starts), rows
    shorter than one vector, several chunks per row; a second call gives
    the same bits."""
    x = torch.randn((R, C), generator=torch.Generator(device=cuda).manual_seed(R + C),
                    device=cuda).to(dtype)
    got = tops.bgl_sumsq(x)
    want = tref.bgl_sumsq_ref(x)
    assert got.dtype == torch.float32 and got.shape == (R,)
    assert ((got - want).abs() / want).max().item() <= 1e-5
    assert torch.equal(got, tops.bgl_sumsq(x))


def test_bgl_sumsq_unaligned_view_and_launch_count(cuda):
    """A contiguous view that starts off a 16-byte boundary, the gradient
    through the autograd Function, and the checks that raise."""
    base = torch.randn(1 + 5 * 4099, device=cuda)
    x = base[1:].view(5, 4099)
    tbgl.reset_launches()
    got = tops.bgl_sumsq(x)
    assert ((got - tref.bgl_sumsq_ref(x)).abs() / got).max().item() <= 1e-5
    xg = x.detach().clone().requires_grad_(True)
    g = torch.randn(5, device=cuda)
    (gx,) = torch.autograd.grad(tops.bgl_sumsq(xg), xg, g)
    assert torch.equal(gx, xg.detach() * (2.0 * g)[:, None])
    assert (tbgl.launches, tbgl.backward_launches) == (2, 1)
    with pytest.raises(TypeError, match="dtype"):
        tbgl.bgl_sumsq_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        tbgl.bgl_sumsq_cuda(torch.randn(8, 6, device=cuda).t())
    assert (tbgl.launches, tbgl.backward_launches) == (2, 1)


def _bgl_group(dev, dtype, seed):
    """Ragged views, views that start off a 16-byte boundary (slices of one
    flat buffer), a 1-element row beside a 1e6-element row, several chunks
    per row, and an empty view."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn(1 + 5 * 4099 + 3 * 33, generator=gen, device=dev).to(dtype)
    xs = [torch.randn(s, generator=gen, device=dev).to(dtype)
          for s in ((1, 1), (1, 1_000_000), (9, 432), (7, 1_000_003), (18, 65_536),
                    (0, 8), (2, 8), (9, 36_864))]
    xs += [base[1:1 + 5 * 4099].view(5, 4099), base[1 + 5 * 4099:].view(3, 33)]
    return xs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bgl_grouped_kernel_matches_plain_and_is_bitwise_alone_and_again(cuda, dtype):
    """One launch for the group, within 1e-5 of each row's plain value;
    each view's sums the same bits alone as in the group; a second call
    the same bits."""
    xs = _bgl_group(cuda, dtype, 7)
    tbgl.reset_launches()
    got = tops.bgl_sumsq_grouped(xs)
    assert tbgl.launches == 1 and got.shape == (sum(x.shape[0] for x in xs),)
    want = tref.bgl_sumsq_grouped_ref(xs)
    assert ((got - want).abs() / want).max().item() <= 1e-5
    assert torch.equal(got, tops.bgl_sumsq_grouped(xs))
    alone = torch.cat([tops.bgl_sumsq(x) for x in xs])
    assert torch.equal(got, alone)
    assert tbgl.launches == 2 + len(xs) - 1  # the (0, 8) view alone launches nothing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bgl_grouped_backward_is_the_plain_bits_in_one_launch(cuda, dtype):
    """``x * (2 g)[:, None]`` (bf16: the f32 product rounded once) for
    every view that needs it, in one launch, from a strided and from an
    expanded (stride 0) gradient."""
    xs = [x.detach().requires_grad_(i % 3 != 2) for i, x in enumerate(_bgl_group(cuda, dtype, 8))]
    need = [x for x in xs if x.requires_grad]
    rows = sum(x.shape[0] for x in xs)
    for g in (torch.randn(2 * rows, device=cuda)[::2], torch.ones((), device=cuda).expand(rows)):
        tbgl.reset_launches()
        grads = torch.autograd.grad(tops.bgl_sumsq_grouped(xs), need, g)
        assert (tbgl.launches, tbgl.backward_launches) == (1, 1)
        gs = dict(zip(map(id, xs), torch.split(g, [x.shape[0] for x in xs])))
        for x, gx in zip(need, grads):
            assert gx.dtype == dtype and gx.shape == x.shape
            assert torch.equal(gx, (x.detach().float() * (2.0 * gs[id(x)])[:, None]).to(dtype))


def test_bgl_grouped_raises_and_splits_long_tables(cuda):
    """A mixed-dtype group, a CPU view and a strided view raise before any
    launch; a table longer than one launch's parameters takes one launch
    per MAX_SEGMENTS views, with the same sums as one view at a time."""
    a, b = torch.randn(4, 8, device=cuda), torch.randn(2, 8, device=cuda)
    tbgl.reset_launches()
    with pytest.raises(TypeError, match="one dtype"):
        tbgl.bgl_sumsq_grouped_cuda([a, b.bfloat16()])
    with pytest.raises(ValueError, match="CUDA"):
        tbgl.bgl_sumsq_grouped_cuda([a, b.cpu()])
    with pytest.raises(ValueError, match="contiguous"):
        tbgl.bgl_sumsq_grouped_cuda([a, torch.randn(8, 6, device=cuda).t()])
    assert tbgl.launches == 0
    gen = torch.Generator(device=cuda).manual_seed(3)
    xs = [torch.randn((1 + i % 9, 1 + 37 * i), generator=gen, device=cuda)
          for i in range(2 * tbgl.MAX_SEGMENTS + 8)]
    got = tops.bgl_sumsq_grouped(xs)
    assert tbgl.launches == 3
    assert torch.equal(got, torch.cat([tops.bgl_sumsq(x) for x in xs]))


def test_bsq_train_steps_on_card_match_cpu(cuda):
    """Reduced granite-3-2b, f32: two BSQ train steps from one state on
    the card (the kernel in every regulariser) and on the CPU (the plain
    version) give the same losses and regs within 1e-5 relative, and the
    masks after a requant are equal."""
    cfg = reduced_config("granite-3-2b")
    bsq_cfg = BSQConfig(n_init=8, alpha=5e-3, compute_dtype=torch.float32)
    opt = SGDM()
    state_cpu, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, bsq_cfg, opt, "cpu")
    state_gpu = tree_map(lambda x: x.clone() if x.ndim == 0 else x.to(cuda, copy=True),
                         state_cpu)
    step = make_bsq_train_step(ctx, opt, step_decay(0.2, [100]))
    task = MarkovLM(vocab=cfg.vocab_size, seed=13)
    batches = [task.batch(np.random.default_rng(i), 4, 16) for i in range(2)]
    tbgl.reset_launches()
    for b in batches:
        state_cpu, m_cpu = step(state_cpu, {k: torch.from_numpy(v).long() for k, v in b.items()})
        state_gpu, m_gpu = step(state_gpu, {k: torch.from_numpy(v).long().to(cuda)
                                            for k, v in b.items()})
        for k in ("ce", "reg", "total"):
            assert abs(m_gpu[k].item() - m_cpu[k].item()) <= 1e-5 * abs(m_cpu[k].item()), k
    # one grouped launch per regulariser evaluation, and one for its backward
    assert (tbgl.launches, tbgl.backward_launches) == (2, 2)
    rq = make_requant_step(ctx)
    masks_cpu, masks_gpu = rq(state_cpu)["masks"], rq(state_gpu)["masks"]
    for name in masks_cpu:
        assert torch.equal(masks_gpu[name].cpu(), masks_cpu[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,d,window,causal,G", [
    (8, 256, 64, None, True, 4),    # granite-3-2b's heads: d 64, GQA 4
    (4, 300, 256, 128, True, 2),    # gemma3-12b's: d 256, GQA 2, windowed, ragged
    (2, 77, 16, None, False, 1),    # non-causal, ragged, the reduced configs' d
    (3, 1000, 64, 100, True, 1),
    (2, 64, 8, 1, True, 1),         # window 1: each query sees itself
    # lengths that are no multiple of the 64-key tile, windows one key
    # either side of it, d 128, and the prefill shapes' S 4096
    (4, 1, 64, None, True, 2),
    (4, 63, 128, None, True, 4),
    (4, 65, 256, 17, True, 2),
    (2, 1000, 128, 63, True, 1),
    (2, 1000, 256, 65, True, 2),
    (2, 63, 256, 1, True, 1),
    (4, 1000, 128, None, False, 4),
    (2, 65, 64, 17, False, 2),
    (8, 4096, 64, 1024, True, 4),
    (2, 4096, 256, None, True, 2),
    # the MoE slices at d 128: one lane of qwen2-moe's 1024-token bucket
    # (16 heads, MHA) and of phi3.5-moe's 256 (32 query heads over 8)
    (16, 1024, 128, None, True, 1),
    (32, 256, 128, None, True, 4),
    # a rank of the 2x2 mesh: recurrentgemma-9b's windowed prefill over 2
    # lanes, 8 of the 16 query heads of its one K/V head; gemma3-12b's
    # local layers over 2 lanes x 4 of its 8 K/V heads
    (16, 256, 256, 2048, True, 8),
    (16, 256, 256, 1024, True, 2),
])
def test_flash_kernel_matches_plain_version(cuda, BH, S, d, window, causal, G, dtype):
    gen = torch.Generator(device=cuda).manual_seed(S + d)
    q = torch.randn((BH, S, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((BH // G, S, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((BH // G, S, d), generator=gen, device=cuda).to(dtype)
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol * want.float().abs().max().item()
    assert torch.equal(got, tops.flash_attention(q, k, v, causal=causal, window=window))


def test_flash_wrapper_checks_and_launch_counts(cuda):
    q = torch.randn((4, 64, 32), device=cuda)
    tflash.reset_launches()
    tops.flash_attention(q, q[:2].contiguous(), q[:2].contiguous())
    tops.flash_attention(q, q, q, window=8, sm_scale=0.5)
    assert (tflash.launches, tflash.windowed_launches) == (2, 1)
    with pytest.raises(ValueError, match="no backward"):
        tflash.flash_attention_cuda(q.clone().requires_grad_(True), q, q)
    with pytest.raises(TypeError, match="dtypes"):
        tflash.flash_attention_cuda(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="multiple of 8"):
        tflash.flash_attention_cuda(q[..., :12].contiguous(), q[..., :12].contiguous(),
                                    q[..., :12].contiguous())
    with pytest.raises(ValueError, match="divid"):
        tflash.flash_attention_cuda(q, q[:3].contiguous(), q[:3].contiguous())
    assert (tflash.launches, tflash.windowed_launches) == (2, 1)


def test_ring_engines_on_card_match_cpu(cuda):
    """Reduced gemma3-12b (window 16) at f32, 6-bit packed: the bucketed
    engine (prefill through the flash kernel, one launch per layer, the
    local ones windowed) and the paged-kernel continuous engine (rings
    beside paged global layers) give the CPU's greedy tokens, decoding
    past every ring's wrap."""
    cfg = reduced_config("gemma3-12b")
    params = transformer.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                                     pack_bits=6)
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new=cfg.window + 4) for i, n in enumerate((5, 23, 23, 9))]
    arrivals = [0, 0, 2, 3]
    kw = dict(continuous=True, n_slots=2, paged=True, block_size=8, paged_kernel=True)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tpack.tree_to(params, dev)
        tflash.reset_launches()
        bucketed = ServeEngine(p, cfg, max_len=64, device=dev).generate(reqs)
        if dev.type == "cuda":
            # three buckets (5, 23, 9 tokens): one prefill call each
            assert tflash.launches == 3 * cfg.n_layers
            assert tflash.windowed_launches == 3 * cfg.layer_pattern.count("local") * 2
        eng = ServeEngine(p, cfg, max_len=64, device=dev, **kw)
        out[dev.type] = ({r.uid: r.tokens for r in bucketed},
                         {r.uid: r.tokens for r in eng.generate(reqs, arrival_steps=arrivals)})
        assert eng.scheduler.pool.allocator.free_count == eng.scheduler.pool.n_blocks
    for uid in range(len(reqs)):
        for i in range(2):
            np.testing.assert_array_equal(out["cuda"][i][uid], out["cpu"][i][uid])
        np.testing.assert_array_equal(out["cuda"][0][uid], out["cuda"][1][uid])


@pytest.mark.parametrize("arch,pack_bits", [("mamba2-130m", None), ("recurrentgemma-9b", 6)])
def test_recurrent_engines_on_card_match_cpu(cuda, arch, pack_bits):
    """Reduced mamba2-130m (float: it has no packable weight) and reduced
    recurrentgemma-9b (6-bit packed, window 16) at f32: the bucketed
    engine and the chunked paged-kernel continuous engine give the CPU's
    greedy tokens, the RG-LRU model decoding past every ring's wrap; its
    prefill runs the flash kernel on its local layers (one windowed
    launch each per call), and neither model launches the paged kernel
    (rings and recurrent state bypass paging)."""
    cfg = reduced_config(arch)
    params = transformer.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                                     pack_bits=pack_bits)
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new=20) for i, n in enumerate((5, 23, 23, 9))]
    arrivals = [0, 0, 2, 3]
    kw = dict(continuous=True, n_slots=2, paged=True, block_size=8, paged_kernel=True)
    n_local = cfg.layer_pattern.count("local") * cfg.n_superblocks
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tpack.tree_to(params, dev)
        tflash.reset_launches()
        tpaged.reset_launches()
        bucketed = ServeEngine(p, cfg, max_len=64, device=dev).generate(reqs)
        eng = ServeEngine(p, cfg, max_len=64, device=dev, **kw)
        chunked = eng.generate(reqs, arrival_steps=arrivals)
        if dev.type == "cuda":
            # three buckets (5, 23, 9 tokens): one prefill call each
            assert tflash.launches == tflash.windowed_launches == 3 * n_local
            assert tpaged.launches == 0
        out[dev.type] = ({r.uid: r.tokens for r in bucketed}, {r.uid: r.tokens for r in chunked})
        assert eng.scheduler.pool.allocator.free_count == eng.scheduler.pool.n_blocks
    for uid in range(len(reqs)):
        for i in range(2):
            np.testing.assert_array_equal(out["cuda"][i][uid], out["cpu"][i][uid])
        np.testing.assert_array_equal(out["cuda"][0][uid], out["cuda"][1][uid])
