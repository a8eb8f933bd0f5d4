"""The port's modality frontends (``models/frontends.py``), its
cross-attention sublayer (``attention.cross_attention``) and the two
configurations they serve, against the JAX package, on the CPU, at f32
(params drawn as numpy arrays and carried to both packages, inputs from
numpy with a seed):

* ``cross_attention`` with float and 4-bit packed weights, one and two
  K/V heads, S != T; in bf16; at a runtime plane count against JAX under
  ``active_plane_count``;
* reduced llama-3.2-vision-11b (10 layers: 2 x (attn x 4, attn+cross), 8
  cross tokens) and reduced musicgen-large (``embeds`` in place of
  tokens), float and 4-bit packed: ``forward`` with and without
  ``cross_embeds`` (and musicgen's tokens path), ``loss_fn`` and its
  gradients, ``prefill`` plus ``decode_step`` at scalar and per-slot
  positions, ``prefill_chunk`` plus paged ``decode_step(block_table=)``,
  each within 5e-4 of JAX's forward as ``tests/test_decode.py`` holds
  JAX's own; the bucketed and continuous paged engines against JAX's
  bucketed engine (greedy tokens; the engines take no frontend inputs and
  skip the cross sublayers, as JAX's do); spec decode refused;
* ``bridge`` loading JAX's own float and packed llama-vision trees, the
  cross leaves byte for byte;
* the configs: ``SHAPES``, ``shape_applicable`` and the keys, shapes and
  dtypes of ``frontends.batch_specs`` and ``synthetic_batch`` for every
  arch (``tests/test_models.py::test_long_500k_applicability_matrix``).

Tolerances as ``tests/test_torch_rglru.py``: functions 1e-5 absolute plus
1e-4 relative, models 2e-4, tokens exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.packing import pack_from_float as j_pack_from_float
from repro.core.packing import pack_model_params as j_pack_model_params
from repro.models import attention as jattn
from repro.models import frontends as jfrontends
from repro.models import transformer as jtf
from repro.models.common import active_plane_count
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge, configs
from repro_torch.core.packing import PackedWeight, pack_model_params
from repro_torch.models import attention as tattn
from repro_torch.models import frontends
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.scheduler import SchedulerPolicy
from repro_torch.tree import flatten_with_path, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

VISION, AUDIO = "llama-3.2-vision-11b", "musicgen-large"
TOL = (1e-5, 1e-4)
MODEL_TOL = (2e-4, 2e-4)
DECODE_TOL = 5e-4  # tests/test_decode.py: serving paths against the forward
B, S, EXTRA = 2, 8, 6
MAX_LEN = 32


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.array(want, np.float32), atol=tol[0], rtol=tol[1])


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# cross_attention
# ---------------------------------------------------------------------------

D, H, HD = 64, 4, 16


def _cross_params(n_kv, kind, seed):
    """An attention block's four projections, float or packed to 4 bits
    by JAX (each leaf on its own, as ``pack_model_params`` would pack the
    wider ones), for both packages."""
    rng = np.random.default_rng(seed)
    p = {"wq": _normal(rng, (D, H * HD), D**-0.5), "wk": _normal(rng, (D, n_kv * HD), D**-0.5),
         "wv": _normal(rng, (D, n_kv * HD), D**-0.5), "wo": _normal(rng, (H * HD, D), D**-0.5)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if kind == "packed":
        jp = {k: j_pack_from_float(v, 4) for k, v in jp.items()}
    return jp, bridge.from_numpy_tree(jp)


@pytest.mark.parametrize("kind", ["float", "packed"])
@pytest.mark.parametrize("n_kv", [1, 2])
def test_cross_attention_matches_jax(kind, n_kv):
    jp, tp = _cross_params(n_kv, kind, seed=n_kv)
    rng = np.random.default_rng(10 + n_kv)
    x, src = _normal(rng, (2, 5, D)), _normal(rng, (2, 7, D))
    kw = dict(n_heads=H, n_kv=n_kv, head_dim=HD)
    want = jax.jit(functools.partial(jattn.cross_attention, **kw))(jp, jnp.asarray(x),
                                                                     jnp.asarray(src))
    got = tattn.cross_attention(tp, _t(x), _t(src), **kw)
    assert got.shape == (2, 5, D)
    _close(got, want)


def test_cross_attention_bf16_matches_jax():
    jp, tp = _cross_params(2, "float", seed=3)
    rng = np.random.default_rng(13)
    x, src = _normal(rng, (2, 6, D)), _normal(rng, (2, 9, D))
    kw = dict(n_heads=H, n_kv=2, head_dim=HD)
    want = np.array(jax.jit(functools.partial(jattn.cross_attention, **kw))(
        jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(src, jnp.bfloat16)), np.float32)
    got = tattn.cross_attention(tp, _t(x).bfloat16(), _t(src).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("a", [1, 3])
def test_cross_attention_active_planes_match_jax(a):
    """The runtime plane count reaches all four projections: JAX's under
    ``active_plane_count(a)``, the port's through ``active_planes=a``."""
    jp, tp = _cross_params(2, "packed", seed=4)
    rng = np.random.default_rng(14)
    x, src = _normal(rng, (2, 3, D)), _normal(rng, (2, 8, D))
    kw = dict(n_heads=H, n_kv=2, head_dim=HD)
    with active_plane_count(jnp.int32(a)):
        want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(src), **kw)
    got = tattn.cross_attention(tp, _t(x), _t(src), active_planes=torch.tensor([a]), **kw)
    _close(got, want)
    full = tattn.cross_attention(tp, _t(x), _t(src), **kw)
    assert not torch.equal(got, full)


# ---------------------------------------------------------------------------
# Reduced llama-3.2-vision-11b and musicgen-large
# ---------------------------------------------------------------------------

_MODELS = {}


@pytest.fixture(scope="module")
def models():
    """Per arch: both configs and the float and 4-bit packed trees (drawn
    with the port's ``init_params`` as numpy; JAX packs its copy and the
    port loads JAX's packed tree through the bridge)."""
    def get(arch):
        if arch not in _MODELS:
            jcfg, cfg = jconfigs.reduced_config(arch), configs.reduced_config(arch)
            params = tree_map(lambda t: t.numpy(),
                              ttf.init_params(cfg, torch.Generator().manual_seed(1), "cpu"))
            jp = jax.tree.map(jnp.asarray, params)
            jpacked = jax.jit(functools.partial(j_pack_model_params, n_bits=4))(jp)
            _MODELS[arch] = {"jcfg": jcfg, "cfg": cfg,
                             "float": (jp, bridge.from_numpy_tree(params)),
                             "packed": (jpacked, bridge.from_numpy_tree(jpacked))}
        return _MODELS[arch]
    return get


def _batch(arch, cfg, seed=5, n=S + EXTRA):
    """Numpy inputs of JAX's ``synthetic_batch`` keys: tokens, or musicgen's
    embeds; llama-vision's cross embeds."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio":
        out["embeds"] = _normal(rng, (B, n, cfg.d_model))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    if cfg.frontend == "vision":
        out["cross_embeds"] = _normal(rng, (B, cfg.frontend_tokens, cfg.d_model))
    return out


def _to_port(batch):
    return {k: _t(v).long() if v.dtype == np.int32 else _t(v) for k, v in batch.items()}


_JAX_LOGITS = {}


def _jax_forward(m, kind, batch, key):
    if key not in _JAX_LOGITS:
        jl, _ = jax.jit(functools.partial(jtf.forward, cfg=m["jcfg"]))(
            m[kind][0], {k: jnp.asarray(v) for k, v in batch.items()})
        _JAX_LOGITS[key] = np.array(jl)
    return _JAX_LOGITS[key]


FORWARD_CASES = [(VISION, "float", True), (VISION, "packed", True), (VISION, "float", False),
                 (VISION, "packed", False), (AUDIO, "float", True), (AUDIO, "packed", True)]


@pytest.mark.parametrize("arch,kind,frontend", FORWARD_CASES)
def test_forward_matches_jax(models, arch, kind, frontend):
    """llama-vision with and without ``cross_embeds`` (without them the
    cross sublayers are skipped, as JAX does); musicgen on ``embeds``."""
    m = models(arch)
    batch = _batch(arch, m["cfg"])
    if not frontend:
        batch.pop("cross_embeds")
    want = _jax_forward(m, kind, batch, (arch, kind, frontend))
    with torch.no_grad():
        got, _ = ttf.forward(m[kind][1], _to_port(batch), m["cfg"])
    _close(got, want, MODEL_TOL)
    if arch == VISION and frontend:  # the cross sublayers change the logits
        assert np.abs(want - _jax_forward(m, kind, {"tokens": batch["tokens"]},
                                          (arch, kind, False))).max() > 1e-3


def test_musicgen_tokens_path_matches_jax(models):
    """musicgen served by the engines runs on tokens through its
    embedding table, scaled by sqrt(d_model) as every token path is."""
    m = models(AUDIO)
    toks = np.random.default_rng(6).integers(0, 512, (B, S + EXTRA)).astype(np.int32)
    want = _jax_forward(m, "float", {"tokens": toks}, (AUDIO, "float", "tokens"))
    with torch.no_grad():
        got, _ = ttf.forward(m["float"][1], {"tokens": _t(toks).long()}, m["cfg"])
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_loss_and_gradients_match_jax(models, arch):
    m = models(arch)
    jcfg, cfg = m["jcfg"], m["cfg"]
    batch = _batch(arch, cfg, seed=7, n=11)
    batch["labels"] = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, 11)).astype(
        np.int32)
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        functools.partial(jtf.loss_fn, cfg=jcfg), has_aux=True))(
        m["float"][0], {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree_map(lambda t: t.clone().requires_grad_(), m["float"][1])
    loss, _ = ttf.loss_fn(tp, _to_port(batch), cfg)
    loss.backward()
    _close(loss, jloss, MODEL_TOL)
    jflat = dict(flatten_with_path(jgrad))
    names = set()
    for name, t in flatten_with_path(tp):
        if t.grad is None:  # musicgen's embeds path never reads the embedding
            assert (arch, name) == (AUDIO, "embed") and not np.array(jflat[name]).any()
            continue
        assert torch.isfinite(t.grad).all(), name
        _close(t.grad, jflat[name], MODEL_TOL)
        names.add(name)
    if arch == VISION:  # the cross sublayer's leaves have gradients too
        assert {f"blocks/p4/cross/{w}" for w in ("wq", "wk", "wv", "wo")} <= names


def _next_input(batch, t):
    """Decode step ``t``'s input: the next token (B, 1), or musicgen's next
    frame embedding (B, 1, D)."""
    src = batch["embeds"] if "embeds" in batch else batch["tokens"]
    x = _t(src[:, S + t:S + t + 1])
    return x.long() if x.dtype == torch.int32 else x


@pytest.mark.parametrize("arch", [VISION, AUDIO])
@pytest.mark.parametrize("kind", ["float", "packed"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_prefill_and_decode_match_jax_forward(models, arch, kind, per_slot):
    """Prefill of the first S positions, then EXTRA decode steps fed the
    following tokens (musicgen: embeds) and the cross embeds, at a scalar
    position or a (B,) tensor of per-slot positions."""
    m = models(arch)
    cfg = m["cfg"]
    batch = _batch(arch, cfg)
    want = _jax_forward(m, kind, batch, (arch, kind, True))
    pre = {k: (v[:, :S] if k != "cross_embeds" else v) for k, v in batch.items()}
    cross = _t(batch["cross_embeds"]) if "cross_embeds" in batch else None
    with torch.no_grad():
        lg, cache = ttf.prefill(m[kind][1], _to_port(pre), cfg, MAX_LEN)
        errs = [np.abs(lg.numpy() - want[:, S - 1]).max()]
        for t in range(EXTRA):
            pos = torch.full((B,), S + t, dtype=torch.int32) if per_slot else S + t
            lg, cache = ttf.decode_step(m[kind][1], cache, _next_input(batch, t), pos, cfg,
                                        cross_embeds=cross)
            errs.append(np.abs(lg.numpy() - want[:, S + t]).max())
    assert max(errs) < DECODE_TOL, errs


@pytest.mark.parametrize("arch", [VISION, AUDIO])
@pytest.mark.parametrize("kind", ["float", "packed"])
def test_prefill_chunk_and_paged_decode_match_jax_forward(models, arch, kind):
    """Chunked prefill (chunks of 5 and 3 into a paged pool; lane 1 with
    2 pads behind its second chunk) and paged decode with the kernel's
    plain version, both with the cross embeds.  The chunk's input is
    tokens, as in JAX, so musicgen runs its tokens path here."""
    m = models(arch)
    cfg, tp = m["cfg"], m[kind][1]
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "vision":
        batch["cross_embeds"] = _normal(rng, (B, cfg.frontend_tokens, cfg.d_model))
    want = _jax_forward(m, kind, batch, (arch, kind, "chunk"))
    cross = _t(batch["cross_embeds"]) if "cross_embeds" in batch else None
    bs, nb = 4, 16
    cache = ttf.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu", paged_blocks=nb, block_size=bs)
    table = torch.tensor([[0, 2, 4, 6, 8, 10, 12, 14], [15, 13, 11, 9, 7, 5, 3, 1]],
                         dtype=torch.int32)
    lens = [S, S - 2]  # lane 1's prompt is 2 tokens shorter
    with torch.no_grad():
        start = 0
        for C in (5, 3):
            nv = torch.tensor([max(0, min(C, n - start)) for n in lens], dtype=torch.int32)
            lg, _ = ttf.prefill_chunk(tp, cache, _t(toks[:, start:start + C]).long(),
                                      torch.full((B,), start, dtype=torch.int32), nv, cfg,
                                      block_table=table, cross_embeds=cross)
            start += C
        errs = [np.abs(lg[0].numpy() - want[0, S - 1]).max(),
                np.abs(lg[1].numpy() - want[1, S - 3]).max()]
        pos = torch.tensor(lens, dtype=torch.int32)
        for t in range(EXTRA):
            nxt = torch.from_numpy(toks[np.arange(B), pos.numpy()][:, None]).long()
            lg, _ = ttf.decode_step(tp, cache, nxt, pos, cfg, block_table=table,
                                    paged_kernel=True, cross_embeds=cross)
            errs += [np.abs(lg[b].numpy() - want[b, int(pos[b])]).max() for b in range(B)]
            pos = pos + 1
    assert max(errs) < DECODE_TOL, errs


def _requests(cls, cfg):
    rng = np.random.default_rng(7)
    return [cls(uid=i, tokens=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                max_new=6) for i, n in enumerate((5, 9, 9, 5))]


_ORACLE = {}


@pytest.mark.parametrize("arch", [VISION, AUDIO])
@pytest.mark.parametrize("mode", ["bucketed", "paged"])
def test_engines_match_the_jax_bucketed_oracle(models, arch, mode):
    """The engines serve tokens and skip the cross sublayers, as JAX's
    engine does: greedy tokens equal to JAX's bucketed engine, the pool
    drained."""
    m = models(arch)
    cfg, tp = m["cfg"], m["float"][1]
    if arch not in _ORACLE:
        _ORACLE[arch] = {r.uid: r.tokens for r in JServeEngine(
            m["float"][0], m["jcfg"], max_len=MAX_LEN).generate(_requests(JRequest, m["jcfg"]))}
    if mode == "bucketed":
        eng = ServeEngine(tp, cfg, max_len=MAX_LEN, device="cpu")
    else:
        eng = ServeEngine(tp, cfg, max_len=MAX_LEN, device="cpu", continuous=True,
                          policy=SchedulerPolicy(n_slots=2, chunked_prefill=True,
                                                 chunk_sizes=(4, 1), paged=True, block_size=4,
                                                 paged_kernel=True))
    out = eng.generate(_requests(Request, cfg), arrival_steps=[0, 1, 2, 3])
    assert sorted(r.uid for r in out) == [0, 1, 2, 3]
    for r in out:
        np.testing.assert_array_equal(r.tokens, _ORACLE[arch][r.uid],
                                      err_msg=f"{arch} {mode} uid {r.uid}")
    if eng.scheduler is not None:
        pool = eng.scheduler.pool
        assert pool.allocator.free_count == pool.n_blocks and eng.obs.recorder.leaked == []
        assert pool.ring_bytes() == 0


def test_spec_decode_is_refused_for_the_vision_pattern():
    cfg = configs.reduced_config(VISION)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu", pack_bits=4)
    with pytest.raises(ValueError, match="attention-only layer pattern"):
        ServeEngine(params, cfg, max_len=32, device="cpu", continuous=True, paged=True,
                    spec_decode=True)


def test_ring_bytes_counts_cross_local_rings():
    """A "local+cross" pattern keeps its rings: ``ring_bytes`` compares
    the base kind."""
    from repro_torch.serve.slots import SlotPool

    cfg = configs.reduced_config("gemma3-12b")
    cfg = cfg.scaled(layer_pattern=tuple(k + "+cross" if k == "local" else k
                                         for k in cfg.layer_pattern))
    pool = SlotPool(cfg, 2, 64, device="cpu")
    plain = SlotPool(configs.reduced_config("gemma3-12b"), 2, 64, device="cpu")
    assert pool.ring_bytes() == plain.ring_bytes() > 0


def test_bridge_carries_jax_vision_trees(models):
    """JAX's own draw of the reduced llama-vision tree, float and packed,
    loads through the bridge byte for byte; the port's packing of the
    loaded float tree equals JAX's packed tree, the cross sublayer's wq
    and wo packed (its 64 x 32 wk and wv are too narrow), as JAX's
    ``packable`` says."""
    jcfg = jconfigs.reduced_config(VISION)
    jp = jax.jit(functools.partial(jtf.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    jpacked = jax.jit(functools.partial(j_pack_model_params, n_bits=4))(jp)
    ours = flatten_with_path(pack_model_params(bridge.from_numpy_tree(jp), 4))
    theirs = flatten_with_path(bridge.from_numpy_tree(jpacked))
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    cross = {}
    for (name, a), (_, b) in zip(ours, theirs):
        assert type(a) is type(b), name
        if isinstance(b, PackedWeight):
            for f in ("planes", "sign", "scale"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
        else:
            assert torch.equal(a, b), name
        if "/cross/" in name:
            cross[name.rsplit("/", 1)[-1]] = b
    assert set(cross) == {"wq", "wk", "wv", "wo"}
    assert isinstance(cross["wq"], PackedWeight) and isinstance(cross["wo"], PackedWeight)
    for tree in (jp, jpacked):
        loaded = bridge.from_numpy_tree(tree)["blocks"]["p4"]["cross"]
        for w, leaf in tree["blocks"]["p4"]["cross"].items():
            if isinstance(loaded[w], PackedWeight):
                for f in ("planes", "sign", "scale"):
                    assert getattr(loaded[w], f).numpy().tobytes() == \
                        np.array(getattr(leaf, f)).tobytes(), (w, f)
            else:
                assert loaded[w].numpy().tobytes() == np.array(leaf).tobytes(), w


# ---------------------------------------------------------------------------
# Configs: SHAPES, shape_applicable, batch_specs, synthetic_batch
# ---------------------------------------------------------------------------


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


def test_shapes_match_jax():
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in configs.SHAPES.items():
        j = jconfigs.SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shape_applicable_and_batch_specs_match_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        assert configs.shape_applicable(arch, name) == jconfigs.shape_applicable(arch, name)
        for gb in (None, 3):
            ours = frontends.batch_specs(cfg, shape, global_batch=gb)
            theirs = jfrontends.batch_specs(jcfg, jconfigs.SHAPES[name], global_batch=gb)
            assert list(ours) == list(theirs), (arch, name)
            for k, spec in ours.items():
                assert spec.device.type == "meta"
                assert tuple(spec.shape) == tuple(theirs[k].shape), (arch, name, k)
                assert _dtype_name(spec.dtype) == _dtype_name(theirs[k].dtype), (arch, name, k)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_synthetic_batch_matches_jax_keys_shapes_and_dtypes(arch):
    cfg, jcfg = configs.reduced_config(arch), jconfigs.reduced_config(arch)
    for labels in (True, False):
        ours = frontends.synthetic_batch(cfg, 2, 5, torch.Generator().manual_seed(0), "cpu",
                                         with_labels=labels)
        theirs = jfrontends.synthetic_batch(jcfg, 2, 5, with_labels=labels)
        assert list(ours) == list(theirs)
        for k, t in ours.items():
            assert tuple(t.shape) == tuple(theirs[k].shape), (arch, k)
            assert _dtype_name(t.dtype) == _dtype_name(theirs[k].dtype), (arch, k)
            if t.dtype == torch.int32:
                assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab_size
    again = frontends.synthetic_batch(cfg, 2, 5, torch.Generator().manual_seed(0), "cpu")
    first = frontends.synthetic_batch(cfg, 2, 5, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(again[k], first[k]) for k in first)
