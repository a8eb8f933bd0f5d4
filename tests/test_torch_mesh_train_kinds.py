"""BSQ training of every other layer kind on a ("data", "model") mesh,
against the JAX package on one device and the port in one process, on
the CPU (reduced configs, f32, batch 4 x 16 tokens, 2 steps).

One module-scope 2x2 gloo group of CPU ranks (``launch.mesh.run_on_mesh``,
spawned once, from a thread while this process computes the references)
trains six reduced configurations, each rank on its blocks of the state
and of every batch:

* qwen2-moe-a2.7b: 2 of its 4 experts a "model" rank, their hidden
  width over "data", the shared expert a Megatron pair, the router
  stitched; the experts' (layer, expert) groups split over "model";
* recurrentgemma-9b: RG-LRU layers (their matrices stitched, the stacked
  gate biases as ``RowsBlock`` rows) and a "local" layer of one K/V head;
* gemma3-12b ("local" layers), mamba2-130m ("ssm"), llama-3.2-vision-11b
  ("attn+cross", fed ``cross_embeds``) and musicgen-large (``embeds``).

qwen2-moe and recurrentgemma are held to JAX's jitted single-device
``make_bsq_train_step`` from JAX's own BSQ state of the same draw
(bridged), the others to the port's step in one process: the losses of
both steps within 1e-5 relative, the gradients at the first step (each
rank's, gathered) within 1e-5 absolute plus 2e-4 relative, the gathered
state after the steps within 1e-4 of each leaf's largest |x| (its SGD
moments, sums of gradients, to the gradient bar); the masks
of a requant after them bit for bit one process's requant of the
gathered state.  Beside them one test per fault the mesh path had to be
cleared of (the form each leaf takes, the router
loss over the whole batch, the split groups' scales and masks, requant
and the regulariser over a split group axis), the init on a mesh, and a
2x2 checkpoint of the MoE state resumed on 4x1 (the same four processes
as a 4x1 mesh) against one process's 4 steps.
"""
import contextlib
import io
import threading

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core import BSQConfig
from repro_torch.data import MarkovLM, sharded_lm_iterator
from repro_torch.dist import elastic
from repro_torch.dist import sharding as ts
from repro_torch.launch.mesh import make_host_mesh, run_on_mesh
from repro_torch.models import transformer as ttf
from repro_torch.optim import SGDM, step_decay
from repro_torch.train import (TrainerConfig, init_bsq_state, make_bsq_train_step,
                               make_requant_step, train_bsq)
from repro_torch.train import step as st
from repro_torch.tree import flatten_with_path, tree_map, unflatten_like
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

MOE, RG = "qwen2-moe-a2.7b", "recurrentgemma-9b"
JAX_ARCHS = [MOE, RG]
ARCHS = JAX_ARCHS + ["gemma3-12b", "mamba2-130m", "llama-3.2-vision-11b", "musicgen-large"]
B, S, STEPS = 4, 16, 2
BSQ = BSQConfig(n_init=8, alpha=5e-3, compute_dtype=torch.float32)
LOSS_TOL = 1e-5  # relative
GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-4
STATE_TOL = 1e-4  # of each leaf's largest |x|
AUX_WEIGHT = 10.0  # the router loss weight of the aux test: 1000x the config's


def _lr():
    return step_decay(0.2, [STEPS])


def _seed(arch):
    return 40 + ARCHS.index(arch)


def _batches(cfg, n=STEPS):
    """Markov tokens (vocab 512), drawn from rng(i); ``embeds`` in place of
    tokens for the audio frontend, ``cross_embeds`` for the vision one."""
    task = MarkovLM(vocab=cfg.vocab_size, seed=13)
    out = []
    for i in range(n):
        rng = np.random.default_rng(i)
        b = {k: v.astype(np.int64) for k, v in task.batch(rng, B, S).items()}
        if cfg.frontend == "audio":
            b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
            del b["tokens"]
        if cfg.frontend == "vision":
            b["cross_embeds"] = rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _torch_batch(b, mesh=None):
    """The batch, this rank's rows of it on ``mesh``."""
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(v)
        if mesh is not None:
            t = ts.local_block(t, ts.data_batch_spec(mesh, v.shape[0], v.ndim), mesh)
        out[k] = t.contiguous()
    return out


def _np(tree):
    return {n: x.detach().cpu().numpy().copy() for n, x in flatten_with_path(tree)
            if isinstance(x, torch.Tensor)}


def _clone(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _ctx(cfg):
    return st.abstract_bsq_state(cfg, BSQ, SGDM())[1]


def _grads(state, ctx, batch, mesh=None):
    """(loss, metrics, gradient tree) of the BSQ objective at ``state``."""
    specs = {}
    if mesh is not None:
        specs = dict(ts.flatten_specs(elastic.train_state_specs(state, mesh, ctx.template)))
    return st.value_and_grad(
        lambda tr: st.bsq_loss(tr, state["masks"], batch, ctx, mesh, specs), state["trainable"])


# ---------------------------------------------------------------------------
# What every rank runs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _first_step_seen(seen):
    """Record into ``seen`` what the first loss evaluation inside the block
    computes: ``"grads"`` (a copy: the step clips them in place) and
    ``"placed"``, the type of every leaf the training forward read
    (``name -> type name``)."""
    orig_leaf, orig_grad = st._forward_leaf, st.value_and_grad
    placed = {}

    def leaf(name, x, spec, mesh):
        out = orig_leaf(name, x, spec, mesh)
        placed[name] = type(out).__name__
        return out

    def grad(fn, tree):
        out = orig_grad(fn, tree)
        if "grads" not in seen:
            seen["grads"], seen["placed"] = _clone(out[2]), dict(placed)
        return out

    st._forward_leaf, st.value_and_grad = leaf, grad
    try:
        yield
    finally:
        st._forward_leaf, st.value_and_grad = orig_leaf, orig_grad


@contextlib.contextmanager
def _near_ties(seen):
    """Count into ``seen`` the routing picks and their near-ties: a top-k
    margin under 100 f32 ulps of the largest gate, where another order of
    the stitched router sum could pick another expert."""
    from repro_torch.models import moe

    orig = moe._route
    seen.update(near=0, picks=0)

    def route(gates, top_k):
        srt = gates.detach().sort(-1, descending=True).values
        margin = srt[..., top_k - 1] - srt[..., top_k]
        seen["near"] += int((margin < 100 * torch.finfo(torch.float32).eps
                             * srt.abs().amax()).sum())
        seen["picks"] += margin.numel()
        return orig(gates, top_k)

    moe._route = route
    try:
        yield
    finally:
        moe._route = orig


def _steps(state, ctx, batches, mesh=None):
    """STEPS BSQ steps: (state, metrics per step, what the first step saw,
    the routing's near-ties among its picks)."""
    step = make_bsq_train_step(ctx, SGDM(), _lr(), mesh=mesh)
    seen, metrics = {}, []
    with _first_step_seen(seen), _near_ties(seen.setdefault("route", {})):
        for b in batches:
            state, mt = step(state, b)
            metrics.append({k: float(v) for k, v in mt.items()})
    return state, metrics, seen


def _arch_run(mesh, m):
    """Init on the mesh, STEPS steps (the first one's gradients recorded)
    and a requant, on this rank's blocks."""
    cfg, ctx = m["cfg"], _ctx(m["cfg"])
    out = {}
    on_mesh = init_bsq_state(torch.Generator().manual_seed(m["seed"]), cfg, BSQ, SGDM(), "cpu",
                             mesh=mesh)[0]
    cut = elastic.reshard_tree(init_bsq_state(torch.Generator().manual_seed(m["seed"]), cfg,
                                              BSQ, SGDM(), "cpu")[0], mesh)
    out["init_differ"] = [n for (n, a), (_, b) in zip(flatten_with_path(on_mesh),
                                                      flatten_with_path(cut))
                          if not torch.equal(a, b)]
    del on_mesh, cut
    state = elastic.reshard_tree(_clone(m["state"]), mesh)
    specs = elastic.train_state_specs(state, mesh, ctx.template)
    state, out["metrics"], seen = _steps(state, ctx, [_torch_batch(b, mesh)
                                                     for b in m["batches"]], mesh)
    out["placed"], out["grads_local"] = seen["placed"], _np(seen["grads"])
    out["route"] = seen["route"]
    out["grads"] = _np(elastic.gather_tree(seen["grads"], mesh, specs["trainable"]))
    out["state"] = _np(elastic.gather_tree(state, mesh, specs))
    state = make_requant_step(ctx, mesh)(state)
    out["requant"] = _np(elastic.gather_tree(state, mesh, specs))
    out["masks_local"] = _np(state["masks"])
    return out


def _aux_run(mesh, m):
    """qwen2-moe's gradients with the router loss weighted AUX_WEIGHT."""
    cfg = m["cfg"].scaled(router_aux_weight=AUX_WEIGHT)
    ctx = _ctx(cfg)
    state = elastic.reshard_tree(_clone(m["state"]), mesh)
    specs = elastic.train_state_specs(state, mesh, ctx.template)
    loss, metrics, grads = _grads(state, ctx, _torch_batch(m["batches"][0], mesh), mesh)
    return {"grads": _np(elastic.gather_tree(grads, mesh, specs["trainable"])),
            "share": float(loss), "metrics": {k: float(v) for k, v in metrics.items()}}


def _zeroed_experts(state, ctx):
    """The MoE state with layer 0's expert 0 of ``w_gate`` all zero and its
    expert 1 zero on the first half of its hidden width (data rank 0's
    block) only: requant must keep expert 1's planes and drop expert 0's,
    whose flat position on model rank 1 holds expert 2."""
    state = _clone(state)
    name = next(k for k in ctx.meta if k.endswith("/moe/w_gate"))
    rep = state["trainable"]["reps"][name]
    f = rep["wp"].shape[-1]
    for p in ("wp", "wn"):
        rep[p][:, 0, 0] = 0.0
        rep[p][:, 0, 1, :, :f // 2] = 0.0
    return state, name


def _requant_run(mesh, m):
    ctx = _ctx(m["cfg"])
    whole, _ = _zeroed_experts(m["state"], ctx)
    state = elastic.reshard_tree(whole, mesh)
    specs = elastic.train_state_specs(state, mesh, ctx.template)
    state = make_requant_step(ctx, mesh)(state)
    return {"whole": _np(elastic.gather_tree(state, mesh, specs)),
            "masks_local": _np(state["masks"])}


def _reg_run(mesh, m):
    """One regulariser evaluation on the MoE state: its value, this rank's
    plane and scale gradients, its grouped calls and collectives."""
    from repro_torch.kernels import ops

    ctx = _ctx(m["cfg"])
    state = elastic.reshard_tree(_clone(m["state"]), mesh)
    specs = dict(ts.flatten_specs(elastic.train_state_specs(state, mesh, ctx.template)))
    reps = st._reps_from_state(state["trainable"], state["masks"], ctx.meta)
    planes = [x for r in reps.values() for x in (r.wp, r.wn)]
    for x in planes:
        x.requires_grad_(True)
    calls, plain = [], ops.bgl_sumsq_grouped
    ops.bgl_sumsq_grouped = lambda xs: calls.append(len(xs)) or plain(xs)
    try:
        before = mesh.collectives
        reg = st._regularizer(reps, ctx, mesh, st._weight_specs(specs, reps))
        grads = torch.autograd.grad(reg, planes)
        collectives = mesh.collectives - before
    finally:
        ops.bgl_sumsq_grouped = plain
    names = [f"{k}/{p}" for k in reps for p in ("wp", "wn")]
    return {"reg": float(reg), "grads": {n: g.numpy() for n, g in zip(names, grads)},
            "calls": calls, "collectives": collectives}


def _resume_run(mesh, workdir):
    """train_bsq of the MoE state from its seed draw: 2 steps on the 2x2
    mesh (checkpoint at 2), then, on the same four processes as a 4x1
    mesh, resumed to step 4; gathered."""
    cfg = reduced_config(MOE)
    ctx = None
    for m, total, skip in ((mesh, 2, 0), (make_host_mesh(4, 1, device="cpu", backend="gloo"),
                                          4, 2)):
        state, ctx = init_bsq_state(torch.Generator().manual_seed(_seed(MOE)), cfg, BSQ,
                                    SGDM(), "cpu", mesh=m)
        data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), B, S, sharding=m)
        for _ in range(skip):
            next(data)
        tcfg = TrainerConfig(total_steps=total, requant_interval=100, ckpt_interval=2,
                             log_interval=1, workdir=workdir)
        with contextlib.redirect_stdout(io.StringIO()) as text:
            res = train_bsq(state, ctx, make_bsq_train_step(ctx, SGDM(), _lr(), mesh=m),
                            make_requant_step(ctx, m), data, tcfg, mesh=m)
    specs = elastic.train_state_specs(res["state"], m, ctx.template)
    return {"whole": _np(elastic.gather_tree(res["state"], m, specs)),
            "steps": [h["step"] for h in res["history"]], "text": text.getvalue()}


def _rank(mesh, models, workdir):
    # the states and params cross as numpy (a torch tensor crosses through a
    # shared-memory file of its own: seconds for a state's hundreds of leaves)
    models = {a: dict(m, **{k: tree_map(torch.from_numpy, m[k]) for k in ("state", "params")})
              for a, m in models.items()}
    out = {"coords": dict(mesh.coords)}
    for arch in ARCHS:
        out[arch] = _arch_run(mesh, models[arch])
    out["aux"] = _aux_run(mesh, models[MOE])
    out["requant"] = _requant_run(mesh, models[MOE])
    out["reg"] = _reg_run(mesh, models[MOE])
    out["resume"] = _resume_run(mesh, workdir)
    return out


# ---------------------------------------------------------------------------
# The references: JAX on one device, the port in one process
# ---------------------------------------------------------------------------


def _jax_state(arch, params):
    """JAX's BSQ state of ``params`` (numpy) and its context, as JAX's
    ``init_bsq_state`` builds it from its own draw."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config as j_reduced
    from repro.core import BSQConfig as JBSQConfig
    from repro.core import bsq as jbsq
    from repro.optim import SGDM as JSGDM
    from repro.train import step as jstep

    jb = JBSQConfig(n_init=8, alpha=5e-3, compute_dtype=jnp.float32)
    _, jctx = jstep.abstract_bsq_state(j_reduced(arch), jb, JSGDM())

    def init(p):
        qp, fp = jbsq.partition_params(p)
        reps = jbsq.init_bitreps(qp, jb)
        tr = {"reps": {k: {"wp": r.wp, "wn": r.wn, "scale": r.scale} for k, r in reps.items()},
              "float": fp}
        return {"trainable": tr, "masks": {k: r.mask for k, r in reps.items()},
                "opt": JSGDM().init(tr), "step": jnp.zeros((), jnp.int32)}

    return jax.tree.map(np.asarray, jax.jit(init)(jax.tree.map(jnp.asarray, params))), jctx


def _jax_ref(state, jctx, batches):
    """JAX's gradients at the first batch and its STEPS jitted steps."""
    import jax
    import jax.numpy as jnp

    from repro.optim import SGDM as JSGDM
    from repro.optim import step_decay as j_step_decay
    from repro.train import step as jstep

    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    js = jax.tree.map(jnp.asarray, state)
    (_, m), g = jax.jit(lambda tr, mk, b: jax.value_and_grad(jstep.bsq_loss, has_aux=True)(
        tr, mk, b, jctx))(js["trainable"], js["masks"], jb[0])
    step = jax.jit(jstep.make_bsq_train_step(jctx, JSGDM(), j_step_decay(0.2, [STEPS])))
    metrics = []
    for b in jb:
        js, mt = step(js, b)
        metrics.append({k: float(v) for k, v in mt.items()})
    return {"grads": dict(flatten_with_path(jax.tree.map(np.asarray, g))),
            "state": dict(flatten_with_path(jax.tree.map(np.asarray, js))),
            "metrics": metrics}


def _port_ref(m):
    """The port's STEPS steps in one process from the same whole state, the
    first one's gradients recorded."""
    state, metrics, seen = _steps(_clone(m["state"]), _ctx(m["cfg"]),
                                  [_torch_batch(b) for b in m["batches"]])
    return {"grads": _np(seen["grads"]), "state": _np(state), "metrics": metrics}


def _one_process_four_steps():
    cfg = reduced_config(MOE)
    state, ctx = init_bsq_state(torch.Generator().manual_seed(_seed(MOE)), cfg, BSQ, SGDM(),
                                "cpu")
    data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), B, S, device="cpu")
    step = make_bsq_train_step(ctx, SGDM(), _lr())
    for _ in range(4):
        state, _ = step(state, next(data))
    return _np(make_requant_step(ctx)(state))  # train_bsq's final requant


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The draws and whole states, then the 2x2 ranks (spawned from a
    thread) while this process computes the references."""
    models, jctx = {}, {}
    for arch in ARCHS:
        cfg = reduced_config(arch)
        params = tree_map(lambda t: t.numpy(), ttf.init_params(
            cfg, torch.Generator().manual_seed(_seed(arch)), "cpu"))
        m = {"cfg": cfg, "seed": _seed(arch), "batches": _batches(cfg),
             "params": bridge.from_numpy_tree(params)}
        if arch in JAX_ARCHS:
            jstate, jctx[arch] = _jax_state(arch, params)
            m["jstate"] = jstate
            m["state"] = bridge.bsq_state_from_jax(jstate, jctx[arch].meta)
        else:
            m["state"] = init_bsq_state(torch.Generator().manual_seed(_seed(arch)), cfg, BSQ,
                                        SGDM(), "cpu")[0]
        models[arch] = m
    workdir = str(tmp_path_factory.mktemp("mesh_train_kinds"))
    out = {}

    def spawn():
        try:
            sent = {a: {k: tree_map(lambda t: t.numpy(), v) if k in ("state", "params") else v
                        for k, v in m.items() if k != "jstate"} for a, m in models.items()}
            out["ranks"] = run_on_mesh(_rank, 2, 2, backend="gloo", device="cpu", threads=1,
                                       args=(sent, workdir))
        except BaseException as e:  # noqa: BLE001 - raised in the test's thread below
            out["error"] = e

    ranks_thread = threading.Thread(target=spawn)
    ranks_thread.start()
    ref = {}
    for arch in ARCHS:
        m = models[arch]
        if arch in JAX_ARCHS:
            ref[arch] = _jax_ref(m["jstate"], jctx[arch], m["batches"])
        else:
            ref[arch] = _port_ref(m)
    _, metrics, g = _grads(_clone(models[MOE]["state"]),
                           _ctx(models[MOE]["cfg"].scaled(router_aux_weight=AUX_WEIGHT)),
                           _torch_batch(models[MOE]["batches"][0]))
    ref["aux"] = {"grads": _np(g), "metrics": {k: float(v) for k, v in metrics.items()}}
    ref["four_steps"] = _one_process_four_steps()
    ranks_thread.join()
    if "error" in out:
        raise out["error"]
    return models, ref, out["ranks"], workdir


def _view(coords):
    from types import SimpleNamespace

    return SimpleNamespace(shape={"data": 2, "model": 2}, coords=coords)


def _port_state(flat, like):
    return unflatten_like(like, {n: torch.from_numpy(np.array(v)) for n, v in flat.items()})


# ---------------------------------------------------------------------------
# Against JAX (qwen2-moe, recurrentgemma) and one process (the others)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_match_the_single_device_reference(runs, arch):
    """ce, aux, reg and total of both steps, and the first step's gradient
    norm, within 1e-5 relative of JAX's (qwen2-moe, recurrentgemma) or of
    one process's; every rank's alike."""
    _, ref, ranks, _ = runs
    for r in ranks:
        for i, (got, want) in enumerate(zip(r[arch]["metrics"], ref[arch]["metrics"])):
            for k in ("ce", "aux", "reg", "total") + (("grad_norm",) if i == 0 else ()):
                w = want[k]
                assert abs(got[k] - w) <= LOSS_TOL * max(abs(w), 1e-30), \
                    (arch, r["coords"], i, k, got[k], w)
            assert got["lr"] == want["lr"]
    if arch == MOE:
        assert ranks[0][arch]["metrics"][0]["aux"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_single_device_reference(runs, arch):
    """Each rank's gradients of its blocks, gathered, against JAX's
    ``value_and_grad(bsq_loss)`` or one process's: every element within
    1e-5 absolute and 2e-4 relative."""
    _, ref, ranks, _ = runs
    want = ref[arch]["grads"]
    for r in ranks:
        got = r[arch]["grads"]
        assert sorted(got) == sorted(want)
        for name, g in got.items():
            np.testing.assert_allclose(g, np.asarray(want[name]), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{arch} {r['coords']} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_state_after_two_steps_matches(runs, arch):
    """Every leaf of the gathered state after the same two steps against
    JAX's or one process's: planes, scales, float params within 1e-4 of
    the leaf's largest |x|; the SGD moments, sums of the two steps'
    gradients, to the gradient bar (an expert scale's or the embedding
    scale's gradient sums some 1e5 times its size of terms that cancel:
    f32 sums in another order move it by 1e-6 absolute, 0.5 % of it)."""
    _, ref, ranks, _ = runs
    want = ref[arch]["state"]
    for r in ranks:
        got = r[arch]["state"]
        assert sorted(got) == sorted(want)
        for name, x in got.items():
            w = np.asarray(want[name])
            assert x.shape == w.shape, (arch, name)
            if name.startswith("opt/"):
                np.testing.assert_allclose(x, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=f"{arch} {r['coords']} {name}")
                continue
            tol = STATE_TOL * max(float(np.abs(w).max()) if w.size else 0.0, 1e-30)
            err = float(np.abs(x - w).max(initial=0.0))
            assert err <= tol, (arch, r["coords"], name, err, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_requant_masks_equal_one_process_and_are_whole_on_every_rank(runs, arch):
    """The mesh's requant after the two steps: planes and masks bit for bit
    one process's requant of the gathered state; every rank holds the same
    whole masks."""
    models, _, ranks, _ = runs
    ctx = _ctx(models[arch]["cfg"])
    state = make_requant_step(ctx)(_port_state(ranks[0][arch]["state"], models[arch]["state"]))
    want = _np(state)
    for r in ranks:
        for name, x in r[arch]["requant"].items():
            if name.startswith(("masks/", "trainable/reps/")):
                np.testing.assert_array_equal(x, want[name], err_msg=f"{arch} {name}")
        for name, x in r[arch]["masks_local"].items():
            np.testing.assert_array_equal(x, want[f"masks/{name}"], err_msg=f"{arch} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_on_the_mesh_is_the_block_of_the_whole_init(runs, arch):
    """``init_bsq_state(mesh=)``: each rank's planes decomposed on its block
    by its groups' scales, the scales and masks whole: every leaf equal to
    the rules' block of the one-process init."""
    _, _, ranks, _ = runs
    for r in ranks:
        assert r[arch]["init_differ"] == [], (arch, r["coords"])


# ---------------------------------------------------------------------------
# The faults the mesh path had to be cleared of, one test each
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_training_forward_places_each_leaf_as_serving_does(runs, arch):
    """One rule for what the forward stitches: the form in which the
    training forward reads each leaf (a FloatBlock for the router and the
    recurrent and cross matrices, a RowsBlock for the stacked RG-LRU gate
    biases, the plain block for the experts and the embedding) is the form
    the serving placement gives the same leaf."""
    models, _, ranks, _ = runs
    served = flatten_with_path(elastic.reshard_tree(models[arch]["params"], _view(
        ranks[0]["coords"])))
    want = {n: type(x).__name__ for n, x in served}
    got = ranks[0][arch]["placed"]
    assert sorted(got) == sorted(want)
    assert {n: t for n, t in got.items() if t != want[n]} == {}
    kinds = set(got.values())
    assert "FloatBlock" in kinds
    if arch == MOE:
        assert got["blocks/p0/moe/router"] == "FloatBlock"
        assert got["blocks/p0/moe/w_gate"] == "Tensor"
    if arch == RG:
        assert got["blocks/p0/mixer/b_rgate"] == "RowsBlock"
        assert got["blocks/p0/mixer/w_x"] == "FloatBlock"


def test_router_loss_is_the_whole_batch_and_counted_once(runs):
    """With the router loss weighted 10 (its gradient then dominates the
    router's), the mesh's gradients equal one process's, the aux metric is
    the whole batch's on every rank, and the data ranks' shares of the
    task loss (one model rank's) add up to one process's ce + weight *
    aux."""
    _, ref, ranks, _ = runs
    want = ref["aux"]
    for r in ranks:
        got = r["aux"]
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, want["grads"][name], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=name)
        assert abs(got["metrics"]["aux"] - ranks[0]["aux"]["metrics"]["aux"]) == 0.0
    one = ref["aux"]["metrics"]
    reg = ranks[0]["aux"]["metrics"]["reg"]
    shares = sum(r["aux"]["share"] - BSQ.alpha * reg for r in ranks if r["coords"]["model"] == 0)
    task = one["ce"] + AUX_WEIGHT * one["aux"]
    assert abs(shares - task) <= LOSS_TOL * abs(task), (shares, task)


def test_expert_scales_and_masks_are_whole_and_their_gradients_too(runs):
    """The experts' (layer, expert) groups split over "model": each rank
    holds the whole scales and masks, and its scale gradients are the whole
    gradients (each rank's experts' part summed over the mesh), equal to
    JAX's."""
    models, ref, ranks, _ = runs
    names = [n for n in ranks[0][MOE]["grads_local"] if n.endswith("/scale") and "/moe/" in n
             and "/shared/" not in n]
    assert names
    for r in ranks:
        for name in names:
            g = r[MOE]["grads_local"][name]
            w = np.asarray(ref[MOE]["grads"][name])
            assert g.shape == w.shape and g.shape[1] == models[MOE]["cfg"].n_experts
            np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
        for name, mask in r[MOE]["masks_local"].items():
            assert mask.shape == ranks[0][MOE]["requant"][f"masks/{name}"].shape


def test_requant_of_a_split_group_axis_equals_one_process(runs):
    """Expert 0 of layer 0 zero everywhere, expert 1 zero on one data rank's
    half only: the mesh's requant drops expert 0's planes (whose flat
    position on the other model rank holds a live expert) and keeps expert
    1's, as one process does; planes and masks bit for bit."""
    models, _, ranks, _ = runs
    ctx = _ctx(models[MOE]["cfg"])
    whole, name = _zeroed_experts(models[MOE]["state"], ctx)
    want = _np(make_requant_step(ctx)(whole))
    mask = want[f"masks/{name}"]
    assert not mask[:, 0, 0].any() and mask[:, 0, 1].any()
    for r in ranks:
        got = r["requant"]
        for n, x in got["whole"].items():
            if n.startswith(("masks/", "trainable/reps/")):
                np.testing.assert_array_equal(x, want[n], err_msg=n)
        for n, x in got["masks_local"].items():
            np.testing.assert_array_equal(x, want[f"masks/{n}"], err_msg=n)


def test_regulariser_over_a_split_group_axis_is_one_call_and_equals_one_process(runs):
    """Each rank: one bgl_sumsq_grouped call over its wp and wn blocks and
    one collective; the value and each rank's plane gradients within 1e-6
    relative of one process's."""
    from repro_torch.core import bsq as bsq_mod

    models, _, ranks, _ = runs
    ctx = _ctx(models[MOE]["cfg"])
    state = _clone(models[MOE]["state"])
    reps = st._reps_from_state(state["trainable"], state["masks"], ctx.meta)
    planes = [x for r in reps.values() for x in (r.wp, r.wn)]
    for x in planes:
        x.requires_grad_(True)
    reg = bsq_mod.regularizer(reps, ctx.bsq_cfg, ctx.total_quant_params)
    grads = dict(zip([f"{k}/{p}" for k in reps for p in ("wp", "wn")],
                     torch.autograd.grad(reg, planes)))
    reg = reg.item()
    specs = dict(ts.flatten_specs(elastic.train_state_specs(state, _view({}))))
    split = 0
    for r in ranks:
        got = r["reg"]
        assert got["calls"] == [2 * len(reps)] and got["collectives"] == 1
        assert abs(got["reg"] - reg) <= 1e-6 * abs(reg)
        view = _view(r["coords"])
        for name, g in got["grads"].items():
            spec = specs[f"trainable/reps/{name}"]
            want = ts.local_block(grads[name], spec, view).numpy()
            split += "/moe/w_" in name and "/shared/" not in name and spec[2] == "model"
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)
    assert split > 0


def test_moe_checkpoint_from_2x2_resumes_on_4x1(runs):
    """train_bsq's step-2 checkpoint of the MoE state written on 2x2 (whole
    tensors, masks whole) resumes on 4x1, where each rank holds every
    expert: 2 more steps equal one process's 4 within 1e-4 of each leaf's
    max |x|."""
    from repro_torch.ckpt import checkpoint as ckpt

    _, ref, ranks, workdir = runs
    assert ckpt.available_steps(workdir) == [2, 4]
    want = ref["four_steps"]
    for r in ranks:
        assert r["resume"]["steps"] == [3, 4]
        for name, x in r["resume"]["whole"].items():
            w = want[name]
            tol = STATE_TOL * max(float(np.abs(w).max()) if w.size else 0.0, 1e-30)
            assert float(np.abs(x - w).max(initial=0.0)) <= tol, name
    assert "[trainer] resumed from step 2" in ranks[0]["resume"]["text"]


@pytest.mark.parametrize("arch", [MOE, RG, "mamba2-130m"])
def test_scale_gradients_on_the_mesh_are_within_f32_rounding(runs, arch, monkeypatch):
    """A rep's scale gradient sums ``g_w * w / s`` over its group, terms that
    largely cancel, so f32 sums in another order move it more than any
    other leaf.  Against the float64 gradient (the same state in f64, one
    process) the mesh's is within 16 unit roundoffs of the sum of the
    terms' magnitudes per group (the mesh and one f32 process both come
    within about 2 of them)."""
    import dataclasses

    from repro_torch.configs import base
    from repro_torch.core import bsq as bsq_mod

    monkeypatch.setitem(base._DTYPES, "float64", torch.float64)  # the reference's sums
    models, _, ranks, _ = runs
    m = models[arch]
    batch = {k: torch.from_numpy(v) for k, v in m["batches"][0].items()}
    cfg = m["cfg"].scaled(dtype="float64")
    bsq64 = dataclasses.replace(BSQ, compute_dtype=torch.float64)
    ctx = dataclasses.replace(st.abstract_bsq_state(cfg, bsq64, SGDM())[1], cfg=cfg)
    state = tree_map(lambda x: x.double() if x.is_floating_point() else x, _clone(m["state"]))
    _, _, g = st.value_and_grad(lambda tr: st.bsq_loss(tr, state["masks"], batch, ctx),
                                state["trainable"])
    exact = _np(g)
    reps = st._reps_from_state(state["trainable"], state["masks"], ctx.meta)
    w = {k: v.detach().requires_grad_(True) for k, v in bsq_mod.reconstruct(reps, bsq64).items()}
    loss, _ = ttf.loss_fn(bsq_mod.merge_params(ctx.template, w, state["trainable"]["float"]),
                          batch, cfg)
    gw = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
    u = 2.0**-24
    for (k, wk), gk in zip(w.items(), gw):
        terms = torch.zeros_like(wk) if gk is None else (gk * wk / reps[k].scale).abs()
        red = tuple(i for i in range(wk.ndim) if i not in reps[k].group_axes)
        bound = 16 * u * (terms.sum(dim=red, keepdim=True) if red else terms).detach().numpy()
        name = f"reps/{k}/scale"
        for r in ranks:
            err = np.abs(r[arch]["grads"][name] - exact[name])
            assert (err <= bound + 1e-12).all(), (name, float(err.max()), float(bound.max()))

def test_routing_near_ties_on_the_mesh_are_reported(runs):
    """qwen2-moe's routing on the ranks: its picks counted and any near-tie
    reported (the losses and states above hold the mesh to JAX whatever
    the count, so a near-tie that routed otherwise would fail them)."""
    _, _, ranks, _ = runs
    for r in ranks:
        seen = r[MOE]["route"]
        assert seen["picks"] > 0
        print(f"rank {r['coords']}: {seen['near']} near-ties of {seen['picks']} routing picks")
    assert all(r[arch]["route"]["picks"] == 0 for r in ranks for arch in ARCHS if arch != MOE)


def test_refusals_naming_the_next_mesh_slice_still_raise():
    """What used to be refused now runs: no rule splits a param dim over
    two axes, on the 2x16x16 pod mesh or on 2x2, for every arch at full
    and reduced widths (the training forward's guard against one is never
    reached); a microbatched step builds on a mesh, its placement the
    rules' (the runs of it are in tests/test_torch_pod_mesh.py)."""
    from types import SimpleNamespace

    from repro_torch.configs import ARCH_IDS, get_config

    meshes = [SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16}),
              SimpleNamespace(shape={"data": 2, "model": 2})]
    for arch in ARCH_IDS:
        for cfg in (get_config(arch), reduced_config(arch)):
            params = ttf.init_params(cfg, torch.Generator(), "meta")
            for mesh in meshes:
                for name, spec in ts.flatten_specs(ts.tree_param_specs(params, mesh)):
                    assert not any(isinstance(ax, tuple) for ax in spec), (arch, name, spec)
                    assert "pod" not in ts.spec_axes(spec), (arch, name, spec)
    with pytest.raises(NotImplementedError, match="split over several axes"):
        st._forward_leaf("blocks/p0/mlp/w_up", torch.zeros(2, 4, 4),
                         (None, ("data", "model"), None), None)
    ctx = _ctx(reduced_config(MOE))
    mesh = SimpleNamespace(size=lambda: 4, shape={"data": 2, "model": 2})
    for hoist in (True, False):
        assert callable(make_bsq_train_step(ctx, SGDM(), _lr(), microbatches=2, mesh=mesh,
                                            hoist_reconstruct=hoist))


def test_the_iterator_cuts_frontend_inputs_over_data():
    """``sharded_lm_iterator`` keeps a float input float (``embeds``,
    ``cross_embeds``) and cuts it over the data axis as it cuts tokens."""
    from types import SimpleNamespace

    class Task:
        def batch(self, rng, b, s):
            return {"tokens": rng.integers(0, 9, (b, s)), "labels": rng.integers(0, 9, (b, s)),
                    "embeds": rng.standard_normal((b, s, 3)).astype(np.float32),
                    "cross_embeds": rng.standard_normal((b, 5, 3)).astype(np.float32)}

    whole = next(sharded_lm_iterator(Task(), 4, 6, device="cpu"))
    for i in range(2):
        mesh = SimpleNamespace(shape={"data": 2, "model": 2}, coords={"data": i, "model": 1},
                               device="cpu")
        got = next(sharded_lm_iterator(Task(), 4, 6, sharding=mesh))
        for k, t in got.items():
            assert t.dtype == whole[k].dtype
            assert torch.equal(t, whole[k][2 * i:2 * i + 2]), k
    assert whole["embeds"].dtype == torch.float32 and whole["tokens"].dtype == torch.int64


def test_a_two_by_two_rank_group_spawns_once_for_every_model(runs):
    """Every model ran on all four ranks, each at its own coordinates."""
    _, _, ranks, _ = runs
    assert sorted((r["coords"]["data"], r["coords"]["model"]) for r in ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(arch in r for r in ranks for arch in ARCHS)
