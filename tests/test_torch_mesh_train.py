"""The port's training on a ("data", "model") mesh against the JAX package
on one device, on the CPU (reduced granite-3-2b, f32, batch 4, seq 16).

The JAX references run in this process on one CPU device: JAX's jitted
BSQ and plain steps, and its compressed data-parallel steps and
``compressed_psum_ef`` with ``shard_map`` composed by ``jax.vmap`` over a
named axis (each shard a row of the vmapped batch, ``pmax``/``psum``
under the axis name).  The port runs on gloo process groups
(``launch.mesh.run_on_mesh``), one spawned group per mesh shape (2x2,
2x1, 4x1, each spawned once in a module fixture, running every check of
its shape); the tests read the results.  JAX is imported inside the
fixtures only, so the spawned ranks import torch and the port alone.

Tolerances: states within 1e-5 absolute and ce, reg, total and
grad_norm within 1e-5 relative of JAX's (the bars of
``test_torch_train.py``: f32 sums in another order, here over ranks
too); the compressed steps' per-rank gradients against JAX's per-shard
ones within 1e-5 absolute and GRAD_TOL relative; the
regulariser within 1e-6 relative of one process; int8 codes,
residuals, masks, replicated leaves and checkpoint leaves bit for bit;
the compressed mean within one f32 ulp.
"""
import contextlib
import dataclasses
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import reduced_config
from repro_torch.core import BSQConfig
from repro_torch.data import MarkovLM, sharded_lm_iterator
from repro_torch.dist import elastic
from repro_torch.dist import sharding as ts
from repro_torch.dist.collectives import compressed_psum_ef, init_residuals, quantize_int8
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.optim import SGDM, step_decay
from repro_torch.train import (TrainerConfig, init_bsq_state, make_bsq_train_step,
                               make_compressed_bsq_dp_step, make_compressed_dp_step,
                               make_plain_train_step, make_requant_step, train_bsq)
from repro_torch.tree import flatten_with_path, unflatten_like
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "granite-3-2b"
STEPS = 3
B, S = 4, 16
BSQ = BSQConfig(n_init=8, alpha=5e-3, compute_dtype=torch.float32)
# a gradient element against JAX's, relative (beside 1e-5 absolute): the
# gradient bar of test_torch_remat.py (f32 sums in another order; an
# embedding element of 0.5 after two unclipped compressed steps lies
# 1.4e-5 off)
GRAD_TOL = 2e-4


def _batches(n, B=B, S=S):
    """test_torch_train.py's batches: MarkovLM rows drawn from rng(i)."""
    task = MarkovLM(vocab=512, seed=13)
    return [task.batch(np.random.default_rng(i), B, S) for i in range(n)]


def _lr():
    return step_decay(0.2, [2])


def _np(tree):
    """name -> a numpy copy (the steps update the state's tensors in place)."""
    return {n: x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)
            for n, x in flatten_with_path(tree)}


def _rank_batch(b, mesh, microbatches=1):
    """This rank's rows of a batch, in microbatch order."""
    return {k: ts.batch_block(torch.from_numpy(v.astype(np.int64)), mesh,
                              microbatches).contiguous()
            for k, v in b.items()}


def _ctx():
    return init_bsq_state(torch.Generator(), reduced_config(ARCH), BSQ, SGDM(), "cpu")[1]


# ---------------------------------------------------------------------------
# What every rank runs
# ---------------------------------------------------------------------------


def _bsq_run(mesh, ref, remat=False, steps=STEPS, **step_kw):
    """BSQ steps from JAX's state, this rank's blocks; then the requant.
    ``remat``: each superblock rematerialised ("nothing"), its recompute
    in the backward on the mesh as well."""
    ctx = _ctx()
    if remat:
        ctx = dataclasses.replace(ctx, cfg=ctx.cfg.scaled(remat=True, remat_policy="nothing"))
    state = elastic.reshard_tree(bridge.bsq_state_from_jax(ref["bsq0"], ref["meta"]), mesh)
    step = make_bsq_train_step(ctx, SGDM(), _lr(), mesh=mesh, **step_kw)
    metrics = []
    for b in _batches(steps):
        state, m = step(state, _rank_batch(b, mesh, step_kw.get("microbatches", 1)))
        metrics.append({k: float(v) for k, v in m.items()})
    specs = elastic.train_state_specs(state, mesh, ctx.template)
    out = {"local": _np(state), "whole": _np(elastic.gather_tree(state, mesh, specs)),
           "metrics": metrics}
    if step_kw:
        return out
    if mesh.shape["model"] > 1:
        out["export"], out["tokens"] = _export_and_serve(state, ctx, mesh)
        from repro_torch.core.bsq import requantize_tree
        from repro_torch.train import state_reps

        dyn = requantize_tree({"embed": state_reps(state, ctx)["embed"]}, "dynamic",
                              mesh)["embed"]
        out["dynamic"] = (dyn.n_denom, dyn.scale.numpy(), dyn.wp.numpy(), dyn.wn.numpy(),
                          dyn.mask.numpy())
    state = make_requant_step(ctx, mesh)(state)
    out["requant_local"] = _np({"masks": state["masks"]})
    out["requant"] = _np(elastic.gather_tree(state, mesh, specs))
    return out


def _requests():
    from repro_torch.serve import Request

    task = MarkovLM(vocab=512, seed=3)
    return [Request(uid=i, tokens=task.sample(np.random.default_rng(50 + i), 1, 8)[0, :8]
                    .astype(np.int32), max_new=4) for i in range(4)]


def _served(packed, reps, state, ctx):
    """The serving tree of an export: packed projections, the embedding's
    float value (this rank's block on a mesh), float norms."""
    from repro_torch.core import merge_params
    from repro_torch.core.requant import forward_value

    served = {k: v for k, v in packed.items() if k != "embed"}
    served["embed"] = forward_value(reps["embed"])
    return merge_params(ctx.template, served, state["trainable"]["float"])


def _export_and_serve(state, ctx, mesh):
    """This rank's export of its trained blocks (``export_packed_blocks``)
    and the greedy tokens of one bucketed decode served from them."""
    from repro_torch.core.bsq import export_packed_blocks
    from repro_torch.serve import ServeEngine
    from repro_torch.train import state_reps

    reps = state_reps(state, ctx)
    shapes = {k: tuple(x.shape) for k, x in flatten_with_path(ctx.template)}
    packed = export_packed_blocks(reps, mesh, shapes)
    engine = ServeEngine(_served(packed, reps, state, ctx), ctx.cfg, max_len=32, mesh=mesh,
                         placed=True)
    tokens = {r.uid: r.tokens.tolist() for r in engine.generate(_requests())}
    return {k: (pw.planes.numpy(), pw.sign.numpy(), pw.scale.numpy(), pw.n_bits, pw.k,
                pw.kn_spec) for k, pw in packed.items()}, tokens


def _plain_run(mesh, ref):
    cfg = reduced_config(ARCH)
    params = bridge.from_numpy_tree(ref["plain0"])
    state = elastic.reshard_tree({"params": params, "opt": SGDM().init(params),
                                  "step": torch.zeros((), dtype=torch.int32)}, mesh)
    step = make_plain_train_step(cfg, SGDM(), _lr(), mesh=mesh)
    metrics = []
    for b in _batches(STEPS):
        state, m = step(state, _rank_batch(b, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    from repro_torch.train.step import abstract_plain_state

    specs = elastic.train_state_specs(state, mesh, abstract_plain_state(cfg, SGDM())["params"])
    return {"local": _np(state), "whole": _np(elastic.gather_tree(state, mesh, specs)),
            "metrics": metrics}


def _reg_run(mesh, ref):
    """One regulariser evaluation on the bridged state: its value, this
    rank's plane gradients, its grouped calls and collectives."""
    from repro_torch.kernels import ops
    from repro_torch.train import step as st

    ctx = _ctx()
    state = elastic.reshard_tree(bridge.bsq_state_from_jax(ref["bsq0"], ref["meta"]), mesh)
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


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _trainer(mesh, workdir, total, skip=0, **tkw):
    """train_bsq of the reduced config on this mesh from the seed-0 draw;
    ``skip`` batches of the seed-0 stream are passed over first (a
    restarted run's data picks up where the checkpoint left it)."""
    cfg = reduced_config(ARCH)
    state, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, BSQ, SGDM(), "cpu",
                                mesh=mesh)
    data = sharded_lm_iterator(MarkovLM(vocab=512, seed=13), B, S, sharding=mesh)
    for _ in range(skip):
        next(data)
    tcfg = TrainerConfig(total_steps=total, requant_interval=100, ckpt_interval=2,
                         log_interval=1, workdir=workdir, **tkw)
    out, text = _quiet(train_bsq, state, ctx, make_bsq_train_step(ctx, SGDM(), _lr(), mesh=mesh),
                       make_requant_step(ctx, mesh), data, tcfg, mesh=mesh)
    specs = elastic.train_state_specs(out["state"], mesh, ctx.template)
    return {"whole": _np(elastic.gather_tree(out["state"], mesh, specs)), "text": text,
            "steps": [h["step"] for h in out["history"]],
            "bits": out["scheme"].bits_per_param}


def _launch(mesh, argv):
    from repro_torch.launch import train as launcher

    args = launcher.build_parser().parse_args(argv)
    out, text = _quiet(launcher._train_rank, mesh, reduced_config(ARCH), args, 1)
    return {"text": text, "steps": [h["step"] for h in out["history"]]}


def _compressed_run(mesh, ref):
    """3 compressed plain and 3 compressed BSQ steps (global batch 4),
    with the params each step starts from, what it hands the compression
    (this rank's gradients) and the loss mean (its metrics) recorded."""
    from repro_torch.dist import collectives
    from repro_torch.train import step as st

    cfg = reduced_config(ARCH)
    batches = [_rank_batch(b, mesh) for b in _batches(STEPS)]
    seen = {"grads": [], "metrics": []}
    psum, pmean = collectives.tree_compressed_psum_ef, st._pmean

    def record_psum(grads, residuals, mesh_, axis):
        seen["grads"].append(_np(grads))
        return psum(grads, residuals, mesh_, axis)

    def record_pmean(mesh_, axis, values):
        seen["metrics"].append({k: float(v) for k, v in values.items()})
        return pmean(mesh_, axis, values)

    collectives.tree_compressed_psum_ef, st._pmean = record_psum, record_pmean
    try:
        out = {}
        _, plain_step = make_compressed_dp_step(cfg, SGDM(), _lr(), mesh)
        params = bridge.from_numpy_tree(ref["plain0"])
        state = {"params": params, "opt": SGDM().init(params),
                 "residual": init_residuals(params, n_shards=1),
                 "step": torch.zeros((), dtype=torch.int32)}
        for kind in ("plain", "bsq"):
            if kind == "bsq":
                ctx = _ctx()
                add_residuals, step = make_compressed_bsq_dp_step(ctx, SGDM(), _lr(), mesh)
                state = add_residuals(bridge.bsq_state_from_jax(ref["bsq0"], ref["meta"]))
            else:
                step = plain_step
            metrics, before = [], []
            for b in batches:
                before.append(_np({k: state[k] for k in ("params", "trainable", "masks")
                                   if k in state}))
                state, m = step(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
            out[kind] = {"state": _np(state), "metrics": metrics, "before": before,
                         "grads": seen["grads"][-STEPS:], "local": seen["metrics"][-STEPS:]}
    finally:
        collectives.tree_compressed_psum_ef, st._pmean = psum, pmean
    return out


def _rank_2x2(mesh, ref, workdir):
    out = {"coords": dict(mesh.coords), "bsq": _bsq_run(mesh, ref),
           "plain": _plain_run(mesh, ref), "reg": _reg_run(mesh, ref)}
    out["trainer"] = _trainer(mesh, os.path.join(workdir, "elastic"), 2)
    # the STOP file only rank 0 can see: every rank must stop with it
    stop_dir = os.path.join(workdir, "stop")
    if mesh.rank == 0:
        os.makedirs(stop_dir, exist_ok=True)
        open(os.path.join(stop_dir, "STOP"), "w").close()
    mesh.any(False)  # the file exists before any rank looks
    exists = os.path.exists
    if mesh.rank:
        os.path.exists = lambda p: not p.endswith(os.sep + "STOP") and exists(p)
    try:
        out["stop"] = _trainer(mesh, stop_dir, 4)
    finally:
        os.path.exists = exists
    out["launch"] = _launch(mesh, ["--device", "cpu", "--data-parallel", "2",
                                   "--model-parallel", "2", "--steps", "4", "--batch", "4",
                                   "--seq", "16", "--requant-interval", "3",
                                   "--ckpt-interval", "2", "--workdir",
                                   os.path.join(workdir, "launch")])
    return out


def _rank_2x1(mesh, ref):
    return {"coords": dict(mesh.coords), "bsq": _bsq_run(mesh, ref, remat=True),
            "plain": _plain_run(mesh, ref), "compressed": _compressed_run(mesh, ref),
            "decoupled": _bsq_run(mesh, ref, steps=1, decouple_reg_clip=True),
            "microbatched": _bsq_run(mesh, ref, steps=1, microbatches=2)}


def _rank_4x1(mesh, ref, workdir, probe):
    g, r = torch.from_numpy(probe["g"][mesh.rank]), torch.from_numpy(probe["r"][mesh.rank])
    c = g + r
    scale = mesh.all_reduce(torch.clamp(torch.amax(torch.abs(c)), min=1e-12), "data",
                            "max") / 127.0
    mean, res = compressed_psum_ef(g, r, mesh, "data")
    out = {"probe": {"codes": quantize_int8(c, scale)[0].numpy(), "mean": mean.numpy(),
                     "residual": res.numpy()},
           "compressed": _compressed_run(mesh, ref),
           "resumed": _trainer(mesh, os.path.join(workdir, "elastic"), 4, skip=2),
           "launch": _launch(mesh, ["--device", "cpu", "--data-parallel", "4",
                                    "--model-parallel", "1", "--steps", "6", "--batch", "4",
                                    "--seq", "16", "--requant-interval", "3",
                                    "--ckpt-interval", "2", "--workdir",
                                    os.path.join(workdir, "launch")])}
    return out


# ---------------------------------------------------------------------------
# The JAX references, on one device
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """JAX's states: 3 BSQ and 3 plain steps (test_torch_train.py's
    recipe)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config as j_reduced
    from repro.core import BSQConfig as JBSQConfig
    from repro.optim import SGDM as JSGDM
    from repro.optim import step_decay as j_step_decay
    from repro.train import step as jstep

    jcfg = j_reduced(ARCH)
    jbsq = JBSQConfig(n_init=8, alpha=5e-3, compute_dtype=jnp.float32)
    _, jctx = jstep.abstract_bsq_state(jcfg, jbsq, JSGDM())
    bsq0 = jax.jit(lambda k: jstep.init_bsq_state(k, jcfg, jbsq, JSGDM())[0])(
        jax.random.PRNGKey(0))
    plain0 = jax.jit(lambda k: jstep.init_plain_state(k, jcfg, JSGDM()))(jax.random.PRNGKey(0))
    out = {"meta": jctx.meta, "bsq0": jax.tree.map(np.array, bsq0),
           "plain0": jax.tree.map(np.array, plain0["params"])}

    def run(step, state, batches):
        states, metrics = [], []
        step = jax.jit(step)
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            states.append(jax.tree.map(np.array, state))
            metrics.append({k: float(v) for k, v in m.items()})
        return states, metrics

    lr = j_step_decay(0.2, [2])
    out["bsq"] = run(jstep.make_bsq_train_step(jctx, JSGDM(), lr), bsq0, _batches(STEPS))
    out["plain"] = run(jstep.make_plain_train_step(jcfg, JSGDM(), lr), plain0, _batches(STEPS))
    return out


@pytest.fixture(scope="module")
def probe():
    """compressed_psum_ef over 4 shards of random gradients and residuals,
    JAX's under ``vmap(axis_name="data")``: codes, mean, residuals."""
    import jax
    import jax.numpy as jnp

    from repro.dist import collectives as jcoll

    rng = np.random.default_rng(7)
    g = rng.standard_normal((4, 64, 48)).astype(np.float32) * np.float32(0.3)
    r = rng.standard_normal((4, 64, 48)).astype(np.float32) * np.float32(0.01)

    def shard(gi, ri):
        c = gi + ri
        scale = jax.lax.pmax(jnp.maximum(jnp.max(jnp.abs(c)), 1e-12), "data") / 127.0
        mean, res = jcoll.compressed_psum_ef(gi, ri, "data")
        return jcoll.quantize_int8(c, scale)[0], mean, res

    codes, mean, res = jax.jit(jax.vmap(shard, axis_name="data"))(g, r)
    return {"g": g, "r": r, "codes": np.asarray(codes), "mean": np.asarray(mean),
            "residual": np.asarray(res)}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_train"))


@pytest.fixture(scope="module")
def mesh_2x2(ref, workdir):
    return run_on_mesh(_rank_2x2, 2, 2, backend="gloo", device="cpu", threads=1,
                       args=(ref, workdir))


@pytest.fixture(scope="module")
def mesh_2x1(ref):
    return run_on_mesh(_rank_2x1, 2, 1, backend="gloo", device="cpu", threads=1, args=(ref,))


@pytest.fixture(scope="module")
def mesh_4x1(ref, workdir, probe, mesh_2x2):
    return run_on_mesh(_rank_4x1, 4, 1, backend="gloo", device="cpu", threads=1,
                       args=(ref, workdir, probe))


@pytest.fixture
def meshes(request):
    return request.getfixturevalue(request.param)


def _rank_view(shape, coords):
    return SimpleNamespace(shape=dict(zip(("data", "model"), shape)), coords=coords)


def _close(got, want, atol, what):
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol, err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# BSQ and plain steps on 2x2 and 2x1
# ---------------------------------------------------------------------------

MESHES = [("mesh_2x2", (2, 2)), ("mesh_2x1", (2, 1))]


@pytest.mark.parametrize("kind", ["bsq", "plain"])
@pytest.mark.parametrize("meshes,shape", MESHES, indirect=["meshes"], ids=["2x2", "2x1"])
def test_steps_on_the_mesh_match_jax_single_device(meshes, shape, kind, ref):
    """3 steps: every rank's gathered state within 1e-5 of JAX's, and ce,
    reg, total, grad_norm within 1e-5 relative; lr exact."""
    states, metrics = ref[kind]
    want = dict(flatten_with_path(states[-1]))
    for r in meshes:
        _close(r[kind]["whole"], {n: np.asarray(v) for n, v in want.items()}, 1e-5,
               f"{kind} rank {r['coords']}")
        for i, (m, w) in enumerate(zip(r[kind]["metrics"], metrics)):
            for k in ("ce", "reg", "total", "grad_norm"):
                if k in w:
                    assert abs(m[k] - w[k]) <= 1e-5 * abs(w[k]), (kind, i, k, m[k], w[k])
            assert m["lr"] == w["lr"]


@pytest.mark.parametrize("kind", ["bsq", "plain"])
@pytest.mark.parametrize("meshes,shape", MESHES, indirect=["meshes"], ids=["2x2", "2x1"])
def test_each_rank_holds_its_block_and_replicated_leaves_agree(meshes, shape, kind):
    """Each rank's leaves are exactly the rules' block of the gathered state
    (tree_param_specs on the whole shapes), and every leaf the rules keep
    whole (rep scales, norms, masks, the step) is the same bits on every
    rank."""
    whole = meshes[0][kind]["whole"]
    tree = unflatten_like(whole, {n: SimpleNamespace(shape=v.shape) for n, v in whole.items()})
    tree = {"step": None, **tree} if "step" not in tree else tree
    specs = dict(ts.flatten_specs(elastic.train_state_specs(tree, _rank_view(shape, {}))))
    split = 0
    for r in meshes:
        view = _rank_view(shape, r["coords"])
        for name, x in r[kind]["local"].items():
            want = ts.local_block(torch.from_numpy(whole[name]), specs[name], view).numpy()
            np.testing.assert_array_equal(x, want, err_msg=f"{r['coords']} {name}")
            if any(a is not None for a in specs[name]):
                split += x.size < whole[name].size
            else:
                np.testing.assert_array_equal(x, meshes[0][kind]["local"][name])
    assert split > 0


def _port_state(flat, ref):
    """A port BSQ state from a flat name -> array map (the bridged JAX
    state gives the structure)."""
    like = bridge.bsq_state_from_jax(ref["bsq0"], ref["meta"])
    return unflatten_like(like, {n: torch.from_numpy(np.array(v)) for n, v in flat.items()})


def test_decoupled_clip_on_2x1_equals_one_process_and_accumulation_raises(mesh_2x1, ref):
    """``decouple_reg_clip`` on a mesh (the regulariser's gradient taken
    again on each rank's rows, the task gradient's norm over the mesh): one
    step equals the same step in one process within 1e-5; so does a step of
    gradient accumulation (microbatches 2, hoisted, each rank's rows in
    microbatch order), which a mesh used to refuse."""
    ctx = _ctx()
    batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in _batches(1)[0].items()}
    for key, kw in (("decoupled", {"decouple_reg_clip": True}), ("microbatched",
                                                                 {"microbatches": 2})):
        state = bridge.bsq_state_from_jax(ref["bsq0"], ref["meta"])
        state, m = make_bsq_train_step(ctx, SGDM(), _lr(), **kw)(state, batch)
        want = _np(state)
        for r in mesh_2x1:
            _close(r[key]["whole"], want, 1e-5, key)
            for k in ("ce", "reg", "total", "grad_norm"):
                got = r[key]["metrics"][0][k]
                assert abs(got - float(m[k])) <= 1e-5 * abs(float(m[k])), \
                    (key, k, got, float(m[k]))


def test_requant_masks_on_the_mesh_equal_one_process(mesh_2x2, ref):
    """The mesh's requant after 3 steps: planes and masks bit for bit those
    of one process's requant of the gathered state; masks alike on every
    rank."""
    state = make_requant_step(_ctx())(_port_state(mesh_2x2[0]["bsq"]["whole"], ref))
    want = _np(state)
    for r in mesh_2x2:
        for name, x in r["bsq"]["requant"].items():
            np.testing.assert_array_equal(x, want[name], err_msg=name)
        for name, x in r["bsq"]["requant_local"].items():
            np.testing.assert_array_equal(x, mesh_2x2[0]["bsq"]["requant_local"][name])


def test_export_of_trained_blocks_equals_the_block_of_one_process_export(mesh_2x2, ref):
    """After 3 steps on 2x2: each rank's export_packed_blocks bytes are the
    rules' block of one process's export_packed of the gathered state, and
    one bucketed decode served from the ranks' blocks gives one process's
    greedy tokens."""
    from repro_torch.core import export_packed
    from repro_torch.serve import ServeEngine
    from repro_torch.train import state_reps

    ctx = _ctx()
    state = _port_state(mesh_2x2[0]["bsq"]["whole"], ref)
    reps = state_reps(state, ctx)
    whole = export_packed(reps)
    engine = ServeEngine(_served(whole, reps, state, ctx), ctx.cfg, max_len=32, device="cpu")
    tokens = {r.uid: r.tokens.tolist() for r in engine.generate(_requests())}
    shape = (2, 2)
    split = 0
    for r in mesh_2x2:
        assert r["bsq"]["tokens"] == tokens
        view = _rank_view(shape, r["coords"])
        for name, (planes, sign, scale, n_bits, k, kn) in r["bsq"]["export"].items():
            pw = whole[name]
            assert (n_bits, k) == (pw.n_bits, pw.k)
            sspec = ts.param_spec(f"{name}/sign", tuple(pw.sign.shape), view)
            assert kn == (tuple(sspec) + (None, None))[len(pw.sign.shape) - 2:][:2]
            pspec = ts.param_spec(f"{name}/planes", tuple(pw.planes.shape), view)
            for got, want, spec in ((planes, pw.planes, pspec), (sign, pw.sign, sspec)):
                np.testing.assert_array_equal(got, ts.local_block(want, spec, view).numpy())
            split += sign.size < pw.sign.numel()
            np.testing.assert_array_equal(scale, elastic.local_scale(
                pw.scale, ts.param_spec(f"{name}/scale", tuple(pw.scale.shape), view),
                sspec[-1] if len(sspec) else None, pw.sign.shape[-1], view).numpy())
    assert split > 0


def test_dynamic_requant_of_a_block_equals_one_process(mesh_2x2, ref):
    """``requantize_tree(mode="dynamic", mesh=)`` on each rank's block of
    the embedding after 3 steps: the whole tensor's precision and scale
    (or-ed over the mesh) and the block of one process's new planes."""
    from repro_torch.core.requant import requantize_dynamic
    from repro_torch.train import state_reps

    want = requantize_dynamic(state_reps(_port_state(mesh_2x2[0]["bsq"]["whole"], ref),
                                         _ctx())["embed"])
    spec = ts.param_spec("embed", tuple(want.wp.shape[1:]), _rank_view((2, 2), {}))
    for r in mesh_2x2:
        n, scale, wp, wn, mask = r["bsq"]["dynamic"]
        assert n == want.n_denom and n < 9
        np.testing.assert_array_equal(scale, want.scale.numpy())
        np.testing.assert_array_equal(mask, want.mask.numpy())
        view = _rank_view((2, 2), r["coords"])
        for got, planes in ((wp, want.wp), (wn, want.wn)):
            np.testing.assert_array_equal(got, ts.local_block(planes, (None,) + tuple(spec),
                                                              view).numpy())


def test_regulariser_on_2x2_is_one_grouped_call_and_one_all_reduce(mesh_2x2, ref):
    """Each rank: one bgl_sumsq_grouped call over the wp and wn blocks of
    every tensor and one collective; the value and each rank's plane
    gradients within 1e-6 relative of one process's."""
    from repro_torch.core import bsq as bsq_mod
    from repro_torch.train import step as st

    ctx = _ctx()
    state = bridge.bsq_state_from_jax(ref["bsq0"], ref["meta"])
    reps = st._reps_from_state(state["trainable"], state["masks"], ctx.meta)
    planes = [x for r in reps.values() for x in (r.wp, r.wn)]
    for x in planes:
        x.requires_grad_(True)
    reg = bsq_mod.regularizer(reps, ctx.bsq_cfg, ctx.total_quant_params)
    grads = dict(zip([f"{k}/{p}" for k in reps for p in ("wp", "wn")],
                     torch.autograd.grad(reg, planes)))
    reg = reg.detach()
    specs = dict(ts.flatten_specs(elastic.train_state_specs(state, _rank_view((2, 2), {}))))
    for r in mesh_2x2:
        got = r["reg"]
        assert got["calls"] == [2 * len(reps)] and got["collectives"] == 1
        assert abs(got["reg"] - reg.item()) <= 1e-6 * abs(reg.item())
        view = _rank_view((2, 2), r["coords"])
        for name, g in got["grads"].items():
            want = ts.local_block(grads[name], specs[f"trainable/reps/{name}"], view).numpy()
            assert g.shape == want.shape and g.size < grads[name].numel()
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)


class _Handed(Exception):
    """Raised by the stand-in collectives once they have seen their tensor."""


@pytest.mark.parametrize("backend,wire", [("nccl", "meta"), ("gloo", "cpu")])
def test_host_tensors_cross_on_the_ranks_card_under_nccl(monkeypatch, backend, wire):
    """NCCL takes only the rank's card.  Under nccl every host tensor that
    HostMesh hands to a collective is on the mesh's device: the trainer's
    STOP flag (a bool), requant's flags, the engine's float64 byte count,
    an int32 sum and a gather; under gloo it stays on the host.  The
    "meta" device stands in for the rank's card (this runs on the CPU):
    the stand-in collectives record the device they are handed and stop."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import AbstractMesh, HostMesh
    from repro_torch.train.trainer import _should_stop

    mesh = HostMesh.__new__(HostMesh)
    AbstractMesh.__init__(mesh, {"data": 2, "model": 2})
    mesh.rank, mesh.device, mesh.backend = 0, torch.device("meta"), backend
    mesh.coords, mesh._root, mesh._count = {"data": 0, "model": 0}, mesh, 0
    mesh.group = lambda axis: axis
    seen = []

    def handed(first, second=None, **kw):
        seen.append((second if isinstance(first, list) else first).device.type)
        raise _Handed

    monkeypatch.setattr(dist, "all_reduce", handed)
    monkeypatch.setattr(dist, "all_gather", handed)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    calls = [lambda: _should_stop(None, mesh),
             lambda: mesh.any(torch.tensor([True, False])),
             lambda: mesh.all_reduce(torch.tensor(3.0, dtype=torch.float64), ("data", "model")),
             lambda: mesh.all_reduce(torch.arange(3, dtype=torch.int32), "data"),
             lambda: mesh.all_gather(torch.ones(2, 3), "model", 0)]
    for call in calls:
        with pytest.raises(_Handed):
            call()
    assert seen == [wire] * len(calls)


def test_compressed_psum_ef_matches_jax_under_vmap(mesh_4x1, probe):
    """4 gloo ranks against JAX's compressed_psum_ef under vmap: the int8
    codes and the residuals bit for bit, the mean within one f32 ulp."""
    for rank, r in enumerate(mesh_4x1):
        got = r["probe"]
        assert got["codes"].dtype == np.int8
        np.testing.assert_array_equal(got["codes"], probe["codes"][rank])
        np.testing.assert_array_equal(got["residual"], probe["residual"][rank])
        want = probe["mean"][rank]
        assert (np.abs(got["mean"] - want) <= np.spacing(np.abs(want))).all()


def _jax_compressed(kind, n, ranks, ref):
    """JAX's compressed data-parallel step composed on one device, fed each
    rank's recorded gradients: ``tree_compressed_psum_ef`` and ``pmean``
    under ``vmap(axis_name="data")`` (a rank a row), JAX's SGDM update and,
    for BSQ, its plane projection, as ``make_compressed_dp_step`` and
    ``make_compressed_bsq_dp_step`` run them after their per-shard
    gradients; one jitted step.  Beside it, JAX's per-shard
    ``value_and_grad`` of ``loss_fn`` (plain) or ``bsq_loss`` (BSQ), as
    JAX's ``per_shard`` takes it, on each rank's block of the batch at the
    params that rank started the step from, vmapped over the ranks.
    Returns, after each step, (state, metrics, the per-shard gradients
    with a leading rank axis, the per-shard metrics)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config as j_reduced
    from repro.core import BSQConfig as JBSQConfig
    from repro.dist import collectives as jcoll
    from repro.models import transformer as jtf
    from repro.optim import SGDM as JSGDM
    from repro.optim import project_bitplanes
    from repro.optim import step_decay as j_step_decay
    from repro.train import step as jstep

    jcfg = j_reduced(ARCH)
    _, jctx = jstep.abstract_bsq_state(
        jcfg, JBSQConfig(n_init=8, alpha=5e-3, compute_dtype=jnp.float32), JSGDM())
    key = "params" if kind == "plain" else "trainable"
    if kind == "plain":
        params = jax.tree.map(jnp.asarray, ref["plain0"])
        state = {"params": params, "opt": JSGDM().init(params)}
    else:
        state = dict(jax.tree.map(jnp.asarray, ref["bsq0"]))
    state["residual"] = jcoll.init_residuals(state[key], n_shards=n)

    def one(start, b):
        if kind == "plain":
            (loss, _), g = jax.value_and_grad(
                lambda p: jtf.loss_fn(p, b, jcfg), has_aux=True)(start["params"])
            return g, {"total": loss}
        (_, m), g = jax.value_and_grad(jstep.bsq_loss, has_aux=True)(
            start["trainable"], start["masks"], b, jctx)
        return g, m

    def step(state, grads, metrics, lr, starts, blocks):
        shard_grads, shard_metrics = jax.vmap(one)(starts, blocks)
        mean, residual = jax.vmap(lambda g, r: jcoll.tree_compressed_psum_ef(g, r, "data"),
                                  axis_name="data")(grads, state["residual"])
        metrics = jax.vmap(lambda m: jax.tree.map(lambda v: jax.lax.pmean(v, "data"), m),
                           axis_name="data")(metrics)
        new, opt = JSGDM().update(jax.tree.map(lambda x: x[0], mean), state["opt"],
                                  state[key], lr)
        if kind == "bsq":
            reps = project_bitplanes(jstep._reps_from_state(new, state["masks"], ref["meta"]))
            new = dict(new, reps={k: {"wp": r.wp, "wn": r.wn, "scale": r.scale}
                                  for k, r in reps.items()})
        return (dict(state, **{key: new, "opt": opt, "residual": residual}),
                jax.tree.map(lambda x: x[0], metrics), shard_grads, shard_metrics)

    step = jax.jit(step)
    lr_fn, out = j_step_decay(0.2, [2]), []
    for i, b in enumerate(_batches(STEPS)):
        blocks = {k: jnp.asarray(v.reshape((n, v.shape[0] // n) + v.shape[1:]))
                  for k, v in b.items()}
        grads = jax.tree.map(lambda *xs: jnp.stack(xs), *[
            unflatten_like(state[key], {n_: jnp.asarray(v) for n_, v in r[kind]["grads"][i].items()})
            for r in ranks])
        metrics = {k: jnp.asarray([r[kind]["local"][i][k] for r in ranks])
                   for k in ranks[0][kind]["local"][i]}
        like = {k: state[k] for k in ("params", "trainable", "masks") if k in state}
        starts = jax.tree.map(lambda *xs: jnp.stack(xs), *[
            unflatten_like(like, {n_: jnp.asarray(v) for n_, v in r[kind]["before"][i].items()})
            for r in ranks])
        state, m, g, gm = step(state, grads, metrics, lr_fn(i), starts, blocks)
        out.append(({k: np.asarray(v) for k, v in flatten_with_path(
            jax.tree.map(np.asarray, state))}, {k: float(v) for k, v in m.items()},
            dict(flatten_with_path(jax.tree.map(np.asarray, g))),
            {k: np.asarray(v) for k, v in gm.items()}))
    return out


@pytest.mark.parametrize("kind", ["plain", "bsq"])
@pytest.mark.parametrize("meshes,n", [("mesh_2x1", 2), ("mesh_4x1", 4)], indirect=["meshes"],
                         ids=["2x1", "4x1"])
def test_compressed_steps_match_the_composed_jax_reference(meshes, n, kind, ref):
    """3 compressed steps, params whole on every rank.  What each rank hands
    the int8 collective, its gradients on its block of the batch, is held
    to JAX's per-shard ``value_and_grad`` at the params the rank started
    the step from, every element within 1e-5 absolute and GRAD_TOL
    relative, and the rank's losses within 1e-5 relative.
    The reference's composed step is then fed the ranks' own gradients
    (int8 rounding is a step function: a gradient 1e-7 away, from f32 sums
    in another order, moves a code that sits by a rounding boundary a
    whole level): each rank's state within 1e-5 of JAX's after the 3 steps
    (its residual, JAX's row of the rank) and every step's loss means
    within 1e-6 relative."""
    want = _jax_compressed(kind, n, [r["compressed"] for r in meshes], ref)
    state_w = want[-1][0]
    for rank, r in enumerate(meshes):
        got = r["compressed"][kind]
        for i, (_, _, grads_w, local_w) in enumerate(want):
            assert sorted(got["grads"][i]) == sorted(grads_w)
            for name, g in got["grads"][i].items():
                np.testing.assert_allclose(g, grads_w[name][rank], rtol=GRAD_TOL, atol=1e-5,
                                           err_msg=f"{kind} {n} step {i} rank {rank} {name}")
            for k, v in got["local"][i].items():
                w = float(local_w[k][rank])
                assert abs(v - w) <= 1e-5 * abs(w), (kind, n, i, rank, k, v, w)
        assert sorted(k for k in got["state"] if k != "step") == sorted(
            k for k in state_w if k != "step")
        for name, w in state_w.items():
            if name == "step":
                continue
            w = w[rank:rank + 1] if name.startswith("residual/") else w
            np.testing.assert_allclose(got["state"][name], w, rtol=0, atol=1e-5,
                                       err_msg=f"{kind} {n} {name}")
        for m, (_, w, _, _) in zip(got["metrics"], want):
            for k, v in w.items():
                assert abs(m[k] - v) <= 1e-6 * abs(v), (kind, n, k, m[k], v)


def _single_process():
    """The uninterrupted one-process run of _trainer's recipe: (the state
    after 2 steps, the state after 4 steps and the final requant)."""
    cfg = reduced_config(ARCH)
    state, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, BSQ, SGDM(), "cpu")
    data = sharded_lm_iterator(MarkovLM(vocab=512, seed=13), B, S, device="cpu")
    step = make_bsq_train_step(ctx, SGDM(), _lr())
    states = []
    for _ in range(4):
        state, _ = step(state, next(data))
        states.append(_np(state))
    return states[1], _np(make_requant_step(ctx)(state))


def test_elastic_resume_2x2_checkpoint_on_4x1(mesh_2x2, mesh_4x1, workdir, ref):
    """train_bsq's step-2 checkpoint from the 2x2 mesh: whole tensors that
    the port (unsharded) and JAX's ckpt.restore read alike, equal to one
    process's 2 steps; restored on (4, 1), 2 more steps equal one
    process's uninterrupted 4 steps within 1e-5."""
    from repro.ckpt import checkpoint as jckpt

    d = os.path.join(workdir, "elastic")
    assert ckpt.available_steps(d) == [2, 4]
    two, four = _single_process()
    restored = _np(ckpt.restore(_port_state(two, ref), d, 2))
    _close(restored, two, 1e-5, "step-2 checkpoint")
    jax_restored = dict(flatten_with_path(jckpt.restore(ref["bsq0"], d, 2)))
    for name, x in restored.items():
        np.testing.assert_array_equal(np.asarray(jax_restored[name]), x, err_msg=name)
    for r in mesh_4x1:
        assert r["resumed"]["steps"] == [3, 4]
        _close(r["resumed"]["whole"], four, 1e-5, "resumed on 4x1")
    assert "[trainer] resumed from step 2" in mesh_4x1[0]["resumed"]["text"]
    assert all(r["trainer"]["steps"] == [1, 2] for r in mesh_2x2)


def test_stop_file_seen_by_one_rank_stops_every_rank(mesh_2x2, workdir):
    """Only rank 0 sees STOP: every rank stops after step 1, and the
    checkpoint of step 1 is written."""
    assert [r["stop"]["steps"] for r in mesh_2x2] == [[1]] * 4
    assert "STOP file detected at step 1" in mesh_2x2[0]["stop"]["text"]
    assert not any(r["stop"]["text"] for r in mesh_2x2[1:])
    assert 1 in ckpt.available_steps(os.path.join(workdir, "stop"))


def test_launcher_mesh_flags_run_and_resume(mesh_2x2, mesh_4x1, workdir):
    """The launcher's rank body on 2x2 (4 steps, checkpoints at 2 and 4),
    then on 4x1 with --steps 6: it resumes from step 4; rank 0 alone
    prints and writes scheme.json and history.json."""
    first, second = mesh_2x2[0]["launch"], mesh_4x1[0]["launch"]
    assert first["steps"] == [1, 2, 3, 4] and second["steps"] == [5, 6]
    assert "[requant] step 3:" in first["text"] and "done: bits/para=" in first["text"]
    assert "[trainer] resumed from step 4" in second["text"]
    assert not any(r["launch"]["text"] for r in mesh_2x2[1:] + mesh_4x1[1:])
    d = os.path.join(workdir, "launch")
    assert ckpt.available_steps(d) == [2, 4, 6]
    assert os.path.exists(os.path.join(d, "scheme.json"))
    assert os.path.exists(os.path.join(d, "history.json"))
