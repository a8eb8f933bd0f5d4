"""BSQ training on a live ("pod", "data", "model") mesh, gradient
accumulation on a mesh, and the dry run's 16x16 and 2x16x16 cells,
against the JAX package on one device, on the CPU (reduced granite-3-2b
and qwen2-moe-a2.7b, f32, batch 8 x 16 tokens, 2 steps).

Three gloo groups of CPU ranks (``launch.mesh.run_on_mesh``), spawned
one after the other from a thread while this process computes JAX's
references:

* 2x2: 2 steps at ``microbatches`` 2, hoisted and not, of both models
  from JAX's bridged state, each rank's rows laid out in microbatch order
  (``dist.sharding.batch_block``: rank r holds its block of JAX's
  microbatch 0, then of microbatch 1); then 2 steps of granite through
  ``train_bsq``, whose checkpoint the next group resumes;
* 2x2x2: 2 steps of both models (every parameter a copy on each pod, the
  batch over ("pod", "data")), the 2x2 checkpoint resumed to step 4, and
  one step of the dry run's train config under ``roofline.analysis``'s
  counter;
* 2x2 again: the 2x2x2 run's step-4 checkpoint resumed to step 6.

JAX's reference is its jitted single-device ``make_bsq_train_step`` on
the whole batch (its own 3-axis mesh test fails on a CPU host), at
``microbatches`` 1 or 2 and ``hoist_reconstruct`` as the mesh ran.  The
bars are slices 15-17's: ce, aux, reg, total and the first gradient norm
within 1e-5 relative; the gathered state within 1e-5 absolute (granite)
or 1e-4 of each leaf's largest |x| (qwen2-moe, whose routing and expert
sums run in another order).  The regulariser, the clip's norm and
requant's flags sum a weight's blocks over the weight axes only: a sum
over "pod" would count each group twice and move reg by a factor of 2.
The router loss sums its statistics over both data axes; counted once
per pod it moves aux.  Rows in contiguous order rather than microbatch
order move the microbatched qwen2-moe router loss.
"""
import contextlib
import io
import threading
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import SHAPES, ShapeConfig, reduced_config
from repro_torch.core import BSQConfig
from repro_torch.data import MarkovLM, sharded_lm_iterator
from repro_torch.dist import elastic
from repro_torch.dist import sharding as ts
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import meta_mesh, run_on_mesh
from repro_torch.models import transformer as ttf
from repro_torch.optim import SGDM, step_decay
from repro_torch.roofline import analysis
from repro_torch.train import (TrainerConfig, init_bsq_state, make_bsq_train_step,
                               make_requant_step, train_bsq)
from repro_torch.tree import flatten_with_path, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRANITE, MOE = "granite-3-2b", "qwen2-moe-a2.7b"
ARCHS = [GRANITE, MOE]
B, S, STEPS, MB = 8, 16, 2, 2
BSQ = BSQConfig(n_init=8, alpha=5e-3, compute_dtype=torch.float32)
LOSS_TOL = 1e-5  # relative
STATE_TOL = {GRANITE: ("abs", 1e-5), MOE: ("of_max", 1e-4)}
# the dry run's train config (launch.dryrun.build_train_cell), for the
# live step whose collective bytes the meta count must equal
DRY_BSQ = BSQConfig(n_init=8, alpha=5e-3, mode="static")
POD = {"pod": 2, "data": 2, "model": 2}


def _lr():
    return step_decay(0.2, [STEPS])


def _batches(cfg):
    task = MarkovLM(vocab=cfg.vocab_size, seed=13)
    return [{k: v.astype(np.int64) for k, v in task.batch(np.random.default_rng(i), B, S).items()}
            for i in range(STEPS)]


def _np(tree):
    return {n: x.detach().cpu().numpy().copy() for n, x in flatten_with_path(tree)
            if isinstance(x, torch.Tensor)}


def _ctx(cfg):
    from repro_torch.train import step as st

    return st.abstract_bsq_state(cfg, BSQ, SGDM())[1]


@contextlib.contextmanager
def _counted_bgl(calls):
    """Count the grouped regulariser's forward and backward calls (on the
    card each is one kernel launch)."""
    fwd, bwd = ops._BglSumsqGrouped.forward, ops._BglSumsqGrouped.backward

    def forward(ctx, *xs):
        calls["forward"] += 1
        return fwd(ctx, *xs)

    def backward(ctx, g):
        calls["backward"] += 1
        return bwd(ctx, g)

    with mock.patch.object(ops._BglSumsqGrouped, "forward", staticmethod(forward)), \
            mock.patch.object(ops._BglSumsqGrouped, "backward", staticmethod(backward)):
        yield


# ---------------------------------------------------------------------------
# What every rank runs
# ---------------------------------------------------------------------------


def _train(mesh, m, microbatches=1, hoist=True):
    """STEPS steps from the bridged whole state on this rank's blocks, the
    rows of each batch in microbatch order: gathered state, metrics and
    the grouped regulariser's calls per step."""
    cfg = m["cfg"]
    ctx = _ctx(cfg)
    state = elastic.reshard_tree(tree_map(torch.from_numpy, m["state"]), mesh)
    step = make_bsq_train_step(ctx, SGDM(), _lr(), mesh=mesh, microbatches=microbatches,
                               hoist_reconstruct=hoist)
    metrics, calls = [], []
    for b in m["batches"]:
        rows = {k: ts.batch_block(torch.from_numpy(v), mesh, microbatches).contiguous()
                for k, v in b.items()}
        c = {"forward": 0, "backward": 0}
        with _counted_bgl(c):
            state, mt = step(state, rows)
        calls.append(c)
        metrics.append({k: float(v) for k, v in mt.items()})
    specs = elastic.train_state_specs(state, mesh, ctx.template)
    return {"state": _np(elastic.gather_tree(state, mesh, specs)), "local": _np(state),
            "metrics": metrics, "calls": calls}


def _trainer(mesh, workdir, total, skip):
    """train_bsq of reduced granite from its seed-0 draw on ``mesh``,
    checkpoints every 2 steps; ``skip`` batches passed over first."""
    cfg = reduced_config(GRANITE)
    state, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, BSQ, SGDM(), "cpu",
                                mesh=mesh)
    data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), B, S, sharding=mesh)
    for _ in range(skip):
        next(data)
    tcfg = TrainerConfig(total_steps=total, requant_interval=100, ckpt_interval=2,
                         log_interval=1, workdir=workdir)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        res = train_bsq(state, ctx, make_bsq_train_step(ctx, SGDM(), _lr(), mesh=mesh),
                        make_requant_step(ctx, mesh), data, tcfg, mesh=mesh)
    specs = elastic.train_state_specs(res["state"], mesh, ctx.template)
    return {"whole": _np(elastic.gather_tree(res["state"], mesh, specs)),
            "steps": [h["step"] for h in res["history"]], "text": text.getvalue()}


def _dry_config_step(mesh):
    """One step of the dry run's train config of reduced granite at B x S on
    this rank's blocks, under the counter: its collective bytes by kind."""
    cfg = reduced_config(GRANITE)
    state, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, DRY_BSQ, SGDM(), "cpu",
                                mesh=mesh)
    step = make_bsq_train_step(ctx, SGDM(), step_decay(0.1, [10_000, 20_000]), mesh=mesh)
    task = MarkovLM(vocab=cfg.vocab_size, seed=13)
    b = {k: ts.batch_block(torch.from_numpy(v.astype(np.int64)), mesh).contiguous()
         for k, v in task.batch(np.random.default_rng(0), B, S).items()}
    with analysis.Counter() as counter:
        step(state, b)
    return dict(counter.collectives)


def _rank_2x2(mesh, models, workdir):
    out = {"coords": dict(mesh.coords)}
    for arch in ARCHS:
        out[arch] = {h: _train(mesh, models[arch], MB, h) for h in (True, False)}
    out["trainer"] = _trainer(mesh, workdir, 2, 0)
    return out


def _rank_resume(mesh, workdir):
    return _trainer(mesh, workdir, 6, 4)


def _rank_2x2x2(mesh, models, workdir):
    view = mesh.training_view()
    out = {"coords": dict(mesh.coords), "view": (dict(view.shape), dict(view.coords))}
    for arch in ARCHS:
        out[arch] = _train(mesh, models[arch])
    out["resumed"] = _trainer(mesh, workdir, 4, 2)
    out["collectives"] = _dry_config_step(mesh)
    return out


# ---------------------------------------------------------------------------
# The references: JAX on one device
# ---------------------------------------------------------------------------


def _jax_runs(jstate, jctx, batches):
    """JAX's jitted STEPS steps from ``jstate`` on the whole batches at
    microbatches 1 and, hoisted and not, 2."""
    import jax
    import jax.numpy as jnp

    from repro.optim import SGDM as JSGDM
    from repro.optim import step_decay as j_step_decay
    from repro.train import step as jstep

    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    out = {}
    for key, mb, hoist in (("one", 1, True), (True, MB, True), (False, MB, False)):
        step = jax.jit(jstep.make_bsq_train_step(jctx, JSGDM(), j_step_decay(0.2, [STEPS]),
                                                 microbatches=mb, hoist_reconstruct=hoist))
        js, metrics = jax.tree.map(jnp.asarray, jstate), []
        for b in jb:
            js, mt = step(js, b)
            metrics.append({k: float(v) for k, v in mt.items()})
        out[key] = {"state": dict(flatten_with_path(jax.tree.map(np.array, js))),
                    "metrics": metrics}
    return out


def _one_process_steps(n):
    """One process's n steps of ``_trainer``'s run, then its final requant."""
    cfg = reduced_config(GRANITE)
    state, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, BSQ, SGDM(), "cpu")
    data = sharded_lm_iterator(MarkovLM(vocab=cfg.vocab_size, seed=13), B, S, device="cpu")
    step = make_bsq_train_step(ctx, SGDM(), _lr())
    for _ in range(n):
        state, _ = step(state, next(data))
    return _np(make_requant_step(ctx)(state))  # train_bsq's final requant


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's states of the draws, then the rank groups (spawned from a
    thread) while this process computes JAX's steps and one process's."""
    from test_torch_mesh_train_kinds import _jax_state

    models, jax_states, ref = {}, {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = reduced_config(arch)
        params = tree_map(lambda t: t.numpy(), ttf.init_params(
            cfg, torch.Generator().manual_seed(60 + i), "cpu"))
        jax_states[arch] = _jax_state(arch, params)
        state = bridge.bsq_state_from_jax(jax_states[arch][0], jax_states[arch][1].meta)
        models[arch] = {"cfg": cfg, "batches": _batches(cfg),
                        "state": tree_map(lambda t: t.numpy(), state)}
    workdir = str(tmp_path_factory.mktemp("pod_mesh"))
    out = {}

    def spawn():
        try:
            out["2x2"] = run_on_mesh(_rank_2x2, 2, 2, backend="gloo", device="cpu", threads=1,
                                     args=(models, workdir))
            out["2x2x2"] = run_on_mesh(_rank_2x2x2, 2, 2, pod=2, backend="gloo", device="cpu",
                                       threads=1, args=(models, workdir))
            out["resumed"] = run_on_mesh(_rank_resume, 2, 2, backend="gloo", device="cpu",
                                         threads=1, args=(workdir,))
        except BaseException as e:  # noqa: BLE001 - raised in the test's thread below
            out["error"] = e

    ranks_thread = threading.Thread(target=spawn)
    ranks_thread.start()
    for arch in ARCHS:
        ref[arch] = _jax_runs(*jax_states[arch], models[arch]["batches"])
    ref["four_steps"], ref["six_steps"] = _one_process_steps(4), _one_process_steps(6)
    ref["meta_collectives"] = dict(dryrun.run_meta(
        reduced_config(GRANITE), ShapeConfig("pod_test", S, B, "train"), "bsq", 1,
        mesh_shape=POD)[0].collectives)
    ranks_thread.join()
    if "error" in out:
        raise out["error"]
    return ref, out["2x2"], out["2x2x2"], out["resumed"]


def _close_state(got, want, arch, what):
    kind, tol = STATE_TOL[arch]
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        w = np.asarray(w)
        bar = tol if kind == "abs" else tol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[name], w, rtol=0, atol=bar, err_msg=f"{what} {name}")


def _close_metrics(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("ce", "aux", "reg", "total") + (("grad_norm",) if i == 0 else ()):
            assert abs(g[k] - w[k]) <= LOSS_TOL * abs(w[k]), (what, i, k, g[k], w[k])
        assert g["lr"] == w["lr"]


# ---------------------------------------------------------------------------
# The live ("pod", "data", "model") mesh
# ---------------------------------------------------------------------------


def test_pod_ranks_are_row_major_and_the_training_view_hides_pod(runs):
    """Rank (p, d, m) = (p * 2 + d) * 2 + m, as jax.make_mesh lays devices
    out; the training view keeps "model" alone."""
    _, _, ranks, _ = runs
    assert [tuple(r["coords"].values()) for r in ranks] == \
        [(p, d, m) for p in range(2) for d in range(2) for m in range(2)]
    for r in ranks:
        shape, coords = r["view"]
        assert shape == {"pod": 1, "data": 1, "model": 2}
        assert coords == {"pod": 0, "data": 0, "model": r["coords"]["model"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_training_on_2x2x2_matches_jax_single_device(runs, arch):
    """2 steps on the ("pod", "data", "model") mesh: every rank's metrics
    and gathered state against JAX's single-device steps on the whole
    batches; one grouped regulariser call and one backward per step."""
    ref, _, ranks, _ = runs
    want = ref[arch]["one"]
    for r in ranks:
        what = f"{arch} rank {r['coords']}"
        _close_metrics(r[arch]["metrics"], want["metrics"], what)
        _close_state(r[arch]["state"], want["state"], arch, what)
        assert r[arch]["calls"] == [{"forward": 1, "backward": 1}] * STEPS, what


@pytest.mark.parametrize("arch", ARCHS)
def test_each_pod_holds_a_copy_of_every_block(runs, arch):
    """The rules never split a leaf over "pod": rank (1, d, m) holds exactly
    rank (0, d, m)'s blocks after the steps, and a block is the rules'
    block of the gathered state."""
    _, _, ranks, _ = runs
    whole = ranks[0][arch]["state"]
    specs = dict(ts.flatten_specs(elastic.train_state_specs(_tree_of_shapes(whole),
                                                            SimpleNamespace(shape=POD))))
    split = 0
    for r in ranks[:4]:
        twin = ranks[4 + ranks.index(r)]
        for name, x in r[arch]["local"].items():
            np.testing.assert_array_equal(twin[arch]["local"][name], x, err_msg=name)
            view = SimpleNamespace(shape=POD, coords=r["coords"])
            want = ts.local_block(torch.from_numpy(whole[name]), specs[name], view).numpy()
            np.testing.assert_array_equal(x, want, err_msg=name)
            assert "pod" not in ts.spec_axes(specs[name]), name
            split += x.size < whole[name].size
    assert split > 0


def _tree_of_shapes(flat):
    """The nested tree of a flat ``name -> array`` map, each leaf a stand-in
    with the array's shape (what the rules read)."""
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = SimpleNamespace(shape=v.shape)
    return tree


@pytest.mark.parametrize("way", ["2x2 to 2x2x2", "2x2x2 to 2x2"])
def test_a_2x2_checkpoint_resumes_on_2x2x2(runs, way):
    """train_bsq's step-2 checkpoint written on 2x2 resumes on 2x2x2 to step
    4, and that run's step-4 checkpoint on 2x2 to step 6: the gathered
    state within 1e-5 of one process's 4 and 6 steps."""
    ref, _, pod, back = runs
    ranks, first, want = (pod, 2, ref["four_steps"]) if way.endswith("2x2x2") else \
        (back, 4, ref["six_steps"])
    res = [r["resumed"] for r in ranks] if ranks is pod else ranks
    assert f"resumed from step {first}" in res[0]["text"]  # rank 0 prints
    for r in res:
        assert r["steps"] == [first + 1, first + 2]
        for name, w in want.items():
            np.testing.assert_allclose(r["whole"][name], w, rtol=0, atol=1e-5, err_msg=name)


def test_live_collective_bytes_equal_the_meta_dry_run(runs):
    """One step of the dry run's train config on the live 2x2x2 mesh: each
    rank's collective bytes by kind, counted by ``roofline.analysis``,
    equal the dry run's meta count of rank 0 on the same mesh exactly."""
    ref, _, ranks, _ = runs
    want = ref["meta_collectives"]
    assert want["all-reduce"] > 0 and want["all-gather"] > 0
    for r in ranks:
        assert r["collectives"] == want, r["coords"]


# ---------------------------------------------------------------------------
# Gradient accumulation on the 2x2 mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hoist", [True, False], ids=["hoisted", "not_hoisted"])
@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_step_on_2x2_matches_jax(runs, arch, hoist):
    """2 steps at microbatches 2 on 2x2, each rank's rows in microbatch
    order, against JAX's make_bsq_train_step(microbatches=2,
    hoist_reconstruct=hoist) on the whole batches; the grouped regulariser
    runs once a step hoisted (1 + 1) and once a microbatch not (2 + 2)."""
    ref, ranks, _, _ = runs
    want = ref[arch][hoist]
    n = 1 if hoist else MB
    for r in ranks:
        what = f"{arch} hoist={hoist} rank {r['coords']}"
        got = r[arch][hoist]
        _close_metrics(got["metrics"], want["metrics"], what)
        _close_state(got["state"], want["state"], arch, what)
        assert got["calls"] == [{"forward": n, "backward": n}] * STEPS, what


def test_microbatch_order_moves_the_router_loss(runs):
    """The witness that the layout matters: JAX's qwen2-moe router loss at
    microbatches 2 differs from the one-batch loss, which contiguous rows
    on a mesh would give instead."""
    ref, _, _, _ = runs
    one, two = ref[MOE]["one"]["metrics"][0]["aux"], ref[MOE][True]["metrics"][0]["aux"]
    assert abs(one - two) > 100 * LOSS_TOL * abs(two)


def test_batch_block_lays_rows_out_in_microbatch_order():
    """Rank r's rows at microbatches mb are its block of each of JAX's
    microbatches in turn; the iterator cuts them so."""
    t = torch.arange(16).reshape(8, 2)
    for pod in (1, 2):
        shape = {"pod": 2, "data": 2, "model": 2} if pod == 2 else {"data": 2, "model": 2}
        n_dp = 2 * pod
        for r in range(n_dp):
            coords = {"pod": r // 2, "data": r % 2, "model": 1} if pod == 2 else \
                {"data": r, "model": 1}
            mesh = SimpleNamespace(shape=shape, coords=coords, device=torch.device("cpu"))
            got = ts.batch_block(t, mesh, 2)
            per = 4 // n_dp
            want = torch.cat([t[i * 4 + r * per:i * 4 + (r + 1) * per] for i in range(2)])
            assert torch.equal(got, want), (pod, r)
            assert torch.equal(ts.batch_block(t, mesh), t[r * 8 // n_dp:(r + 1) * 8 // n_dp])

    class Task:
        def batch(self, rng, b, s):
            return {"tokens": np.arange(b * s).reshape(b, s)}

    mesh = SimpleNamespace(shape={"data": 2, "model": 1}, coords={"data": 1, "model": 0},
                           device="cpu")
    got = next(sharded_lm_iterator(Task(), 8, 3, sharding=mesh, microbatches=2))["tokens"]
    whole = torch.arange(24).reshape(8, 3)
    assert torch.equal(got, torch.cat([whole[2:4], whole[6:8]]))


# ---------------------------------------------------------------------------
# The dry run's 16x16 and 2x16x16 cells, reduced configs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dry_cells():
    cfg = reduced_config(GRANITE)
    out = {}
    for mesh in ("16x16", "2x16x16"):
        out[mesh] = dryrun.run_cell(GRANITE, "train_4k", technique="bsq", verbose=False,
                                    cfg_override=cfg, mesh_shape=dryrun.MESHES[mesh])
    return out


def _rule_bytes(mesh_shape):
    """(state bytes, batch bytes) of rank 0's blocks under the rules, from
    the whole abstract state and batch."""
    from repro_torch.models.frontends import batch_specs
    from repro_torch.train import step as st

    cfg = reduced_config(GRANITE)
    whole, _ = st.abstract_bsq_state(cfg, DRY_BSQ, SGDM())
    view = SimpleNamespace(shape=mesh_shape, coords={ax: 0 for ax in mesh_shape})
    specs = dict(ts.flatten_specs(elastic.train_state_specs(whole, view)))
    state = sum(int(np.prod(ts.local_shape(x.shape, specs[n], view))) * x.element_size()
                for n, x in flatten_with_path(whole))
    mb = dryrun.default_microbatches(SHAPES["train_4k"], mesh_shape)
    batch = sum(int(np.prod(ts.batch_block(x, view, mb).shape)) * x.element_size()
                for x in batch_specs(cfg, SHAPES["train_4k"]).values())
    return state, batch


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_dry_run_pod_cells_hold_rank0s_blocks(dry_cells, mesh):
    """A reduced train_4k cell on each production mesh: status ok, JAX's
    microbatch default (16 on 16x16, 8 on 2x16x16), rank 0's argument
    bytes those of its blocks under the rules, collectives non-zero by
    kind, one grouped bgl_sumsq launch and one backward (microbatches 1)."""
    rec = dry_cells[mesh]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == mesh and rec["microbatches"] == {"16x16": 16, "2x16x16": 8}[mesh]
    state, batch = _rule_bytes(dryrun.MESHES[mesh])
    assert rec["memory"]["argument_bytes"] == state + batch
    coll = rec["roofline"]["collectives"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert rec["roofline"]["collective_bytes_per_device"] == sum(coll.values())
    assert rec["roofline"]["n_devices"] == (256 if mesh == "16x16" else 512)
    assert rec["roofline"]["kernel_launches"] == {"bgl_sumsq": 1, "bgl_sumsq_backward": 1}


def test_parameters_are_not_split_over_pod(dry_cells):
    """The state's bytes of rank 0 are the same on 16x16 and 2x16x16 (no
    rule names "pod" for a leaf); only the batch's halve."""
    one, two = (_rule_bytes(dryrun.MESHES[m]) for m in ("16x16", "2x16x16"))
    assert one[0] == two[0] and one[1] == 2 * two[1]
    a, b = (dry_cells[m]["memory"]["argument_bytes"] for m in ("16x16", "2x16x16"))
    assert a - b == one[1] - two[1]


def test_one_decode_layers_collectives_equal_a_hand_count():
    """One decode layer of granite (reduced widths, 16 heads of 4 so the
    heads split over "model"; 6-bit packed, f32) on 16x16, B 128: the
    collective bytes a second layer adds equal the count from the rules.

    The rules (``param_spec`` on the packed sign bytes) split K/8 = 8
    rows over no axis, so wq, wk, wv and wo each gather their whole N
    over its axis, with no K reduction; the cache's lanes split over
    "data" and its 16 K/V heads over "model" (``cache_spec``), so the
    attention output is gathered over its heads, then over its lanes; the
    MLP's gate and up products keep each rank's d_ff columns (a Megatron
    pair) and w_down (K/8 = 32 rows over "model", N over "data") reduces
    its partial sums over "model", then gathers N over "data"."""
    d, H, hd, f, lanes = 64, 16, 4, 256, 128
    mesh = SimpleNamespace(shape={"data": 16, "model": 16})
    f32 = 4

    def stitched(name, K, N):  # x whole @ a packed (K, N): (K reduce, N gather) bytes
        k_ax, n_ax = ts.param_spec(f"blocks/p0/{name}/sign", (1, K // 8, N), mesh)[-2:]
        n_local = N // ts.axis_size(mesh, n_ax)
        return (lanes * n_local * f32 if k_ax else 0), (lanes * N * f32 if n_ax else 0)

    want = {"all-reduce": 0, "all-gather": 0}
    for name, K, N in (("attn/wq", d, H * hd), ("attn/wk", d, H * hd), ("attn/wv", d, H * hd),
                       ("attn/wo", H * hd, d)):
        r, g = stitched(name, K, N)
        want["all-reduce"] += r
        want["all-gather"] += g
    b_ax, _, kv_ax, _ = ts.cache_spec("k", (lanes, 32768, H, hd), mesh)
    lanes_local = lanes // ts.axis_size(mesh, b_ax)
    want["all-gather"] += lanes_local * H * hd * f32  # over the heads ("model")
    want["all-gather"] += lanes * H * hd * f32  # over the lanes ("data")
    assert (b_ax, kv_ax) == ("data", "model")
    k_ax, n_ax = ts.param_spec("blocks/p0/mlp/w_down/sign", (1, f // 8, d), mesh)[-2:]
    assert (k_ax, n_ax) == ("model", "data")
    want["all-reduce"] += lanes * (d // 16) * f32
    want["all-gather"] += lanes * d * f32

    got = []
    for n_layers in (1, 2):
        cfg = reduced_config(GRANITE).scaled(n_layers=n_layers, n_heads=H, n_kv_heads=H,
                                             d_ff=f)
        got.append(dryrun.run_meta(cfg, SHAPES["decode_32k"], "bsq", 1, 6,
                                   {"data": 16, "model": 16})[0].collectives)
    layer = {k: got[1][k] - got[0][k] for k in want}
    assert layer == want


def test_meta_mesh_lives_only_inside_its_with():
    """The fake process group is destroyed after the cell, so nothing later
    in the process sees an initialised torch.distributed."""
    import torch.distributed as dist

    with meta_mesh({"pod": 2, "data": 16, "model": 16}) as mesh:
        assert dist.is_initialized() and mesh.size() == 512
        assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
        t = mesh.all_reduce(torch.empty(3, device="meta"), ("pod", "data"))
        assert t.device.type == "meta" and mesh.collectives == 1  # one group: both axes
    assert not dist.is_initialized()
    rec = dryrun.run_cell(GRANITE, "decode_32k", multi_pod=True, verbose=False,
                          cfg_override=reduced_config(GRANITE))
    assert rec["status"] == "ok" and not dist.is_initialized()
