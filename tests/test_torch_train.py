"""The port's BSQ training against the JAX package on reduced
granite-3-2b in f32: train steps from the bridged JAX state, gradient
accumulation, checkpoint interchange both ways, the trainer's resume,
the optimizers, schedules and the input pipeline.

Tolerances: per-step loss, reg and total within 1e-5 relative, planes
and float params within 1e-5 absolute (f32 sums in another order; a
fused multiply-add where XLA rounds twice); optimizer updates 1e-6
relative; step-decay learning rates and checkpoint leaves exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import reduced_config as j_reduced_config
from repro.core import BSQConfig as JBSQConfig
from repro.data import sharded_lm_iterator as j_sharded_lm_iterator
from repro.optim import SGDM as JSGDM
from repro.optim import AdamW as JAdamW
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import cosine_warmup as j_cosine
from repro.optim import step_decay as j_step_decay
from repro.train import step as jstep
from repro_torch import bridge
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import reduced_config
from repro_torch.core import BSQConfig
from repro_torch.data import (MarkovLM, Prefetcher, host_slice, pack_documents,
                              sharded_lm_iterator)
from repro_torch.launch import train as launcher
from repro_torch.optim import SGDM, AdamW, clip_by_global_norm, cosine_warmup, step_decay
from repro_torch.train import (TrainerConfig, init_bsq_state, make_bsq_train_step,
                               make_requant_step, train_bsq)
from repro_torch.tree import flatten_with_path, tree_map

ARCH = "granite-3-2b"
STEPS = 3


def _batches(n, B=4, S=16):
    task = MarkovLM(vocab=512, seed=13)
    return [task.batch(np.random.default_rng(i), B, S) for i in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's state and 3 jitted train steps (lr decays at step 2)."""
    jcfg = j_reduced_config(ARCH)
    jbsq = JBSQConfig(n_init=8, alpha=5e-3, compute_dtype=jnp.float32)
    # jitted init (eager JAX init takes seconds); the context from the
    # shapes-only twin
    _, jctx = jstep.abstract_bsq_state(jcfg, jbsq, JSGDM())
    state0 = jax.jit(lambda k: jstep.init_bsq_state(k, jcfg, jbsq, JSGDM())[0])(
        jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_bsq_train_step(jctx, JSGDM(), j_step_decay(0.2, [2])))
    states, metrics, s = [], [], state0
    for b in _batches(STEPS):
        s, m = step(s, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(jax.tree.map(np.array, s))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"state0": jax.tree.map(np.array, state0), "meta": jctx.meta, "states": states,
            "metrics": metrics}


def _port(jax_run):
    """The bridged JAX state, and the port's context for it (from a port
    init of the same config, whose reps carry the same meta)."""
    _, ctx = init_bsq_state(torch.Generator(), reduced_config(ARCH),
                            BSQConfig(n_init=8, alpha=5e-3, compute_dtype=torch.float32),
                            SGDM(), "cpu")
    assert ctx.meta == jax_run["meta"]
    return bridge.bsq_state_from_jax(jax_run["state0"], jax_run["meta"]), ctx


def test_bsq_train_steps_match_jax(jax_run):
    state, ctx = _port(jax_run)
    step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [2]))
    for i, b in enumerate(_batches(STEPS)):
        state, m = step(state, _torch_batch(b))
        for k in ("ce", "reg", "total", "grad_norm"):
            want = jax_run["metrics"][i][k]
            assert abs(float(m[k]) - want) <= 1e-5 * abs(want), (i, k, float(m[k]), want)
        assert m["lr"] == jax_run["metrics"][i]["lr"]
        want_leaves = dict(flatten_with_path(jax_run["states"][i]))
        for name, x in flatten_with_path(state):
            np.testing.assert_allclose(x.numpy(), want_leaves[name], rtol=0, atol=1e-5,
                                       err_msg=f"step {i} {name}")
    assert int(state["step"]) == STEPS and state["step"].dtype == torch.int32


@pytest.mark.parametrize("hoist", [True, False])
def test_microbatches_match_one_batch(jax_run, hoist):
    """microbatches=2 (hoisted reconstruction and not) against 1: the same
    metrics and updated planes, gradients being linear in the batch."""
    b = _torch_batch(_batches(1, B=8)[0])
    out = []
    for mb in (1, 2):
        state, ctx = _port(jax_run)
        step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [2]), microbatches=mb,
                                   hoist_reconstruct=hoist)
        out.append(step(state, b))
    (s1, m1), (s2, m2) = out
    for k in ("ce", "reg", "total", "grad_norm"):
        assert abs(float(m2[k]) - float(m1[k])) <= 1e-5 * abs(float(m1[k])), k
    for (name, x), (_, y) in zip(flatten_with_path(s1), flatten_with_path(s2)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_decoupled_reg_clip_runs_the_kernel_twice_and_stays_finite(jax_run):
    from repro_torch.kernels import ops

    state, ctx = _port(jax_run)
    calls = []
    orig = ops.bgl_sumsq_grouped
    ops.bgl_sumsq_grouped = lambda xs: calls.append(len(xs)) or orig(xs)
    try:
        step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [2]), decouple_reg_clip=True)
        state, m = step(state, _torch_batch(_batches(1)[0]))
    finally:
        ops.bgl_sumsq_grouped = orig
    # one grouped call (wp and wn of every tensor) each for task+reg and reg-only
    assert calls == [2 * len(ctx.meta)] * 2
    assert all(np.isfinite(float(v)) for v in m.values())


def test_checkpoints_interchange_with_jax(jax_run, tmp_path):
    """A JAX checkpoint restores into the port's state, and the port's
    into JAX's, leaf for leaf and bit for bit, with the same files."""
    jstate = jax_run["states"][-1]
    jckpt.save(jstate, str(tmp_path / "j"), 3)
    port_template, _ = _port(jax_run)
    restored, step = ckpt.restore_latest(port_template, str(tmp_path / "j"))
    assert step == 3
    want = dict(flatten_with_path(jstate))
    for name, x in flatten_with_path(restored):
        assert x.dtype == torch.from_numpy(np.asarray(want[name])).dtype, name
        np.testing.assert_array_equal(x.numpy(), want[name], err_msg=name)
    state, _ = _port(jax_run)
    state["step"] = torch.tensor(7, dtype=torch.int32)
    ckpt.save(state, str(tmp_path / "t"), 7, blocking=False).join()
    back = jckpt.restore(jax_run["state0"], str(tmp_path / "t"), 7)
    for name, x in flatten_with_path(state):
        np.testing.assert_array_equal(np.asarray(dict(flatten_with_path(back))[name]), x.numpy())
    assert sorted(p.name for p in (tmp_path / "t" / "step_7").iterdir()) == sorted(
        p.name for p in (tmp_path / "j" / "step_3").iterdir())
    assert ckpt.available_steps(str(tmp_path / "t")) == [7]


def test_checkpoint_detects_corruption_and_prunes(tmp_path, jax_run):
    state, _ = _port(jax_run)
    for s in (1, 2, 3):
        ckpt.save(state, str(tmp_path), s)
    ckpt.prune_old(str(tmp_path), keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [2, 3]
    with open(tmp_path / "step_3" / "shard_0.npz", "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError, match="integrity"):
        ckpt.restore(state, str(tmp_path), 3)
    _, step = ckpt.restore_latest(state, str(tmp_path))
    assert step == 2


def test_train_bsq_resumes_from_its_own_checkpoint(tmp_path, capsys):
    """4 steps with checkpoints at 2 and 4, then a fresh run to 6 resumes at
    4: its final state equals steps 4-5 replayed from the step-4 checkpoint."""
    cfg = reduced_config(ARCH)
    bsq_cfg = BSQConfig(n_init=8, alpha=5e-3, compute_dtype=torch.float32)
    opt = SGDM()

    def run(total):
        state, ctx = init_bsq_state(torch.Generator().manual_seed(0), cfg, bsq_cfg, opt, "cpu")
        data = sharded_lm_iterator(MarkovLM(vocab=512, seed=13), 4, 16, device="cpu")
        tcfg = TrainerConfig(total_steps=total, requant_interval=3, ckpt_interval=2,
                             log_interval=1, workdir=str(tmp_path))
        return train_bsq(state, ctx, make_bsq_train_step(ctx, opt, step_decay(0.2, [5])),
                         make_requant_step(ctx), data, tcfg), ctx

    first, ctx = run(4)
    assert [h["step"] for h in first["history"]] == [1, 2, 3, 4]
    second, _ = run(6)
    assert "[trainer] resumed from step 4" in capsys.readouterr().out
    assert [h["step"] for h in second["history"]] == [5, 6]
    assert int(second["state"]["step"]) == 6
    # replay: restore step 4 and take the same two steps
    template, _ = init_bsq_state(torch.Generator().manual_seed(1), cfg, bsq_cfg, opt, "cpu")
    state = ckpt.restore(template, str(tmp_path), 4)
    step = make_bsq_train_step(ctx, opt, step_decay(0.2, [5]))
    data = sharded_lm_iterator(MarkovLM(vocab=512, seed=13), 4, 16, device="cpu")
    for _ in range(2):
        state, _ = step(state, next(data))
    state = make_requant_step(ctx)(state)
    for (name, x), (_, y) in zip(flatten_with_path(state), flatten_with_path(second["state"])):
        assert torch.equal(x, y), name
    assert (tmp_path / "scheme.json").exists() and (tmp_path / "history.json").exists()
    assert ckpt.available_steps(str(tmp_path)) == [2, 4, 6]


# ---------------------------------------------------------------------------
# optimizers, schedules, pipeline
# ---------------------------------------------------------------------------


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (5, 3), "b": (3,)}, "c": (4,)}
    return [jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]


@pytest.mark.parametrize("name", ["sgdm", "sgdm_nesterov", "adamw"])
def test_optimizers_match_jax(name):
    jopt, opt = {
        "sgdm": (JSGDM(), SGDM()),
        "sgdm_nesterov": (JSGDM(nesterov=True, weight_decay=0.01),
                          SGDM(nesterov=True, weight_decay=0.01)),
        "adamw": (JAdamW(), AdamW()),
    }[name]
    params, g1, g2 = _trees(0)
    jp, js = params, jopt.init(params)
    tp = tree_map(torch.from_numpy, params)
    ts = opt.init(tp)
    for g in (g1, g2):
        jp, js = jopt.update(g, js, jp, 0.05)
        tp, ts = opt.update(tree_map(torch.from_numpy, tree_map(np.copy, g)), ts, tp, 0.05)
    for (n, x), (_, y) in zip(flatten_with_path(tp), flatten_with_path(jp)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _trees(1)[0]
    jg, jn = j_clip(g, max_norm)
    tg, tn = clip_by_global_norm(tree_map(lambda x: torch.from_numpy(x.copy()), g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for (n, x), (_, y) in zip(flatten_with_path(tg), flatten_with_path(jg)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, err_msg=n)


def test_schedules_match_jax():
    jsd, sd = j_step_decay(0.2, [3, 7], 0.1), step_decay(0.2, [3, 7], 0.1)
    jcw, cw = j_cosine(0.3, 4, 20), cosine_warmup(0.3, 4, 20)
    for s in range(25):
        assert sd(s) == float(jsd(jnp.int32(s)))
        np.testing.assert_allclose(cw(s), float(jcw(jnp.int32(s))), rtol=1e-6)


def test_pipeline_matches_jax():
    assert host_slice(8, 1, 4) == slice(2, 4)
    with pytest.raises(ValueError):
        host_slice(6, 0, 4)
    from repro.data import pack_documents as j_pack

    docs = [[5, 6, 7], [8, 9], [10, 11, 12, 13]]
    for a, b in zip(pack_documents(docs, 4), j_pack(docs, 4)):
        np.testing.assert_array_equal(a, b)
    task = MarkovLM(vocab=512, seed=13)
    ours = sharded_lm_iterator(task, 4, 8, seed=3, device="cpu")
    theirs = j_sharded_lm_iterator(task, 4, 8, seed=3)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int64
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    with pytest.raises(NotImplementedError, match="mesh"):
        sharded_lm_iterator(task, 4, 8, device="cpu", sharding=object())

    def bad():
        yield 1
        raise KeyError("boom")

    it = Prefetcher(bad())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


def test_bridge_checks_the_state_against_the_meta(jax_run):
    meta = dict(jax_run["meta"])
    meta["embed"] = (8, (0,))
    with pytest.raises(ValueError, match="embed"):
        bridge.bsq_state_from_jax(jax_run["state0"], meta)
    state, _ = _port(jax_run)
    assert state["step"].device.type == "cpu" and state["step"].ndim == 0


def test_launcher_trains_on_cpu_and_mesh_flags_raise(tmp_path):
    out = launcher.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "8",
                         "--requant-interval", "2", "--ckpt-interval", "2",
                         "--workdir", str(tmp_path)])
    assert out["scheme"].bits_per_param > 0 and int(out["state"]["step"]) == 3
    assert ckpt.available_steps(str(tmp_path)) == [2]
    plain = launcher.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
                           "--technique", "plain"])
    assert len(plain["history"]) == 1
    for flag in ("--data-parallel", "--model-parallel"):
        with pytest.raises(NotImplementedError, match="mesh"):
            launcher.main(["--device", "cpu", flag, "2"])
