"""The plain reference against the program at a small size in float32 on
the CPU: the same weights give the same logits, the same BSQ step the
same objective, gradients and update."""
from unittest import mock

import pytest
import torch

from perfbench.counts.model import LM
from perfbench.drivers.train_steps import _state_leaves
from perfbench.harness import program, weights
from perfbench.reference import bsq as ref_bsq
from perfbench.reference.lm import Model
from perfbench.tests._tiny import tiny_cell, workloads


# each serving cell's configuration, and its MoE form (the reference's
# routed path: experts top-k of 6, one shared)
MOE = {"n_experts": 6, "top_k": 2, "n_shared_experts": 1, "capacity_factor": 3.0, "d_ff": 32,
       "family": "moe"}


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("workload", workloads("serve_closed_loop"))
def test_served_logits_match_the_program(workload, moe):
    from repro_torch.core.packing import pack_model_params, packed_leaves
    from repro_torch.models import transformer

    conf = tiny_cell(workload).config
    if moe:
        conf["program"].update(MOE)
    lm = LM.from_program(conf["program"])
    cfg = program.model_config(conf["program"])
    w = weights.make_flat(lm, 2**31 + 99, "cpu", torch.float32)
    packed = pack_model_params(weights.nest(w), 6)
    assert packed_leaves(packed)  # the 6-bit path is what is compared
    tokens = torch.randint(0, lm.vocab, (1, 40), generator=torch.Generator().manual_seed(1))
    got, _ = transformer.forward(packed, {"tokens": tokens}, cfg)
    ref = Model(conf["program"], w, conf["serve"]["packed_leaves"])
    want = ref.logits([tokens[0]], [torch.arange(40)])[0]
    torch.testing.assert_close(got[0, :, :lm.vocab], want, rtol=1e-4, atol=1e-4)
    # the reference's 6-bit values are the program's, not the float weights
    plain = Model(conf["program"], w, [])
    assert (plain.logits([tokens[0]], [torch.arange(40)])[0] - want).abs().max() > 1e-3


def test_bsq_steps_match_the_program():
    from repro_torch.core.bsq import BSQConfig
    from repro_torch.models import transformer
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train.step import init_bsq_state, make_bsq_train_step

    conf = tiny_cell(workloads("train_steps")[0]).config
    prog, bsq = conf["program"], conf["bsq"]
    lm = LM.from_program(prog)
    cfg = program.model_config(dict(prog, dtype="float32"))
    w0 = weights.make_flat(lm, 7, "cpu", torch.float32)
    given = weights.nest({k: v.clone() for k, v in w0.items()})
    opt = SGDM(momentum=bsq["momentum"], weight_decay=bsq["weight_decay"])
    bcfg = BSQConfig(n_init=bsq["n_init"], n_max=bsq["n_max"], alpha=bsq["alpha"],
                     compute_dtype=torch.float32)
    with mock.patch.object(transformer, "init_params", lambda *a, **k: given):
        state, ctx = init_bsq_state(torch.Generator(), cfg, bcfg, opt, "cpu")
    step = make_bsq_train_step(ctx, opt, step_decay(bsq["lr"], []), grad_clip=bsq["grad_clip"])
    rows = torch.randint(0, lm.vocab, (2, 1, 33), generator=torch.Generator().manual_seed(3))
    batches = [(r[:, :-1], r[:, 1:]) for r in rows]
    losses = []
    for tok, lab in batches:
        state, m = step(state, {"tokens": tok, "labels": lab})
        losses.append(float(m["total"]))
    ref = ref_bsq.follow(prog, w0, sorted(ctx.meta), bsq, batches)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    now = _state_leaves(state["trainable"])
    for name, t0 in ref_bsq.initial_leaves(w0, sorted(ctx.meta), bsq):
        got = float(torch.linalg.vector_norm(now[name] - t0))
        assert got == pytest.approx(ref["change_norms"][name], rel=1e-3, abs=1e-7), name
