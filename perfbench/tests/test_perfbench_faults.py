"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, with the harness's
look for a chip skipped (a small cell on the CPU).  One chip: no
exchange between chips to leave out."""
import contextlib
import time
from unittest import mock

import pytest
import torch

from perfbench.harness.report import measure
from perfbench.tests._tiny import tiny_cell, workloads

SEED = 2**31 + 77


def _run(workload, patches=None):
    return measure(tiny_cell(workload), SEED, 1.0, False, torch.device("cpu"), time.perf_counter(),
                   patches=patches)


# -- serving ---------------------------------------------------------------
def token_altered():
    """At every fifth sampling call each lane's token is replaced, where it
    is sampled, by its least likely one: each request of a few tokens
    carries one."""
    from repro_torch.serve.engine import ServeEngine

    real = ServeEngine._sample
    calls = [0]

    def sample(self, logits, temperatures, any_hot):
        out = real(self, logits, temperatures, any_hot)
        calls[0] += 1
        if calls[0] % 5 == 0:
            out = torch.argmin(logits[:, : self.cfg.vocab_size], dim=-1).to(out.dtype)
        return out

    return mock.patch.object(ServeEngine, "_sample", sample)


def decode_state_unchanged():
    """The decode step writes no K/V row: it leaves the cache as it was."""
    from repro_torch.models import attention

    return mock.patch.object(attention, "_paged_write", lambda *a, **k: None)


def half_the_batch():
    """The decode step's second half of lanes is left out: their logits are the first half's."""
    from repro_torch.models import transformer

    real = transformer.decode_step

    def step(*a, **k):
        logits, cache = real(*a, **k)
        n = logits.shape[0]
        logits = logits.clone()
        logits[n - n // 2:] = logits[: n // 2]
        return logits, cache

    return mock.patch.object(transformer, "decode_step", step)


# -- training --------------------------------------------------------------
def train_state_unchanged():
    """The optimiser's update returns the state it was given."""
    from repro_torch.optim import SGDM

    return mock.patch.object(SGDM, "update", lambda self, g, state, params, lr: (params, state))


def train_half_the_batch():
    """The loss is the mean over the first half of the tokens alone."""
    from repro_torch.train import step as step_mod

    real = step_mod.cross_entropy_sums

    def half(logits, labels):
        labels = labels.clone()
        labels[..., labels.shape[-1] // 2:] = -1
        return real(logits, labels)

    return mock.patch.object(step_mod, "cross_entropy_sums", half)


@pytest.mark.parametrize("workload", workloads())
def test_a_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [token_altered, decode_state_unchanged, half_the_batch])
@pytest.mark.parametrize("workload", workloads("serve_closed_loop"))
def test_a_serving_fault_is_not_correct(workload, fault):
    out = _run(workload, fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [train_state_unchanged, train_half_the_batch])
@pytest.mark.parametrize("workload", workloads("train_steps"))
def test_a_training_fault_is_not_correct(workload, fault):
    out = _run(workload, fault)
    assert not out["correct"], out["checks"]
