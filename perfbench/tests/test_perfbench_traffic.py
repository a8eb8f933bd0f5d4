"""The traffic generator: one seed gives the same requests, two seeds
differ in order and content but never in the work."""
import json

import numpy as np

from perfbench.harness import traffic
from perfbench.harness.cell import BENCH

CHAT = dict(json.loads((BENCH / "traffic" / "chat.json").read_text()), backlog=300)
BIG_SEED = 2**31 + 12345


def test_same_seed_same_requests():
    a = traffic.chat_requests(CHAT, 16, BIG_SEED, 49155)
    b = traffic.chat_requests(CHAT, 16, BIG_SEED, 49155)
    assert len(a) == 16 + 300
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))


def test_two_seeds_differ_but_hold_the_same_work():
    a = traffic.chat_requests(CHAT, 16, BIG_SEED, 49155)
    b = traffic.chat_requests(CHAT, 16, BIG_SEED + 1, 49155)
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    assert [len(x[0]) for x in a] != [len(x[0]) for x in b]
    assert sorted(len(x[0]) for x in a) == sorted(len(x[0]) for x in b)
    # the first wave's outputs and the backlog's are each the same multiset
    assert sorted(x[1] for x in a[:16]) == sorted(x[1] for x in b[:16])
    assert sorted(x[1] for x in a[16:]) == sorted(x[1] for x in b[16:])


def test_lengths_follow_the_mix():
    p = traffic.lognormal_lengths(CHAT["prompt_tokens"], 4096)
    assert p.min() >= 1 and p.max() == 3072 and np.median(p) == 1020
    r = traffic.residual_lengths(CHAT["output_tokens"], 128)
    full = traffic.lognormal_lengths(CHAT["output_tokens"], 4096)
    assert np.median(full) == 129 and full.min() == 4 and full.max() == 1024
    # what is left of a request found in flight: mean E[L(L+1)] / 2E[L]
    # (longer than a request where lengths spread as widely as these)
    want = (full.astype(float) * (full + 1)).mean() / (2 * full.mean())
    assert 1 <= r.min() and r.max() <= 1024 and abs(r.mean() / want - 1) < 0.05


def test_the_mix_gives_its_sources_statistics():
    """The fitted lognormals give the published medians and, but for the
    cuts at the tails, the published means."""
    for key, ratio in (("prompt_tokens", 0.99), ("output_tokens", 0.95)):
        src, spec = CHAT["source_statistics"][key], CHAT[key]
        assert spec["median"] == src["median"]
        unclipped = dict(spec, min=0, max=10**9)
        assert abs(traffic.lognormal_lengths(unclipped, 1 << 16).mean() / src["mean"] - 1) < 0.01
        # what the cuts take off the mean
        assert traffic.lognormal_lengths(spec, 1 << 16).mean() > ratio * src["mean"]


def test_tokens_lie_in_the_vocabulary():
    for toks, n in traffic.chat_requests(CHAT, 4, 7, 1000):
        assert toks.min() >= 0 and toks.max() < 1000 and n >= 1


def test_markov_rows_are_seeded():
    a = traffic.markov_rows({"successors": 8}, BIG_SEED, 500, 3, 64)
    b = traffic.markov_rows({"successors": 8}, BIG_SEED, 500, 3, 64)
    c = traffic.markov_rows({"successors": 8}, BIG_SEED + 1, 500, 3, 64)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len({tuple(r) for r in a}) == 3  # rows that all differ


def test_every_block_holds_each_stratum():
    rng = np.random.default_rng(3)
    vals = traffic.lognormal_lengths(CHAT["prompt_tokens"], 64)
    order = traffic.stratified_order(vals, rng, 16)
    assert sorted(order) == sorted(vals)
    strata = np.sort(vals).reshape(16, -1)
    for b in range(4):
        blk = np.sort(order[16 * b:16 * (b + 1)])
        # one value from each stratum's range in every block of 16
        assert all(strata[i].min() <= blk[i] <= strata[i].max() for i in range(16))
