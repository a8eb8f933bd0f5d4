"""The window's arithmetic: tails over every sample, tokens counted by
their timestamps at the window's edges."""
import pytest

from perfbench.harness import window


def test_percentile_over_every_sample():
    xs = list(range(1, 101))
    assert window.percentile(xs, 90) == pytest.approx(90.1)
    assert window.percentile(xs, 50) == pytest.approx(50.5)
    assert window.percentile([], 90) is None
    assert window.percentile([7.0], 95) == 7.0


def test_tokens_count_by_timestamp_at_the_edges():
    reqs = {1: [0.5, 1.0, 1.5, 2.0], 2: [1.9, 2.0, 3.0, 3.1]}
    # [1.0, 3.0] holds 1.0, 1.5, 2.0 of the first and 1.9, 2.0, 3.0 of the second
    assert window.tokens_in_window(reqs.values(), 1.0, 3.0) == 6


def test_ttft_from_send_of_first_tokens_inside():
    sent = {1: 0.0, 2: 1.0, 3: 2.5}
    tokens = {1: [0.5, 1.0], 2: [1.25, 1.5], 3: [3.5]}
    s = window.window_summary(tokens, sent, 1.0, 3.0)
    assert s["first_tokens"] == 1 and s["ttft_p90_ms"] == pytest.approx(250.0)


def test_gaps_need_both_ends_inside():
    tokens = {1: [0.5, 1.0, 1.5, 2.0, 3.5]}
    gaps = window.gaps_in_window(tokens.values(), 1.0, 3.0)
    assert gaps == pytest.approx([500.0, 500.0])


def test_summary_rate_is_over_the_whole_window():
    tokens = {u: [1.0 + 0.1 * i for i in range(10)] for u in range(5)}
    s = window.window_summary(tokens, {u: 0.9 for u in tokens}, 1.0, 3.0)
    assert s["serve_tokens_per_s"] == pytest.approx(50 / 2.0)
    assert s["itl_p95_ms"] == pytest.approx(100.0)
