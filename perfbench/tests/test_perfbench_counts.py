"""Each count against a hand count."""
import pytest

from perfbench.counts import HBM_BW, bgl_sumsq, bitserial_matmul, paged_attention, peak_flops
from perfbench.counts.model import LM

GRANITE = dict(n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
               vocab_size=49155, tie_embeddings=True)


def test_peaks_are_the_data_sheet():
    assert peak_flops("bfloat16") == 989e12 and HBM_BW == 3.35e12


def test_bitserial_launch_by_hand():
    # x (4, 16) bf16, 6 planes + sign of 2 bytes a column for 8 columns, one scale,
    # out (4, 8) bf16
    flops, nbytes = bitserial_matmul.work(4, 16, 8, 6)
    assert flops == 2 * 4 * 16 * 8
    assert nbytes == 4 * 16 * 2 + 7 * 2 * 8 + 4 + 4 * 8 * 2
    assert bitserial_matmul.least(4, 16, 8, 6) == pytest.approx(nbytes / 3.35e12)
    # a large prefill launch is bound by its operations
    assert bitserial_matmul.least(16384, 2048, 8192, 6) == pytest.approx(
        2 * 16384 * 2048 * 8192 / 989e12)


def test_paged_attention_by_hand():
    # two live lanes with 3 and 5 rows, 4 heads on 2 K/V heads of 8
    flops, nbytes = paged_attention.work([3, 5], H=4, kv=2, d=8)
    assert flops == 4 * 4 * 8 * 8
    assert nbytes == 8 * 2 * 8 * 2 * 2 + 2 * 4 * 8 * 2 * 2


def test_bgl_sumsq_by_hand():
    assert bgl_sumsq.work(1000, 10) == (2000.0, 4000.0 + 40.0)
    assert bgl_sumsq.work(1000, 10, backward=True) == (2000.0, 8000.0 + 40.0)


def test_granite_widths_by_hand():
    lm = LM.from_program(GRANITE)
    per_layer = 2048 * 2048 * 2 + 2048 * 512 * 2 + 3 * 2048 * 8192
    assert lm.layer_active_params() == per_layer
    assert lm.active_params() == 40 * per_layer + 2048 * 49155
    assert lm.padded_vocab == 49408
    assert lm.token_flops(9) == pytest.approx(2 * lm.active_params() + 4 * 40 * 32 * 64 * 10)
    assert lm.tokens_flops(3, 4) == pytest.approx(sum(lm.token_flops(p) for p in range(3, 7)))


def test_granite_packed_launches():
    lm = LM.from_program(GRANITE)
    assert lm.kv_bytes_per_token() == 80 * 1024  # 40 layers x K and V x 8 heads x 64 x bf16
    packed = ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"]
    calls = lm.packed_launches(packed, 128, 128)
    assert len(calls) == 40 * 7  # the tied head is the embedding, in bf16
    assert calls[:7] == [(128, 2048, 2048), (128, 2048, 512), (128, 2048, 512),
                         (128, 2048, 2048), (128, 2048, 8192), (128, 2048, 8192),
                         (128, 8192, 2048)]


def test_qwen_moe_counts():
    lm = LM.from_program(dict(n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
                              vocab_size=151936, n_experts=60, top_k=4, n_shared_experts=4))
    attn = 4 * 2048 * 2048
    expert = 3 * 2048 * 1408
    assert lm.layer_active_params() == attn + 2048 * 60 + 4 * expert + 4 * expert
    calls = lm.packed_launches(["wq", "wk", "wv", "wo", "lm_head"], 8192, 64)
    assert len(calls) == 24 * 4 + 1 and calls[-1] == (64, 2048, 152064)


def test_bsq_state_by_hand():
    lm = LM.from_program(dict(GRANITE, n_layers=2))
    q = 49408 * 2048 + 2 * (2 * 2048 * 2048 + 2 * 2048 * 512 + 3 * 2048 * 8192)
    assert lm.quantised_params() == q
    # wp, wn and their momentum, 9 f32 planes each, read and written
    assert lm.bsq_state_bytes(9) == 2 * 2 * 9 * 2 * 4 * q
    assert lm.bsq_step_least(9, 4096, 1) == pytest.approx(lm.bsq_state_bytes(9) / 3.35e12)
    assert lm.train_flops(4096, 1) == pytest.approx(
        6 * lm.active_params() * 4096 + 3 * 4 * 2 * 32 * 64 * 4096 * 4097 / 2)
