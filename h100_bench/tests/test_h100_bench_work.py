"""The counts behind every roofline and MFU, held against hand counts at
one small shape."""

import pytest

from h100_bench import work

D = work.DecoderShape(layers=2, hidden=8, intermediate=16, heads=2,
                      kv_heads=1, vocab=10)


def test_decoder_params_by_hand():
    # q 8x8, k 8x4, v 8x4, o 8x8, gate/up/down 3 x 8x16
    assert D.layer_matmul_params() == 64 + 32 + 32 + 64 + 384
    assert D.matmul_params() == 2 * 576 + 80
    mpt = work.DecoderShape(1, 8, 32, 2, 2, 10, glu=False)
    assert mpt.layer_matmul_params() == 4 * 64 + 2 * 8 * 32


def test_prefill_and_decode_flops_by_hand():
    # 3 tokens, 6 causal pairs: 2 layers x (2 x 576 x 3 + 4 x 2 x 4 x 6),
    # the head on one row: 2 x 10 x 8
    assert work.prefill_flops(D, 3) == 2 * (3456 + 192) + 160
    # one token over 5 slots
    assert work.decode_token_flops(D, 5) == 2 * (1152 + 160) + 160


def test_vision_flops_by_hand():
    v = work.VisionShape(layers_run=1, hidden=4, intermediate=8, image=4,
                         patch=2, projector_out=6, projector_layers=2)
    embed = 2 * 4 * 12 * 4                 # 4 patches of 3*2*2 inputs
    layer = 2 * 5 * (4 * 16 + 2 * 4 * 8) + 4 * 4 * 25
    proj = 2 * 4 * (4 * 6 + 6 * 6)
    assert work.vision_flops(v, 1) == embed + layer + proj
    assert work.vision_flops(v, 3) == 3 * (embed + layer + proj)


def test_paged_launch_by_hand():
    ops, nbytes = work.paged_attention_launch([3, 5], heads=4, kv_heads=2,
                                              head_dim=8)
    assert ops == 4 * 4 * 8 * 8
    # K and V: 2 x 2 heads x 8 x 8 slots; q and out: 2 x 2 rows x 4 x 8
    assert nbytes == (256 + 128) * 2


def test_round_paged_work_by_hand():
    ops, nbytes, launches, rows_steps = work.round_paged_work(
        [2, 0], [3, 5], [True, False], steps=2, layers=3, heads=4,
        kv_heads=2, head_dim=8)
    assert ops == 3 * (4 * 4 * 8 * 3 + 4 * 4 * 8 * 4)
    assert nbytes == 3 * ((96 + 64) * 2 + (128 + 64) * 2)
    assert (launches, rows_steps) == (6, 2)
    # a budget that ends inside the round stops the row
    _, _, _, rows = work.round_paged_work([4], [1], [True], 8, 1, 4, 2, 8)
    assert rows == 1


def test_roofline_takes_the_longer_bound():
    assert work.roofline_seconds(989e12, 0) == pytest.approx(1.0)
    assert work.roofline_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert work.roofline_seconds(989e9, 3.35e12) == pytest.approx(1.0)


def test_flash_bwd_work_by_hand():
    # one row of 3 tokens: 6 pairs; 2 heads, 1 kv head, Dh 4, 2 layers
    ops, nbytes = work.flash_bwd_work([3], 2, 1, 4, 2)
    assert ops == 2 * 5 * 2 * 2 * 4 * 6
    # q, o, dO, dq at 2 heads and k, v, dk, dv at 1, bf16; lse f32
    assert nbytes == 2 * (3 * 4 * 2 * (4 * 2 + 4 * 1) + 3 * 2 * 4)


def test_train_step_flops_by_hand():
    v = work.VisionShape(1, 4, 8, 4, 2, 6, 2)
    rows, labelled, lora = [3, 2], 2, 10
    tokens, pairs = 5, 6 + 3
    base = 2 * 2 * 576 * tokens
    attn = 4 * 2 * 4 * pairs * 2
    head = 2 * 10 * 8 * labelled
    lo = 2 * 2 * lora * tokens
    proj_w = 2 * 4 * 1 * (4 * 6 + 6 * 6)
    want = (base + attn + head + lo) + (base + 2 * attn + head + 3 * lo) \
        + work.vision_flops(v, 1) + proj_w
    assert work.train_step_flops(D, v, rows, labelled, 1, lora) == want
