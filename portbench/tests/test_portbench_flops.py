"""The benchmark's FLOP and byte counts."""

from portbench import flops, model_config

from .tiny import TINY


def test_published_parameter_counts():
    assert model_config.load("mistral-7b-v0.3").param_count() \
        == 7_248_023_552
    nemo = model_config.load("mistral-nemo-12b")
    assert nemo.param_count() == 12_247_782_400
    assert nemo.q_width == 4096 != nemo.hidden


def test_causal_pairs_by_counting():
    for new in (1, 5, 17):
        for before in (0, 3, 64):
            want = sum(before + i + 1 for i in range(new))
            assert flops.causal_pairs(new, before) == want


def test_prefill_and_decode_flops():
    s = TINY
    assert flops.prefill_flops(s, 10, 4) == (
        2 * s.layers * s.layer_matmul_params() * 6
        + 4 * s.layers * s.heads * s.head_dim * (6 * 4 + 21)
        + 2 * s.hidden * s.vocab)
    assert flops.decode_flops(s, 11) == (
        2 * s.layers * s.layer_matmul_params()
        + 4 * s.layers * s.heads * s.head_dim * 11
        + 2 * s.hidden * s.vocab)


def test_train_step_is_three_forwards_with_every_logit():
    s = TINY
    fwd = (2 * s.matmul_params() * 2 * 64
           + 4 * s.layers * s.heads * s.head_dim * 2 * (64 * 65 // 2))
    assert flops.train_step_flops(s, 2, 64) == 3 * fwd


def test_flash_work():
    s = TINY
    f, b = flops.flash_forward_work(s, 1, 8)
    assert f == 4 * s.layers * s.heads * s.head_dim * 36
    assert b == 2 * s.layers * 8 * s.head_dim * (2 * s.heads
                                                 + 2 * s.kv_heads)
    f3, b3 = flops.flash_train_work(s, 1, 8)
    assert f3 == 3 * f and b3 > 2 * b
