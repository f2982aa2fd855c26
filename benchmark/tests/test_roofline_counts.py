"""The roofline and utilization counts against small shapes worked by hand."""

import pytest

from benchmark.measure import roofline as r

MODEL = {"vocab_size": 10, "d_model": 4, "n_heads": 2, "n_layers": 3, "d_ff": 8, "max_seq_len": 8}


def test_flash_counts_by_hand():
    # b 1, s 3, h 2, hk 2, d 4, bf16: q = kv = 1*2*3*4*2 = 48 bytes, rows 1*2*3*4 = 24,
    # causal pairs 2 * (3 + 2 + 1) = 12
    assert r.flash_work("flash_fwd_tc_kernel", 1, 3, 2, 2, 4) == (2 * 48 + 2 * 48 + 24, 4 * 12 * 4)
    assert r.flash_work("flash_bwd_dq_tc_kernel", 1, 3, 2, 2, 4) == (3 * 48 + 2 * 48 + 48, 6 * 12 * 4)
    assert r.flash_work("flash_bwd_dkv_tc_kernel", 1, 3, 2, 2, 4) == (4 * 48 + 2 * 48 + 48, 8 * 12 * 4)
    with pytest.raises(ValueError):
        r.flash_work("flash_fwd_kernel", 1, 3, 2, 2, 4)


def test_int8_bound_by_hand():
    # m 2, k 64, n 16: q 1024 + scales 64 + bf16 (x 256 + y 64 + bias 32) = 1440 bytes
    assert r.int8_bound_s(2, 64, 16) == pytest.approx(1440 / r.HBM_BYTES_PER_S)
    # a large m is bound by its operations
    assert r.int8_bound_s(8192, 8192, 8192) == pytest.approx(2 * 8192**3 / r.PEAK_BF16_FLOPS)


def test_step_shapes_cover_every_matmul():
    shapes = r.int8_step_shapes(MODEL)
    assert sum(n for _, _, n in shapes) == 6 * 3 + 1
    assert sum(k * n * c for k, n, c in shapes) == r.dense_weights(MODEL)


def test_train_flops_by_hand():
    # dense: 3 * (4*16 + 2*32) + 4*10 = 424; b 2, seq 5 -> 4 trained positions a row,
    # pairs 4*5/2 = 10; attention 12 * 3 layers * 2 rows * 10 * 4
    assert r.dense_weights(MODEL) == 424
    assert r.train_flops_per_step(MODEL, 2, 5) == 6 * 424 * 2 * 4 + 12 * 3 * 2 * 10 * 4


def test_decode_step_bound_by_hand():
    d, f, layers, v, b, filled = 4, 8, 3, 10, 2, 5
    nbytes = (424 + 4 * (layers * (4 * d + f + d) + v + 2 * d)
              + 4 * (layers * (9 * d + f) + 2 * d + v) + b * 2 * d
              + 2 * layers * d * 2 * b * (filled + 1))
    flops = 2 * 424 * b + 4 * layers * b * filled * d
    assert r.decode_step_bound_s(MODEL, b, filled) == pytest.approx(
        max(nbytes / r.HBM_BYTES_PER_S, flops / r.PEAK_BF16_FLOPS))


def test_mfu_readers_by_hand():
    from benchmark import cells

    root = cells.Path(__file__).resolve().parents[2]
    traffic = {"batch": 2, "seq_len": 5, "total_len": 4}
    window = {"step_s": [1.0, 1.0], "attempted": 2, "elapsed_s": 2.0}
    got = cells.reader(root, "mfu.train").read({"window": window, "traffic": traffic, "model": MODEL})
    assert got == pytest.approx(100 * r.train_flops_per_step(MODEL, 2, 5) / r.PEAK_BF16_FLOPS)
    window = {"call_s": [1.0], "calls": 1, "elapsed_s": 1.0}
    got = cells.reader(root, "mfu.decode").read({"window": window, "traffic": traffic, "model": MODEL})
    assert got == pytest.approx(100 * sum(r.decode_step_bound_s(MODEL, 2, i) for i in (1, 2, 3)))
