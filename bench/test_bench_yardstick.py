"""The benchmark's operation and byte counts against numbers worked by hand
for the cells' shapes, and its statistics."""

import json
import statistics

import pytest

from bench import run as bench_run
from bench import yardstick as ys


def config(name):
    return json.loads((bench_run.ROOT / "bench" / "configs" / f"{name}.json").read_text())


def test_attended_pairs():
    assert ys.attended_pairs(2048, 2048, causal=True) == 2048 * 2049 // 2 == 2_098_176
    assert ys.attended_pairs(512, 512, causal=False) == 262_144
    # a chunk of 4 queries at offset 6 over 8 keys: 7 + 8 + 8 + 8
    assert ys.attended_pairs(4, 8, causal=True, q_offset=6) == 31
    assert ys.attended_pairs(3, 8, causal=True, q_offset=0) == 1 + 2 + 3


def test_neox_prefill_counts():
    cfg = config("gpt-neox-20b")
    layer, head = ys.dense_matmul_params(cfg)
    # q, k, v, o: 4 x 6144^2 = 150,994,944; MLP 2 x 6144 x 24576 = 301,989,888
    assert layer == 452_984_832
    assert layer * 44 == 19_931_332_608
    assert head == 6144 * 50432
    # 2 x 19.93 B x 2048 + 44 x 4 x 6144 x 2,098,176 + 2 x 6144 x 50432
    assert ys.forward_flops(cfg, 2048, 1, head_positions=1) == 83_908_208_099_328
    # one layer's flash call at 2048: 4 x 64 x 96 x 2,098,176 flops; q, k, v, o in bf16
    flops, nbytes = ys.attention_fwd_work((1, 2048, 64, 96), (1, 2048, 64, 96), True, 2)
    assert flops == 51_564_773_376
    assert nbytes == 4 * 2048 * 6144 * 2 == 100_663_296
    assert ys.bound_s(flops, nbytes) == pytest.approx(flops / 989e12)  # operations bound it


def test_roberta_train_counts():
    cfg = config("roberta-large")
    layer, head = ys.dense_matmul_params(cfg)
    assert layer * 24 == 301_989_888
    assert layer * 24 + head == 353_461_248  # 354 M matmul weights
    # 3 x 128 x (2 x 301,989,888 x 512 + 24 x 4 x 1024 x 512^2 + 2 x 51,471,360 x 512)
    assert ys.train_step_flops(cfg, 512, 128) == 148_882_222_743_552
    flops, nbytes = ys.attention_fwd_work((128, 512, 16, 64), (128, 512, 16, 64), False, 2,
                                          lse=True)
    assert flops == 4 * 128 * 16 * 64 * 512 * 512
    assert nbytes == 4 * 128 * 512 * 1024 * 2 + 4 * 128 * 16 * 512
    flops, nbytes = ys.attention_bwd_work((128, 512, 16, 64), (128, 512, 16, 64), False, 2)
    assert flops == 10 * 128 * 16 * 64 * 512 * 512  # five products
    # do, q, o, dq, k, v, dk, dv in bf16 and the float32 lse
    assert nbytes == 8 * 128 * 512 * 1024 * 2 + 4 * 128 * 16 * 512
    assert ys.bound_s(flops, nbytes) == pytest.approx(flops / 989e12)


def test_statistics():
    xs = [10.0, 12.0, 11.0, 13.0, 9.0, 14.0]
    assert ys.percentile(xs, 50) == statistics.median(xs)
    assert ys.percentile(list(range(101)), 95) == 95
    assert ys.percentile([1.0, 2.0], 95) == pytest.approx(1.95)
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert ys.spread(xs) == pytest.approx((q3 - q1) / med)
