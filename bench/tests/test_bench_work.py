"""The yardstick against hand-worked shapes: cache rows, the attention
kernels' operations and bytes, the model FLOPs, tails and unions."""
import math

import pytest

from bench.harness import spec, work

GRANITE = work.Shape(layers=36, d_model=4096, heads=32, kv_heads=8,
                     head_dim=128, d_ff=14336, vocab=49152)
KIVI2 = work.Shape(layers=36, d_model=4096, heads=32, kv_heads=8,
                   head_dim=128, d_ff=14336, vocab=49152, budget=1024,
                   window=128, bits=2)


def test_shape_from_files():
    s = work.Shape.of(spec.config("granite-8b"),
                      spec.workload("granite-8b.chat-kivi2"))
    assert s == KIVI2
    assert work.Shape.of(spec.config("granite-8b"),
                         spec.workload("granite-8b.rag-full")) == GRANITE


@pytest.mark.parametrize("prompt,k,rows", [
    (2048, 1, (1024, 1)),      # the prompt's ring flushed by eviction
    (2048, 128, (1024, 128)),
    (2048, 129, (1024, 1)),
    (1024, 1, (1024, 1)),      # 896 kept, the ring's flush fills group 7
    (512, 1, (512, 1)),        # 384 kept + one flushed group
    (512, 129, (640, 1)),
    (512, 256, (640, 128)),
])
def test_kivi2_rows(prompt, k, rows):
    assert KIVI2.decode_rows(prompt, k) == rows


def test_full_rows_and_decode_bytes():
    assert GRANITE.decode_rows(3968, 5) == (0, 3973)
    f, b = GRANITE.decode_attn(3968, 5)
    assert f == 4 * 32 * 128 * 3973
    assert b == 2 * 32 * 128 * 2 + 3973 * 2 * 8 * 128 * 2
    f, b = KIVI2.decode_attn(2048, 1)
    # 1024 rows of 2-bit K and V codes, K's per-group min / scale, V's
    # per-row min / scale; one exact bf16 row; q and the output
    codes = 1024 * 2 * 8 * 128 * 2 / 8
    scales = 8 * 2 * 8 * 128 * 4 + 1024 * 2 * 8 * 4
    assert b == pytest.approx(codes + scales + 2 * 8 * 128 * 2
                              + 2 * 32 * 128 * 2)
    assert f == 4 * 32 * 128 * 1025


def test_prefill_counts():
    f, b = GRANITE.prefill_attn(2048)
    assert f == 4 * 32 * 128 * 2048 * 2049 / 2
    assert b == (2 * 32 + 2 * 8) * 2048 * 128 * 2
    # granite-8b: 218 103 808 matmul parameters a layer
    assert GRANITE.matmul_params == 36 * 218_103_808
    assert GRANITE.prefill_flops(512) == pytest.approx(
        2 * 36 * 218_103_808 * 512 + 36 * f * (512 * 513) / (2048 * 2049)
        + 2 * 4096 * 49152)
    assert GRANITE.request_flops(512, 1) == GRANITE.prefill_flops(512)


def test_bounds():
    # a call bound by bytes and one bound by operations
    assert work.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(989e12, 1.0) == pytest.approx(1.0)
    items = [(1, 2048, 5), (1, 512, 5), (2, 2048, 6)]
    one = KIVI2.decode_attn(2048, 5)
    two = KIVI2.decode_attn(512, 5)
    step1 = work.bound_s(one[0] + two[0], one[1] + two[1])
    step2 = work.bound_s(*KIVI2.decode_attn(2048, 6))
    assert work.decode_bound_s(KIVI2, items) == pytest.approx(
        36 * (step1 + step2))


def test_percentile_and_union():
    xs = list(range(1, 101))
    assert work.percentile(xs, 0.90) == 90
    assert work.percentile(xs, 0.95) == 95
    assert work.percentile([3.0, math.inf, 1.0, 2.0], 0.75) == 3.0
    assert work.percentile([3.0, math.inf, 1.0, 2.0], 0.9) == math.inf
    assert work.union_seconds([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == 3


@pytest.mark.parametrize("prompt", [512, 1024, 2048])
def test_rows_agree_with_the_reference_schedule(prompt):
    from bench.reference import decoder
    pol = decoder.CachePolicy(budget=1024, window=128, sinks=4, bits=2)
    n = prompt + 300
    sc = decoder.cache_schedule(prompt, n, pol)
    for t in range(prompt, n):
        live, ring0 = sc.visible[t]
        k = t - prompt + 1
        assert KIVI2.decode_rows(prompt, k) == (128 * len(live),
                                                t - ring0 + 1)
