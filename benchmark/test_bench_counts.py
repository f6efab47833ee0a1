"""The operation and byte counts of the benchmark's yardstick, against
shapes worked out by hand."""

import pytest

from benchmark import spec
from benchmark.bounds import flash_attention as FA
from benchmark.models import transformer as LM
from benchmark.models import vit as V


def test_pairs_by_hand():
    assert FA.pairs(4, 4, causal=False) == 16
    assert FA.pairs(4, 4, causal=True) == 1 + 2 + 3 + 4
    # A window of 2: each query sees itself and the one before.
    assert FA.pairs(4, 4, causal=True, window=2) == 1 + 2 + 2 + 2
    # A window as long as the sequence changes nothing.
    assert FA.pairs(4096, 4096, True, 4096) == 4096 * 4097 // 2


def test_attention_operations_and_bytes_by_hand():
    call = {"b": 2, "sq": 4, "sk": 4, "h": 4, "h_kv": 2, "d": 8,
            "causal": True, "window": 0}
    pairs_ = 10 * 4 * 2   # 10 pairs a head, 4 heads, 2 rows
    assert FA.operations(call, "fwd") == 4 * 8 * pairs_
    assert FA.operations(call, "dq") == 6 * 8 * pairs_
    assert FA.operations(call, "dkv") == 8 * 8 * pairs_
    q = 2 * 4 * 4 * 8 * 2         # one of q, o, do, dq in bf16
    kv = 2 * 4 * 2 * 8 * 2        # one of k, v, dk, dv at the KV heads
    st = 2 * 4 * 4 * 4            # one of lse, dd in f32
    assert FA.nbytes(call, "fwd") == 2 * q + 2 * kv + st
    assert FA.nbytes(call, "dq") == 3 * q + 2 * kv + 2 * st
    assert FA.nbytes(call, "dkv") == 2 * q + 4 * kv + 2 * st
    peak_f, peak_b = 989e12, 3.35e12
    assert FA.bound_s(call, "fwd", peak_f, peak_b) == max(
        4 * 8 * pairs_ / peak_f, (2 * q + 2 * kv + st) / peak_b)


def test_mistral_cell_counts():
    cell = spec.cell("mistral7b-l4-dp2-s4096")
    conf, traffic = cell["config"], cell["traffic"]
    # Per layer: wqkv 4096 x (4096 + 2 x 1024), wo 4096 x 4096, gate|up
    # 4096 x 28672, down 14336 x 4096; and the head 4096 x 32000.
    per_layer = 4096 * 6144 + 4096 * 4096 + 4096 * 28672 + 14336 * 4096
    assert LM.matmul_params(conf) == 4 * per_layer + 4096 * 32000
    assert LM.work(conf, traffic) == {"tokens": 2 * 2 * 4096}
    attn = 3 * 4 * 128 * (4096 * 4097 // 2) * 32 * 2 * 2 * 4
    assert LM.model_flops(conf, traffic) == pytest.approx(
        6 * (4 * per_layer + 4096 * 32000) * 16384 + attn, rel=1e-12)
    # 1.052e14 model FLOP a step, as PERF.md predicts from.
    assert LM.model_flops(conf, traffic) == pytest.approx(1.052e14,
                                                          rel=1e-3)
    n = sum(1 for _ in LM.param_specs(conf))
    assert n == 3 + 4 * 6


def test_vit_cell_counts():
    cell = spec.cell("vitb16-dp2-b256")
    conf, traffic = cell["config"], cell["traffic"]
    per_layer = 768 * 2304 + 768 * 768 + 2 * 768 * 3072
    tokens, head = V.matmul_params(conf)
    assert (tokens, head) == (768 * 768 + 12 * per_layer, 768 * 1000)
    images = 2 * traffic["rows_per_rank"]
    attn = 3 * 4 * 64 * 196 * 196 * 12 * traffic["rows_per_rank"] * 2 * 12
    assert V.model_flops(conf, traffic) == pytest.approx(
        6 * (tokens * 196 + head) * images + attn, rel=1e-12)
    assert V.model_flops(conf, traffic) / images == pytest.approx(
        1.048e11, rel=1e-3)
    assert sum(1 for _ in V.param_specs(conf)) == 5 + 12 * 8
