"""The expert-parallel cell: the MoE's tiny size for the shared CPU
tests, the grouped products' and the dispatch exchange's readers on
hand-made records, and the cell resolving to its files."""

import pytest
import torch

from benchmark import conftest, faults_moe, harness, spec
from benchmark.bounds import grouped_mm as G
from benchmark.conftest import tiny_cell
from benchmark.models import moe_transformer as M

# The MoE family at the test size: d 64, 4 query heads of 32 over 2 KV
# heads, 8 experts of 48 with top-2, layers sliding x 3 and full, window
# 8, 32 tokens a row.
conftest.TINY.setdefault("moe_transformer", (
    {"vocab_size": 64, "hidden_size": 64, "head_dim": 32,
     "moe_intermediate_size": 48, "num_attention_heads": 4,
     "num_key_value_heads": 2, "num_experts": 8, "num_experts_per_tok": 2,
     "sliding_window": 8, "max_position_embeddings": 64},
    {"seq_len": 32, "rows_per_rank": 2, "pool_steps": 4,
     "trace_steps": 2}))

MOE = "mellum2-l4-ep2-s8192"


def test_moe_cell_resolves_to_its_files():
    cell = spec.cell(MOE)
    assert cell["config"]["family"] == "moe_transformer"
    assert cell["traffic"]["loop"] == "ep_train"
    assert harness.module("loops", "ep_train").run
    assert {m["name"] for m in cell["per_layer"]} == {
        "step_mfu.moe", "attn_roofline.moe", "exchange_ms.moe",
        "device_idle_pct.moe", "alltoall_ms.moe", "expert_mm_roofline.moe"}


@pytest.mark.parametrize("key,value", [
    ("beta_fast", 16), ("beta_slow", 2), ("attention_factor", 1.0)])
def test_port_config_refuses_other_yarn_constants(key, value):
    conf = spec.cell(MOE)["config"]
    assert M.port_config(conf).yarn_factor == 16.0
    rope = dict(conf["rope_parameters"])
    rope["full_attention"] = dict(rope["full_attention"], **{key: value})
    with pytest.raises(ValueError, match="YaRN"):
        M.port_config(dict(conf, rope_parameters=rope))


def test_mellum_counts():
    conf = spec.cell(MOE)["config"]
    traffic = spec.cell(MOE)["traffic"]
    d, q, kv, f, E, k, V = 2304, 4096, 512, 896, 64, 8, 98304
    per_layer = d * (q + 2 * kv) + q * d + d * E + k * 3 * d * f
    assert M.matmul_params(conf) == 4 * per_layer + d * V
    assert M.work(conf, traffic) == {"tokens": 2 * 2 * 8192}
    calls = M.attention_calls(conf, traffic)
    assert [(c["window"], c["count"]) for c in calls] == [(1024, 6), (0, 2)]
    # 1.12e14 model FLOP a step, as PERF.md predicts from.
    assert M.model_flops(conf, traffic) == pytest.approx(1.12e14, rel=0.02)
    specs = M.param_specs(conf)
    assert len(specs) == 3 + 4 * 7
    total = sum(torch.Size(s[1]).numel() for s in specs)
    # Four layers of the published 12.15B: 21.2M attention, 396M experts
    # and 0.15M router a layer, and the 226M embedding and head.
    assert total == pytest.approx(4 * (21.2e6 + 64 * 6.19e6 + 0.15e6)
                                  + 2 * 226.5e6, rel=2e-3)


def test_grouped_mm_bound_by_hand():
    n, d, f, held = 10, 8, 4, 3
    prods = G.products(n, d, f, held, elem=2)
    assert [o for o, _ in prods["fwd"]] == [2 * 10 * 8 * 8, 2 * 10 * 4 * 8]
    assert G.operations(n, d, f, "fwd") == 6 * n * d * f
    assert G.operations(n, d, f, "bwd") == 2 * G.operations(n, d, f, "fwd")
    w1, w2 = 3 * 8 * 8 * 2, 3 * 4 * 8 * 2
    x, gu, a = 10 * 8 * 2, 10 * 8 * 2, 10 * 4 * 2
    assert [b for _, b in prods["fwd"]] == [x + w1 + gu, a + w2 + x]
    assert [b for _, b in prods["bwd"]] == [gu + w1 + x, x + gu + w1,
                                            x + w2 + a, a + x + w2]
    peak_f, peak_b = 1e3, 1e2
    assert G.bound_s(n, d, f, held, peak_f, peak_b, "fwd") == \
        max(1280 / peak_f, (x + w1 + gu) / peak_b) + \
        max(640 / peak_f, (a + w2 + x) / peak_b)


def _run(trace, steps=2):
    from types import SimpleNamespace
    return SimpleNamespace(peaks={"bf16_flops": 1e3, "hbm_bytes_s": 1e2},
                           trace=trace)


def test_readers_on_hand_made_records():
    from benchmark.metrics import alltoall_ms, expert_mm_roofline

    assert alltoall_ms.read(_run(None)) is None
    assert alltoall_ms.read(_run({"steps": 4})) is None
    assert alltoall_ms.read(_run({"steps": 4, "alltoall_s": 0.2})) == \
        pytest.approx(50.0)
    shapes = {"d": 8, "f": 4, "experts": 6, "ranks": 2, "layers": 1}
    # 2 steps x 1 layer x 2 ranks = 4 launches of 10 assignments each.
    t = {"steps": 2, "moe_assignments": 40, "expert_shapes": shapes,
         "ops": [(0.0, 1.0, "cutlass_GroupProblemShape_k"),
                 (1.0, 3.0, "flash_fwd_tc"),
                 (3.0, 4.0, "void GroupProblemShape<2>")]}
    need = 4 * (G.bound_s(10, 8, 4, 3, 1e3, 1e2, "fwd")
                + G.bound_s(10, 8, 4, 3, 1e3, 1e2, "bwd"))
    assert expert_mm_roofline.read(_run(t)) == pytest.approx(
        100.0 * need / 2.0)
    # A parent without the counters, or without the kernels, reads
    # nothing.
    assert expert_mm_roofline.read(_run({**t, "moe_assignments": 0})) \
        is None
    assert expert_mm_roofline.read(_run({**t, "ops": []})) is None


def test_zipf_inputs_are_seeded_and_skewed():
    cell = tiny_cell(MOE)
    conf, traffic = cell["config"], cell["traffic"]
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a = M.make_inputs(conf, dict(traffic, seq_len=4096), g(), "cpu", 2)
    b = M.make_inputs(conf, dict(traffic, seq_len=4096), g(), "cpu", 2)
    assert torch.equal(a, b)
    counts = torch.bincount(a.flatten(), minlength=64).sort(
        descending=True).values.float()
    # Zipf(1) over 64 ids: the top id takes ~21% of draws, the last ~0.3%.
    assert counts[0] / counts.sum() > 0.15 and counts[-1] / counts.sum() \
        < 0.01


@pytest.mark.parametrize("fault", sorted(faults_moe.FAULTS))
def test_moe_fault_is_not_correct(fault):
    cell = tiny_cell(MOE)
    fam = harness.module("models", "moe_transformer")
    res, rows, _ = harness.run_cell(MOE, 11, 0.2, False, device="cpu",
                                    cell=cell,
                                    step_fn=faults_moe.FAULTS[fault](fam))
    assert not res["correct"], rows
