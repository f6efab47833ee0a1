"""Shared pieces of the benchmark's CPU tests: each cell cut to a size a
test run holds on the CPU (its widths, depth and batch shrunk; the
traffic's structure, loop and limits kept)."""

from __future__ import annotations

import copy

import pytest

from benchmark import spec

# Per model family: the configuration keys and traffic keys a tiny cell
# overrides.
TINY = {
    "transformer": ({"vocab_size": 64, "hidden_size": 32,
                     "intermediate_size": 48, "num_hidden_layers": 2,
                     "num_attention_heads": 4, "num_key_value_heads": 2,
                     "sliding_window": 8, "max_position_embeddings": 64},
                    {"seq_len": 16, "rows_per_rank": 2, "pool_steps": 4,
                     "trace_steps": 2}),
    "vit": ({"image_size": 16, "patch_size": 4, "hidden_size": 32,
             "intermediate_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 4, "num_labels": 10},
            {"rows_per_rank": 4, "pool_steps": 4,
             "trace_steps": 2}),
}

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


def tiny_cell(workload: str, dtype: str = "float32") -> dict:
    """``spec.cell(workload)`` cut to the CPU: the cell's limits, loop
    and traffic structure, tiny sizes, parameters in ``dtype``."""
    cell = copy.deepcopy(spec.cell(workload))
    conf_over, traffic_over = TINY[cell["config"]["family"]]
    cell["config"].update(conf_over, torch_dtype=dtype)
    cell["traffic"].update(traffic_over)
    return cell


@pytest.fixture(params=WORKLOADS)
def workload(request):
    return request.param
