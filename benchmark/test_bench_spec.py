"""``BENCHMARK.json`` against the benchmark's contract, and every entry
resolving to the files that the harness finds by its name."""

import importlib
import json
import os
import re

import pytest

from benchmark import harness, spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(B) == TOP
    path = os.path.join(spec.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert B["command"][0] == "python3" and len(B["command"]) <= 32
    assert all(_line(w) for w in B["command"])
    assert B["paths"] == ["benchmark"]
    assert all(os.path.exists(os.path.join(spec.ROOT, w))
               for w in B["command"][1:] if "/" in w)
    assert 1 <= B["run_seconds"] <= 51


def test_names_units_and_keys():
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and \
            _line(c["source"])
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names["configs"].add(c["name"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names["configs"] and w["chips"] in (1, 4)
        assert _line(w["why"])
        names["workloads"].add(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(names["workloads"]) == len(B["workloads"])
    used = {w["config"] for w in B["workloads"]}
    assert used == names["configs"]
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= names["workloads"]
        assert m["name"] not in names["metrics"]
        names["metrics"].add(m["name"])


def test_every_cell_reports_what_it_must(workload):
    cell = spec.cell(workload)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e


def test_every_entry_resolves_to_its_files(workload):
    cell = spec.cell(workload)
    conf, traffic = cell["config"], cell["traffic"]
    fam = harness.module("models", conf["family"])
    for fn in ("port_config", "param_specs", "make_inputs", "batch",
               "train_step", "work", "model_flops", "attention_calls"):
        assert callable(getattr(fam, fn))
    ref = importlib.import_module(f"benchmark.reference.{conf['family']}")
    for fn in ("loss_sum", "n_rows", "take_rows", "positions_per_row"):
        assert callable(getattr(ref, fn))
    drv = harness.module("loops", traffic["loop"])
    assert callable(drv.run) and callable(drv.reference)
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    assert set(cell["limits"]) and all(
        isinstance(v, (int, float)) and v >= 0
        for v in cell["limits"].values())
    assert cell["config_entry"]["source"] == conf["source"]
    assert set(cell["config_entry"]["reduced"]) == set(conf["reduced"])


def test_reduced_lists_no_width():
    widths = re.compile(r"(hidden_size|intermediate_size|latent|state_size|"
                        r"proj|_dim$|_rank$|head_size|expansion|per_tok)")
    for c in B["configs"]:
        assert not [k for k in c["reduced"] if widths.search(k)]


def test_files_are_named_from_names():
    for root, _, files in os.walk(spec.BENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), spec.ROOT)
            if "__pycache__" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_config_files_are_json_with_published_keys():
    for c in B["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        for k, v in conf["reduced"].items():
            assert conf[k] == v["here"] != v["published"]


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_per_layer_metric_names_its_cells(metric):
    m = next(x for x in B["per_layer"] if x["name"] == metric)
    for w in m["workloads"]:
        cell = spec.cell(w)
        assert m["moves"] in {x["name"] for x in cell["end_to_end"]}
