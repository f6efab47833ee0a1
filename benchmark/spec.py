"""Reading ``BENCHMARK.json`` and the files it names."""

from __future__ import annotations

import json
import os

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark():
    return _json(ROOT, "BENCHMARK.json")


def cell(workload: str) -> dict:
    """Everything one cell runs from: its ``BENCHMARK.json`` entry, its
    configuration file, traffic file and limits, and the end-to-end and
    per-layer metrics it reports."""
    b = benchmark()
    entries = {w["name"]: w for w in b["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(entries)}")
    w = entries[workload]
    confs = {c["name"]: c for c in b["configs"]}
    entry = confs[w["config"]]
    e2e = [m for m in b["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in b["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return {"workload": w, "config_entry": entry,
            "config": _json(ROOT, entry["file"]),
            "traffic": _json(BENCH, "traffic", w["traffic"] + ".json"),
            "limits": _json(BENCH, "limits", workload + ".json"),
            "end_to_end": e2e, "per_layer": per_layer,
            "peaks": _json(BENCH, "peaks.json")}
