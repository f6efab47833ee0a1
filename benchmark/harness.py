"""One run of one cell: the loop's run, the reference check, the metric
readers, and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import time
from types import SimpleNamespace

from . import checks, spec as S

# Top-level module names that may not be loaded: JAX and the JAX package
# (compared whole, so the port's ``mpi4torch_tpu_torch`` is not one).
FORBIDDEN = ("jax", "jaxlib", "flax", "mpi4torch_tpu")
CACHE = os.path.join(S.ROOT, ".bench_cache")


def pin_caches():
    """Every compile cache the run may touch, at fixed paths inside the
    checkout, so that the first run of a cell builds and the next ones
    hit.  The port keeps its CUDA kernels in ``mpi4torch_tpu_torch/build``
    itself."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def module(kind: str, name: str):
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def reader(metric: str):
    """``metrics/<name>.py``, else ``metrics/<name before the first
    dot>.py``."""
    for name in (metric, metric.split(".")[0]):
        path = os.path.join(S.BENCH, "metrics", name + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"{__package__}.metrics.{name}", path,
                submodule_search_locations=None)
            mod = importlib.util.module_from_spec(spec)
            mod.__package__ = f"{__package__}.metrics"
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            "benchmark/metrics/")


def run_cell(workload, seed, seconds, trace, device="cuda", cell=None,
             step_fn=None, t_start=None):
    """Run one cell and return ``(result, check_rows)``.  ``cell`` (as
    :func:`spec.cell` gives it) may be altered by a test; ``step_fn``
    replaces the family's entry (the tests' planted faults)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or S.cell(workload)
    conf, traffic = cell["config"], cell["traffic"]
    fam = module("models", conf["family"])
    drv = module("loops", traffic["loop"])
    rec = drv.run(fam, conf, traffic, seed, seconds, trace, device,
                  step_fn=step_fn, t_start=t_start)
    cuda = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    if cuda:
        torch.cuda.empty_cache()
    ref = drv.reference(fam, conf, traffic, seed, device)
    values = checks.readings(rec["checked"], ref)
    correct, rows = checks.judge(values, cell["limits"])
    peaks = cell["peaks"].get(kind, {})
    run = SimpleNamespace(work=fam.work(conf, traffic),
                          model_flops=fam.model_flops(conf, traffic),
                          attention_calls=fam.attention_calls(conf, traffic),
                          peaks=peaks, setup_s=rec["setup_s"],
                          window=rec["window"], trace=rec["trace"])
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": 0, "metrics": metrics, "device": device_info}
    if trace and rec["trace"] is not None:
        t = rec["trace"]
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              t["device_ops"][:10]],
                               "idle_gaps": [list(x) for x in
                                             t["idle_gaps"][:10]]}
    result["readings"] = {k: v for k, v in values.items()
                          if k not in cell["limits"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim, _ in rows}
    return result, rows, rec["window"]
