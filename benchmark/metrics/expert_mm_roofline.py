"""The grouped expert products' share of their roofline: the least time
the profiled steps' expert products need (``bounds.grouped_mm``, from the
assignments the ``moe_assignments_total`` counters counted, spread
evenly over the steps, layers and ranks, and the expert shapes the loop
records) over the device time of the profiled grouped-product kernels,
in percent."""

from ..bounds import grouped_mm as G


def read(run):
    t = run.trace
    if t is None or not t.get("moe_assignments") or \
            "bf16_flops" not in run.peaks:
        return None
    spent = sum(b - a for a, b, name in t["ops"]
                if any(k in name for k in G.KERNELS))
    if spent <= 0:
        return None
    s = t["expert_shapes"]
    launches = s["layers"] * s["ranks"] * t["steps"]
    n = t["moe_assignments"] / launches
    need = launches * sum(
        G.bound_s(n, s["d"], s["f"], s["experts"] // s["ranks"],
                  run.peaks["bf16_flops"], run.peaks["hbm_bytes_s"], role)
        for role in G.ROLES)
    return 100.0 * need / spent
