"""The attention kernels' share of their roofline: the least time the
model's attention work needs (``bounds.flash_attention`` from the shapes,
K and V at the model's KV heads) over the device time of the profiled
K2-K4 kernels, in percent."""

from ..bounds import flash_attention as FA


def read(run):
    t = run.trace
    if t is None or "bf16_flops" not in run.peaks:
        return None
    spent = sum(b - a for a, b, name in t["ops"]
                if any(k in name for k in FA.KERNELS))
    if spent <= 0:
        return None
    need = sum(c["count"] * FA.bound_s(c, role, run.peaks["bf16_flops"],
                                       run.peaks["hbm_bytes_s"])
               for c in run.attention_calls
               for role in FA.KERNELS.values())
    return 100.0 * need * t["steps"] / spent
