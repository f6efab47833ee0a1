"""The profiled stretch's share of wall time in which no device operation
ran: 100 minus the union of kernel, copy and set intervals over the
stretch."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
