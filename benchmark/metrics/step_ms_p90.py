"""The 90th percentile of the window's step times (host clock, from a
step's start to the synchronisation that ends it), over every step."""

import statistics


def read(run):
    times = run.window["step_s"]
    if len(times) < 2:
        return None
    return 1e3 * statistics.quantiles(times, n=10, method="inclusive")[8]
