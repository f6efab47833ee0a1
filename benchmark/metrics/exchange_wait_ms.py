"""The rank mean of host milliseconds a step blocked at rendezvous
barriers (the wait intervals of ``obs.trace()``'s events, every rank
thread's), over the profiled steps: of ``exchange_ms``'s busy plus wait,
the wait."""


def read(run):
    t = run.trace
    if t is None or "exchange_wait_s" not in t:
        return None
    return 1e3 * t["exchange_wait_s"] / t["steps"]
