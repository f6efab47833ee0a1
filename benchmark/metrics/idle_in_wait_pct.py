"""Of the device's idle time in the profiled stretch (the gaps that
``device_idle_pct`` reads), the share during which at least one rank
thread was blocked at a rendezvous barrier: idle owed to skew between
the ranks' hosts, in percent."""


def read(run):
    t = run.trace
    if t is None or "idle_in_wait_s" not in t:
        return None
    idle = t["window_s"] - t["busy_s"]
    return 100.0 * t["idle_in_wait_s"] / idle if idle > 0 else None
