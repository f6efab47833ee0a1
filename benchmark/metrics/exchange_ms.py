"""Rank 0's host milliseconds a step inside the communication chokepoints
(``CommEvent.duration_s`` of ``obs.trace()``, waits on the peer
included), over the profiled steps."""


def read(run):
    t = run.trace
    if t is None or t["comm_events"] == 0:
        return None
    return 1e3 * t["comm_s"] / t["steps"]
