"""Rank 0's host milliseconds a step in the expert dispatch's
``Alltoall`` exchanges (``CommEvent.duration_s`` of their ``Gather`` and
``Scatter`` rendezvous, waits on the peer included), over the profiled
steps.  A loop that keeps no ``alltoall_s`` gives nothing."""


def read(run):
    t = run.trace
    if t is None or not t.get("alltoall_s"):
        return None
    return 1e3 * t["alltoall_s"] / t["steps"]
