"""Peak-live-bytes census of a recorded reshard program.

Port of ``mpi4torch_tpu/reshard/census.py``.  A last-use liveness scan
over the recorded events: a value is live from the op that defines it
to its last use, and the census is the largest live total.  It is exact
about what the planner controls (a program that materializes an
``N x shard`` gather holds it through its range, the planned exchange
never defines one), so planned-against-gather comparisons run both
programs through the same scan.  The scan lives in
:mod:`mpi4torch_tpu_torch.analyze`; this module keeps the historical
entry points as delegations.
"""

from __future__ import annotations

__all__ = ["peak_live_bytes", "tensor_bytes"]


def peak_live_bytes(program) -> int:
    """Peak live bytes of a recorded program (``analyze.lower`` of a
    reshard): :func:`mpi4torch_tpu_torch.analyze.peak_live_bytes`."""
    from ..analyze.accounting import peak_live_bytes as _peak

    return _peak(program)


def tensor_bytes(type_text) -> int:
    """Bytes of a tensor type description (``8x128xf32``):
    :func:`mpi4torch_tpu_torch.analyze.tensor_bytes`."""
    from ..analyze.parse import tensor_bytes as _bytes

    return _bytes(type_text)
