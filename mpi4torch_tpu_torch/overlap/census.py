"""Scheduled-exposure census: how much of a program's bucket
communication its schedule leaves *exposed*.

Port of ``mpi4torch_tpu/overlap/census.py``.  The rank threads'
rendezvous is blocking, so blocking and split-phase programs time alike
on them; what is deterministic on every device is the *schedule*: a
split-phase bucket whose ``.start``/``.wait`` window holds another
collective's wire op is hidden, an empty window (or a blocking bucket)
is exposed.  The pass lives in :mod:`mpi4torch_tpu_torch.analyze` over
the shared parse of a recorded program (``analyze.lower``,
``Engine.lower_step``); this module keeps the historical entry point as
a delegation.
"""

from __future__ import annotations

from typing import Dict

from ..analyze.parse import WIRE_OPS

__all__ = ["scheduled_exposure", "WIRE_OPS"]


def scheduled_exposure(program) -> Dict:
    """The scheduled-exposure census of a recorded program
    (``analyze.lower``, ``Engine.lower_step``):
    :func:`mpi4torch_tpu_torch.analyze.scheduled_exposure`.  Returns
    ``{"n_buckets", "n_exposed", "exposed_fraction", "buckets"}``;
    ``exposed_fraction`` is None when the program has no bucket
    collectives."""
    from ..analyze.accounting import scheduled_exposure as _exposure

    return _exposure(program)
