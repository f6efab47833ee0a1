"""Typed comm-event records: the unit of runtime observability.

Port of ``mpi4torch_tpu/obs/events.py``.  A :class:`CommEvent` is one
operation observed at a chokepoint of the rank-thread runtime
(``World.exchange`` or the p2p mailboxes).  Every subsystem's traffic
(plain, fused, compressed, overlapped, serving) goes through those two
sites, so one record type covers it all without a hook per subsystem.

:func:`annotate_signature` reads the rendezvous signature tuples every
call site deposits (``("Allreduce", op, algo, (shape, dtype))``,
``("Allreduce.q8hop", codec, algo, reverse, sig)``, ...) into the
logical fields of an event: the wire family, the algorithm and codec
labels, the shape and dtype, and whether the rendezvous is bookkeeping
(a fold-result share or a barrier, which moves no wire bytes of the
collective's own schedule).

Times in an event are host times (``time.perf_counter``): a rendezvous
returns once every rank has queued its work, before the card has run
it, so a duration is how long the host spent in the operation, never a
device time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "CommEvent",
    "StepSpan",
    "FAMILY_OF",
    "annotate_signature",
    "payload_nbytes",
]


def payload_nbytes(payload: Any) -> int:
    """Total bytes of the tensor leaves of a rendezvous payload tree
    (ints, strings and None in a codec's meta carry no wire bytes).  A
    tensor's bytes come from its shape and dtype: nothing is read from
    the device, so a CUDA payload is counted without a sync or a
    copy."""
    # Imported here: ``utils.tree`` opens this package's step-phase
    # spans, so it imports the package.
    from ..utils.tree import tree_leaves

    total = 0
    for leaf in tree_leaves(payload):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


# Signature head -> wire family: which collective the rendezvous
# executes.  Heads absent here are reported as unmodeled; None marks
# bookkeeping rounds.
FAMILY_OF = {
    "Allreduce": "all_reduce",
    "Allreduce.q8hop": "all_reduce",
    "Allreduce.c": "all_reduce",
    "Allgather": "all_gather",
    "Allgather.c": "all_gather",
    # The Allgather backward ships the whole upstream gradient and every
    # rank folds its own segment: a reduce-scatter.
    "Allgather.bwd": "reduce_scatter",
    "Allgather.c.bwd": "reduce_scatter",
    "Reduce_scatter": "reduce_scatter",
    "Reduce_scatter.bwd": "all_gather",
    # The reshard executor's wire steps (reshard/executor.py).
    "Reshard.permute": "collective_permute",
    "Reshard.alltoall": "all_to_all",
    "Reshard.allgather": "all_gather",
    "Reshard.reduce_scatter": "reduce_scatter",
    # Fold-once result shares and barriers are artifacts of the thread
    # rendezvous, not of the collective's wire schedule.
    "Allreduce.fold": None,
    "Allreduce.c.fold": None,
    "Barrier": None,
    # Mode A (ops/spmd.py): one rendezvous a lax collective; the finite
    # guard's check round moves no wire bytes.
    "spmd.ppermute": "collective_permute",
    "spmd.all_gather": "all_gather",
    "spmd.all_gather_tiled": "all_gather",
    "spmd.psum": "all_reduce",
    "spmd.psum_scatter": "reduce_scatter",
    "spmd.all_to_all": "all_to_all",
    "spmd.finite_guard": None,
}

# Heads with no single standard wire accounting (root and varying-shape
# collectives, and the encoded Allgather forms): traced like the rest,
# flagged unmodeled.
_UNMODELED_HEADS = ("Bcast_", "Bcast_.bwd", "Reduce_", "Reduce_.bwd",
                    "Gather", "Scatter", "Allgather.c",
                    "Allgather.c.bwd")

# Where each head keeps its (shape, dtype) element and its labels.  The
# port's signatures follow the JAX package's grammar element for
# element; only their dtype strings differ ("torch.float32" against
# "float32"), which :func:`_dtype_name` normalizes.
_SHAPE_AT = {"Allreduce": 3, "Allreduce.q8hop": 4, "Allreduce.c": 3,
             "Allgather.bwd": 2, "Reduce_scatter": 3,
             "Reduce_scatter.bwd": 2,
             "spmd.ppermute": 3, "spmd.all_gather": 3,
             "spmd.all_gather_tiled": 4, "spmd.psum": 4,
             "spmd.psum_scatter": 5, "spmd.all_to_all": 5,
             "spmd.finite_guard": 2}
_ALGO_AT = {"Allreduce": 2, "Allreduce.q8hop": 2}
_CODEC_AT = {"Allreduce.q8hop": 1, "Allreduce.c": 1, "Allgather.c": 1,
             "Allgather.c.bwd": 1}


def _dtype_name(dtype) -> str:
    """A dtype as the JAX package names it (``"float32"``, not
    ``"torch.float32"``)."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def annotate_signature(signature) -> dict:
    """Logical annotation of a rendezvous signature tuple: ``op`` (the
    head), ``family`` (wire kind, or None for bookkeeping), ``shape`` /
    ``dtype`` (where the grammar carries them), ``algorithm`` /
    ``codec`` labels, ``group_size`` (a reshard step's replica group;
    None: the whole communicator), ``bookkeeping`` and ``unmodeled``."""
    if not isinstance(signature, tuple) or not signature \
            or not isinstance(signature[0], str):
        return {"op": repr(signature), "family": None,
                "bookkeeping": False, "unmodeled": True}
    head = signature[0]
    out: dict = {"op": head, "unmodeled": head in _UNMODELED_HEADS}
    family = FAMILY_OF.get(head)
    # A trailing "fold" (the hop oracle's result share) marks bookkeeping
    # whatever the head; a trailing "crc" is the checksummed wire
    # exchange, still the real transfer.
    bookkeeping = (family is None and head in FAMILY_OF) \
        or (len(signature) > 1 and signature[-1] == "fold")
    out["family"] = None if bookkeeping else family
    out["bookkeeping"] = bookkeeping
    idx = _SHAPE_AT.get(head)
    if idx is not None and len(signature) > idx:
        sig = signature[idx]
        if isinstance(sig, tuple) and len(sig) == 2:
            out["shape"], out["dtype"] = sig[0], _dtype_name(sig[1])
    if head.startswith("Reshard.") and len(signature) >= 5:
        out["group_size"] = signature[2]
        out["shape"] = signature[3]
        out["dtype"] = _dtype_name(signature[4])
    idx = _ALGO_AT.get(head)
    if idx is not None and len(signature) > idx:
        out["algorithm"] = signature[idx]
    idx = _CODEC_AT.get(head)
    if idx is not None and len(signature) > idx:
        out["codec"] = signature[idx]
    return out


@dataclass(frozen=True)
class CommEvent:
    """One observed communication operation.

    ``channel`` is the chokepoint: ``"exchange"`` (the rendezvous) or
    ``"p2p_send"`` / ``"p2p_recv"`` (the mailboxes).  ``payload_bytes``
    is the byte count of what crossed it (for a compressed wire, the
    encoded bytes).  ``retries`` counts the retry extensions this wait
    used.  ``status`` is ``"ok"`` or the raised error's class name.
    ``duration_s`` and ``wait_s`` (the part of it spent blocked on peers
    at the barriers) are host seconds; ``duration_s - wait_s`` is the
    rank's own local latency, the gray-failure detector's signal."""

    seq: int
    rank: int
    world: int                       # tracer-assigned world ordinal
    world_size: int
    channel: str
    op: str
    signature: Tuple = ()
    payload_bytes: int = 0
    duration_s: float = 0.0
    wait_s: float = 0.0
    t_start: float = 0.0
    retries: int = 0
    status: str = "ok"
    family: Optional[str] = None     # wire kind; None = bookkeeping/n.a.
    bookkeeping: bool = False
    unmodeled: bool = False
    algorithm: Optional[str] = None
    codec: Optional[str] = None
    bucket: Optional[str] = None     # innermost bucket/step label
    group_size: Optional[int] = None  # replica group (None = world)
    shape: Optional[Tuple] = None
    dtype: Optional[str] = None
    peer: Optional[int] = None       # p2p destination/source
    tag: Optional[int] = None
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        """JSON-friendly form (the signature repr'd), as the flight
        recorder and the Chrome-trace export write it."""
        d = {k: getattr(self, k) for k in (
            "seq", "rank", "world", "world_size", "channel", "op",
            "payload_bytes", "duration_s", "wait_s", "t_start",
            "retries", "status", "family", "bookkeeping", "algorithm",
            "codec", "bucket", "group_size", "peer", "tag")}
        d["signature"] = repr(self.signature)
        if self.shape is not None:
            d["shape"] = list(self.shape)
            d["dtype"] = self.dtype
        return d


@dataclass(frozen=True)
class StepSpan:
    """One step phase of one rank thread (``obs.step_phase``):
    ``phase`` is ``"forward"``, ``"backward"``, ``"exchange"`` or
    ``"update"``; ``step`` counts the rank's ``forward`` phases under
    the tracer (-1 before its first); ``t_start`` / ``t_end`` are host
    times (``time.perf_counter``), as a :class:`CommEvent`'s are."""

    world: int                       # tracer-assigned world ordinal
    rank: int
    step: int
    phase: str
    t_start: float
    t_end: float
