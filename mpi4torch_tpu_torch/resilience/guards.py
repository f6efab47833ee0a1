"""Integrity guards: non-finite payload checks and compressed-wire
checksums.

Port of ``mpi4torch_tpu/resilience/guards.py`` for the rank-thread
runtime.  Both guards are off by default and cost one attribute read
per collective while off.

* ``config.comm_finite_guard`` in {"off", "warn", "raise"}: non-finite
  (NaN/Inf) contributions are named by rank in an
  :class:`~mpi4torch_tpu_torch.runtime.IntegrityError` or an
  :class:`IntegrityWarning` instead of folding silently into every
  rank's result.
* ``config.comm_wire_checksum``: a CRC32 leg on the compressed wire
  (compress/eager.py).  Each encoded payload travels with the checksum
  of its wire bytes, computed once by its sender; a mismatch (an
  injected ``bitflip`` on the int8 blocks, a corrupt scale) raises an
  ``IntegrityError`` naming the corrupt contributor.

On the card a check reads the device: the finite test ends in a sync
and the CRC needs the wire bytes on the host.  So the chokepoint form
(:func:`finite_check`, :func:`wire_check`, handed to
``World.exchange(checks=...)``) checks each contribution once, by its
own rank, after fault injection, and shares the verdicts through the
rendezvous: one device read per rank and rendezvous, not one per pair
of ranks, and every rank raises the same error with the same ``ranks``.
:func:`check_contributions` and :func:`verify_wire` keep the JAX
package's list form, for the p2p pipeline (where each rank holds its
own list) and for callers holding a list.

The Mode A guard (:func:`spmd_finite_value`, called on a collective's
input under ``run_spmd``) hands the same kind of check to a rendezvous of
its own, so every rank raises or warns alike, with the JAX package's
message and ledger entry.
"""

from __future__ import annotations

import threading
import warnings
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import config as _config
from ..runtime import IntegrityError
from ..utils.tree import tree_leaves

__all__ = [
    "IntegrityWarning",
    "check_contributions",
    "spmd_finite_value",
    "wire_checksum",
    "verify_wire",
    "last_violation",
    "clear_violations",
]


class IntegrityWarning(RuntimeWarning):
    """Warning class of ``comm_finite_guard="warn"``, filterable apart from
    other RuntimeWarnings."""


def _all_true(flags: List) -> List[bool]:
    """``flags`` (Python bools and 0-d bool tensors) as Python bools; the
    tensors of one device are read back together, in one device read."""
    idx = [i for i, f in enumerate(flags) if isinstance(f, torch.Tensor)]
    if len({flags[i].device for i in idx}) == 1:
        vals = torch.stack([flags[i] for i in idx]).tolist()
    else:
        vals = [bool(flags[i]) for i in idx]
    out = [bool(f) if not isinstance(f, torch.Tensor) else True
           for f in flags]
    for i, v in zip(idx, vals):
        out[i] = bool(v)
    return out


def _finite_flags(trees: Sequence) -> List[bool]:
    """Whether each tree's floating leaves are all finite, with one
    device read for the whole list (per device)."""
    flags: list = []
    for tree in trees:
        parts: list = []
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor):
                if leaf.numel() and leaf.is_floating_point():
                    parts.append(torch.isfinite(leaf).all())
            elif isinstance(leaf, np.ndarray) and leaf.size \
                    and np.issubdtype(leaf.dtype, np.floating):
                parts.append(bool(np.isfinite(leaf).all()))
        flags.append(parts[0] if len(parts) == 1 else parts)
    # A tree of several leaves contributes all of its parts to the read.
    flat = [p for f in flags for p in (f if isinstance(f, list) else [f])]
    vals = iter(_all_true(flat))
    return [all(next(vals) for _ in f) if isinstance(f, list)
            else next(vals) for f in flags]


def _report_nonfinite(bad: Sequence[int], opname: str, mode: str) -> None:
    bad = sorted(bad)
    msg = (f"non-finite payload from rank(s) {bad} in {opname} "
           f"(comm_finite_guard={mode!r}): a corrupt contribution would "
           "fold into every rank's result")
    _record(opname, mode, bad)
    if mode == "raise":
        raise IntegrityError(msg, ranks=bad)
    warnings.warn(msg, IntegrityWarning, stacklevel=3)


def check_contributions(vals: Sequence, opname: str) -> None:
    """Finite guard over a rank-ordered contribution list (index ``i`` is
    rank ``i``); a no-op while the guard is off.  Every rank that holds
    the same list raises or warns alike."""
    mode = _config.comm_finite_guard()
    if mode == "off":
        return
    bad = [i for i, ok in enumerate(_finite_flags(vals)) if not ok]
    if bad:
        _report_nonfinite(bad, opname, mode)


class _FiniteCheck:
    """The finite guard as a rendezvous check: ``ok`` tests this rank's
    own contribution (after ``decode``, when the wire is encoded)."""

    def __init__(self, opname: str, mode: str, decode=None):
        self.opname, self.mode, self.decode = opname, mode, decode

    def ok(self, payload) -> bool:
        if self.decode is not None:
            payload = self.decode(payload)
        return _finite_flags([payload])[0]

    def report(self, bad: Sequence[int]) -> None:
        _report_nonfinite(bad, self.opname, self.mode)


def finite_check(opname: str, decode=None) -> tuple:
    """The ``checks`` of an exchange under the finite guard: ``()`` while
    ``comm_finite_guard`` is off, else one check of each rank's
    contribution (``decode(payload)`` for an encoded wire)."""
    mode = _config.comm_finite_guard()
    if mode == "off":
        return ()
    return (_FiniteCheck(opname, mode, decode),)


# ---------------------------------------------------------------- ledger

# Violation ledger: the deterministic poll surface of the guard.
_violations: List[dict] = []
_viol_lock = threading.Lock()


def _record(where: str, mode: str, ranks=()) -> None:
    with _viol_lock:
        _violations.append(
            {"where": where, "mode": mode, "ranks": sorted(ranks)})
    from ..obs import metrics as _metrics
    _metrics.inc("integrity_violations_total",
                 help="finite-guard/checksum violations recorded by the "
                      "resilience guards")


def last_violation() -> Optional[dict]:
    """The most recent finite-guard violation record, or None."""
    with _viol_lock:
        return _violations[-1] if _violations else None


def clear_violations() -> None:
    with _viol_lock:
        _violations.clear()


class _SpmdFiniteCheck:
    """The Mode A finite guard as a rendezvous check, reporting with the
    JAX package's Mode A message."""

    def __init__(self, where: str, mode: str):
        self.where, self.mode = where, mode

    def ok(self, payload) -> bool:
        return _finite_flags([payload])[0]

    def report(self, bad: Sequence[int]) -> None:
        bad = sorted(bad)
        _record(self.where, self.mode, bad)
        msg = (f"non-finite payload entering {self.where} "
               f"(comm_finite_guard={self.mode!r})")
        if self.mode == "raise":
            raise IntegrityError(msg, ranks=bad)
        warnings.warn(msg, IntegrityWarning, stacklevel=3)


def spmd_finite_value(x, where: str):
    """Mode A finite guard hook, called on a collective's input.
    ``comm_finite_guard="off"`` (default) returns ``x`` untouched: no op,
    no sync.  "warn"/"raise" check each rank's floating input once, on
    its own rank, in a rendezvous that shares the verdicts, so every rank
    warns or raises :class:`IntegrityError` alike (``ranks`` names the
    corrupt ones) and the ledger (:func:`last_violation`) records it."""
    mode = _config.comm_finite_guard()
    if mode == "off" or not x.is_floating_point():
        return x
    from ..ops.spmd import current_spmd_context
    ctx = current_spmd_context()
    ctx.world.exchange(ctx.rank, ("spmd.finite_guard", where,
                                  (tuple(x.shape), str(x.dtype))), x,
                       read=lambda vals: None,
                       checks=(_SpmdFiniteCheck(where, mode),))
    return x


# ------------------------------------------------------------- checksums

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype)[len("torch."):]


def _host_bytes(leaf) -> Optional[bytes]:
    """The bytes a non-tensor leaf contributes to the checksum, as
    ``np.asarray(leaf).tobytes()`` gives them in the JAX package (a
    string in UCS-4, an int as int64); a torch dtype as its JAX name.
    None contributes nothing."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.dtype):
        leaf = _dtype_name(leaf)
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def wire_checksum(payload) -> int:
    """CRC32 over the wire bytes of an encoded payload's leaves, in tree
    order.  Equal to the JAX package's checksum of the same encoded wire
    where the trees hold the same values in the same order: tensors by
    their raw bytes (a bf16 leaf through an int16 view, as numpy sees
    it), meta strings and ints as numpy encodes them, and the meta's
    torch dtype by its JAX name.  The tensor leaves are copied to the
    host together, in one device-to-host copy."""
    leaves = tree_leaves(payload)
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    host = None
    if tensors:
        flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
                for t in tensors]
        host = (torch.cat(flat) if len(flat) > 1 else flat[0]) \
            .cpu().numpy()
    c, offset = 0, 0
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            n = leaf.numel() * leaf.element_size()
            c = zlib.crc32(host[offset:offset + n].tobytes(), c)
            offset += n
            continue
        b = _host_bytes(leaf)
        if b is not None:
            c = zlib.crc32(b, c)
    return c & 0xFFFFFFFF


def _report_checksum(bad: Sequence[int], opname: str) -> None:
    raise IntegrityError(
        f"compressed wire checksum mismatch for rank(s) {sorted(bad)} in "
        f"{opname}: the encoded payload was corrupted in transit "
        "(comm_wire_checksum guard)", ranks=sorted(bad))


def verify_wire(items: Sequence, opname: str) -> List:
    """Verify a rank-ordered list of checksummed wire tuples ``(meta,
    payload, crc)``; returns the ``(meta, payload)`` list.  The CRC
    covers the meta as well as the payload: a codec's block scales steer
    the decode as much as its blocks.  A mismatch raises
    :class:`~mpi4torch_tpu_torch.runtime.IntegrityError` naming the
    corrupt contributor(s)."""
    bad, out = [], []
    for r, (meta, payload, crc) in enumerate(items):
        if wire_checksum((meta, payload)) != crc:
            bad.append(r)
        out.append((meta, payload))
    if bad:
        _report_checksum(bad, opname)
    return out


class _WireCheck:
    """The checksum as a rendezvous check of a ``(meta, payload, crc)``
    item: ``ok`` recomputes the CRC of the item as deposited."""

    def __init__(self, opname: str):
        self.opname = opname

    def ok(self, item) -> bool:
        meta, payload, crc = item
        return wire_checksum((meta, payload)) == crc

    def report(self, bad: Sequence[int]) -> None:
        _report_checksum(bad, self.opname)


def wire_check(opname: str) -> tuple:
    """The ``checks`` of a checksummed wire exchange."""
    return (_WireCheck(opname),)
