"""Static-vs-runtime reconciliation: the traced Mode B wire against the
``analyze`` predictions of the matching Mode A lowering.

Port of ``mpi4torch_tpu/obs/reconcile.py``.  :func:`reconcile` joins
what the Mode B chokepoints *measured* against what
:func:`mpi4torch_tpu_torch.analyze.wire_bytes_per_device` *predicts*
for the equivalent Mode A program, and the match is EXACT, not
statistical: Mode B payload bytes are censused at the rendezvous, never
sampled.

Every modeled Mode B logical collective is converted to the per-device
wire bytes and collective-kind counts its Mode A execution would
census:

* uncompressed ring-path collectives use THE shared accounting formula
  (:func:`mpi4torch_tpu_torch.analyze.wire_contribution`, one
  definition for the static pass and the runtime conversion) with a 1:1
  logical -> collective count (an Allreduce is one ``all_reduce``, a
  reshard permute step one ``collective_permute``, ...), except where
  Mode A runs an Allreduce as the reduce_scatter + all_gather pair: a
  split-phase ``.start`` bucket (the JAX package's rule) and a blocking
  fused exact ring bucket of ``Allreduce_tree`` (the port's addition:
  the JAX package counts that bucket as one ``all_reduce``, which its
  Mode A lowering does not hold, so its fused exact trees never
  reconcile);
* compressed or non-ring Allreduce events carry their codec/algorithm
  labels in the rendezvous signature, and their conversion **records
  the equivalent single collective** (same shape, dtype, codec,
  algorithm and world) with :func:`analyze.lower` and censuses it with
  the same pass, so the in-schedule q8 pipeline's int8 + scale permute
  schedule is priced exactly.  The JAX package lowers that collective
  to StableHLO text; the port records it as it runs once on
  ``run_spmd`` rank threads (its K1 hops launch on a card), cached under
  the JAX package's key, so one record serves the total and every tier
  split.

``reconcile(events, lowered)`` then asserts two exact equalities: total
per-device wire bytes, and the per-kind collective counts.  A passing
report proves the runtime executed exactly the collectives the recorded
program holds: no extra rendezvous, none missing, none resized, the
codec really on the wire.

Fold-once shares and barriers are *bookkeeping* (thread-rendezvous
artifacts with no Mode A wire op) and are excluded but counted;
root/varying-shape collectives (``Bcast_``, ``Gather``, ...) and raw p2p
traffic are listed as *unmodeled* rather than mispriced; exact byte
equality needs payloads divisible by the replica-group size (the
fractional accountings round once on each side).  Where the recorded
program loops (the ordered ring fold, bidir chains past
``config.chain_unroll_max``) the port prices every trip, as the runtime
sends it (ROADMAP.md Queue 3 item 17: JAX prices the loop body once).
``scheduled_exposure`` of the program rides along in the prediction.

The equivalent recordings run on ``device`` (the card unless the caller
passes ``"cpu"``); without a card and without ``device="cpu"`` these
functions raise, cached or not.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["measured_wire_table", "reconcile", "equivalent_wire",
           "equivalent_tier_wire"]


# Equivalent single-collective censuses, keyed by the logical signature
# (head, shape, dtype, codec, algorithm, world size, knob fingerprint).
_equiv_cache: Dict[tuple, Tuple[int, Dict[str, int]]] = {}

# The equivalent recordings under the same key: the tier breakdown
# (:func:`equivalent_tier_wire`) re-censuses the SAME record per tier
# stack instead of recording again.
_equiv_program_cache: Dict[tuple, object] = {}
_equiv_tier_cache: Dict[tuple, List[int]] = {}

# The heads the equivalent recording can reproduce (their signatures
# carry the full shape/dtype and the facade call is a plain Allreduce);
# anything else that cannot take the formula path is classified
# unmodeled upstream (events._UNMODELED_HEADS), never crashed on.
_EQUIV_HEADS = ("Allreduce", "Allreduce.q8hop", "Allreduce.c")


def _needs_equivalent_lowering(ev) -> bool:
    if ev.op not in _EQUIV_HEADS:
        return False
    return (ev.codec is not None
            or ev.algorithm not in (None, "auto", "ring"))


def _equiv_key(ev) -> tuple:
    from .. import config as _config

    # The recording depends on the knobs the schedules read (quant hop
    # impl, ring chunk bytes, hier group, tier stack, ...): fold the
    # fingerprint in so a knob change never serves a stale census.
    return (ev.op, tuple(ev.shape or ()), ev.dtype, ev.codec,
            ev.algorithm, ev.world_size,
            _config.thresholds_fingerprint())


def _equivalent_program(ev, key: tuple, device):
    """The recorded Mode A program equivalent to one Mode B collective
    event (the same facade call, shape, dtype, codec and algorithm, over
    an ``ev.world_size``-rank ``run_spmd`` world on ``device``); cached
    per logical signature so the total census and every tier breakdown
    read ONE recording."""
    got = _equiv_program_cache.get(key)
    if got is not None:
        return got
    if ev.shape is None or ev.dtype is None:
        raise ValueError(
            f"event {ev.op} carries no shape/dtype signature — cannot "
            "record its equivalent collective")
    import torch

    from .. import MPI_SUM
    from ..analyze.sweep import _flat_lowerer

    codec = ev.codec if ev.codec is not None else False
    algo = None if ev.algorithm in (None, "auto") else ev.algorithm
    lower, _ = _flat_lowerer(ev.world_size, device)
    x = torch.zeros(tuple(ev.shape), dtype=getattr(torch, ev.dtype))
    got = lower(lambda c, v: c.Allreduce(v, MPI_SUM, compression=codec,
                                         algorithm=algo), x)
    _equiv_program_cache[key] = got
    return got


def equivalent_wire(ev, device=None) -> Tuple[int, Dict[str, int]]:
    """Per-device wire bytes and collective-kind counts of the Mode A
    program equivalent to one Mode B collective event, censused with
    :func:`analyze.wire_bytes_per_device`.  Cached per logical
    signature; a miss records the collective on ``device``."""
    from .. import analyze
    from ..runtime import resolve_device

    dev = resolve_device(device)
    key = _equiv_key(ev)
    got = _equiv_cache.get(key)
    if got is not None:
        return got
    got = analyze.wire_bytes_per_device(_equivalent_program(ev, key, dev))
    _equiv_cache[key] = got
    return got


def equivalent_tier_wire(ev, tiers, device=None) -> List[int]:
    """Per-tier wire bytes of the equivalent Mode A program of one
    Mode B collective event: :func:`analyze.tier_wire_table` over the
    SAME cached recording :func:`equivalent_wire` censuses, so the tier
    breakdown can only split the total, never disagree with it.  This
    prices grouped and compressed schedules (hier, tier-stack folds, q8
    pipelines) per tier from the replica groups of the recorded run, not
    a formula."""
    from .. import analyze
    from ..runtime import resolve_device

    dev = resolve_device(device)
    tiers = tuple(int(g) for g in tiers)
    key = _equiv_key(ev) + (tiers,)
    got = _equiv_tier_cache.get(key)
    if got is not None:
        return got
    got = analyze.tier_wire_table(
        _equivalent_program(ev, key[:-1], dev), tiers)
    _equiv_tier_cache[key] = got
    return got


def _bucket(ev, adjoint: bool = False):
    """``(op, bucket, total, phase)`` of the event's bucket label (with
    ``adjoint``, else that of the forward bucket whose adjoint it is), or
    None."""
    label = ev.bucket or (ev.extra.get("adjoint_of") if adjoint else None)
    if not label:
        return None
    from ..analyze.parse import bucket_of

    return bucket_of(label)


def _split_phase_start(ev) -> bool:
    """True when the event ran inside a split-phase ``.start`` bucket
    scope (the eager ``Allreduce_start`` runs its blocking rendezvous
    within the start span, carried into the event's bucket label by the
    tracer's label stack)."""
    b = _bucket(ev)
    return b is not None and b[3] == "start"


def _fused_ring_pair(ev) -> bool:
    """True for a blocking fused exact SUM bucket on the ring, or its
    adjoint: Mode A's ``Allreduce_tree`` runs it as a reduce_scatter of
    the bucket padded to the rank count + an all_gather of the scattered
    part (``fuse/collectives.py``), and its adjoint as the transposed
    pair, where Mode B runs one Allreduce rendezvous each way.  (The JAX
    package's conversion counts each as one ``all_reduce``, which its own
    Mode A lowering never holds.)"""
    from ..constants import MPI_SUM

    b = _bucket(ev, adjoint=True)
    return (b is not None and b[0] == "Allreduce_tree" and b[3] is None
            and ev.op == "Allreduce" and ev.codec is None
            and ev.algorithm in (None, "auto", "ring")
            and len(ev.signature) > 1 and ev.signature[1] == MPI_SUM)


def _formula_row(ev) -> Tuple[float, Dict[str, int]]:
    from ..analyze import wire_contribution

    s = ev.group_size if ev.group_size else ev.world_size
    pair = {"reduce_scatter": 1, "all_gather": 1}
    if ev.family == "all_reduce" and _split_phase_start(ev):
        # A split-phase Allreduce records in Mode A as the explicit
        # reduce_scatter + all_gather PAIR (the start issues the RS, the
        # Wait completes the AG): the same total wire, two ops.
        return (wire_contribution("reduce_scatter", ev.payload_bytes, s)
                + wire_contribution("all_gather", ev.payload_bytes / s,
                                    s), pair)
    if ev.family == "all_reduce" and s > 1 and _fused_ring_pair(ev):
        # The same pair, over the bucket padded to a multiple of s.
        numel = math.prod(ev.shape) if ev.shape else 0
        padded = (-(-numel // s) * s * ev.payload_bytes // numel
                  if numel else 0)
        return (wire_contribution("reduce_scatter", padded, s)
                + wire_contribution("all_gather", padded / s, s), pair)
    return (wire_contribution(ev.family, ev.payload_bytes, s),
            {ev.family: 1})


def _formula_tier(ev, tiers: tuple) -> int:
    """Tier of a formula-priced event: formula rows are plain ring-path
    collectives whose replica group is a contiguous run of ranks, so a
    group size equal to the product of the first j tier factors spans
    exactly tiers 0..j-1; anything else, the whole world included,
    crosses the top tier.  Grouped schedules whose groups are NOT
    contiguous runs (hier's strided stage, tier-stack folds) never take
    this path: their algorithm label routes them through the equivalent
    recording, whose replica groups give the tier."""
    s = ev.group_size if ev.group_size else ev.world_size
    p = 1
    for j, g in enumerate(tiers):
        p *= g
        if s == p:
            return j
    return len(tiers) - 1


def measured_wire_table(events: Iterable, rank: Optional[int] = None,
                        tiers=None, device=None) -> dict:
    """Convert a Mode B event stream into the analyzer's census
    vocabulary: per-device wire bytes + per-kind collective counts.

    Uses ONE rank's events (``rank=None``: the lowest rank present; wire
    accountings are per device) after checking every rank recorded the
    SAME logical collective sequence (op, family, bytes, group).
    Returns ``{"wire_bytes", "counts", "logical_events", "by_op",
    "per_rank_consistent", "excluded", ...}``; with a tier stack
    ``tiers`` the report also carries ``"tier_wire"``, the per-tier
    split of ``wire_bytes`` (equivalent-recording rows read their tiers
    from the recorded replica groups via :func:`equivalent_tier_wire`,
    formula rows from the contiguous-run rule), summing to the total
    exactly.  Equivalent recordings run on ``device``."""
    from ..runtime import resolve_device

    dev = resolve_device(device)
    events = list(events)
    evs = [e for e in events if e.channel == "exchange"]
    ranks = sorted({e.rank for e in evs})
    n_spmd = sum(1 for e in events if e.channel == "spmd")

    def logical(seq):
        """The modeled, completed logical collectives of one rank's
        event sequence."""
        return [e for e in seq
                if e.status == "ok" and not e.bookkeeping
                and e.family is not None and not e.unmodeled]

    per_rank = {r: logical([e for e in evs if e.rank == r])
                for r in ranks}
    use = (rank if rank is not None else ranks[0]) if ranks else None
    rows = per_rank.get(use, [])

    # Exclusions of the selected rank (symmetric when the consistency
    # check holds), except p2p and Mode A spmd step events, reported
    # trace-wide (p2p is asymmetric; spmd events have no rank): every
    # dropped event class is counted, never filtered silently.
    excluded = {"bookkeeping": 0, "errors": 0, "unmodeled": {},
                "p2p": sum(1 for e in events
                           if e.channel in ("p2p_send", "p2p_recv")),
                "spmd": n_spmd}
    for e in evs:
        if e.rank != use:
            continue
        if e.status != "ok":
            excluded["errors"] += 1
        elif e.unmodeled:
            excluded["unmodeled"][e.op] = \
                excluded["unmodeled"].get(e.op, 0) + 1
        elif e.bookkeeping or e.family is None:
            excluded["bookkeeping"] += 1

    def fingerprint(seq):
        return [(e.op, e.family, e.payload_bytes, e.group_size,
                 e.algorithm, e.codec, e.bucket) for e in seq]

    consistent = len({tuple(fingerprint(v)) for v in per_rank.values()}
                     ) <= 1

    tiers = tuple(int(g) for g in tiers) if tiers is not None else None
    tier_wire = [0.0] * len(tiers) if tiers is not None else None
    wire = 0.0
    counts: Dict[str, int] = {}
    by_op: Dict[str, dict] = {}
    for e in rows:
        if _needs_equivalent_lowering(e):
            b, c = equivalent_wire(e, dev)
            if tiers is not None:
                for level, tw in enumerate(
                        equivalent_tier_wire(e, tiers, dev)):
                    tier_wire[level] += tw
        else:
            b, c = _formula_row(e)
            if tiers is not None:
                tier_wire[_formula_tier(e, tiers)] += b
        wire += b
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        slot = by_op.setdefault(e.op, {"events": 0, "wire_bytes": 0.0,
                                       "payload_bytes": 0})
        slot["events"] += 1
        slot["wire_bytes"] += b
        slot["payload_bytes"] += e.payload_bytes
    for slot in by_op.values():
        slot["wire_bytes"] = int(round(slot["wire_bytes"]))
    out = {
        "rank": use,
        "wire_bytes": int(round(wire)),
        "counts": counts,
        "logical_events": len(rows),
        "by_op": by_op,
        "per_rank_consistent": consistent,
        "ranks": ranks,
        "excluded": excluded,
    }
    if tiers is not None:
        out["tiers"] = list(tiers)
        out["tier_wire"] = [int(round(w)) for w in tier_wire]
    return out


def reconcile(events_or_tracer, lowered, rank: Optional[int] = None,
              dropped: Optional[int] = None, tiers=None,
              device=None) -> dict:
    """Join a traced Mode B event stream against the ``analyze``
    predictions of the matching recorded Mode A program (a
    :class:`~mpi4torch_tpu_torch.analyze.LoweredProgram` from
    ``analyze.lower`` or ``Engine.lower_step``, or its
    :class:`~mpi4torch_tpu_torch.analyze.ParsedProgram`; text raises
    ``TypeError``, as ``parse_program`` does).

    ``events_or_tracer`` is the :class:`~.trace.CommTracer` itself
    (preferred: its ``dropped`` count is read, so a truncated trace can
    never reconcile by omission) or a plain event list (then pass
    ``dropped=tracer.dropped``; it defaults to 0 only for event lists
    that never lived in a bounded tracer).

    Returns a report whose ``ok`` is True iff (1) every rank recorded
    the same logical collective sequence, (2) the measured per-device
    wire bytes equal :func:`analyze.wire_bytes_per_device` of the
    program EXACTLY, (3) the measured per-kind collective counts equal
    the program's exactly, and (4) the tracer dropped nothing.  With a
    tier stack ``tiers`` (innermost first) ``matches["tier_wire"]``
    also demands the per-tier split match EXACTLY.  Equivalent
    recordings run on ``device`` (the card unless ``"cpu"``); they skip
    the comm tracer, so reconciling inside an open trace adds no event
    to it."""
    from .. import analyze

    parsed = analyze.parse_program(lowered)
    events = events_or_tracer
    if hasattr(events, "events") and hasattr(events, "dropped"):
        if dropped is None:
            dropped = events.dropped
        events = events.events
    if dropped is None:
        dropped = 0
    measured = measured_wire_table(events, rank=rank, tiers=tiers,
                                   device=device)
    pred_bytes, pred_counts = analyze.wire_bytes_per_device(parsed)
    exposure = analyze.scheduled_exposure(parsed)
    matches = {
        "wire_bytes": measured["wire_bytes"] == pred_bytes,
        "counts": measured["counts"] == pred_counts,
    }
    predicted = {
        "wire_bytes": pred_bytes,
        "counts": pred_counts,
        "scheduled_exposure": exposure["exposed_fraction"],
    }
    if tiers is not None:
        predicted["tier_wire"] = analyze.tier_wire_table(parsed, tiers)
        matches["tier_wire"] = (measured["tier_wire"]
                                == predicted["tier_wire"])
    return {
        "measured": measured,
        "predicted": predicted,
        "matches": matches,
        "dropped_events": int(dropped),
        "ok": bool(all(matches.values())
                   and measured["per_rank_consistent"]
                   and not dropped),
    }
