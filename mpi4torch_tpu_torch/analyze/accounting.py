"""Unified deterministic accounting passes over the shared parse.

Port of ``mpi4torch_tpu/analyze/accounting.py`` over recorded programs:

* :func:`wire_bytes_per_device` — per-device bytes-on-wire under the
  standard ring accountings: a ``collective_permute`` ships its operand
  once; an ``all_gather`` over groups of size s ships the local shard
  (s-1) times; an ``all_reduce`` 2(s-1)/s of the payload; a
  ``reduce_scatter`` (s-1)/s; an ``all_to_all`` keeps 1/s local and
  ships the rest.  Equal to JAX's on the same program.
* :func:`peak_live_bytes` — the last-use liveness scan over the recorded
  events: a value is live from the event that defines it (the start,
  for an argument) to its last use, a view or an in-place result is its
  base's value, and the peak of the summed live bytes wins.  Aten ops
  are not XLA's, so the figure is the port's own, not JAX's: exact about
  what the program holds (a gather of ``N x shard`` is live through its
  range however it runs), blind to the allocator's caching.
* :func:`scheduled_exposure` — the split-phase window census: a bucket
  whose ``.start``/``.wait`` span has another collective's wire op in
  flight inside it is *hidden*; an empty window (or a blocking,
  zero-width one) is *exposed*.  Blocking programs census 1.0 by
  construction, windowed split-phase programs strictly lower.  Exact
  about the program, conservative about the runtime: it never claims
  wall-clock hiding, only that the schedule keeps >= 2 transfers in
  flight.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .parse import WIRE_OPS, dtype_bytes, parse_program, tensor_bytes

__all__ = [
    "wire_contribution",
    "wire_bytes_per_device",
    "tier_wire_table",
    "weighted_wire_cost",
    "peak_live_bytes",
    "scheduled_exposure",
]


# ------------------------------------------------------------- wire bytes

def _payload_bytes(op) -> int:
    """Operand bytes with the historical strictness: the wire table is
    a verdict surface, so an UNKNOWN payload element type is an error,
    not a silent zero — while a legitimately empty payload (a
    zero-sized dim) prices at 0, as it always did."""
    desc = op.operand_types[0] if op.operand_types else ""
    n = tensor_bytes(desc)
    if n == 0 and dtype_bytes(op.dtype or "") is None:
        raise ValueError(f"unknown element type in {desc!r}")
    return n


def wire_contribution(kind: str, payload_bytes: float,
                      group_size: int = None) -> float:
    """Per-device bytes-on-wire of ONE collective under the standard
    ring accountings (module docstring): the one shared formula."""
    if kind == "collective_permute":
        return float(payload_bytes)
    s = group_size
    if s is None or s < 1:
        raise ValueError(
            f"{kind} needs a replica-group size to price; got {s!r}")
    if kind == "all_gather":
        return (s - 1) * float(payload_bytes)
    if kind == "all_reduce":
        return 2 * (s - 1) / s * float(payload_bytes)
    if kind in ("reduce_scatter", "all_to_all"):
        return (s - 1) / s * float(payload_bytes)
    raise ValueError(f"unknown wire collective kind {kind!r}")


def wire_bytes_per_device(program) -> Tuple[int, Dict[str, int]]:
    """Deterministic per-device bytes-on-wire of a recorded program
    (see module docstring for the per-kind accountings).  Returns
    ``(total_bytes, per-op-kind counts)``."""
    parsed = parse_program(program)
    wire = 0.0
    counts: Dict[str, int] = {}
    for op in parsed.collectives:
        if op.kind != "collective_permute" and op.group_size is None:
            continue  # no replica_groups: not a priceable transfer
        counts[op.kind] = counts.get(op.kind, 0) + 1
        wire += wire_contribution(op.kind, _payload_bytes(op),
                                  op.group_size)
    return int(round(wire)), counts


def _op_tier(op, tiers) -> int:
    """Tier of ONE parsed collective under the mixed-radix attribution
    rule (single source: :func:`~mpi4torch_tpu_torch.csched.census.
    tier_of_group` — the highest tier whose digit differs among any
    group's members).
    A ``collective_permute`` is attributed by its ``source_target_pairs``
    (each pair is a 2-member group); an op with no replica groups spans
    the whole axis and prices at the top tier."""
    from ..csched.census import tier_of_group

    top = len(tiers) - 1
    if op.kind == "collective_permute":
        pairs = op.source_target_pairs
        if not pairs:
            return top
        return max(tier_of_group(pair, tiers) for pair in pairs)
    if not op.replica_groups:
        return top
    return max(tier_of_group(g, tiers) for g in op.replica_groups)


def tier_wire_table(program, tiers) -> List[int]:
    """Per-tier split of :func:`wire_bytes_per_device` under a flat-world
    tier stack ``tiers`` (innermost first — the
    ``config.tier_stack()`` / ``tune.resolve_tier_stack`` grammar).

    Each parsed collective's whole wire contribution lands on the tier
    of its WIDEST replica-group span (an ``all_gather`` over an
    innermost-tier group is intra-pod traffic no matter how many such
    groups tile the axis; a group mixing outer-tier digits crosses the
    outer wire).  The returned ints sum to the
    :func:`wire_bytes_per_device` total, so this is a *breakdown*, not
    a second accounting — the same invariant
    :func:`mpi4torch_tpu_torch.csched.census.program_tier_census` keeps
    on the IR side."""
    tiers = tuple(int(g) for g in tiers)
    if not tiers:
        raise ValueError("tier_wire_table needs a non-empty tier stack")
    parsed = parse_program(program)
    per = [0.0] * len(tiers)
    for op in parsed.collectives:
        if op.kind != "collective_permute" and op.group_size is None:
            continue
        per[_op_tier(op, tiers)] += wire_contribution(
            op.kind, _payload_bytes(op), op.group_size)
    return [int(round(w)) for w in per]


def weighted_wire_cost(program, tier_bandwidths, tiers=None) -> float:
    """The bandwidth-weighted wire census of a recorded program:
    ``sum(tier_wire[l] / tier_bandwidths[l])`` — relative seconds-on-wire
    under the configured per-tier bandwidths, the ranking functional of
    tier synthesis (:func:`mpi4torch_tpu_torch.csched.synthesize_tiers`)
    read off the recorded run rather than the IR census.  ``tiers``
    defaults to ``config.tier_stack()`` (which must then be set)."""
    from ..csched.census import weighted_cost

    if tiers is None:
        from .. import config as _config

        tiers = _config.tier_stack()
        if tiers is None:
            raise ValueError(
                "weighted_wire_cost needs a tier stack: pass tiers= or "
                "set config.set_tier_stack(...)")
    return weighted_cost(tier_wire_table(program, tiers), tier_bandwidths)


# ----------------------------------------------------------- peak liveness

def peak_live_bytes(program) -> int:
    """Max over program points of the summed bytes of live values
    (live from definition to last use, arguments from the start), over
    one rank's recorded events: the ``reshard.peak_live_bytes`` contract
    on the shared parse."""
    parsed = parse_program(program)
    size: Dict[int, int] = {}
    born: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for vid, nbytes in parsed.arguments:
        size[vid], born[vid], last[vid] = nbytes, 0, 0
    for ev in parsed.events:
        for vid, nbytes in ev.results:
            size[vid], born[vid], last[vid] = nbytes, ev.line, ev.line
        for vid in ev.operands:
            if vid in size:
                last[vid] = max(last[vid], ev.line)

    marks: Dict[int, Tuple[int, int]] = {}
    for vid, b in size.items():
        s, e = marks.get(born[vid], (0, 0))
        marks[born[vid]] = (s + b, e)
        s, e = marks.get(last[vid], (0, 0))
        marks[last[vid]] = (s, e + b)
    live = peak = 0
    for i in sorted(marks):
        add, drop = marks[i]
        live += add
        peak = max(peak, live)
        live -= drop
    return peak


# ------------------------------------------------------ scheduled exposure

def scheduled_exposure(program) -> Dict:
    """Census a recorded program for scheduled communication exposure.

    Returns ``{"n_buckets", "n_exposed", "exposed_fraction",
    "buckets"}`` where ``buckets`` maps ``"<Op>.bucket<i>of<n>"`` to
    ``{"split_phase": bool, "exposed": bool}``.  ``exposed_fraction``
    is ``None`` when the program contains no bucket collectives (e.g. a
    program with no bucket spans).  The ``overlap.scheduled_exposure``
    contract, a pass over the shared parse's event stream."""
    parsed = parse_program(program)

    # One bucket_of() evaluation per event (the property regex-searches
    # the scope path on every access).
    by_bucket: Dict[tuple, Dict[str, List[int]]] = {}
    wire: List[tuple] = []
    for ev in parsed.events:
        b = ev.bucket
        if b is not None:
            slot = by_bucket.setdefault(b[:3], {"start": [], "wait": [],
                                                "plain": []})
            slot[b[3] or "plain"].append(ev.line)
        if ev.kind in WIRE_OPS:
            wire.append((ev.line, b[:3] if b is not None else None))

    buckets = {}
    n_exposed = 0
    for key in sorted(by_bucket):
        slot = by_bucket[key]
        split = bool(slot["start"] and slot["wait"])
        if split:
            lo, hi = max(slot["start"]), min(slot["wait"])
            hidden = any(lo < idx < hi and wkey != key
                         for idx, wkey in wire)
            exposed = not hidden
        else:
            # Blocking bucket (or a start that was never waited —
            # defensively exposed): zero-width completion window.
            exposed = True
        n_exposed += exposed
        op, i, n = key
        buckets[f"{op}.bucket{i}of{n}"] = {"split_phase": split,
                                           "exposed": exposed}

    nb = len(buckets)
    return {
        "n_buckets": nb,
        "n_exposed": n_exposed,
        "exposed_fraction": (round(n_exposed / nb, 4) if nb else None),
        "buckets": buckets,
    }
