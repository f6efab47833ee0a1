"""The one census generator: program -> wire bytes, steps, collectives.

Port of ``mpi4torch_tpu/csched/census.py``.  ``program_census(program,
nelems, itemsize)`` computes from the IR alone, with no per-algorithm
tables:

* ``wire_bytes_per_rank`` — bytes received per rank over the schedule;
* ``seq_steps`` — sequential wire rounds (the latency proxy);
* ``hlo`` — the per-kind collective-op counts the JAX package's lowering
  of the program holds, honoring the knobs its emitters honor
  (``config.chain_unroll_max`` and ``config.phase_pipelined_ring``).
  The port's own recorded programs (:mod:`mpi4torch_tpu_torch.analyze`)
  hold the executed exchanges, which equal it wherever the JAX program
  has no loop (a ``lax.scan`` body counts once there).

Also the tier attribution (:func:`tier_of_group`), the per-tier census
(:func:`program_tier_census`) and the bandwidth-weighted cost
(:func:`weighted_cost`).  Every figure is the JAX package's.
"""

from __future__ import annotations

from typing import Dict

from .. import config as _config
from .. import constants as C
from ..runtime import CommError
from .ir import Program, Step

_HLO_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
              "collective_permute", "all_to_all")


def _zero_counts() -> Dict[str, int]:
    return {k: 0 for k in _HLO_KINDS}


def _ceil_log2(n: int) -> int:
    return max(1, (n - 1).bit_length()) if n > 1 else 0


# ---------------------------------------------------------------------------
# Per-kind census: (step, n, span_elems, itemsize)
#   -> (wire_bytes_per_rank, seq_steps, hlo_counts)
# ---------------------------------------------------------------------------


def _census_native_allreduce(step, n, elems, itemsize):
    s = elems * itemsize
    wire = 2.0 * s * (n - 1) / n if n > 1 else 0.0
    return wire, 2 * (n - 1), {"all_reduce": 1}


def _census_level_fold(step, n, elems, itemsize):
    groups, g = step.params
    # One all-gather over groups of g: each rank receives (g-1) shards.
    return (g - 1) * elems * itemsize, 1, {"all_gather": 1}


def _census_ring_fold(step, n, elems, itemsize):
    chunk = max(1, _config.ordered_ring_chunk_bytes() // itemsize)
    nchunks = -(-elems // chunk)
    cbytes = chunk * itemsize
    if _config.phase_pipelined_ring():
        steps = nchunks + 2 * (n - 1)
        # Two chunk-sized permutes per step (fold and relay lanes).
        return 2.0 * steps * cbytes, steps, {"collective_permute": 2}
    steps = n + nchunks - 1
    bcast = _ceil_log2(n)
    wire = steps * cbytes + bcast * elems * itemsize
    return wire, steps + bcast, {"collective_permute": 1 + bcast}


def _census_butterfly(step, n, elems, itemsize):
    s = elems * itemsize
    log = _ceil_log2(n)
    # Halving moves S/2 + S/4 + ... = S*(n-1)/n; doubling the same.
    return 2.0 * s * (n - 1) / n, 2 * log, {"collective_permute": 2 * log}


def _census_tree_reduce(step, n, elems, itemsize):
    s = elems * itemsize
    log = _ceil_log2(n)
    return float(log * s), log, {"collective_permute": log}


_census_tree_bcast = _census_tree_reduce


def _census_mask_root(step, n, elems, itemsize):
    return 0.0, 0, {}


def _census_ring_chain(step, n, elems, itemsize):
    """The ``bidir`` chains: ``2(n - 1)`` hops, counted as that many
    permutes up to ``config.chain_unroll_max()`` ranks (the JAX package
    unrolls them; larger worlds take a ``lax.scan`` of two permutes).
    The port's rank threads run every hop either way, so only the
    predicted ``hlo`` count reads the knob."""
    s = elems * itemsize
    hops = 2 * (n - 1)
    permutes = hops if n <= _config.chain_unroll_max() else 2
    return 2.0 * s * (n - 1) / n, hops, {"collective_permute": permutes}


def _census_grouped_sum(step, n, elems, itemsize):
    g, rs, ar, ag = step.params
    s = elems * itemsize
    ng = n // g
    wire = s * (g - 1) / g                      # grouped reduce-scatter
    wire += 2.0 * (s / g) * (ng - 1) / ng if ng > 1 else 0.0
    wire += s * (g - 1) / g                     # grouped all-gather
    steps = (g - 1) + 2 * (ng - 1) + (g - 1)
    return wire, steps, {"reduce_scatter": 1, "all_reduce": 1,
                         "all_gather": 1}


def _census_q8_ring_channel(step, n, elems, itemsize):
    from ..compress import get_codec

    codec = get_codec(step.codec)
    block = codec.base().block
    # int8 payload + one f32 scale per block, both directions of the
    # quantized ring (reduce-scatter hops + encoded gather), per round.
    per_elem = 1.0 + 4.0 / block
    wire_round = 2.0 * elems * per_elem * (n - 1) / n if n > 1 else 0.0
    rounds = codec.ef_rounds
    hlo = {"collective_permute": 2 * (n - 1) * rounds,
           "all_gather": 2 * rounds}
    return wire_round * rounds, 2 * (n - 1) * rounds, hlo


def _census_q8_level_fold(step, n, elems, itemsize):
    from ..compress import get_codec

    groups, g = step.params
    block = get_codec(step.codec or "q8").base().block
    nb = -(-max(elems, 1) // block)
    # One grouped gather of the encoded contribution: (g-1) members,
    # each a zero-padded int8 payload (lower.q8_fold_blocks) plus one
    # f32 scale per block, as two all-gathers (payload, scales).
    wire = (g - 1) * (nb * block + 4 * nb)
    return float(wire), 1, {"all_gather": 2}


CENSUS = {
    "native_allreduce": _census_native_allreduce,
    "level_fold": _census_level_fold,
    "ring_fold": _census_ring_fold,
    "butterfly": _census_butterfly,
    "tree_reduce": _census_tree_reduce,
    "tree_bcast": _census_tree_bcast,
    "mask_root": _census_mask_root,
    "ring_chain": _census_ring_chain,
    "grouped_sum": _census_grouped_sum,
    "q8_ring_channel": _census_q8_ring_channel,
    "q8_level_fold": _census_q8_level_fold,
}


def census_covers():
    """Step kinds the census table serves (registry-guard probe)."""
    return tuple(CENSUS)


def _span_elems(step: Step, nelems: int) -> int:
    if step.span == "all":
        return nelems
    m = C.multipath_split(nelems)
    return m if step.span[1] == 0 else max(0, nelems - m)


def program_census(program: Program, nelems: int, itemsize: int) -> Dict:
    """Wire/step/collective census of a program at a payload size.
    Multipath channels are concurrent: their wire bytes add, their
    sequential rounds take the maximum."""
    if program is None:
        return {"wire_bytes_per_rank": 0, "seq_steps": 0,
                "hlo": _zero_counts(), "nsteps": 0}
    wire = 0.0
    hlo = _zero_counts()
    seq = 0
    for phase in program.phases:
        chan_steps: Dict[object, int] = {}
        for step in phase.steps:
            fn = CENSUS.get(step.kind)
            if fn is None:
                raise CommError(
                    f"no census entry for IR step kind {step.kind!r}")
            elems = _span_elems(step, nelems)
            if elems == 0:
                continue
            w, s, h = fn(step, program.nranks, elems, itemsize)
            wire += w
            for k, v in h.items():
                hlo[k] = hlo.get(k, 0) + v
            chan_steps[step.span] = chan_steps.get(step.span, 0) + s
        if chan_steps:
            seq += max(chan_steps.values())
    return {"wire_bytes_per_rank": int(round(wire)), "seq_steps": seq,
            "hlo": hlo, "nsteps": program.nsteps}


# ---------------------------------------------------------------------------
# Tier attribution and the bandwidth-weighted census
# ---------------------------------------------------------------------------


def _tier_digits(rank: int, tiers):
    """Mixed-radix digits of a rank over the tier stack (innermost radix
    first), the row-major layout of :func:`.programs.chain_groups`."""
    out = []
    q = int(rank)
    for radix in tiers:
        out.append(q % radix)
        q //= radix
    return out


def tier_of_group(group, tiers) -> int:
    """The tier-attribution rule: a replica group's traffic belongs to
    the HIGHEST tier whose mixed-radix digit differs between any two
    members."""
    ds = [_tier_digits(r, tiers) for r in group]
    for pos in range(len(tiers) - 1, -1, -1):
        if any(d[pos] != ds[0][pos] for d in ds):
            return pos
    return 0


def tier_of_groups(groups, tiers) -> int:
    """Attribution of a grouped step: None (the whole axis) is the top
    tier; an explicit table takes the maximum over its groups."""
    if groups is None:
        return len(tiers) - 1
    return max(tier_of_group(g, tiers) for g in groups)


def program_tier_census(program: Program, nelems: int, itemsize: int,
                        tiers):
    """Per-tier wire bytes of a program (innermost tier first; sums to
    ``program_census(...)['wire_bytes_per_rank']``).  Grouped steps
    attribute by their group tables, ``grouped_sum`` per leg; whole-axis
    schedules are charged to the top tier."""
    tiers = tuple(int(t) for t in tiers)
    per = [0.0] * len(tiers)
    top = len(tiers) - 1
    if program is None:
        return [0] * len(tiers)
    for phase in program.phases:
        for step in phase.steps:
            elems = _span_elems(step, nelems)
            if elems == 0:
                continue
            n = program.nranks
            if step.kind in ("level_fold", "q8_level_fold"):
                groups, _g = step.params
                w, _, _ = CENSUS[step.kind](step, n, elems, itemsize)
                per[tier_of_groups(groups, tiers)] += w
            elif step.kind == "grouped_sum":
                g, rs, ar, ag = step.params
                s = elems * itemsize
                ng = n // g
                per[tier_of_groups(rs, tiers)] += s * (g - 1) / g
                if ng > 1:
                    per[tier_of_groups(ar, tiers)] += \
                        2.0 * (s / g) * (ng - 1) / ng
                per[tier_of_groups(ag, tiers)] += s * (g - 1) / g
            else:
                w, _, _ = CENSUS[step.kind](step, n, elems, itemsize)
                per[top] += w
    return [int(round(w)) for w in per]


def weighted_cost(per_tier, bandwidths=None) -> float:
    """The bandwidth-weighted wire cost ``sum(bytes[l] / bandwidth[l])``
    under the given per-tier bandwidths (None: uniform)."""
    per_tier = tuple(per_tier)
    if bandwidths is None:
        bandwidths = (1.0,) * len(per_tier)
    bandwidths = tuple(float(b) for b in bandwidths)
    if len(bandwidths) != len(per_tier):
        raise CommError(
            f"tier_bandwidths has {len(bandwidths)} entries for a "
            f"{len(per_tier)}-tier stack")
    return float(sum(w / b for w, b in zip(per_tier, bandwidths)))
