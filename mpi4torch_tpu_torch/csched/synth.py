"""Schedule synthesis: an autotuner leg searching over IR programs.

Port of ``mpi4torch_tpu/csched/synth.py`` (its ``chain_groups`` lives in
:mod:`.programs`).  Once algorithms are programs, new schedules are
points in a search space.  The bounded family here is the multi-level
grouped ordered fold: one ``level_fold`` tier per factor of an ordered
factorization chain of the world size (``hier`` is the 2-level member;
deeper chains are new programs).  Candidates are scored on the
deterministic census (:mod:`.census`: wire bytes, then sequential rounds,
then the digest as a stable tie-break), so synthesis is a pure function
of ``(nranks, nbytes bucket)``.

Winners are cached under the tune cache's key like measured algorithms:
the entry's algorithm is ``synth:<digest>`` and the entry carries the
serialized program, which installs into the in-process registry on
lookup, so a later process lowers or interprets the winner without
searching again.  ``tune.select_auto`` serves installed synthesized
winners in deterministic mode.  Both modes run the same program: Mode A
lowers it (:mod:`.lower`), the rank threads fold through its
interpretation (:func:`.interp.interpret_allreduce`), so the two stay
bitwise alike.  Programs, reports and digests are the JAX package's.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch

from ..runtime import CommError
from .census import (program_census, program_tier_census,
                     tier_of_groups, weighted_cost)
from .ir import Phase, Program, Step
from .programs import chain_groups

# In-process registry of installed synthesized programs, keyed by the
# full cache name ("synth:<digest>"): filled by synthesis runs in this
# process and by persisted tune-cache entries on lookup, from any rank
# thread.
_INSTALLED: Dict[str, Program] = {}
_lock = threading.Lock()

SYNTH_PREFIX = "synth:"

# Search bound: factorization chains up to this many tiers (each member
# costs (factor - 1) x S of wire, so the useful depth is log2(n); four
# tiers cover worlds to 16 ranks exhaustively).
MAX_LEVELS = 4


def is_synth_name(name) -> bool:
    return isinstance(name, str) and name.startswith(SYNTH_PREFIX)


def factorization_chains(n: int, max_levels: int = MAX_LEVELS
                         ) -> List[Tuple[int, ...]]:
    """Ordered factorizations of ``n`` into factors >= 2 (up to
    ``max_levels`` factors), sorted.  ``(n,)``, the single flat tier, is
    always a member."""
    out = set()

    def rec(rem: int, chain: Tuple[int, ...]):
        if rem == 1:
            if chain:
                out.add(chain)
            return
        if len(chain) == max_levels - 1:
            out.add(chain + (rem,))
            return
        for f in range(2, rem + 1):
            if rem % f == 0:
                rec(rem // f, chain + (f,))

    rec(n, ())
    return sorted(out)


def _prod(t) -> int:
    p = 1
    for f in t:
        p *= int(f)
    return p


def fold_program(n: int, chain: Tuple[int, ...], tiers=None) -> Program:
    """The multi-level grouped ordered-fold program of a chain.  Each
    step carries its tier index: the chain position, or, given the
    physical tier stack ``tiers``, the stack tier its groups cross
    (:func:`.census.tier_of_groups`)."""
    if any(f < 2 for f in chain) or _prod(chain) != n:
        raise CommError(
            f"factorization chain {chain} does not factor a {n}-rank "
            "world into tiers of >= 2")
    steps = tuple(
        Step("level_fold", (groups, f),
             tier=(tier_of_groups(groups, tiers)
                   if tiers is not None else level))
        for level, (groups, f) in enumerate(chain_groups(n, chain)))
    return Program("allreduce", "synth", n, (Phase("seq", steps),))


def synthesize(n: int, nbytes: int, itemsize: int = 4) -> Dict:
    """Search the family at one ``(nranks, nbytes)`` point.  Returns every
    candidate's census, the winner (name, chain, program, census) and the
    deterministic ring it is scored against (the ordered fold, the
    schedule a synthesized winner replaces)."""
    from .. import constants as C
    from .programs import allreduce_program

    nelems = max(1, nbytes // itemsize)
    ring = allreduce_program("ring", n, C.MPI_SUM, deterministic=True,
                             nelems=nelems, itemsize=itemsize)
    ring_census = program_census(ring, nelems, itemsize)
    candidates = []
    for chain in factorization_chains(n):
        prog = fold_program(n, chain)
        candidates.append((chain, prog,
                           program_census(prog, nelems, itemsize)))
    if not candidates:
        # A one-rank world has no schedule to synthesize.
        return {"nranks": n, "nbytes": int(nbytes), "winner": None,
                "chain": [], "program": None, "census": ring_census,
                "ring_census": ring_census,
                "synthesis_beats_ring": False, "candidates": []}
    ranked = sorted(
        candidates,
        key=lambda c: (c[2]["wire_bytes_per_rank"], c[2]["seq_steps"],
                       c[1].digest()))
    chain, prog, cen = ranked[0]
    beats = (cen["wire_bytes_per_rank"]
             < ring_census["wire_bytes_per_rank"]) or (
        cen["wire_bytes_per_rank"] == ring_census["wire_bytes_per_rank"]
        and cen["seq_steps"] < ring_census["seq_steps"])
    return {
        "nranks": n,
        "nbytes": int(nbytes),
        "winner": SYNTH_PREFIX + prog.digest(),
        "chain": list(chain),
        "program": prog,
        "census": cen,
        "ring_census": ring_census,
        "synthesis_beats_ring": bool(beats),
        "candidates": [
            {"chain": list(ch), "wire_bytes_per_rank":
                c["wire_bytes_per_rank"], "seq_steps": c["seq_steps"]}
            for ch, _p, c in ranked],
    }


# ---------------------------------------------------------------------------
# Tier-dimension synthesis
# ---------------------------------------------------------------------------

# The per-tier (algorithm x codec) compositions the tier search emits:
# "exact" is a tier-annotated grouped fold chain; "q8-slow" rewrites the
# folds of the slow tiers (bandwidth strictly below the fastest) into
# q8_level_fold codec hops, spending quantization where the link is slow.
TIER_COMPOSITIONS = ("exact", "q8-slow")


def rewrite_fold_codec(program: Program, slow_tiers,
                       codec: str = "q8") -> Program:
    """Per-tier codec rewrite: every ``level_fold`` whose tier index is in
    ``slow_tiers`` becomes a ``q8_level_fold`` carrying ``codec``."""
    slow = frozenset(slow_tiers)
    phases = tuple(
        Phase(ph.kind, tuple(
            Step("q8_level_fold", s.params, s.span, codec, s.tier)
            if s.kind == "level_fold" and s.tier in slow else s
            for s in ph.steps))
        for ph in program.phases)
    return Program(program.collective, program.algorithm,
                   program.nranks, phases, program.codec)


def _resolved_tiers(n: int, tiers):
    from .. import config as _config

    if tiers is None:
        tiers = _config.tier_stack()
    if tiers is None:
        return (n,)
    tiers = tuple(int(t) for t in tiers)
    if _prod(tiers) != n or any(t < 2 for t in tiers):
        raise CommError(
            f"tier_stack {tiers} does not factor a {n}-rank world "
            "into tiers of >= 2")
    return tiers


def synthesize_tiers(n: int, nbytes: int, itemsize: int = 4,
                     tiers=None, tier_bandwidths=None,
                     codec: str = "q8") -> Dict:
    """The tier-dimension search: per-tier compositions ranked by the
    bandwidth-weighted wire census (:func:`.census.weighted_cost` over
    :func:`.census.program_tier_census`), scored against the flat
    ``bidir`` schedule, whose whole-axis traffic crosses the slowest
    tier.  Candidates are every ordered factorization chain of ``n``,
    each in its ``TIER_COMPOSITIONS`` variants; the lossy ``q8-slow``
    variants exist only when some tier is strictly slower than the
    fastest, so with uniform bandwidths the search is all-exact."""
    from .. import config as _config
    from .. import constants as C
    from .programs import allreduce_program

    nelems = max(1, nbytes // itemsize)
    tiers = _resolved_tiers(n, tiers)
    if tier_bandwidths is None:
        tier_bandwidths = _config.tier_bandwidths()
    if tier_bandwidths is None:
        tier_bandwidths = (1.0,) * len(tiers)
    bw = tuple(float(b) for b in tier_bandwidths)
    if len(bw) != len(tiers):
        raise CommError(
            f"tier_bandwidths {bw} has {len(bw)} entries for the "
            f"{len(tiers)}-tier stack {tiers}")
    base = {"nranks": n, "nbytes": int(nbytes), "tiers": list(tiers),
            "tier_bandwidths": list(bw)}
    if n <= 1:
        return dict(base, winner=None, exact_winner=None,
                    beats_bidir=False, candidates=[])
    bidir = allreduce_program("bidir", n, C.MPI_SUM, deterministic=False,
                              nelems=nelems, itemsize=itemsize)
    bidir_tier = program_tier_census(bidir, nelems, itemsize, tiers)
    bidir_cost = weighted_cost(bidir_tier, bw)
    slow = tuple(level for level, b in enumerate(bw) if b < max(bw))
    candidates = []
    for chain in factorization_chains(n):
        exact = fold_program(n, chain, tiers)
        variants = [("exact", exact)]
        if slow and codec is not None:
            lossy = rewrite_fold_codec(exact, slow, codec)
            if lossy != exact:
                variants.append(("q8-slow", lossy))
        for comp, prog in variants:
            per_tier = program_tier_census(prog, nelems, itemsize, tiers)
            candidates.append({
                "chain": chain, "composition": comp, "program": prog,
                "census": program_census(prog, nelems, itemsize),
                "tier_wire": per_tier,
                "weighted_cost": weighted_cost(per_tier, bw)})
    ranked = sorted(
        candidates,
        key=lambda c: (c["weighted_cost"], c["census"]["seq_steps"],
                       c["program"].digest()))
    exact_ranked = [c for c in ranked if c["composition"] == "exact"]
    win, exact_win = ranked[0], exact_ranked[0]
    return dict(
        base,
        bidir_tier_wire=list(bidir_tier),
        bidir_weighted_cost=bidir_cost,
        beats_bidir=bool(win["weighted_cost"] < bidir_cost),
        exact_beats_bidir=bool(exact_win["weighted_cost"] < bidir_cost),
        candidates=[
            {"chain": list(c["chain"]),
             "composition": c["composition"],
             "tier_wire": list(c["tier_wire"]),
             "weighted_cost": c["weighted_cost"],
             "seq_steps": c["census"]["seq_steps"]}
            for c in ranked],
        winner=SYNTH_PREFIX + win["program"].digest(),
        chain=list(win["chain"]),
        composition=win["composition"],
        program=win["program"], census=win["census"],
        tier_wire=list(win["tier_wire"]),
        weighted_cost=win["weighted_cost"],
        exact_winner=SYNTH_PREFIX + exact_win["program"].digest(),
        exact_chain=list(exact_win["chain"]),
        exact_program=exact_win["program"],
        exact_tier_wire=list(exact_win["tier_wire"]),
        exact_weighted_cost=exact_win["weighted_cost"])


# ---------------------------------------------------------------------------
# Registry + tune-cache integration
# ---------------------------------------------------------------------------


def install(program: Program) -> str:
    """Install a synthesized program; returns its cache name."""
    name = SYNTH_PREFIX + program.digest()
    with _lock:
        _INSTALLED[name] = program
    return name


def installed_program(name: str, nranks: Optional[int] = None) -> Program:
    with _lock:
        prog = _INSTALLED.get(name)
    if prog is None:
        raise CommError(
            f"synthesized schedule {name!r} is not installed in this "
            "process — run csched.synth.synthesize/autotune_synthesis, "
            "or let a tune-cache lookup install the persisted winner")
    if nranks is not None and prog.nranks != nranks:
        raise CommError(
            f"synthesized schedule {name!r} was built for "
            f"{prog.nranks} ranks, not {nranks}")
    return prog


def synth_applicable(name, nranks: int) -> bool:
    with _lock:
        prog = _INSTALLED.get(name)
    return prog is not None and prog.nranks == nranks


def installed() -> Dict[str, Program]:
    """A copy of the installed programs (saved and restored around a
    tuning run that must not outlive its caller)."""
    with _lock:
        return dict(_INSTALLED)


def restore_installed(programs: Dict[str, Program]) -> None:
    """Replace the installed programs with a copy saved by
    :func:`installed`."""
    with _lock:
        _INSTALLED.clear()
        _INSTALLED.update(programs)


def validate_entry(name: str, program_json) -> None:
    """Tune-cache validation of a ``synth:`` winner: the entry must carry
    a program whose digest matches the name; a valid entry installs.
    Raises ``ValueError`` (the cache's stale-entry signal) otherwise."""
    if not isinstance(program_json, dict):
        raise ValueError(
            f"synthesized winner {name!r} has no serialized program")
    try:
        prog = Program.from_json(program_json)
    except Exception as e:  # noqa: BLE001 — any defect means "stale"
        # A corrupt entry, or one whose grammar this build does not know,
        # is stale: it must never crash deterministic auto selection.
        raise ValueError(
            f"synthesized winner {name!r} carries a program this "
            f"build cannot load: {e}") from e
    if SYNTH_PREFIX + prog.digest() != name:
        raise ValueError(
            f"synthesized winner {name!r} does not match its program "
            f"digest {prog.digest()!r}")
    with _lock:
        _INSTALLED[name] = prog


def clear_installed() -> None:
    with _lock:
        _INSTALLED.clear()


def _tuning_world(nranks, dtype, device):
    """``(nranks, dtype, its key token, itemsize, platform)`` of a tuning
    run on ``device`` (the sweep's rule: the card unless the caller asks
    for another; ``nranks=None`` is the device count)."""
    from ..tune.autotuner import _sweep_world, dtype_token, platform_of

    dev, n, dtype = _sweep_world(nranks, device, dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return n, dtype, dtype_token(dtype), itemsize, platform_of(dev)


def autotune_synthesis(nranks: Optional[int] = None,
                       sizes=(1 << 10, 1 << 14, 1 << 18),
                       dtype=None, persist: bool = True,
                       device=None) -> Dict:
    """The synthesis autotuner leg: search each size bucket, install the
    winners that beat the deterministic ring, and record them under the
    tune cache's ``codec="synth"`` slot (``synth:<digest>`` + the
    serialized program), for the platform of ``device`` (the card unless
    the caller asks for another).  Deterministic-mode auto selection
    then serves them."""
    from .. import tune as _tune

    n, dtype, token, itemsize, platform = _tuning_world(nranks, dtype,
                                                        device)
    report = {"collective": "allreduce", "nranks": n, "dtype": token,
              "entries": {}}
    for nbytes in sizes:
        res = synthesize(n, int(nbytes), itemsize)
        ent = {k: res[k] for k in ("winner", "chain", "census",
                                   "ring_census", "synthesis_beats_ring")}
        if res["synthesis_beats_ring"] and n > 1:
            prog = res["program"]
            install(prog)
            # The codec dimension keeps census verdicts in their own slot:
            # they never clobber wall-clock winners of the same bucket.
            _tune.record("allreduce", dtype, int(nbytes), n,
                         res["winner"], platform=platform, persist=persist,
                         codec="synth", program=prog.to_json())
            ent["recorded"] = True
        report["entries"][str(int(nbytes))] = ent
    return report


def autotune_tier_synthesis(nranks: Optional[int] = None,
                            sizes=(1 << 10, 1 << 14, 1 << 18),
                            dtype=None, persist: bool = True,
                            tiers=None, tier_bandwidths=None,
                            device=None) -> Dict:
    """The tier-synthesis autotuner leg: the weighted search per size
    bucket, winners installed and recorded under the tier-keyed slot.
    The exact winner records under ``codec="synth"``; a lossy
    ``q8-slow`` winner under ``codec="synth_q8"``, which auto selection
    never reads, so compressed tier schedules stay explicit opt-in
    (``algorithm="synth:<digest>"``)."""
    from .. import tune as _tune

    n, dtype, token, itemsize, platform = _tuning_world(nranks, dtype,
                                                        device)
    tiers = _resolved_tiers(n, tiers)
    report = {"collective": "allreduce", "nranks": n,
              "tiers": list(tiers), "dtype": token, "entries": {}}
    for nbytes in sizes:
        res = synthesize_tiers(n, int(nbytes), itemsize, tiers=tiers,
                               tier_bandwidths=tier_bandwidths)
        ent = {k: res[k] for k in
               ("winner", "chain", "composition", "tier_wire",
                "weighted_cost", "exact_winner", "exact_tier_wire",
                "exact_weighted_cost", "bidir_tier_wire",
                "bidir_weighted_cost", "beats_bidir")}
        if res["beats_bidir"] and n > 1:
            exact = res["exact_program"]
            install(exact)
            _tune.record("allreduce", dtype, int(nbytes), n,
                         res["exact_winner"], platform=platform,
                         persist=persist, codec="synth", tiers=tiers,
                         program=exact.to_json())
            if res["winner"] != res["exact_winner"]:
                prog = res["program"]
                install(prog)
                _tune.record("allreduce", dtype, int(nbytes), n,
                             res["winner"], platform=platform,
                             persist=persist, codec="synth_q8",
                             tiers=tiers, program=prog.to_json())
            ent["recorded"] = True
        report["entries"][str(int(nbytes))] = ent
    return report
