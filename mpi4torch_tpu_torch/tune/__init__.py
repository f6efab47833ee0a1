"""Size- and topology-aware collective algorithm selection.

Port of ``mpi4torch_tpu/tune``.  Which schedule an Allreduce takes is
decided

* **per call** — ``comm.Allreduce(x, op, algorithm="rhd")``;
* **per scope** — ``with mpi.config.algorithm_scope("tree"): ...`` (or
  process-wide with :func:`mpi4torch_tpu_torch.config.
  set_default_algorithm`);
* **by default** — the selector (:func:`select_auto`), in three tiers:
  the persisted autotuner cache's measured winner for the ``(collective,
  dtype, nbytes-bucket, nranks, platform)`` key when there is one; at or
  below the measured latency crossover
  (:func:`~mpi4torch_tpu_torch.config.latency_crossover_bytes`) the
  latency-optimal algorithm (``rhd``, else ``tree``); at or above the
  measured bandwidth crossover the multipath tier (``bidir``); ``ring``
  otherwise or when nothing is measured.  Deterministic mode pins
  ``ring`` unless a synthesized schedule (:mod:`mpi4torch_tpu_torch.
  csched.synth`) won the bucket on the census sweep and is installed.

Degrade/raise rule (:func:`resolve_request`): a scope or process
default that cannot serve a call (``rhd`` on a world that is not a power
of two, ``hier`` on a prime world, an algorithm the codec does not ride,
a synthesized schedule not installed for this world) falls back to auto
selection; an explicit per-call ``algorithm=`` raises with the reason.

The measurement is :func:`autotune_allreduce` (``python -m
mpi4torch_tpu_torch.tune.autotuner``); its winners persist in a
versioned JSON file (:mod:`.autotuner`), which ``python -m
mpi4torch_tpu_torch.tune --show`` prints.
"""

from __future__ import annotations

import math
from typing import Optional

from .. import config as _config
from ..runtime import CommError
from .autotuner import (autotune_allreduce, bucket_nbytes, cache_path,
                        clear, ensure_tuned_allreduce, entry_from_disk,
                        generation, lookup, lookup_algorithm, make_key,
                        record)
from .registry import (AlgorithmSpec, available_algorithms, best_group,
                       get_algorithm, register_algorithm)

__all__ = [
    "AlgorithmSpec", "available_algorithms", "best_group", "get_algorithm",
    "register_algorithm", "resolve_request", "resolve_hier_group",
    "resolve_tier_stack", "select_auto", "codec_algorithms",
    "autotune_allreduce", "bucket_nbytes", "ensure_tuned_allreduce",
    "lookup", "lookup_algorithm", "entry_from_disk", "record", "make_key",
    "cache_path", "generation", "clear",
]


def codec_algorithms(codec) -> tuple:
    """The wire algorithms ``codec`` declares it composes with
    (``Codec.algorithms``; a codec without the field is ring-only)."""
    return tuple(getattr(codec, "algorithms", ("ring",)))


def resolve_request(requested, *, collective: str = "allreduce",
                    nranks: int = 1,
                    explicit: bool = False) -> Optional[str]:
    """Resolve an ``algorithm=`` request for ``collective``
    (``"allreduce"``, ``"reduce"`` or ``"bcast"``) to a concrete name, or
    ``None`` for selector-driven choice (``None``/``False``/``"auto"``).

    ``requested`` is the per-call argument when ``explicit``, else the
    scope/process default.  Unknown names always raise ``ValueError``; an
    algorithm that cannot serve this collective on this world raises
    :class:`CommError` when explicit and degrades to auto selection
    (None, not a pinned ``"ring"``) when it is a default."""
    if requested is None or requested is False or requested == "auto":
        return None
    if isinstance(requested, str) and requested.startswith("synth:"):
        # A synthesized IR schedule serves allreduce only, and only when
        # its program is installed for this world.
        from ..csched import synth as _synth

        if collective != "allreduce":
            if explicit:
                raise CommError(
                    f"synthesized schedule {requested!r} serves "
                    f"allreduce, not {collective}")
            return None
        if _synth.synth_applicable(requested, nranks):
            return requested
        if explicit:
            raise CommError(
                f"synthesized schedule {requested!r} is not installed "
                f"for a {nranks}-rank world (run "
                "csched.synth.autotune_synthesis or load its "
                "tune-cache entry)")
        return None
    spec = get_algorithm(requested)  # raises on unknown names
    reason = spec.why_not(nranks, collective)
    if reason is None:
        return spec.name
    if explicit:
        raise CommError(reason)
    return None


def resolve_hier_group(nranks: int) -> int:
    """The intra-group size of the 2-level split of an ``nranks`` world
    (the ``hier`` and ``torus`` schedules):
    ``config.hier_group_size()`` when set (validated against this world),
    else the innermost factor of ``config.tier_stack()`` when that is
    set, else the divisor closest to the square root.  Raises
    :class:`CommError` when no valid split exists; an auto pick catches
    it and degrades."""
    g = _config.hier_group_size()
    if g is not None:
        if nranks % g or not (1 < g < nranks):
            raise CommError(
                f"config.hier_group_size={g} does not define a 2-level "
                f"split of the {nranks}-rank communicator (need a "
                f"divisor with 1 < g < {nranks})")
        return g
    if _config.tier_stack() is not None:
        # The tier stack generalizes hier_group_size: its innermost
        # factor is the intra-group size of the 2-level view.
        stack = resolve_tier_stack(nranks)
        if len(stack) < 2:
            raise CommError(
                f"config.tier_stack={stack} is a single flat tier — "
                f"the 'hier' schedule needs >= 2 levels")
        return stack[0]
    g = best_group(nranks)
    if g is None:
        raise CommError(
            f"the 'hier' and 'torus' schedules need a 2-level group "
            f"factorization of the world size; {nranks} has no nontrivial "
            "divisor — use 'tree', 'ring' or 'bidir'")
    return g


def resolve_tier_stack(nranks: int):
    """The flat-axis tier-stack factorization (innermost first) of an
    ``nranks`` communicator: ``config.tier_stack()`` when set (validated
    against this communicator), else the 2-level ``(g, nranks // g)``
    split of :func:`resolve_hier_group`."""
    ts = _config.tier_stack()
    if ts is not None:
        stack = tuple(int(g) for g in ts)
        if math.prod(stack) != nranks or any(g < 2 for g in stack):
            raise CommError(
                f"config.tier_stack={stack} does not factor the "
                f"{nranks}-rank communicator into tiers of >= 2")
        return stack
    g = resolve_hier_group(nranks)
    return (g, nranks // g)


def select_auto(*, collective: str = "allreduce", nbytes: int,
                dtype, nranks: int, deterministic: bool = False,
                codec=None) -> str:
    """The selector: the algorithm of an auto-selected collective call, a
    pure function of the call, the config knobs and the autotuner cache.

    Deterministic mode pins ``ring`` unless the cache's ``codec="synth"``
    slot names a synthesized schedule installed for this world; a
    measured cache winner wins (synthesized winners never steer the
    wall-clock tiers); at or below the latency crossover the latency
    algorithm (``rhd`` on power-of-two worlds, else ``tree``); at or
    above the bandwidth crossover ``bidir``; otherwise ``ring``.  A
    codec restricts candidates to the algorithms it rides and reads its
    own codec-keyed winners.  ``dtype`` is the payload's torch dtype."""
    if nranks <= 1:
        return "ring"
    if deterministic:
        from ..csched import synth as _synth

        if codec is None:
            w = lookup_algorithm(collective, dtype, nbytes, nranks,
                                 codec="synth")
            if (_synth.is_synth_name(w)
                    and _synth.synth_applicable(w, nranks)):
                return w
        return "ring"

    def ok(name: str) -> bool:
        if not get_algorithm(name).applicable(nranks, collective):
            return False
        if name in ("hier", "torus"):
            # A set config.hier_group_size can void the registry's static
            # gate for this world: never pick what the backend rejects.
            try:
                resolve_hier_group(nranks)
            except CommError:
                return False
        if codec is None:
            return True
        from ..compress import codec_applicable

        return codec_applicable(codec, dtype, algorithm=name)

    # Codec-keyed winners: compressed traffic reads its own measurements
    # and never hijacks (or is hijacked by) exact selection.
    winner = lookup_algorithm(collective, dtype, nbytes, nranks,
                              codec=codec)
    if winner is not None and winner.startswith("synth:"):
        # Census verdicts serve deterministic mode only.
        winner = None
    crossover = _config.latency_crossover_bytes()
    if winner is not None and ok(winner):
        if (codec is None and crossover is not None
                and nbytes <= crossover
                and get_algorithm(winner).bandwidth_optimal):
            # Latency-tier guard: decode-sized messages share power-of-two
            # buckets with training tail buckets, so a bandwidth-tier
            # winner recorded under such a key never applies at or below
            # the measured latency crossover; the tiers below decide.
            # Exact traffic only: decode payloads are exact, and voiding
            # a codec-keyed winner would strand it on ring.
            winner = None
        else:
            return winner
    if crossover is not None and nbytes <= crossover:
        if ok("rhd"):
            return "rhd"
        if ok("tree"):
            return "tree"
    bandwidth = _config.bandwidth_crossover_bytes()
    if bandwidth is not None and nbytes >= bandwidth:
        # The multipath tier: `bidir` is the any-world pick; `torus` wins
        # only through a measured cache entry.
        if ok("bidir"):
            return "bidir"
    return "ring"

