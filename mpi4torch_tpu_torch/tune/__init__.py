"""Size- and topology-aware collective algorithm selection.

Port of ``mpi4torch_tpu/tune/__init__.py`` as far as the facade and
the schedule IR read it: the request resolver (:func:`resolve_request`),
the 2-level group rule of ``hier`` and ``torus``
(:func:`resolve_hier_group`), the tier-stack factorization
(:func:`resolve_tier_stack`), the selector (:func:`select_auto`) and a
codec's declared algorithms (:func:`codec_algorithms`).

The JAX package's selector first asks its persisted autotuner cache for
a measured winner, and its latency tier picks ``rhd``/``tree`` for small
payloads.  The autotuner is not ported (ROADMAP.md, Queue 1 item 5) and
no latency crossover is measured, so here selection is the deterministic
pin and the bandwidth tier.  The port has no algorithm scope: an
algorithm is named per call, explicitly, so a request that cannot serve
the call raises (the JAX package's rule for explicit requests).  The
autotuner's names (its cache, the registry's listing and registration)
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import math
from typing import Optional

from .. import config as _config
from ..runtime import CommError
from .registry import AlgorithmSpec, best_group, get_algorithm

__all__ = [
    "AlgorithmSpec", "best_group", "codec_algorithms", "get_algorithm",
    "resolve_request", "resolve_hier_group", "resolve_tier_stack",
    "select_auto",
]


def codec_algorithms(codec) -> tuple:
    """The wire algorithms ``codec`` declares it composes with
    (``Codec.algorithms``; a codec without the field is ring-only)."""
    return tuple(getattr(codec, "algorithms", ("ring",)))


def resolve_request(requested, *, collective: str = "allreduce",
                    nranks: int = 1) -> Optional[str]:
    """Resolve an ``algorithm=`` request for ``collective``
    (``"allreduce"``, ``"reduce"`` or ``"bcast"``) to a concrete name, or
    ``None`` for selector-driven choice (``None``/``False``/``"auto"``).
    Unknown names raise ``ValueError``, synthesized ones
    ``NotImplementedError``, and an algorithm that cannot serve this
    collective on this world :class:`CommError`."""
    if requested is None or requested is False or requested == "auto":
        return None
    spec = get_algorithm(requested)
    reason = spec.why_not(nranks, collective)
    if reason is not None:
        raise CommError(reason)
    return spec.name


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


def select_auto(*, nbytes: int, nranks: int, deterministic: bool = False,
                codec=None) -> str:
    """The selector: the algorithm of an auto-selected Allreduce, a pure
    function of the call and the config knobs.  Deterministic mode pins
    ``ring``; at or above the bandwidth crossover ``bidir``, when
    ``codec`` (if any) rides it (``compress.codec_rides_algorithm``);
    otherwise ``ring``."""
    if nranks <= 1 or deterministic:
        return "ring"
    bandwidth = _config.bandwidth_crossover_bytes()
    if bandwidth is not None and nbytes >= bandwidth:
        from ..compress import codec_rides_algorithm

        if codec is None or codec_rides_algorithm(codec, "bidir"):
            return "bidir"
    return "ring"


def _item5(name):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"tune.{name}: the autotuner and its cache are not ported yet "
            "(ROADMAP.md, Queue 1 item 5)")
    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = f"``tune.{name}``: not ported yet (raises)."
    return stub


# The autotuner's surface (JAX tune/autotuner.py and the registry's
# listing and registration), kept as stubs that name their item.
for _name in ("available_algorithms", "register_algorithm",
              "autotune_allreduce", "bucket_nbytes",
              "ensure_tuned_allreduce", "lookup", "lookup_algorithm",
              "entry_from_disk", "record", "make_key", "cache_path",
              "generation", "clear"):
    globals()[_name] = _item5(_name)
del _name
