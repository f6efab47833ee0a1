"""Size- and topology-aware collective algorithm selection.

Port of ``mpi4torch_tpu/tune/__init__.py`` as far as the facade reads
it: the request resolver (:func:`resolve_request`), the 2-level group
rule of ``hier`` and ``torus`` (:func:`resolve_hier_group`) and the
selector (:func:`select_auto`).

The JAX package's selector first asks its persisted autotuner cache for
a measured winner, and its latency tier picks ``rhd``/``tree`` for small
payloads.  The autotuner is not ported (ROADMAP.md, Queue 1 item 5) and
no latency crossover is measured, so here selection is the deterministic
pin and the bandwidth tier.  The port has no algorithm scope: an
algorithm is named per call, explicitly, so a request that cannot serve
the call raises (the JAX package's rule for explicit requests).
"""

from __future__ import annotations

from typing import Optional

from .. import config as _config
from ..runtime import CommError
from .registry import AlgorithmSpec, best_group, get_algorithm

__all__ = [
    "AlgorithmSpec", "best_group", "get_algorithm", "resolve_request",
    "resolve_hier_group", "select_auto",
]


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
    else the divisor closest to the square root.  Raises
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
    g = best_group(nranks)
    if g is None:
        raise CommError(
            f"the 'hier' and 'torus' schedules need a 2-level group "
            f"factorization of the world size; {nranks} has no nontrivial "
            "divisor — use 'tree', 'ring' or 'bidir'")
    return g


def select_auto(*, nbytes: int, nranks: int, deterministic: bool = False,
                codec=None) -> str:
    """The selector: the algorithm of an auto-selected Allreduce, a pure
    function of the call and the config knobs.  Deterministic mode pins
    ``ring``; at or above the bandwidth crossover ``bidir``, when
    ``codec`` (if any) rides it; otherwise ``ring``."""
    if nranks <= 1 or deterministic:
        return "ring"
    bandwidth = _config.bandwidth_crossover_bytes()
    if bandwidth is not None and nbytes >= bandwidth \
            and (codec is None or "bidir" in codec.algorithms):
        return "bidir"
    return "ring"
