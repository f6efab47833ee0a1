"""Collective-algorithm registry.

Port of ``mpi4torch_tpu/tune/registry.py`` as far as this package runs
the algorithms: the names of the wire schedules and their applicability
rules, which the facade's ``algorithm=`` argument and the selector
(:mod:`mpi4torch_tpu_torch.tune`) consult.  The compressed Allreduce runs
``ring``, ``bidir`` and ``torus`` (the quantized fold oracle,
``constants.reduce_q8_hop``) and the exact Allreduce ``ring``.  The JAX
package's other schedules (``rhd``, ``tree``, ``hier``) are not ported: a
request for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """A registered collective algorithm and its applicability rule:
    ``requires_factorable`` algorithms need a 2-level group split of the
    world (:func:`best_group`)."""

    name: str
    requires_factorable: bool = False

    def why_not(self, nranks: int) -> Optional[str]:
        """Human reason this algorithm cannot serve an ``nranks`` world,
        or None."""
        if nranks > 1 and self.requires_factorable \
                and best_group(nranks) is None:
            return (f"algorithm {self.name!r} needs a 2-level group "
                    f"factorization of the world size; {nranks} has no "
                    "nontrivial divisor")
        return None


def best_group(n: int) -> Optional[int]:
    """Default intra-group size of the 2-level split of ``n`` ranks: the
    divisor closest to ``sqrt(n)`` (ties to the smaller), or None when
    ``n`` is prime or < 4."""
    if n < 4:
        return None
    best, dist = None, None
    for g in range(2, n):
        if n % g:
            continue
        d = abs(g - n // g)
        if dist is None or d < dist:
            best, dist = g, d
    return best


_REGISTRY = {spec.name: spec for spec in (
    AlgorithmSpec("ring"),
    AlgorithmSpec("bidir"),
    AlgorithmSpec("torus", requires_factorable=True),
)}
_NOT_PORTED = ("rhd", "tree", "hier")


def get_algorithm(spec) -> AlgorithmSpec:
    """Resolve an ``algorithm=`` argument to its spec; raises on names this
    package does not run."""
    if isinstance(spec, AlgorithmSpec):
        return spec
    if isinstance(spec, str):
        got = _REGISTRY.get(spec)
        if got is not None:
            return got
        if spec in _NOT_PORTED:
            raise NotImplementedError(
                f"algorithm={spec!r}: only ring, bidir and torus are "
                "ported; the other schedules come with the compiled "
                "backend (ROADMAP.md, Queue 1 items 2 and 6)")
        raise ValueError(
            f"unknown collective algorithm {spec!r}; available: "
            f"{', '.join(sorted(_REGISTRY))}")
    raise TypeError(
        f"algorithm must be a registered name or an AlgorithmSpec; "
        f"got {spec!r}")
