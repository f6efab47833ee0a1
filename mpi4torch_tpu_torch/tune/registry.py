"""Collective-algorithm registry.

Port of ``mpi4torch_tpu/tune/registry.py``: the names of the wire
schedules, the collectives each serves, and their applicability rules,
which the facade's ``algorithm=`` argument and the selector
(:mod:`mpi4torch_tpu_torch.tune`) consult.  On the rank-thread runtime an
algorithm is a reduction association: the exact Allreduce folds in the
association of each schedule (``constants.reduce_*``), the compressed one
runs ``ring``, ``bidir`` and ``torus`` through the quantized fold oracle
(``constants.reduce_q8_hop``), and ``Bcast_``/``Reduce_`` take ``ring``
or ``tree``.  Synthesized schedules (``"synth:..."``) come with the
schedule IR and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """A registered collective algorithm and its applicability rules: the
    ``collectives`` it serves; ``requires_power_of_two`` algorithms need a
    power-of-two world, ``requires_factorable`` ones a 2-level group split
    of the world (:func:`best_group`).  ``codec_capable`` is the
    registry's side of the codec/algorithm composition rule
    (``compress.codec_rides_algorithm``): True for the ring-shaped
    schedules, whose channels can carry a requantizing per-hop pipeline;
    a codec must also declare the algorithm in ``Codec.algorithms``."""

    name: str
    collectives: Tuple[str, ...] = ("allreduce",)
    codec_capable: bool = False
    requires_power_of_two: bool = False
    requires_factorable: bool = False

    def why_not(self, nranks: int,
                collective: str = "allreduce") -> Optional[str]:
        """Human reason this algorithm cannot serve ``collective`` on an
        ``nranks`` world, or None."""
        if collective not in self.collectives:
            return (f"algorithm {self.name!r} serves "
                    f"{'/'.join(self.collectives)}, not {collective}")
        if nranks > 1 and self.requires_power_of_two \
                and (nranks & (nranks - 1)):
            return (f"algorithm {self.name!r} (recursive halving/"
                    f"doubling) needs a power-of-two world; got "
                    f"{nranks} ranks — use 'tree' for the logarithmic "
                    "schedule at this size, or 'ring'")
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
    AlgorithmSpec("ring", collectives=("allreduce", "reduce", "bcast"),
                  codec_capable=True),
    AlgorithmSpec("rhd", requires_power_of_two=True),
    AlgorithmSpec("tree", collectives=("allreduce", "reduce", "bcast")),
    AlgorithmSpec("hier", requires_factorable=True),
    AlgorithmSpec("bidir", codec_capable=True),
    AlgorithmSpec("torus", requires_factorable=True, codec_capable=True),
)}


def get_algorithm(spec) -> AlgorithmSpec:
    """Resolve an ``algorithm=`` argument to its spec; raises on names this
    package does not run."""
    if isinstance(spec, AlgorithmSpec):
        return spec
    if isinstance(spec, str):
        got = _REGISTRY.get(spec)
        if got is not None:
            return got
        if spec.startswith("synth:"):
            raise NotImplementedError(
                f"algorithm={spec!r}: synthesized schedules come with the "
                "schedule IR and its autotuner (ROADMAP.md, Queue 1 item 5)")
        raise ValueError(
            f"unknown collective algorithm {spec!r}; available: "
            f"{', '.join(sorted(_REGISTRY))}")
    raise TypeError(
        f"algorithm must be a registered name or an AlgorithmSpec; "
        f"got {spec!r}")
