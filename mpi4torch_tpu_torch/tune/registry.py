"""Collective-algorithm registry.

Port of ``mpi4torch_tpu/tune/registry.py``: the names of the wire
schedules, the collectives each serves, their tiers (latency-optimal,
bandwidth-optimal) and their applicability rules, which the facade's
``algorithm=`` argument, the selector (:mod:`mpi4torch_tpu_torch.tune`)
and the autotuner (:mod:`.autotuner`) consult.  On the rank-thread
runtime an algorithm is a reduction association: the exact Allreduce
folds in the association of each schedule (``constants.reduce_*``), the
compressed one runs ``ring``, ``bidir`` and ``torus`` through the
quantized fold oracle (``constants.reduce_q8_hop``), and
``Bcast_``/``Reduce_`` take ``ring`` or ``tree``.  Synthesized schedules
(``"synth:<digest>"``) are not registered here: they resolve through
:mod:`mpi4torch_tpu_torch.csched.synth` (``tune.resolve_request``, the
cache's winner validation, ``csched.allreduce_program``), and
:func:`get_algorithm` names them unknown, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


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
    # The selector prefers these below the measured latency crossover.
    latency_optimal: bool = False
    # The multipath bandwidth tier: preferred at or above the measured
    # bandwidth crossover, which the autotuner derives from the sizes
    # they win.
    bandwidth_optimal: bool = False
    codec_capable: bool = False
    requires_power_of_two: bool = False
    requires_factorable: bool = False
    description: str = ""

    def applicable(self, nranks: int,
                   collective: str = "allreduce") -> bool:
        """Whether this algorithm can serve ``collective`` on an
        ``nranks`` world (a one-rank collective is the identity: only
        ``ring`` claims it)."""
        if collective not in self.collectives:
            return False
        if nranks <= 1:
            return self.name == "ring"
        if self.requires_power_of_two and (nranks & (nranks - 1)):
            return False
        if self.requires_factorable and best_group(nranks) is None:
            return False
        return True

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


_REGISTRY: Dict[str, AlgorithmSpec] = {}


def register_algorithm(spec: AlgorithmSpec) -> AlgorithmSpec:
    """Register an algorithm spec under ``spec.name`` (the selector and
    the ``algorithm=`` argument accept it at once).  The schedule itself
    must be known to the backends: this registry names and gates, it
    carries no schedule."""
    if not spec.name:
        raise ValueError("algorithm must have a non-empty name")
    _REGISTRY[spec.name] = spec
    return spec


def available_algorithms() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_algorithm(spec) -> AlgorithmSpec:
    """Resolve an ``algorithm=`` argument to its spec; raises on names the
    registry does not know (a typo is caught at the facade)."""
    if isinstance(spec, AlgorithmSpec):
        return spec
    if isinstance(spec, str):
        got = _REGISTRY.get(spec)
        if got is None:
            raise ValueError(
                f"unknown collective algorithm {spec!r}; available: "
                f"{', '.join(available_algorithms())}")
        return got
    raise TypeError(
        f"algorithm must be a registered name or an AlgorithmSpec; "
        f"got {spec!r}")


register_algorithm(AlgorithmSpec(
    name="ring", collectives=("allreduce", "reduce", "bcast"),
    codec_capable=True,
    description="the ascending-rank fold (Mode A: the native collective "
                "outside deterministic mode); 2(N-1) hops, 2·S·(N-1)/N "
                "wire"))
register_algorithm(AlgorithmSpec(
    name="rhd", latency_optimal=True, requires_power_of_two=True,
    description="recursive halving/doubling butterfly: 2·log2(N) hops "
                "of halving width, power-of-two worlds"))
register_algorithm(AlgorithmSpec(
    name="tree", collectives=("allreduce", "reduce", "bcast"),
    latency_optimal=True,
    description="binomial reduce-to-root + tree broadcast: "
                "2·ceil(log2 N) full-payload hops, any N"))
register_algorithm(AlgorithmSpec(
    name="hier", requires_factorable=True,
    description="2-level hierarchical: intra-group reduce-scatter, "
                "inter-group allreduce, intra-group all-gather"))
register_algorithm(AlgorithmSpec(
    name="bidir", bandwidth_optimal=True, codec_capable=True,
    description="bidirectional dual ring: the payload halves ride two "
                "counter-rotating ring chains, any N"))
register_algorithm(AlgorithmSpec(
    name="torus", bandwidth_optimal=True, requires_factorable=True,
    codec_capable=True,
    description="multi-axis multipath: the payload halves stripe across "
                "the two tiers of a 2-level factorization"))
