"""The collective-schedule IR: one program grammar for every schedule.

Port of ``mpi4torch_tpu/csched/ir.py``.  A collective algorithm is a
*program*, a sequence of :class:`Phase`\\ s of :class:`Step`\\ s drawn
from one closed step grammar (GC3, arXiv:2201.11840), and everything
else dispatches over :data:`STEP_KINDS`:

* :mod:`.lower` — the one Mode A emitter (the exchange rounds of
  ``ops/spmd.py`` on the ``run_spmd`` rank threads);
* :mod:`.interp` — the one Mode B / deterministic-mode fold oracle;
* :func:`transpose` (here) — the one rule deriving every backward
  program from the forward program;
* :mod:`.census` — the wire/step/collective-count accounting.

The grammar:

=================== ==================================================
kind                 meaning (params)
=================== ==================================================
``native_allreduce`` the native whole-axis collective (``psum`` /
                     ``pmax`` / ``pmin`` by reduction op) ``()``
``level_fold``       all-gather over a rank grouping + ascending fold,
                     one tier of an ordered reduction
                     ``(groups|None, fold_count)``
``ring_fold``        the chunked pipelined deterministic ring ``()``
``butterfly``        recursive halving/doubling (power-of-two worlds)
                     ``()``
``tree_reduce``      binomial reduce-to-root rounds + root mask
                     ``(root,)``
``tree_bcast``       root mask + binomial broadcast rounds ``(root,)``
``mask_root``        zero every non-root rank's value ``(root,)``
``ring_chain``       one directional exact reduce-scatter + all-gather
                     ring chain (a ``bidir`` half) ``(direction,)``
``grouped_sum``      grouped reduce-scatter → grouped allreduce →
                     grouped all-gather ``(g, rs_groups, ar_groups,
                     ag_groups)``
``q8_ring_channel``  a codec-rewritten quantized ring channel
                     ``(sigma_spec, direction, channel, reversible)``
``q8_level_fold``    a block-q8 level fold: encode → grouped all-gather
                     of (int8, scales) → decode → ascending fold
                     ``(groups|None, fold_count)``
=================== ==================================================

``Step.span`` places a step on the whole payload (``"all"``) or on a
multipath half (``("half", k)``, split at
:func:`constants.multipath_split`); ``Step.tier`` labels a tier-stack
level (0 innermost; None untiered); ``Step.codec`` is the codec-hop
annotation of a codec rewrite.

Transposition (:func:`transpose`): allreduce programs are self-adjoint,
with every directional step's ring direction reversed; root
collectives reverse their phase and step lists under ``tree_reduce ↔
tree_bcast``.  Programs, their JSON form and :meth:`Program.digest` are
the JAX package's, byte for byte.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Optional, Tuple

from ..runtime import CommError

# The closed step grammar: extending it means extending the lowering,
# interpreter, transposition and census tables (the registry guard of
# tests/test_torch_csched.py checks that each covers every kind).
STEP_KINDS = (
    "native_allreduce",
    "level_fold",
    "ring_fold",
    "butterfly",
    "tree_reduce",
    "tree_bcast",
    "mask_root",
    "ring_chain",
    "grouped_sum",
    "q8_ring_channel",
    "q8_level_fold",
)

# "seq" runs its steps in order on the whole payload; "multipath"
# stripes the flat payload across per-span channels (disjoint halves at
# constants.multipath_split); "q8_multipath" is the codec-rewritten
# multipath form (f32 staging and a final cast).
PHASE_KINDS = ("seq", "multipath", "q8_multipath")


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


@dataclass(frozen=True)
class Step:
    """One step of a schedule program: ``params`` are static,
    JSON-serializable kind-specific arguments, ``span`` places the step
    on the payload, ``codec`` is the codec-hop annotation (None: exact
    wire), ``tier`` the tier-stack level."""

    kind: str
    params: Tuple = ()
    span: object = "all"          # "all" | ("half", k)
    codec: Optional[str] = None
    tier: Optional[int] = None

    def __post_init__(self):
        if self.kind not in STEP_KINDS:
            raise CommError(
                f"unknown IR step kind {self.kind!r}; the grammar is "
                f"closed over {STEP_KINDS}")
        object.__setattr__(self, "params", _freeze(self.params))
        object.__setattr__(self, "span", _freeze(self.span))


@dataclass(frozen=True)
class Phase:
    kind: str
    steps: Tuple[Step, ...] = ()

    def __post_init__(self):
        if self.kind not in PHASE_KINDS:
            raise CommError(
                f"unknown IR phase kind {self.kind!r}; expected one of "
                f"{PHASE_KINDS}")
        object.__setattr__(self, "steps", tuple(self.steps))


@dataclass(frozen=True)
class Program:
    """A typed schedule program: ``collective`` names the op family,
    ``algorithm`` the source schedule, ``nranks`` the world it was built
    for, ``codec`` the wire codec after a codec rewrite (None: exact)."""

    collective: str
    algorithm: str
    nranks: int
    phases: Tuple[Phase, ...] = ()
    codec: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "phases", tuple(self.phases))

    def steps(self) -> Tuple[Step, ...]:
        return tuple(s for ph in self.phases for s in ph.steps)

    @property
    def nsteps(self) -> int:
        return len(self.steps())

    def to_json(self) -> dict:
        return {
            "collective": self.collective,
            "algorithm": self.algorithm,
            "nranks": self.nranks,
            "codec": self.codec,
            "phases": [
                {"kind": ph.kind,
                 "steps": [
                     # "tier" only when set, as in the JAX package, so
                     # untiered programs keep their digests.
                     dict({"kind": s.kind, "params": s.params,
                           "span": s.span, "codec": s.codec},
                          **({"tier": s.tier}
                             if s.tier is not None else {}))
                     for s in ph.steps]}
                for ph in self.phases],
        }

    @classmethod
    def from_json(cls, data: dict) -> "Program":
        phases = tuple(
            Phase(ph["kind"], tuple(
                Step(s["kind"], _freeze(s.get("params", ())),
                     _freeze(s.get("span", "all")), s.get("codec"),
                     s.get("tier"))
                for s in ph["steps"]))
            for ph in data["phases"])
        return cls(collective=data["collective"],
                   algorithm=data["algorithm"],
                   nranks=int(data["nranks"]),
                   phases=phases, codec=data.get("codec"))

    def digest(self) -> str:
        """Canonical content digest (the ``synth:<digest>`` identity of a
        program): the JAX package's JSON encoding, hashed the same way."""
        blob = json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"), default=list)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:10]


# ---------------------------------------------------------------------------
# Transposition
# ---------------------------------------------------------------------------

# Kind map applied when a root collective's step list is reversed.
TRANSPOSE_KINDS = {
    "native_allreduce": "native_allreduce",
    "level_fold": "level_fold",
    "ring_fold": "ring_fold",
    "butterfly": "butterfly",
    "tree_reduce": "tree_bcast",
    "tree_bcast": "tree_reduce",
    "mask_root": "mask_root",
    "ring_chain": "ring_chain",        # + direction flip (below)
    "grouped_sum": "grouped_sum",
    "q8_ring_channel": "q8_ring_channel",  # + flip when reversible
    "q8_level_fold": "q8_level_fold",
}


def _flip_step(step: Step) -> Step:
    """Directional adjoint of one step: ring chains and reversible
    quantized channels reverse their ring direction; every other kind is
    direction-free."""
    if step.kind == "ring_chain":
        (d,) = step.params
        return Step("ring_chain", (-d,), step.span, step.codec,
                    step.tier)
    if step.kind == "q8_ring_channel":
        sigma, d, k, reversible = step.params
        if reversible:
            return Step("q8_ring_channel", (sigma, -d, k, reversible),
                        step.span, step.codec, step.tier)
    return step


def transpose(program: Optional[Program]) -> Optional[Program]:
    """The backward-derivation rule.  Sum-allreduce programs are
    self-adjoint: the backward is the same program with each directional
    step flipped (``bidir``'s counter-rotating chains swap directions).
    Root collectives reverse their phase and step lists under
    :data:`TRANSPOSE_KINDS`: ``transpose(bcast)`` is a reduce and back."""
    if program is None:
        return None
    if program.collective == "allreduce":
        phases = tuple(
            Phase(ph.kind, tuple(_flip_step(s) for s in ph.steps))
            for ph in program.phases)
        return Program(program.collective, program.algorithm,
                       program.nranks, phases, program.codec)
    phases = tuple(
        Phase(ph.kind, tuple(
            Step(TRANSPOSE_KINDS[s.kind], s.params, s.span, s.codec,
                 s.tier)
            for s in reversed(ph.steps)))
        for ph in reversed(program.phases))
    collective = {"bcast": "reduce", "reduce": "bcast"}.get(
        program.collective, program.collective)
    return Program(collective, program.algorithm, program.nranks,
                   phases, program.codec)


def transposition_covers() -> Tuple[str, ...]:
    """Step kinds the transposition table serves (the registry guard's
    coverage probe)."""
    return tuple(TRANSPOSE_KINDS)
