"""Registered IR programs: one constructor per collective algorithm.

Port of ``mpi4torch_tpu/csched/programs.py``.  Each constructor
re-expresses a hand-written schedule of ``ops/spmd.py`` as an IR program
whose lowering (:mod:`.lower`) issues the same exchanges in the same
order and folds the same bits, mirroring the original dispatch decisions
exactly (op cases, deterministic mode, the size thresholds of
:mod:`mpi4torch_tpu_torch.config`, the raises).  The programs are the
JAX package's, field for field.

The port runs eagerly, so a call site would rebuild its program on every
call on every rank thread; :func:`cached` keys a built program on the
constructor's arguments and every config knob a constructor reads, so a
knob change never serves a stale program.
"""

from __future__ import annotations

from typing import Tuple

from .. import config as _config
from .. import constants as C
from ..runtime import CommError
from .ir import Phase, Program, Step

# Algorithms with a registered IR program constructor.  An algorithm
# registered in tune.registry must appear here or in NATIVE_EXEMPT.
PROGRAM_ALGORITHMS = ("ring", "rhd", "tree", "hier", "bidir", "torus")

# Registered algorithms exempted from the IR (none: all six allreduce
# schedules re-express through the grammar).
NATIVE_EXEMPT: Tuple[str, ...] = ()


def has_program(algorithm: str) -> bool:
    return algorithm in PROGRAM_ALGORITHMS or (
        isinstance(algorithm, str) and algorithm.startswith("synth:"))


def _ident(collective: str, algorithm: str, n: int) -> Program:
    return Program(collective, algorithm, n, ())


def _hier_groups(n: int, g: int):
    """The 2-level grouping of ``n`` ranks with intra-group size ``g``:
    the blocks of ``g`` consecutive ranks, the ``g`` strided groups
    ``{i, i + g, ...}`` across them, and the number of blocks."""
    ngroups = n // g
    inner = tuple(tuple(b * g + i for i in range(g))
                  for b in range(ngroups))
    outer = tuple(tuple(i + b * g for b in range(ngroups))
                  for i in range(g))
    return inner, outer, ngroups


def chain_groups(n: int, chain: Tuple[int, ...]):
    """The per-tier rank groupings of a factorization chain (the JAX
    package's ``csched.synth.chain_groups``): tier ``l`` groups ranks
    that differ only in the ``l``-th mixed-radix digit, so the tiers
    compose like ``reduce_grouped``'s inner/outer pair."""
    levels = []
    stride = 1
    for f in chain:
        block = stride * f
        groups = []
        for c in range(n // block):
            for o in range(stride):
                groups.append(tuple(c * block + j * stride + o
                                    for j in range(f)))
        levels.append((tuple(groups), f))
        stride = block
    return levels


def _ordered_fold_program(algorithm: str, n: int, op: int, nelems: int,
                          itemsize: int) -> Program:
    """The deterministic ordered-fold dispatch of ops/spmd
    ``_ordered_fold_allreduce``: the all-gather+fold form below the
    gather threshold, the chunked ring above it."""
    if n == 1:
        return _ident("allreduce", algorithm, n)
    gathered = nelems * itemsize * n
    if gathered <= _config.ordered_fold_gather_max_bytes():
        step = Step("level_fold", (None, n))
    else:
        step = Step("ring_fold")
    return Program("allreduce", algorithm, n, (Phase("seq", (step,)),))


def allreduce_program(algorithm, n: int, op: int, *, deterministic: bool,
                      nelems: int, itemsize: int) -> Program:
    """The IR program computing ``Allreduce(op)`` with ``algorithm`` on
    an ``n``-rank axis, branch for branch the hand-written dispatch.
    Raises exactly where the hand-written forms raise (rhd on worlds
    that are not a power of two, hier/torus without a 2-level
    factorization, MINLOC/MAXLOC everywhere)."""
    algorithm = algorithm or "ring"
    if isinstance(algorithm, str) and algorithm.startswith("synth:"):
        from . import synth as _synth

        return _synth.installed_program(algorithm, n)

    if algorithm == "rhd":
        if n == 1:
            return _ident("allreduce", "rhd", n)
        if n & (n - 1):
            raise CommError(
                f"the 'rhd' (recursive halving/doubling) schedule needs a "
                f"power-of-two world; got {n} ranks — use 'tree' for the "
                "logarithmic schedule at this size, or 'ring'")
        return Program("allreduce", "rhd", n,
                       (Phase("seq", (Step("butterfly"),)),))

    if algorithm == "tree":
        if n == 1:
            return _ident("allreduce", "tree", n)
        return Program("allreduce", "tree", n, (Phase("seq", (
            Step("tree_reduce", (0,)), Step("tree_bcast", (0,)))),))

    if algorithm == "hier":
        if n == 1:
            return _ident("allreduce", "hier", n)
        from ..tune import resolve_hier_group, resolve_tier_stack

        g = resolve_hier_group(n)
        inner, outer, ngroups = _hier_groups(n, g)
        if op == C.MPI_SUM and not deterministic:
            # A deeper config.tier_stack merges its outer tiers into the
            # inter-group stage: grouped_sum is the 2-level triple.
            return Program("allreduce", "hier", n, (Phase("seq", (
                Step("grouped_sum", (g, inner, outer, inner)),)),))
        stack = resolve_tier_stack(n)
        if len(stack) > 2:
            # Deterministic N-level stack: one tier-labelled level_fold
            # per configured tier.
            steps = tuple(
                Step("level_fold", (grp, f), tier=level)
                for level, (grp, f) in enumerate(chain_groups(n, stack)))
            return Program("allreduce", "hier", n,
                           (Phase("seq", steps),))
        return Program("allreduce", "hier", n, (Phase("seq", (
            Step("level_fold", (inner, g)),
            Step("level_fold", (outer, ngroups)))),))

    if algorithm == "bidir":
        if n == 1:
            return _ident("allreduce", "bidir", n)
        if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
            C.combine2(op, None, None)  # raises with explanation
        if deterministic:
            return _ordered_fold_program("bidir", n, op, nelems, itemsize)
        m = C.multipath_split(nelems)
        steps = [Step("ring_chain", (1,), span=("half", 0))]
        if m < nelems:
            steps.append(Step("ring_chain", (-1,), span=("half", 1)))
        return Program("allreduce", "bidir", n,
                       (Phase("multipath", tuple(steps)),))

    if algorithm == "torus":
        if n == 1:
            return _ident("allreduce", "torus", n)
        if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
            C.combine2(op, None, None)  # raises with explanation
        from ..tune import resolve_hier_group

        g = resolve_hier_group(n)
        inner, outer, ngroups = _hier_groups(n, g)
        m = C.multipath_split(nelems)
        if op == C.MPI_SUM and not deterministic:
            ch0 = (Step("grouped_sum", (g, inner, outer, inner),
                        span=("half", 0)),)
            ch1 = (Step("grouped_sum", (ngroups, outer, inner, outer),
                        span=("half", 1)),)
        else:
            ch0 = (Step("level_fold", (inner, g), span=("half", 0)),
                   Step("level_fold", (outer, ngroups), span=("half", 0)))
            ch1 = (Step("level_fold", (outer, ngroups), span=("half", 1)),
                   Step("level_fold", (inner, g), span=("half", 1)))
        steps = ch0 + (ch1 if m < nelems else ())
        return Program("allreduce", "torus", n,
                       (Phase("multipath", steps),))

    if algorithm == "ring":
        if op == C.MPI_SUM:
            if deterministic:
                return _ordered_fold_program("ring", n, op, nelems,
                                             itemsize)
            return Program("allreduce", "ring", n,
                           (Phase("seq", (Step("native_allreduce"),)),))
        if op in (C.MPI_MAX, C.MPI_MIN):
            return Program("allreduce", "ring", n,
                           (Phase("seq", (Step("native_allreduce"),)),))
        if op in (C.MPI_MINLOC, C.MPI_MAXLOC):
            C.combine2(op, None, None)  # raises with explanation
        return _ordered_fold_program("ring", n, op, nelems, itemsize)

    raise CommError(
        f"no IR program registered for collective algorithm "
        f"{algorithm!r} (registered: {', '.join(PROGRAM_ALGORITHMS)})")


# ---------------------------------------------------------------------------
# Bcast_/Reduce_ tree and ring forms
# ---------------------------------------------------------------------------


def bcast_program(algorithm, n: int, root: int, *, nbytes: int) -> Program:
    """The Bcast_ program: ``tree`` pins the binomial-tree form,
    ``ring`` the root-masked psum pair; ``None`` keeps the size dispatch
    (``config.bcast_tree_max_bytes``)."""
    if n == 1:
        return _ident("bcast", algorithm or "auto", n)
    if algorithm == "tree" or (
            algorithm not in ("ring",)
            and nbytes <= _config.bcast_tree_max_bytes()):
        return Program("bcast", "tree", n, (Phase("seq", (
            Step("tree_bcast", (root,)),)),))
    return Program("bcast", "ring", n, (Phase("seq", (
        Step("mask_root", (root,)), Step("native_allreduce"))),))


def reduce_program(algorithm, n: int, op: int, root: int, *,
                   deterministic: bool, nelems: int,
                   itemsize: int) -> Program:
    """The Reduce_ program: ``tree`` is the binomial reduce (whose
    transpose is the tree Bcast_); everything else the ring allreduce
    program with a root mask appended."""
    if algorithm == "tree":
        return Program("reduce", "tree", n, (Phase("seq", (
            Step("tree_reduce", (root,)),)),))
    base = allreduce_program("ring", n, op, deterministic=deterministic,
                             nelems=nelems, itemsize=itemsize)
    steps = tuple(s for ph in base.phases for s in ph.steps)
    return Program("reduce", "ring", n, (Phase("seq", steps + (
        Step("mask_root", (root,)),)),))


# ---------------------------------------------------------------------------
# Codec rewrite: compression as a program transformation
# ---------------------------------------------------------------------------


def rewrite_codec(program: Program, codec_name: str,
                  block: int) -> Program:
    """Rewrite an exact allreduce program for the in-schedule block-q8
    pipeline: every multipath channel becomes ONE ``q8_ring_channel``
    step annotated with the codec.  Exact ``ring_chain`` channels keep
    their direction and stay reversible (``bidir``'s backward flips
    them); grouped torus channels ride the transposed-grid walk of
    :func:`constants.multipath_ring_orders`, the inner group size read
    off the channel's own first step."""
    if not program.phases:
        return Program("allreduce", program.algorithm, program.nranks,
                       (), codec=codec_name)
    phase = program.phases[0]
    steps = []
    if phase.kind == "seq":
        steps.append(Step("q8_ring_channel", (None, 1, 0, False),
                          span="all", codec=codec_name))
    elif phase.kind == "multipath":
        by_span = {}
        for s in phase.steps:
            by_span.setdefault(s.span, []).append(s)
        spans = sorted(by_span, key=lambda sp: sp[1])
        first0 = by_span[spans[0]][0]
        inner = None
        if first0.kind == "grouped_sum":
            inner = int(first0.params[0])
        elif first0.kind == "level_fold":
            inner = int(first0.params[1])
        for k, span in enumerate(spans):
            first = by_span[span][0]
            if first.kind == "ring_chain":
                (d,) = first.params
                steps.append(Step("q8_ring_channel", (None, d, k, True),
                                  span=span, codec=codec_name))
            elif k == 0:
                steps.append(Step("q8_ring_channel", (None, 1, 0, False),
                                  span=span, codec=codec_name))
            else:
                if inner is None:
                    raise CommError(
                        "torus codec rewrite needs the row-major "
                        "channel's group size")
                steps.append(Step(
                    "q8_ring_channel", (("torus_col", inner), 1, k,
                                        False),
                    span=span, codec=codec_name))
    else:
        raise CommError(
            f"codec rewrite does not serve phase kind {phase.kind!r}")
    return Program("allreduce", program.algorithm, program.nranks,
                   (Phase("q8_multipath", tuple(steps)),),
                   codec=codec_name)


def q8_allreduce_program(algorithm, n: int, codec_name: str,
                         block: int, *, reverse: bool = False
                         ) -> Program:
    """Build and rewrite in one call: the exact program of ``algorithm``
    (sum, not deterministic: the fused pipeline's regime) rewritten for
    the block-q8 codec; ``reverse`` gives the backward through
    :func:`.ir.transpose` (``bidir``'s channel directions swap)."""
    from .ir import transpose

    # nelems=2 keeps both multipath channels in the program; the
    # lowering skips the empty half of a one-element payload.
    prog = allreduce_program(algorithm, n, C.MPI_SUM,
                             deterministic=False, nelems=2, itemsize=4)
    prog = rewrite_codec(prog, codec_name, block)
    return transpose(prog) if reverse else prog


def resolve_sigma(spec, n: int):
    """Materialize a ``q8_ring_channel`` walk spec: ``None`` is the
    identity walk, ``("torus_col", inner)`` the column-major grid walk of
    :func:`constants.multipath_ring_orders`."""
    if spec is None:
        return None
    tag, inner = spec
    if tag != "torus_col":
        raise CommError(f"unknown q8 channel walk {spec!r}")
    inner = int(inner)
    outer = n // inner
    return tuple((p % outer) * inner + p // outer for p in range(n))


# ---------------------------------------------------------------------------
# The call-site cache
# ---------------------------------------------------------------------------

_CACHE: dict = {}
_CACHE_MAX = 4096


def _knobs():
    """Every config knob a constructor reads (the deterministic flag is
    one of its arguments), and the selection state: the tune cache's
    generation (a tuning run installs and records synthesized programs),
    the process default algorithm and both crossovers."""
    from ..tune import generation

    return (_config.ordered_fold_gather_max_bytes(),
            _config.hier_group_size(), _config.tier_stack(),
            _config.bcast_tree_max_bytes(), generation(),
            _config.default_algorithm(),
            _config.latency_crossover_bytes(),
            _config.bandwidth_crossover_bytes())


def cached(build, *args, **kwargs):
    """``build(*args, **kwargs)``, made once per distinct arguments
    and knob values.  Programs are immutable, so rank threads share
    them; a constructor that raises is not cached and raises on every
    call."""
    if args and isinstance(args[0], str) and args[0].startswith("synth:"):
        # A synthesized program is a lookup in the installed registry,
        # which can change without a generation bump: never cached.
        return build(*args, **kwargs)
    key = (build, args, tuple(sorted(kwargs.items())), _knobs())
    prog = _CACHE.get(key)
    if prog is None:
        prog = build(*args, **kwargs)
        if len(_CACHE) >= _CACHE_MAX:
            _CACHE.clear()
        _CACHE[key] = prog
    return prog
