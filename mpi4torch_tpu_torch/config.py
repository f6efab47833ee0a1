"""Framework configuration flags.

Port of the part of ``mpi4torch_tpu/config.py`` this package reads:
``deterministic_mode`` (thread-local, as there), the bucket size of the
fused tree collectives (:func:`set_default_bucket_bytes`,
:func:`fusion_scope`), the split-phase overlap policy
(:func:`set_default_overlap`, :func:`overlap_scope`) and the split count
of the serving decode collectives (:func:`set_serve_decode_buckets`), the
deadlock timeout of rank worlds,
the collective-algorithm default (:func:`set_default_algorithm`,
:func:`algorithm_scope`) and the selector's measured crossovers
(:func:`set_latency_crossover_bytes`,
:func:`set_bandwidth_crossover_bytes`),
and the knobs of the compressed Allreduce: the default codec
(:func:`set_default_compression`, :func:`compression_scope`), the
``hier``/``torus`` group size, the tier stack (:func:`set_tier_stack`)
with its relative bandwidths (:func:`set_tier_bandwidths`) and the
implementation of the quantized hop
(:func:`quant_hop_impl`), the reshard planner's default strategy
(:func:`set_default_reshard_strategy`), and the fault-tolerance and
observability knobs: comm retries and backoff, the finite guard, the
wire checksum, the fault plan and the comm tracer, and the default
transport of ``run_ranks`` (:func:`set_comm_transport`,
:func:`transport_scope`).  The deterministic flag and the
scopes are per thread, so a scope opened before ``run_ranks`` is not
seen by the rank threads; the process-wide setters are, and the
fault-tolerance and observability knobs are process-wide only.
:func:`snapshot_process_state` / :func:`apply_process_state` carry the
process-wide state to the process transport's workers.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager

_state = threading.local()
_UNSET = object()

# Environment override of the rank-world deadlock timeout (seconds): a
# wall clock for detecting a rank that never reaches a collective, not a
# performance knob.  The same variable as the JAX package's.
WORLD_TIMEOUT_ENV = "MPI4TORCH_TPU_WORLD_TIMEOUT"


def world_timeout() -> float:
    return float(os.environ.get(WORLD_TIMEOUT_ENV, "60"))


def deterministic_reductions() -> bool:
    return getattr(_state, "deterministic", False)


def set_deterministic_reductions(value: bool) -> None:
    _state.deterministic = bool(value)


@contextmanager
def deterministic_mode(value: bool = True):
    """Ask for deterministic reductions inside the block.  Every eager
    reduction of this package already folds in ascending rank order, so
    the flag changes no result here; it is kept so that code written for
    the JAX package runs unchanged."""
    prev = deterministic_reductions()
    set_deterministic_reductions(value)
    try:
        yield
    finally:
        set_deterministic_reductions(prev)


# --- fused tree collectives ------------------------------------------------

# Fused-collective bucket size (mpi4torch_tpu_torch.fuse).  4 MiB: large
# enough to amortize per-collective cost over many small leaves, small
# enough that a gradient tree still splits into several buckets.
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024
_process_bucket_bytes = DEFAULT_BUCKET_BYTES


def default_bucket_bytes() -> int:
    """Bucket size (bytes) the fused tree collectives use when no
    explicit ``bucket_bytes=`` is passed: the innermost active
    :func:`fusion_scope` on this thread, else the process-wide
    :func:`set_default_bucket_bytes` value.  ``0`` disables fusion
    (per-leaf collectives)."""
    scoped = getattr(_state, "bucket_bytes", _UNSET)
    return _process_bucket_bytes if scoped is _UNSET else scoped


def _validated_bucket_bytes(nbytes) -> int:
    if nbytes is False:
        return 0
    nbytes = int(nbytes)
    if nbytes < 0:
        raise ValueError(f"bucket_bytes must be >= 0, got {nbytes}")
    return nbytes


def set_default_bucket_bytes(nbytes) -> None:
    """Set the process-wide fused-collective bucket size in bytes
    (``0``/``False`` = fusion off, per-leaf collectives)."""
    global _process_bucket_bytes
    _process_bucket_bytes = _validated_bucket_bytes(nbytes)


@contextmanager
def fusion_scope(bucket_bytes):
    """Lexically scoped bucket size for the fused tree collectives on this
    thread; ``fusion_scope(0)`` gives per-leaf collectives in the
    block."""
    prev = getattr(_state, "bucket_bytes", _UNSET)
    _state.bucket_bytes = _validated_bucket_bytes(bucket_bytes)
    try:
        yield
    finally:
        if prev is _UNSET:
            del _state.bucket_bytes
        else:
            _state.bucket_bytes = prev


# --- split-phase overlap ---------------------------------------------------

_process_overlap = None


def default_overlap():
    """The overlap policy the fused tree collectives, the ZeRO helpers and
    the serving decode collectives use when no explicit ``overlap=`` is
    passed: the innermost active :func:`overlap_scope` on this thread,
    else the process-wide :func:`set_default_overlap` value.  ``None`` and
    ``False`` are blocking schedules; ``True`` turns on the overlap
    schedules with a window of 2 collectives in flight, an ``int >= 1``
    with that window."""
    scoped = getattr(_state, "overlap", _UNSET)
    return _process_overlap if scoped is _UNSET else scoped


def _validated_overlap(value):
    if value is None or value is False or value is True:
        return value
    try:
        depth = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"overlap must be None, a bool, or a prefetch depth >= 1; "
            f"got {value!r}") from None
    if depth < 1:
        raise ValueError(
            f"overlap prefetch depth must be >= 1, got {depth}")
    return depth


def set_default_overlap(value) -> None:
    """Set the process-wide overlap policy (``None``/``True``/``False``
    or an integer window depth; see :func:`default_overlap`)."""
    global _process_overlap
    _process_overlap = _validated_overlap(value)


@contextmanager
def overlap_scope(value):
    """Lexically scoped overlap policy on this thread.  A scope default is
    a preference: a call it cannot serve (a codec, a reduction other
    than ``MPI_SUM``) takes the blocking path, where an explicit
    ``overlap=`` raises."""
    prev = getattr(_state, "overlap", _UNSET)
    _state.overlap = _validated_overlap(value)
    try:
        yield
    finally:
        if prev is _UNSET:
            del _state.overlap
        else:
            _state.overlap = prev


def _validated_threshold(nbytes, what: str, minimum: int = 0,
                         unit: str = "byte count") -> int:
    try:
        nbytes = int(nbytes)
    except (TypeError, ValueError):
        raise ValueError(f"{what} must be an integer {unit}, got "
                         f"{nbytes!r}") from None
    if nbytes < minimum:
        raise ValueError(f"{what} must be >= {minimum}, got {nbytes}")
    return nbytes


# Split count of the serving decode step's per-layer collectives: with the
# overlap policy on, each decode payload is split into this many windowed
# split-phase chunks.
DEFAULT_SERVE_DECODE_BUCKETS = 2
_serve_decode_buckets = DEFAULT_SERVE_DECODE_BUCKETS


def serve_decode_buckets() -> int:
    """How many windowed split-phase chunk buckets one serving decode
    collective is split into (:mod:`mpi4torch_tpu_torch.serve`; >= 1)."""
    return _serve_decode_buckets


def set_serve_decode_buckets(n) -> None:
    global _serve_decode_buckets
    _serve_decode_buckets = _validated_threshold(
        n, "serve_decode_buckets", minimum=1, unit="bucket count")


# --- wire compression ------------------------------------------------------

_process_compression = None


def default_compression():
    """The codec facade ops use when ``compression=None`` is passed: the
    innermost active :func:`compression_scope` on this thread, else the
    process-wide :func:`set_default_compression` value (None: exact)."""
    scoped = getattr(_state, "compression", _UNSET)
    return _process_compression if scoped is _UNSET else scoped


def _validated_codec(codec):
    if codec is None:
        return None
    from .compress import get_codec

    return get_codec(codec)


def set_default_compression(codec) -> None:
    """Set the process-wide default codec (a registered name, a Codec
    object, or None).  Rank threads see it unless their own
    :func:`compression_scope` overrides it."""
    global _process_compression
    _process_compression = _validated_codec(codec)


@contextmanager
def compression_scope(codec):
    """Lexically scoped compression default for this thread;
    ``compression_scope(None)`` forces exact transfers in the block even
    when a process default is set."""
    prev = getattr(_state, "compression", _UNSET)
    _state.compression = _validated_codec(codec)
    try:
        yield
    finally:
        if prev is _UNSET:
            del _state.compression
        else:
            _state.compression = prev


# --- algorithm selection ---------------------------------------------------

_process_algorithm = None


def default_algorithm():
    """The collective algorithm facade ops use when no explicit
    ``algorithm=`` is passed: the innermost active :func:`algorithm_scope`
    on this thread, else the process-wide :func:`set_default_algorithm`
    value.  ``None`` defers to the :mod:`mpi4torch_tpu_torch.tune`
    selector."""
    scoped = getattr(_state, "algorithm", _UNSET)
    return _process_algorithm if scoped is _UNSET else scoped


def _validated_algorithm(name):
    if name is None or name == "auto":
        return None
    from .tune import get_algorithm

    return get_algorithm(name).name  # raises on unknown names


def set_default_algorithm(name) -> None:
    """Set the process-wide default collective algorithm (a registered
    name, or ``None``/``"auto"`` for the selector).  Rank threads see it
    unless their own :func:`algorithm_scope` overrides it.  A default is
    a preference: a collective it cannot serve (``rhd`` on a world that
    is not a power of two, an algorithm the codec does not ride) falls
    back to auto selection, where an explicit ``algorithm=`` raises."""
    global _process_algorithm
    _process_algorithm = _validated_algorithm(name)


@contextmanager
def algorithm_scope(name):
    """Lexically scoped collective-algorithm default on this thread::

        with mpi.config.algorithm_scope("rhd"):
            y = comm.Allreduce(x, mpi.MPI_SUM)   # the butterfly

    The degrade rule of :func:`set_default_algorithm` applies."""
    prev = getattr(_state, "algorithm", _UNSET)
    _state.algorithm = _validated_algorithm(name)
    try:
        yield
    finally:
        if prev is _UNSET:
            del _state.algorithm
        else:
            _state.algorithm = prev


# Measured crossovers of the selector's latency and bandwidth tiers
# (tune.select_auto), set from measurement by tune.autotune_allreduce or
# by hand.  None = not measured: auto selection deviates from `ring`
# only on evidence.
_latency_crossover_bytes = None
_bandwidth_crossover_bytes = None


def latency_crossover_bytes():
    """Payload bytes at or below which the selector prefers a
    latency-optimal algorithm (``rhd``, else ``tree``); None:
    unmeasured."""
    return _latency_crossover_bytes


def set_latency_crossover_bytes(nbytes) -> None:
    global _latency_crossover_bytes
    _latency_crossover_bytes = (
        None if nbytes is None
        else _validated_threshold(nbytes, "latency_crossover_bytes"))


def bandwidth_crossover_bytes():
    """Payload bytes at or above which the selector prefers the multipath
    bandwidth tier (``bidir``); None: unmeasured."""
    return _bandwidth_crossover_bytes


def set_bandwidth_crossover_bytes(nbytes) -> None:
    global _bandwidth_crossover_bytes
    _bandwidth_crossover_bytes = (
        None if nbytes is None
        else _validated_threshold(nbytes, "bandwidth_crossover_bytes"))


_hier_group_size = None


def hier_group_size():
    """Intra-group size of the 2-level ``torus`` split of a rank
    world (must divide its size, 1 < g < size); None: derive it
    (tune.resolve_hier_group)."""
    return _hier_group_size


def set_hier_group_size(g) -> None:
    global _hier_group_size
    _hier_group_size = (None if g is None else
                        _validated_threshold(g, "hier_group_size",
                                             minimum=2))


# --- the tier stack ---------------------------------------------------------

# The flat-axis tier-stack factorization (innermost first) of the
# ``hier`` schedule: None derives it (hier_group_size, else the
# square-root 2-level split; tune.resolve_tier_stack).
_tier_stack = None
# Relative bandwidth of each tier's links, aligned with the tier stack
# (innermost first): the weights of the bandwidth-weighted census
# (csched.weighted_cost) that tier synthesis ranks by, and the skew the
# split-phase tier window is derived from (overlap.tier_window_depth).
# None = uniform.
_tier_bandwidths = None


def tier_stack():
    """The configured tier-stack factorization (innermost first), or
    None to derive.  Each factor must be >= 2 and the product must equal
    the communicator size (validated where it is resolved)."""
    return _tier_stack


def set_tier_stack(stack) -> None:
    global _tier_stack
    if stack is None:
        _tier_stack = None
        return
    try:
        stack = tuple(int(g) for g in stack)
    except (TypeError, ValueError):
        raise ValueError(
            f"tier_stack must be a tuple of ints >= 2 or None, got "
            f"{stack!r}") from None
    if not stack or any(g < 2 for g in stack):
        raise ValueError(
            f"tier_stack factors must all be >= 2, got {stack!r}")
    _tier_stack = stack


def tier_bandwidths():
    """Per-tier relative bandwidths (innermost first), or None for
    uniform weights.  Aligned with the resolved tier stack."""
    return _tier_bandwidths


def set_tier_bandwidths(bws) -> None:
    global _tier_bandwidths
    if bws is None:
        _tier_bandwidths = None
        return
    try:
        bws = tuple(float(b) for b in bws)
    except (TypeError, ValueError):
        raise ValueError(
            f"tier_bandwidths must be a tuple of positive numbers or "
            f"None, got {bws!r}") from None
    if not bws or any(b <= 0 for b in bws):
        raise ValueError(
            f"tier_bandwidths must all be > 0, got {bws!r}")
    _tier_bandwidths = bws


# --- the quantized hop -----------------------------------------------------

_QUANT_HOP_IMPLS = ("auto", "torch", "cuda")
_quant_hop_impl = "auto"


def quant_hop_impl() -> str:
    """Which implementation serves the quantized ring hop
    (``ops/quant_kernels.py``): ``"auto"`` (the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; bitwise equal),
    ``"torch"`` (the plain version on any device) or ``"cuda"`` (the
    kernel, raising for a CPU tensor)."""
    return _quant_hop_impl


def set_quant_hop_impl(impl: str) -> None:
    global _quant_hop_impl
    if impl not in _QUANT_HOP_IMPLS:
        raise ValueError(
            f"quant_hop_impl must be one of {_QUANT_HOP_IMPLS}, got "
            f"{impl!r}")
    _quant_hop_impl = impl


# --- Mode A schedule thresholds (ops/spmd.py) --------------------------------
#
# Process-wide, with the JAX package's defaults and validation.  The
# all-gather+fold form of the deterministic ordered reduction gathers
# size x the tensor on every rank; below this many gathered bytes
# (payload x ranks) it is taken, above it the chunked ring fold, whose
# extra memory does not grow with the rank count.  Both fold in the same
# ascending-rank association, so the switch never changes a bit.
DEFAULT_ORDERED_FOLD_GATHER_MAX_BYTES = 4 * 1024 * 1024
# Pipeline granularity of the deterministic ring fold.
DEFAULT_ORDERED_RING_CHUNK_BYTES = 8 * 1024 * 1024
# Payloads at or below this take the binomial-tree broadcast (log2(N)
# sequential full-payload hops); larger ones the root-masked psum.
DEFAULT_BCAST_TREE_MAX_BYTES = 256 * 1024

_ordered_fold_gather_max_bytes = DEFAULT_ORDERED_FOLD_GATHER_MAX_BYTES
_ordered_ring_chunk_bytes = DEFAULT_ORDERED_RING_CHUNK_BYTES
_bcast_tree_max_bytes = DEFAULT_BCAST_TREE_MAX_BYTES


def ordered_fold_gather_max_bytes() -> int:
    """Gathered-bytes ceiling (payload x ranks) below which the Mode A
    deterministic ordered fold uses the all-gather+fold form instead of
    the chunked ring (ops/spmd.py)."""
    return _ordered_fold_gather_max_bytes


def set_ordered_fold_gather_max_bytes(nbytes) -> None:
    global _ordered_fold_gather_max_bytes
    _ordered_fold_gather_max_bytes = _validated_threshold(
        nbytes, "ordered_fold_gather_max_bytes")


def ordered_ring_chunk_bytes() -> int:
    """Chunk size of the Mode A deterministic ring-fold pipeline
    (ops/spmd.py)."""
    return _ordered_ring_chunk_bytes


def set_ordered_ring_chunk_bytes(nbytes) -> None:
    global _ordered_ring_chunk_bytes
    _ordered_ring_chunk_bytes = _validated_threshold(
        nbytes, "ordered_ring_chunk_bytes", minimum=1)


def bcast_tree_max_bytes() -> int:
    """Payload-bytes ceiling below which a Mode A ``Bcast_`` takes the
    binomial-tree form instead of the root-masked psum (ops/spmd.py)."""
    return _bcast_tree_max_bytes


def set_bcast_tree_max_bytes(nbytes) -> None:
    global _bcast_tree_max_bytes
    _bcast_tree_max_bytes = _validated_threshold(
        nbytes, "bcast_tree_max_bytes")


# Phase pipelining of the deterministic chunked ring fold (ops/spmd.py
# _ring_fold_allreduce): when True (default) a chunk whose ascending-rank
# fold has completed starts its all-gather relay around the ring while
# later chunks are still folding, in one loop with no trailing
# full-payload broadcast.  False keeps the fold-then-tree-broadcast
# two-phase form.  The bits are the same either way: the fold association
# is untouched and the relay only moves data.
_phase_pipelined_ring = True


def phase_pipelined_ring() -> bool:
    """Whether the deterministic chunked ring fold overlaps its
    all-gather head with the reduce-scatter tail (see ops/spmd.py
    ``_ring_fold_allreduce``)."""
    return _phase_pipelined_ring


def set_phase_pipelined_ring(value: bool) -> None:
    global _phase_pipelined_ring
    _phase_pipelined_ring = bool(value)


# --- the reshard planner -----------------------------------------------------

# Default strategy of mpi4torch_tpu_torch.reshard: None ("auto") walks
# the planner's preference order (local < permute < allgather < alltoall
# < rounds; gather, the gather-everything baseline, only when asked for);
# a strategy name pins every plan to it, and a plan it cannot serve
# raises.  Process-wide, so the rank threads see it.
_reshard_strategy = None


def default_reshard_strategy():
    """The strategy :func:`mpi4torch_tpu_torch.reshard.plan_reshard` uses
    when no ``strategy=`` is passed (``None``: the preference order)."""
    return _reshard_strategy


def set_default_reshard_strategy(name) -> None:
    global _reshard_strategy
    if name in (None, "auto"):
        _reshard_strategy = None
        return
    from .reshard.plan import STRATEGIES

    if name not in STRATEGIES:
        raise ValueError(
            f"reshard strategy must be one of {STRATEGIES} or "
            f"None/'auto', got {name!r}")
    _reshard_strategy = name


# --- fault tolerance and observability ---------------------------------------
#
# These knobs are process-wide module globals, not per-thread state: a
# fault plan, a guard or a tracer installed outside ``run_ranks`` must
# reach the rank threads, which a thread-local scope opened outside them
# would never see.

# Retry budget of a timed-out rendezvous barrier or p2p receive: this many
# more patience windows of capped exponential backoff before it raises.
# 0 keeps the single-timeout behaviour.
_comm_retries = 0
# Base backoff in seconds: retry k waits min(backoff * 2**(k-1), 30 s).
_comm_backoff = 0.05


def comm_retries() -> int:
    """Retry extensions a timed-out rendezvous barrier or p2p receive gets
    before it raises (``mpi4torch_tpu_torch.resilience``)."""
    return _comm_retries


def set_comm_retries(n) -> None:
    global _comm_retries
    try:
        n = int(n)
    except (TypeError, ValueError):
        raise ValueError(f"comm_retries must be an integer retry count, "
                         f"got {n!r}") from None
    if n < 0:
        raise ValueError(f"comm_retries must be >= 0, got {n}")
    _comm_retries = n


def comm_backoff() -> float:
    """Base seconds of the capped exponential backoff between retries
    (retry k waits ``min(comm_backoff * 2**(k-1), 30 s)``)."""
    return _comm_backoff


def set_comm_backoff(seconds) -> None:
    global _comm_backoff
    try:
        seconds = float(seconds)
    except (TypeError, ValueError):
        raise ValueError(f"comm_backoff must be a number of seconds, got "
                         f"{seconds!r}") from None
    if seconds < 0:
        raise ValueError(f"comm_backoff must be >= 0, got {seconds}")
    _comm_backoff = seconds


# Non-finite payload guard of the collectives: "off" (no check),
# "warn" (IntegrityWarning naming the offending rank(s)) or "raise"
# (IntegrityError naming them).
_GUARD_MODES = ("off", "warn", "raise")
_comm_finite_guard = "off"


def comm_finite_guard() -> str:
    """Non-finite payload check of the collectives
    (``resilience.guards``): ``"off"``, ``"warn"`` or ``"raise"``."""
    return _comm_finite_guard


def set_comm_finite_guard(mode: str) -> None:
    global _comm_finite_guard
    if mode not in _GUARD_MODES:
        raise ValueError(f"comm_finite_guard must be one of {_GUARD_MODES}, "
                         f"got {mode!r}")
    _comm_finite_guard = mode


# Checksum leg of the compressed rendezvous wire (compress/eager.py):
# when True every encoded payload travels with the CRC32 of its wire
# bytes, and a mismatch raises IntegrityError naming the contributor.
_comm_wire_checksum = False


def comm_wire_checksum() -> bool:
    """Whether the compressed wire carries a verified checksum
    (``resilience.guards.wire_checksum``)."""
    return _comm_wire_checksum


def set_comm_wire_checksum(value: bool) -> None:
    global _comm_wire_checksum
    _comm_wire_checksum = bool(value)


# ---------------------------------------------------------------------------
# The online self-tuning controller (ctl/)
# ---------------------------------------------------------------------------

# Master switch: False (default) keeps SelfTuningController.poll to ONE
# knob read and guarantees the controller changes nothing — the
# fault-plan/obs off-path discipline.
_ctl_enabled = False
# EWMA half-life of the bandwidth estimates, in SAMPLES (after this
# many events a value's weight has decayed to 1/2) — a deterministic
# unit: the smoke/test cells drive the estimator with known event
# counts, never wall-clock.
_ctl_halflife = 4.0
# Hysteresis watermarks on the live/baseline per-tier ratio: a tier
# degrades below `low`, recovers above `high`, and the band between
# them resets both patience counters — scheduler noise oscillating
# inside the band can never flap a switch.
_ctl_drift_low = 0.5
_ctl_drift_high = 0.8
# Consecutive monitor checks past a watermark before the state flips.
_ctl_drift_patience = 2
# Minimum consensus epochs between ratified switches (a second
# anti-flap leg, counted in the currency switches themselves advance).
_ctl_min_switch_epochs = 1
# Ratio below which the escalation is a CODEC escalation (exact ->
# compressed wire, the EQuARX regime) rather than an exact re-rank: at
# a quarter of baseline bandwidth the ~4x smaller q8 wire breaks even
# on the sagged tier.
_ctl_codec_crossover = 0.25


def ctl_enabled() -> bool:
    """Whether the online self-tuning controller acts
    (:mod:`mpi4torch_tpu_torch.ctl`).  Off (default): ``poll`` is one
    attribute read and the program runs exactly as without a
    controller."""
    return _ctl_enabled


def set_ctl_enabled(value: bool) -> None:
    global _ctl_enabled
    _ctl_enabled = bool(value)


def ctl_halflife() -> float:
    """EWMA half-life (in samples) of the controller's live bandwidth
    estimates (ctl.estimate)."""
    return _ctl_halflife


def set_ctl_halflife(halflife) -> None:
    global _ctl_halflife
    try:
        halflife = float(halflife)
    except (TypeError, ValueError):
        raise ValueError(
            f"ctl_halflife must be a number of samples, got "
            f"{halflife!r}") from None
    if not halflife > 0:
        raise ValueError(f"ctl_halflife must be > 0, got {halflife}")
    _ctl_halflife = halflife


def ctl_drift_thresholds():
    """The ``(low, high)`` hysteresis watermarks on the live/baseline
    bandwidth ratio (ctl.drift): degrade below ``low``, recover above
    ``high``, never flap inside the band."""
    return (_ctl_drift_low, _ctl_drift_high)


def set_ctl_drift_thresholds(low, high) -> None:
    global _ctl_drift_low, _ctl_drift_high
    try:
        low, high = float(low), float(high)
    except (TypeError, ValueError):
        raise ValueError(
            f"ctl_drift_thresholds must be numbers, got "
            f"({low!r}, {high!r})") from None
    if not (0.0 < low < high):
        raise ValueError(
            f"ctl_drift_thresholds need 0 < low < high, got "
            f"({low}, {high})")
    _ctl_drift_low, _ctl_drift_high = low, high


def ctl_drift_patience() -> int:
    """Consecutive monitor checks past a watermark before a tier's
    drift state flips (ctl.drift)."""
    return _ctl_drift_patience


def set_ctl_drift_patience(n) -> None:
    global _ctl_drift_patience
    _ctl_drift_patience = _validated_threshold(
        n, "ctl_drift_patience", minimum=1, unit="check count")


def ctl_min_switch_epochs() -> int:
    """Minimum consensus epochs between ratified controller switches
    (ctl.controller) — the anti-flap leg counted in epochs."""
    return _ctl_min_switch_epochs


def set_ctl_min_switch_epochs(n) -> None:
    global _ctl_min_switch_epochs
    _ctl_min_switch_epochs = _validated_threshold(
        n, "ctl_min_switch_epochs", minimum=0, unit="epoch count")


def ctl_codec_crossover() -> float:
    """Live/baseline ratio below which the controller escalates the
    CODEC (exact -> q8) instead of only re-ranking the exact winner
    (ctl.controller)."""
    return _ctl_codec_crossover


def set_ctl_codec_crossover(ratio) -> None:
    global _ctl_codec_crossover
    try:
        ratio = float(ratio)
    except (TypeError, ValueError):
        raise ValueError(
            f"ctl_codec_crossover must be a ratio in (0, 1], got "
            f"{ratio!r}") from None
    if not (0.0 < ratio <= 1.0):
        raise ValueError(
            f"ctl_codec_crossover must be in (0, 1], got {ratio}")
    _ctl_codec_crossover = ratio


# The active fault-injection plan (resilience.FaultPlan) or None: the
# chokepoints read it once per call.
_fault_plan = None


def fault_plan():
    """The active fault-injection plan, or None
    (``mpi4torch_tpu_torch.resilience``)."""
    return _fault_plan


def set_fault_plan(plan) -> None:
    """Install a process-wide fault plan: a ``FaultPlan``, a ``FaultSpec``,
    a sequence of specs, or None to clear."""
    global _fault_plan
    if plan is None:
        _fault_plan = None
        return
    from .resilience.faults import as_plan

    _fault_plan = as_plan(plan)


# The active comm tracer (obs.CommTracer) or None: the chokepoints read
# it once per call.
_comm_tracer = None


def comm_tracer():
    """The active comm tracer, or None (``mpi4torch_tpu_torch.obs``)."""
    return _comm_tracer


def set_comm_tracer(tracer) -> None:
    """Install a process-wide comm tracer (an ``obs.CommTracer``), or None
    to turn tracing off."""
    global _comm_tracer
    _comm_tracer = tracer


# --- the transport -----------------------------------------------------------

# Which registered transport serves run_ranks when no ``backend=`` is
# passed: "thread" (rank threads in this process) or "process" (pooled
# worker processes, mpi4torch_tpu_torch.transport).  Process-wide, like the
# fault plan: the choice must reach whichever thread calls run_ranks.
TRANSPORT_ENV = "MPI4TORCH_TPU_TRANSPORT"
_comm_transport = os.environ.get(TRANSPORT_ENV, "thread")


def comm_transport() -> str:
    """The transport :func:`~mpi4torch_tpu_torch.run_ranks` uses when no
    ``backend=`` is passed (initially ``MPI4TORCH_TPU_TRANSPORT``, else
    ``"thread"``)."""
    return _comm_transport


def set_comm_transport(name) -> None:
    """Set the process-wide default transport: a name registered in
    ``transport.TRANSPORTS`` (``None``: ``"thread"``)."""
    global _comm_transport
    if name is None:
        name = "thread"
    from .transport import TRANSPORTS

    if name not in TRANSPORTS:
        raise ValueError(f"comm_transport must be one of "
                         f"{sorted(TRANSPORTS)}, got {name!r}")
    _comm_transport = name


@contextmanager
def transport_scope(name):
    """The default transport for a ``with`` block, process-wide like
    :func:`set_comm_transport`::

        with mpi.config.transport_scope("process"):
            mpi.run_ranks(step, 4)      # one worker process per rank
    """
    global _comm_transport
    prev = _comm_transport
    set_comm_transport(name)
    try:
        yield
    finally:
        _comm_transport = prev


# --- process state shipped to transport workers -----------------------------
#
# A rank thread sees this process's process-wide knobs and torch's own
# process-wide numeric state; a worker process sees neither unless it is
# shipped.  Thread-scoped state (deterministic_mode and the scopes) is
# not shipped: rank threads do not see the launcher thread's scopes
# either.


def _matmul_precision():
    import torch

    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:
        # torch refuses to read it back after the precision and the TF32
        # flag were set apart; the flags below still carry the state.
        return None


# torch's backend flags that decide a result's bits: the cuBLAS TF32 and
# reduced-precision reductions, cuDNN's TF32 and algorithm choice.
_CUDA_MATMUL_FLAGS = ("allow_tf32", "allow_fp16_reduced_precision_reduction",
                      "allow_bf16_reduced_precision_reduction")
_CUDNN_FLAGS = ("allow_tf32", "deterministic", "benchmark")


def _flag_objects():
    import torch

    return (("cuda_matmul", torch.backends.cuda.matmul, _CUDA_MATMUL_FLAGS),
            ("cudnn", torch.backends.cudnn, _CUDNN_FLAGS))


def _torch_numeric_state() -> dict:
    import torch

    return {
        "default_dtype": torch.get_default_dtype(),
        "float32_matmul_precision": _matmul_precision(),
        **{key: {name: getattr(obj, name) for name in names}
           for key, obj, names in _flag_objects()},
        "deterministic_algorithms": (
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled()),
        # A CPU reduction splits its work by thread count, so its bits
        # may depend on it.
        "num_threads": torch.get_num_threads(),
    }


def _apply_torch_numeric_state(st: dict) -> None:
    """Set each piece of torch's numeric state that differs here (torch
    refuses some combinations of the precision and the TF32 flags set
    one after the other, so nothing already equal is set again)."""
    import torch

    torch.set_default_dtype(st["default_dtype"])
    # The precision first: it also moves the TF32 flag compared below.
    want = st["float32_matmul_precision"]
    if want is not None and want != _matmul_precision():
        torch.set_float32_matmul_precision(want)
    for key, obj, _names in _flag_objects():
        for name, value in st[key].items():
            if getattr(obj, name) != value:
                setattr(obj, name, value)
    enabled, warn_only = st["deterministic_algorithms"]
    if (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled()) \
            != (enabled, warn_only):
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
    if torch.get_num_threads() != st["num_threads"]:
        torch.set_num_threads(st["num_threads"])


def snapshot_process_state() -> dict:
    """Picklable snapshot of the process-wide state a rank body's bits
    depend on: this module's process-wide knobs (a codec by its name)
    and torch's numeric state (default dtype, matmul precision and the
    TF32 / reduced-precision flags, cuDNN's flags, deterministic
    algorithms, the CPU thread count).  The process transport ships it
    to every worker (:func:`apply_process_state`)."""
    codec = _process_compression
    if codec is not None and getattr(codec, "name", None) is not None:
        codec = codec.name
    return {
        "compression": codec,
        "bucket_bytes": _process_bucket_bytes,
        "overlap": _process_overlap,
        "algorithm": _process_algorithm,
        "latency_crossover_bytes": _latency_crossover_bytes,
        "bandwidth_crossover_bytes": _bandwidth_crossover_bytes,
        "hier_group_size": _hier_group_size,
        "tier_stack": _tier_stack,
        "tier_bandwidths": _tier_bandwidths,
        "serve_decode_buckets": _serve_decode_buckets,
        "quant_hop_impl": _quant_hop_impl,
        "ordered_fold_gather_max_bytes": _ordered_fold_gather_max_bytes,
        "ordered_ring_chunk_bytes": _ordered_ring_chunk_bytes,
        "bcast_tree_max_bytes": _bcast_tree_max_bytes,
        "phase_pipelined_ring": _phase_pipelined_ring,
        "reshard_strategy": _reshard_strategy,
        "comm_retries": _comm_retries,
        "comm_backoff": _comm_backoff,
        "comm_finite_guard": _comm_finite_guard,
        "comm_wire_checksum": _comm_wire_checksum,
        "ctl_enabled": _ctl_enabled,
        "ctl_halflife": _ctl_halflife,
        "ctl_drift_thresholds": (_ctl_drift_low, _ctl_drift_high),
        "ctl_drift_patience": _ctl_drift_patience,
        "ctl_min_switch_epochs": _ctl_min_switch_epochs,
        "ctl_codec_crossover": _ctl_codec_crossover,
        "world_timeout": os.environ.get(WORLD_TIMEOUT_ENV),
        "torch": _torch_numeric_state(),
    }


def apply_process_state(state: dict) -> None:
    """Apply a :func:`snapshot_process_state` dict: the worker's half of
    shipping the configuration."""
    set_default_compression(state["compression"])
    set_default_bucket_bytes(state["bucket_bytes"])
    set_default_overlap(state["overlap"])
    set_default_algorithm(state["algorithm"])
    set_latency_crossover_bytes(state["latency_crossover_bytes"])
    set_bandwidth_crossover_bytes(state["bandwidth_crossover_bytes"])
    set_hier_group_size(state["hier_group_size"])
    set_tier_stack(state["tier_stack"])
    set_tier_bandwidths(state["tier_bandwidths"])
    set_serve_decode_buckets(state["serve_decode_buckets"])
    set_quant_hop_impl(state["quant_hop_impl"])
    set_ordered_fold_gather_max_bytes(
        state["ordered_fold_gather_max_bytes"])
    set_ordered_ring_chunk_bytes(state["ordered_ring_chunk_bytes"])
    set_bcast_tree_max_bytes(state["bcast_tree_max_bytes"])
    set_phase_pipelined_ring(state["phase_pipelined_ring"])
    set_default_reshard_strategy(state["reshard_strategy"])
    set_comm_retries(state["comm_retries"])
    set_comm_backoff(state["comm_backoff"])
    set_comm_finite_guard(state["comm_finite_guard"])
    set_comm_wire_checksum(state["comm_wire_checksum"])
    set_ctl_enabled(state["ctl_enabled"])
    set_ctl_halflife(state["ctl_halflife"])
    set_ctl_drift_thresholds(*state["ctl_drift_thresholds"])
    set_ctl_drift_patience(state["ctl_drift_patience"])
    set_ctl_min_switch_epochs(state["ctl_min_switch_epochs"])
    set_ctl_codec_crossover(state["ctl_codec_crossover"])
    if state["world_timeout"] is None:
        os.environ.pop(WORLD_TIMEOUT_ENV, None)
    else:
        os.environ[WORLD_TIMEOUT_ENV] = state["world_timeout"]
    _apply_torch_numeric_state(state["torch"])
