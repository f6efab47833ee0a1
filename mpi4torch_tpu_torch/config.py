"""Framework configuration flags.

Port of the part of ``mpi4torch_tpu/config.py`` this package reads:
``deterministic_mode`` (thread-local, as there), the bucket size of the
fused tree collectives (:func:`set_default_bucket_bytes`,
:func:`fusion_scope`), the split-phase overlap policy
(:func:`set_default_overlap`, :func:`overlap_scope`) and the split count
of the serving decode collectives (:data:`SERVE_DECODE_BUCKETS`), the
deadlock timeout of rank worlds,
and the knobs of the compressed Allreduce: the default codec
(:func:`set_default_compression`, :func:`compression_scope`), the
bandwidth crossover of the algorithm selector, the ``torus`` group
size and the implementation of the quantized hop
(:func:`quant_hop_impl`).  The deterministic flag and the scopes are per
thread, so a scope opened before ``run_ranks`` is not seen by the rank
threads; the process-wide setters are.
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


# Split count of the serving decode step's per-layer collectives: with the
# overlap policy on, each decode payload is split into this many windowed
# split-phase chunks (the JAX package's default; its setter is not ported,
# no caller here sets another value).
SERVE_DECODE_BUCKETS = 2


def _validated_threshold(nbytes, what: str, minimum: int = 0) -> int:
    try:
        nbytes = int(nbytes)
    except (TypeError, ValueError):
        raise ValueError(f"{what} must be an integer byte count, got "
                         f"{nbytes!r}") from None
    if nbytes < minimum:
        raise ValueError(f"{what} must be >= {minimum}, got {nbytes}")
    return nbytes


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

# Measured crossover of the selector's bandwidth tier (tune.select_auto).
# None = not measured: auto selection deviates from `ring` only on
# evidence.
_bandwidth_crossover_bytes = None


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
