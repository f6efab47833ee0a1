"""Framework configuration flags.

Port of the part of ``mpi4torch_tpu/config.py`` this package reads:
``deterministic_mode`` (thread-local, as there), the overlap policy of
the serving decode collectives, the deadlock timeout of rank worlds, and
the knobs of the compressed Allreduce: the default codec
(:func:`set_default_compression`, :func:`compression_scope`), the
bandwidth crossover of the algorithm selector, the ``torus`` group
size and the implementation of the quantized hop
(:func:`quant_hop_impl`).  The deterministic flag
and the compression scope are per thread, so a scope opened before
``run_ranks`` is not seen by the rank threads; the process-wide setters
are.
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


_process_overlap = None


def default_overlap():
    """The overlap policy the serving decode collectives use when none is
    passed: the process-wide :func:`set_default_overlap` value.  Only
    ``None`` and ``False`` (blocking collectives) exist in this
    package."""
    return _process_overlap


def set_default_overlap(value) -> None:
    global _process_overlap
    if value is not None and value is not False:
        raise NotImplementedError(
            f"overlap={value!r}: the split-phase overlap scheduler is not "
            "ported yet (ROADMAP.md, Queue 1 item 4); use None or False")
    _process_overlap = value


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
