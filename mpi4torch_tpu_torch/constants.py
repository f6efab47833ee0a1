"""Reduction-op codes and the ordered fold.

Port of ``mpi4torch_tpu/constants.py``: the same library-stable op codes
(those of the mpi4torch reference's ``Mpi4torchCollectiveOps`` enum) and
the fixed ascending-rank fold that makes every eager reduction
deterministic and bit-reproducible.  The JAX package folds large
CPU-resident operands in a host C++ kernel; here the fold is torch ops on
the tensors' own device, in the identical association.
"""

from __future__ import annotations

import torch

MPI_MAX = 1
MPI_MIN = 2
MPI_SUM = 3
MPI_PROD = 4
MPI_LAND = 5
MPI_BAND = 6
MPI_LOR = 7
MPI_BOR = 8
MPI_LXOR = 9
MPI_BXOR = 10
MPI_MINLOC = 11
MPI_MAXLOC = 12

_OP_NAMES = {
    MPI_MAX: "MPI_MAX",
    MPI_MIN: "MPI_MIN",
    MPI_SUM: "MPI_SUM",
    MPI_PROD: "MPI_PROD",
    MPI_LAND: "MPI_LAND",
    MPI_BAND: "MPI_BAND",
    MPI_LOR: "MPI_LOR",
    MPI_BOR: "MPI_BOR",
    MPI_LXOR: "MPI_LXOR",
    MPI_BXOR: "MPI_BXOR",
    MPI_MINLOC: "MPI_MINLOC",
    MPI_MAXLOC: "MPI_MAXLOC",
}

_BITWISE_OPS = (MPI_BAND, MPI_BOR, MPI_BXOR)


def op_name(op: int) -> str:
    return _OP_NAMES.get(op, f"<unknown op {op}>")


def fold_supported(op: int) -> bool:
    """True iff :func:`combine2` can evaluate ``op`` (everything but the
    pair-semantics MINLOC/MAXLOC and unknown codes)."""
    return op in _OP_NAMES and op not in (MPI_MINLOC, MPI_MAXLOC)


def fold_applicable(op: int, dtype: torch.dtype) -> bool:
    """Dtype-aware :func:`fold_supported`: bitwise ops apply to integer
    and bool tensors only.  Gates that hand a fold to one rank key on
    this, so an op invalid for the dtype raises on every rank alike."""
    if not fold_supported(op):
        return False
    if op in _BITWISE_OPS:
        return not (dtype.is_floating_point or dtype.is_complex)
    return True


def combine2(op: int, a, b):
    """Elementwise combination of two operands for reduction ``op``."""
    if op == MPI_SUM:
        return a + b
    if op == MPI_MAX:
        return torch.maximum(a, b)
    if op == MPI_MIN:
        return torch.minimum(a, b)
    if op == MPI_PROD:
        return a * b
    if op == MPI_LAND:
        return torch.logical_and(a != 0, b != 0).to(a.dtype)
    if op == MPI_LOR:
        return torch.logical_or(a != 0, b != 0).to(a.dtype)
    if op == MPI_LXOR:
        return torch.logical_xor(a != 0, b != 0).to(a.dtype)
    if op in _BITWISE_OPS:
        if not fold_applicable(op, a.dtype):
            raise TypeError(
                f"{op_name(op)} applies to integer and bool tensors only; "
                f"got dtype {a.dtype}")
        if op == MPI_BAND:
            return a & b
        if op == MPI_BOR:
            return a | b
        return a ^ b
    if op in (MPI_MINLOC, MPI_MAXLOC):
        raise NotImplementedError(
            f"{op_name(op)} requires (value, index) pair semantics, which "
            "no collective here provides; use Allreduce(MPI_MIN/MPI_MAX) "
            "plus an argmin/argmax instead.")
    raise ValueError(f"Unknown reduction op code {op}")


def reduce_ordered(op: int, values):
    """Reduce a list of per-rank tensors in ascending rank order: the
    left fold ``((v0 op v1) op v2) ...`` — fixed association, so the
    result is the same bits on every rank and every run."""
    if not values:
        raise ValueError("reduce_ordered needs at least one value")
    out = values[0]
    for v in values[1:]:
        out = combine2(op, out, v)
    return out
