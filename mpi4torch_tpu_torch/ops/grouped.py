"""Grouped matrix products: one launch for the products of many row
groups, each with a matrix of its own (the experts a rank holds).

``grouped_mm(x, w, counts)`` multiplies the rows of ``x`` ``(N, K)``,
laid out group after group (``counts[g]`` rows of group ``g``), by
``w[g]`` ``(K, M)``: one call to ``torch._grouped_mm`` (on the card a
CUTLASS grouped GEMM for bfloat16 on sm_90) for every group at once,
forward and backward.  On the CPU, where that call cannot serve the
operands (float64, or rows that are not 16-byte multiples), the groups
are multiplied one at a time; on the card such operands are refused.
"""

from __future__ import annotations

from typing import Sequence

import torch

_FAST_DTYPES = {"cuda": (torch.bfloat16,),
                "cpu": (torch.bfloat16, torch.float32)}


def fast_path(x, w) -> bool:
    """Whether ``torch._grouped_mm`` takes ``x`` and ``w``: its dtypes on
    the device, and rows and columns that are 16-byte multiples."""
    if not hasattr(torch, "_grouped_mm") or x.dtype != w.dtype:
        return False
    if x.dtype not in _FAST_DTYPES.get(x.device.type, ()):
        return False
    elem = x.element_size()
    return (x.shape[-1] * elem) % 16 == 0 and (w.shape[-1] * elem) % 16 == 0


def group_ends(counts: Sequence[int], device) -> torch.Tensor:
    """The cumulative row ends of the groups, int32 on ``device``: the
    ``offs`` operand of ``torch._grouped_mm``."""
    ends, total = [], 0
    for c in counts:
        total += int(c)
        ends.append(total)
    return torch.tensor(ends, dtype=torch.int32, device=device)


def grouped_mm(x, w, counts: Sequence[int], ends=None):
    """``(N, M)``: rows ``[e_{g-1}, e_g)`` of ``x`` ``(N, K)`` times
    ``w[g]`` ``(K, M)``, for the ``G`` groups of ``counts`` (host ints,
    summing to ``N``).  ``ends`` is :func:`group_ends` of ``counts`` when
    the caller has it.  Differentiable in ``x`` and ``w``."""
    if len(counts) != w.shape[0]:
        raise ValueError(f"grouped_mm: {len(counts)} group counts for "
                         f"{w.shape[0]} matrices")
    if sum(int(c) for c in counts) != x.shape[0]:
        raise ValueError(f"grouped_mm: counts sum to {sum(counts)}, x has "
                         f"{x.shape[0]} rows")
    if x.shape[0] and fast_path(x, w):
        if ends is None:
            ends = group_ends(counts, x.device)
        return torch._grouped_mm(x, w, offs=ends)
    if x.shape[0] and x.device.type != "cpu":
        raise TypeError(
            f"grouped_mm: torch._grouped_mm on {x.device.type} takes "
            f"{_FAST_DTYPES.get(x.device.type, ())} operands whose rows are "
            f"16-byte multiples, got {x.dtype} x {w.dtype} of "
            f"{tuple(x.shape)} x {tuple(w.shape)}")
    outs, lo = [], 0
    for g, c in enumerate(counts):
        outs.append(x[lo:lo + int(c)] @ w[g])
        lo += int(c)
    return torch.cat(outs) if outs else x.new_zeros(0, w.shape[-1])
