"""Operations and bytes of the grouped expert products of a dropless
SwiGLU MoE layer (``mpi4torch_tpu_torch.ops.grouped``): per layer and
rank, one launch for ``x W1`` (``(N, d)`` by ``(d, 2 f)`` a held expert)
and one for ``a W2`` (``(N, f)`` by ``(f, d)``) forward, and in the
backward for each the input's gradient and the weights' gradient, ``N``
the assignments the rank computes.

Operations: ``2 N d 2f`` and ``2 N f d`` forward, 6 d f an assignment,
and the same for each of the four backward products, 12 d f.  Bytes:
every operand read once and every result written once, in ``elem``-byte
elements: the held experts' weights (or their gradients) and the rows
in and out of each product.
"""

from __future__ import annotations

# Kernel name as the profiler reports it (a substring): the grouped GEMMs
# that ``torch._grouped_mm`` launches on sm_90.
KERNELS = ("GroupProblemShape", "grouped_mm", "GroupedMm")
ROLES = ("fwd", "bwd")


def products(n: float, d: int, f: int, held: int, elem: int = 2):
    """``[(operations, bytes)]`` of each product one rank's layer
    launches with ``n`` assignments over ``held`` experts, forward then
    backward."""
    w1, w2 = held * d * 2 * f * elem, held * f * d * elem
    x, gu, a = n * d * elem, n * 2 * f * elem, n * f * elem
    fw1 = (2.0 * n * d * 2 * f, x + w1 + gu)
    fw2 = (2.0 * n * f * d, a + w2 + x)
    return {"fwd": [fw1, fw2],
            "bwd": [(fw1[0], gu + w1 + x),      # d x = d(gu) W1^T
                    (fw1[0], x + gu + w1),      # d W1 = x^T d(gu)
                    (fw2[0], x + w2 + a),       # d a = d y W2^T
                    (fw2[0], a + x + w2)]}      # d W2 = a^T d y


def operations(n: float, d: int, f: int, role: str) -> float:
    return sum(o for o, _ in products(n, d, f, 0)[role])


def bound_s(n: float, d: int, f: int, held: int, peak_flops: float,
            peak_bytes_s: float, role: str) -> float:
    """The least time the products of ``role`` of one rank's layer can
    take: each product's operations at the peak rate or its bytes at the
    peak bandwidth, whichever is longer, summed."""
    return sum(max(o / peak_flops, b / peak_bytes_s)
               for o, b in products(n, d, f, held)[role])
