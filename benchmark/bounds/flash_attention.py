"""Operations and bytes of the attention kernels K2 (forward), K3 (dq) and
K4 (dk, dv), counted from the model's shapes.

Operations count the query-key pairs that the causal and window masks
leave, per query head: the forward does two products of ``d`` (``q k`` and
``p v``), 4 d a pair; the dq kernel recomputes the scores and forms
``do v`` and ``ds k``, 6 d; the dk/dv kernel recomputes the scores and
forms ``p do``, ``do v`` and ``ds q``, 8 d.  Bytes count every input read
once and every output written once: q, o, do and dq at the query heads,
k, v, dk and dv at the KV heads the model has, the row statistics (lse,
dd) in float32.
"""

from __future__ import annotations

# Kernel name as the profiler reports it (a substring) -> its role.
KERNELS = {"flash_fwd": "fwd", "flash_bwd_dq": "dq", "flash_bwd_dkv": "dkv"}
OPS_PER_PAIR_PER_DIM = {"fwd": 4, "dq": 6, "dkv": 8}


def pairs(sq: int, sk: int, causal: bool, window: int = 0) -> int:
    """Query-key pairs a head computes for one sequence: every pair
    without a mask; with ``causal`` the keys at or before each query, and
    with a ``window`` the last ``window`` of those (the query included).
    Queries and keys start at position 0."""
    if not causal:
        return sq * sk
    total = 0
    for q in range(sq):
        seen = min(q + 1, sk)
        total += min(seen, window) if window else seen
    return total


def operations(call: dict, role: str) -> float:
    """Floating-point operations of one launch of kernel ``role`` on the
    attention ``call`` (``b, sq, sk, h, h_kv, d, causal, window``)."""
    n = pairs(call["sq"], call["sk"], call["causal"], call.get("window", 0))
    return float(OPS_PER_PAIR_PER_DIM[role] * call["d"] * n * call["h"]
                 * call["b"])


def nbytes(call: dict, role: str, elem: int = 2) -> float:
    """Bytes one launch of kernel ``role`` must read and write at least:
    ``elem``-byte operands, float32 row statistics."""
    b, sq, sk, h, h_kv, d = (call[k] for k in ("b", "sq", "sk", "h", "h_kv",
                                               "d"))
    q_side = b * sq * h * d * elem       # one of q, o, do, dq
    kv_side = b * sk * h_kv * d * elem   # one of k, v, dk, dv
    stats = b * sq * h * 4               # one of lse, dd
    if role == "fwd":                    # q, k, v in; o, lse out
        return float(2 * q_side + 2 * kv_side + stats)
    if role == "dq":                     # q, k, v, do, lse, dd in; dq out
        return float(3 * q_side + 2 * kv_side + 2 * stats)
    # q, k, v, do, lse, dd in; dk, dv out
    return float(2 * q_side + 4 * kv_side + 2 * stats)


def bound_s(call: dict, role: str, peak_flops: float,
            peak_bytes_s: float) -> float:
    """The least time one launch can take: the larger of its operations
    at the peak rate and its bytes at the peak bandwidth."""
    return max(operations(call, role) / peak_flops,
               nbytes(call, role) / peak_bytes_s)
