"""Reduction-op codes and the ordered fold.

Port of ``mpi4torch_tpu/constants.py``: the same library-stable op codes
(those of the mpi4torch reference's ``Mpi4torchCollectiveOps`` enum) and
the fixed ascending-rank fold that makes every eager reduction
deterministic and bit-reproducible.  The JAX package folds large
CPU-resident operands in a host C++ kernel; here the fold is torch ops on
the tensors' own device, in the identical association.

It also holds the folds of the other wire algorithms, each in the
association its compiled schedule reduces in (:func:`reduce_rhd`,
:func:`reduce_tree`, :func:`reduce_grouped`, :func:`reduce_torus`,
bitwise equal to the JAX package's on the same inputs), the quantized
fold oracle of the block-q8 codecs (:func:`reduce_q8_hop`) with its
multipath schedule rules, and the division of the rank means
(:func:`divide`).
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


def scalar_like(x, like):
    """``x`` as a 0-d tensor of ``like``'s dtype on its device, as JAX's
    weak typing casts a Python scalar before the op.  A 0-d device tensor
    (not a Python scalar) also keeps a CUDA division a true division: a
    host scalar there becomes a multiplication by its reciprocal, which
    is one ulp off ``x / n`` for some ``n`` (3 and 6 among them)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def divide(x, n):
    """``x / n`` for a Python number ``n``, rounded as the JAX package's
    ``x / n`` on every device: the rank means (``mean=True``, ``/ size``)
    divide through here."""
    return x / scalar_like(n, x)


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


def reduce_rhd(op: int, values):
    """Reduce per-rank tensors in the recursive halving/doubling
    association: a balanced binary tree pairing rank ``i`` with rank
    ``i + h`` at ``h = n/2, n/4, ..., 1``.  Needs a power-of-two count."""
    vals = list(values)
    n = len(vals)
    if n & (n - 1):
        raise ValueError(
            f"reduce_rhd needs a power-of-two rank count, got {n}")
    while n > 1:
        h = n // 2
        vals = [combine2(op, vals[i], vals[i + h]) for i in range(h)]
        n = h
    return vals[0]


def reduce_tree(op: int, values):
    """Reduce per-rank tensors in the binomial-tree-toward-rank-0
    association: at step ``s = 2^(k-1), ..., 2, 1`` every rank ``r < s``
    with ``r + s < n`` absorbs rank ``r + s``'s partial.  Any count."""
    vals = list(values)
    n = len(vals)
    step = 1
    while step < n:
        step *= 2
    step //= 2
    while step >= 1:
        for r in range(step):
            if r + step < n:
                vals[r] = combine2(op, vals[r], vals[r + step])
        step //= 2
    return vals[0] if vals else None


def reduce_grouped(op: int, values, group: int):
    """Reduce per-rank tensors in the 2-level hierarchical association:
    the ascending fold within each block of ``group`` consecutive ranks,
    then the ascending fold of the block partials.  The fold body is the
    schedule-IR interpreter's ``level_fold`` path
    (``csched.interp.level_fold_groups``), the one that folds the
    ``hier`` program, so the two cannot drift apart."""
    vals = list(values)
    n = len(vals)
    if group < 1 or n % group:
        raise ValueError(
            f"reduce_grouped needs group ({group}) to divide the rank "
            f"count ({n})")
    from .csched.interp import level_fold_groups
    from .csched.programs import _hier_groups

    inner, outer, _ = _hier_groups(n, group)
    return level_fold_groups(
        outer, op, level_fold_groups(inner, op, vals))[0]


def reduce_torus(op: int, values, inner: int):
    """Reduce per-rank tensors in the 2-axis torus multipath association:
    ranks form a row-major ``(n // inner, inner)`` grid, the flat payload
    splits at :func:`multipath_split`, and each half folds in the grouped
    association of its own channel: half 0 as :func:`reduce_grouped`
    (within blocks of ``inner``, then across), half 1 on the transposed
    grid (within each strided group ``{i, i + inner, ...}``, then
    across)."""
    vals = list(values)
    n = len(vals)
    if inner < 1 or n % inner:
        raise ValueError(
            f"reduce_torus needs inner ({inner}) to divide the rank "
            f"count ({n})")
    if n == 1:
        return vals[0]
    # The fold is the torus program's interpretation: the deterministic
    # channels (half 0 inner tier first, half 1 the transposed grid)
    # executed by the schedule-IR interpreter's one level_fold path.
    from .csched.interp import interpret_allreduce
    from .csched.ir import Phase, Program, Step
    from .csched.programs import _hier_groups

    inner_groups, outer_groups, outer_n = _hier_groups(n, inner)
    ch0 = (Step("level_fold", (inner_groups, inner), span=("half", 0)),
           Step("level_fold", (outer_groups, outer_n), span=("half", 0)))
    ch1 = (Step("level_fold", (outer_groups, outer_n), span=("half", 1)),
           Step("level_fold", (inner_groups, inner), span=("half", 1)))
    prog = Program("allreduce", "torus", n,
                   (Phase("multipath", ch0 + ch1),))
    return interpret_allreduce(prog, op, vals)


def multipath_split(total: int) -> int:
    """The split point of a multipath payload: the first
    ``multipath_split(total)`` flat elements ride channel 0, the rest
    channel 1."""
    return -(-int(total) // 2)


def multipath_ring_orders(n: int, algorithm, *, inner=None,
                          reverse: bool = False):
    """The channel schedules of the quantized multipath collectives: a
    tuple of ``(sigma, direction)`` ring channels.  ``sigma`` maps ring
    position to rank (``None``: position ``p`` is rank ``p``) and
    ``direction`` is the ring step (+1/-1).

    * ``ring`` — one identity channel.
    * ``bidir`` — two counter-rotating identity channels; ``reverse``
      swaps the directions, which is how the backward pass runs (the
      adjoint of a ring segment is the reverse ring).
    * ``torus`` — two same-direction channels on transposed walks of the
      ``(outer, inner)`` rank grid: row-major, then column-major."""
    if algorithm in (None, "ring"):
        return ((None, 1),)
    if algorithm == "bidir":
        return ((None, -1), (None, 1)) if reverse else ((None, 1),
                                                        (None, -1))
    if algorithm == "torus":
        if inner is None or inner < 1 or n % inner:
            raise ValueError(
                f"the torus multipath schedule needs an inner group size "
                f"dividing the rank count; got inner={inner} for {n} "
                "ranks")
        outer = n // inner
        sigma = tuple((p % outer) * inner + p // outer for p in range(n))
        return ((None, 1), (sigma, 1))
    raise ValueError(
        f"no multipath ring decomposition for algorithm {algorithm!r} "
        "(the quantized in-schedule pipeline serves ring-shaped "
        "schedules: ring, bidir, torus)")


def _sim_quant_ring(flats, block, sigma, d, salt, stochastic, hop_ef,
                    track):
    """Simulate one quantized ring channel over the per-rank contribution
    list, hop for hop: the same chunk layout, requantization and
    schedule-keyed noise as the JAX package's oracle.  Every hop runs
    through ``ops/quant_kernels.dequant_accum_requant`` on the
    contributions' device (the CUDA kernel K1 on a card).  Returns
    ``(reduced_flat, per_rank_residual_flats or None)``."""
    from .ops import quant_kernels as qk

    n = len(flats)
    total = flats[0].numel()
    device = flats[0].device
    xcbs = [qk.chunk_blocks(f, n, block)[0] for f in flats]
    nb = xcbs[0].shape[1]
    sig = list(sigma) if sigma is not None else list(range(n))
    want = hop_ef or track

    def noise(t, rank):
        if not stochastic:
            return None
        return qk.hop_noise(qk.schedule_key(salt, t, rank), nb, block,
                            device=device)

    state = [None] * n                      # per position: (q, scale)
    carry = [None] * n                      # per position: hop residual
    err = ([torch.zeros_like(xcbs[0]) for _ in range(n)]  # per rank
           if track else None)
    for p in range(n):
        r = sig[p]
        c0 = (p - d) % n
        q, s, res = qk.dequant_accum_requant(None, None, xcbs[r][c0],
                                             noise=noise(0, r),
                                             want_resid=want)
        state[p] = (q, s)
        if hop_ef:
            carry[p] = res
        if track:
            err[r][c0] = res
    for t in range(1, n):
        new = [None] * n
        for p in range(n):
            r = sig[p]
            q, s = state[(p - d) % n]       # payload moved one step
            c = (p - d * (t + 1)) % n
            mine = xcbs[r][c]
            if hop_ef:
                mine = mine + carry[p]
            q2, s2, res = qk.dequant_accum_requant(
                q, s, mine, noise=noise(t, r), want_resid=want)
            new[p] = (q2, s2)
            if hop_ef:
                carry[p] = res
            if track:
                err[r][c] = res
        state = new
    pieces = [(state[c][0].to(torch.float32)
               * state[c][1][:, None]).reshape(-1) for c in range(n)]
    out = torch.cat(pieces)[:total]
    if not track:
        return out, None
    return out, [e.reshape(-1)[:total] for e in err]


def reduce_q8_hop(values, *, block: int = 256, algorithm="ring",
                  inner=None, reverse: bool = False,
                  stochastic: bool = False, hop_ef: bool = False,
                  ef_rounds: int = 1):
    """The quantized fold oracle: reduce per-rank tensors through a
    bit-exact simulation of the in-schedule quantized collective —
    chunked block-q8 ring reduce-scatter with a fresh-block-scale
    dequantize→accumulate→requantize at every hop, composed over the
    multipath channels of ``algorithm`` (:func:`multipath_ring_orders`)
    and the codec's error-feedback rounds.  ``reverse`` mirrors the
    backward pass's swapped ``bidir`` directions.  Bitwise equal to the
    JAX package's ``constants.reduce_q8_hop`` on the same inputs."""
    vals = list(values)
    if not vals:
        raise ValueError("reduce_q8_hop needs at least one value")
    n = len(vals)
    if n == 1:
        return vals[0]
    shape, dtype = vals[0].shape, vals[0].dtype
    flats = [v.to(torch.float32).reshape(-1) for v in vals]
    total = flats[0].numel()
    orders = multipath_ring_orders(n, algorithm, inner=inner,
                                   reverse=reverse)
    m = multipath_split(total) if len(orders) > 1 else total
    from .ops import quant_kernels as qk

    outs = []
    for k, (sigma, d) in enumerate(orders):
        if k > 0 and m >= total:
            break
        chan = [f[:m] if k == 0 else f[m:] for f in flats]
        out, resids = _sim_quant_ring(chan, block, sigma, d,
                                      qk.ring_salt(0, k), stochastic,
                                      hop_ef, track=ef_rounds > 1)
        for r in range(1, ef_rounds):
            last = r == ef_rounds - 1
            more, resids = _sim_quant_ring(resids, block, sigma, d,
                                           qk.ring_salt(r, k), stochastic,
                                           hop_ef, track=not last)
            out = out + more
        outs.append(out)
    flat_out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return flat_out.reshape(shape).to(dtype)
