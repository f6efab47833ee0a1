"""Block attention, forward and backward: the CUDA kernels, their plain
versions, and the dispatch between them.

Port of ``mpi4torch_tpu/ops/flash.py``: :func:`flash_block_attention` and
:func:`flash_attention`.  Both return what the JAX package returns:
**normalised** partials ``(out, lse)`` of ``q`` against one KV block,
with ``out = 0`` and ``lse = -1e30`` on fully masked rows.  Positions are
global int32 offsets, so causal and sliding-window masks follow the
caller's sequence positions.

The block is differentiable (:class:`_BlockAttention`, the counterpart of
the JAX package's ``custom_vjp`` ``_block``): the backward recomputes the
scores from the residuals ``q, k, v, out, lse`` and never stores them.

``impl`` mirrors the JAX package's switch, forward and backward alike:

* ``"torch"`` — the plain PyTorch versions (:func:`_torch_block`, the
  counterpart of ``_jnp_block``; :func:`_torch_block_bwd`, of the jnp
  path of ``_block_bwd``).  Serving asks for it by name in decode, as the
  JAX package asks for ``impl="jnp"``, and per-row ``(batch,)`` offsets
  force it (the kernels skip tiles off one scalar frontier).
* ``"auto"`` — on a CUDA tensor, the hand-written kernels: for bf16 with
  head dim <= 128 the tensor-core ones (``ops/csrc/flash_fwd_tc.cu``
  forward, ``ops/csrc/flash_bwd_tc.cu`` backward), otherwise the CUDA-core
  ones (``ops/csrc/flash_fwd.cu``, ``ops/csrc/flash_bwd.cu``), as
  ``_kernels.fwd_variant`` picks; shapes they do not take raise, they
  never fall back.  On a CPU tensor, the plain versions.
* ``"cuda"`` — the kernels, forced (raises on a CPU tensor).

:func:`merge_partials` combines two normalised partials over disjoint KV
sets (the online-softmax rule ring attention and KV chunking merge by).
The JAX package's automatic KV chunking (``_KV_VMEM_BUDGET``,
``_kv_chunk_for``) exists because its TPU kernels stage the whole KV
block in VMEM; the CUDA kernels stream KV tiles and need no staging
budget, so :func:`flash_attention` chunks only when the caller forces a
``kv_chunk``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

NEG_BIG = -1e30

_IMPLS = ("auto", "torch", "cuda")


def _compute_dtype(q) -> torch.dtype:
    # At least f32; f64 inputs keep f64 (the CPU tests compare at 1e-12).
    return torch.promote_types(q.dtype, torch.float32)


def _torch_block(q, k, v, q_off, kv_off, causal: bool, window: int = 0):
    """Plain PyTorch block attention: the port of ``_jnp_block`` (the same
    mask algebra, f32-or-wider arithmetic, and fully-masked-row rule).
    ``q_off``/``kv_off`` are int32 tensors on ``q``'s device, scalars or
    per-row ``(batch,)`` vectors."""
    ct = _compute_dtype(q)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scale = torch.tensor(d, dtype=ct, device=q.device).sqrt().reciprocal()
    s = torch.einsum("bqhd,bkhd->bqhk", q.to(ct), k.to(ct)) * scale
    bmask = None
    if causal:
        ar_q = torch.arange(sq, dtype=torch.int32, device=q.device)
        ar_k = torch.arange(sk, dtype=torch.int32, device=q.device)
        if q_off.dim() == 0 and kv_off.dim() == 0:
            q_pos = q_off + ar_q
            kv_pos = kv_off + ar_k
            mask = q_pos[:, None] >= kv_pos[None, :]
            if window:
                # Sliding window: q attends its last `window` positions,
                # itself included.
                mask &= (q_pos[:, None] - kv_pos[None, :]) < window
            bmask = mask[None, :, None, :]
        else:
            # Per-row offsets (continuous-batching decode): each batch row
            # has its own causal / window frontier.
            q_pos = q_off[..., None] + ar_q
            kv_pos = kv_off[..., None] + ar_k
            mask = q_pos[..., :, None] >= kv_pos[..., None, :]
            if window:
                mask &= (q_pos[..., :, None] - kv_pos[..., None, :]) < window
            bmask = mask.expand(b, sq, sk)[:, :, None, :]
        s = torch.where(bmask, s, NEG_BIG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if causal:
        p = torch.where(bmask, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bqhk,bkhd->bqhd", p, v.to(ct))
    safe_l = torch.where(l > 0, l, 1.0)
    out = torch.where(l[..., None] > 0, acc / safe_l[..., None], 0.0)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_BIG)
    return out.to(q.dtype), lse


# The plain backward recomputes scores KV-tiled beyond this many keys, so
# the rebuilt slab stays (b, sq, h, _KV_TILE) instead of (b, sq, h, sk);
# small blocks keep the one-shot einsum.  The JAX package's values, so both
# sum in the same grouping.
_BWD_TILE_ABOVE = 512
_KV_TILE = 128


def _group_sum(dkv, b: int, h_kv: int, g: int):
    """Sum per-q-head dk/dv partials back onto the shared KV heads:
    (b, sk, h_kv*g, d) -> (b, sk, h_kv, d)."""
    if g == 1:
        return dkv
    sk, d = dkv.shape[1], dkv.shape[3]
    return dkv.reshape(b, sk, h_kv, g, d).sum(dim=3)


def _bwd_tile_math(qf, k_t, v_t, do, lse, delta, dlse, q_pos, kv_pos_t,
                   causal: bool, scale, window: int, parts=("dq", "dkv")):
    """Gradient contributions of one KV tile (flash backward:
    ``ds = p * (dp - delta + dlse)``), the port of ``_bwd_tile_math``.
    ``parts`` names what to form, ``"dq"`` and/or ``"dkv"``; the others
    come back as None."""
    s = torch.einsum("bqhd,bkhd->bqhk", qf, k_t) * scale
    if causal:
        m2 = q_pos[:, None] >= kv_pos_t[None, :]
        if window:
            m2 &= (q_pos[:, None] - kv_pos_t[None, :]) < window
        mask = m2[None, :, None, :]
        s = torch.where(mask, s, NEG_BIG)
    p = torch.exp(s - lse[..., None])          # = softmax over this block
    if causal:
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bqhk", do, v_t)
    ds = p * (dp - delta[..., None] + dlse[..., None])
    dq = dk = dv = None
    if "dq" in parts:
        dq = torch.einsum("bqhk,bkhd->bqhd", ds, k_t) * scale
    if "dkv" in parts:
        dv = torch.einsum("bqhk,bqhd->bkhd", p, do)
        dk = torch.einsum("bqhk,bqhd->bkhd", ds, qf) * scale
    return dq, dk, dv


def _torch_block_bwd(q, k, v, out, lse, do, dlse, q_off, kv_off,
                     causal: bool, window: int = 0, parts=("dq", "dkv")):
    """Plain PyTorch backward of :func:`_torch_block`: the port of the jnp
    path of ``_block_bwd``.  Scores are recomputed (KV-tiled past
    ``_BWD_TILE_ABOVE`` keys); grouped-query KV is repeated per q head and
    the group's dk/dv partials are summed at the end.  ``q_off``/``kv_off``
    are scalar int32 tensors; ``dlse`` may be None (zero).  Returns
    ``(dq, dk, dv)`` in the input dtypes; ``parts`` (``"dq"`` and/or
    ``"dkv"``) names the gradients to form, the plain counterparts of the
    two kernels, and the others come back as None."""
    ct = _compute_dtype(q)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    g = h // h_kv
    scale = torch.tensor(d, dtype=ct, device=q.device).sqrt().reciprocal()
    qf, kf, vf = q.to(ct), k.to(ct), v.to(ct)
    if g > 1:
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)
    do = do.to(ct)
    lse = lse.to(ct)
    dlse = torch.zeros_like(lse) if dlse is None else dlse.to(ct)
    delta = torch.sum(do * out.to(ct), dim=-1)              # (b, q, h)
    q_pos = q_off + torch.arange(sq, dtype=torch.int32, device=q.device)
    kv_pos = kv_off + torch.arange(sk, dtype=torch.int32, device=q.device)

    kt = _KV_TILE
    if sk <= _BWD_TILE_ABOVE or sk % kt != 0:
        dq, dk, dv = _bwd_tile_math(qf, kf, vf, do, lse, delta, dlse, q_pos,
                                    kv_pos, causal, scale, window, parts)
    else:
        dq = torch.zeros_like(qf) if "dq" in parts else None
        dk = torch.empty_like(kf) if "dkv" in parts else None
        dv = torch.empty_like(vf) if "dkv" in parts else None
        for j in range(sk // kt):
            t = slice(j * kt, (j + 1) * kt)
            dq_t, dk_t, dv_t = _bwd_tile_math(
                qf, kf[:, t], vf[:, t], do, lse, delta, dlse, q_pos,
                kv_pos[t], causal, scale, window, parts)
            if dq is not None:
                dq = dq + dq_t
            if dk is not None:
                dk[:, t], dv[:, t] = dk_t, dv_t
    if dq is not None:
        dq = dq.to(q.dtype)
    if dk is not None:
        dk = _group_sum(dk, b, h_kv, g).to(k.dtype)
        dv = _group_sum(dv, b, h_kv, g).to(v.dtype)
    return dq, dk, dv


class _BlockAttention(torch.autograd.Function):
    """Differentiable block attention with scalar offsets: the forward and
    the backward both dispatch on the resolved ``impl`` ("torch" or
    "cuda"); the residuals are ``q, k, v, out, lse``.  Offsets are
    int32 tensors for "torch" and Python ints for "cuda"."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, kv_off, causal, window, impl):
        if impl == "torch":
            out, lse = _torch_block(q, k, v, q_off, kv_off, causal, window)
        else:
            out, lse = _kernels.flash_fwd(q, k, v, q_off, kv_off, causal,
                                          window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_off, kv_off, causal, window, impl)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        q_off, kv_off, causal, window, impl = ctx.args
        if impl == "torch":
            dq, dk, dv = _torch_block_bwd(q, k, v, out, lse, do, dlse,
                                          q_off, kv_off, causal, window)
        else:
            # delta and dd in f32, outside the kernels, as the JAX
            # package computes them for its TPU kernels.
            do = do.contiguous()
            dd = torch.sum(do.float() * out.float(), dim=-1)
            if dlse is not None:
                dd = dd - dlse.float()
            dq = _kernels.flash_bwd_dq(q, k, v, do, lse, dd, q_off, kv_off,
                                       causal, window)
            dk, dv = _kernels.flash_bwd_dkv(q, k, v, do, lse, dd, q_off,
                                            kv_off, causal, window)
        return dq, dk, dv, None, None, None, None, None


def _offset(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def flash_block_attention(q, k, v, *, causal: bool = False, q_offset=0,
                          kv_offset=0, impl: str = "auto",
                          window: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalised attention partials of ``q`` against one KV block.

    Arguments are ``(batch, seq, heads, head_dim)``; ``k``/``v`` may carry
    fewer heads than ``q`` (grouped-query attention: q head ``h`` reads KV
    head ``h // (h_q // h_kv)``).  Offsets are the integer global
    positions of the first query / key: Python ints, 0-d tensors, or
    ``(batch,)`` per-row vectors (plain version only).  Returns ``(out,
    lse)`` with ``out`` shaped and typed like ``q`` and ``lse``
    ``(batch, seq_q, heads)`` (f32 from the kernel; the compute dtype,
    f32 or f64, from the plain version).  ``window > 0`` (needs
    ``causal``) restricts each query to its last ``window`` positions.

    Differentiable in ``q``, ``k`` and ``v`` through both outputs, by the
    backward of the same ``impl``.  Per-row offsets are forward-only, as
    in the JAX package (serving decode never differentiates): they run
    the plain forward without the recomputing backward."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {_IMPLS}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q{tuple(q.shape)} and k{tuple(k.shape)}/v{tuple(v.shape)} "
            "must agree on batch and head_dim, and k/v must match")
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(
            f"query heads ({q.shape[2]}) must be a multiple of KV heads "
            f"({k.shape[2]}) — grouped-query attention maps q head h to "
            f"KV head h // (h_q // h_kv)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError(
            "window > 0 requires causal=True (sliding-window attention "
            "is defined over the causal mask)")
    if impl != "torch" and q.is_cuda and all(
            isinstance(o, int) for o in (q_offset, kv_offset)):
        # The kernels take Python ints: build no offset tensor, whose
        # host-to-device copy would wait for the stream on every call.
        return _BlockAttention.apply(q, k, v, q_offset, kv_offset, causal,
                                     window, "cuda")
    q_off = _offset(q_offset, q.device)
    kv_off = _offset(kv_offset, q.device)
    if q_off.dim() > 0 or kv_off.dim() > 0:
        for name, off in (("q_offset", q_off), ("kv_offset", kv_off)):
            if off.dim() > 1 or (off.dim() == 1
                                 and off.shape[0] != q.shape[0]):
                raise ValueError(
                    f"{name} must be a scalar or a (batch,) vector of "
                    f"per-row positions; got shape {tuple(off.shape)} for "
                    f"batch {q.shape[0]}")
        if impl == "cuda":
            raise ValueError(
                "per-row q_offset/kv_offset vectors ride the plain version "
                "only (the kernel skips tiles off one scalar frontier); "
                "use impl='torch' or 'auto'")
        return _torch_block(q, k, v, q_off, kv_off, causal, window)
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "cuda":
        if not q.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors; got device "
                             f"{q.device}")
        q_off, kv_off = int(q_offset), int(kv_offset)
    return _BlockAttention.apply(q, k, v, q_off, kv_off, causal, window,
                                 impl)


def merge_partials(out_a, lse_a, out_b, lse_b):
    """Exact merge of two normalised attention partials over disjoint KV
    sets, the online-softmax combination rule: ``lse = logaddexp(lse_a,
    lse_b)`` and each ``out`` weighted by ``exp(lse_x - lse)``.  The
    arithmetic runs in ``out_a``'s compute dtype (at least f32) and
    ``out`` is cast back to ``out_a``'s dtype after every merge, as the
    JAX package does, so a bf16 ring rounds where the JAX ring rounds.
    A fully masked partial (``lse = -1e30``) gets weight 0."""
    ct = _compute_dtype(out_a)
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse).to(ct)[..., None]
    wb = torch.exp(lse_b - lse).to(ct)[..., None]
    out = out_a.to(ct) * wa + out_b.to(ct) * wb
    return out.to(out_a.dtype), lse


def flash_attention(q, k, v, *, causal: bool = False, impl: str = "auto",
                    kv_chunk: int = 0, window: int = 0):
    """Single-device attention over the full local KV: the ``out`` of
    :func:`flash_block_attention` with both offsets at 0.

    ``kv_chunk`` forces the KV to be processed in chunks of that many
    keys, each through :func:`flash_block_attention` at its KV offset,
    merged by :func:`merge_partials` from a neutral start (``out = 0``,
    ``lse = -1e30``), as the JAX package's chunked path does.  A forced
    chunk must divide the KV length and, on a kernel path (``impl`` other
    than ``"torch"``), be a multiple of the 128-row KV tile.
    ``kv_chunk=0`` is one call on every path: the CUDA kernels tile the
    KV themselves and need no staging budget, so there is no counterpart
    of the JAX package's automatic choice (``_kv_chunk_for``, which its
    CPU path also takes); the two differ by the merges' rounding only."""
    sk = k.shape[1]
    if kv_chunk:
        if kv_chunk < 0 or sk % kv_chunk != 0 or (
                impl != "torch" and kv_chunk % _KV_TILE != 0):
            raise ValueError(
                f"kv_chunk={kv_chunk} must divide the KV length {sk} and "
                f"(for kernel paths) be a multiple of {_KV_TILE}")
    if not kv_chunk or kv_chunk == sk:
        out, _ = flash_block_attention(q, k, v, causal=causal, impl=impl,
                                       window=window)
        return out
    out = torch.zeros_like(q)
    lse = torch.full(q.shape[:3], NEG_BIG, dtype=_compute_dtype(q),
                     device=q.device)
    for lo in range(0, sk, kv_chunk):
        o_b, lse_b = flash_block_attention(
            q, k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk],
            causal=causal, kv_offset=lo, impl=impl, window=window)
        out, lse = merge_partials(out, lse, o_b, lse_b)
    return out
