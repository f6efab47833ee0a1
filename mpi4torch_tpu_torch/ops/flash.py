"""Block attention forward: the CUDA kernel, its plain version, and the
dispatch between them.

Port of ``mpi4torch_tpu/ops/flash.py`` as far as serving needs it:
:func:`flash_block_attention` (forward only) and :func:`flash_attention`.
Both return what the JAX package returns: **normalised** partials
``(out, lse)`` of ``q`` against one KV block, with ``out = 0`` and
``lse = -1e30`` on fully masked rows.  Positions are global int32
offsets, so causal and sliding-window masks follow the caller's
sequence positions.

``impl`` mirrors the JAX package's switch:

* ``"torch"`` — the plain PyTorch version (:func:`_torch_block`, the
  counterpart of ``_jnp_block``).  Serving asks for it by name in
  decode, as the JAX package asks for ``impl="jnp"``, and per-row
  ``(batch,)`` offsets force it (the kernel skips tiles off one scalar
  frontier).
* ``"auto"`` — on a CUDA tensor, the hand-written kernel
  (``ops/csrc/flash_fwd.cu``); shapes it does not take raise, they never
  fall back.  On a CPU tensor, the plain version.
* ``"cuda"`` — the kernel, forced (raises on a CPU tensor).

The JAX package's KV chunking (``_KV_VMEM_BUDGET``, ``_kv_chunk_for``)
exists because its TPU kernel stages the whole KV block in VMEM; the CUDA
kernel streams KV tiles, so the port has no chunking.
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
    ``causal``) restricts each query to its last ``window`` positions."""
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
        impl = "torch"
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "torch":
        return _torch_block(q, k, v, q_off, kv_off, causal, window)
    if not q.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got device "
                         f"{q.device}")
    return _kernels.flash_fwd(q, k, v, int(q_offset), int(kv_offset),
                              causal, window)


def flash_attention(q, k, v, *, causal: bool = False, impl: str = "auto",
                    window: int = 0):
    """Single-device attention over the full local KV: the ``out`` of
    :func:`flash_block_attention` with both offsets at 0."""
    out, _ = flash_block_attention(q, k, v, causal=causal, impl=impl,
                                   window=window)
    return out
