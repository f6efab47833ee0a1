"""Tensor-parallel KV-cache prefill and decode: the serving compute core.

Port of the dense slot-table part of ``mpi4torch_tpu/serve/kv.py``.
Heads are sharded over the communicator by the ``parallel/tp.py``
conventions (each rank owns ``n_heads / size`` query heads and
``kv_heads / size`` KV heads end to end), so per-head attention never
crosses ranks and each layer costs two collectives: the row-parallel
output projection's Allreduce and the row-parallel FFN Allreduce.

:func:`decode_step_tp` takes one position per slot: every slot of the
continuous batch sits at its own sequence position, written through a
:func:`~mpi4torch_tpu_torch.ops.ragged.position_onehot` mask and masked
per row in attention.  The KV cache is updated in place (see
``models/transformer.py``).  Inference only: nothing here is
differentiated.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import config as _config
from ..constants import MPI_SUM
from ..models.transformer import (TransformerConfig, _ffn_local, _norm,
                                  _rope_rotate)
from ..ops.flash import flash_attention, flash_block_attention
from ..ops.ragged import position_onehot
from ..overlap import overlap_split_allreduce, resolve_overlap
from ..parallel.tp import shard_axis, shard_heads
from ..runtime import CommError
from ..utils.profiling import bucket_scope, serve_step_scope

__all__ = [
    "validate_tp",
    "shard_params_tp",
    "init_kv_cache_tp",
    "prefill_tp",
    "decode_step_tp",
]


def validate_tp(cfg: TransformerConfig, size: int) -> None:
    """Serving TP shardability of a model config over ``size`` ranks:
    whole q heads, whole KV heads, and an FFN hidden width divisible per
    rank.  MoE configs are refused."""
    if cfg.n_experts > 0:
        raise CommError(
            "serve: MoE configs (n_experts > 0) are not supported by the "
            "dense TP decode path — expert-parallel serving needs the "
            "Alltoall routing schedule")
    if cfg.n_heads % size != 0 or cfg.kv_heads % size != 0:
        raise CommError(
            f"serve: n_heads={cfg.n_heads} and kv_heads={cfg.kv_heads} "
            f"must both divide into {size} TP ranks (whole-head "
            "sharding)")
    if cfg.d_ff % size != 0:
        raise CommError(
            f"serve: d_ff={cfg.d_ff} not divisible by world size {size}")


def _shard_wqkv(cfg: TransformerConfig, comm, wqkv):
    """This rank's column slice of the fused qkv projection: the q, k and
    v head-block ranges each shard by whole heads and re-fuse as
    ``[q_r | k_r | v_r]`` — still one matmul per layer."""
    h, h_kv = cfg.n_heads, cfg.kv_heads
    hd = cfg.d_model // h
    q = wqkv[:, :h * hd]
    k = wqkv[:, h * hd:(h + h_kv) * hd]
    v = wqkv[:, (h + h_kv) * hd:]
    return torch.cat([shard_heads(comm, q, h, 1),
                      shard_heads(comm, k, h_kv, 1),
                      shard_heads(comm, v, h_kv, 1)], dim=1)


def _shard_swiglu_w1(cfg: TransformerConfig, comm, w1):
    """This rank's column slice of swiglu's fused gate|up projection
    (each half sharded separately, so the rank keeps matching slices)."""
    gate, up = w1[:, :cfg.d_ff], w1[:, cfg.d_ff:]
    return torch.cat([shard_axis(comm, gate, 1), shard_axis(comm, up, 1)],
                     dim=1)


def shard_params_tp(cfg: TransformerConfig, params, comm):
    """This rank's tensor-parallel serving shard of a full parameter tree:
    ``wqkv`` column-sharded by whole heads (per q/k/v block), ``wo``
    row-sharded by the same q-head blocks, ``w1`` column-sharded,
    ``w2`` row-sharded; embeddings, norms, positions and the unembedding
    replicated (so every rank computes the same logits).  At size 1 every
    shard is the full matrix."""
    size = comm.size
    validate_tp(cfg, size)

    def block_shard(blk):
        out = {"ln1": blk["ln1"], "ln2": blk["ln2"],
               "wqkv": _shard_wqkv(cfg, comm, blk["wqkv"]),
               "wo": shard_heads(comm, blk["wo"], cfg.n_heads, 0)}
        if cfg.ffn == "swiglu":
            out["w1"] = _shard_swiglu_w1(cfg, comm, blk["w1"])
        else:
            out["w1"] = shard_axis(comm, blk["w1"], 1)
        out["w2"] = shard_axis(comm, blk["w2"], 0)
        return out

    shards = {"embed": params["embed"], "ln_f": params["ln_f"],
              "unembed": params["unembed"],
              "blocks": [block_shard(blk) for blk in params["blocks"]]}
    if "pos" in params:
        shards["pos"] = params["pos"]
    return shards


def init_kv_cache_tp(cfg: TransformerConfig, slots: int, size: int,
                     dtype, device, poison: bool = False):
    """Per-layer TP-sharded slot-table KV cache, ``(slots, max_seq,
    kv_heads / size, head_dim)`` per rank.  ``poison=True`` fills it with
    NaN — the engine's free-slot discipline: a poisoned row that leaked
    into a live slot would show at once, and admission overwrites the
    whole slot row, so live slots never see the poison."""
    hd = cfg.d_model // cfg.n_heads
    shape = (slots, cfg.max_seq, cfg.kv_heads // size, hd)
    fill = float("nan") if poison and dtype.is_floating_point else 0

    def buf():
        return torch.full(shape, fill, dtype=dtype, device=device)

    return [{"k": buf(), "v": buf()} for _ in range(cfg.n_layers)]


def _tp_size(cfg: TransformerConfig, shards) -> int:
    """The TP world size a shard tree was built for, read off the output
    projection's row count."""
    hd = cfg.d_model // cfg.n_heads
    h_local = shards["blocks"][0]["wo"].shape[0] // hd
    return cfg.n_heads // h_local


def _split_qkv_local(cfg: TransformerConfig, blk, y, positions, size):
    """This rank's q/k/v head slabs from its ``[q_r | k_r | v_r]``
    projection shard.  ``positions`` is ``(s,)`` or per-slot ``(b, s)``."""
    b, s = y.shape[0], y.shape[1]
    h_loc = cfg.n_heads // size
    hkv_loc = cfg.kv_heads // size
    hd = cfg.d_model // cfg.n_heads
    qkv = y @ blk["wqkv"]
    q = qkv[..., :h_loc * hd].reshape(b, s, h_loc, hd)
    k = qkv[..., h_loc * hd:(h_loc + hkv_loc) * hd].reshape(
        b, s, hkv_loc, hd)
    v = qkv[..., (h_loc + hkv_loc) * hd:].reshape(b, s, hkv_loc, hd)
    if cfg.rope:
        q = _rope_rotate(cfg, q, positions)
        k = _rope_rotate(cfg, k, positions)
    return q, k, v


def _decode_allreduce(comm, x, *, site: int, nsites: int, overlap,
                      algorithm=None):
    """One decode collective site: the row-parallel partial-sum
    Allreduce, scheduled per the overlap policy.  ``overlap`` truthy →
    the windowed split-phase chunk window
    (:func:`~mpi4torch_tpu_torch.overlap.overlap_split_allreduce`, span
    labels numbered over the step's ``nsites`` sites); falsy → the
    blocking facade op under a per-site span.  Both give the same bits.
    Always exact (``compression=False``: decode activations are forward
    values, out of a gradient codec's reach)."""
    if comm is None:
        return x
    if overlap:
        k = _config.SERVE_DECODE_BUCKETS
        return overlap_split_allreduce(
            comm, x, MPI_SUM, nsplits=k, index_base=site * k,
            index_total=nsites * k, op_name="ServeDecode",
            algorithm=algorithm)
    with bucket_scope("ServeDecode", site, nsites):
        return comm.Allreduce(x, MPI_SUM, compression=False,
                              algorithm=algorithm)


def prefill_tp(cfg: TransformerConfig, shards, cache, prompt, comm=None):
    """TP prefill: fill this rank's KV-cache shard rows from a whole
    prompt in one batched pass and return ``(last_logits, cache)``.
    Attention runs through :func:`flash_attention` (the CUDA kernel on a
    CUDA device); one blocking Allreduce per row-parallel half."""
    b, p_len = prompt.shape
    size = _tp_size(cfg, shards)
    x = shards["embed"][prompt]
    if not cfg.rope:
        x = x + shards["pos"][None, :p_len]
    positions = torch.arange(p_len, dtype=torch.int32, device=x.device)
    with serve_step_scope("prefill"):
        for blk, c in zip(shards["blocks"], cache):
            y = _norm(cfg, x, blk["ln1"])
            q, k, v = _split_qkv_local(cfg, blk, y, positions, size)
            c["k"][:, :p_len] = k.to(c["k"].dtype)
            c["v"][:, :p_len] = v.to(c["v"].dtype)
            o = flash_attention(q, k, v, causal=True,
                                window=cfg.attn_window)
            o_part = o.reshape(b, p_len, -1) @ blk["wo"]
            if comm is not None:
                o_part = comm.Allreduce(o_part, MPI_SUM, compression=False)
            x = x + o_part.to(x.dtype)
            ff = _ffn_local(cfg, blk, _norm(cfg, x, blk["ln2"]))
            if comm is not None:
                ff = comm.Allreduce(ff, MPI_SUM, compression=False)
            x = x + ff.to(x.dtype)
        x = _norm(cfg, x, shards["ln_f"])
        return x[:, -1] @ shards["unembed"], cache


def decode_step_tp(cfg: TransformerConfig, shards, cache, tokens, pos,
                   comm=None, *, overlap=None,
                   algorithm: Optional[str] = None, active=None):
    """One continuous-batching decode step over the whole slot table:
    logits ``(slots, vocab)`` for ``tokens`` ``(slots,)``, each slot at
    its own position ``pos[slot]``, writing this rank's KV-cache shard in
    place.  Returns ``(logits, cache)``.

    Per slot this is ``models/transformer.decode_step``'s math over the
    full ``max_seq`` buffer with per-row causal / window masks.  Free
    slots compute row-local garbage that never touches live rows: every
    op is row-wise, and the collectives reduce over ranks, not slots.
    ``active`` (``(slots,)`` bool) zeroes the free slots' rows of every
    collective payload, so a NaN-poisoned free slot never reaches the
    wire; live rows pass through ``where`` unchanged.

    ``overlap`` (``None`` defers to ``config.default_overlap()``) truthy
    rides each of the ``2 * n_layers`` collective sites through the
    windowed split-phase chunk window; falsy is the blocking baseline.
    ``algorithm`` is the schedule of every decode Allreduce (None: the
    selector).  The chunks split an elementwise sum, so the overlap
    window gives the blocking bits; another ``algorithm`` folds in its
    own association (on two ranks every schedule is the one addition)."""
    slots = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    size = _tp_size(cfg, shards)
    ov = resolve_overlap(overlap)
    nsites = 2 * len(shards["blocks"])
    live = None if active is None else \
        torch.as_tensor(active, device=tokens.device).to(torch.bool)[:, None]

    def guard_rows(payload):
        if live is None:
            return payload
        return torch.where(live, payload, torch.zeros((), dtype=payload.dtype,
                                                      device=payload.device))

    with serve_step_scope("decode_step"):
        x = shards["embed"][tokens]
        if not cfg.rope:
            x = x + shards["pos"][pos]
        wmask = (position_onehot(pos, cfg.max_seq) != 0)[:, :, None, None]
        site = 0
        for blk, c in zip(shards["blocks"], cache):
            y = _norm(cfg, x, blk["ln1"])
            q, k_new, v_new = _split_qkv_local(cfg, blk, y[:, None, :],
                                               pos[:, None], size)
            for name, new in (("k", k_new), ("v", v_new)):
                buf = c[name]
                torch.where(wmask, new.to(buf.dtype), buf, out=buf)
            o, _ = flash_block_attention(
                q, c["k"], c["v"], causal=True, q_offset=pos, kv_offset=0,
                window=cfg.attn_window, impl="torch")
            o_part = o.reshape(slots, -1).to(x.dtype) @ blk["wo"]
            attn = _decode_allreduce(comm, guard_rows(o_part), site=site,
                                     nsites=nsites, overlap=ov,
                                     algorithm=algorithm)
            site += 1
            x = x + attn.to(x.dtype)
            ff = _ffn_local(cfg, blk, _norm(cfg, x, blk["ln2"]))
            ff = _decode_allreduce(comm, guard_rows(ff), site=site,
                                   nsites=nsites, overlap=ov,
                                   algorithm=algorithm)
            site += 1
            x = x + ff.to(x.dtype)
        x = _norm(cfg, x, shards["ln_f"])
        return x @ shards["unembed"], cache
