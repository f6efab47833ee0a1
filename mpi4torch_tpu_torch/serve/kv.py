"""Tensor-parallel KV-cache prefill and decode: the serving compute core.

Port of ``mpi4torch_tpu/serve/kv.py``: the dense slot-table cache, the
paged pool, and :func:`admit_zero3`, the handoff of ZeRO-3 training
shards into serving shards.  Heads are sharded over the communicator by the ``parallel/tp.py``
conventions (each rank owns ``n_heads / size`` query heads and
``kv_heads / size`` KV heads end to end), so per-head attention never
crosses ranks and each layer costs two collectives: the row-parallel
output projection's Allreduce and the row-parallel FFN Allreduce.

:func:`decode_step_tp` takes one position per slot: every slot of the
continuous batch sits at its own sequence position, written through a
:func:`~mpi4torch_tpu_torch.ops.ragged.position_onehot` mask and masked
per row in attention.  :func:`decode_step_paged` is the same step over a
page pool (:func:`init_kv_pool_tp`) addressed through a per-slot block
table, and :func:`prefill_chunk_tp` prefills one prompt chunk against
the prefix rows already computed (prefix sharing, chunked prefill).  The
KV cache and the pool are updated in place (see ``models/transformer.py``
and :func:`~mpi4torch_tpu_torch.ops.ragged.block_scatter`).  Inference
only: nothing here is differentiated.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import config as _config
from ..constants import MPI_SUM
from ..models.transformer import (TransformerConfig, _ffn_local, _norm,
                                  _rope_rotate)
from ..ops.flash import flash_attention, flash_block_attention
from ..ops.ragged import (block_gather, live_cells, position_onehot,
                          write_cells)
from ..overlap import overlap_split_allreduce, resolve_overlap
from ..parallel.tp import shard_axis, shard_heads
from ..runtime import CommError, resolve_device
from ..utils.profiling import bucket_scope, serve_step_scope

__all__ = [
    "validate_tp",
    "shard_params_tp",
    "init_kv_cache_tp",
    "init_kv_pool_tp",
    "prefill_tp",
    "prefill_chunk_tp",
    "decode_step_tp",
    "decode_step_paged",
    "admit_zero3",
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


def admit_zero3(cfg: TransformerConfig, comm, p_shards, template, *,
                dtype=None, strategy=None):
    """Admit ZeRO-3 training shards as serving TP shards: the
    train -> serve handoff on the planned ``comm.Reshard`` path
    (:func:`~mpi4torch_tpu_torch.parallel.zero.zero3_to_tp`), never
    gathering every parameter on every rank.

    Per leaf: ``wo`` and ``w2`` take the row-shard Layout and a gelu
    ``w1`` the column-shard Layout, each one planned exchange of
    ``O(shard)`` peak; ``wqkv`` (its q/k/v head blocks interleave per
    rank, which no axis-contiguous layout expresses) and swiglu's fused
    ``w1`` take the replicated Layout and are sliced locally by the same
    helpers :func:`shard_params_tp` cuts with; embeddings, norms,
    positions and the unembedding replicate.  ``dtype`` is the serving
    precision (bf16 shards of f32 training state), applied after the
    exchange.  ``template`` is the full-shape parameter tree (meta
    tensors will do).

    Returns the :func:`shard_params_tp` layout, bitwise equal to
    ``shard_params_tp(cfg, zero3_params(...), comm)`` (cast to
    ``dtype``): the redistribution moves bits and never rounds them."""
    import re

    from .. import reshard as _rs
    from ..parallel.zero import zero3_to_tp
    from ..utils.tree import tree_map

    size = comm.size
    validate_tp(cfg, size)
    row = _rs.Layout((size,), ((0,), ()))
    col = _rs.Layout((size,), ((), (0,)))
    rules = [(r"blocks/\d+/wo$", row), (r"blocks/\d+/w2$", row)]
    if cfg.ffn != "swiglu":
        rules.append((r"blocks/\d+/w1$", col))

    def lay_for(path, leaf):
        shape = tuple(leaf.shape)
        for pat, lay in rules:
            if re.search(pat, path) and len(shape) == lay.ndim:
                return lay
        return _rs.Layout((size,), ((),) * len(shape))

    specs = tree_map(lay_for, _rs.tree_paths(template), template)
    tp_tree = zero3_to_tp(comm, p_shards, template, specs,
                          strategy=strategy, dtype=dtype)
    out_blocks = []
    for blk in tp_tree["blocks"]:
        nb = dict(blk)
        nb["wqkv"] = _shard_wqkv(cfg, comm, blk["wqkv"])
        if cfg.ffn == "swiglu":
            nb["w1"] = _shard_swiglu_w1(cfg, comm, blk["w1"])
        out_blocks.append(nb)
    out = {k: v for k, v in tp_tree.items() if k != "blocks"}
    out["blocks"] = out_blocks
    return out


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


def init_kv_pool_tp(cfg: TransformerConfig, num_blocks: int,
                    block_size: int, size: int, dtype=torch.float32,
                    device=None):
    """Per-layer TP-sharded paged KV pool, ``(num_blocks, block_size,
    kv_heads / size, head_dim)`` per rank, zero-filled: the paged
    counterpart of :func:`init_kv_cache_tp`, addressed through a per-slot
    block table.  One block-id space serves every layer.
    ``block_size`` must divide ``cfg.max_seq``: the decode step gathers
    each slot's pages back into the full ``max_seq`` extent, so paged
    attention sees the dense buffer's shape.  No poison fill: a free page
    is one no table entry points at, and
    :func:`~mpi4torch_tpu_torch.ops.ragged.block_gather` zeroes unmapped
    entries.  ``device`` is resolved by ``runtime.resolve_device``."""
    if block_size < 1 or cfg.max_seq % block_size != 0:
        raise CommError(
            f"serve: block_size={block_size} must be >= 1 and divide "
            f"max_seq={cfg.max_seq} (the paged gather reconstructs the "
            "dense attention extent)")
    hd = cfg.d_model // cfg.n_heads
    shape = (num_blocks, block_size, cfg.kv_heads // size, hd)
    dev = resolve_device(device)

    def buf():
        return torch.zeros(shape, dtype=dtype, device=dev)

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
        k = _config.serve_decode_buckets()
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


def prefill_chunk_tp(cfg: TransformerConfig, shards, past, chunk,
                     comm=None):
    """TP prefill of one prompt chunk against prefix K/V already computed:
    the suffix/chunked half of paged admission.  ``chunk`` is ``(1,
    c_len)`` tokens at global positions ``p_len .. p_len + c_len - 1``,
    where ``p_len`` is read off ``past``, a per-layer ``[{"k", "v"}]``
    list of exact-length ``(1, p_len, ...)`` prefix rows (``p_len = 0``
    makes this a prefill from scratch).  Returns ``(last_logits,
    chunk_rows)``, ``chunk_rows`` the chunk's own K/V in ``past``'s
    dtype, ready to install into the page pool.

    Attention is ``flash_block_attention(q, [past ++ chunk],
    q_offset=p_len, kv_offset=0, causal=True)`` with ``impl`` left at
    auto: on the card the attention kernel (the same kernel as the
    one-shot prefill of :func:`prefill_tp`, now at ``sq < sk``), on the
    CPU the plain version.  Prompt rows depend only on the tokens at or
    before them, so a chunk's rows are what the one-shot prefill computes
    for those positions (to the GEMMs' rounding at another row count),
    which is what prefix sharing rides on.  The JAX package pins
    ``impl="jnp"`` here because its one-shot prefill takes the jnp path
    on its CPU; the port's one-shot prefill takes the kernel on the
    card, and so does its chunk.  One blocking Allreduce per
    row-parallel half."""
    b, c_len = chunk.shape
    p_len = int(past[0]["k"].shape[1])
    size = _tp_size(cfg, shards)
    x = shards["embed"][chunk]
    if not cfg.rope:
        x = x + shards["pos"][None, p_len:p_len + c_len]
    positions = torch.arange(p_len, p_len + c_len, dtype=torch.int32,
                             device=x.device)
    rows = []
    with serve_step_scope("prefill"):
        for blk, p in zip(shards["blocks"], past):
            y = _norm(cfg, x, blk["ln1"])
            q, k, v = _split_qkv_local(cfg, blk, y, positions, size)
            rows.append({"k": k.to(p["k"].dtype), "v": v.to(p["v"].dtype)})
            kf = torch.cat([p["k"].to(k.dtype), k], dim=1)
            vf = torch.cat([p["v"].to(v.dtype), v], dim=1)
            o, _ = flash_block_attention(
                q, kf, vf, causal=True, q_offset=p_len, kv_offset=0,
                window=cfg.attn_window)
            o_part = o.reshape(b, c_len, -1) @ blk["wo"]
            if comm is not None:
                o_part = comm.Allreduce(o_part, MPI_SUM, compression=False)
            x = x + o_part.to(x.dtype)
            ff = _ffn_local(cfg, blk, _norm(cfg, x, blk["ln2"]))
            if comm is not None:
                ff = comm.Allreduce(ff, MPI_SUM, compression=False)
            x = x + ff.to(x.dtype)
        x = _norm(cfg, x, shards["ln_f"])
        return x[:, -1] @ shards["unembed"], rows


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


def decode_step_paged(cfg: TransformerConfig, shards, pool, table, tokens,
                      pos, comm=None, *, overlap=None,
                      algorithm: Optional[str] = None, active=None):
    """One continuous-batching decode step over a paged slot table:
    :func:`decode_step_tp`'s math with the dense per-slot cache replaced
    by ``pool`` (per-layer ``(num_blocks, block_size, kv_heads/size,
    head_dim)`` pages, :func:`init_kv_pool_tp`) and a ``(slots,
    max_seq/block_size)`` block ``table`` (``-1`` = unmapped).  Returns
    ``(logits, pool)``; the pool is written in place.

    Per layer the new K/V row lands by
    :func:`~mpi4torch_tpu_torch.ops.ragged.block_scatter` in the slot's
    current page (``table[s, pos[s] // bs]`` at offset ``pos[s] % bs``),
    then :func:`~mpi4torch_tpu_torch.ops.ragged.block_gather` rebuilds
    each slot's full ``max_seq`` extent (unmapped pages as zeros behind
    the per-row causal frontier) and attention proceeds as in the dense
    step, on the plain version (per-row offsets).  The caller's block
    manager keeps live slots' write cells in distinct private pages (the
    copy-on-write rule).  Free slots carry ``-1`` pages and
    ``active=False``: no write, zero rows, payload rows zeroed before the
    wire.

    ``table``, ``pos`` and ``active`` may be host arrays (numpy or CPU
    tensors; the engine passes its own) or device tensors, which are read
    back once: the write cells are picked on the host, once per step,
    before any of the step's work is queued."""
    dev = pool[0]["k"].device
    bs = pool[0]["k"].shape[1]
    table_h = torch.as_tensor(table).to("cpu", torch.int64)
    pos_h = torch.as_tensor(pos).to("cpu", torch.int64)
    live_h = None if active is None else \
        torch.as_tensor(active).to("cpu", torch.bool)
    # The slot's current write page and in-page offset; a free slot's
    # all -1 table row yields -1, which the scatter drops.
    n_blk = table_h.shape[1]
    wb = table_h.gather(1, (pos_h // bs).clamp(0, n_blk - 1)[:, None])[:, 0]
    cells = live_cells(wb, pos_h % bs, pool[0]["k"], live_h)
    table_d = table_h.to(dev)
    pos_d = pos_h.to(dev, torch.int32)
    tokens = torch.as_tensor(tokens, device=dev)
    slots = tokens.shape[0]
    size = _tp_size(cfg, shards)
    ov = resolve_overlap(overlap)
    nsites = 2 * len(shards["blocks"])
    live = None if live_h is None else live_h.to(dev)[:, None]

    def guard_rows(payload):
        if live is None:
            return payload
        return torch.where(live, payload, torch.zeros((), dtype=payload.dtype,
                                                      device=payload.device))

    with serve_step_scope("decode_step"):
        x = shards["embed"][tokens]
        if not cfg.rope:
            x = x + shards["pos"][pos_d]
        site = 0
        for blk, c in zip(shards["blocks"], pool):
            y = _norm(cfg, x, blk["ln1"])
            q, k_new, v_new = _split_qkv_local(cfg, blk, y[:, None, :],
                                               pos_d[:, None], size)
            write_cells(c["k"], cells, k_new[:, 0])
            write_cells(c["v"], cells, v_new[:, 0])
            o, _ = flash_block_attention(
                q, block_gather(c["k"], table_d),
                block_gather(c["v"], table_d), causal=True,
                q_offset=pos_d, kv_offset=0, window=cfg.attn_window,
                impl="torch")
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
        return x @ shards["unembed"], pool
