"""Flagship model: decoder-only transformer, inference and training.

Port of ``mpi4torch_tpu/models/transformer.py`` for serving and for
data-parallel training: the configuration, parameter initialisation, the
JAX-to-torch weight conversion (both ways), prefill, incremental decode,
greedy generation, the training forward, the chunked-vocabulary loss and
the SGD train step.  The parameters are a plain dictionary in the JAX
package's layout — ``(in, out)`` matrices used as ``x @ W``, the fused
``wqkv`` q|k|v head-block projection, swiglu's fused gate|up ``w1`` — so
one parameter tree means the same model in both packages, and the
tensor-parallel slicing rules of ``serve/kv.py`` carry over unchanged.

Unlike the JAX package, the KV-cache functions update the cache tensors
in place (JAX arrays are immutable; here a copy of the whole cache per
token would double decode memory traffic).  They still return the cache,
so the call shapes match.

Training runs attention on one device (``comm_sp`` of size 1): the
sequence-parallel strategies and the expert-parallel MoE FFN raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
Besides the SGD ``train_step`` there are the ZeRO-1 and ZeRO-3 steps
(``zero_train_step``, ``zero3_train_step``) over the port's functional
optimizers (``utils/optim.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..constants import MPI_SUM
from ..ops.flash import flash_attention, flash_block_attention
from ..parallel.dp import all_average_tree
from ..runtime import resolve_device
from ..utils.tree import tree_map, value_and_grad


@dataclass(frozen=True)
class TransformerConfig:
    """Static model hyperparameters, validated as in the JAX package.
    ``n_experts > 0`` (the expert-parallel MoE FFN) is accepted here and
    refused by the forward functions: the MoE path is not ported yet."""
    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    max_seq: int
    n_kv_heads: int = 0
    attn_window: int = 0
    rope: bool = False
    rope_theta: float = 10000.0
    norm: str = "layernorm"
    ffn: str = "gelu"
    n_experts: int = 0
    capacity: int = 0
    aux_coef: float = 0.01
    remat: bool = False

    def __post_init__(self):
        if self.n_experts > 0 and self.capacity <= 0:
            raise ValueError(
                f"n_experts={self.n_experts} requires capacity > 0, got "
                f"{self.capacity}")
        if self.n_kv_heads:
            if self.n_kv_heads < 0 or self.n_heads % self.n_kv_heads != 0:
                raise ValueError(
                    f"n_heads={self.n_heads} must be a positive multiple "
                    f"of n_kv_heads={self.n_kv_heads}")
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0 (0 = full causal attention), "
                f"got {self.attn_window}")
        if self.rope and (self.d_model // self.n_heads) % 2 != 0:
            raise ValueError(
                f"rope requires an even head_dim, got "
                f"{self.d_model // self.n_heads}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.ffn not in ("gelu", "swiglu"):
            raise ValueError(f"unknown ffn {self.ffn!r}")
        if self.ffn == "swiglu" and self.n_experts > 0:
            raise ValueError(
                "ffn='swiglu' applies to the dense FFN; the MoE experts "
                "(n_experts > 0) keep their own gelu expert MLPs")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


def init_transformer(generator, cfg: TransformerConfig,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Dict[str, Any]:
    """Parameter dictionary for a pre-LN decoder-only transformer, with the
    JAX package's shapes and scalings (normal embeddings and positions at
    0.02, matrices normal over ``sqrt(fan_in)``).  ``generator`` is a
    ``torch.Generator`` on ``device`` or an integer seed.  Draws happen
    in the JAX package's key order (embed, pos — drawn even under rope,
    so the stream does not shift — unembed, then per layer wqkv, wo, w1,
    w2); the numbers differ from JAX's, since the generators do."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    d_model, d_ff = cfg.d_model, cfg.d_ff

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev)

    def dense(m, n):
        return normal(m, n) / math.sqrt(m)

    def norm_p():
        p = {"scale": torch.ones(d_model, dtype=dtype, device=dev)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros(d_model, dtype=dtype, device=dev)
        return p

    if cfg.n_experts > 0:
        raise NotImplementedError(
            "n_experts > 0: the MoE FFN is not ported yet (ROADMAP.md, "
            "Queue 1 item 3)")
    params: Dict[str, Any] = {"embed": normal(cfg.vocab, d_model) * 0.02}
    pos = normal(cfg.max_seq, d_model) * 0.02
    if not cfg.rope:
        params["pos"] = pos
    params["ln_f"] = norm_p()
    params["unembed"] = dense(d_model, cfg.vocab)
    hd = d_model // cfg.n_heads
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {"ln1": norm_p(),
               "wqkv": dense(d_model, d_model + 2 * cfg.kv_heads * hd),
               "wo": dense(d_model, d_model),
               "ln2": norm_p()}
        if cfg.ffn == "swiglu":
            blk["w1"] = dense(d_model, 2 * d_ff)   # gate | up, fused
        else:
            blk["w1"] = dense(d_model, d_ff)
        blk["w2"] = dense(d_ff, d_model)
        blocks.append(blk)
    params["blocks"] = blocks
    return params


def params_from_jax(tree, device, dtype=None):
    """The port's parameters from a JAX parameter tree whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, params)``): the same nested
    dictionaries and lists, each leaf a tensor on ``device`` (cast to
    ``dtype`` when given).  The layout is kept as it is."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_jax`: the same nested layout with
    each leaf a numpy array on the host (bfloat16, which numpy lacks,
    widens to float32)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(leaf, tree)


def _layer_norm(x, p):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]


def _rms_norm(x, p):
    ms = (x * x).mean(dim=-1, keepdim=True)
    return x / torch.sqrt(ms + 1e-5) * p["scale"]


def _norm(cfg: TransformerConfig, x, p):
    return _rms_norm(x, p) if cfg.norm == "rmsnorm" else _layer_norm(x, p)


def _rope_rotate(cfg: TransformerConfig, x, positions):
    """Rotary position embedding (half-split convention).  ``positions``
    is ``(s,)``, or ``(b, s)`` for per-row positions (continuous-batching
    decode)."""
    hd = x.shape[-1]
    half = hd // 2
    ct = torch.promote_types(x.dtype, torch.float32)
    inv = cfg.rope_theta ** (
        -torch.arange(half, dtype=ct, device=x.device) * 2.0 / hd)
    positions = torch.as_tensor(positions, device=x.device)
    if positions.dim() == 1:
        ang = positions.to(ct)[:, None] * inv[None, :]
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
    else:
        ang = positions.to(ct)[..., None] * inv
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].to(ct), x[..., half:].to(ct)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _split_qkv(cfg: TransformerConfig, blk, y, positions=None):
    """Project ``y`` (b, s, d) through the fused qkv matrix into ``q``
    (b, s, h, hd) and ``k``/``v`` (b, s, kv_heads, hd)."""
    b, s = y.shape[0], y.shape[1]
    h, h_kv = cfg.n_heads, cfg.kv_heads
    hd = cfg.d_model // h
    qkv = y @ blk["wqkv"]
    q = qkv[..., :h * hd].reshape(b, s, h, hd)
    k = qkv[..., h * hd:(h + h_kv) * hd].reshape(b, s, h_kv, hd)
    v = qkv[..., (h + h_kv) * hd:].reshape(b, s, h_kv, hd)
    if cfg.rope:
        if positions is None:
            raise ValueError("cfg.rope requires the caller's positions")
        q = _rope_rotate(cfg, q, positions)
        k = _rope_rotate(cfg, k, positions)
    return q, k, v


def _ffn_local(cfg: TransformerConfig, blk, y):
    """The dense FFN product of normalised ``y`` (gelu is the tanh form,
    as ``jax.nn.gelu``'s default)."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "n_experts > 0: the MoE FFN is not ported yet (ROADMAP.md, "
            "Queue 1 item 3)")
    if cfg.ffn == "swiglu":
        gate, up = (y @ blk["w1"]).chunk(2, dim=-1)
        return (F.silu(gate) * up) @ blk["w2"]
    return F.gelu(y @ blk["w1"], approximate="tanh") @ blk["w2"]


def _ffn_residual(cfg: TransformerConfig, blk, x):
    """Post-attention dense FFN with pre-LN and residual."""
    return x + _ffn_local(cfg, blk, _norm(cfg, x, blk["ln2"]))


def init_kv_cache(cfg: TransformerConfig, batch: int, dtype, device):
    """Per-layer K/V cache ``(batch, max_seq, kv_heads, head_dim)``."""
    hd = cfg.d_model // cfg.n_heads
    shape = (batch, cfg.max_seq, cfg.kv_heads, hd)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _window_bucket(cfg: TransformerConfig) -> int:
    """Length of the cache slice decode attends: the smallest power of
    two >= the sliding window (capped at max_seq), or the whole buffer
    without a window."""
    if not cfg.attn_window:
        return cfg.max_seq
    bucket = 1
    while bucket < cfg.attn_window:
        bucket *= 2
    return min(bucket, cfg.max_seq)


def decode_step(cfg: TransformerConfig, params, cache, tokens, pos: int):
    """One incremental decode step: logits ``(batch, vocab)`` for
    ``tokens`` ``(batch,)`` at position ``pos``, writing the new K/V row
    into ``cache`` in place.  Returns ``(logits, cache)``.  With a
    sliding window, attention runs on a position-tracking slice of the
    cache (a power-of-two bucket >= the window) instead of the whole
    ``max_seq`` buffer; the window mask does the rest."""
    pos = int(pos)
    if not 0 <= pos < cfg.max_seq:
        raise ValueError(
            f"decode position {pos} out of range: cfg.max_seq is "
            f"{cfg.max_seq}")
    b = tokens.shape[0]
    x = params["embed"][tokens]
    if not cfg.rope:
        x = x + params["pos"][pos]
    win = cfg.attn_window
    bucket = _window_bucket(cfg)
    positions = torch.tensor([pos], dtype=torch.int32, device=x.device)
    for blk, c in zip(params["blocks"], cache):
        y = _norm(cfg, x, blk["ln1"])
        q, k_new, v_new = _split_qkv(cfg, blk, y[:, None, :], positions)
        # The cache dtype is authoritative (a serving cache may be
        # narrower than the parameters).
        c["k"][:, pos] = k_new[:, 0].to(c["k"].dtype)
        c["v"][:, pos] = v_new[:, 0].to(c["v"].dtype)
        if bucket < cfg.max_seq:
            # Earliest slice start that still covers [pos-win+1, pos].
            start = min(max(pos - bucket + 1, 0), cfg.max_seq - bucket)
            kk = c["k"][:, start:start + bucket]
            vv = c["v"][:, start:start + bucket]
        else:
            start, kk, vv = 0, c["k"], c["v"]
        o, _ = flash_block_attention(q, kk, vv, causal=True, q_offset=pos,
                                     kv_offset=start, window=win,
                                     impl="torch")
        x = x + o.reshape(b, cfg.d_model).to(x.dtype) @ blk["wo"]
        x = _ffn_residual(cfg, blk, x)
    x = _norm(cfg, x, params["ln_f"])
    return x @ params["unembed"], cache


def prefill(cfg: TransformerConfig, params, cache, prompt):
    """Fill the KV cache from a whole prompt ``(batch, p_len)`` in one
    batched pass and return ``(last_logits (batch, vocab), cache)``.
    Attention runs through :func:`flash_attention` (the CUDA kernel on a
    CUDA device)."""
    b, p_len = prompt.shape
    x = params["embed"][prompt]
    if not cfg.rope:
        x = x + params["pos"][None, :p_len]
    positions = torch.arange(p_len, dtype=torch.int32, device=x.device)
    for blk, c in zip(params["blocks"], cache):
        y = _norm(cfg, x, blk["ln1"])
        q, k, v = _split_qkv(cfg, blk, y, positions)
        c["k"][:, :p_len] = k.to(c["k"].dtype)
        c["v"][:, :p_len] = v.to(c["v"].dtype)
        o = flash_attention(q, k, v, causal=True, window=cfg.attn_window)
        x = x + o.reshape(b, p_len, cfg.d_model) @ blk["wo"]
        x = _ffn_residual(cfg, blk, x)
    x = _norm(cfg, x, params["ln_f"])
    return x[:, -1] @ params["unembed"], cache


def select_token(logits):
    """The decoding choice for each row of ``(batch, vocab)`` logits: the
    greedy argmax (the first maximal index, like ``jnp.argmax``).
    :func:`generate` and the serving engine both choose through it.
    Sampled decoding needs a port of the JAX package's threefry key
    discipline (ROADMAP.md, Queue 1 item 2)."""
    return torch.argmax(logits, dim=-1)


def generate(cfg: TransformerConfig, params, prompt, n_new: int,
             dtype=None):
    """Autoregressive greedy decoding: prefill the cache from ``prompt``
    ``(batch, prompt_len)`` in one batched pass, then emit ``n_new``
    tokens one decode step at a time.  The cache dtype follows the
    parameters unless ``dtype`` overrides it.  Returns ``(batch,
    prompt_len + n_new)`` tokens."""
    b, p_len = prompt.shape
    if p_len + n_new > cfg.max_seq:
        raise ValueError(
            f"prompt {p_len} + n_new {n_new} exceeds max_seq "
            f"{cfg.max_seq}")
    if n_new == 0:
        return prompt
    dtype = dtype or params["embed"].dtype
    cache = init_kv_cache(cfg, b, dtype, prompt.device)
    logits, cache = prefill(cfg, params, cache, prompt)
    tok = select_token(logits).to(prompt.dtype)
    out = [tok]
    # Each step feeds the token at position i and emits position i+1's
    # choice; the last emitted token needs no decode step of its own.
    for i in range(p_len, p_len + n_new - 1):
        logits, cache = decode_step(cfg, params, cache, tok, i)
        tok = select_token(logits).to(prompt.dtype)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


# --------------------------------------------------------------- training

_ATTNS = ("dense", "ring", "ulysses", "zigzag")


def _check_parallel(comm_sp, attn: str, comm_ep=None) -> None:
    """The training functions run attention on one device: a size>1
    sequence-parallel or expert-parallel communicator raises."""
    if attn not in _ATTNS:
        raise ValueError(f"unknown attention strategy {attn!r}")
    if comm_sp is not None and comm_sp.size > 1:
        raise NotImplementedError(
            f"comm_sp of size {comm_sp.size} (attn={attn!r}): "
            "sequence-parallel attention (ring, ulysses, zigzag) is not "
            "ported yet (ROADMAP.md, Queue 1 item 3); pass comm_sp=None "
            "with the full sequence")
    if comm_ep is not None and comm_ep.size > 1:
        raise NotImplementedError(
            f"comm_ep of size {comm_ep.size}: the expert-parallel MoE FFN "
            "is not ported yet (ROADMAP.md, Queue 1 item 3)")


def forward(cfg: TransformerConfig, params, tokens, comm_sp=None,
            attn: str = "ring", comm_ep=None, return_hidden: bool = False):
    """Logits ``(batch, seq, vocab)`` for ``(batch, seq)`` token ids, the
    training forward.  Attention is causal single-device flash attention
    (the CUDA kernels on a CUDA device), whatever ``attn`` names, as in
    the JAX package when ``comm_sp`` is None or of size 1.
    ``return_hidden`` returns the post-``ln_f`` hidden states ``(batch,
    seq, d_model)`` instead of logits (what :func:`lm_loss`'s chunked
    vocabulary consumes).  With ``cfg.remat`` each
    block is recomputed in the backward (``torch.utils.checkpoint``, the
    counterpart of ``jax.checkpoint``)."""
    _check_parallel(comm_sp, attn, comm_ep)
    b, s = tokens.shape
    if not cfg.rope and s > cfg.max_seq:
        raise ValueError(f"sequence {s} exceeds cfg.max_seq {cfg.max_seq}")
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = F.embedding(tokens, params["embed"])
    if not cfg.rope:
        x = x + params["pos"][None, :s]
    d = x.shape[-1]

    def block_fn(x, blk):
        y = _norm(cfg, x, blk["ln1"])
        q, k, v = _split_qkv(cfg, blk, y, positions)
        o = flash_attention(q, k, v, causal=True, window=cfg.attn_window)
        x = x + o.reshape(b, s, d) @ blk["wo"]
        return _ffn_residual(cfg, blk, x)

    for blk in params["blocks"]:
        if cfg.remat:
            x = checkpoint(block_fn, x, blk, use_reentrant=False)
        else:
            x = block_fn(x, blk)
    x = _norm(cfg, x, params["ln_f"])
    return x if return_hidden else x @ params["unembed"]


def _ce_chunk(x, w, labels, m, se, zt, lo: int):
    """One vocabulary chunk of :func:`_chunked_ce`: fold the ``(b, s,
    chunk)`` logits slab ``x @ w`` into the running logsumexp ``(m, se)``
    and pick the label logit ``zt`` if it falls in the chunk."""
    chunk = w.shape[1]
    z = (x @ w).to(m.dtype)
    m_new = torch.maximum(m, z.amax(dim=-1))
    se = se * torch.exp(m - m_new) + \
        torch.exp(z - m_new[..., None]).sum(dim=-1)
    in_chunk = (labels >= lo) & (labels < lo + chunk)
    idx = (labels - lo).clamp(0, chunk - 1)
    zsel = z.gather(-1, idx[..., None])[..., 0]
    return m_new, se, torch.where(in_chunk, zsel, zt)


def _chunked_ce(x, unembed, labels, vocab_chunk: int):
    """Per-token cross entropy ``logsumexp(z) - z[label]`` over vocabulary
    chunks: the full ``(batch, seq, vocab)`` logits never exist.  The
    online logsumexp runs in at least f32, and each chunk is recomputed in
    the backward (``torch.utils.checkpoint``), so only one ``(batch, seq,
    chunk)`` slab is alive at a time either way — the port of the JAX
    package's checkpointed ``lax.scan``."""
    n_chunks = unembed.shape[1] // vocab_chunk
    ct = torch.promote_types(x.dtype, torch.float32)
    m = torch.full(labels.shape, -1e30, dtype=ct, device=x.device)
    se = torch.zeros(labels.shape, dtype=ct, device=x.device)
    zt = torch.zeros(labels.shape, dtype=ct, device=x.device)
    for c in range(n_chunks):
        lo = c * vocab_chunk
        m, se, zt = checkpoint(_ce_chunk, x,
                               unembed[:, lo:lo + vocab_chunk], labels, m,
                               se, zt, lo, use_reentrant=False)
    return m + torch.log(se) - zt


def lm_loss(cfg: TransformerConfig, params, tokens, comm_sp=None,
            attn: str = "ring", seq_global=None, comm_ep=None,
            vocab_chunk: int = 0):
    """Mean next-token cross-entropy over the sequence.  The last position
    has no successor and is masked out; the sum is normalised by
    ``batch * (seq_global - 1)``.  ``vocab_chunk`` (a divisor of the
    vocabulary, smaller than it) computes the loss through
    :func:`_chunked_ce` without materialising the logits."""
    _check_parallel(comm_sp, attn, comm_ep)
    b, s = tokens.shape
    s_global = seq_global or s
    if vocab_chunk and (vocab_chunk <= 0
                        or cfg.vocab % vocab_chunk != 0):
        raise ValueError(
            f"vocab_chunk={vocab_chunk} must divide vocab={cfg.vocab}")
    want_hidden = bool(vocab_chunk) and vocab_chunk < cfg.vocab
    out = forward(cfg, params, tokens, return_hidden=want_hidden)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    global_pos = torch.arange(s, device=tokens.device)
    mask = (global_pos < s_global - 1).to(out.dtype)
    if want_hidden:
        ce = _chunked_ce(out, params["unembed"], labels, vocab_chunk)
    else:
        logp = F.log_softmax(out, dim=-1)
        ce = -logp.gather(-1, labels[..., None])[..., 0]
    return torch.sum(ce * mask[None, :]) / (b * (s_global - 1))


def train_step(cfg: TransformerConfig, params, tokens, comm_sp=None,
               comm_dp=None, attn: str = "ring", lr: float = 1e-2,
               comm_ep=None):
    """One SGD step; returns ``(loss, new_params)``.

    Data parallelism follows the reference recipe exactly: the
    parameters are averaged over ``comm_dp`` (an Allreduce whose adjoint
    makes each rank's gradient the rank mean) and the loss is Allreduced
    over ``comm_dp``, so replicas stay in lock-step.  The gradient comes
    from :func:`torch.autograd.grad`; the update is ``p - lr * g``."""
    _check_parallel(comm_sp, attn, comm_ep)
    dp = comm_dp is not None and comm_dp.size > 1

    def global_loss(p):
        if dp:
            p = all_average_tree(comm_dp, p)
        loss = lm_loss(cfg, p, tokens, comm_sp, attn, comm_ep=comm_ep)
        if dp:
            loss = comm_dp.Allreduce(loss, MPI_SUM,
                                     compression=False) / comm_dp.size
        return loss

    loss, grads = value_and_grad(global_loss, params)
    with torch.no_grad():
        new_params = tree_map(lambda p, g: p - lr * g, params, grads)
    return loss, new_params


def zero_train_step(cfg: TransformerConfig, params, tokens, opt,
                    opt_state, comm_dp, comm_sp=None, attn: str = "ring",
                    comm_ep=None):
    """One optimizer step with ZeRO-1 sharded state over ``comm_dp``;
    returns ``(loss, new_params, new_opt_state)``.

    The data-parallel reduction moves out of the loss and into
    :func:`~mpi4torch_tpu_torch.parallel.zero.zero_step`'s
    reduce-scatter: each rank differentiates its local mean loss (no
    parameter averaging, no loss Allreduce — the un-reduced gradients
    are what the reduce-scatter sums), the element-wise ``opt`` update
    (``utils/optim.py``) runs on this rank's ``1/dp`` parameter shard,
    and the allgather re-replicates.  The parameters match replicated-DP
    training with the same optimizer bit for bit; the optimizer state is
    ``1/dp`` of the replicated state.  The returned loss is the dp mean."""
    from ..parallel.zero import zero_step

    _check_parallel(comm_sp, attn, comm_ep)
    loss, grads = value_and_grad(
        lambda p: lm_loss(cfg, p, tokens, comm_sp, attn, comm_ep=comm_ep),
        params)
    # zero_step's reduce-scatter / size turns the un-reduced local
    # gradients into the dp-mean gradient shard.
    new_params, new_state = zero_step(comm_dp, opt, params, grads,
                                      opt_state)
    loss = comm_dp.Allreduce(loss, MPI_SUM, compression=False) / comm_dp.size
    return loss, new_params, new_state


def zero3_train_step(cfg: TransformerConfig, p_shards, template, tokens,
                     opt, opt_state, comm_dp, comm_sp=None,
                     attn: str = "ring"):
    """One optimizer step with ZeRO-3 over ``comm_dp``: the parameters
    live as ``1/dp`` flat shards between steps (parameters and optimizer
    state both ``/ dp``); returns ``(loss, new_p_shards,
    new_opt_state)``.  The forward gathers the shards on use
    (:func:`~mpi4torch_tpu_torch.parallel.zero.zero3_params`); the
    backward reduce-scatters the gradients through the Allgather's
    adjoint.  Obtain ``(p_shards, opt_state)`` from
    :func:`~mpi4torch_tpu_torch.parallel.zero.zero3_init`.  The
    parameters match replicated-DP training with the same optimizer bit
    for bit."""
    from ..parallel.zero import zero3_step

    _check_parallel(comm_sp, attn)
    loss, new_shards, new_state = zero3_step(
        comm_dp, opt, p_shards, template,
        lambda p: lm_loss(cfg, p, tokens, comm_sp, attn), opt_state)
    loss = comm_dp.Allreduce(loss, MPI_SUM, compression=False) / comm_dp.size
    return loss, new_shards, new_state
