"""Flagship model: decoder-only transformer, inference path.

Port of ``mpi4torch_tpu/models/transformer.py`` as far as serving needs
it: the configuration, parameter initialisation, the JAX-to-torch weight
conversion, prefill, incremental decode and greedy generation.  The
parameters are a plain dictionary in the JAX package's layout —
``(in, out)`` matrices used as ``x @ W``, the fused ``wqkv`` q|k|v
head-block projection, swiglu's fused gate|up ``w1`` — so one parameter
tree means the same model in both packages, and the tensor-parallel
slicing rules of ``serve/kv.py`` carry over unchanged.

Unlike the JAX package, the KV-cache functions update the cache tensors
in place (JAX arrays are immutable; here a copy of the whole cache per
token would double decode memory traffic).  They still return the cache,
so the call shapes match.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash import flash_attention, flash_block_attention
from ..runtime import resolve_device


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
            "Queue 1 item 5)")
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
            "Queue 1 item 5)")
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
    discipline (ROADMAP.md, Queue 1 item 7)."""
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
