"""Flagship model: decoder-only transformer, inference and training.

Port of ``mpi4torch_tpu/models/transformer.py`` for serving and for
data-parallel training: the configuration, parameter initialisation, the
JAX-to-torch weight conversion (both ways), prefill, incremental decode,
the decoding rule (greedy, or sampled under the JAX package's threefry
key discipline) and generation, the training forward, the
chunked-vocabulary loss and the SGD train step.  The parameters are a
plain dictionary in the JAX package's layout — ``(in, out)`` matrices used as ``x @ W``, the fused
``wqkv`` q|k|v head-block projection, swiglu's fused gate|up ``w1`` — so
one parameter tree means the same model in both packages, and the
tensor-parallel slicing rules of ``serve/kv.py`` carry over unchanged.

Unlike the JAX package, the KV-cache functions update the cache tensors
in place (JAX arrays are immutable; here a copy of the whole cache per
token would double decode memory traffic).  They still return the cache,
so the call shapes match.

Training shards the sequence over ``comm_sp`` (``attn="ring"``,
``"zigzag"`` or ``"ulysses"``, ``parallel/attention.py``: the K2 forward
and K3/K4 backward per block on a CUDA device) and, with ``n_experts >
0``, runs every block's FFN as the expert-parallel MoE over ``comm_ep``
(``parallel/moe.py``); ``comm_dp`` averages data-parallel replicas.
Each of the three axes is its own communicator.  Under ``run_ranks`` one
of them spans the world at a time; under ``run_spmd(mesh=)`` they are the
axes of one mesh at once (``comm_from_mesh(mesh, "dp")``, ``"sp"``,
``"ep"``), each rank taking its token slice by the axes' symbolic ranks,
and every mesh position ends a step with the same loss and parameters.
Decoding an MoE configuration runs the dense-expert form
(``moe_ffn_dense``).

Two MoE forms.  ``moe="capacity"`` is the JAX package's top-1 gelu MoE,
kept for its parity tests: every rank holds every expert's leaves,
``moe_ffn`` slices them, and ``train_step`` averages them over
``comm_ep`` like any replicated leaf.  ``moe="dropless"`` is the form of
today's large open MoE models (Mellum2, Qwen-MoE): a float32 softmax
router, ``experts_per_token`` experts a token with renormalised gates,
SwiGLU experts, no token dropped (``parallel.moe.moe_topk_ffn``: sorted
assignments, the ragged ``Alltoall`` there and back, grouped expert
products).  Its expert leaves are sharded: each ep rank passes
:func:`shard_experts` of the whole tree, holding ``E / ep`` experts, and
``train_step`` leaves them out of the ``comm_ep`` average; their
gradient arrives whole over the ``Alltoall``'s adjoint.  Per-layer
attention kinds (``layer_types``: sliding layers with ``attn_window``
and the default rope, full layers without a window and with YaRN) and
a ``head_dim`` apart from ``d_model // n_heads`` serve the same
models.  Besides the SGD ``train_step`` there are the
ZeRO-1 and ZeRO-3 steps (``zero_train_step``, ``zero3_train_step``) over
the port's functional optimizers (``utils/optim.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..constants import MPI_SUM, divide, scalar_like
from ..ops.flash import flash_attention, flash_block_attention
from ..parallel.attention import (ring_attention, ulysses_attention,
                                  zigzag_ring_attention, zigzag_slice)
from ..parallel.dp import all_average_tree
from ..parallel.moe import (expert_shard, init_moe, init_moe_topk, moe_ffn,
                            moe_ffn_dense, moe_topk_ffn)
from ..parallel.ring import ring_shift
from ..runtime import resolve_device
from ..utils import threefry
from ..obs.trace import step_phase
from ..utils.tree import tree_map, value_and_grad


_LAYER_KINDS = ("sliding", "full")
_MOE_FORMS = ("capacity", "dropless")
# YaRN's rotation counts bounding the blended frequencies (its defaults,
# which Hugging Face transformers also takes).
YARN_BETA_FAST = 32.0
YARN_BETA_SLOW = 1.0


@dataclass(frozen=True)
class TransformerConfig:
    """Static model hyperparameters, validated as in the JAX package.
    ``n_experts > 0`` makes every block's FFN a MoE with that many
    experts.  ``moe="capacity"`` (the JAX package's form) is top-1 over
    gelu experts: ``capacity`` slots per (expert, source rank), and the
    load-balancing loss weighted by ``aux_coef`` in :func:`lm_loss`.
    ``moe="dropless"`` routes each token to its ``experts_per_token``
    most probable SwiGLU experts (gates renormalised, nothing dropped, no
    auxiliary loss; ``parallel.moe.moe_topk_ffn``), and needs
    ``ffn="swiglu"``.

    The port's own fields, whose defaults keep the JAX package's model:
    ``head_dim`` (0: ``d_model // n_heads``; otherwise q is ``n_heads *
    head_dim`` wide against the ``d_model`` residual), ``norm_eps``,
    ``layer_types`` (one ``"sliding"`` or ``"full"`` a layer; empty: every
    layer sliding; a sliding layer takes ``attn_window``, a full one sees
    every earlier key) and the full layers' YaRN rope (``yarn_factor`` >
    0 over ``yarn_original_max`` positions, with YaRN's defaults: beta
    32 and 1, attention factor ``0.1 ln factor + 1``), as Hugging Face
    transformers computes it."""
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
    head_dim: int = 0
    norm_eps: float = 1e-5
    layer_types: tuple = ()
    yarn_factor: float = 0.0
    yarn_original_max: int = 0
    moe: str = "capacity"
    experts_per_token: int = 1

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.moe not in _MOE_FORMS:
            raise ValueError(f"unknown moe form {self.moe!r}")
        if self.moe == "dropless":
            if self.n_experts <= 0 or self.ffn != "swiglu":
                raise ValueError(
                    "moe='dropless' needs n_experts > 0 and ffn='swiglu' "
                    "(its experts are SwiGLU)")
            if not 1 <= self.experts_per_token <= self.n_experts:
                raise ValueError(
                    f"experts_per_token={self.experts_per_token} must lie "
                    f"in [1, n_experts={self.n_experts}]")
        elif self.experts_per_token != 1:
            raise ValueError("the capacity form routes top-1; "
                             "experts_per_token > 1 needs moe='dropless'")
        if self.head_dim < 0:
            raise ValueError(f"head_dim must be >= 0, got {self.head_dim}")
        if self.layer_types and (
                len(self.layer_types) != self.n_layers
                or any(t not in _LAYER_KINDS for t in self.layer_types)):
            raise ValueError(
                f"layer_types must give one of {_LAYER_KINDS} for each of "
                f"the {self.n_layers} layers, got {self.layer_types}")
        if self.yarn_factor and (self.yarn_factor <= 1.0 or not self.rope
                                 or self.yarn_original_max <= 0):
            raise ValueError(
                "yarn_factor > 1 needs rope=True and yarn_original_max > 0")
        if self.moe == "capacity" and self.n_experts > 0 and \
                self.capacity <= 0:
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
        if self.rope and self.head_size % 2 != 0:
            raise ValueError(
                f"rope requires an even head_dim, got {self.head_size}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.ffn not in ("gelu", "swiglu"):
            raise ValueError(f"unknown ffn {self.ffn!r}")
        if self.ffn == "swiglu" and self.n_experts > 0 and \
                self.moe == "capacity":
            # The JAX package's message: its one MoE is the capacity form.
            raise ValueError(
                "ffn='swiglu' applies to the dense FFN; the MoE experts "
                "(n_experts > 0) keep their own gelu expert MLPs")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_size(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_width(self) -> int:
        """Width of the queries and of the attention output: ``n_heads *
        head_size`` (``d_model`` unless ``head_dim`` says otherwise)."""
        return self.n_heads * self.head_size

    def layer_kind(self, i: int) -> str:
        return self.layer_types[i] if self.layer_types else "sliding"

    def layer_window(self, i: int) -> int:
        """Layer ``i``'s attention window: ``attn_window`` on a sliding
        layer, 0 (every earlier key) on a full one."""
        return self.attn_window if self.layer_kind(i) == "sliding" else 0


def init_transformer(generator, cfg: TransformerConfig,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Dict[str, Any]:
    """Parameter dictionary for a pre-LN decoder-only transformer, with the
    JAX package's shapes and scalings (normal embeddings and positions at
    0.02, matrices normal over ``sqrt(fan_in)``).  ``generator`` is a
    ``torch.Generator`` on ``device`` or an integer seed.  Draws happen
    in the JAX package's key order (embed, pos — drawn even under rope,
    so the stream does not shift — unembed, then per layer wqkv, wo, and
    w1, w2 or, with ``n_experts > 0``, the MoE leaves ``blk["moe"]``:
    gate, w1, w2, or router, w1, w2 in the dropless form); the numbers
    differ from JAX's, since the generators do.  The dropless form's
    ``blk["moe"]`` holds every expert: an expert-parallel rank keeps its
    :func:`shard_experts`."""
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

    params: Dict[str, Any] = {"embed": normal(cfg.vocab, d_model) * 0.02}
    pos = normal(cfg.max_seq, d_model) * 0.02
    if not cfg.rope:
        params["pos"] = pos
    params["ln_f"] = norm_p()
    params["unembed"] = dense(d_model, cfg.vocab)
    hd = cfg.head_size
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {"ln1": norm_p(),
               "wqkv": dense(d_model, cfg.q_width + 2 * cfg.kv_heads * hd),
               "wo": dense(cfg.q_width, d_model),
               "ln2": norm_p()}
        if cfg.moe == "dropless":
            blk["moe"] = init_moe_topk(generator, cfg.n_experts, d_model,
                                       d_ff, dtype, dev)
        elif cfg.n_experts > 0:
            blk["moe"] = init_moe(generator, cfg.n_experts, d_model, d_ff,
                                  dtype, dev)
        else:
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


def shard_experts(cfg: TransformerConfig, params, comm_ep):
    """This rank's parameters for dropless expert-parallel training over
    ``comm_ep``: every block's ``moe`` cut to the rank's ``E / size``
    experts (``parallel.moe.expert_shard``), the rest as it is."""
    if cfg.moe != "dropless":
        raise ValueError("only the dropless MoE keeps its experts sharded")
    return {**params, "blocks": [{**blk, "moe": expert_shard(comm_ep,
                                                             blk["moe"])}
                                 for blk in params["blocks"]]}


def _layer_norm(x, p):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]


def _rms_norm(x, p, eps=1e-5):
    ms = (x * x).mean(dim=-1, keepdim=True)
    return x / torch.sqrt(ms + eps) * p["scale"]


def _norm(cfg: TransformerConfig, x, p):
    return _rms_norm(x, p, cfg.norm_eps) if cfg.norm == "rmsnorm" \
        else _layer_norm(x, p)


def yarn_ramp(cfg: TransformerConfig, hd: int, dtype=torch.float32,
              device=None):
    """YaRN's blend of each rotary pair ``i < hd / 2``: 0 keeps the
    frequency, 1 divides it by ``yarn_factor``.  The correction range
    of Hugging Face transformers' ``_compute_yarn_parameters``: ``low =
    floor(d(YARN_BETA_FAST))``, ``high = ceil(d(YARN_BETA_SLOW))``, clamped to
    ``[0, hd - 1]``, with ``d(r) = hd ln(L / (2 pi r)) / (2 ln theta)``
    at the original context ``L``; the ramp ``(i - low) / (high - low)``
    clamped to ``[0, 1]``."""
    def dim(rot):
        return hd * math.log(cfg.yarn_original_max / (rot * 2 * math.pi)) \
            / (2 * math.log(cfg.rope_theta))

    low = max(math.floor(dim(YARN_BETA_FAST)), 0)
    high = min(math.ceil(dim(YARN_BETA_SLOW)), hd - 1)
    if low == high:
        high += 0.001
    i = torch.arange(hd // 2, dtype=dtype, device=device)
    return ((i - low) / (high - low)).clamp(0, 1)


def rope_inv_freq(cfg: TransformerConfig, hd: int, kind: str = "sliding",
                  dtype=torch.float32, device=None):
    """``(inv_freq (hd / 2,), scale)`` of a layer of ``kind``: the default
    rope ``theta^(-2 i / hd)`` and scale 1, or on a full layer under
    YaRN the blend ``inv / factor * ramp + inv * (1 - ramp)``
    (:func:`yarn_ramp`) and the attention factor, by which cos and sin
    are multiplied."""
    inv = cfg.rope_theta ** (
        -torch.arange(hd // 2, dtype=dtype, device=device) * 2.0 / hd)
    if kind != "full" or not cfg.yarn_factor:
        return inv, 1.0
    ramp = yarn_ramp(cfg, hd, dtype, device)
    inv = inv / cfg.yarn_factor * ramp + inv * (1 - ramp)
    return inv, 0.1 * math.log(cfg.yarn_factor) + 1.0


def _rope_rotate(cfg: TransformerConfig, x, positions, kind="sliding"):
    """Rotary position embedding (half-split convention) of a layer of
    ``kind`` (:func:`rope_inv_freq`).  ``positions`` is ``(s,)``, or
    ``(b, s)`` for per-row positions (continuous-batching decode)."""
    hd = x.shape[-1]
    half = hd // 2
    ct = torch.promote_types(x.dtype, torch.float32)
    inv, scale = rope_inv_freq(cfg, hd, kind, ct, x.device)
    positions = torch.as_tensor(positions, device=x.device)
    if positions.dim() == 1:
        ang = positions.to(ct)[:, None] * inv[None, :]
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
    else:
        ang = positions.to(ct)[..., None] * inv
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    x1, x2 = x[..., :half].to(ct), x[..., half:].to(ct)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _split_qkv(cfg: TransformerConfig, blk, y, positions=None,
               kind="sliding"):
    """Project ``y`` (b, s, d) through the fused qkv matrix into ``q``
    (b, s, h, hd) and ``k``/``v`` (b, s, kv_heads, hd), rotated as a
    layer of ``kind``."""
    b, s = y.shape[0], y.shape[1]
    h, h_kv = cfg.n_heads, cfg.kv_heads
    hd = cfg.head_size
    qkv = y @ blk["wqkv"]
    q = qkv[..., :h * hd].reshape(b, s, h, hd)
    k = qkv[..., h * hd:(h + h_kv) * hd].reshape(b, s, h_kv, hd)
    v = qkv[..., (h + h_kv) * hd:].reshape(b, s, h_kv, hd)
    if cfg.rope:
        if positions is None:
            raise ValueError("cfg.rope requires the caller's positions")
        q = _rope_rotate(cfg, q, positions, kind)
        k = _rope_rotate(cfg, k, positions, kind)
    return q, k, v


def _ffn_local(cfg: TransformerConfig, blk, y):
    """The dense FFN product of normalised ``y`` (gelu is the tanh form,
    as ``jax.nn.gelu``'s default)."""
    if cfg.ffn == "swiglu":
        gate, up = (y @ blk["w1"]).chunk(2, dim=-1)
        return (F.silu(gate) * up) @ blk["w2"]
    return F.gelu(y @ blk["w1"], approximate="tanh") @ blk["w2"]


def _ffn_residual(cfg: TransformerConfig, blk, x, comm_ep=None,
                  layer: int = 0):
    """Post-attention FFN with pre-LN and residual; returns ``(x, aux)``.
    With ``n_experts > 0`` the FFN is the MoE over the flattened tokens:
    expert-parallel over ``comm_ep`` of size > 1, else all experts local
    (``moe_ffn_dense``), and ``aux`` its load-balancing loss; a dense
    FFN's ``aux`` is None.  Capacity competes over exactly the tokens in
    ``x`` (a whole batch x sequence in training and prefill, one
    position's batch in decode), so the two can drop different tokens
    when capacity binds.  The dropless form (``moe_topk_ffn``, whose
    ``aux`` is None) drops nothing; ``layer`` labels its counters."""
    y = _norm(cfg, x, blk["ln2"])
    if cfg.moe == "dropless":
        comm = comm_ep if _sharded(comm_ep) else None
        ff = moe_topk_ffn(comm, y.reshape(-1, x.shape[-1]), blk["moe"],
                          cfg.experts_per_token, layer)
        return x + ff.reshape(x.shape), None
    if cfg.n_experts > 0:
        flat = y.reshape(-1, x.shape[-1])
        if comm_ep is not None and comm_ep.size > 1:
            ff, aux = moe_ffn(comm_ep, flat, blk["moe"], cfg.capacity)
        else:
            ff, aux = moe_ffn_dense(flat, blk["moe"], cfg.capacity)
        return x + ff.reshape(x.shape), aux
    return x + _ffn_local(cfg, blk, y), None


def init_kv_cache(cfg: TransformerConfig, batch: int, dtype, device):
    """Per-layer K/V cache ``(batch, max_seq, kv_heads, head_dim)``."""
    hd = cfg.head_size
    shape = (batch, cfg.max_seq, cfg.kv_heads, hd)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _window_bucket(cfg: TransformerConfig, window=None) -> int:
    """Length of the cache slice decode attends: the smallest power of
    two >= the sliding window (``window``, else ``cfg.attn_window``;
    capped at max_seq), or the whole buffer without a window."""
    window = cfg.attn_window if window is None else window
    if not window:
        return cfg.max_seq
    bucket = 1
    while bucket < window:
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
    positions = torch.tensor([pos], dtype=torch.int32, device=x.device)
    for i, (blk, c) in enumerate(zip(params["blocks"], cache)):
        win = cfg.layer_window(i)
        bucket = _window_bucket(cfg, win)
        y = _norm(cfg, x, blk["ln1"])
        q, k_new, v_new = _split_qkv(cfg, blk, y[:, None, :], positions,
                                     cfg.layer_kind(i))
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
        x = x + o.reshape(b, cfg.q_width).to(x.dtype) @ blk["wo"]
        x, _ = _ffn_residual(cfg, blk, x, layer=i)
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
    for i, (blk, c) in enumerate(zip(params["blocks"], cache)):
        y = _norm(cfg, x, blk["ln1"])
        q, k, v = _split_qkv(cfg, blk, y, positions, cfg.layer_kind(i))
        c["k"][:, :p_len] = k.to(c["k"].dtype)
        c["v"][:, :p_len] = v.to(c["v"].dtype)
        o = flash_attention(q, k, v, causal=True, window=cfg.layer_window(i))
        x = x + o.reshape(b, p_len, cfg.q_width) @ blk["wo"]
        x, _ = _ffn_residual(cfg, blk, x, layer=i)
    x = _norm(cfg, x, params["ln_f"])
    return x[:, -1] @ params["unembed"], cache


def _top_k_mask(logits, top_k: int):
    """Every logit below the row's ``top_k``-th largest becomes -inf; ties
    with the ``top_k``-th value all stay (``logits >= kth``)."""
    kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
    return torch.where(logits >= kth, logits,
                       scalar_like(-math.inf, logits))


def perturbed_scores(logits, key, temperature: float, top_k: int):
    """The scores a sampled choice takes the argmax of: the top-k masked
    ``logits / temperature`` plus Gumbel noise in the logits' dtype
    (``jax.random.categorical``'s Gumbel-max draw).  ``key`` is one key
    for the whole ``(batch, vocab)`` table, or a ``(batch, 2)`` int64
    tensor of one key per row (the serving engine's batched draw)."""
    if top_k:
        logits = _top_k_mask(logits, top_k)
    return threefry.gumbel_scores(
        key, logits / scalar_like(temperature, logits))


def select_token(logits, key=None, temperature: float = 0.0,
                 top_k: int = 0, dtype=None):
    """The decoding choice for each row of ``(batch, vocab)`` logits, the
    rule of the JAX package's ``select_token``: the greedy argmax (the
    first maximal index, like ``jnp.argmax``) when ``temperature == 0``,
    else a categorical draw at that temperature from the ``top_k``
    highest logits (0 = all), with ``key`` (see
    :func:`perturbed_scores`).  :func:`generate` and the serving engine
    both choose through it.  ``dtype`` casts the chosen ids."""
    if temperature == 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        tok = torch.argmax(perturbed_scores(logits, key, temperature,
                                            top_k), dim=-1)
    return tok if dtype is None else tok.to(dtype)


def generate(cfg: TransformerConfig, params, prompt, n_new: int,
             dtype=None, temperature: float = 0.0, top_k: int = 0,
             key=None):
    """Autoregressive decoding: prefill the cache from ``prompt``
    ``(batch, prompt_len)`` in one batched pass, then emit ``n_new``
    tokens one decode step at a time.  ``temperature == 0`` (default) is
    greedy; ``temperature > 0`` samples (``key`` required: two 32-bit
    words, ``utils.threefry.PRNGKey``), optionally from the ``top_k``
    highest logits.  The key splits once before the first token and once
    per step, greedy or not, as the JAX package's ``generate`` does, so
    the same key gives the same tokens.  The cache dtype follows the
    parameters unless ``dtype`` overrides it.  Returns ``(batch,
    prompt_len + n_new)`` tokens."""
    b, p_len = prompt.shape
    if p_len + n_new > cfg.max_seq:
        raise ValueError(
            f"prompt {p_len} + n_new {n_new} exceeds max_seq "
            f"{cfg.max_seq}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0 or top_k > cfg.vocab:
        raise ValueError(
            f"top_k must be in [0, vocab={cfg.vocab}], got {top_k}")
    if temperature > 0 and key is None:
        raise ValueError("temperature > 0 requires a PRNG `key`")
    if n_new == 0:
        return prompt
    dtype = dtype or params["embed"].dtype
    key = threefry.PRNGKey(0) if key is None else threefry.as_key(key)
    cache = init_kv_cache(cfg, b, dtype, prompt.device)
    logits, cache = prefill(cfg, params, cache, prompt)
    key, sub = threefry.split(key)
    tok = select_token(logits, sub, temperature, top_k, prompt.dtype)
    out = [tok]
    # Each step feeds the token at position i and emits position i+1's
    # choice; the last emitted token needs no decode step of its own.
    for i in range(p_len, p_len + n_new - 1):
        logits, cache = decode_step(cfg, params, cache, tok, i)
        key, sub = threefry.split(key)
        tok = select_token(logits, sub, temperature, top_k, prompt.dtype)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


# --------------------------------------------------------------- training

_ATTNS = ("dense", "ring", "ulysses", "zigzag")


def _check_parallel(attn: str) -> None:
    if attn not in _ATTNS:
        raise ValueError(f"unknown attention strategy {attn!r}")


def _sharded(comm) -> bool:
    return comm is not None and comm.size > 1


def _zigzag_positions(comm_sp, s_local: int, device):
    """Global positions of this rank's zigzag sequence shard, cut from the
    global position axis by :func:`zigzag_slice` itself, so the
    position and label arithmetic follows the data layout."""
    return zigzag_slice(comm_sp, torch.arange(
        comm_sp.size * s_local, dtype=torch.int32, device=device), axis=0)


def _attention(q, k, v, comm_sp, attn: str, window: int = 0):
    """Causal attention of one block's q/k/v under the sequence-parallel
    strategy ``attn`` over ``comm_sp``; flash attention on one device when
    ``comm_sp`` is None or of size 1."""
    if not _sharded(comm_sp):
        return flash_attention(q, k, v, causal=True, window=window)
    if attn == "dense":
        raise ValueError(
            "attn='dense' cannot see across sequence shards: with a "
            "size>1 sequence-parallel communicator each rank would attend "
            "only within its own block (and mask as if it started at "
            "position 0).  Use attn='ring' or attn='ulysses', or pass "
            "comm_sp=None with the full sequence.")
    if attn == "ring":
        return ring_attention(comm_sp, q, k, v, causal=True, window=window)
    if attn == "zigzag":
        if window:
            raise ValueError(
                "attn='zigzag' does not compose with attn_window: a "
                "sliding window already balances causal work (every query "
                "sees the same key count), which is the point of the "
                "zigzag layout — use attn='ring' for windowed sequence "
                "parallelism")
        return zigzag_ring_attention(comm_sp, q, k, v)
    return ulysses_attention(comm_sp, q, k, v, causal=True, window=window)


def forward(cfg: TransformerConfig, params, tokens, comm_sp=None,
            attn: str = "ring", comm_ep=None, return_aux: bool = False,
            return_hidden: bool = False):
    """Logits ``(batch, seq_local, vocab)`` for this rank's ``(batch,
    seq_local)`` token ids, the training forward.

    ``comm_sp`` (None, or size 1, for the full sequence) shards the
    sequence: ``tokens`` is this rank's contiguous block, rank-major, or
    its zigzag shard (:func:`~mpi4torch_tpu_torch.parallel.attention.
    zigzag_slice`) under ``attn="zigzag"``; positions (learned table or
    rope) are global.  Without rope the global length may not exceed
    ``cfg.max_seq``.  With ``cfg.n_experts > 0`` each block's FFN is the
    MoE, expert-parallel over ``comm_ep`` (None keeps all experts local);
    ``return_aux`` also returns the summed load-balancing loss (0 without
    experts).  ``return_hidden`` returns the post-``ln_f`` hidden states
    ``(batch, seq_local, d_model)`` instead of logits (what
    :func:`lm_loss`'s chunked vocabulary consumes).  With ``cfg.remat``
    each block is recomputed in the backward
    (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``)."""
    _check_parallel(attn)
    b, s_local = tokens.shape
    if _sharded(comm_sp):
        s_global = comm_sp.size * s_local
        offset = comm_sp.rank * s_local
    else:
        s_global, offset = s_local, 0
    if not cfg.rope and s_global > cfg.max_seq:
        raise ValueError(
            f"global sequence {s_global} (sp x s_local) exceeds "
            f"cfg.max_seq {cfg.max_seq}")
    if attn == "zigzag" and _sharded(comm_sp):
        # Two global position intervals: chunk r and chunk 2*sp-1-r.
        positions = _zigzag_positions(comm_sp, s_local, tokens.device)
    else:
        positions = offset + torch.arange(s_local, dtype=torch.int32,
                                          device=tokens.device)
    x = F.embedding(tokens, params["embed"])
    if not cfg.rope:
        if attn == "zigzag" and _sharded(comm_sp):
            x = x + params["pos"].index_select(0, positions)[None]
        else:
            x = x + params["pos"][None, offset:offset + s_local]
    width = cfg.q_width

    def block_fn(x, blk, i):
        y = _norm(cfg, x, blk["ln1"])
        q, k, v = _split_qkv(cfg, blk, y, positions, cfg.layer_kind(i))
        o = _attention(q, k, v, comm_sp, attn, cfg.layer_window(i))
        x = x + o.reshape(b, s_local, width) @ blk["wo"]
        return _ffn_residual(cfg, blk, x, comm_ep, i)

    aux_total = None
    for i, blk in enumerate(params["blocks"]):
        if cfg.remat:
            x, aux = checkpoint(block_fn, x, blk, i, use_reentrant=False)
        else:
            x, aux = block_fn(x, blk, i)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    x = _norm(cfg, x, params["ln_f"])
    out = x if return_hidden else x @ params["unembed"]
    if return_aux:
        if aux_total is None:
            aux_total = torch.zeros((), dtype=x.dtype, device=x.device)
        return out, aux_total
    return out


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
    """Mean next-token cross-entropy over the global sequence.

    Under sequence parallelism the label of a shard's last token lives on
    the next sp rank and is fetched with a one-column ``ring_shift(shift=
    -1)``; under the zigzag layout the lo chunk's last label comes from
    the next rank's lo chunk (the last rank's from its own hi chunk) and
    the hi chunk's from the previous rank's hi chunk (``shift=+1``), both
    shifts on every rank.  The final global position has no successor and
    is masked out; the sp-summed loss (``Allreduce``) is normalised by
    ``batch * (seq_global - 1)``.  With experts, ``cfg.aux_coef`` times
    the sp-averaged load-balancing loss is added.  ``vocab_chunk`` (a
    divisor of the vocabulary, smaller than it) computes the loss through
    :func:`_chunked_ce` without materialising the logits."""
    b, s_local = tokens.shape
    sp = comm_sp.size if comm_sp is not None else 1
    s_global = seq_global or sp * s_local
    if vocab_chunk and (vocab_chunk <= 0
                        or cfg.vocab % vocab_chunk != 0):
        raise ValueError(
            f"vocab_chunk={vocab_chunk} must divide vocab={cfg.vocab}")
    want_hidden = bool(vocab_chunk) and vocab_chunk < cfg.vocab
    if cfg.n_experts > 0 and cfg.moe == "capacity":
        out, aux = forward(cfg, params, tokens, comm_sp, attn,
                           comm_ep=comm_ep, return_aux=True,
                           return_hidden=want_hidden)
    else:
        out = forward(cfg, params, tokens, comm_sp, attn, comm_ep=comm_ep,
                      return_hidden=want_hidden)
        aux = None

    if sp > 1 and attn == "zigzag":
        c = s_local // 2
        lo, hi = tokens[:, :c], tokens[:, c:]
        from_next_lo = ring_shift(comm_sp, lo[:, :1], shift=-1)
        from_prev_hi = ring_shift(comm_sp, hi[:, :1], shift=1)
        lo_last = hi[:, :1] if comm_sp.rank == sp - 1 else from_next_lo
        labels = torch.cat([lo[:, 1:], lo_last, hi[:, 1:], from_prev_hi],
                           dim=1)
        global_pos = _zigzag_positions(comm_sp, s_local, tokens.device)
    elif sp > 1:
        nxt = ring_shift(comm_sp, tokens[:, :1], shift=-1)
        labels = torch.cat([tokens[:, 1:], nxt], dim=1)
        global_pos = comm_sp.rank * s_local + torch.arange(
            s_local, device=tokens.device)
    else:
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        global_pos = torch.arange(s_local, device=tokens.device)
    mask = (global_pos < s_global - 1).to(out.dtype)

    if want_hidden:
        ce = _chunked_ce(out, params["unembed"], labels, vocab_chunk)
    else:
        logp = F.log_softmax(out, dim=-1)
        ce = -logp.gather(-1, labels[..., None])[..., 0]
    local_sum = torch.sum(ce * mask[None, :])
    if sp > 1:
        # compression=False: an exact-parity internal sum, which a
        # gradient-compression scope must not reach.
        total = comm_sp.Allreduce(local_sum, MPI_SUM, compression=False)
    else:
        total = local_sum
    loss = total / (b * (s_global - 1))
    if aux is not None:
        if sp > 1:
            # Each sp rank routes its own shard: average, so the loss
            # stays rank-identical.
            aux = comm_sp.Allreduce(aux, MPI_SUM, compression=False) / sp
        loss = loss + cfg.aux_coef * aux
    return loss


def _average(comm, tree):
    return all_average_tree(comm, tree) if _sharded(comm) else tree


def _mean_over(comm, loss):
    if not _sharded(comm):
        return loss
    return divide(comm.Allreduce(loss, MPI_SUM, compression=False),
                  comm.size)


class _GradScale(torch.autograd.Function):
    """The identity forward (the same tensor's values, no copy); the
    backward multiplies the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _split_experts(p):
    """``(replicated, experts)``: the tree without the dropless experts'
    ``w1``/``w2``, and those leaves, one dictionary a block."""
    blocks = [{**blk, "moe": {"router": blk["moe"]["router"]}}
              for blk in p["blocks"]]
    experts = [{"w1": blk["moe"]["w1"], "w2": blk["moe"]["w2"]}
               for blk in p["blocks"]]
    return {**p, "blocks": blocks}, experts


def _join_experts(rep, experts):
    return {**rep, "blocks": [{**blk, "moe": {**blk["moe"], **e}}
                              for blk, e in zip(rep["blocks"], experts)]}


def _average_params(cfg, p, comm_dp, comm_sp, comm_ep):
    """The parameters every rank computes with: averaged over
    ``comm_dp``, ``comm_sp`` and ``comm_ep``, an Allreduce whose adjoint
    makes each rank's gradient the axis mean.  Dropless experts sharded
    over ``comm_ep`` are not averaged over it: their gradient reaches
    them whole over the Alltoall's adjoint, from every rank's tokens,
    and is scaled by ``1 / ep`` to the gradient of the ep-mean loss."""
    if cfg.moe != "dropless" or not _sharded(comm_ep):
        return _average(comm_ep, _average(comm_sp, _average(comm_dp, p)))
    rep, experts = _split_experts(p)
    rep = _average(comm_ep, _average(comm_sp, _average(comm_dp, rep)))
    inv = 1.0 / comm_ep.size
    experts = tree_map(lambda t: _GradScale.apply(t, inv),
                       _average(comm_sp, _average(comm_dp, experts)))
    return _join_experts(rep, experts)


def train_step(cfg: TransformerConfig, params, tokens, comm_sp=None,
               comm_dp=None, attn: str = "ring", lr: float = 1e-2,
               comm_ep=None):
    """One SGD step; returns ``(loss, new_params)``.

    The reference's data-parallel recipe, applied per axis: the
    parameters are averaged over ``comm_dp``, ``comm_sp`` and ``comm_ep``
    (an Allreduce whose adjoint makes each rank's gradient the mean over
    the axis), and the loss is averaged over ``comm_dp`` and ``comm_ep``
    (ranks holding other data).  Over sp the loss is already the
    sp-summed global loss: each rank's cotangents come out ``sp`` times
    too large and the parameter average's ``1/sp`` cancels it.  Over ep
    the capacity form's experts, sliced per rank inside ``moe_ffn``, are
    logically replicated leaves like the rest; the dropless form's are
    sharded (each rank passes its :func:`shard_experts`) and stay
    unaveraged (:func:`_average_params`), while its replicated leaves
    ride the same fused buckets.  The gradient comes from
    :func:`torch.autograd.grad`; the update is ``p - lr * g``."""
    _check_parallel(attn)

    def global_loss(p):
        p = _average_params(cfg, p, comm_dp, comm_sp, comm_ep)
        loss = lm_loss(cfg, p, tokens, comm_sp, attn, comm_ep=comm_ep)
        return _mean_over(comm_ep, _mean_over(comm_dp, loss))

    loss, grads = value_and_grad(global_loss, params)
    with step_phase("update"), torch.no_grad():
        new_params = tree_map(lambda p, g: p - lr * g, params, grads)
    return loss, new_params


def zero_train_step(cfg: TransformerConfig, params, tokens, opt,
                    opt_state, comm_dp, comm_sp=None, attn: str = "ring",
                    comm_ep=None):
    """One optimizer step with ZeRO-1 sharded state over ``comm_dp``;
    returns ``(loss, new_params, new_opt_state)``.

    The data-parallel reduction moves out of the loss and into
    :func:`~mpi4torch_tpu_torch.parallel.zero.zero_step`'s
    reduce-scatter: each rank differentiates its local loss (no dp
    parameter averaging, no dp loss Allreduce — the un-reduced gradients
    are what the reduce-scatter sums), the element-wise ``opt`` update
    (``utils/optim.py``) runs on this rank's ``1/dp`` parameter shard,
    and the allgather re-replicates.  The sp and ep axes compose inside
    the local loss as in :func:`train_step`.  The parameters match
    replicated-DP training with the same optimizer bit for bit; the
    optimizer state is ``1/dp`` of the replicated state.  The returned
    loss is the dp mean."""
    from ..parallel.zero import zero_step

    _check_parallel(attn)

    def local_loss(p):
        p = _average(comm_ep, _average(comm_sp, p))
        loss = lm_loss(cfg, p, tokens, comm_sp, attn, comm_ep=comm_ep)
        return _mean_over(comm_ep, loss)

    loss, grads = value_and_grad(local_loss, params)
    # zero_step's reduce-scatter / size turns the un-reduced local
    # gradients into the dp-mean gradient shard.
    new_params, new_state = zero_step(comm_dp, opt, params, grads,
                                      opt_state)
    loss = divide(comm_dp.Allreduce(loss, MPI_SUM, compression=False),
                  comm_dp.size)
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
    adjoint.  Sequence parallelism composes inside the local loss as in
    :func:`zero_train_step`.  Obtain ``(p_shards, opt_state)`` from
    :func:`~mpi4torch_tpu_torch.parallel.zero.zero3_init`.  The
    parameters match replicated-DP training with the same optimizer bit
    for bit."""
    from ..parallel.zero import zero3_step

    _check_parallel(attn)

    def local_loss(p):
        return lm_loss(cfg, _average(comm_sp, p), tokens, comm_sp, attn)

    loss, new_shards, new_state = zero3_step(
        comm_dp, opt, p_shards, template, local_loss, opt_state)
    loss = divide(comm_dp.Allreduce(loss, MPI_SUM, compression=False),
                  comm_dp.size)
    return loss, new_shards, new_state
