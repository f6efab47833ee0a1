"""Plain float32 reference of a decoder with sparse SwiGLU experts and
sliding and full attention layers, from the published ``config.json``
keys of Mellum2-12B-A2.5B (JetBrains/Mellum2-12B-A2.5B-Instruct): RMSNorm
(``rms_norm_eps``), ``head_dim``-wide grouped-query heads, rotary
positions in the half-split convention (the default frequencies on
``sliding_attention`` layers, YaRN's on ``full_attention`` layers, as
Hugging Face transformers' ``_compute_yarn_parameters`` gives them, cos
and sin times the attention factor), causal attention with the
``sliding_window`` on sliding layers (key ``j`` seen from query ``i`` if
``i - j < window``), a float32 softmax router over ``num_experts`` with
the ``num_experts_per_tok`` largest gates renormalised
(``norm_topk_prob``), SwiGLU experts computed on the tokens routed to
them, an untied head, and the mean next-token cross-entropy over every
position but the last.  No load-balancing loss (the config states no
coefficient).

Parameters follow the port's layout: ``wqkv`` q | k | v by heads, the
experts' ``w1`` ``(E, d, 2 f)`` gate | up and ``w2`` ``(E, f, d)``, each
used as ``x @ W``; every product with a weight matrix is taken by ``mm``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512   # queries whose scores exist at once
# Sequences through the model at once, so that the float32 reference fits
# on the card at 8192 tokens a sequence beside its parameters.
ROWS_PER_CALL = 1


def n_rows(tokens):
    return tokens.shape[0]


def take_rows(tokens, lo, hi):
    return tokens[lo:hi]


def positions_per_row(tokens):
    return tokens.shape[1] - 1


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope_frequencies(conf, kind, device):
    """``(inv_freq, attention factor)`` of a layer of ``kind``."""
    p = conf["rope_parameters"][kind]
    hd = conf["head_dim"]
    base = float(p["rope_theta"])
    pos_freqs = base ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                      device=device) / hd)
    if p["rope_type"] == "default":
        return 1.0 / pos_freqs, 1.0
    if p["rope_type"] != "yarn":
        raise ValueError(f"rope_type {p['rope_type']!r}")
    factor = float(p["factor"])
    orig = p["original_max_position_embeddings"]

    def correction_dim(rotations):
        return hd * math.log(orig / (rotations * 2 * math.pi)) / \
            (2 * math.log(base))

    low = max(math.floor(correction_dim(p["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(p["beta_slow"])), hd - 1)
    ramp = ((torch.arange(hd // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    inv = 1.0 / (factor * pos_freqs) * ramp + 1.0 / pos_freqs * (1 - ramp)
    return inv, float(p.get("attention_factor",
                            0.1 * math.log(factor) + 1.0))


def rope(x, conf, kind):
    """Rotate ``(s, heads, hd)``: the first half of each head pairs with
    the second."""
    inv, factor = rope_frequencies(conf, kind, x.device)
    ang = torch.arange(x.shape[0], dtype=torch.float32,
                       device=x.device)[:, None] * inv
    cos = (torch.cos(ang) * factor)[:, None, :]
    sin = (torch.sin(ang) * factor)[:, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(qb, k, v, lo, window):
    """Queries ``lo .. lo + len(qb)`` against every key: causal, and within
    the last ``window`` positions (the query's own included)."""
    s = torch.einsum("qhd,khd->hqk", qb, k) / math.sqrt(qb.shape[-1])
    qpos = lo + torch.arange(qb.shape[0], device=qb.device)[:, None]
    kpos = torch.arange(k.shape[0], device=qb.device)[None, :]
    keep = kpos <= qpos
    if window:
        keep &= (qpos - kpos) < window
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def attention(q, k, v, window):
    """Causal grouped-query attention of one sequence, the scores of
    ``Q_BLOCK`` queries at a time, recomputed in the backward."""
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    return torch.cat([checkpoint(_attend, q[lo:lo + Q_BLOCK], k, v, lo,
                                 window, use_reentrant=False)
                      for lo in range(0, q.shape[0], Q_BLOCK)])


def moe(conf, h, router, w1, w2, mm):
    """The sparse MLP of tokens ``h`` ``(T, d)``: the float32 softmax
    router, renormalised top-k gates, each expert on its tokens."""
    p = torch.softmax(mm(h, router), dim=-1)
    top, experts = torch.topk(p, conf["num_experts_per_tok"], dim=-1)
    if conf["norm_topk_prob"]:
        top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(w1.shape[0]):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        gate, up = mm(h[tok], w1[e]).chunk(2, dim=-1)
        y = mm(F.silu(gate) * up, w2[e])
        out = out.index_add(0, tok, top[tok, slot][:, None] * y)
    return out


def seq_loss_sum(conf, P, tokens, mm):
    d, hd = conf["hidden_size"], conf["head_dim"]
    h, h_kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    eps = conf["rms_norm_eps"]
    s = tokens.shape[0]
    x = P[("embed",)][tokens]
    for i, kind in enumerate(conf["layer_types"]):
        blk = ("blocks", i)
        y = rms_norm(x, P[blk + ("ln1", "scale")], eps)
        qkv = mm(y, P[blk + ("wqkv",)])
        q = rope(qkv[:, :h * hd].reshape(s, h, hd), conf, kind)
        k = rope(qkv[:, h * hd:(h + h_kv) * hd].reshape(s, h_kv, hd), conf,
                 kind)
        v = qkv[:, (h + h_kv) * hd:].reshape(s, h_kv, hd)
        window = conf["sliding_window"] if kind == "sliding_attention" \
            else 0
        o = attention(q, k, v, window)
        x = x + mm(o.reshape(s, h * hd), P[blk + ("wo",)])
        y = rms_norm(x, P[blk + ("ln2", "scale")], eps)
        x = x + moe(conf, y, P[blk + ("moe", "router")],
                    P[blk + ("moe", "w1")], P[blk + ("moe", "w2")], mm)
    x = rms_norm(x, P[("ln_f", "scale")], eps)
    logits = mm(x[:-1], P[("unembed",)])
    return F.cross_entropy(logits, tokens[1:], reduction="sum")


def loss_sum(conf, P, rows, mm):
    """Summed next-token loss of ``rows`` ``(n, s)`` token ids."""
    return sum(seq_loss_sum(conf, P, row, mm) for row in rows)
