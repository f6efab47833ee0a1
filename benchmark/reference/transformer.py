"""Plain float32 reference of a Mistral-style decoder (Jiang et al. 2023,
arXiv:2310.06825; the ``config.json`` of mistralai/Mistral-7B-v0.1):
RMSNorm (eps 1e-5), rotary positions in the half-split convention,
grouped-query causal attention with a sliding window, a SwiGLU FFN, an
untied head, and the mean next-token cross-entropy over every position but
the last, computed over the whole vocabulary at once.

Parameters follow the port's layout: ``wqkv`` holds q | k | v by heads and
``w1`` gate | up, each used as ``x @ W``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5
Q_BLOCK = 512   # queries whose scores exist at once
# Sequences through the model at once, so that the float32 reference fits
# on the card at 4096 tokens a sequence.
ROWS_PER_CALL = 1


def n_rows(tokens):
    return tokens.shape[0]


def take_rows(tokens, lo, hi):
    return tokens[lo:hi]


def positions_per_row(tokens):
    return tokens.shape[1] - 1


def rms_norm(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def rope(x, theta):
    """Rotate ``(s, heads, hd)``: the first half of each head pairs with
    the second at frequency ``theta ** (-2 i / hd)``."""
    s, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) * 2.0 / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(qb, k, v, lo, window):
    """Queries ``lo .. lo + len(qb)`` against every key: causal, and within
    the last ``window`` positions (the query's own included)."""
    d = qb.shape[-1]
    s = torch.einsum("qhd,khd->hqk", qb, k) / math.sqrt(d)
    qpos = lo + torch.arange(qb.shape[0], device=qb.device)[:, None]
    kpos = torch.arange(k.shape[0], device=qb.device)[None, :]
    keep = kpos <= qpos
    if window:
        keep &= (qpos - kpos) < window
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def attention(q, k, v, window):
    """Causal grouped-query attention of one sequence: q ``(s, h, hd)``,
    k and v ``(s, h_kv, hd)``; the scores of ``Q_BLOCK`` queries at a time,
    recomputed in the backward."""
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    return torch.cat([checkpoint(_attend, q[lo:lo + Q_BLOCK], k, v, lo,
                                 window, use_reentrant=False)
                      for lo in range(0, q.shape[0], Q_BLOCK)])


def seq_loss_sum(conf, P, tokens, mm):
    d = conf["hidden_size"]
    h, h_kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = d // h
    s = tokens.shape[0]
    x = P[("embed",)][tokens]
    for i in range(conf["num_hidden_layers"]):
        blk = ("blocks", i)
        y = rms_norm(x, P[blk + ("ln1", "scale")])
        qkv = mm(y, P[blk + ("wqkv",)])
        q = rope(qkv[:, :h * hd].reshape(s, h, hd), conf["rope_theta"])
        k = rope(qkv[:, h * hd:(h + h_kv) * hd].reshape(s, h_kv, hd),
                 conf["rope_theta"])
        v = qkv[:, (h + h_kv) * hd:].reshape(s, h_kv, hd)
        o = attention(q, k, v, conf["sliding_window"] or 0)
        x = x + mm(o.reshape(s, d), P[blk + ("wo",)])
        y = rms_norm(x, P[blk + ("ln2", "scale")])
        gate, up = mm(y, P[blk + ("w1",)]).chunk(2, dim=-1)
        x = x + mm(F.silu(gate) * up, P[blk + ("w2",)])
    x = rms_norm(x, P[("ln_f", "scale")])
    logits = mm(x[:-1], P[("unembed",)])
    return F.cross_entropy(logits, tokens[1:], reduction="sum")


def loss_sum(conf, P, rows, mm):
    """Summed next-token loss of ``rows`` ``(n, s)`` token ids."""
    return sum(seq_loss_sum(conf, P, row, mm) for row in rows)
