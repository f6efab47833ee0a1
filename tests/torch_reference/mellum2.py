"""Plain float32 reference of Mellum2-12B-A2.5B (the ``config.json`` of
JetBrains/Mellum2-12B-A2.5B-Instruct): written from the published keys
alone, with no kernel, cache or batching, and nothing of the port.

Each layer ``l`` of kind ``t(l)`` (``layer_types``: sliding or full):

* ``h = RMSNorm1(x)``, ``RMSNorm(x) = x rsqrt(mean(x^2) + eps) scale``;
* ``q, k, v = h Wq, h Wk, h Wv`` (``head_dim`` wide heads, no biases),
  rotary positions in the half-split convention: the default frequencies
  ``theta^(-2i/hd)`` on sliding layers, YaRN's on full layers (Hugging
  Face transformers' ``_compute_yarn_parameters``), with cos and sin
  times the attention factor;
* ``o = softmax(q k^T / sqrt(hd) + mask) v``, grouped-query; the mask is
  causal, and on sliding layers key ``j`` is seen from query ``i`` only
  if ``i - j < sliding_window``; ``x = x + o Wo``;
* ``h = RMSNorm2(x)``, ``p = softmax(h Wr)`` in float32, the
  ``num_experts_per_tok`` largest ``S``, ``g_e = p_e / sum_S p``
  (``norm_topk_prob``), ``x = x + sum_S g_e W2_e (silu(h Wg_e) * (h
  Wu_e))``, each expert computed on the tokens routed to it;

then the final RMSNorm, the untied head and the mean next-token
cross-entropy over every position but the last.

Parameters are a dict from a path tuple to a tensor in the port's layout:
``("blocks", i, "wqkv")`` holds q | k | v by heads, ``("blocks", i,
"moe", "w1")`` is ``(E, d, 2 f)`` gate | up, each used as ``x @ W``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope_frequencies(conf, kind):
    """``(inv_freq, attention factor)`` of a layer of ``kind``
    (``"sliding_attention"`` or ``"full_attention"``)."""
    p = conf["rope_parameters"][kind]
    hd = conf["head_dim"]
    base = float(p["rope_theta"])
    pos_freqs = base ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd)
    if p["rope_type"] == "default":
        return 1.0 / pos_freqs, 1.0
    assert p["rope_type"] == "yarn", p
    factor = float(p["factor"])
    orig = p["original_max_position_embeddings"]

    def correction_dim(rotations):
        return hd * math.log(orig / (rotations * 2 * math.pi)) / \
            (2 * math.log(base))

    low = max(math.floor(correction_dim(p["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(p["beta_slow"])), hd - 1)
    ramp = ((torch.arange(hd // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    extrapolation = 1.0 / pos_freqs
    interpolation = 1.0 / (factor * pos_freqs)
    inv = interpolation * ramp + extrapolation * (1 - ramp)
    return inv, float(p.get("attention_factor",
                            0.1 * math.log(factor) + 1.0))


def rope(x, conf, kind):
    """Rotate ``(s, heads, hd)``: the first half of each head pairs with
    the second."""
    inv, factor = rope_frequencies(conf, kind)
    ang = torch.arange(x.shape[0], dtype=torch.float32)[:, None] * \
        inv.to(x.device)[None, :]
    cos = (torch.cos(ang) * factor)[:, None, :].to(x.device)
    sin = (torch.sin(ang) * factor)[:, None, :].to(x.device)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def visible(s, window):
    """``(s, s)`` boolean: query ``i`` sees key ``j``."""
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    keep = j <= i
    if window:
        keep &= (i - j) < window
    return keep


def attention(q, k, v, window):
    """q ``(s, h, hd)``, k and v ``(s, h_kv, hd)``."""
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    keep = visible(q.shape[0], window).to(q.device)
    scores = scores.masked_fill(~keep, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)


def route(conf, h, router):
    """``(experts (T, k), gates (T, k))`` of the float32 softmax router
    with renormalised top-k gates."""
    p = torch.softmax((h @ router).float(), dim=-1)
    top, experts = torch.topk(p, conf["num_experts_per_tok"], dim=-1)
    if conf["norm_topk_prob"]:
        top = top / top.sum(-1, keepdim=True)
    return experts, top


def moe(conf, h, router, w1, w2):
    """The sparse MLP of tokens ``h`` ``(T, d)``: each expert computed on
    the tokens routed to it."""
    experts, gates = route(conf, h, router)
    out = torch.zeros_like(h)
    for e in range(w1.shape[0]):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        gate, up = (h[tok] @ w1[e]).chunk(2, dim=-1)
        y = (F.silu(gate) * up) @ w2[e]
        out = out.index_add(0, tok, gates[tok, slot][:, None] * y)
    return out


def sequence_loss_sum(conf, P, tokens):
    """The summed next-token loss of one sequence ``(s,)``."""
    d, hd = conf["hidden_size"], conf["head_dim"]
    h, h_kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    eps = conf["rms_norm_eps"]
    s = tokens.shape[0]
    x = P[("embed",)][tokens]
    for i, kind in enumerate(conf["layer_types"]):
        blk = ("blocks", i)
        y = rms_norm(x, P[blk + ("ln1", "scale")], eps)
        qkv = y @ P[blk + ("wqkv",)]
        q = rope(qkv[:, :h * hd].reshape(s, h, hd), conf, kind)
        k = rope(qkv[:, h * hd:(h + h_kv) * hd].reshape(s, h_kv, hd), conf,
                 kind)
        v = qkv[:, (h + h_kv) * hd:].reshape(s, h_kv, hd)
        window = conf["sliding_window"] if kind == "sliding_attention" \
            else 0
        o = attention(q, k, v, window)
        x = x + o.reshape(s, h * hd) @ P[blk + ("wo",)]
        y = rms_norm(x, P[blk + ("ln2", "scale")], eps)
        x = x + moe(conf, y, P[blk + ("moe", "router")],
                    P[blk + ("moe", "w1")], P[blk + ("moe", "w2")])
    x = rms_norm(x, P[("ln_f", "scale")], eps)
    logits = x[:-1] @ P[("unembed",)]
    return F.cross_entropy(logits, tokens[1:], reduction="sum")


def loss(conf, P, tokens):
    """The mean next-token loss of ``tokens`` ``(b, s)`` over every
    position but each row's last."""
    total = sum(sequence_loss_sum(conf, P, row) for row in tokens)
    return total / (tokens.shape[0] * (tokens.shape[1] - 1))
