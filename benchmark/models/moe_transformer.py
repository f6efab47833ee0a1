"""A decoder with sparse SwiGLU experts and sliding and full attention
layers (the published ``config.json`` keys of Mellum2-12B-A2.5B), run by
``mpi4torch_tpu_torch.models.transformer`` under expert-parallel
training: ``train_step(cfg, params, tokens, comm_ep=COMM_WORLD, lr=...)``
on each rank thread, every rank holding its ``E / ranks`` experts
(``shard_experts``) and the rest whole.

:func:`param_specs` lists the whole expert leaves, so that one seed gives
the program and the reference the same weights; the loop
(``loops/ep_train.py``) hands each rank its slices.
"""

from __future__ import annotations

import math

SLIDING, FULL = "sliding_attention", "full_attention"


def port_config(conf):
    from mpi4torch_tpu_torch.models import transformer as T

    if conf["hidden_act"] != "silu":
        raise ValueError(f"hidden_act {conf['hidden_act']!r}: the port's "
                         "experts are SwiGLU (silu)")
    if conf["tie_word_embeddings"] or conf["attention_bias"]:
        raise ValueError("the port's embedding and head are separate and "
                         "its projections have no bias")
    if set(conf["mlp_layer_types"]) != {"sparse"}:
        raise ValueError("every MLP of the configuration must be sparse")
    if not conf["norm_topk_prob"]:
        raise ValueError("the port's top-k gates are renormalised")
    rope = conf["rope_parameters"]
    slide, full = rope[SLIDING], rope[FULL]
    if slide["rope_type"] != "default" or full["rope_type"] != "yarn" or \
            slide["rope_theta"] != full["rope_theta"]:
        raise ValueError("the port rotates sliding layers by the default "
                         "rope and full layers by YaRN, at one theta")
    if (full["beta_fast"], full["beta_slow"]) != (
            T.YARN_BETA_FAST, T.YARN_BETA_SLOW) or full[
            "attention_factor"] != 0.1 * math.log(full["factor"]) + 1.0:
        raise ValueError("the port's YaRN takes beta 32 and 1 and the "
                         "attention factor 0.1 ln factor + 1")
    return T.TransformerConfig(
        vocab=conf["vocab_size"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"],
        n_layers=conf["num_hidden_layers"],
        d_ff=conf["moe_intermediate_size"],
        max_seq=conf["max_position_embeddings"],
        n_kv_heads=conf["num_key_value_heads"], head_dim=conf["head_dim"],
        attn_window=conf["sliding_window"], rope=True,
        rope_theta=float(slide["rope_theta"]), norm="rmsnorm",
        norm_eps=conf["rms_norm_eps"], ffn="swiglu",
        layer_types=tuple("sliding" if t == SLIDING else "full"
                          for t in conf["layer_types"]),
        yarn_factor=float(full["factor"]),
        yarn_original_max=full["original_max_position_embeddings"],
        n_experts=conf["num_experts"], moe="dropless",
        experts_per_token=conf["num_experts_per_tok"])


def _dims(conf):
    d, hd = conf["hidden_size"], conf["head_dim"]
    h, h_kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    return d, hd, h * hd, h_kv * hd, conf["moe_intermediate_size"]


def is_expert(path) -> bool:
    """Whether a leaf is an expert matrix, held a slice a rank."""
    return len(path) == 4 and path[2] == "moe" and path[3] in ("w1", "w2")


# The embedding's scale.  At ``init_transformer``'s 0.02 the residual
# after the first attention is its output's part common to every token, so
# every token's router input points one way and all of them go to the same
# 8 experts (the load gauge reads 7.4-8.0 of a possible 8); at 1.0
# (PyTorch's ``nn.Embedding`` default) the tokens route apart, 2.0-3.3
# under the Zipf ids.
EMBED_SCALE = 1.0


def param_specs(conf):
    """The port's layout (``init_transformer`` under rope and the dropless
    MoE), the experts whole; the embedding at :data:`EMBED_SCALE`."""
    d, hd, q, kv, f = _dims(conf)
    vocab, E = conf["vocab_size"], conf["num_experts"]
    specs = [(("embed",), (vocab, d), "normal", EMBED_SCALE),
             (("ln_f", "scale"), (d,), "ones", 1.0),
             (("unembed",), (d, vocab), "normal", 1 / math.sqrt(d))]
    for i in range(conf["num_hidden_layers"]):
        blk = ("blocks", i)
        specs += [(blk + ("ln1", "scale"), (d,), "ones", 1.0),
                  (blk + ("wqkv",), (d, q + 2 * kv), "normal",
                   1 / math.sqrt(d)),
                  (blk + ("wo",), (q, d), "normal", 1 / math.sqrt(q)),
                  (blk + ("ln2", "scale"), (d,), "ones", 1.0),
                  (blk + ("moe", "router"), (d, E), "normal",
                   1 / math.sqrt(d)),
                  (blk + ("moe", "w1"), (E, d, 2 * f), "normal",
                   1 / math.sqrt(d)),
                  (blk + ("moe", "w2"), (E, f, d), "normal",
                   1 / math.sqrt(f))]
    return specs


def make_inputs(conf, traffic, generator, device, n_steps):
    """Token ids ``(n_steps, ranks, rows, seq_len)`` int64 from a Zipf law
    of exponent ``traffic["zipf"]`` over the vocabulary, under a seeded
    permutation of the ids: natural text's unigram skew, which loads the
    router unevenly."""
    import torch

    vocab = conf["vocab_size"]
    shape = (n_steps, traffic["ranks"], traffic["rows_per_rank"],
             traffic["seq_len"])
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    probs = ranks ** -float(traffic["zipf"])
    perm = torch.randperm(vocab, generator=generator, device=device)
    n = math.prod(shape)
    draw = torch.multinomial(probs / probs.sum(), n, replacement=True,
                             generator=generator)
    return perm[draw].reshape(shape)


def batch(inputs, step, rank):
    return inputs[step, rank]


def train_step(comm, cfg, params, tokens, lr):
    """The port's entry on this rank's tokens.  ``comm`` None leaves the
    exchange of the gradients out (each rank steps on its own loss; the
    experts' dispatch, without which the layer cannot run, still rides
    ``COMM_WORLD``)."""
    import torch
    from mpi4torch_tpu_torch import COMM_WORLD
    from mpi4torch_tpu_torch.models import transformer as T
    from mpi4torch_tpu_torch.utils.tree import tree_map, value_and_grad

    if comm is not None:
        return T.train_step(cfg, params, tokens, comm_ep=comm, lr=lr)
    loss, grads = value_and_grad(
        lambda p: T.lm_loss(cfg, p, tokens, comm_ep=COMM_WORLD), params)
    with torch.no_grad():
        return loss, tree_map(lambda p, g: p - lr * g, params, grads)


def work(conf, traffic):
    return {"tokens": traffic["ranks"] * traffic["rows_per_rank"]
            * traffic["seq_len"]}


def matmul_params(conf):
    """Parameters that enter a matrix product a token, with the active
    experts only (the embedding is a lookup)."""
    d, hd, q, kv, f = _dims(conf)
    k, E = conf["num_experts_per_tok"], conf["num_experts"]
    per_layer = d * (q + 2 * kv) + q * d + d * E + k * 3 * d * f
    return conf["num_hidden_layers"] * per_layer + d * conf["vocab_size"]


def attention_calls(conf, traffic):
    """One entry for the sliding layers and one for the full layers."""
    d, hd, q, kv, f = _dims(conf)
    kinds = conf["layer_types"]
    base = {"b": traffic["rows_per_rank"], "sq": traffic["seq_len"],
            "sk": traffic["seq_len"], "h": conf["num_attention_heads"],
            "h_kv": conf["num_key_value_heads"], "d": hd, "causal": True}
    return [dict(base, window=conf["sliding_window"],
                 count=traffic["ranks"] * kinds.count(SLIDING)),
            dict(base, window=0, count=traffic["ranks"] * kinds.count(FULL))]


def model_flops(conf, traffic):
    """6 x active matmul parameters x tokens, plus attention forward (4 d
    a pair and head) and backward (8 d), with the causal and window
    masks."""
    from ..bounds import flash_attention as FA

    tokens = work(conf, traffic)["tokens"]
    attn = sum(3 * FA.operations(c, "fwd") * c["count"]
               for c in attention_calls(conf, traffic))
    return 6.0 * matmul_params(conf) * tokens + attn
