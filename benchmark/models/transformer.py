"""The decoder-only transformer of ``mpi4torch_tpu_torch.models.transformer``
under data-parallel training: ``train_step(cfg, params, tokens,
comm_dp=COMM_WORLD, lr=...)`` on each rank thread.

The configuration file holds the published ``config.json`` keys of a
Mistral-style model (RMSNorm, rope, grouped-query attention with a sliding
window, SwiGLU); :func:`port_config` maps them onto ``TransformerConfig``.
"""

from __future__ import annotations

import math


def port_config(conf):
    from mpi4torch_tpu_torch.models.transformer import TransformerConfig

    if conf["hidden_act"] != "silu":
        raise ValueError(f"hidden_act {conf['hidden_act']!r}: the port's "
                         "gated FFN is SwiGLU (silu)")
    if conf["rms_norm_eps"] != 1e-5:
        raise ValueError(f"rms_norm_eps {conf['rms_norm_eps']}: the port's "
                         "RMSNorm uses 1e-5")
    if conf["tie_word_embeddings"]:
        raise ValueError("the port's embedding and head are separate")
    return TransformerConfig(
        vocab=conf["vocab_size"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"],
        n_layers=conf["num_hidden_layers"], d_ff=conf["intermediate_size"],
        max_seq=conf["max_position_embeddings"],
        n_kv_heads=conf["num_key_value_heads"],
        attn_window=conf["sliding_window"] or 0, rope=True,
        rope_theta=conf["rope_theta"], norm="rmsnorm", ffn="swiglu")


def _dims(conf):
    d = conf["hidden_size"]
    hd = d // conf["num_attention_heads"]
    return d, hd, conf["num_key_value_heads"] * hd, conf["intermediate_size"]


def param_specs(conf):
    """The port's layout (``init_transformer`` under rope, without the
    unused position table)."""
    d, hd, kv, ff = _dims(conf)
    vocab = conf["vocab_size"]
    specs = [(("embed",), (vocab, d), "normal", 0.02),
             (("ln_f", "scale"), (d,), "ones", 1.0),
             (("unembed",), (d, vocab), "normal", 1 / math.sqrt(d))]
    for i in range(conf["num_hidden_layers"]):
        blk = ("blocks", i)
        specs += [(blk + ("ln1", "scale"), (d,), "ones", 1.0),
                  (blk + ("wqkv",), (d, d + 2 * kv), "normal",
                   1 / math.sqrt(d)),
                  (blk + ("wo",), (d, d), "normal", 1 / math.sqrt(d)),
                  (blk + ("ln2", "scale"), (d,), "ones", 1.0),
                  (blk + ("w1",), (d, 2 * ff), "normal", 1 / math.sqrt(d)),
                  (blk + ("w2",), (ff, d), "normal", 1 / math.sqrt(ff))]
    return specs


def make_inputs(conf, traffic, generator, device, n_steps):
    """Token ids uniform over the vocabulary: ``(n_steps, ranks, rows,
    seq_len)`` int64."""
    import torch

    shape = (n_steps, traffic["ranks"], traffic["rows_per_rank"],
             traffic["seq_len"])
    return torch.randint(0, conf["vocab_size"], shape, generator=generator,
                         device=device)


def batch(inputs, step, rank):
    return inputs[step, rank]


def train_step(comm, cfg, params, tokens, lr):
    from mpi4torch_tpu_torch.models import transformer as T

    return T.train_step(cfg, params, tokens, comm_dp=comm, lr=lr)


def work(conf, traffic):
    return {"tokens": traffic["ranks"] * traffic["rows_per_rank"]
            * traffic["seq_len"]}


def matmul_params(conf):
    """Parameters that enter a matrix product a token (the embedding is a
    lookup)."""
    d, hd, kv, ff = _dims(conf)
    per_layer = d * (d + 2 * kv) + d * d + d * 2 * ff + ff * d
    return conf["num_hidden_layers"] * per_layer + d * conf["vocab_size"]


def attention_calls(conf, traffic):
    d, hd, kv, ff = _dims(conf)
    return [{"b": traffic["rows_per_rank"], "sq": traffic["seq_len"],
             "sk": traffic["seq_len"], "h": conf["num_attention_heads"],
             "h_kv": conf["num_key_value_heads"], "d": hd, "causal": True,
             "window": conf["sliding_window"] or 0,
             "count": traffic["ranks"] * conf["num_hidden_layers"]}]


def model_flops(conf, traffic):
    """6 x matmul parameters x tokens, plus attention forward (4 d a pair
    and head) and backward (8 d), with the causal and window masks."""
    from ..bounds import flash_attention as FA

    tokens = work(conf, traffic)["tokens"]
    attn = sum(3 * FA.operations(c, "fwd") * c["count"]
               for c in attention_calls(conf, traffic))
    return 6.0 * matmul_params(conf) * tokens + attn
