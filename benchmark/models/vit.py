"""The Vision Transformer of ``mpi4torch_tpu_torch.models.vit`` under
data-parallel training: ``dp_grad_train_step(COMM_WORLD, cfg, params,
(images, labels), lr=...)`` on each rank thread (a local backward, then one
``Allreduce`` per gradient)."""

from __future__ import annotations

import math


def port_config(conf):
    from mpi4torch_tpu_torch.models.vit import ViTConfig

    return ViTConfig(image_hw=conf["image_size"], patch=conf["patch_size"],
                     d_model=conf["hidden_size"],
                     n_heads=conf["num_attention_heads"],
                     n_layers=conf["num_hidden_layers"],
                     d_ff=conf["intermediate_size"],
                     num_classes=conf["num_labels"],
                     channels=conf["num_channels"])


def _tokens(conf):
    return (conf["image_size"] // conf["patch_size"]) ** 2


def param_specs(conf):
    """The port's layout (``init_vit``)."""
    d, ff = conf["hidden_size"], conf["intermediate_size"]
    pdim = conf["patch_size"] ** 2 * conf["num_channels"]
    specs = [(("patch_proj",), (pdim, d), "normal", 1 / math.sqrt(pdim)),
             (("pos",), (_tokens(conf), d), "normal", 0.02),
             (("ln_f", "scale"), (d,), "ones", 1.0),
             (("ln_f", "bias"), (d,), "zeros", 0.0),
             (("head",), (d, conf["num_labels"]), "normal",
              1 / math.sqrt(d))]
    for i in range(conf["num_hidden_layers"]):
        blk = ("blocks", i)
        specs += [(blk + ("ln1", "scale"), (d,), "ones", 1.0),
                  (blk + ("ln1", "bias"), (d,), "zeros", 0.0),
                  (blk + ("wqkv",), (d, 3 * d), "normal", 1 / math.sqrt(d)),
                  (blk + ("wo",), (d, d), "normal", 1 / math.sqrt(d)),
                  (blk + ("ln2", "scale"), (d,), "ones", 1.0),
                  (blk + ("ln2", "bias"), (d,), "zeros", 0.0),
                  (blk + ("w1",), (d, ff), "normal", 1 / math.sqrt(d)),
                  (blk + ("w2",), (ff, d), "normal", 1 / math.sqrt(ff))]
    return specs


def make_inputs(conf, traffic, generator, device, n_steps):
    """NHWC images of standard normal pixels in the model's dtype and
    labels uniform over the classes: ``(n_steps, ranks, rows, hw, hw, c)``
    and ``(n_steps, ranks, rows)``."""
    import torch

    hw, c = conf["image_size"], conf["num_channels"]
    lead = (n_steps, traffic["ranks"], traffic["rows_per_rank"])
    images = torch.randn(lead + (hw, hw, c), generator=generator,
                         device=device, dtype=torch.float32)
    labels = torch.randint(0, conf["num_labels"], lead, generator=generator,
                           device=device)
    return images.to(getattr(torch, conf["torch_dtype"])), labels


def batch(inputs, step, rank):
    images, labels = inputs
    return images[step, rank], labels[step, rank]


class LocalComm:
    """A world of one: what a rank's step sees with the exchange left
    out."""

    size, rank = 1, 0

    def Allreduce(self, x, op=None, **kw):
        return x


def train_step(comm, cfg, params, batch_, lr):
    from mpi4torch_tpu_torch.models import vit as V

    return V.dp_grad_train_step(comm if comm is not None else LocalComm(),
                                cfg, params, batch_, lr=lr)


def work(conf, traffic):
    return {"images": traffic["ranks"] * traffic["rows_per_rank"]}


def matmul_params(conf):
    """(parameters a patch token multiplies, parameters the pooled row
    multiplies)."""
    d, ff = conf["hidden_size"], conf["intermediate_size"]
    pdim = conf["patch_size"] ** 2 * conf["num_channels"]
    per_layer = d * 3 * d + d * d + 2 * d * ff
    return pdim * d + conf["num_hidden_layers"] * per_layer, \
        d * conf["num_labels"]


def attention_calls(conf, traffic):
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    s = _tokens(conf)
    return [{"b": traffic["rows_per_rank"], "sq": s, "sk": s, "h": h,
             "h_kv": h, "d": d // h, "causal": False, "window": 0,
             "count": traffic["ranks"] * conf["num_hidden_layers"]}]


def model_flops(conf, traffic):
    """6 x (token matmul parameters x tokens + head parameters x images),
    plus non-causal attention forward (4 d a pair and head) and backward
    (8 d)."""
    from ..bounds import flash_attention as FA

    images = work(conf, traffic)["images"]
    per_token, head = matmul_params(conf)
    attn = sum(3 * FA.operations(c, "fwd") * c["count"]
               for c in attention_calls(conf, traffic))
    return 6.0 * (per_token * _tokens(conf) + head) * images + attn
