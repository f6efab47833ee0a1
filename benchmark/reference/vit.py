"""Plain float32 reference of ViT-B/16 (Dosovitskiy et al., ICLR 2021,
arXiv:2010.11929) as the port builds it: patches embedded by one matrix,
learned positions, pre-LN blocks (LayerNorm eps 1e-5) of multi-head
attention and a GELU MLP (tanh form), a final LayerNorm, the mean over the
patch tokens (the port has no class token) and a linear head; the loss is
the mean softmax cross-entropy.  No matrix has a bias.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-5
# Images through the model at once, so that the float32 reference fits on
# the card at any batch.
ROWS_PER_CALL = 64


def n_rows(b):
    return b[0].shape[0]


def take_rows(b, lo, hi):
    return b[0][lo:hi], b[1][lo:hi]


def positions_per_row(b):
    return 1


def layer_norm(x, P, name):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * P[name + ("scale",)] + \
        P[name + ("bias",)]


def patchify(images, patch):
    """NHWC ``(n, hw, hw, c)`` -> ``(n, tokens, patch * patch * c)``:
    patches in raster order, each patch's pixels row-major, channels
    last."""
    n, hw, _, c = images.shape
    g = hw // patch
    x = images.reshape(n, g, patch, g, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, patch * patch * c)


def loss_sum(conf, P, rows, mm):
    images, labels = rows
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    hd = d // h
    x = mm(patchify(images.float(), conf["patch_size"]),
           P[("patch_proj",)]) + P[("pos",)]
    n, s, _ = x.shape
    for i in range(conf["num_hidden_layers"]):
        blk = ("blocks", i)
        y = layer_norm(x, P, blk + ("ln1",))
        q, k, v = mm(y, P[blk + ("wqkv",)]).reshape(n, s, 3, h,
                                                      hd).unbind(2)
        a = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k)
                          / math.sqrt(hd), dim=-1)
        o = torch.einsum("nhqk,nkhd->nqhd", a, v).reshape(n, s, d)
        x = x + mm(o, P[blk + ("wo",)])
        y = layer_norm(x, P, blk + ("ln2",))
        x = x + mm(F.gelu(mm(y, P[blk + ("w1",)]), approximate="tanh"),
                   P[blk + ("w2",)])
    pooled = layer_norm(x, P, ("ln_f",)).mean(dim=1)
    logits = mm(pooled, P[("head",)])
    return F.cross_entropy(logits, labels, reduction="sum")
