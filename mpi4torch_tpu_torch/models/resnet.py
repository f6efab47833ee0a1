"""ResNet-18 (CIFAR variant) for data-parallel training.

Port of ``mpi4torch_tpu/models/resnet.py``, the model of BASELINE.md
config 4 ("Data-parallel ResNet-18/CIFAR-10, per-param-grad Allreduce"),
with both DP recipes:

* :func:`dp_grad_train_step` — the classic DDP recipe: local backward,
  then one ``Allreduce(grad, MPI_SUM) / size`` per parameter leaf;
* :func:`dp_loss_train_step` — the reference's own pattern: the
  parameter-averaging Allreduce inside the loss, the gradients from its
  adjoint.

The public functions take NHWC images, as the JAX package's do.
Internally the activations are NCHW tensors in the ``channels_last``
memory format (an NHWC image permuted to NCHW is one already, without a
copy), the layout cuDNN's convolutions prefer, and the filters are OIHW,
the layout ``F.conv2d`` takes; :func:`params_from_jax` carries the JAX
package's HWIO filters across.  The parameter and state trees keep the
JAX package's keys.

Two details follow XLA rather than torch's defaults.  ``SAME`` padding
puts the odd pixel of a strided convolution at the end (a 3x3 stride-2
convolution of an even input pads (0, 1), where ``padding=1`` would pad
(1, 1)), so such an asymmetric padding is applied with ``F.pad``.
BatchNorm is written out as the JAX package writes it — the biased
batch variance, and running statistics kept as ``m * old + (1 - m) *
new`` with ``m = bn_momentum`` — rather than ``F.batch_norm``, whose
momentum is the other way round and whose running variance is the
unbiased one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import MPI_SUM, divide
from ..runtime import resolve_device
from ..utils.tree import tree_map, value_and_grad


@dataclass(frozen=True)
class ResNetConfig:
    """CIFAR-style ResNet-18: 3x3 stem (no max-pool), 4 stages of 2 basic
    blocks at widths (64, 128, 256, 512), global average pool, linear
    head."""

    num_classes: int = 10
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5


def _block_stride(si: int, bi: int) -> int:
    """The first block of every stage after the first downsamples."""
    return 2 if (bi == 0 and si > 0) else 1


def init_resnet(generator, cfg: ResNetConfig, in_channels: int = 3,
                dtype=torch.float32, device=None):
    """Returns ``(params, state)``: the trainable leaves (OIHW filters
    normal over ``sqrt(fan_in / 2)``, BN affine, head) and the BN running
    statistics.  ``generator`` is a ``torch.Generator`` on ``device`` or
    an integer seed; draws follow the JAX package's order (stem, then per
    block conv1, conv2, proj, then the head), and the numbers differ from
    its, since the generators do."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)

    def conv(k, cin, cout):
        w = torch.randn((cout, cin, k, k), generator=generator, dtype=dtype,
                        device=dev)
        return w * math.sqrt(2.0 / (k * k * cin))

    def bn(c):
        return {"scale": torch.ones(c, dtype=dtype, device=dev),
                "bias": torch.zeros(c, dtype=dtype, device=dev)}

    def bn_state(c):
        return {"mean": torch.zeros(c, dtype=dtype, device=dev),
                "var": torch.ones(c, dtype=dtype, device=dev)}

    w0 = cfg.widths[0]
    params = {"stem": {"conv": conv(3, in_channels, w0), "bn": bn(w0)}}
    state = {"stem": {"bn": bn_state(w0)}}
    cin = w0
    stages, stages_state = [], []
    for si, (width, nblocks) in enumerate(zip(cfg.widths, cfg.stage_sizes)):
        blocks, blocks_state = [], []
        for bi in range(nblocks):
            block = {"conv1": conv(3, cin, width), "bn1": bn(width),
                     "conv2": conv(3, width, width), "bn2": bn(width)}
            bstate = {"bn1": bn_state(width), "bn2": bn_state(width)}
            if _block_stride(si, bi) != 1 or cin != width:
                block["proj"] = conv(1, cin, width)
                block["bn_proj"] = bn(width)
                bstate["bn_proj"] = bn_state(width)
            blocks.append(block)
            blocks_state.append(bstate)
            cin = width
        stages.append(blocks)
        stages_state.append(blocks_state)
    params["stages"] = stages
    state["stages"] = stages_state
    params["head"] = {
        "w": torch.randn((cin, cfg.num_classes), generator=generator,
                         dtype=dtype, device=dev) / math.sqrt(cin),
        "b": torch.zeros(cfg.num_classes, dtype=dtype, device=dev)}
    return params, state


def _tensor(a, device, dtype):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(params, state, device, dtype=None):
    """The port's ``(params, state)`` from the JAX package's trees with
    numpy leaves: the same keys, each leaf a tensor on ``device`` (cast to
    ``dtype`` when given), and every 4-d filter carried from HWIO to
    OIHW."""
    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [convert(v) for v in tree]
        t = _tensor(tree, device, dtype)
        return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t

    return convert(params), convert(state)


def _same_pads(n: int, k: int, stride: int):
    """XLA's ``SAME`` padding ``(lo, hi)`` of an axis of ``n`` for a window
    of ``k``: ``ceil(n / stride)`` outputs, the odd pixel at the end."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """``SAME`` convolution of NCHW ``x`` with the OIHW filter ``w``.  A
    symmetric padding rides the convolution's own; an asymmetric one (a
    strided convolution of an even input) is padded explicitly, keeping
    ``x``'s memory format."""
    (hl, hh), (wl, wh) = (_same_pads(x.shape[a], w.shape[a], stride)
                          for a in (2, 3))
    if hl == hh and wl == wh:
        return F.conv2d(x, w, stride=stride, padding=(hl, wl))
    fmt = torch.channels_last if x.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format
    x = F.pad(x, (wl, wh, hl, hh)).contiguous(memory_format=fmt)
    return F.conv2d(x, w, stride=stride)


def _batch_norm(x, p, s, cfg: ResNetConfig, train: bool):
    """BatchNorm over (N, H, W); returns ``(y, new_state)``.  In train mode
    the statistics are the local batch's (each DP rank normalises its own
    shard) and the running statistics move by ``bn_momentum``."""
    dims = (0, 2, 3)
    if train:
        mean = x.mean(dim=dims)
        var = ((x - mean[:, None, None]) ** 2).mean(dim=dims)
        m = cfg.bn_momentum
        new_s = {"mean": m * s["mean"] + (1 - m) * mean,
                 "var": m * s["var"] + (1 - m) * var}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + cfg.bn_eps)
    y = (x - mean[:, None, None]) * inv[:, None, None] \
        * p["scale"][:, None, None] + p["bias"][:, None, None]
    return y, new_s


def _basic_block(x, p, s, cfg, stride, train):
    y, s1 = _batch_norm(_conv(x, p["conv1"], stride), p["bn1"], s["bn1"],
                        cfg, train)
    y = F.relu(y)
    y, s2 = _batch_norm(_conv(y, p["conv2"]), p["bn2"], s["bn2"], cfg, train)
    new_s = {"bn1": s1, "bn2": s2}
    if "proj" in p:
        x, sp = _batch_norm(_conv(x, p["proj"], stride), p["bn_proj"],
                            s["bn_proj"], cfg, train)
        new_s["bn_proj"] = sp
    return F.relu(x + y), new_s


def forward(cfg: ResNetConfig, params, state, images, train: bool = True):
    """Logits for NHWC ``images``; returns ``(logits, new_state)``."""
    x = images.permute(0, 3, 1, 2)          # NCHW view, channels_last
    x, stem_s = _batch_norm(_conv(x, params["stem"]["conv"]),
                            params["stem"]["bn"], state["stem"]["bn"], cfg,
                            train)
    x = F.relu(x)
    new_state = {"stem": {"bn": stem_s}, "stages": []}
    for si, (blocks, bstates) in enumerate(zip(params["stages"],
                                               state["stages"])):
        stage_s = []
        for bi, (bp, bs) in enumerate(zip(blocks, bstates)):
            x, ns = _basic_block(x, bp, bs, cfg, _block_stride(si, bi),
                                 train)
            stage_s.append(ns)
        new_state["stages"].append(stage_s)
    x = x.mean(dim=(2, 3))
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, new_state


def local_loss(cfg: ResNetConfig, params, state, batch, train: bool = True):
    """Mean softmax cross-entropy on the rank-local batch ``(images,
    labels)``; returns ``(loss, new_state)``."""
    images, labels = batch
    logits, new_state = forward(cfg, params, state, images, train)
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return ce.mean(), new_state


def _average_state(comm, state):
    # compression=False: BN running statistics are carried state — codec
    # error would accumulate across steps.
    return tree_map(
        lambda s: divide(comm.Allreduce(s, MPI_SUM, compression=False),
                         comm.size), state)


def dp_grad_train_step(comm, cfg: ResNetConfig, params, state, batch,
                       lr: float = 0.1):
    """One SGD step with the classic DDP recipe (BASELINE.md config 4):
    local backward first, then one ``Allreduce(g, MPI_SUM) / size`` per
    parameter gradient, and the BN running statistics averaged the same
    way (exact wire).  Returns ``(global_loss, new_params,
    new_state)``."""
    (loss, new_state), grads = value_and_grad(
        lambda p: local_loss(cfg, p, state, batch), params, has_aux=True)
    size = comm.size
    grads = tree_map(lambda g: divide(comm.Allreduce(g, MPI_SUM), size),
                     grads)
    global_loss = divide(comm.Allreduce(loss, MPI_SUM), size)
    new_state = _average_state(comm, new_state)
    with torch.no_grad():
        new_params = tree_map(lambda p, g: p - lr * g, params, grads)
    return global_loss, new_params, new_state


def dp_loss_train_step(comm, cfg: ResNetConfig, params, state, batch,
                       lr: float = 0.1):
    """One SGD step with the reference's in-loss recipe: a
    parameter-averaging Allreduce per leaf and the loss Allreduce inside
    the differentiated function, so the gradients come from the adjoint
    Allreduce.  Returns ``(global_loss, new_params, new_state)``."""
    size = comm.size

    def global_loss_fn(p):
        p = tree_map(lambda t: divide(comm.Allreduce(t, MPI_SUM), size), p)
        loss, ns = local_loss(cfg, p, state, batch)
        return divide(comm.Allreduce(loss, MPI_SUM), size), ns

    (loss, new_state), grads = value_and_grad(global_loss_fn, params,
                                              has_aux=True)
    new_state = _average_state(comm, new_state)
    with torch.no_grad():
        new_params = tree_map(lambda p, g: p - lr * g, params, grads)
    return loss, new_params, new_state
