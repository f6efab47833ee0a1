"""Vision Transformer: the model zoo's non-causal attention family.

Port of ``mpi4torch_tpu/models/vit.py``: a pre-LN ViT with learned
positions and a mean-pool classification head.  Patches are embedded by
one matmul after :func:`patchify`, a reshape and permute.  Attention runs
through :func:`~mpi4torch_tpu_torch.ops.flash.flash_attention` with
``causal=False`` (on a CUDA device the hand-written kernels: bf16 at head
dim 64 takes the tensor-core ones), or, patch-parallel, through
:func:`~mpi4torch_tpu_torch.parallel.attention.ring_attention` with
``causal=False``.  The parameter tree keeps the JAX package's layout
(``(in, out)`` matrices used as ``x @ W``, the fused ``wqkv``), so
:func:`params_from_jax` carries its weights across unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..constants import MPI_SUM, divide
from ..ops.flash import flash_attention
from ..parallel.attention import ring_attention
from ..runtime import resolve_device
from ..obs.trace import step_phase
from ..utils.tree import tree_map, value_and_grad
from .transformer import _layer_norm
from .transformer import params_from_jax as _tree_from_jax


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_hw: int
    patch: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    num_classes: int
    channels: int = 3

    def __post_init__(self):
        if self.image_hw % self.patch != 0:
            raise ValueError(
                f"image_hw={self.image_hw} not divisible by "
                f"patch={self.patch}")
        if self.d_model % self.n_heads != 0:
            raise ValueError(
                f"d_model={self.d_model} not divisible by "
                f"n_heads={self.n_heads}")

    @property
    def n_patches(self) -> int:
        return (self.image_hw // self.patch) ** 2


def init_vit(generator, cfg: ViTConfig, dtype=torch.float32,
             device=None) -> Dict[str, Any]:
    """Parameter dictionary with the JAX package's shapes and scalings
    (matrices normal over ``sqrt(fan_in)``, positions normal at 0.02).
    ``generator`` is a ``torch.Generator`` on ``device`` or an integer
    seed; the numbers differ from the JAX package's."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev)

    def dense(m, n):
        return normal(m, n) / math.sqrt(m)

    def norm_p():
        return {"scale": torch.ones(cfg.d_model, dtype=dtype, device=dev),
                "bias": torch.zeros(cfg.d_model, dtype=dtype, device=dev)}

    pdim = cfg.patch * cfg.patch * cfg.channels
    params: Dict[str, Any] = {
        "patch_proj": dense(pdim, cfg.d_model),
        "pos": normal(cfg.n_patches, cfg.d_model) * 0.02,
        "ln_f": norm_p(),
        "head": dense(cfg.d_model, cfg.num_classes),
        "blocks": [],
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "ln1": norm_p(),
            "wqkv": dense(cfg.d_model, 3 * cfg.d_model),
            "wo": dense(cfg.d_model, cfg.d_model),
            "ln2": norm_p(),
            "w1": dense(cfg.d_model, cfg.d_ff),
            "w2": dense(cfg.d_ff, cfg.d_model),
        })
    return params


def params_from_jax(tree, device, dtype=None):
    """The port's parameters from a JAX ViT tree with numpy leaves: the
    same layout, each leaf a tensor on ``device`` (cast to ``dtype`` when
    given)."""
    return _tree_from_jax(tree, device, dtype)


def patchify(cfg: ViTConfig, images):
    """``(b, hw, hw, c) -> (b, n_patches, patch * patch * c)``, patches in
    raster order, each patch's pixels row-major with channels last."""
    b = images.shape[0]
    g, p, c = cfg.image_hw // cfg.patch, cfg.patch, cfg.channels
    x = images.reshape(b, g, p, g, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * c)


def forward(cfg: ViTConfig, params, images):
    """Logits ``(b, num_classes)`` of NHWC ``images`` on one device.  For
    patch parallelism shard the patchified input and call
    :func:`forward_patches` with ``comm_sp``."""
    return forward_patches(cfg, params, patchify(cfg, images))


def forward_patches(cfg: ViTConfig, params, patches, comm_sp=None,
                    patch_offset=None):
    """Forward from patchified input, optionally patch-sharded.

    With ``comm_sp`` (of size > 1) each rank holds the contiguous equal
    shard ``(b, n_patches / size, patch * patch * c)`` of one global patch
    sequence, in rank order; attention is non-causal ring attention over
    the shards, and the mean-pool closes with one exact ``Allreduce``.
    The shard's position rows start at ``comm_sp.rank * s_local`` unless
    ``patch_offset`` says otherwise."""
    sp = comm_sp is not None and comm_sp.size > 1
    pos = params["pos"]
    if sp:
        if patch_offset is None:
            patch_offset = comm_sp.rank * patches.shape[1]
        pos = pos.narrow(0, int(patch_offset), patches.shape[1])
    x = patches @ params["patch_proj"] + pos
    b, s, d = x.shape
    hd = d // cfg.n_heads
    for blk in params["blocks"]:
        y = _layer_norm(x, blk["ln1"])
        qkv = y @ blk["wqkv"]
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, s, cfg.n_heads, hd)
                   for i in range(3))
        if sp:
            att = ring_attention(comm_sp, q, k, v, causal=False)
        else:
            att = flash_attention(q, k, v, causal=False)
        x = x + att.reshape(b, s, d) @ blk["wo"]
        y = _layer_norm(x, blk["ln2"])
        x = x + F.gelu(y @ blk["w1"], approximate="tanh") @ blk["w2"]
    x = _layer_norm(x, params["ln_f"])
    pooled = x.mean(dim=1)
    if sp:
        # Mean over the whole patch axis = mean of the equal shards' means.
        # compression=False: a forward activation.
        pooled = divide(comm_sp.Allreduce(pooled, MPI_SUM,
                                          compression=False), comm_sp.size)
    return pooled @ params["head"]


def local_loss(cfg: ViTConfig, params, batch):
    """Mean softmax cross-entropy on the rank-local batch ``(images,
    labels)``."""
    images, labels = batch
    logp = F.log_softmax(forward(cfg, params, images), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def dp_grad_train_step(comm, cfg: ViTConfig, params, batch,
                       lr: float = 0.1):
    """One SGD step with the classic DDP recipe: local backward, then one
    ``Allreduce(g, MPI_SUM) / size`` per gradient.  Returns
    ``(global_loss, new_params)``."""
    loss, grads = value_and_grad(lambda p: local_loss(cfg, p, batch), params)
    size = comm.size
    with step_phase("exchange"):
        grads = tree_map(lambda g: divide(comm.Allreduce(g, MPI_SUM), size),
                         grads)
        global_loss = divide(comm.Allreduce(loss, MPI_SUM), size)
    with step_phase("update"), torch.no_grad():
        new_params = tree_map(lambda p, g: p - lr * g, params, grads)
    return global_loss, new_params
