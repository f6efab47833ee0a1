"""Cross-step error feedback for the compressed gradient Allreduce.

Port of ``mpi4torch_tpu/compress/ef.py``: carry the residual across
optimizer steps (EF-SGD) so each step pays single-round q8 wire while the
error it did not transmit joins the next step's gradient::

    resid = ef_init(grads)
    for step in range(n_steps):
        grads = grad_fn(params)
        synced, resid = ef_allreduce(comm, grads, resid, compression="q8")
        params = update(params, synced)

``q8``'s residual is exact: hop 0 of the quantized ring requantizes each
rank's contribution with the codec's own block layout and scales, so
``base.roundtrip`` reproduces what this rank put on the wire.
``q8_ef_hop`` carries a zero residual (its hops already feed their
residuals forward, and its rounding is unbiased).
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .codecs import get_codec

__all__ = ["ef_init", "ef_allreduce"]


def ef_init(tree):
    """Zero residual state shaped like ``tree`` (same dtypes)."""
    return tree_map(torch.zeros_like, tree)


def ef_allreduce(comm, tree, residual, op: int = C.MPI_SUM,
                 compression="q8"):
    """Error-compensated compressed Allreduce over a gradient tree.

    Each leaf is corrected by its carried residual, summed across ranks
    through ``comm.Allreduce(..., compression=...)`` (one collective per
    leaf, in traversal order), and the new residual — what this rank's
    codec failed to transmit — is returned for the next call.  A
    multi-round codec (``q8_ef``) is reduced to its single-round base:
    cross-step feedback replaces in-call feedback.  Returns
    ``(synced_tree, new_residual)``."""
    codec = get_codec(compression)
    if codec is None:
        synced = tree_map(lambda g: comm.Allreduce(g, op, compression=False),
                          tree)
        return synced, residual
    base = codec.base()
    synced, resid = [], []
    for g, r in zip(tree_leaves(tree), tree_leaves(residual)):
        corrected = g + r.to(g.dtype)
        synced.append(comm.Allreduce(corrected, op, compression=base))
        if base.stochastic:
            new_r = torch.zeros_like(corrected)
        else:
            new_r = corrected - base.roundtrip(corrected)
        resid.append(new_r.to(r.dtype))
    return tree_unflatten(tree, synced), tree_unflatten(residual, resid)
