"""Tensor parallelism: sharding helpers and the column/row-parallel
layers.

Port of ``mpi4torch_tpu/parallel/tp.py``: :func:`shard_axis` and
:func:`shard_heads` (this rank's equal, rank-major shard of a replicated
tensor, and the whole-head variant the serving layer cuts its q/k/v and
output-projection shards with), and the Megatron-style layers built on
the differentiable op table, whose backward communication is the ops'
adjoints:

* :func:`column_parallel_linear` — weight sharded on the output features,
  optionally ``Allgather``-ed back (adjoint: each rank keeps its slice);
* :func:`row_parallel_linear` — weight sharded on the input features,
  partial products summed by ``Allreduce`` (adjoint: the cotangent
  reaches every rank);
* :func:`tp_mlp` and :func:`tp_attention` — the column -> row pairings,
  one ``Allreduce`` forward and its adjoint backward.

Every collective here passes ``compression=False``: these are forward
activations, and a gradient-compression scope must not quantize them.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..constants import MPI_SUM


def shard_axis(comm, x, axis: int):
    """This rank's equal shard of ``x`` along ``axis`` (rank-major order).
    ``x`` must be replicated (every rank passes the same full tensor).
    The shard is a view of ``x``."""
    size = comm.size
    n = x.shape[axis]
    if n % size != 0:
        raise ValueError(
            f"axis {axis} length {n} not divisible by world size {size}")
    local = n // size
    return x.narrow(axis, comm.rank * local, local)


def shard_heads(comm, w, n_heads: int, axis: int = 1):
    """This rank's whole-head shard of a head-structured projection:
    ``w``'s ``axis`` holds ``n_heads`` contiguous equal head blocks, and
    the shard keeps ``n_heads / size`` whole heads, so per-head attention
    never crosses ranks."""
    size = comm.size
    n = w.shape[axis]
    if n_heads <= 0 or n % n_heads != 0:
        raise ValueError(
            f"axis {axis} length {n} is not a whole number of "
            f"{n_heads} head blocks")
    if n_heads % size != 0:
        raise ValueError(
            f"n_heads ({n_heads}) not divisible by world size ({size}) "
            "— tensor-parallel attention shards whole heads only")
    return shard_axis(comm, w, axis)


def _gelu(x):
    # jax.nn.gelu's default, the tanh form.
    return F.gelu(x, approximate="tanh")


def column_parallel_linear(comm, x, w_shard, b_shard=None,
                           gather_output: bool = True):
    """``y = x @ W + b`` with ``W`` sharded column-wise (output features).
    With ``gather_output`` the feature axis is reassembled with
    ``Allgather``; without it the output stays feature-sharded, ready for
    :func:`row_parallel_linear`."""
    y = x @ w_shard
    if b_shard is not None:
        y = y + b_shard
    if gather_output:
        y = comm.Allgather(y, gatheraxis=y.dim() - 1, compression=False)
    return y


def row_parallel_linear(comm, x_shard, w_shard, b=None,
                        reduce_output: bool = True):
    """``y = x @ W + b`` with ``W`` sharded row-wise (input features):
    the partial products are summed with ``Allreduce(SUM)``, and the
    replicated bias is added after the sum.  ``reduce_output=False``
    returns the partial sums and refuses a bias (a later Allreduce would
    count it ``size`` times)."""
    y = x_shard @ w_shard
    if reduce_output:
        y = comm.Allreduce(y, MPI_SUM, compression=False)
    elif b is not None:
        raise ValueError(
            "row_parallel_linear(reduce_output=False) cannot add a "
            "replicated bias to per-rank partial sums — a later "
            "Allreduce would count it size times; add b after reducing")
    if b is not None:
        y = y + b
    return y


def tp_mlp(comm, x, w1_shard, b1_shard, w2_shard, b2, activation=_gelu):
    """Tensor-parallel MLP: column(w1) -> activation -> row(w2), one
    ``Allreduce`` forward and one backward.  ``w1_shard`` is ``(d,
    f/size)``, ``w2_shard`` the matching ``(f/size, d)``; the default
    activation is tanh-form gelu (``jax.nn.gelu``'s)."""
    h = column_parallel_linear(comm, x, w1_shard, b1_shard,
                               gather_output=False)
    return row_parallel_linear(comm, activation(h), w2_shard, b2)


def tp_attention(comm, q_proj, k_proj, v_proj, o_proj, x, n_heads: int,
                 attention_fn=None, causal: bool = True):
    """Head-sharded (tensor-parallel) self-attention: column-parallel
    q/k/v projections (each rank owns ``n_heads / size`` whole heads),
    row-parallel output projection, one ``Allreduce`` per direction.
    ``x`` is ``(batch, seq, d_model)`` and replicated; ``q/k/v_proj`` are
    ``(d_model, d_model/size)`` shards and ``o_proj`` the matching
    ``(d_model/size, d_model)`` row shard.  ``attention_fn(q, k, v,
    causal=...)`` defaults to
    :func:`~mpi4torch_tpu_torch.parallel.attention.dense_attention`, as in
    the JAX package; ``ops.flash.flash_attention`` runs the kernels."""
    from .attention import dense_attention

    size = comm.size
    if n_heads % size != 0:
        raise ValueError(
            f"n_heads ({n_heads}) not divisible by world size ({size})")
    h_local = n_heads // size
    b, s, _ = x.shape
    if attention_fn is None:
        attention_fn = dense_attention

    def heads(t):
        return t.reshape(b, s, h_local, t.shape[-1] // h_local)

    q = heads(column_parallel_linear(comm, x, q_proj, gather_output=False))
    k = heads(column_parallel_linear(comm, x, k_proj, gather_output=False))
    v = heads(column_parallel_linear(comm, x, v_proj, gather_output=False))
    o = attention_fn(q, k, v, causal=causal)
    return row_parallel_linear(comm, o.reshape(b, s, -1), o_proj)
