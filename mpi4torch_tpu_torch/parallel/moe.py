"""Expert parallelism: capacity-based MoE dispatch over ``Alltoall``.

Port of ``mpi4torch_tpu/parallel/moe.py``.  Top-1 routing with a fixed
per-expert ``capacity`` (tokens beyond it are dropped and contribute
zero; the caller's residual carries them), in the one-hot form of the
JAX package: the ``(T, E, C)`` dispatch and combine masks hold the
ragged structure, so which tokens are dropped and which slots a bias
reaches are the JAX package's.  Slots are counted in integers, where the
JAX package counts in the router's dtype: in bf16, past the 256th token
of an expert, its tokens share slots and its capacity never binds.

Layout (experts rank-major: expert ``e`` lives on rank ``e // epr``)::

    tokens (T, d) --top-1 router--> dispatch one-hot (T, E, C)
    send   (size, epr*C, d)  --Alltoall(ga=1, sa=0)-->  slots from all ranks
    expert FFN on (epr, size*C, d)   (batched matmuls)
    the same Alltoall back --combine--> (T, d)

Both transports are the differentiable ``Alltoall``, so gradients reach
the expert weights over the reverse exchange.  The dispatch/combine
products and the expert matmuls are plain large products, as in the JAX
package (no Pallas kernel computes them there).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..runtime import resolve_device
from ..utils.tree import tree_map
from .tp import shard_axis


def _gelu(x):
    # jax.nn.gelu's default, the tanh form.
    return F.gelu(x, approximate="tanh")


def top1_route(router_logits, capacity: int):
    """Switch-style top-1 routing with a per-expert capacity.

    Returns ``(dispatch, combine, aux)``: the ``(T, E, C)`` one-hot
    dispatch mask (token t occupies slot c of expert e, slots filled in
    token order), the same mask scaled by the router probability, and the
    load-balancing loss ``E * sum_e f_e * P_e`` (1 at perfect balance)."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)                     # (T,), first max
    gate = probs.amax(dim=-1)                                # (T,)
    hot = F.one_hot(expert, E)                               # (T, E) int64
    onehot = hot.to(probs.dtype)
    # Slot of each token within its expert's buffer, in token order,
    # counted in integers: a bf16 count cannot hold 257.
    pos = (torch.cumsum(hot, dim=0) * hot).sum(dim=-1) - 1   # (T,)
    keep = pos < capacity
    slot = F.one_hot(pos.clamp(0, capacity - 1),
                     capacity).to(probs.dtype)               # (T, C)
    dispatch = (onehot[:, :, None] * slot[:, None, :]
                * keep[:, None, None].to(probs.dtype))       # (T, E, C)
    combine = dispatch * gate[:, None, None]
    frac = onehot.mean(dim=0)                                # f_e
    mean_prob = probs.mean(dim=0)                            # P_e
    aux = E * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def init_moe(generator, n_experts: int, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32, device=None
             ) -> Dict[str, Any]:
    """Replicated parameters of a MoE FFN with stacked expert weights
    (experts on axis 0, rank-major), with the JAX package's shapes and
    scalings: ``gate`` ``(d, E)`` and ``w1`` ``(E, d, f)`` normal over
    ``sqrt(d)``, ``w2`` ``(E, f, d)`` normal over ``sqrt(f)``, zero
    biases.  ``generator`` is a ``torch.Generator`` on ``device`` or an
    integer seed; draws go gate, w1, w2 (the JAX key order)."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev)

    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(d_ff)
    return {
        "gate": normal(d_model, n_experts) * scale_in,
        "w1": normal(n_experts, d_model, d_ff) * scale_in,
        "b1": torch.zeros((n_experts, d_ff), dtype=dtype, device=dev),
        "w2": normal(n_experts, d_ff, d_model) * scale_out,
        "b2": torch.zeros((n_experts, d_model), dtype=dtype, device=dev),
    }


def moe_ffn(comm, x, params: Dict[str, Any], capacity: int,
            activation=_gelu):
    """Expert-parallel MoE FFN layer.

    ``x`` is this rank's ``(T, d)`` token shard; ``params`` the replicated
    stacked-expert dictionary of :func:`init_moe` (each rank computes
    only its ``n_experts / size`` experts, on slots from every rank).
    Returns ``(y, aux)``: ``y[t]`` is the gated expert output (zeros for
    dropped tokens) and ``aux`` the load-balancing loss."""
    size = comm.size
    T, d = x.shape
    E = params["gate"].shape[1]
    if E % size != 0:
        raise ValueError(
            f"n_experts ({E}) not divisible by world size ({size})")
    epr = E // size
    C = capacity

    dispatch, combine, aux = top1_route(x @ params["gate"], C)
    send = torch.einsum("td,tec->ecd", x, dispatch).reshape(size, epr * C,
                                                            d)
    if size > 1:
        # Rank s keeps row s of every source: its experts' slot buffers.
        recv = comm.Alltoall(send, gatheraxis=1, scatteraxis=0, numelem=1)
        recv = recv.reshape(size, epr, C, d).permute(1, 0, 2, 3)
    else:
        recv = send.reshape(1, epr, C, d).permute(1, 0, 2, 3)
    xin = recv.reshape(epr, size * C, d)

    w1 = shard_axis(comm, params["w1"], 0)
    b1 = shard_axis(comm, params["b1"], 0)
    w2 = shard_axis(comm, params["w2"], 0)
    b2 = shard_axis(comm, params["b2"], 0)
    h = activation(torch.einsum("esd,edf->esf", xin, w1) + b1[:, None, :])
    yout = torch.einsum("esf,efd->esd", h, w2) + b2[:, None, :]

    # The same exchange returns each slot's output to its token's owner.
    back = yout.reshape(epr, size, C, d).permute(1, 0, 2, 3)
    back = back.reshape(size, epr * C, d)
    if size > 1:
        mine = comm.Alltoall(back, gatheraxis=1, scatteraxis=0, numelem=1)
        mine = mine.reshape(E, C, d)
    else:
        mine = back.reshape(E, C, d)
    # Empty slots carry b2 after the expert FFN; combine's zero rows keep
    # it from every token.
    y = torch.einsum("ecd,tec->td", mine, combine)
    return y, aux


def balanced_assignment(loads, size: int):
    """A load-balancing expert assignment with equal per-rank counts:
    experts sorted by observed load (descending, stable) and dealt to the
    ranks in snake order, so each rank gets ``E / size`` experts.
    Returns the permutation ``perm`` of :func:`rebalance_experts`: new
    global slot ``u`` (owner ``u // epr``) holds old expert ``perm[u]``."""
    loads = [float(x) for x in torch.as_tensor(loads).reshape(-1).tolist()]
    E = len(loads)
    if E % size:
        raise ValueError(
            f"n_experts ({E}) not divisible by world size ({size})")
    epr = E // size
    order = sorted(range(E), key=lambda e: -loads[e])
    slots = [[] for _ in range(size)]
    it = iter(order)
    for k in range(epr):
        ranks = range(size) if k % 2 == 0 else range(size - 1, -1, -1)
        for r in ranks:
            slots[r].append(next(it))
    return tuple(e for r in range(size) for e in slots[r])


def rebalance_experts(comm, experts, assignment, strategy=None):
    """Move experts between ranks: ``experts`` is a tree of
    expert-stacked tensors whose axis 0 holds this rank's ``epr`` local
    experts (rank-major), and ``assignment`` a permutation of the ``E``
    global experts (e.g. from :func:`balanced_assignment`): new global
    slot ``u`` receives old expert ``assignment[u]``.

    Every leaf rides one block-permutation plan of
    :mod:`mpi4torch_tpu_torch.reshard` under ``strategy`` (``None`` is
    the process default, ``"auto"`` unless set), which never gathers
    (``"gather"`` cannot serve a permutation and raises).  The move is
    differentiable: the cotangents return over the inverse move."""
    from .. import reshard as _rs

    size = comm.size
    assignment = tuple(int(a) for a in assignment)
    E = len(assignment)
    if sorted(assignment) != list(range(E)):
        raise ValueError(f"assignment {assignment} is not a permutation of "
                         f"range({E})")
    if E % size:
        raise ValueError(
            f"n_experts ({E}) not divisible by world size ({size})")
    epr = E // size

    def one(x):
        if x.shape[0] != epr:
            raise ValueError(f"expert leaf holds {x.shape[0]} experts on "
                             f"axis 0; expected {epr} per rank")
        lay = _rs.Layout((size,), ((0,),) + ((),) * (x.dim() - 1))
        return _rs.reshard_blocks(comm, x, lay, 0, assignment,
                                  strategy=strategy)

    return tree_map(one, experts)


def moe_ffn_dense(x, params: Dict[str, Any], capacity: int,
                  activation=_gelu):
    """Single-device oracle with :func:`moe_ffn`'s routing and capacity
    semantics, all experts local.  Returns ``(y, aux)``."""
    dispatch, combine, aux = top1_route(x @ params["gate"], capacity)
    buf = torch.einsum("td,tec->ecd", x, dispatch)
    h = activation(torch.einsum("ecd,edf->ecf", buf, params["w1"])
                   + params["b1"][:, None, :])
    yout = torch.einsum("ecf,efd->ecd", h, params["w2"]) \
        + params["b2"][:, None, :]
    y = torch.einsum("ecd,tec->td", yout, combine)
    return y, aux
