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

The dropless top-k form (:func:`moe_topk_ffn`, the port's own: the JAX
package has only the top-1 form, which stays for its parity tests) is the
routing of today's large open MoE models: a float32 softmax router, the
``k`` most probable experts a token with their gates renormalised to sum
to 1, SwiGLU experts without biases, and no token dropped.  Each rank
holds only its ``E / size`` experts' leaves; the assignments are sorted
by expert, the per-expert counts exchanged (one ``Allgather``, read on the
host to size the exchange), and each assignment's row travels to its
expert's rank and back through :func:`~mpi4torch_tpu_torch.ops.ragged.
ragged_alltoall`::

    tokens (T, d) --softmax top-k--> (T, k) experts and gates
    assignments sorted by expert -> send (size, cap, d)  [cap: the largest
        count any rank sends any rank]
    ragged Alltoall --> rows from every rank, regrouped expert by expert
    grouped products (ops/grouped.py): one launch a projection and
        direction for all the experts held
    ragged Alltoall back --> (T, k, d) --gates--> (T, d)

The stages are the profiler ranges ``mpi4torch.moe.route``,
``.dispatch``, ``.experts`` and ``.combine``, and a forward's counts go
to ``obs.record_moe``, both only while a tracer is installed.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as _config
from ..obs.metrics import record_moe
from ..obs.trace import moe_range
from ..ops.grouped import group_ends, grouped_mm
from ..ops.ragged import ragged_alltoall
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


# ------------------------------------------------- dropless top-k MoE


def topk_route(router_logits, k: int):
    """Softmax routing with renormalised top-k gates (``norm_topk_prob``):
    the probabilities over every expert in float32, each token's ``k``
    largest, divided by their sum.  Returns ``(experts, gates)``, ``(T,
    k)`` int64 and float32; every token keeps all ``k`` assignments."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    top, experts = torch.topk(probs, k, dim=-1)
    return experts, top / top.sum(dim=-1, keepdim=True)


def init_moe_topk(generator, n_experts: int, d_model: int, d_ff: int,
                  dtype: torch.dtype = torch.float32, device=None
                  ) -> Dict[str, Any]:
    """Parameters of a top-k SwiGLU MoE FFN, every expert stacked on axis
    0: ``router`` ``(d, E)`` and ``w1`` ``(E, d, 2 f)`` (gate | up, fused)
    normal over ``sqrt(d)``, ``w2`` ``(E, f, d)`` normal over
    ``sqrt(f)``; no biases.  Draws go router, w1, w2.  A rank of an
    expert-parallel world keeps its :func:`expert_shard`."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev)

    return {"router": normal(d_model, n_experts) / math.sqrt(d_model),
            "w1": normal(n_experts, d_model, 2 * d_ff) / math.sqrt(d_model),
            "w2": normal(n_experts, d_ff, d_model) / math.sqrt(d_ff)}


def expert_shard(comm, params: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's part of a whole :func:`init_moe_topk` dictionary: the
    router whole, ``w1`` and ``w2`` cut to the rank's ``E / size``
    experts (rank-major) and copied, so that the rank holds only them."""
    return {"router": params["router"],
            "w1": shard_axis(comm, params["w1"], 0).clone(),
            "w2": shard_axis(comm, params["w2"], 0).clone()}


class _Dispatch(torch.autograd.Function):
    """The send buffer's rows from the tokens: slot ``j`` holds token
    ``tok_of_slot[j]`` (index ``T``, a zero row, for the padding).  The
    backward gathers each token's ``k`` slot gradients and sums them in
    one reduction (float32 inside, one rounding), with no atomics."""

    @staticmethod
    def forward(ctx, x, tok_of_slot, slot_tm, k):
        ctx.save_for_backward(slot_tm)
        ctx.k, ctx.T = k, x.shape[0]
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        return xp.index_select(0, tok_of_slot)

    @staticmethod
    def backward(ctx, g):
        slot_tm, = ctx.saved_tensors
        gx = g.index_select(0, slot_tm).view(ctx.T, ctx.k, -1).sum(dim=1)
        return gx, None, None, None


class _Rows(torch.autograd.Function):
    """``x.index_select(0, idx)`` for an ``idx`` without repeats; the
    backward writes each row's gradient back to its row (an
    ``index_copy_`` into zeros) with no atomics."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return g.new_zeros((ctx.n,) + tuple(g.shape[1:])).index_copy_(
            0, idx, g), None


def _exchange_plan(C: np.ndarray, rank: int, size: int, epr: int):
    """The host side of one dispatch, from every rank's per-expert counts
    ``C`` ``(size, E)``: ``cap`` (the largest count any rank sends any
    rank), ``send[r]`` / ``recv[s]`` (rows to rank ``r``, from rank
    ``s``), ``groups[j]`` (rows of this rank's ``j``-th expert, over
    every source) and ``gather`` (the received buffer's rows, ``s * cap``
    + offset, in expert-major order: expert ``j``'s rows from rank 0,
    then rank 1, ...)."""
    M = C.reshape(size, size, epr).sum(axis=-1)   # M[s, r]: s sends r
    cap = int(M.max())
    mine = C[:, rank * epr:(rank + 1) * epr]      # (size, epr)
    off = np.cumsum(mine, axis=1) - mine          # within each source
    starts = (np.arange(size)[:, None] * cap + off).T.reshape(-1)
    lens = mine.T.reshape(-1)
    firsts = np.cumsum(lens) - lens
    gather = np.arange(int(lens.sum()), dtype=np.int64) + \
        np.repeat(starts - firsts, lens)
    return cap, M[rank], M[:, rank], mine.sum(axis=0), gather


def moe_topk_ffn(comm, x, params: Dict[str, Any], k: int, layer: int = 0):
    """The dropless top-k SwiGLU MoE FFN of this rank's tokens ``x``
    ``(T, d)``, expert-parallel over ``comm`` (None, or size 1: every
    expert local).  ``params``: ``router`` ``(d, E)`` (replicated) and
    this rank's experts ``w1`` ``(E / size, d, 2 f)``, ``w2`` ``(E /
    size, f, d)`` (:func:`expert_shard`).  Returns ``y`` ``(T, d)``,
    ``y[t] = sum_e g_te * W2_e (silu(x_t W1g_e) * (x_t W1u_e))`` over the
    token's ``k`` experts.  Differentiable: every expert leaf's gradient
    (over every rank's tokens) returns over the reverse exchanges.
    ``layer`` labels the counters."""
    T, d = x.shape
    router, w1, w2 = params["router"], params["w1"], params["w2"]
    E = router.shape[1]
    size = comm.size if comm is not None else 1
    rank = comm.rank if size > 1 else 0
    epr = w1.shape[0]
    if epr * size != E:
        raise ValueError(f"{epr} experts a rank over {size} ranks, for a "
                         f"router over {E}")
    dev = x.device
    with moe_range("route"):
        experts, gates = topk_route(x @ router, k)
        flat = experts.reshape(-1)
        counts = torch.bincount(flat, minlength=E)
        order = torch.argsort(flat, stable=True)
    with moe_range("dispatch"):
        allc = (comm.Allgather(counts[None], gatheraxis=0) if size > 1
                else counts[None])
        C = allc.cpu().numpy()
        cap, send, recv, groups, gather = _exchange_plan(C, rank, size, epr)
        n = flat.shape[0]
        send_dev = counts.view(size, epr).sum(dim=1)
        send_off = torch.cumsum(send_dev, 0) - send_dev
        dst = flat.index_select(0, order) // epr
        pos = torch.arange(n, device=dev)
        slot_tm = torch.empty_like(pos).scatter_(
            0, order, dst * cap + pos - send_off.index_select(0, dst))
        tok_of_slot = torch.full((size * cap,), T, dtype=torch.int64,
                                 device=dev).scatter_(0, slot_tm, pos // k)
        buf = _Dispatch.apply(x, tok_of_slot, slot_tm, k).view(size, cap, d)
        if size > 1:
            buf, _ = ragged_alltoall(comm, buf, send.tolist(),
                                     recv_counts=recv.tolist())
        gather = torch.from_numpy(gather).to(dev)
        xin = _Rows.apply(buf.reshape(size * cap, d), gather)
    with moe_range("experts"):
        groups = groups.tolist()
        ends = group_ends(groups, dev)
        gate, up = grouped_mm(xin, w1, groups, ends).chunk(2, dim=-1)
        yout = grouped_mm(F.silu(gate) * up, w2, groups, ends)
    with moe_range("combine"):
        back = yout.new_zeros(size * cap, d).index_copy_(0, gather, yout)
        back = back.view(size, cap, d)
        if size > 1:
            back, _ = ragged_alltoall(comm, back, recv.tolist(),
                                      recv_counts=send.tolist())
        out = _Rows.apply(back.reshape(size * cap, d), slot_tm)
        y = torch.bmm(gates.to(x.dtype)[:, None, :], out.view(T, k, d))
    if _config.comm_tracer() is not None:
        load = C.sum(axis=0)
        record_moe(layer, int(gather.shape[0]),
                   int(send.sum() - send[rank]),
                   float(load.max() / load.mean()))
    return y[:, 0]


def moe_topk_ffn_dense(x, params: Dict[str, Any], k: int):
    """Single-device oracle of :func:`moe_topk_ffn` with every expert
    local: the same routing and gates, every expert computed on every
    token, and the gates applied as a dense ``(T, E)`` matrix that is
    zero off each token's ``k`` experts."""
    experts, gates = topk_route(x @ params["router"], k)
    dense = torch.zeros(x.shape[0], params["router"].shape[1],
                        dtype=gates.dtype, device=x.device)
    dense = dense.scatter(1, experts, gates).to(x.dtype)
    gate, up = torch.einsum("td,edf->etf", x, params["w1"]).chunk(2, dim=-1)
    out = torch.einsum("etf,efd->etd", F.silu(gate) * up, params["w2"])
    return torch.einsum("te,etd->td", dense, out)
