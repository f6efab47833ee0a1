"""Hot-spare ranks: replicated state slices for zero-reshard takeover.

Port of ``mpi4torch_tpu/elastic/spare.py``.

A spare is a world member that computes no gradients but RIDES the
training step's existing collectives, keeping a full replica of the
sharded state current at zero extra wire bytes: on the rendezvous every
collective already delivers each rank the material it needs (an
``Allreduce`` hands every member the full fold), so the spare's mirror
is local post-processing of traffic the data ranks exchange anyway.
When a data rank dies, the spare promotes into its deal slot by SLICING
its mirror — no reshard plan, no wire, no checkpoint rewind.  Without a
spare, recovery falls back to the planned resharding of :mod:`.replan`.

Conventions:

* a spare world has ``n_data`` data ranks at positions ``0..n_data-1``
  and the spares ABOVE them — the deal width is ``n_data``, decoupled
  from the world size, which is what makes same-width takeover
  possible;
* data ranks keep shard-sized state (``slot = position``); spares keep
  the full mirror (``slot = None``) and pay replicated-state memory;
* spares contribute ZEROS to the gradient collectives, so they are
  arithmetically invisible under SUM reduction while completing every
  rendezvous.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..constants import MPI_SUM
from ..utils.tree import tree_map
from .membership import ElasticError

__all__ = [
    "is_spare",
    "zero_spare_init",
    "zero_spare_step",
    "takeover_shard",
    "bank_spare_step",
    "takeover_bank_slot",
]


def is_spare(position: int, n_data: int) -> bool:
    return position >= n_data


def _numel(x) -> int:
    shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
    return int(np.prod(shape)) if shape else 1


def _flat_pad(x, n_data: int):
    flat = torch.as_tensor(x).reshape(-1)
    per = -(-flat.shape[0] // n_data)
    return torch.nn.functional.pad(flat, (0, per * n_data - flat.shape[0])), \
        per


def _seg(flat, per: int, slot: int):
    return flat[slot * per:(slot + 1) * per]


def zero_spare_init(opt, params, n_data: int, slot: Optional[int]):
    """Optimizer state for a spare-capable ZeRO world: data rank
    ``slot`` inits on its ``1/n_data`` flat segment, a spare
    (``slot=None``) on the FULL padded flat view — elementwise
    optimizers keep the mirror's segment ``s`` bitwise identical to
    data rank ``s``'s state forever after."""

    def view(p):
        flat, per = _flat_pad(p, n_data)
        return flat if slot is None else _seg(flat, per, slot)

    return opt.init(tree_map(view, params))


def zero_spare_step(comm, opt, params, local_grads, opt_state, *,
                    n_data: int, slot: Optional[int], slots=None):
    """One spare-capable ZeRO step; every world member (data ranks AND
    spares) calls it collectively.  Returns ``(new_params,
    new_opt_state)`` — parameters fully replicated (as in ZeRO-1), the
    optimizer state shard-sized on data ranks and full on spares.

    ``slot`` is THIS rank's data deal slot (``None`` for a mirror);
    ``slots`` maps every world position to its slot (``None`` for
    spares) — required once takeover has permuted slots relative to
    world positions; the default is the identity convention.

    Wire per step: ONE summed gradient all-reduce (spares contribute
    zeros) + ONE segment all-gather of the updated parameters (spares
    contribute an inert zeros segment, discarded by slot bookkeeping) a
    leaf."""
    size = comm.size
    if not (0 < n_data <= size):
        raise ElasticError(
            f"n_data must be in 1..world size ({size}); got {n_data}")
    if slot is not None and not (0 <= slot < n_data):
        raise ElasticError(
            f"data slot must be in 0..{n_data - 1}; got {slot}")
    if slots is None:
        slots = tuple(p if p < n_data else None for p in range(size))
    slots = tuple(slots)
    if len(slots) != size or sorted(
            s for s in slots if s is not None) != list(range(n_data)):
        raise ElasticError(
            f"slots must map the {size} world positions onto data "
            f"slots 0..{n_data - 1} (spares None); got {slots}")
    pos_of_slot = {s: p for p, s in enumerate(slots) if s is not None}

    # Wire 1: the full global gradient on every member, compression off —
    # the mirror must hold the exact bits the owners hold.
    g_full = tree_map(
        lambda g: comm.Allreduce(torch.as_tensor(g), MPI_SUM,
                                 compression=False),
        local_grads)

    def view(x):
        flat, per = _flat_pad(x, n_data)
        return flat if slot is None else _seg(flat, per, slot)

    p_view = tree_map(view, params)
    g_view = tree_map(view, g_full)
    updates, new_state = opt.update(g_view, opt_state, p_view)
    p_view = tree_map(torch.add, p_view, updates)

    # Wire 2: segment all-gather back to full replicated parameters.
    # Every member contributes a segment-shaped buffer (spares: zeros),
    # so the collective signature is uniform across the world.
    def gather_leaf(pv, tmpl):
        n = _numel(tmpl)
        per = -(-n // n_data)
        contrib = pv if slot is not None else torch.zeros(
            (per,), dtype=pv.dtype, device=pv.device)
        full = comm.Allgather(contrib, 0, compression=False)
        # Reassemble in SLOT order: takeover may have permuted who serves
        # which slot.
        flat = torch.cat([
            full[pos_of_slot[s] * per:(pos_of_slot[s] + 1) * per]
            for s in range(n_data)])
        shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") \
            else np.shape(tmpl)
        return flat[:n].reshape(shape)

    # The gathered copy is the source of truth for everyone; on a spare
    # it is bitwise the segments of its own full update.
    new_params = tree_map(gather_leaf, p_view, params)
    return new_params, new_state


def takeover_shard(full_state, slot: int, n_data: int, template):
    """Zero-reshard takeover: slice data slot ``slot``'s shard out of a
    spare's FULL mirror state — the promoted spare's state in the new
    world, bitwise what the dead rank held.  ``template`` gives each
    leaf's global shape (as for :func:`.replan.replan_zero`)."""

    def one(full_flat, tmpl):
        per = -(-_numel(tmpl) // n_data)
        return _seg(full_flat, per, slot)

    return tree_map(one, full_state, template)


# ---------------------------------------------------------------------------
# Dense / TP bank mirror: the same discipline for axis-0-sharded state.
# ---------------------------------------------------------------------------


def bank_spare_step(comm, bank, delta, *, n_data: int,
                    slot: Optional[int]):
    """One update of an axis-0-sharded parameter bank with a spare
    mirror: every member contributes its (zero-padded, full-shaped)
    ``delta`` to ONE summed all-reduce; data rank ``slot`` applies its
    axis-0 slice, a spare applies the whole thing to its full replica.
    Returns the updated shard (data) or full bank (spare)."""
    dev = comm.device
    d = comm.Allreduce(torch.as_tensor(delta, device=dev), MPI_SUM,
                       compression=False)
    bank = torch.as_tensor(bank, device=dev)
    if slot is None:
        return bank + d
    n_units = d.shape[0]
    if n_units % n_data:
        raise ElasticError(
            f"bank axis 0 ({n_units}) must divide by n_data ({n_data})")
    per = n_units // n_data
    return bank + d[slot * per:(slot + 1) * per]


def takeover_bank_slot(full_bank, slot: int, n_data: int):
    """Slice data slot ``slot``'s axis-0 shard from a spare's full bank
    replica (the dense analogue of :func:`takeover_shard`)."""
    bank = torch.as_tensor(full_bank)
    per = bank.shape[0] // n_data
    return bank[slot * per:(slot + 1) * per]
