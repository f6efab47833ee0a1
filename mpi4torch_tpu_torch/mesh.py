"""Rank <-> mesh-coordinate convention (port of ``mpi4torch_tpu/mesh.py``).

:func:`mesh_coords` and :func:`rank_of_coords` fix how a flat rank maps
onto a virtual mesh: row-major, the LAST mesh axis varying fastest.  The
reshard planner's layouts (:mod:`mpi4torch_tpu_torch.reshard`) key off
it, so a world of 8 rank threads reads as the ``(2, 4)`` mesh the same
way in both packages.

:func:`device_mesh` and :func:`hybrid_mesh` build the port's
:class:`Mesh` (axis names, sizes, the device of each rank and the
process that runs it) for ``run_spmd(mesh=...)`` and ``comm_from_mesh``.
One recorded difference from the JAX package: without ``devices=``
every rank of the mesh gets the world's one device, since rank threads
share a card.  Under ``init_distributed`` the default devices are the
global ranks', in process order, and :func:`hybrid_mesh`'s granules are
the processes.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "device_mesh", "hybrid_mesh", "mesh_coords",
           "rank_of_coords"]


def mesh_coords(rank: int, mesh_shape: Sequence[int]) -> tuple:
    """Row-major mesh coordinates of a flat rank: the last mesh axis
    varies fastest."""
    rank = int(rank)
    total = math.prod(mesh_shape)
    if not (0 <= rank < total):
        raise ValueError(f"rank {rank} out of range for mesh "
                         f"{tuple(mesh_shape)} ({total} ranks)")
    coords = []
    for m in reversed(tuple(mesh_shape)):
        coords.append(rank % m)
        rank //= m
    return tuple(reversed(coords))


def rank_of_coords(coords: Sequence[int], mesh_shape: Sequence[int]) -> int:
    """Inverse of :func:`mesh_coords`: the flat rank of row-major mesh
    coordinates."""
    coords, mesh_shape = tuple(coords), tuple(mesh_shape)
    if len(coords) != len(mesh_shape):
        raise ValueError(
            f"coords {coords} do not match mesh {mesh_shape}")
    r = 0
    for c, m in zip(coords, mesh_shape):
        if not (0 <= int(c) < m):
            raise ValueError(f"coords {coords} out of mesh {mesh_shape}")
        r = r * m + int(c)
    return r


class Mesh:
    """A named device mesh: ``axis_names`` (outermost first), ``shape``
    (axis name -> size), ``devices``, an object array of
    ``torch.device`` of that shape (row-major, the last axis fastest),
    and ``process_index``, an int array of the same shape naming the
    process that runs each position (the counterpart of JAX's
    ``device.process_index``; all 0 outside ``init_distributed``).  The
    port's counterpart of ``jax.sharding.Mesh``, for
    :func:`~mpi4torch_tpu_torch.ops.spmd.run_spmd` and
    :func:`~mpi4torch_tpu_torch.comm_from_mesh`."""

    def __init__(self, devices, axis_names: Sequence[str],
                 process_index=None):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"a {arr.ndim}-d device array for axis names "
                             f"{names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.axis_names = names
        self.devices = flat.reshape(arr.shape)
        self.shape = dict(zip(names, arr.shape))
        if process_index is None:
            process_index = np.zeros(arr.shape, dtype=np.int64)
        self.process_index = np.asarray(process_index,
                                        dtype=np.int64).reshape(arr.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices="
                f"{sorted({str(d) for d in self.devices.reshape(-1)})})")


def _check_sizes(shape: Mapping[str, int], n: int, what: str) -> None:
    total = math.prod(shape.values())
    if total != n:
        raise ValueError(
            f"{what} axis sizes {dict(shape)} multiply to {total}, but "
            f"{n} devices are available")


def _default_devices(n: int) -> list:
    """One device repeated for every rank: every rank of a mesh without
    ``devices=`` is a thread on the world's device (CUDA; the JAX package
    gives each rank its own device).  Under ``init_distributed`` a mesh
    covers the global ranks, each on its process's device (checked by
    the caller's size check)."""
    from . import distributed as _dist
    from .runtime import resolve_device
    lay = _dist.layout()
    if lay is None:
        return [resolve_device(None)] * n
    return [lay[2]] * sum(lay[1])


def _default_process_index(devices_given: bool, n: int):
    """Each position's process: the global ranks' under
    ``init_distributed`` when the devices were not given, else all 0."""
    from . import distributed as _dist
    if devices_given or _dist.layout() is None:
        return np.zeros(n, dtype=np.int64)
    return _dist.process_of_ranks()


def device_mesh(axes: Mapping[str, int], *,
                devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` over one host.

    ``axes`` maps axis name -> size, in significance order: the LAST axis
    varies fastest over the device order, so put the axis with the
    heaviest collective traffic (usually TP or SP) last and DP first.
    With ``devices=`` the sizes must multiply to their number (the JAX
    package's check); without, every rank gets the world's one device
    (rank threads share a card), a deliberate difference from the JAX
    package, which needs distinct devices.  Under ``init_distributed``
    the mesh covers the global ranks (the sizes must multiply to their
    count), each position on its process's device."""
    given = devices is not None
    if not given:
        devices = _default_devices(math.prod(axes.values()))
    _check_sizes(axes, len(devices), "device_mesh")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    shape = tuple(axes.values())
    procs = _default_process_index(given, len(devices))
    return Mesh(arr.reshape(shape), tuple(axes.keys()),
                process_index=procs.reshape(shape))


def hybrid_mesh(ici_axes: Mapping[str, int], dcn_axes: Mapping[str, int],
                *, devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` with explicit tier assignment: the ``dcn_axes``
    cross the slow tier (their total size must equal the number of
    granules), the ``ici_axes`` stay inside one.  The mesh carries the
    DCN axes first, then the ICI axes: ``hybrid_mesh({"tp": 4},
    {"dp": 2})`` has axis names ``("dp", "tp")``.

    The granules are the processes: rank threads of one process are one
    granule, and under ``init_distributed`` (without ``devices=``) each
    process is one.  On one granule every ``dcn_axes`` size must be 1 and
    the call degrades to :func:`device_mesh`, as the JAX package does on
    one slice.  On several, ``dcn_axes`` must multiply to their number
    and every process must hold one ICI block: then the global ranks, in
    process order, laid out row-major with the DCN axes first, keep each
    ICI block inside one process."""
    both = {**dcn_axes, **ici_axes}
    if len(both) != len(dcn_axes) + len(ici_axes):
        raise ValueError(
            f"axis names must be disjoint between tiers; got ICI "
            f"{tuple(ici_axes)} and DCN {tuple(dcn_axes)}")
    given = devices is not None
    if not given:
        devices = _default_devices(math.prod(both.values()))
    _check_sizes(both, len(devices), "hybrid_mesh")
    procs = _default_process_index(given, len(devices))
    n_granules = len(set(procs.tolist()))
    dcn_total = math.prod(dcn_axes.values())
    if n_granules == 1:
        if dcn_total != 1:
            raise ValueError(
                f"dcn axes {dict(dcn_axes)} require {dcn_total} "
                "slices/processes but all devices are in one granule — "
                "move those factors to ici_axes (single-slice) or launch "
                "multi-process (init_distributed)")
        return device_mesh(both, devices=devices)
    if dcn_total != n_granules:
        raise ValueError(
            f"dcn axes {dict(dcn_axes)} multiply to {dcn_total}, but the "
            f"devices span {n_granules} slices/granules")
    ici_total = math.prod(ici_axes.values())
    per = np.bincount(procs)
    if any(int(c) != ici_total for c in per):
        raise ValueError(
            f"ici axes {dict(ici_axes)} hold {ici_total} devices a "
            f"granule, but the processes hold {per.tolist()}")
    return device_mesh(both)
