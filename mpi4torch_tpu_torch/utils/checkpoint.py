"""Training-state checkpoint and resume, in the port's own format.

Port of ``mpi4torch_tpu/utils/checkpoint.py`` with its names
(:func:`save_checkpoint`, :func:`restore_checkpoint`,
:func:`restore_resharded`, :func:`saved_epoch`,
:class:`CheckpointManager`).  The JAX package writes through orbax; the
port writes a directory of its own with torch and the standard library:

* ``manifest.json`` — the format tag, the elastic world epoch (or null),
  and per leaf its tree path (``blocks/0/wo``, in the tree's traversal
  order), shape, dtype (named as the JAX package names it), byte offset
  and byte count in the data file, and the data file's total size;
* ``data.bin`` — every leaf's bytes, written from a host copy, each at an
  offset aligned to 64 bytes.  A tensor's bytes are stored as they are,
  so bfloat16 round-trips bitwise (numpy has no bfloat16).

A save is atomic: everything is written into a temporary sibling
directory and flushed to disk (``fsync``), then renamed into place, so a
crash mid-save never leaves a step that looks complete.  Storage that
tears a file anyway (the ``truncate_save`` fault kind of
:mod:`mpi4torch_tpu_torch.resilience`, whose hook runs after every save)
is caught on restore: the data file must hold exactly the manifest's
bytes, and a short or unreadable step raises :class:`CheckpointError`.
A restore reads the bytes it needs into memory and checks them before any
becomes a tensor; it never maps the file.  :func:`restore_checkpoint`
reads every leaf whole; :func:`restore_resharded` reads only the runs of
each leaf that hold this rank's shard.

Restore takes a template tree (tensors of the saved shapes, e.g. the
freshly initialised state): leaves land on the template's devices and
dtypes (a meta tensor's leaf on the CPU).  A template whose leaf shapes
differ from the saved ones raises :class:`~mpi4torch_tpu_torch.runtime.
CommError` naming :func:`restore_resharded`, the topology-migrating
restore.  That check is never skipped.  (The JAX package's guard reads
orbax metadata best-effort and, where it finds none, returns silently;
ROADMAP.md, Queue 3.)

Saves and restores are host-side I/O of the calling thread: on the
rank-thread world one rank (usually 0) saves, and a restored state
reaches the others by ``Bcast_``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import uuid
from typing import Any, List, Optional

import torch

from ..runtime import CommError
from .tree import tree_leaves, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_resharded",
           "saved_epoch", "CheckpointManager", "CheckpointError"]

FORMAT = "mpi4torch_tpu_torch.checkpoint/1"
MANIFEST = "manifest.json"
DATA = "data.bin"
_ALIGN = 64


class CheckpointError(ValueError):
    """A step directory that does not hold a complete checkpoint: no or
    an unreadable manifest, a data file of the wrong size (a torn save),
    or a tree that is not the template's."""


# ---------------------------------------------------------------- format


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointError(f"unknown dtype {name!r} in the manifest")
    return dt


def _paths(tree) -> List[str]:
    from ..reshard.rules import tree_paths

    return tree_leaves(tree_paths(tree))


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_step(path: str, state: Any, epoch: Optional[int],
                force: bool) -> None:
    """Write ``state`` to directory ``path`` atomically."""
    from ..reshard.plan import dtype_name

    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(
            f"a checkpoint already exists at {path}; pass force=True to "
            "overwrite it")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}-" \
        f"{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    try:
        leaves = [_as_tensor(x).detach() for x in tree_leaves(state)]
        entries, offset = [], 0
        with open(os.path.join(tmp, DATA), "wb") as f:
            for p, t in zip(_paths(state), leaves):
                host = t.to("cpu").contiguous().reshape(-1)
                raw = host.view(torch.uint8) if host.numel() else \
                    torch.empty(0, dtype=torch.uint8)
                pad = -offset % _ALIGN
                if pad:
                    f.write(b"\0" * pad)
                    offset += pad
                f.write(memoryview(raw.numpy()))
                entries.append({"path": p, "shape": list(t.shape),
                                "dtype": dtype_name(t.dtype),
                                "offset": offset,
                                "nbytes": raw.numel()})
                offset += raw.numel()
            f.flush()
            os.fsync(f.fileno())
        manifest = {"format": FORMAT,
                    "epoch": None if epoch is None else int(epoch),
                    "data_bytes": offset, "leaves": entries}
        with open(os.path.join(tmp, MANIFEST), "w", encoding="utf-8") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        old = None
        if os.path.exists(path):
            old = f"{tmp}.old"
            os.replace(path, old)
        os.replace(tmp, path)
        _fsync_dir(parent)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read_manifest(path: str) -> dict:
    try:
        with open(os.path.join(path, MANIFEST), encoding="utf-8") as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointError(
            f"{path} holds no checkpoint manifest") from None
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"unreadable checkpoint manifest in {path} "
            f"({type(e).__name__}: {e})") from None
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT \
            or not isinstance(manifest.get("leaves"), list):
        raise CheckpointError(f"{path} holds no checkpoint of this format")
    return manifest


def _check_data_size(path: str, manifest: dict) -> int:
    """The data file's size, held to the manifest's: a torn file raises."""
    want = int(manifest["data_bytes"])
    try:
        size = os.path.getsize(os.path.join(path, DATA))
    except OSError as e:
        raise CheckpointError(
            f"unreadable checkpoint data in {path} "
            f"({type(e).__name__}: {e})") from None
    if size != want:
        raise CheckpointError(
            f"torn checkpoint at {path}: {DATA} holds {size} bytes, "
            f"the manifest {want}")
    return want


def _read_into(f, path: str, offset: int, view) -> None:
    """Fill ``view`` from the data file at ``offset``; a short read
    raises."""
    try:
        f.seek(offset)
        got = f.readinto(view)
    except OSError as e:
        raise CheckpointError(
            f"unreadable checkpoint data in {path} "
            f"({type(e).__name__}: {e})") from None
    if got != len(view):
        raise CheckpointError(
            f"torn checkpoint at {path}: read {got} of {len(view)} bytes "
            f"at offset {offset}")


def _check_layout_match(path: str, manifest: dict, template: Any) -> None:
    """The saved tree against the template's: another tree raises
    :class:`CheckpointError`; the same tree with other leaf shapes raises
    ``CommError`` naming both and the migration recipe."""
    saved = manifest["leaves"]
    paths = _paths(template)
    if [e.get("path") for e in saved] != paths:
        raise CheckpointError(
            f"checkpoint at {path} holds another tree than the template: "
            f"{len(saved)} saved leaves vs {len(paths)} requested")
    bad = [(p, tuple(e["shape"]), tuple(_as_tensor(x).shape))
           for p, e, x in zip(paths, saved, tree_leaves(template))
           if tuple(e["shape"]) != tuple(_as_tensor(x).shape)]
    if bad:
        detail = "; ".join(f"{p or '<root>'}: saved {ss} vs requested {ts}"
                           for p, ss, ts in bad[:4])
        more = f" (+{len(bad) - 4} more)" if len(bad) > 4 else ""
        raise CommError(
            f"checkpoint at {path} was saved with different leaf shapes "
            f"than this template requests — {detail}{more}.  A shape "
            "mismatch usually means the state was sharded on another "
            "mesh or spec when saved: restore onto the new topology with "
            "utils.checkpoint.restore_resharded (the reshard migration "
            "recipe) instead of a raw restore_checkpoint.")


def _entry(path: str, e: dict, data_bytes: int):
    """``(dtype, shape, offset)`` of a manifest leaf entry that fits the
    data file; one that does not raises."""
    dtype = _torch_dtype(e["dtype"])
    shape = tuple(int(s) for s in e["shape"])
    nbytes, offset = int(e["nbytes"]), int(e["offset"])
    if nbytes != math.prod(shape) * dtype.itemsize or \
            offset % _ALIGN or offset + nbytes > data_bytes:
        raise CheckpointError(
            f"checkpoint at {path}: leaf {e['path']!r} does not fit "
            "its manifest entry")
    return dtype, shape, offset


def _host_tensor(buf, dtype: torch.dtype, shape) -> torch.Tensor:
    """A CPU tensor over the bytes ``buf`` (no copy)."""
    if not len(buf):
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(
        shape)


def _read_region(f, path: str, dtype: torch.dtype, shape, offset: int,
                 region) -> torch.Tensor:
    """The block ``region`` (one ``(start, stop)`` per axis) of a saved
    leaf, read from the open data file as a CPU tensor.  The axes before
    the first partial one are whole, so the block lies in runs along that
    axis: one read per index of the axes before it; the later axes are
    sliced in memory."""
    j = next((a for a, ((lo, hi), n) in enumerate(zip(region, shape))
              if (lo, hi) != (0, n)), len(shape))
    if j == len(shape):                     # the whole leaf: one run
        outer, lo, hi, n, inner = 1, 0, 1, 1, math.prod(shape)
        got_shape = shape
    else:
        outer, (lo, hi), n = math.prod(shape[:j]), region[j], shape[j]
        inner = math.prod(shape[j + 1:])
        got_shape = shape[:j] + (hi - lo,) + shape[j + 1:]
    row = inner * dtype.itemsize
    run = (hi - lo) * row
    buf = bytearray(outer * run)
    view = memoryview(buf)
    for o in range(outer if run else 0):
        _read_into(f, path, offset + (o * n + lo) * row,
                   view[o * run:(o + 1) * run])
    got = _host_tensor(buf, dtype, got_shape)
    if j == len(shape):
        return got
    return got[(slice(None),) * (j + 1)
               + tuple(slice(a, b) for a, b in region[j + 1:])]


def _target_device(x, device=None):
    if device is not None:
        return torch.device(device)
    dev = _as_tensor(x).device
    return torch.device("cpu") if dev.type == "meta" else dev


def _load(path: str, template: Any, expect_epoch: Optional[int],
          lays=None, rank: int = 0, device=None):
    """The checkpoint at ``path`` in ``template``'s structure, after the
    epoch fence, the layout guard and the size check: each leaf whole,
    or with ``lays`` (one Layout a leaf) ``rank``'s block of it, read
    from the data file and placed on the template leaf's device (or
    ``device``) and in its dtype."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    manifest = _read_manifest(path)
    _check_epoch_match(path, manifest, expect_epoch)
    _check_layout_match(path, manifest, template)
    data_bytes = _check_data_size(path, manifest)
    xs = tree_leaves(template)
    out = []
    with open(os.path.join(path, DATA), "rb") as f:
        for i, (e, x) in enumerate(zip(manifest["leaves"], xs)):
            dtype, shape, offset = _entry(path, e, data_bytes)
            if lays is None:
                region = [(0, n) for n in shape]
            else:
                region = [(b * s, (b + 1) * s) for b, s in zip(
                    lays[i].block(rank), lays[i].shard_shape(shape))]
            h = _read_region(f, path, dtype, shape, offset, region)
            out.append(h.to(_target_device(x, device), _as_tensor(x).dtype,
                            copy=True))
    return tree_unflatten(template, out)


# ------------------------------------------------------------------ epoch


def saved_epoch(path: str) -> Optional[int]:
    """The elastic world epoch recorded with the checkpoint at ``path``
    (``None`` when it was saved without one, or holds no manifest)."""
    try:
        epoch = _read_manifest(os.path.abspath(path)).get("epoch")
    except CheckpointError:
        return None
    return None if epoch is None else int(epoch)


def _check_epoch_match(path: str, manifest: dict,
                       expect_epoch: Optional[int]) -> None:
    """Stale-world fencing: a checkpoint saved under world epoch ``e``
    must not silently resume a world at another epoch (the mesh, and
    with it every shard's meaning, may have changed in between)."""
    if expect_epoch is None:
        return
    saved = manifest.get("epoch")
    if saved is not None and int(saved) != int(expect_epoch):
        raise CommError(
            f"checkpoint at {path} was saved under world epoch {saved}, "
            f"but this resume expects epoch {int(expect_epoch)} — the "
            "world was resized in between (stale-world resume).  Restore "
            "deliberately (expect_epoch=None or the saved epoch) and re-lay "
            "the state onto the current world instead of resuming blind.")


# ------------------------------------------------------------- save/restore


def _post_save_fault(path: str) -> None:
    """Fault-injection hook (:mod:`mpi4torch_tpu_torch.resilience`): when
    the active fault plan targets checkpoint saves (``truncate_save``),
    damage the just-written step the way a kill mid-save on non-atomic
    storage would.  One attribute read when no plan is installed."""
    from .. import config as _cfg
    from ..runtime import effective_rank_context

    plan = _cfg.fault_plan()
    if plan is None or not plan.wants_checkpoint():
        return
    plan.on_checkpoint_save(path, rank=effective_rank_context().rank)


def save_checkpoint(path: str, state: Any, *, force: bool = False,
                    epoch: Optional[int] = None) -> None:
    """Write the tree ``state`` (params, optimizer state, step counter,
    ...) to directory ``path``, atomically.  ``force`` overwrites an
    existing checkpoint (otherwise that raises ``FileExistsError``).
    ``epoch`` stamps the elastic world epoch the state was saved under
    (:func:`saved_epoch`; restores passing ``expect_epoch`` fence a
    mismatch)."""
    _write_step(path, state, epoch, force)
    _post_save_fault(os.path.abspath(path))


def restore_checkpoint(path: str, template: Any, *,
                       expect_epoch: Optional[int] = None) -> Any:
    """Read the tree at ``path`` into ``template``'s structure, each leaf
    on the template leaf's device and in its dtype.  Raises
    ``FileNotFoundError`` when ``path`` is no directory,
    :class:`CheckpointError` when it holds no complete checkpoint of the
    template's tree, and ``CommError`` on a leaf-shape mismatch (use
    :func:`restore_resharded`) or when ``expect_epoch`` disagrees with
    the recorded epoch."""
    return _load(path, template, expect_epoch)


def restore_resharded(path: str, template: Any, target_layout, *,
                      saved_layout=None, comm=None) -> Any:
    """Topology-migrating restore: read a checkpoint of the GLOBAL tree
    and return this rank's shard under ``target_layout`` (one
    :class:`~mpi4torch_tpu_torch.reshard.Layout` or a matching tree of
    them, e.g. from ``reshard.match_partition_rules``).

    ``template`` is the global-shaped tree (tensors or meta tensors).
    With ``saved_layout``, each rank takes its saved-layout shard and
    the move to ``target_layout`` runs on the world's device as a
    planned ``comm.Reshard``.  Without it, the target shard is sliced
    directly.  Either way each rank reads only the runs of the data
    file that hold its shard (whole rows from the first split axis on),
    and only the shard reaches the device.

    Host-side I/O: call it from a rank thread of ``run_ranks`` or from a
    single process."""
    from ..comm import COMM_WORLD
    from ..reshard.executor import _spec_tree

    comm = COMM_WORLD if comm is None else comm

    def shard(lay):
        return _load(path, template, None,
                     tree_leaves(_spec_tree(lay, template)), comm.rank,
                     comm.device)

    if saved_layout is None or comm.size == 1:
        return shard(target_layout)
    mine = shard(saved_layout)
    return comm.Reshard(mine, saved_layout, target_layout)


# ----------------------------------------------------------------- manager


class CheckpointManager:
    """Step-numbered checkpoints with retention — the resume loop::

        mgr = CheckpointManager(workdir, max_to_keep=3)
        step = mgr.latest_step()
        state = mgr.restore(step, template=state) if step is not None \\
            else init_state
        for step in range(0 if step is None else step + 1, n_steps):
            state = train_step(state)
            mgr.save(step, state)
        mgr.close()

    Step ``s`` lives in ``<directory>/<s>``.  Saves are synchronous, so
    :meth:`wait_until_finished` and :meth:`close` have nothing to wait
    for; they are kept for the JAX package's calling convention.
    Retention (``max_to_keep``) deletes the oldest step directories after
    each save."""

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = None,
                 save_interval_steps: int = 1):
        if max_to_keep is not None and int(max_to_keep) < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        if int(save_interval_steps) < 1:
            raise ValueError("save_interval_steps must be >= 1, got "
                             f"{save_interval_steps}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = None if max_to_keep is None else int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)
        os.makedirs(self.directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: Any, *, force: bool = False,
             epoch: Optional[int] = None) -> bool:
        """Save ``state`` as step ``step``; returns whether a save
        happened (an off-interval step is skipped unless ``force``).
        Saving a step that exists needs ``force``.  ``epoch`` stamps the
        elastic world epoch (``restore(expect_epoch=...)`` fences it)."""
        step = int(step)
        if not force and step % self.save_interval_steps:
            return False
        path = self._step_path(step)
        _write_step(path, state, epoch, force)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_path(old), ignore_errors=True)
        _post_save_fault(path)
        return True

    def restore(self, step: int, template: Any, *,
                expect_epoch: Optional[int] = None) -> Any:
        """:func:`restore_checkpoint` of step ``step``."""
        return restore_checkpoint(self._step_path(step), template,
                                  expect_epoch=expect_epoch)

    def all_steps(self) -> List[int]:
        """Every numeric step directory, ascending (a directory that holds
        no complete checkpoint included: :func:`~mpi4torch_tpu_torch.
        resilience.restore_or_init` walks past those)."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        """Nothing to wait for: every save has finished when it returns."""

    def close(self) -> None:
        """Nothing to release."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
