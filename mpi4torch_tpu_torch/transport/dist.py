"""The distributed world: a :class:`~mpi4torch_tpu_torch.runtime.World`
whose wire rides ``torch.distributed`` across OS processes.

Under :func:`~mpi4torch_tpu_torch.init_distributed` a ``run_spmd`` world
holds every global rank, and each process runs its own contiguous block
of them on rank threads.  :class:`DistWorld` replaces only the wire
seams ``_exchange_wire`` and ``_health_wire``, as the process transport
does (``transport/_worker.py``), so tracing, fault injection, retries
and the integrity checks compose with no code of their own.

One rendezvous (``_exchange_wire``):

1. every local rank deposits ``(signature, verdicts, payload)`` and
   meets the others at the local barrier;
2. one thread a process (the lowest local rank's) all-gathers every
   process's deposits over gloo: its deposits packed by the payload
   codec (``wire.pack``: raw bytes, so bf16 crosses as it is and every
   result stays bitwise), the byte counts first, then the bytes;
3. the local barrier again, then every local rank checks the
   signatures and verdicts of all global ranks and runs ``read`` on the
   full payload list (its own process's payloads as deposited, the
   others unpacked onto the world's device);
4. the local barrier a third time, so no payload is reused early.

Only that one thread talks to gloo, in rendezvous order, which is the
same on every rank by the SPMD contract: gloo calls from several threads
of one process are not ordered across processes.  Two ``run_spmd``
calls must therefore not run at once in one process.

Mode A sends everything through ``World.exchange``, so the p2p seams
raise.  A signature mismatch raises ``CollectiveMismatchError`` on every
rank of every process.  A peer process that dies or exits surfaces on
every survivor as a typed error within the world timeout (gloo's
timeout, set by ``init_distributed``): ``RankFailedError`` naming the
dead process's ranks where the wire can tell (two processes, one of
which closed its connection), else ``DeadlockError`` naming the ranks
of the other processes as missing.

The exchange is world-wide: every payload reaches every process even
where ``read`` takes one neighbour's.  :func:`stats` counts the bytes
that cross processes.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, List

import numpy as np
import torch

from .. import runtime as _rt
from .wire import Packed, pack, unpack

__all__ = ["DistWorld", "allgather_objects", "stats", "reset_stats"]

# Byte offsets of the serialized buffers are multiples of this, so that
# every unpacked tensor starts aligned.
_ALIGN = 64

# Messages gloo gives when the peer's end of the connection is gone.
_PEER_GONE = ("closed by peer", "reset by peer", "Broken pipe",
              "Connection closed", "Connection refused", "EOF")

_stats_lock = threading.Lock()
_STATS = {"rounds": 0, "sent_bytes": 0, "received_bytes": 0}


def stats() -> dict:
    """Cross-process traffic of this process since the last
    :func:`reset_stats`: ``rounds`` (all-gathers of the distributed
    wire), ``sent_bytes`` (this process's serialized deposits times the
    number of other processes) and ``received_bytes`` (the other
    processes' serialized deposits)."""
    with _stats_lock:
        return dict(_STATS)


def reset_stats() -> None:
    with _stats_lock:
        for k in _STATS:
            _STATS[k] = 0


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _layout(p: Packed):
    """``(buffer lengths, buffer offsets, total length)`` of ``p``
    serialized: an int64 header ``[len(meta), n_bufs, len(buf) ...]``,
    the meta pickle, then each buffer at an aligned offset."""
    lens = [memoryview(b).nbytes for b in p.bufs]
    pos = _aligned(8 * (2 + len(lens)) + len(p.meta))
    offs = []
    for n in lens:
        offs.append(pos)
        pos = _aligned(pos + n)
    return lens, offs, pos


def _serialize_into(out: np.ndarray, p: Packed, lens, offs) -> None:
    head = 8 * (2 + len(lens))
    out[:head].view(np.int64)[:] = [len(p.meta), len(lens)] + lens
    out[head:head + len(p.meta)] = np.frombuffer(p.meta, np.uint8)
    for o, n, b in zip(offs, lens, p.bufs):
        if n:
            out[o:o + n] = np.frombuffer(b, np.uint8)


def _deserialize(buf: np.ndarray) -> Packed:
    meta_len, nb = (int(v) for v in buf[:16].view(np.int64))
    head = 8 * (2 + nb)
    lens = [int(v) for v in buf[16:head].view(np.int64)]
    meta = buf[head:head + meta_len].tobytes()
    pos = _aligned(head + meta_len)
    bufs = []
    for n in lens:
        bufs.append(buf[pos:pos + n])
        pos = _aligned(pos + n)
    return Packed(meta, bufs)


def _allgather_packed(p: Packed) -> List[Packed]:
    """Every process's packed object, in process order (this process's
    own entry is ``p``): two gloo all-gathers, the lengths and then the
    bytes, each process's buffer padded to the longest."""
    import torch.distributed as tdist

    nproc, me = tdist.get_world_size(), tdist.get_rank()
    lens, offs, total = _layout(p)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(nproc)]
    tdist.all_gather(sizes, torch.tensor([total], dtype=torch.int64))
    sizes = [int(s) for s in sizes]
    width = max(sizes)
    mine = torch.empty(width, dtype=torch.uint8)
    _serialize_into(mine.numpy(), p, lens, offs)
    outs = [torch.empty(width, dtype=torch.uint8) for _ in range(nproc)]
    tdist.all_gather(outs, mine)
    with _stats_lock:
        _STATS["rounds"] += 1
        _STATS["sent_bytes"] += total * (nproc - 1)
        _STATS["received_bytes"] += sum(sizes) - total
    return [p if q == me else _deserialize(outs[q].numpy()[:sizes[q]])
            for q in range(nproc)]


def allgather_objects(obj: Any, device=None) -> List[Any]:
    """Every process's ``obj`` (any structure of tensors and plain
    values), in process order; the others' tensors unpacked onto
    ``device``, this process's own entry ``obj`` itself.  Collective:
    every process calls it, from one thread."""
    import torch.distributed as tdist

    me = tdist.get_rank()
    got = _allgather_packed(pack(obj))
    return [obj if q == me else unpack(g, device)
            for q, g in enumerate(got)]


class DistWorld(_rt.World):
    """A world of ``size`` global ranks of which this process runs
    ``ranks`` (its contiguous block), whose rendezvous crosses the
    processes over ``torch.distributed`` (see the module docstring).
    ``process_of`` maps each global rank to its process."""

    def __init__(self, size: int, ranks: range, process_of, timeout=None,
                 device=None):
        super().__init__(size, timeout=timeout, device=device)
        self.local_ranks = ranks
        self.process_of = tuple(int(q) for q in process_of)
        self._leader = ranks[0]
        self._barrier = _rt._AttributedBarrier(len(ranks))
        self._health = _rt._AttributedBarrier(len(ranks), resettable=True)
        self._round = None
        self._health_round = None

    # ------------------------------------------------------------ errors

    def _deadlock_error(self, arrived):
        # The local barrier's generation: only this process's ranks.
        arrived = frozenset() if arrived is None else arrived
        missing = frozenset(self.local_ranks) - arrived
        return _rt.DeadlockError(
            f"collective rendezvous timed out after {self.timeout}s — a "
            "rank did not reach the matching collective (every rank must "
            "execute the same communication sequence).  Ranks "
            f"{sorted(arrived)} arrived; ranks {sorted(missing)} did not",
            arrived=arrived, missing=missing)

    def _wire_error(self, err: BaseException) -> _rt.CommError:
        """The typed error of a failed cross-process all-gather."""
        msg = str(err)
        me = self.process_of[self._leader]
        remote = [r for r in range(self.size) if self.process_of[r] != me]
        nproc = len(set(self.process_of))
        if nproc == 2 and any(s in msg for s in _PEER_GONE):
            return _rt.RankFailedError(
                f"collective cannot complete: rank(s) {remote} failed "
                f"(their process closed its connection: {msg})",
                ranks=remote)
        return _rt.DeadlockError(
            f"collective rendezvous across processes failed within the "
            f"world timeout ({self.timeout}s): {msg}.  Ranks "
            f"{list(self.local_ranks)} arrived; ranks {remote} did not",
            arrived=self.local_ranks, missing=remote)

    def _latch(self, err: BaseException) -> None:
        """Fail the world locally, so later operations raise at once."""
        with self._err_lock:
            if isinstance(err, _rt.RankFailedError):
                for r in err.ranks:
                    self._dead.setdefault(r, err)
            if self._first_error is None:
                self._first_error = err
        self._failed.set()

    # ------------------------------------------------------- wire seams

    def _cross(self, meter):
        """The leader's cross-process step: ``(error, sigs, verdicts,
        payloads)`` over all global ranks, never raising."""
        t0 = time.perf_counter()
        local = [(self._sigs[r], self._verdicts[r], self._slots[r])
                 for r in self.local_ranks]
        try:
            got = _allgather_packed(pack(local))
        except Exception as e:  # noqa: BLE001 — typed and shared below
            return self._wire_error(e), None, None, None
        finally:
            if meter is not None:
                meter.add_wait(t0, time.perf_counter())
        me = self.process_of[self._leader]
        sigs: List[Any] = [None] * self.size
        verdicts: List[Any] = [()] * self.size
        slots: List[Any] = [None] * self.size
        for q, p in enumerate(got):
            rows = local if q == me else unpack(p, self.device)
            ranks = [r for r in range(self.size) if self.process_of[r] == q]
            for r, (sig, ver, pay) in zip(ranks, rows):
                sigs[r], verdicts[r] = sig, ver
                # Local payloads as deposited: a read takes them before
                # their owners go on.
                slots[r] = self._slots[r] if q == me else pay
        return None, sigs, verdicts, slots

    def _exchange_wire(self, rank, signature, payload, read=None,
                       checks=(), meter=None):
        self._sigs[rank] = signature
        self._slots[rank] = payload
        self._verdicts[rank] = tuple(c.ok(payload) for c in checks)
        self._wait_barrier(rank, meter)
        if rank == self._leader:
            self._round = self._cross(meter)
        self._wait_barrier(rank, meter)
        err, sigs, verdicts, slots = self._round
        if err is not None:
            self._latch(err)
            raise copy.copy(err)
        try:
            self._check_sig_agreement(sigs)
            for i, check in enumerate(checks):
                bad = [r for r, v in enumerate(verdicts) if not v[i]]
                if bad:
                    check.report(bad)
            out = list(slots)
            if read is not None:
                out = read(out)
        finally:
            self._wait_barrier(rank, meter)
        return out

    def _health_wire(self, rank, timeout):
        arrivals: list = []
        try:
            self._health.wait(rank, timeout, collect_arrivals=arrivals)
        except (_rt._BarrierTimeout, _rt._BarrierBroken) as e:
            arrived = frozenset() if e.arrived is None else e.arrived
            return False, arrived, e.arrive_t
        if rank == self._leader:
            try:
                every = allgather_objects(arrivals[0] if arrivals else {})
                arrive_t = {r: t for d in every for r, t in d.items()}
                self._health_round = (True, frozenset(range(self.size)),
                                      arrive_t)
            except Exception:  # noqa: BLE001 — a probe reports, not raises
                self._health_round = (False, frozenset(self.local_ranks),
                                      dict(arrivals[0] if arrivals else {}))
        try:
            self._health.wait(rank, timeout)
        except (_rt._BarrierTimeout, _rt._BarrierBroken) as e:
            arrived = frozenset() if e.arrived is None else e.arrived
            return False, arrived, e.arrive_t
        return self._health_round

    def _p2p_send_wire(self, src, dst, tag, payload):
        raise _rt.CommError(
            "the distributed world carries collectives only: run_spmd "
            "turns every point-to-point exchange into a rendezvous "
            "(World.exchange), so no message reaches this seam")

    _p2p_recv_wire = _p2p_send_wire
