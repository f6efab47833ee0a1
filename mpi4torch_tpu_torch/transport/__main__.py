"""``python -m mpi4torch_tpu_torch.transport --smoke [--device cpu]`` —
the transport's smoke lanes.

Port of ``mpi4torch_tpu/transport/__main__.py``.  It exits non-zero on
any divergence:

* **registry sync**: every registered backend is one the parity lanes
  below (and ``tests/test_torch_transport.py``) exercise;
* **bitwise parity**: the plain Allreduce, deterministic mode, a fused
  bucketed ``Allreduce_tree``, the q8 compressed Allreduce and p2p
  ``Send``/``Recv`` on (3,) worlds, and the (8,) -> (2, 4) reshard, each
  value and gradient bit for bit the same on the thread and process
  backends;
* **SIGKILL attribution**: a ``rank_death`` matrix cell on the process
  backend (a real SIGKILL of a real worker) ends in the attributed raise
  with its fired-fault ledger;
* **reconcile**: a ring Allreduce traced on 8 process-backend workers
  reconciles EXACTLY (``obs.reconcile``: wire bytes and collective
  counts) against its recorded Mode A program.

The device is CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys

# The guard's one home is the analyze registry (which reads
# TESTED_BACKENDS below when it runs).
from ..analyze.registry import transport_problems

#: The backends the parity lanes exercise; the registry must not hold
#: another (register a backend, test a backend).
TESTED_BACKENDS = ("thread", "process")


def _fail(failures: list, msg: str) -> None:
    failures.append(msg)
    print(f"FAIL: {msg}", flush=True)


def _ok(msg: str) -> None:
    print(f"ok  : {msg}", flush=True)


def bitwise_equal(a, b) -> bool:
    """Whether two results are the same structure with bit-identical
    leaves (tensors compared byte for byte, NaN payloads included)."""
    import torch

    from ..utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor)
                    and isinstance(y, torch.Tensor)
                    and x.dtype == y.dtype and x.shape == y.shape):
                return False
            bx = x.detach().cpu().contiguous().reshape(-1)
            by = y.detach().cpu().contiguous().reshape(-1)
            if bx.dtype == torch.bool:
                bx, by = bx.to(torch.uint8), by.to(torch.uint8)
            if not torch.equal(bx.view(torch.uint8), by.view(torch.uint8)):
                return False
        elif x != y:
            return False
    return True


def parity_bodies() -> dict:
    """``{name: (nranks, body)}``: the parity lanes' rank bodies, each
    returning its value and gradient on its world's device (closures,
    shipped by value).  Their data come from numpy's seeded generator:
    torch's first transcendental calls made at once on several CPU rank
    threads can return other bits (ROADMAP.md, Queue 3), which would
    make the thread side of a comparison, not the transport, differ."""
    import numpy as np
    import torch

    import mpi4torch_tpu_torch as mpi
    from mpi4torch_tpu_torch import reshard as rs

    comm = mpi.COMM_WORLD

    def seeded(seed, shape):
        a = np.random.default_rng(seed).standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(comm.device)

    def value_and_grad(x, op):
        x = x.clone().requires_grad_()
        y = op(x)
        w = seeded(7, tuple(y.shape))
        (g,) = torch.autograd.grad(torch.vdot(y.reshape(-1), w.reshape(-1)),
                                   x)
        return y.detach(), g

    def base(rank):
        return seeded(rank, (96,))

    def plain(rank):
        return value_and_grad(base(rank),
                              lambda x: comm.Allreduce(x, mpi.MPI_SUM))

    def det(rank):
        with mpi.config.deterministic_mode(True):
            return value_and_grad(base(rank),
                                  lambda x: comm.Allreduce(x, mpi.MPI_SUM))

    def fused(rank):
        dev = comm.device
        a = torch.arange(24, dtype=torch.float32, device=dev) * (rank + 1)
        b = torch.ones(8, dtype=torch.float32, device=dev) * rank
        a.requires_grad_()
        b.requires_grad_()
        out = comm.Allreduce_tree({"a": a, "b": b}, mpi.MPI_SUM,
                                  bucket_bytes=64)
        ga, gb = torch.autograd.grad(
            (out["a"] * out["a"]).sum() + out["b"].sum(), (a, b))
        return {k: v.detach() for k, v in out.items()}, ga, gb

    def q8(rank):
        x = torch.linspace(-2.0, 2.0, 96, device=comm.device) * (rank + 1)
        return value_and_grad(x, lambda v: comm.Allreduce(
            v, mpi.MPI_SUM, compression="q8", algorithm="ring"))

    def p2p(rank):
        if rank == 0:
            comm.Send(torch.arange(8, dtype=torch.float32,
                                   device=comm.device) * 7, 1, 3)
            return None
        if rank == 1:
            return comm.Recv(torch.zeros(8, device=comm.device), 0, 3)
        return None

    src, dst = rs.layout((8,), 0, None), rs.layout((2, 4), 0, 1)
    shard = src.shard_shape((256, 64))

    def migrate(rank):
        return value_and_grad(seeded(rank, shard),
                              lambda v: comm.Reshard(v, src, dst))

    return {"plain": (3, plain), "deterministic": (3, det),
            "fused": (3, fused), "q8": (3, q8), "p2p": (3, p2p),
            "reshard-(8,)->(2,4)": (8, migrate)}


def _smoke_parity(failures, device) -> None:
    import mpi4torch_tpu_torch as mpi

    for name, (n, body) in parity_bodies().items():
        a = mpi.run_ranks(body, n, backend="thread", device=device)
        b = mpi.run_ranks(body, n, backend="process", device=device)
        if bitwise_equal(a, b):
            _ok(f"parity[{name}]: values and gradients x {n} ranks bitwise "
                "identical across backends")
        else:
            _fail(failures, f"parity[{name}]: the process backend diverges "
                            "from the thread backend")


def _smoke_sigkill(failures, device) -> None:
    from ..resilience.matrix import run_cell

    rec = run_cell("rank_death", "plain", nranks=3, backend="process",
                   device=device)
    msg = f"{rec['detail']} (fired={rec['fired']})"
    if rec["status"] == "ok" and "rank_death" in rec["fired"]:
        _ok(f"sigkill[rank_death x plain x process]: {msg}")
    else:
        _fail(failures, f"sigkill[rank_death x plain x process]: {msg}")


def _smoke_reconcile(failures, device) -> None:
    import torch

    import mpi4torch_tpu_torch as mpi
    from mpi4torch_tpu_torch import obs
    from mpi4torch_tpu_torch.analyze.sweep import _flat_lowerer
    from mpi4torch_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    comm = mpi.COMM_WORLD

    def body(rank):
        x = torch.arange(1024, dtype=torch.float32, device=comm.device)
        return comm.Allreduce(x * (rank + 1), mpi.MPI_SUM,
                              algorithm="ring")

    lower, _ = _flat_lowerer(8, dev)
    lowered = lower(lambda c, a: c.Allreduce(a, mpi.MPI_SUM,
                                             algorithm="ring"),
                    torch.arange(1024, dtype=torch.float32, device=dev))
    with obs.trace() as t:
        mpi.run_ranks(body, 8, backend="process", device=device)
    rep = obs.reconcile(t.events, lowered, dropped=t.dropped, device=dev)
    m, p = rep["measured"], rep["predicted"]
    detail = (f"measured {m['wire_bytes']} B {m['counts']} == "
              f"predicted {p['wire_bytes']} B {p['counts']}")
    if rep["ok"]:
        _ok(f"reconcile[process-wire ring-allreduce]: {detail}")
    else:
        _fail(failures, f"reconcile[process-wire ring-allreduce]: "
                        f"{detail} (matches={rep['matches']}, dropped="
                        f"{rep['dropped_events']})")


def smoke(device=None) -> int:
    from . import shutdown

    failures: list = []
    for p in transport_problems():
        _fail(failures, f"[registry] {p}")
    if not failures:
        _ok(f"registry: TRANSPORTS == tested backends "
            f"{list(TESTED_BACKENDS)}")
    try:
        _smoke_parity(failures, device)
        _smoke_sigkill(failures, device)
        _smoke_reconcile(failures, device)
    finally:
        shutdown()
    if failures:
        print(f"\ntransport-smoke: {len(failures)} failure(s)")
        return 1
    print("\ntransport-smoke: all lanes passed")
    return 0


def main(argv) -> int:
    if "--smoke" in argv:
        device = None
        if "--device" in argv:
            device = argv[argv.index("--device") + 1]
        return smoke(device)
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
