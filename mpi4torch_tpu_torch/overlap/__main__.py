"""``python -m mpi4torch_tpu_torch.overlap --smoke [--device cpu]`` — the
overlap-smoke lane.

Port of ``mpi4torch_tpu/overlap/__main__.py``.  It drives the
split-phase scheduler and the ZeRO prefetch end to end on an
:data:`NRANKS`-rank ``run_spmd`` world:

1. a DP gradient-tree Allreduce through the windowed split-phase
   scheduler, checked BITWISE against the blocking fused form;
2. a full ZeRO step (windowed reduce-scatter + double-buffered parameter
   all-gather prefetch) against the blocking step, bitwise;
3. a host wall-clock probe of both steps (informational: the rank
   threads' rendezvous is blocking, so it cannot hide wire time), and
   :func:`~mpi4torch_tpu_torch.overlap.scheduled_exposure` of both
   recorded step programs (``analyze.lower``): the windowed schedule
   must census strictly below the blocking one.

Exits non-zero on any mismatch.  The device is CUDA unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import sys
import time

#: World size of the lane (the JAX CLI's 8 host devices).
NRANKS = 8


class _Sgd:
    """A stateless SGD with the ``init``/``update`` interface of
    :mod:`mpi4torch_tpu_torch.utils.optim`."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        from ..utils.tree import tree_map

        return tree_map(lambda g: -0.1 * g, grads), None


def smoke(device=None) -> int:
    import numpy as np
    import torch

    from .. import COMM_WORLD as comm
    from .. import MPI_SUM, analyze, config, run_spmd
    from ..parallel import zero as Z
    from ..runtime import resolve_device
    from ..utils.tree import tree_map
    from . import scheduled_exposure

    n = NRANKS
    dev = resolve_device(device)
    print(f"overlap-smoke: {n} rank threads, device {dev}")

    rng = np.random.default_rng(0)
    tree = {f"layer{i}": torch.from_numpy(
        rng.standard_normal(2048).astype(np.float32)).to(dev)
        for i in range(6)}

    def avg(ov):
        return run_spmd(lambda t: comm.Allreduce_tree(
            t, MPI_SUM, bucket_bytes=4096, overlap=ov, mean=True),
            nranks=n, device=dev)

    blocking = avg(None)(tree)
    overlapped = avg(True)(tree)
    for k in tree:
        if not torch.equal(blocking[k], overlapped[k]):
            print(f"FAIL: scheduler allreduce tree diverges on {k}")
            return 1
    print("scheduler: 6-leaf tree, windowed split-phase == blocking "
          "fused (bitwise)")

    params = {"w": torch.from_numpy(
        rng.standard_normal((64, 48)).astype(np.float32)).to(dev),
        "b": torch.from_numpy(
            rng.standard_normal(97).astype(np.float32)).to(dev)}
    grads = tree_map(lambda p: p * 0.01, params)
    opt = _Sgd()

    def zstep(ov):
        def f(g):
            with config.fusion_scope(4096):
                st = Z.zero_init(comm, opt, params)
                return Z.zero_step(comm, opt, params, g, st,
                                   overlap=ov)[0]
        return run_spmd(f, nranks=n, device=dev)

    zb = zstep(None)(grads)
    zo = zstep(True)(grads)
    for k in params:
        if not torch.equal(zb[k], zo[k]):
            print(f"FAIL: ZeRO overlap step diverges on {k}")
            return 1
    print("zero: windowed reduce-scatter + prefetched all-gather == "
          "blocking step (bitwise)")

    def timed(fn, arg, iters=3):
        fn(arg)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(arg)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]

    tb, to = timed(zstep(None), grads), timed(zstep(True), grads)
    print(f"zero step: blocking {tb * 1e3:.2f} ms, overlap "
          f"{to * 1e3:.2f} ms (host wall clock, informational: the rank "
          "threads' rendezvous is blocking and cannot hide wire time)")

    # The deterministic story: census both recorded step programs.
    cb = scheduled_exposure(analyze.lower(zstep(None), grads))
    co = scheduled_exposure(analyze.lower(zstep(True), grads))
    print(f"scheduled exposure: blocking {cb['exposed_fraction']} "
          f"({cb['n_buckets']} buckets), overlap {co['exposed_fraction']} "
          f"({co['n_buckets']} buckets)")
    if (n > 1 and cb["n_buckets"]
            and not (co["exposed_fraction"] < cb["exposed_fraction"])):
        print("FAIL: windowed schedule does not lower the scheduled "
              "exposed-comm fraction")
        return 1
    print("overlap-smoke: OK")
    return 0


def main(argv) -> int:
    if "--smoke" in argv or not argv:
        device = argv[argv.index("--device") + 1] \
            if "--device" in argv else None
        return smoke(device)
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
