"""``python -m mpi4torch_tpu_torch.compress --smoke [--device cpu]`` — the
quant-smoke lanes.

Port of ``mpi4torch_tpu/compress/__main__.py``.  It exits non-zero on any
divergence:

1. **Mode A parity**: the q8 ``bidir`` and ``torus`` Allreduce under
   ``run_spmd`` against
   :func:`mpi4torch_tpu_torch.constants.reduce_q8_hop`, the fold oracle of
   Mode B, bit for bit on every rank, for ``q8`` and the stochastic
   per-hop-EF ``q8_ef_hop``.  On a card the hop kernel K1's launches are
   counted against the schedule's: each rank's first encode and ``n - 1``
   hops per channel;
2. **census**: the recorded q8 ``bidir`` program (``analyze.lower``)
   carries int8 ``collective_permute`` ops on BOTH rotations of the dual
   ring (``int8_rotation_census``);
3. **kernel**: K1 (``ops/csrc/quant_hop.cu``) against its plain version,
   bit for bit, round-to-nearest and stochastic with the residual.  On
   the CPU the plain version would be held against itself, which is no
   check: the lane runs only where a card is present, and says so.

Lanes 1 and 2 run on :data:`NRANKS` rank threads.  The device is CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import sys

#: World size of the parity lane (the JAX CLI's 8 host devices).
NRANKS = 8


def _parity_lane(failures, device, n) -> None:
    import numpy as np
    import torch

    from .. import COMM_WORLD, MPI_SUM, run_spmd
    from .. import constants as C
    from ..ops import _kernels
    from ..tune import resolve_hier_group
    from . import get_codec

    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        (rng.standard_normal((n, 700)) * 3.0).astype(np.float32))
    combos = [("q8", "bidir", None), ("q8_ef_hop", "bidir", None),
              ("q8", "torus", resolve_hier_group(n))]
    for codec, algo, inner in combos:
        base = get_codec(codec).base()

        def fn(x, codec=codec, algo=algo):
            return COMM_WORLD.Allreduce(x[COMM_WORLD.rank], MPI_SUM,
                                        compression=codec, algorithm=algo)

        before = dict(_kernels.launch_counts)
        got = run_spmd(fn, nranks=n, device=device)(data)
        hops = _kernels.launch_counts["q8_hop"] - before["q8_hop"]
        enc = _kernels.launch_counts["q8_requant"] - before["q8_requant"]
        want = C.reduce_q8_hop(
            list(data.to(got.device)), block=base.block,
            algorithm=algo, inner=inner, stochastic=base.stochastic,
            hop_ef=base.hop_ef)
        bad = [r for r in range(n) if not torch.equal(got[r], want)]
        if bad:
            failures.append(f"{codec}-on-{algo}")
            print(f"FAIL: Mode A {codec}-on-{algo} diverges from the fold "
                  f"oracle on ranks {bad}")
            continue
        line = (f"parity: {codec}-on-{algo} == reduce_q8_hop oracle "
                "(bitwise, all ranks)")
        if got.is_cuda:
            # Two channels of n ranks: n first encodes and n (n - 1)
            # hops each.
            if (hops, enc) != (2 * n * (n - 1), 2 * n):
                failures.append(f"{codec}-on-{algo} launches")
                print(f"FAIL: {codec}-on-{algo} launched K1 {hops} hop / "
                      f"{enc} requant times; the schedule has "
                      f"{2 * n * (n - 1)} / {2 * n}")
                continue
            line += f"; K1 launches {hops} hop + {enc} requant"
        print(line)


def _census_lane(failures, device, n) -> None:
    import torch

    from .. import MPI_SUM
    from ..analyze.sweep import _flat_lowerer
    from ..runtime import resolve_device
    from . import int8_rotation_census

    dev = resolve_device(device)
    lower, _ = _flat_lowerer(n, dev)
    program = lower(lambda c, a: c.Allreduce(a, MPI_SUM, compression="q8",
                                             algorithm="bidir"),
                    torch.ones((1 << 12,), dtype=torch.float32,
                               device=dev))
    perms, fwd, bwd = int8_rotation_census(program, n)
    if fwd not in perms or bwd not in perms:
        failures.append("census")
        print(f"FAIL: int8 permutes must ride both dual-ring rotations; "
              f"saw {sorted(perms)}")
        return
    print("census: int8 collective_permutes on both source_target_pairs "
          "rotations of the q8-bidir dual ring")


def _kernel_lane(failures, device) -> None:
    import numpy as np
    import torch

    from ..ops import quant_kernels as qk
    from ..runtime import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        print("kernel: skipped on the CPU (K1 runs only on a card; the "
              "plain version against itself is no check)")
        return
    rng = np.random.default_rng(1)
    block = 256
    q = torch.from_numpy(rng.integers(-127, 128, (300, block))
                         .astype(np.int8)).to(dev)
    scale = qk.po2_scale(torch.from_numpy(
        rng.uniform(0.01, 2.0, (300,)).astype(np.float32)).to(dev))
    mine = torch.from_numpy(rng.standard_normal((300, block))
                            .astype(np.float32)).to(dev)
    noise = qk.hop_noise(qk.schedule_key(0, 0, 0), 300, block, device=dev)
    for label, nz in (("round-to-nearest", None), ("stochastic", noise)):
        a = qk.dequant_accum_requant(q, scale, mine, noise=nz,
                                     want_resid=True, impl="cuda")
        b = qk.dequant_accum_requant(q, scale, mine, noise=nz,
                                     want_resid=True, impl="torch")
        for name, av, bv in zip(("q", "scale", "resid"), a, b):
            if not torch.equal(av, bv):
                failures.append(f"kernel {name} {label}")
                print(f"FAIL: K1 vs its plain version diverge on {name} "
                      f"({label})")
                return
    print("kernel: K1 == plain hop (bitwise, incl. stochastic rounding "
          "and the residual)")


def smoke(device=None) -> int:
    failures: list = []
    print(f"quant-smoke: {NRANKS} rank threads, device "
          f"{device or 'cuda'}")
    _parity_lane(failures, device, NRANKS)
    _census_lane(failures, device, NRANKS)
    _kernel_lane(failures, device)
    if failures:
        print(f"quant-smoke: {len(failures)} FAILURE(S)")
        return 1
    print("quant-smoke: OK")
    return 0


def main(argv) -> int:
    if "--smoke" in argv:
        device = argv[argv.index("--device") + 1] \
            if "--device" in argv else None
        return smoke(device)
    print(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
