"""The port's ragged collectives against the JAX package's Mode B, on the
CPU.

``ragged_alltoall``, ``ragged_allgather``, ``ragged_gather`` and
``ragged_scatter`` take capacity-padded float64 blocks (padding poisoned
with NaN) and per-rank count vectors made from a seed with numpy, on
rank-thread worlds of 2, 3 and 8 ranks, in both packages.  Payloads,
counts and the gradients of ``sum(out * w_r)`` are bitwise equal, every
padding slot's gradient is exactly zero, and the contracts of
``tests/test_ragged.py`` (routing oracle, clamped counts, NaN padding,
validation) are re-expressed against the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.ops import ragged as jr
from mpi4torch_tpu_torch.ops import ragged as pr

SIZES = [2, 3, 8]
CAP, FEAT = 4, 3


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).reshape(-1)
                               .view(np.uint8),
                               np.ascontiguousarray(b).reshape(-1)
                               .view(np.uint8)))


def _case(n, seed):
    """Per-rank payloads (NaN in the padding) and counts: a (n, n)
    send-count matrix and a per-rank scalar count, over- and
    under-range entries included so the clamps are exercised."""
    rng = np.random.default_rng(seed)
    sends = rng.integers(-1, CAP + 2, size=(n, n))
    scal = rng.integers(0, CAP + 1, size=n)
    scal[0] = CAP + 3
    blocks, rows = [], []
    for r in range(n):
        b = rng.standard_normal((n, CAP, FEAT))
        for d in range(n):
            b[d, max(sends[r, d], 0):] = np.nan
        blocks.append(b)
        x = rng.standard_normal((CAP, FEAT))
        x[min(scal[r], CAP):] = np.nan
        rows.append(x)
    return sends, scal, blocks, rows


# name -> op(ragged module, comm, x, rank, case) -> (payload, counts);
# "block" ops take the (n, CAP, FEAT) block, "row" ops the (CAP, FEAT) row.
CASES = {
    "alltoall": ("block", lambda m, c, x, r, k: m.ragged_alltoall(
        c, x, k[0][r])),
    "allgather": ("row", lambda m, c, x, r, k: m.ragged_allgather(
        c, x, k[1][r])),
    "gather_root_last": ("row", lambda m, c, x, r, k: m.ragged_gather(
        c, x, k[1][r], root=c.size - 1)),
    "scatter_root1": ("block", lambda m, c, x, r, k: m.ragged_scatter(
        c, x, k[0][1], root=1)),
}


def _run_jax(n, name, case, ws):
    kind, op = CASES[name]
    data = case[2] if kind == "block" else case[3]

    def body(r):
        k = (jnp.asarray(case[0]), jnp.asarray(case[1]))
        t = jnp.asarray(data[r])
        out, cnt = op(jr, mpi.COMM_WORLD, t, r, k)
        g = jax.grad(lambda v: jnp.sum(
            op(jr, mpi.COMM_WORLD, v, r, k)[0] * jnp.asarray(ws[r])))(t)
        return np.asarray(out), np.asarray(cnt), np.asarray(g)

    return mpi.run_ranks(body, n)


def _run_torch(n, name, case, ws):
    kind, op = CASES[name]
    data = case[2] if kind == "block" else case[3]

    def body(r):
        k = (torch.from_numpy(case[0]), torch.from_numpy(case[1]))
        t = torch.from_numpy(data[r]).requires_grad_()
        out, cnt = op(pr, P.COMM_WORLD, t, r, k)
        (g,) = torch.autograd.grad((out * torch.from_numpy(ws[r])).sum(), t)
        return out.detach().numpy(), cnt.numpy(), g.numpy()

    return P.run_ranks(body, n, device="cpu")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_values_counts_and_grads_bitwise_vs_jax(name, n):
    case = _case(n, seed=n + len(name))
    out_shape = (n, CAP, FEAT) if name != "scatter_root1" else (CAP, FEAT)
    rng = np.random.default_rng(99)
    ws = [rng.standard_normal(out_shape) for _ in range(n)]
    want = _run_jax(n, name, case, ws)
    got = _run_torch(n, name, case, ws)
    for (yg, cg, gg), (yw, cw, gw) in zip(got, want):
        assert _bitwise(yg, yw)
        assert _bitwise(cg, cw)
        assert _bitwise(gg, gw)
        assert np.isfinite(yg).all()          # NaN padding never leaks
        assert np.isfinite(gg).all()


def test_alltoall_routes_and_padding_gets_zero_gradient():
    n = 3
    sends, _, blocks, _ = _case(n, seed=1)
    clamped = np.clip(sends, 0, CAP)

    def body(r):
        x = torch.from_numpy(blocks[r]).requires_grad_()
        recv, rc = pr.ragged_alltoall(P.COMM_WORLD, x, sends[r])
        (g,) = torch.autograd.grad(recv.sum(), x)
        return recv.detach(), rc, g

    outs = P.run_ranks(body, n, device="cpu")
    for dst, (recv, rc, _) in enumerate(outs):
        assert rc.tolist() == clamped[:, dst].tolist()
        for src in range(n):
            k = clamped[src, dst]
            assert torch.equal(recv[src, :k],
                               torch.from_numpy(blocks[src][dst, :k]))
            assert (recv[src, k:] == 0).all()
    for src, (_, _, g) in enumerate(outs):
        mask = np.zeros((n, CAP, FEAT))
        for dst in range(n):
            mask[dst, :clamped[src, dst]] = 1.0
        assert np.array_equal(g.numpy(), mask)


def test_gather_then_scatter_round_trips_the_valid_prefixes():
    n = 4
    _, scal, _, rows = _case(n, seed=2)
    counts = np.clip(scal, 0, CAP)

    def body(r):
        c = P.COMM_WORLD
        g, cnt = pr.ragged_gather(c, torch.from_numpy(rows[r]), scal[r],
                                  root=2)
        back, mine = pr.ragged_scatter(c, g, cnt, root=2)
        return g, cnt, back, mine

    outs = P.run_ranks(body, n, device="cpu")
    g, cnt = outs[2][0], outs[2][1]
    assert cnt.tolist() == counts.tolist()
    packed = torch.cat([g[s, :k] for s, k in enumerate(counts)])
    want = np.concatenate([rows[s][:k] for s, k in enumerate(counts)])
    assert np.array_equal(packed.numpy(), want)
    for r, (gr, cr, back, mine) in enumerate(outs):
        if r != 2:
            assert (gr == 0).all() and (cr == 0).all()
        assert int(mine) == counts[r] and mine.dtype == torch.int64
        assert np.array_equal(back[:counts[r]].numpy(), rows[r][:counts[r]])
        assert (back[counts[r]:] == 0).all()


def test_masks_match_jax():
    for counts in (3, [0, 2, 5], [[1, 4], [0, 2]]):
        assert np.array_equal(pr.segment_mask(counts, 4).numpy(),
                              np.asarray(jr.segment_mask(counts, 4)))
    for pos in (2, [0, 3, 7], -1):
        assert np.array_equal(pr.position_onehot(pos, 5).numpy(),
                              np.asarray(jr.position_onehot(pos, 5)))


def test_validation_matches_jax():
    n = 2

    def calls(m, mod):
        return [
            ("capacity", lambda c: mod.ragged_alltoall(
                c, m.zeros((3, CAP, 1)), m.zeros((n,), dtype=m.int32))),
            ("send_counts", lambda c: mod.ragged_alltoall(
                c, m.zeros((n, CAP, 1)), m.zeros((3,), dtype=m.int32))),
            ("scalar", lambda c: mod.ragged_allgather(
                c, m.zeros((CAP, FEAT)), m.zeros((n,), dtype=m.int32))),
            ("scalar", lambda c: mod.ragged_gather(
                c, m.zeros((CAP, FEAT)), m.zeros((n,), dtype=m.int32))),
            ("counts", lambda c: mod.ragged_scatter(
                c, m.zeros((n, CAP, FEAT)), m.zeros((1,), dtype=m.int32))),
        ]

    def jbody():
        for msg, call in calls(jnp, jr):
            with pytest.raises(ValueError, match=msg):
                call(mpi.COMM_WORLD)
        return True

    def pbody():
        for msg, call in calls(torch, pr):
            with pytest.raises(ValueError, match=msg):
                call(P.COMM_WORLD)
        return True

    assert all(mpi.run_ranks(jbody, n))
    assert all(P.run_ranks(pbody, n, device="cpu"))
