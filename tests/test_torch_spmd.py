"""The port's Mode A (``run_spmd``) against the JAX package, on the CPU.

Mirrors ``tests/test_spmd.py`` class by class, on rank-thread worlds of 8
(and 3, 4, 6) ranks with ``device="cpu"``, plus the parity the port owes:

* against the JAX package's Mode A (``mpi4torch_tpu.run_spmd``) on the
  same seeded numpy inputs: under deterministic mode every Allreduce
  algorithm (ring, rhd, tree, hier, bidir, torus) and every op of the
  table, values and the gradients taken from outside ``run_spmd``, are
  bitwise equal (each rank reads its own row of the input, so the
  replicated input's cotangent sums disjoint rows and is exact in any
  order).  Outside deterministic mode the native collectives fold in
  XLA's order there and in ascending order here: values are held within
  ``NONDET_RTOL`` of JAX's; the explicit ``bidir`` chains stay bitwise;
* against the port's own Mode B (``run_ranks``) on (3,), (8,) and the
  (2, 4) mesh: bitwise per algorithm, values and per-rank gradients,
  under deterministic mode and outside it (where the native forms fold
  in the Mode B order; ``bidir``'s cyclic chains excepted);
* the misuse cases raise the JAX package's error types, and what is
  not ported under Mode A (codecs, ``Reshard``) raises
  ``NotImplementedError`` naming its ROADMAP.md item.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu_torch.ops import spmd as pspmd

NR = 8
# Outside deterministic mode XLA's CPU collectives fold in an order of
# their own; the port folds in ascending rank order.  float64 sums of 8
# standard normals agree within a few ulps of their magnitude.
NONDET_RTOL = 1e-13
ALGOS = ("ring", "rhd", "tree", "hier", "bidir", "torus")

pcomm = P.COMM_WORLD
jcomm = mpi.COMM_WORLD


@pytest.fixture(autouse=True)
def _reset_knobs():
    yield
    P.config.set_ordered_fold_gather_max_bytes(
        P.config.DEFAULT_ORDERED_FOLD_GATHER_MAX_BYTES)
    P.config.set_ordered_ring_chunk_bytes(
        P.config.DEFAULT_ORDERED_RING_CHUNK_BYTES)
    P.config.set_bcast_tree_max_bytes(P.config.DEFAULT_BCAST_TREE_MAX_BYTES)
    P.config.set_phase_pipelined_ring(True)
    P.config.set_hier_group_size(None)
    P.config.set_comm_finite_guard("off")
    mpi.config.set_hier_group_size(None)


def run(fn, n=NR, **kw):
    return P.run_spmd(fn, nranks=n, device="cpu", **kw)


def jrun(fn, n=NR):
    return mpi.run_spmd(fn, nranks=n)


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _np(t):
    return t.detach().numpy()


def _grad(f, x, w=None):
    """Gradient of sum(f(x)) (or vdot(f(x), w)) taken from outside."""
    x = x.detach().clone().requires_grad_()
    out = f(x)
    loss = out.sum() if w is None else torch.vdot(
        out.reshape(-1), torch.as_tensor(w).reshape(-1))
    (g,) = torch.autograd.grad(loss, x)
    return g


def _jpick(x, c):
    return jax.lax.dynamic_index_in_dim(x, jnp.asarray(c.rank + 0), 0,
                                        keepdims=False)


def _both(op, n, x, det=True, seed=0):
    """``op(comm, t)`` on this rank's row ``t`` of ``x``, in both
    packages' Mode A: ``((jax out, jax grad), (port out, port grad))``,
    the gradient that of ``vdot(stacked out, w)`` for a seeded ``w``."""
    jf = jrun(lambda v: op(jcomm, _jpick(v, jcomm)), n)
    pf = run(lambda v: op(pcomm, v[pcomm.rank]), n)
    with mpi.config.deterministic_mode(det):
        jo = np.asarray(jf(jnp.asarray(x)))
        w = np.random.default_rng(seed + 7).standard_normal(
            jo.shape).astype(jo.dtype)
        jg = np.asarray(jax.grad(lambda v: jnp.vdot(
            jf(v), jnp.asarray(w)))(jnp.asarray(x)))
    with P.config.deterministic_mode(det):
        xt = torch.from_numpy(x)
        po = _np(pf(xt))
        pg = _grad(pf, xt, w).numpy()
    return (jo, jg), (po, pg), w


def _mode_b(op, n, x, w):
    """The same op on the port's Mode B: per-rank (out, grad of
    vdot(out, w[r]))."""
    def body(r):
        t = torch.from_numpy(x[r]).requires_grad_()
        out = op(pcomm, t)
        (g,) = torch.autograd.grad(
            torch.vdot(out.reshape(-1), torch.from_numpy(w[r]).reshape(-1)),
            t)
        return _np(out), g.numpy()

    return P.run_ranks(body, n, device="cpu")


def _data(n, *shape, seed=0):
    return np.random.default_rng(seed).standard_normal((n,) + shape)


class TestAllreduceSpmd:
    def test_forward_and_grad(self):
        def fn(x):
            return pcomm.Allreduce(x * (pcomm.rank + 1), P.MPI_SUM)

        out = run(fn)(torch.ones(4, dtype=torch.float64))
        assert out.shape == (NR, 4)
        expect = NR * (NR + 1) / 2
        assert (_np(out) == expect).all()
        g = _grad(run(fn), torch.ones(4, dtype=torch.float64))
        assert (g.numpy() == NR * expect).all()
        # The JAX package's Mode A gives the same numbers.
        jfn = jrun(lambda x: jcomm.Allreduce(x * (jcomm.rank + 1),
                                             mpi.MPI_SUM))
        np.testing.assert_array_equal(np.asarray(jfn(jnp.ones(4))),
                                      _np(out))

    def test_jit_compatible(self):
        # jit= is accepted and the call runs eagerly; a second call with
        # other inputs runs the body again.
        fn = run(lambda x: pcomm.Allreduce(x, P.MPI_SUM), jit=True)
        out1 = fn(torch.ones(3))
        out2 = fn(torch.ones(3) * 2)
        assert (_np(out1) == NR).all()
        assert (_np(out2) == 2 * NR).all()
        assert (_np(run(lambda x: pcomm.Allreduce(x, P.MPI_SUM),
                        jit=False)(torch.ones(3))) == NR).all()

    def test_max_forward_ok_backward_raises(self):
        def fn(x):
            return pcomm.Allreduce(x * (pcomm.rank + 1), P.MPI_MAX)

        out = run(fn)(torch.ones(3))
        assert (_np(out) == NR).all()
        with pytest.raises(RuntimeError, match="MPI_MAX"):
            _grad(run(fn), torch.ones(3))

    def test_prod_and_bitwise_forward(self):
        out = run(lambda x: pcomm.Allreduce(x * 2, P.MPI_PROD))(
            torch.ones(2))
        assert (_np(out) == 2.0 ** NR).all()

        def bor(x):
            t = (x * 0 + (pcomm.rank + 0)).to(torch.int32)
            return pcomm.Allreduce(1 << t, P.MPI_BOR)

        out = run(bor)(torch.zeros(2))
        assert (_np(out) == (1 << NR) - 1).all()

    def test_deterministic_mode_matches_eager_oracle(self):
        # Deterministic SPMD mode is bit for bit the eager runtime's
        # ascending-rank fold, and the JAX package's Mode A.
        data = _data(NR, 513, seed=3).astype(np.float32)

        def fn(x):
            return pcomm.Allreduce(x[pcomm.rank], P.MPI_SUM)

        with P.config.deterministic_mode(True):
            det = _np(run(fn)(torch.from_numpy(data)))
        eager = P.run_ranks(lambda r: _np(pcomm.Allreduce(
            torch.from_numpy(data[r]), P.MPI_SUM)), NR, device="cpu")
        jfn = jrun(lambda x: jcomm.Allreduce(_jpick(x, jcomm), mpi.MPI_SUM))
        with mpi.config.deterministic_mode(True):
            jdet = np.asarray(jfn(jnp.asarray(data)))
        for r in range(NR):
            np.testing.assert_array_equal(det[r], eager[r])
        assert _bitwise(det, jdet)

    @pytest.mark.parametrize("pipelined", [True, False])
    def test_ring_fold_bit_identical_to_gather_fold(self, pipelined):
        # The chunked ring fold (phase-pipelined and two-phase) gives the
        # bits of the all-gather+fold and of the eager oracle; multi-chunk
        # WITH padding (513 f32 / 16-element chunks = 33 chunks).
        data = _data(NR, 513, seed=7).astype(np.float32)

        def fn(x):
            return pcomm.Allreduce(x[pcomm.rank], P.MPI_SUM)

        with P.config.deterministic_mode(True):
            gather_path = _np(run(fn)(torch.from_numpy(data)))
            P.config.set_ordered_fold_gather_max_bytes(0)
            P.config.set_ordered_ring_chunk_bytes(64)
            P.config.set_phase_pipelined_ring(pipelined)
            ring_path = _np(run(fn)(torch.from_numpy(data)))
        np.testing.assert_array_equal(ring_path, gather_path)
        eager = P.run_ranks(lambda r: _np(pcomm.Allreduce(
            torch.from_numpy(data[r]), P.MPI_SUM)), NR, device="cpu")
        for r in range(NR):
            np.testing.assert_array_equal(ring_path[r], eager[r])

    def test_ring_fold_single_chunk_and_exact_multiple(self):
        data = _data(NR, 64, seed=11).astype(np.float32)

        def fn(x):
            return pcomm.Allreduce(x[pcomm.rank], P.MPI_SUM)

        with P.config.deterministic_mode(True):
            want = _np(run(fn)(torch.from_numpy(data)))
            P.config.set_ordered_fold_gather_max_bytes(0)
            for chunk_bytes in (64 * 4, 16 * 4):   # 1 chunk; 4 exact
                P.config.set_ordered_ring_chunk_bytes(chunk_bytes)
                got = _np(run(fn)(torch.from_numpy(data)))
                np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("shape,axis,chunk_bytes", [
        ((NR * 8,), 0, 32), ((NR * 9,), 0, 32), ((NR * 8,), 0, 8 * 4),
        ((3, NR * 4, 2), 1, 32)])
    def test_ring_fold_reduce_scatter_matches(self, shape, axis,
                                              chunk_bytes):
        # The relay-routed ring fold delivers segment s straight to rank s
        # with the slice-before-fold bits (exact chunk multiple, padded
        # last chunk, one chunk a segment, a non-leading axis).
        data = _data(NR, *shape, seed=13).astype(np.float32)

        def fn(x):
            return pcomm.Reduce_scatter(x[pcomm.rank], P.MPI_SUM, axis)

        with P.config.deterministic_mode(True):
            want = _np(run(fn)(torch.from_numpy(data)))
            P.config.set_ordered_fold_gather_max_bytes(0)
            P.config.set_ordered_ring_chunk_bytes(chunk_bytes)
            got = _np(run(fn)(torch.from_numpy(data)))
        np.testing.assert_array_equal(got, want)


class TestReduceScatterSpmd:
    def test_forward_and_identity(self):
        def fn(x):
            rs = pcomm.Reduce_scatter(x * (pcomm.rank + 1), P.MPI_SUM, 0)
            ag = pcomm.Allgather(rs, 0)
            ar = pcomm.Allreduce(x * (pcomm.rank + 1), P.MPI_SUM)
            return rs, ag - ar

        rs, diff = run(fn)(torch.ones(NR * 2))
        assert rs.shape == (NR, 2)
        assert (_np(rs) == NR * (NR + 1) / 2).all()
        assert (_np(diff) == 0).all()

    def test_grad_is_allgather(self):
        def fn(x):
            rs = pcomm.Reduce_scatter(x, P.MPI_SUM, 0)
            w = (pcomm.rank + 1) * torch.ones((), dtype=rs.dtype)
            return torch.sum(w * rs)

        g = _grad(run(fn), torch.ones(NR * 2, dtype=torch.float64))
        want = np.repeat(np.arange(1, NR + 1, dtype=float), 2) * NR
        np.testing.assert_array_equal(g.numpy(), want)

    def test_non_sum_forward_ok_backward_raises(self):
        def fn(x):
            return pcomm.Reduce_scatter(x * (pcomm.rank + 1), P.MPI_MAX, 0)

        out = run(fn)(torch.ones(NR))
        assert (_np(out) == NR).all()
        with pytest.raises(RuntimeError, match="MPI_MAX"):
            _grad(run(fn), torch.ones(NR))

    def test_deterministic_mode_matches_eager_order(self):
        def fn(x):
            rs = pcomm.Reduce_scatter(x * (pcomm.rank + 1), P.MPI_SUM, 0)
            ar = pcomm.Allreduce(x * (pcomm.rank + 1), P.MPI_SUM)
            return pcomm.Allgather(rs, 0) - ar

        with P.config.deterministic_mode(True):
            diff = run(fn)(torch.ones(NR * 2))
        assert (_np(diff) == 0).all()

    def test_indivisible_axis_raises(self):
        with pytest.raises(P.CommError, match="divisible"):
            run(lambda x: pcomm.Reduce_scatter(x, P.MPI_SUM, 0))(
                torch.ones(NR + 1))


class TestBcastReduceSpmd:
    def test_bcast_forward_and_grad(self):
        def fn(x):
            return pcomm.Bcast_(x * (pcomm.rank + 1), 2)

        out = _np(run(fn)(torch.ones(3)))
        assert (out == 3.0).all()
        g = _grad(run(fn), torch.ones(3))
        assert (g.numpy() == NR * 3.0).all()

    def test_reduce_zeroes_nonroot(self):
        def fn(x):
            return pcomm.Reduce_(x * (pcomm.rank + 1), P.MPI_SUM, 0)

        out = _np(run(fn)(torch.ones(3)))
        assert (out[0] == NR * (NR + 1) / 2).all()
        assert (out[1:] == 0).all()

    def test_bcast_reduce_adjoint_pair(self):
        g = _grad(run(lambda x: pcomm.Reduce_(x, P.MPI_SUM, 0)),
                  torch.ones(3))
        assert (g.numpy() == NR).all()


class TestShardOpsSpmd:
    def test_allgather_roundtrip_and_grad(self):
        def fn(x):
            return pcomm.Allgather(x * (pcomm.rank + 1), 0)

        out = _np(run(fn)(torch.ones((2, 3))))
        assert out.shape == (NR, 2 * NR, 3)
        for r in range(NR):
            for k in range(NR):
                assert (out[r, 2 * k:2 * k + 2] == k + 1).all()
        g = _grad(run(fn), torch.ones((2, 3)))
        assert (g.numpy() == NR * NR * (NR + 1) / 2).all()

    def test_gather_root_only(self):
        out = _np(run(lambda x: pcomm.Gather(x * (pcomm.rank + 1), 0, 3))(
            torch.ones((1, 2))))
        assert out.shape == (NR, NR, 2)
        for k in range(NR):
            assert (out[3, k] == k + 1).all()
        assert (out[np.arange(NR) != 3] == 0).all()

    def test_gather_grad_is_ones(self):
        g = _grad(run(lambda x: pcomm.Gather(x * (pcomm.rank + 1), 0, 0)),
                  torch.ones((1, 2)))
        assert (g.numpy() == NR * (NR + 1) / 2).all()

    def test_scatter_gather_identity(self):
        def fn(x):
            t = x * (pcomm.rank + 1)
            full = pcomm.Allgather(t, 0)
            return pcomm.Scatter(full, 0, 2, 0) - t

        assert (_np(run(fn)(torch.ones((2, 3)))) == 0).all()

    def test_scatter_numelem_validation(self):
        with pytest.raises(ValueError, match="numelem"):
            run(lambda x: pcomm.Scatter(x, 0, 3, 0))(torch.ones((NR * 2, 2)))

    def test_alltoall_involution_and_grad(self):
        def fn(x):
            t = x * (pcomm.rank + 1)
            y = pcomm.Alltoall(t, 0, 1, 1)
            return pcomm.Alltoall(y, 1, 0, 2) - t

        assert (_np(run(fn)(torch.ones((2, NR)))) == 0).all()
        g = _grad(run(lambda x: pcomm.Alltoall(x * (pcomm.rank + 1), 0, 1,
                                               1)), torch.ones((2, NR)))
        assert (g.numpy() == NR * (NR + 1) / 2).all()


def _ring_isendirecv(c, mod, a0):
    a = a0 * (1.0 + c.rank)
    req = c.Isend(a, (c.rank + 1) % c.size, 0)
    req2 = c.Irecv(mod.JoinDummies(torch.empty_like(a), [req.dummy]),
                   (c.rank + c.size - 1) % c.size, 0)
    res = c.Wait(mod.JoinDummiesHandle(req, [req2.dummy]))
    res2 = c.Wait(mod.JoinDummiesHandle(req2, [res]))
    return res2 * c.rank


def _ring_isendrecv(c, mod, a0):
    a = a0 * (1.0 + c.rank)
    req = c.Isend(a, (c.rank + 1) % c.size, 0)
    res = c.Recv(mod.JoinDummies(torch.empty_like(a), [req.dummy]),
                 (c.rank + c.size - 1) % c.size, 0)
    res2 = c.Wait(mod.JoinDummiesHandle(req, [res]))
    return mod.JoinDummies(res, [res2]) * c.rank


def _ring_irecvsend(c, mod, a0):
    a = a0 * (1.0 + c.rank)
    req = c.Irecv(mod.JoinDummies(torch.empty_like(a), [a]),
                  (c.rank + c.size - 1) % c.size, 0)
    res = c.Send(a, (c.rank + 1) % c.size, 0)
    res2 = c.Wait(mod.JoinDummiesHandle(req, [res]))
    return res2 * c.rank


class TestP2PSpmd:
    @pytest.mark.parametrize("prog", [_ring_isendirecv, _ring_isendrecv,
                                      _ring_irecvsend])
    def test_ring_three_orderings(self, prog):
        def f(a0):
            return prog(pcomm, P, a0)

        out = _np(run(f)(torch.ones(2)))
        for r in range(NR):
            assert (out[r] == (1.0 + (r - 1 + NR) % NR) * r).all()
        g = _grad(run(f), torch.ones(2))
        expect = sum((1 + r) * ((r + 1) % NR) for r in range(NR))
        assert (g.numpy() == expect).all()

    def test_longer_shift(self):
        def prog(a0):
            a = a0 * (1.0 + pcomm.rank)
            h = pcomm.Isend(a, (pcomm.rank + 3) % pcomm.size, 7)
            b = pcomm.Recv(P.JoinDummies(torch.empty_like(a), [h.dummy]),
                           (pcomm.rank - 3) % pcomm.size, 7)
            pcomm.Wait(P.JoinDummiesHandle(h, [b]))
            return b

        out = _np(run(prog)(torch.ones(1)))
        for r in range(NR):
            assert out[r, 0] == 1.0 + (r - 3) % NR

    def test_unmatched_send_trace_time_deadlock(self):
        def prog(a):
            pcomm.Isend(a, (pcomm.rank + 1) % pcomm.size, 0)
            return a

        with pytest.raises(P.DeadlockError,
                           match="unmatched.*ring shift 1"):
            run(prog)(torch.ones(1))

    def test_wait_unmatched_recv_raises(self):
        def prog(a):
            h = pcomm.Irecv(torch.empty_like(a),
                            (pcomm.rank - 1) % pcomm.size, 0)
            return pcomm.Wait(h)

        with pytest.raises(P.DeadlockError, match="before the matching"):
            run(prog)(torch.ones(1))

    def test_blocking_send_recv_ring(self):
        def prog(a0):
            a = a0 * (1.0 + pcomm.rank)
            pcomm.Send(a, (pcomm.rank + 1) % pcomm.size, 0)
            return pcomm.Recv(torch.empty_like(a),
                              (pcomm.rank - 1) % pcomm.size, 0)

        out = _np(run(prog)(torch.ones(2)))
        for r in range(NR):
            assert (out[r] == 1.0 + (r - 1) % NR).all()

    def test_unwrapped_destination_rejected(self):
        def prog(a):
            return pcomm.Wait(pcomm.Isend(a, pcomm.rank + 1, 0))

        with pytest.raises(P.CommError, match="out of range"):
            run(prog)(torch.ones(1))

    def test_rankexpr_arith_after_wrap_materializes(self):
        out = _np(run(lambda x: x * (((pcomm.rank + 1) % pcomm.size) + 1))(
            torch.ones(1)))
        assert out.ravel().tolist() == [(r + 1) % NR + 1 for r in range(NR)]


def _exchange(c, mod, dest, src, tag=0, scale_out=False):
    def prog(a0):
        a = a0 * (1.0 + c.rank)
        h = c.Isend(a, dest(c), tag)
        b = c.Recv(mod.JoinDummies(torch.empty_like(a), [h.dummy]),
                   src(c), tag)
        c.Wait(mod.JoinDummiesHandle(h, [b]))
        return b * (1.0 + c.rank) if scale_out else b
    return prog


class TestGeneralPermutationsP2P:
    def test_butterfly_xor(self):
        prog = _exchange(pcomm, P, lambda c: c.rank ^ 1, lambda c: c.rank ^ 1)
        out = _np(run(prog)(torch.ones(2)))
        for r in range(NR):
            assert (out[r] == 1.0 + (r ^ 1)).all()

    def test_butterfly_gradient_crosschecked_with_eager(self):
        # The gradient travels the butterfly backwards; the eager runtime
        # (concrete destinations) is the oracle.
        prog = _exchange(pcomm, P, lambda c: c.rank ^ 2,
                         lambda c: c.rank ^ 2, tag=3, scale_out=True)
        g_spmd = _grad(run(prog), torch.ones(2, dtype=torch.float64))

        def body():
            x = torch.ones(2, dtype=torch.float64, requires_grad=True)
            (g,) = torch.autograd.grad(prog(x).sum(), x)
            return g

        g_eager = sum(P.run_ranks(body, NR, device="cpu"))
        np.testing.assert_array_equal(g_spmd.numpy(), g_eager.numpy())

    def test_explicit_table_reversal(self):
        table = [NR - 1 - r for r in range(NR)]
        prog = _exchange(pcomm, P, lambda c: table, lambda c: table)
        out = _np(run(prog)(torch.ones(1)))
        for r in range(NR):
            assert out[r, 0] == 1.0 + (NR - 1 - r)

    def test_non_involution_table(self):
        dest = list(range(NR))
        dest[0], dest[1], dest[2] = 1, 2, 0          # 0->1->2->0
        src = [0] * NR
        for r, d in enumerate(dest):
            src[d] = r
        prog = _exchange(pcomm, P, lambda c: dest, lambda c: src)
        out = _np(run(prog)(torch.ones(1)))
        for r in range(NR):
            assert out[r, 0] == 1.0 + src[r]

    @pytest.mark.parametrize("spell", ["rank", "shift0"])
    def test_self_send(self, spell):
        peer = (lambda c: c.rank) if spell == "rank" else \
            (lambda c: (c.rank + c.size) % c.size)
        out = _np(run(_exchange(pcomm, P, peer, peer))(torch.ones(2)))
        for r in range(NR):
            assert (out[r] == 1.0 + r).all()

    def test_non_bijection_table_rejected(self):
        with pytest.raises(P.CommError, match="not a permutation"):
            run(lambda a: pcomm.Wait(pcomm.Isend(a, [0] * NR, 0)))(
                torch.ones(1))

    def test_xor_out_of_range_rejected(self):
        with pytest.raises(P.CommError, match="leaves"):
            run(lambda a: pcomm.Wait(pcomm.Isend(a, pcomm.rank ^ (NR + 1),
                                                 0)))(torch.ones(1))

    def test_ring_and_butterfly_do_not_cross_match(self):
        def prog(a):
            pcomm.Isend(a, (pcomm.rank + 1) % pcomm.size, 0)
            pcomm.Irecv(torch.empty_like(a), pcomm.rank ^ 1, 0)
            return a

        with pytest.raises(P.DeadlockError, match="unmatched"):
            run(prog)(torch.ones(1))


class TestEagerPeerTables:
    def test_table_program_runs_on_both_backends(self):
        table = [NR - 1 - r for r in range(NR)]
        prog = _exchange(pcomm, P, lambda c: table, lambda c: table, tag=2)
        spmd = _np(run(prog)(torch.ones(2)))
        eager = P.run_ranks(lambda: _np(prog(torch.ones(2))), NR,
                            device="cpu")
        for r in range(NR):
            np.testing.assert_array_equal(eager[r], spmd[r])

    def test_wrong_length_table_rejected_eager(self):
        def body():
            with pytest.raises(P.CommError, match="entries"):
                pcomm.Isend(torch.ones(1), [0] * (4 + 1), 0)

        P.run_ranks(body, 4, device="cpu")


class TestEagerSelfSend:
    def test_self_send_eager(self):
        def body():
            a = torch.ones(2) * (1.0 + pcomm.rank)
            h = pcomm.Isend(a, pcomm.rank, 0)
            b = pcomm.Recv(P.JoinDummies(torch.empty_like(a), [h.dummy]),
                           pcomm.rank, 0)
            pcomm.Wait(P.JoinDummiesHandle(h, [b]))
            assert (_np(b) == 1.0 + pcomm.rank).all()

        P.run_ranks(body, 4, device="cpu")


class TestDeterministicToggle:
    def test_toggle_after_first_call_rereads(self):
        # The flag is read at each call: flipping it after the first call
        # changes the schedule the next call runs.
        data = _data(NR, 127, seed=5).astype(np.float32)
        f = run(lambda x: pcomm.Allreduce(x[pcomm.rank], P.MPI_SUM))
        f(torch.from_numpy(data))
        with P.config.deterministic_mode(True):
            det = _np(f(torch.from_numpy(data)))
        oracle = data[0].copy()
        for r in range(1, NR):
            oracle = oracle + data[r]
        np.testing.assert_array_equal(det[0], oracle)

    def test_double_wait_raises(self):
        def prog(a):
            h = pcomm.Isend(a, (pcomm.rank + 1) % pcomm.size, 0)
            b = pcomm.Recv(torch.empty_like(a),
                           (pcomm.rank - 1) % pcomm.size, 0)
            pcomm.Wait(h)
            pcomm.Wait(h)
            return b

        with pytest.raises(P.BifurcationError, match="already waited"):
            run(prog)(torch.ones(1))

    def test_spliced_handle_raises(self):
        def prog(a):
            h = pcomm.Isend(a, (pcomm.rank + 1) % pcomm.size, 0)
            b = pcomm.Recv(torch.empty_like(a),
                           (pcomm.rank - 1) % pcomm.size, 0)
            pcomm.Wait(P.WaitHandle([h._handle[0], b, b]))
            return b

        with pytest.raises(P.BifurcationError, match="bifurcation"):
            run(prog)(torch.ones(1))

    def test_literal_destination_rejected(self):
        with pytest.raises(P.CommError, match="static permutation"):
            run(lambda a: pcomm.Wait(pcomm.Isend(a, 3, 0)))(torch.ones(1))


class TestCrossBackendEquivalence:
    def test_allreduce_program(self):
        data = _data(NR, 64, seed=11)

        def fn(x):
            return pcomm.Allreduce(x[pcomm.rank], P.MPI_SUM) * (pcomm.rank
                                                                + 1)

        spmd = _np(run(fn)(torch.from_numpy(data)))
        eager = P.run_ranks(lambda r: _np(pcomm.Allreduce(
            torch.from_numpy(data[r]), P.MPI_SUM) * (r + 1)), NR,
            device="cpu")
        for r in range(NR):
            np.testing.assert_array_equal(spmd[r], eager[r])

    def test_ring_program(self):
        def prog(x):
            a = x * (1.0 + pcomm.rank)
            h = pcomm.Isend(a, (pcomm.rank + 1) % pcomm.size, 0)
            b = pcomm.Recv(P.JoinDummies(torch.empty_like(a), [h.dummy]),
                           (pcomm.rank - 1) % pcomm.size, 0)
            w = pcomm.Wait(P.JoinDummiesHandle(h, [b]))
            return P.JoinDummies(a + b, [w])

        spmd = _np(run(prog)(torch.ones(3)))
        eager = P.run_ranks(lambda: _np(prog(torch.ones(3))), NR,
                            device="cpu")
        for r in range(NR):
            np.testing.assert_array_equal(spmd[r], eager[r])


def _cpu_mesh(axes):
    return P.device_mesh(axes, devices=[torch.device("cpu")]
                         * int(np.prod(list(axes.values()))))


class TestCommFromMesh:
    def test_mesh_axis_communicator(self):
        # comm_from_mesh inside run_spmd(mesh=): each rank's shard of
        # arange(8); the axis sum on every rank.
        mesh = _cpu_mesh({"workers": 4})
        c = P.comm_from_mesh(mesh, "workers")
        assert c.size == 4
        out = P.run_spmd(lambda x: c.Allreduce(
            x.reshape(4, 2)[c.rank], P.MPI_SUM), mesh=mesh,
            axis_name="workers")(torch.arange(8.0))
        assert (_np(out).reshape(-1) == np.tile([12.0, 16.0], 4)).all()

    def test_p2p_through_mesh_communicator(self):
        mesh = _cpu_mesh({"w": NR})
        c = P.comm_from_mesh(mesh, "w")

        def ring(x):
            a = x[c.rank]
            h = c.Isend(a, (c.rank + 1) % c.size, 0)
            b = c.Recv(P.JoinDummies(torch.empty_like(a), [h.dummy]),
                       (c.rank - 1) % c.size, 0)
            return P.JoinDummies(b, [c.Wait(P.JoinDummiesHandle(h, [b]))])

        out = P.run_spmd(ring, mesh=mesh, axis_name="w")(torch.arange(8.0))
        assert _np(out).tolist() == [7., 0., 1., 2., 3., 4., 5., 6.]

    def test_bad_axis_rejected(self):
        with pytest.raises(P.CommError, match="axis"):
            P.comm_from_mesh(_cpu_mesh({"w": 2}), "nope")
        with pytest.raises(P.CommError, match="axis"):
            P.run_spmd(lambda x: x, mesh=_cpu_mesh({"w": 2}))

    def test_p2p_scope_matches_and_returns_values(self):
        mesh = _cpu_mesh({"w": NR})
        c = P.comm_from_mesh(mesh, "w")

        def ring(x):
            a = x[c.rank]
            with P.p2p_scope(c):
                h = c.Isend(a, (c.rank + 1) % c.size, 0)
                b = c.Recv(P.JoinDummies(torch.empty_like(a), [h.dummy]),
                           (c.rank - 1) % c.size, 0)
                w = c.Wait(P.JoinDummiesHandle(h, [b]))
            return P.JoinDummies(b, [w])

        out = P.run_spmd(ring, mesh=mesh, axis_name="w")(torch.arange(8.0))
        assert _np(out).tolist() == [7., 0., 1., 2., 3., 4., 5., 6.]

    def test_p2p_scope_raises_on_unmatched_send(self):
        mesh = _cpu_mesh({"w": NR})
        c = P.comm_from_mesh(mesh, "w")
        seen = []

        def lonely_send(x):
            try:
                with P.p2p_scope(c):
                    h = c.Isend(x, (c.rank + 1) % c.size, 0)
            except P.DeadlockError as e:
                # The scope raised at its own exit, not at the region's.
                seen.append(str(e))
                raise
            return P.JoinDummies(x, [h.dummy])

        with pytest.raises(P.DeadlockError, match="unmatched"):
            P.run_spmd(lonely_send, mesh=mesh, axis_name="w")(torch.ones(2))
        assert len(seen) == NR

    def test_p2p_scope_rejects_non_mesh_comm(self):
        with pytest.raises(P.CommError, match="mesh-derived"):
            with P.p2p_scope(P.COMM_WORLD):
                pass

    def test_mesh_communicator_refuses_pickling(self):
        c = P.comm_from_mesh(_cpu_mesh({"w": 2}), "w")
        with pytest.raises(pickle.PicklingError, match="only COMM_WORLD"):
            pickle.dumps(c)
        assert pickle.loads(pickle.dumps(P.COMM_WORLD)) is P.COMM_WORLD
        tier = P.comm_from_mesh(_cpu_mesh({"a": 2, "b": 2}), ("a", "b"))
        with pytest.raises(pickle.PicklingError):
            pickle.dumps(tier)


class TestAlltoallCrossModeParity:
    """Alltoall Mode A against Mode B and JAX's Mode A, bitwise, forward
    and backward, on (3,), (8,) and per axis of the (2, 4) mesh."""

    @staticmethod
    def _data(n, k=4):
        return np.random.default_rng(n).standard_normal((n, n * k))

    @pytest.mark.parametrize("n", [3, 8])
    def test_forward_and_backward_bitwise(self, n):
        data = self._data(n)
        w = np.random.default_rng(n + 100).standard_normal(
            (n, n, data.shape[1] // n))

        def op(c, t):
            return c.Alltoall(t.reshape(n, -1), gatheraxis=1,
                              scatteraxis=0, numelem=1)

        (jo, jg), (po, pg), _ = _both(op, n, data)
        assert _bitwise(po, jo) and _bitwise(pg, jg)
        wb = np.stack([np.asarray(w[r]) for r in range(n)])
        xt = torch.from_numpy(data)
        pf = run(lambda v: op(pcomm, v[pcomm.rank]), n)
        po2 = _np(pf(xt))
        pg2 = _grad(pf, xt, wb).numpy()
        for r, (bo, bg) in enumerate(_mode_b(op, n, data, wb)):
            assert _bitwise(po2[r], bo) and _bitwise(pg2[r], bg), r

    def test_2d_mesh_per_axis_vs_local_oracle(self):
        mesh = _cpu_mesh({"a": 2, "b": 4})
        data = np.random.default_rng(7).standard_normal((2, 4, 4, 6))
        for axis, size in (("a", 2), ("b", 4)):
            c = P.comm_from_mesh(mesh, axis)
            ca = P.comm_from_mesh(mesh, "a")
            cb = P.comm_from_mesh(mesh, "b")

            def body(x):
                t = x[ca.rank][cb.rank].reshape(size, -1)
                return c.Alltoall(t, gatheraxis=1, scatteraxis=0, numelem=1)

            out = _np(P.run_spmd(body, mesh=mesh, axis_name="a")(
                torch.from_numpy(data))).reshape(2, 4, 1, -1)
            for ra in range(2):
                for rb in range(4):
                    group = [(i, rb) for i in range(2)] if axis == "a" \
                        else [(ra, j) for j in range(4)]
                    pos = group.index((ra, rb))
                    want = np.concatenate(
                        [data[g].reshape(size, -1)[pos].reshape(1, -1)
                         for g in group], axis=1)
                    assert np.array_equal(out[ra, rb], want), (axis, ra, rb)


# ---------------------------------------------------------------------------
# Per-algorithm parity: JAX's Mode A, the port's Mode B, the mesh forms
# ---------------------------------------------------------------------------

def _algos_for(n):
    out = []
    for a in ALGOS:
        if a == "rhd" and n & (n - 1):
            continue
        if a in ("hier", "torus") and all(n % g for g in range(2, n)):
            continue
        out.append(a)
    return out


def _allreduce_op(algo, op=3):
    return lambda c, t: c.Allreduce(t, op, algorithm=algo)


class TestAlgorithmParityWithJax:
    @pytest.mark.parametrize("n,algo", [(n, a) for n in (6, 8)
                                        for a in _algos_for(n)])
    def test_deterministic_bitwise(self, n, algo):
        # 1000 f64 elements: the gathered bytes stay under the gather
        # threshold; the ring-fold form is pinned below.
        x = _data(n, 1000, seed=n)
        (jo, jg), (po, pg), _ = _both(_allreduce_op(algo), n, x, det=True)
        assert _bitwise(po, jo), algo
        assert _bitwise(pg, jg), algo

    @pytest.mark.parametrize("algo", ["ring", "bidir"])
    def test_deterministic_ring_fold_bitwise(self, algo):
        x = _data(NR, 513, seed=4).astype(np.float32)
        P.config.set_ordered_fold_gather_max_bytes(0)
        P.config.set_ordered_ring_chunk_bytes(64)
        mpi.config.set_ordered_fold_gather_max_bytes(0)
        mpi.config.set_ordered_ring_chunk_bytes(64)
        try:
            (jo, jg), (po, pg), _ = _both(_allreduce_op(algo), NR, x)
        finally:
            mpi.config.set_ordered_fold_gather_max_bytes(
                mpi.config.DEFAULT_ORDERED_FOLD_GATHER_MAX_BYTES)
            mpi.config.set_ordered_ring_chunk_bytes(
                mpi.config.DEFAULT_ORDERED_RING_CHUNK_BYTES)
        assert _bitwise(po, jo) and _bitwise(pg, jg)

    @pytest.mark.parametrize("algo", ["ring", "rhd", "tree", "hier",
                                      "bidir", "torus"])
    def test_nondeterministic(self, algo):
        # The explicit schedules (rhd, tree, the bidir chains) are bitwise
        # JAX's anyway; the native collectives (ring's psum, the hier and
        # torus grouped triples) agree within NONDET_RTOL.
        x = _data(NR, 1000, seed=21)
        (jo, jg), (po, pg), _ = _both(_allreduce_op(algo), NR, x, det=False)
        if algo in ("rhd", "tree", "bidir"):
            assert _bitwise(po, jo) and _bitwise(pg, jg), algo
        np.testing.assert_allclose(po, jo, rtol=NONDET_RTOL, atol=1e-13)
        np.testing.assert_allclose(pg, jg, rtol=NONDET_RTOL, atol=1e-13)

    @pytest.mark.parametrize("op", [1, 2, 4])
    def test_non_sum_ops_bitwise(self, op):
        x = _data(NR, 33, seed=op)
        jf = jrun(lambda v: jcomm.Allreduce(_jpick(v, jcomm), op))
        pf = run(lambda v: pcomm.Allreduce(v[pcomm.rank], op))
        for det in (True, False):
            with mpi.config.deterministic_mode(det), \
                    P.config.deterministic_mode(det):
                assert _bitwise(_np(pf(torch.from_numpy(x))),
                                np.asarray(jf(jnp.asarray(x))))


# The op table: name -> op(comm, t) in both packages, on (3, 4)-shaped
# (or flat) rows.
TABLE = {
    "bcast_ring": lambda c, t: c.Bcast_(t, 1, algorithm="ring"),
    "bcast_tree": lambda c, t: c.Bcast_(t, c.size - 1, algorithm="tree"),
    "bcast_auto": lambda c, t: c.Bcast_(t, 2),
    "reduce_ring": lambda c, t: c.Reduce_(t, 3, 1, algorithm="ring"),
    "reduce_tree": lambda c, t: c.Reduce_(t, 3, 2, algorithm="tree"),
    "allgather": lambda c, t: c.Allgather(t.reshape(2, -1), 1),
    "gather": lambda c, t: c.Gather(t, 0, 2),
    "scatter": lambda c, t: c.Scatter(t.reshape(-1, 3)[:c.size * 2], 0, 2,
                                      1),
    "alltoall": lambda c, t: c.Alltoall(t.reshape(c.size, -1), 1, 0, 1),
    "reduce_scatter": lambda c, t: c.Reduce_scatter(
        t.reshape(c.size, -1), 3, 0),
}
# Whose value or gradient folds real sums in a native collective outside
# deterministic mode (the masked psums add zeros only: exact).
NATIVE_SUMS = {"allgather", "reduce_ring", "reduce_scatter"}


class TestOpTableParity:
    @pytest.mark.parametrize("name", sorted(TABLE))
    @pytest.mark.parametrize("n", [3, NR])
    def test_vs_jax_mode_a(self, name, n):
        x = _data(n, n * 6, seed=len(name) + n)
        op = TABLE[name]
        (jo, jg), (po, pg), _ = _both(op, n, x, det=True)
        assert _bitwise(po, jo), name
        assert _bitwise(pg, jg), name
        (jo, jg), (po, pg), _ = _both(op, n, x, det=False)
        if name in NATIVE_SUMS:
            np.testing.assert_allclose(po, jo, rtol=NONDET_RTOL, atol=1e-14)
            np.testing.assert_allclose(pg, jg, rtol=NONDET_RTOL, atol=1e-14)
        else:
            assert _bitwise(po, jo) and _bitwise(pg, jg), name

    @pytest.mark.parametrize("name", sorted(TABLE))
    def test_vs_mode_b(self, name):
        n = 3
        x = _data(n, n * 6, seed=len(name))
        op = TABLE[name]
        pf = run(lambda v: op(pcomm, v[pcomm.rank]), n)
        po = _np(pf(torch.from_numpy(x)))
        w = np.random.default_rng(1).standard_normal(po.shape)
        pg = _grad(pf, torch.from_numpy(x), w).numpy()
        for r, (bo, bg) in enumerate(_mode_b(op, n, x, w)):
            if name.startswith("bcast") or name == "scatter":
                # The masked psum adds zeros; Mode B copies: equal values
                # (no -0.0 in the data).
                np.testing.assert_array_equal(po[r], bo)
            else:
                assert _bitwise(po[r], bo), (name, r)
            np.testing.assert_array_equal(pg[r], bg)


class TestModeAvsModeB:
    # bidir's cyclic chains fold in another order than Mode B's
    # ascending fold outside deterministic mode (they are held bitwise to
    # JAX's Mode A above), so that pair is not in the grid.
    @pytest.mark.parametrize("n,algo,det", [
        (n, a, det) for n in (3, NR) for a in _algos_for(n)
        for det in (True, False) if not (a == "bidir" and not det)])
    def test_allreduce_bitwise(self, n, algo, det):
        x = _data(n, 777, seed=n + 1)
        w = _data(n, 777, seed=n + 2)
        op = _allreduce_op(algo)
        pf = run(lambda v: op(pcomm, v[pcomm.rank]), n)
        with P.config.deterministic_mode(det):
            po = _np(pf(torch.from_numpy(x)))
            pg = _grad(pf, torch.from_numpy(x), w).numpy()
        for r, (bo, bg) in enumerate(_mode_b(op, n, x, w)):
            assert _bitwise(po[r], bo), (algo, r)
            assert _bitwise(pg[r], bg), (algo, r)

    @pytest.mark.parametrize("algo", ["hier", "ring", "torus"])
    @pytest.mark.parametrize("det", [True, False])
    def test_2d_mesh_tier_stack_bitwise(self, algo, det):
        # comm_from_mesh(mesh, ("dp", "tp")) on the (2, 4) world: the
        # 2-level schedule keyed off the axes equals Mode B's hier with a
        # group of 4 (and its torus with inner 4), bitwise; its flat ring
        # is Mode B's ring outside deterministic mode and, as in the JAX
        # package, the grouped fold under it.
        mesh = _cpu_mesh({"dp": 2, "tp": 4})
        tier = P.comm_from_mesh(mesh, ("dp", "tp"))
        x = _data(NR, 301, seed=9)
        w = _data(NR, 301, seed=10)
        pf = P.run_spmd(lambda v: tier.Allreduce(v[tier.rank], P.MPI_SUM,
                                                 algorithm=algo),
                        mesh=mesh, axis_name="dp")
        with P.config.deterministic_mode(det):
            po = _np(pf(torch.from_numpy(x)))
            pg = _grad(pf, torch.from_numpy(x), w).numpy()
        P.config.set_hier_group_size(4)
        oracle = "hier" if (algo == "ring" and det) else algo
        for r, (bo, bg) in enumerate(_mode_b(_allreduce_op(oracle), NR, x,
                                             w)):
            assert _bitwise(po[r], bo), (algo, r)
            assert _bitwise(pg[r], bg), (algo, r)

    def test_2d_mesh_axis_allreduce(self):
        mesh = _cpu_mesh({"dp": 2, "tp": 4})
        dp, tp = P.comm_from_mesh(mesh, "dp"), P.comm_from_mesh(mesh, "tp")
        x = _data(NR, 10, seed=3)

        def body(v):
            t = v[dp.rank * 4 + tp.rank]
            return dp.Allreduce(t, P.MPI_SUM), tp.Allreduce(t, P.MPI_SUM)

        a, b = P.run_spmd(body, mesh=mesh, axis_name="dp")(
            torch.from_numpy(x))
        for r in range(NR):
            i, j = divmod(r, 4)
            np.testing.assert_array_equal(_np(a)[r], x[j] + x[4 + j])
            want = x[4 * i]
            for k in range(1, 4):
                want = want + x[4 * i + k]
            np.testing.assert_array_equal(_np(b)[r], want)

    def test_tier_stack_refuses_other_ops(self):
        mesh = _cpu_mesh({"dp": 2, "tp": 2})
        tier = P.comm_from_mesh(mesh, ("dp", "tp"))
        with pytest.raises(P.CommError, match="Allreduce only"):
            P.run_spmd(lambda x: tier.Allgather(x, 0), mesh=mesh,
                       axis_name="dp")(torch.ones(2))
        with pytest.raises(P.CommError, match="single-axis"):
            P.run_spmd(lambda x: tier.Allreduce(x, P.MPI_SUM,
                                                algorithm="rhd"),
                       mesh=mesh, axis_name="dp")(torch.ones(2))


class TestSplitPhaseSpmd:
    @pytest.mark.parametrize("det", [True, False])
    def test_starts_equal_blocking(self, det):
        x = _data(NR, 37, seed=2)

        def body(v):
            t = v[pcomm.rank]
            ar = pcomm.Wait(pcomm.Allreduce_start(t, P.MPI_SUM))
            rs = pcomm.Wait(pcomm.Reduce_scatter_start(t[:32], P.MPI_SUM, 0))
            ag = pcomm.Wait(pcomm.Allgather_start(t, 0))
            return (ar - pcomm.Allreduce(t, P.MPI_SUM),
                    rs - pcomm.Reduce_scatter(t[:32], P.MPI_SUM, 0),
                    ag - pcomm.Allgather(t, 0))

        with P.config.deterministic_mode(det):
            outs = run(body)(torch.from_numpy(x))
        assert all((_np(o) == 0).all() for o in outs)
        g = _grad(lambda v: run(lambda u: pcomm.Wait(pcomm.Allreduce_start(
            u[pcomm.rank], P.MPI_SUM)))(v), torch.from_numpy(x))
        np.testing.assert_array_equal(g.numpy(), np.full_like(x, NR))

    def test_unwaited_start_raises(self):
        def body(v):
            pcomm.Allreduce_start(v, P.MPI_SUM)
            return v

        with pytest.raises(P.DeadlockError, match="Allreduce_start"):
            run(body)(torch.ones(4))

    def test_double_wait_raises(self):
        def body(v):
            h = pcomm.Allreduce_start(v, P.MPI_SUM)
            pcomm.Wait(h)
            return pcomm.Wait(h)

        with pytest.raises(P.BifurcationError, match="already waited"):
            run(body)(torch.ones(4))


class TestModeAContract:
    def test_rank_is_symbolic(self):
        def body(x):
            assert isinstance(pcomm.rank, P.RankExpr)
            assert pcomm.size == 4
            with pytest.raises(P.CommError, match="symbolic"):
                int(pcomm.rank)
            with pytest.raises(P.CommError, match="symbolic"):
                [0, 1][pcomm.rank]
            assert isinstance(pcomm.rank ^ 1, P.PermRank)
            return x * (pcomm.rank == 2)

        assert _np(run(body, 4)(torch.ones(1))).ravel().tolist() == \
            [0, 0, 1, 0]

    def test_codec_raises_naming_its_item(self):
        # Ported (ROADMAP.md Queue 1 item 4.9): a codec under Mode A runs
        # the compressed SPMD collectives, explicit or from the scope, for
        # the fused path as well; an integer payload has no codec.
        x = torch.from_numpy(_data(2, 600, seed=3).astype(np.float32))
        mode_b = P.run_ranks(lambda r: pcomm.Allreduce(
            x[r].clone(), P.MPI_SUM, compression="q8"), 2, device="cpu")
        for kw in (dict(compression="q8"), dict(compression="bf16")):
            out = run(lambda v: pcomm.Allreduce(v[pcomm.rank], P.MPI_SUM,
                                                **kw), 2)(x)
            assert torch.equal(out[0], out[1])
            assert not torch.equal(out[0], x.sum(0))
        assert torch.equal(out[0], run(lambda v: pcomm.Allreduce(
            v[pcomm.rank], P.MPI_SUM, compression="bf16"), 2)(x)[1])
        q8 = run(lambda v: pcomm.Allreduce(v[pcomm.rank], P.MPI_SUM,
                                           compression="q8"), 2)(x)
        assert torch.equal(q8[0], mode_b[0])
        gathered = run(lambda v: pcomm.Allgather(v, 0, compression="q8"),
                       2)(x[0])
        assert gathered.shape == (2, 1200)
        with P.config.compression_scope("q8"):
            assert torch.equal(run(lambda v: pcomm.Allreduce(
                v[pcomm.rank], P.MPI_SUM), 2)(x), q8)
            tree = run(lambda v: pcomm.Allreduce_tree(
                {"a": v[pcomm.rank]}, P.MPI_SUM)["a"], 2)(x)
            assert torch.equal(tree[0], tree[1])
            assert not torch.equal(tree[0], x.sum(0))
            ints = run(lambda x: pcomm.Allreduce(x, P.MPI_SUM), 2)(
                torch.ones(4, dtype=torch.int32))
            assert (_np(ints) == 2).all()
            # compression=False forces the exact wire inside the scope.
            exact = run(lambda x: pcomm.Allreduce(x, P.MPI_SUM,
                                                  compression=False), 2)(
                torch.ones(4))
            assert (_np(exact) == 2).all()

    def test_reshard_and_health_refused(self):
        from mpi4torch_tpu_torch import reshard

        # Reshard under Mode A is ported (ROADMAP.md Queue 1 item 4.10):
        # the SPMD executor replicates the two shards on every rank.
        lay = reshard.layout((2,), 0)
        x = torch.arange(8.0).reshape(2, 4)
        out = run(lambda v: pcomm.Reshard(v[pcomm.rank], lay,
                                          reshard.layout((2,), None)), 2)(x)
        assert torch.equal(out[0], x.reshape(-1))
        assert torch.equal(out[1], x.reshape(-1))
        with pytest.raises(P.CommError, match="host-level"):
            run(lambda x: pcomm.check_health(), 2)(torch.ones(1))

    def test_entry_point_needs_cuda_or_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.run_spmd(lambda x: x, nranks=2)(torch.ones(1))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.device_mesh({"w": 2})

    def test_default_nranks_is_the_device_count(self):
        out = P.run_spmd(lambda x: pcomm.Allreduce(x, P.MPI_SUM),
                         device="cpu")(torch.ones(2))
        assert out.shape == (1, 2)

    def test_caller_scopes_reach_the_ranks(self):
        seen = []

        def body(x):
            seen.append((P.config.deterministic_reductions(),
                         P.config.default_bucket_bytes(),
                         P.config.default_overlap()))
            return x

        with P.config.deterministic_mode(True), P.config.fusion_scope(123), \
                P.config.overlap_scope(3):
            run(body, 2)(torch.ones(1))
        assert seen == [(True, 123, 3)] * 2

    def test_outputs_stack_trees_and_scalars(self):
        def body(x):
            return {"a": x * pcomm.rank, "b": [x.sum(), 7, None]}

        out = run(body, 3)(torch.ones(2))
        assert _np(out["a"]).tolist() == [[0, 0], [1, 1], [2, 2]]
        assert _np(out["b"][0]).tolist() == [2, 2, 2]
        assert _np(out["b"][1]).tolist() == [7, 7, 7]
        assert out["b"][2] is None

    def test_backward_inside_the_body(self):
        # value_and_grad inside the SPMD body, as the DP step runs it.
        def body(x):
            w = x.detach().requires_grad_()
            loss = pcomm.Allreduce((w * (pcomm.rank + 1)).sum(), P.MPI_SUM)
            (g,) = torch.autograd.grad(loss, w)
            return g

        g = run(body, 4)(torch.ones(3))
        assert (_np(g) == 4.0 * np.arange(1, 5)[:, None]).all()


class TestHooks:
    def test_collective_event_hook(self):
        x = torch.ones(5, dtype=torch.float64)
        # No tracer, and a tracer without mode_a: x comes back untouched.
        assert P.obs.spmd_collective_event(x, "Allreduce") is x
        with P.obs.trace() as t:
            assert P.obs.spmd_collective_event(x, "Allreduce") is x
        assert not [e for e in t.events if e.channel == "spmd"]
        with P.obs.trace(mode_a=True) as t:
            run(lambda v: pcomm.Allreduce(v, P.MPI_SUM), 3)(x)
        spmd = [e for e in t.events if e.channel == "spmd"]
        assert [(e.op, e.payload_bytes, e.rank) for e in spmd] == \
            [("Allreduce", 40, -1)] * 3
        ex = [e for e in t.events if e.channel == "exchange"]
        assert {e.op for e in ex} == {"spmd.psum"} and len(ex) == 3
        assert {e.family for e in ex} == {"all_reduce"}
        # The JAX package records the same events.
        with mpi.obs.trace(mode_a=True) as jt:
            jax.block_until_ready(mpi.run_spmd(
                lambda v: jcomm.Allreduce(v, mpi.MPI_SUM), nranks=3)(
                jnp.ones(5)))
        jspmd = [(e.op, e.payload_bytes, e.rank) for e in jt.events
                 if e.channel == "spmd"]
        assert jspmd == [(e.op, e.payload_bytes, e.rank) for e in spmd]

    def test_finite_guard(self):
        x = torch.ones(3)
        assert P.resilience.spmd_finite_value(x, "Allreduce") is x

        def body(v):
            t = v * torch.where(pcomm.rank == 1, torch.tensor(float("nan")),
                                torch.tensor(1.0))
            return pcomm.Allreduce(t, P.MPI_SUM)

        P.resilience.clear_violations()
        P.config.set_comm_finite_guard("raise")
        with pytest.raises(P.IntegrityError, match="entering Allreduce") \
                as ei:
            run(body, 3)(x)
        assert ei.value.ranks == frozenset({1})
        assert P.resilience.last_violation()["where"] == "Allreduce"
        P.config.set_comm_finite_guard("warn")
        with pytest.warns(P.resilience.IntegrityWarning):
            out = run(body, 3)(x)
        assert torch.isnan(out).all()
        # A clean run under the guard gives the unguarded bits.
        ok = run(lambda v: pcomm.Allreduce(v * (pcomm.rank + 1),
                                           P.MPI_SUM), 3)(x)
        P.config.set_comm_finite_guard("off")
        assert torch.equal(ok, run(lambda v: pcomm.Allreduce(
            v * (pcomm.rank + 1), P.MPI_SUM), 3)(x))


def test_no_jax_in_the_spmd_module():
    import pathlib

    src = pathlib.Path(pspmd.__file__).read_text()
    assert "import jax" not in src and "mpi4torch_tpu." not in src
