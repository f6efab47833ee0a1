"""The port's compressed SPMD collectives (``compress/spmd.py``) against the
JAX package, on the CPU.

Mirrors the Mode A cells of ``tests/test_compress.py``
(``TestSpmdCompressed``, ``TestModeParity``, ``TestInScheduleMultipath``,
``TestPerHopErrorFeedback``) on rank-thread worlds of 3, 4 and 8 ranks
with ``device="cpu"``.  Every input is seeded numpy.  What is held:

* the block-q8 Allreduce (``q8``, ``q8_ef``, ``q8_ef_hop``) per algorithm
  (``ring``, ``bidir``, ``torus``), ``bf16`` on ``ring`` and the compressed
  Allgather (``q8``, ``q8_ef``, ``bf16``): values and the gradients taken
  from outside ``run_spmd`` BITWISE the JAX package's Mode A (whose block-q8
  Allreduce takes its schedule-IR route: this is what shows the port's
  hand-composed pipeline equals it);
* the same against the port's Mode B (``run_ranks``) BITWISE where the two
  modes run one schedule (the block-q8 Allreduce, the Allgather's
  forward), and within the codec bound where Mode A re-encodes on a ring
  and Mode B folds once at the rendezvous (``bf16``'s Allreduce, the
  Allgather's adjoint), as in the JAX package;
* ``bf16r`` (and ``q8_ef_hop`` as a plain encode): within the codec bound,
  bitwise across ranks, unbiased over seeds.  The key folds in the bits
  of an f32 sum whose order XLA picks, so bitwise parity with JAX is not
  owed there (ROADMAP.md Queue 3);
* the fused compressed buckets of ``Allreduce_tree`` bitwise JAX's Mode A
  and the port's Mode B, and the refusals (non-SUM, ``torus`` on a prime
  world, a codec on a tier-stack communicator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P

pcomm = P.COMM_WORLD
jcomm = mpi.COMM_WORLD
Q8 = ("q8", "q8_ef", "q8_ef_hop")


@pytest.fixture(autouse=True)
def _reset_knobs():
    yield
    P.config.set_hier_group_size(None)
    mpi.config.set_hier_group_size(None)
    P.config.set_bandwidth_crossover_bytes(None)


def _data(n, m=700, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, m)) * scale).astype(np.float32)


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _jpick(x):
    return jax.lax.dynamic_index_in_dim(x, jnp.asarray(jcomm.rank + 0), 0,
                                        keepdims=False)


def _jax_mode_a(op, n, x, w):
    """``op(comm, own row)`` under the JAX package's ``run_spmd``: the
    stacked output and the gradient of ``vdot(out, w)``."""
    f = mpi.run_spmd(lambda v: op(jcomm, _jpick(v)), nranks=n)
    out, vjp = jax.vjp(f, jnp.asarray(x))
    (g,) = vjp(jnp.asarray(w))
    return np.asarray(out), np.asarray(g)


def _port_mode_a(op, n, x, w):
    f = P.run_spmd(lambda v: op(pcomm, v[pcomm.rank]), nranks=n,
                   device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    out = f(xt)
    (g,) = torch.autograd.grad(out, xt, grad_outputs=torch.from_numpy(w))
    return out.detach().numpy(), g.numpy()


def _port_mode_b(op, n, x, w):
    """Per rank: ``(out, gradient of vdot(out, w[r]))`` on the rank
    threads."""
    def body(r):
        t = torch.from_numpy(x[r].copy()).requires_grad_()
        out = op(pcomm, t)
        (g,) = torch.autograd.grad(out, t,
                                   grad_outputs=torch.from_numpy(w[r]))
        return out.detach().numpy(), g.numpy()

    return P.run_ranks(body, n, device="cpu")


def _allreduce(codec, algo=None):
    def op(c, t):
        return c.Allreduce(t, P.MPI_SUM if c is pcomm else mpi.MPI_SUM,
                           compression=codec, algorithm=algo)
    return op


def _cotangent(x, seed):
    return np.random.default_rng(seed).standard_normal(x.shape) \
        .astype(np.float32)


def _parity_cases():
    cases = []
    for codec in Q8:
        for algo in ("ring", "bidir", "torus"):
            for n in (3, 4, 8):
                if algo == "torus" and n == 3:
                    continue
                cases.append((codec, algo, n))
    return cases


class TestInScheduleMultipath:
    @pytest.mark.parametrize("codec,algo,n", _parity_cases())
    def test_mode_a_bitwise_jax_mode_a_and_port_mode_b(self, codec, algo,
                                                       n):
        x = _data(n, seed=31 + n)
        w = _cotangent(x, 7 + n)
        op = _allreduce(codec, algo)
        jo, jg = _jax_mode_a(op, n, x, w)
        po, pg = _port_mode_a(op, n, x, w)
        assert _bitwise(po, jo), (codec, algo, n)
        assert _bitwise(pg, jg), (codec, algo, n)
        for r in range(1, n):
            assert _bitwise(po[r], po[0])
        b = _port_mode_b(op, n, x, w)
        for r in range(n):
            assert _bitwise(po[r], b[r][0])
            assert _bitwise(pg[r], b[r][1])

    def test_torus_group_pinned(self):
        # config.hier_group_size pins the (outer=2, inner=4) grid of 8.
        x = _data(8, seed=61)
        w = _cotangent(x, 62)
        op = _allreduce("q8_ef", "torus")
        mpi.config.set_hier_group_size(4)
        P.config.set_hier_group_size(4)
        jo, jg = _jax_mode_a(op, 8, x, w)
        po, pg = _port_mode_a(op, 8, x, w)
        assert _bitwise(po, jo) and _bitwise(pg, jg)

    @pytest.mark.parametrize("codec", Q8)
    def test_deterministic_mode_bitwise(self, codec):
        x = _data(4, m=500, seed=37)
        with P.config.deterministic_mode(True):
            a = P.run_spmd(lambda v: pcomm.Allreduce(
                v[pcomm.rank], P.MPI_SUM, compression=codec,
                algorithm="bidir"), nranks=4, device="cpu")(
                    torch.from_numpy(x))
            b = P.run_ranks(lambda r: pcomm.Allreduce(
                torch.from_numpy(x[r].copy()), P.MPI_SUM,
                compression=codec, algorithm="bidir"), 4, device="cpu")
        for r in range(4):
            assert torch.equal(a[r], b[r])

    def test_oracle_is_the_fold(self):
        x = _data(4, seed=41)
        want = P.constants.reduce_q8_hop(
            [torch.from_numpy(d) for d in x], block=256, algorithm="bidir")
        got = P.run_spmd(lambda v: pcomm.Allreduce(
            v[pcomm.rank], P.MPI_SUM, compression="q8", algorithm="bidir"),
            nranks=4, device="cpu")(torch.from_numpy(x))
        assert torch.equal(got[2], want)

    def test_values_close_to_exact_on_multipath(self):
        x = _data(8, seed=43)
        exact = x.sum(0)
        for algo in ("bidir", "torus"):
            out = P.run_spmd(lambda v: pcomm.Allreduce(
                v[pcomm.rank], P.MPI_SUM, compression="q8", algorithm=algo),
                nranks=8, device="cpu")(torch.from_numpy(x)).numpy()
            for r in range(1, 8):
                assert _bitwise(out[r], out[0])
            rel = np.linalg.norm(out[0] - exact) / np.linalg.norm(exact)
            assert rel <= 2.5e-2, (algo, rel)

    def test_explicit_bidir_q8_composes_and_tree_q8_raises(self):
        ones = torch.ones(8, 64)
        out = P.run_spmd(lambda v: pcomm.Allreduce(
            v[pcomm.rank], P.MPI_SUM, compression="q8", algorithm="bidir"),
            nranks=8, device="cpu")(ones)
        assert (out == 8.0).all()
        with pytest.raises(ValueError, match="cannot carry this codec"):
            P.run_spmd(lambda v: pcomm.Allreduce(
                v[pcomm.rank], P.MPI_SUM, compression="q8",
                algorithm="tree"), nranks=8, device="cpu")(ones)

    def test_scope_codec_with_explicit_tree_degrades_codec(self):
        def fn(v):
            with P.config.compression_scope("q8"):
                return pcomm.Allreduce(v[pcomm.rank], P.MPI_SUM,
                                       algorithm="tree")

        out = P.run_spmd(fn, nranks=8, device="cpu")(torch.ones(8, 32))
        assert (out == 8.0).all()

    def test_explicit_torus_q8_on_prime_world_raises(self):
        with pytest.raises(P.CommError, match="factorization"):
            P.run_spmd(lambda v: pcomm.Allreduce(
                v[pcomm.rank], P.MPI_SUM, compression="q8",
                algorithm="torus"), nranks=5, device="cpu")(
                    torch.ones(5, 16))

    def test_auto_selection_picks_compressed_bidir_past_crossover(self):
        x = torch.from_numpy(_data(4, m=1 << 12, seed=47))
        P.config.set_bandwidth_crossover_bytes(1 << 12)

        def fn(algo):
            return lambda v: pcomm.Allreduce(v[pcomm.rank], P.MPI_SUM,
                                             compression="q8",
                                             algorithm=algo)

        auto = P.run_spmd(fn(None), nranks=4, device="cpu")(x)
        want = P.run_spmd(fn("bidir"), nranks=4, device="cpu")(x)
        ring = P.run_spmd(fn("ring"), nranks=4, device="cpu")(x)
        eager = P.run_ranks(lambda r: pcomm.Allreduce(
            x[r].clone(), P.MPI_SUM, compression="q8"), 4, device="cpu")
        assert torch.equal(auto, want) and not torch.equal(auto, ring)
        for r in range(4):
            assert torch.equal(eager[r], auto[r])


class TestSpmdCompressed:
    def test_allreduce_value_and_bit_identity(self):
        x = _data(8, m=1000, seed=5)
        out = P.run_spmd(lambda v: pcomm.Allreduce(
            v[pcomm.rank], P.MPI_SUM, compression="q8"), nranks=8,
            device="cpu")(torch.from_numpy(x)).numpy()
        exact = x.sum(0)
        for r in range(1, 8):
            assert _bitwise(out[r], out[0])
        assert np.linalg.norm(out[0] - exact) <= 2.5e-2 * np.linalg.norm(
            exact)

    @pytest.mark.parametrize("codec,bound", [("q8", 2.5e-2),
                                             ("q8_ef", 1e-3),
                                             ("bf16", 1e-2),
                                             ("bf16r", 1e-2)])
    def test_allreduce_codecs_close_to_exact(self, codec, bound):
        data = _data(1, m=1000, seed=6)[0]
        out = P.run_spmd(lambda v: pcomm.Allreduce(
            v * (pcomm.rank + 1.0), P.MPI_SUM, compression=codec),
            nranks=8, device="cpu")(torch.from_numpy(data)).numpy()
        exact = data * (8 * 9 / 2)
        for r in range(1, 8):
            assert _bitwise(out[r], out[0])
        rel = np.linalg.norm(out[0] - exact) / np.linalg.norm(exact)
        assert rel <= bound, (codec, rel)

    def test_q8_ef_cancels_ring_error(self):
        data = torch.from_numpy(_data(1, m=1000, seed=13)[0])
        exact = data * 36.0

        def run(codec):
            return P.run_spmd(lambda v: pcomm.Allreduce(
                v * (pcomm.rank + 1.0), P.MPI_SUM, compression=codec),
                nranks=8, device="cpu")(data)[0]

        assert (run("q8_ef") - exact).norm() < 0.1 * (run("q8")
                                                       - exact).norm()

    @pytest.mark.parametrize("codec,n,want", [("q8", 8, 64.0),
                                              ("q8_ef", 4, 16.0)])
    def test_allreduce_grad_end_to_end(self, codec, n, want):
        # Ones cotangents quantize exactly: d(sum over ranks)/dx = n^2.
        x = torch.ones(64, requires_grad=True)
        out = P.run_spmd(lambda v: pcomm.Allreduce(
            v, P.MPI_SUM, compression=codec), nranks=n, device="cpu")(x)
        (g,) = torch.autograd.grad(out.sum(), x)
        assert (g == want).all()

    def test_allgather_value_and_adjoint(self):
        data = torch.from_numpy(_data(1, m=24, seed=7)[0])
        x = data.clone().requires_grad_()
        out = P.run_spmd(lambda v: pcomm.Allgather(v, 0, compression="q8"),
                         nranks=4, device="cpu")(x)
        assert out.shape == (4, 96)
        exact = torch.cat([data] * 4)
        assert (out[0] - exact).norm() <= 1e-2 * exact.norm()
        (g,) = torch.autograd.grad(out.sum(), x)
        assert torch.allclose(g, torch.full((24,), 16.0), rtol=1e-5)

    def test_non_sum_raises(self):
        with pytest.raises(P.CommError, match="MPI_SUM only"):
            P.run_spmd(lambda v: pcomm.Allreduce(
                v, P.MPI_MAX, compression="q8"), nranks=4, device="cpu")(
                    torch.ones(8))

    def test_compression_scope_applies(self):
        data = torch.from_numpy(_data(1, m=1000, seed=8)[0])
        runner = P.run_spmd(lambda v: pcomm.Allreduce(v, P.MPI_SUM),
                            nranks=4, device="cpu")
        exact = runner(data)[0]
        with P.config.compression_scope("q8"):
            compressed = runner(data)[0]
            want = P.run_spmd(lambda v: pcomm.Allreduce(
                v, P.MPI_SUM, compression="q8"), nranks=4,
                device="cpu")(data)[0]
            ints = P.run_spmd(lambda v: pcomm.Allreduce(v, P.MPI_SUM),
                              nranks=4, device="cpu")(
                                  torch.ones(4, dtype=torch.int32))
        assert not torch.equal(exact, compressed)
        assert torch.equal(compressed, want)
        assert torch.equal(runner(data)[0], exact)
        assert (ints == 4).all()

    def test_codec_labels_on_the_step_event(self):
        with P.obs.trace(mode_a=True) as t:
            P.run_spmd(lambda v: pcomm.Allreduce(
                v, P.MPI_SUM, compression="q8"), nranks=2, device="cpu")(
                    torch.ones(8))
        ops = [e.op for e in t.events]
        assert "Allreduce[q8]" in ops, ops


class TestModeParity:
    @pytest.mark.parametrize("n", [3, 4, 8])
    def test_bf16_allreduce(self, n):
        x = _data(n, seed=9 + n)
        w = _cotangent(x, 10 + n)
        op = _allreduce("bf16")
        jo, jg = _jax_mode_a(op, n, x, w)
        po, pg = _port_mode_a(op, n, x, w)
        assert _bitwise(po, jo) and _bitwise(pg, jg)
        # Mode A re-encodes on every hop, Mode B folds the decoded
        # contributions once: statistical parity, as in the JAX package.
        b = _port_mode_b(op, n, x, w)
        exact = x.sum(0).astype(np.float64)
        for r in range(n):
            assert np.linalg.norm(po[r] - b[r][0]) <= 3e-2 * np.linalg.norm(
                exact)

    @pytest.mark.parametrize("codec", ["q8", "q8_ef", "bf16"])
    @pytest.mark.parametrize("n", [3, 4, 8])
    def test_allgather(self, codec, n):
        x = _data(n, m=96, seed=21 + n)
        w = np.random.default_rng(22 + n).standard_normal(
            (n, 96 * n)).astype(np.float32)

        def op(c, t):
            return c.Allgather(t, 0, compression=codec)

        jo, jg = _jax_mode_a(op, n, x, w)
        po, pg = _port_mode_a(op, n, x, w)
        assert _bitwise(po, jo) and _bitwise(pg, jg)
        b = _port_mode_b(op, n, x, w)
        full = np.linalg.norm(w.sum(0))
        for r in range(n):
            # The forward is one schedule in both modes; the adjoint is
            # the quantized ring here and the rendezvous fold there.
            assert _bitwise(po[r], b[r][0])
            assert np.linalg.norm(pg[r] - b[r][1]) <= 3e-2 * full

    def test_allgather_uneven_axis_1(self):
        x = _data(3, m=40, seed=3).reshape(3, 5, 8)
        w = np.random.default_rng(4).standard_normal((3, 5, 24)) \
            .astype(np.float32)

        def op(c, t):
            return c.Allgather(t, 1, compression="q8_ef")

        jo, jg = _jax_mode_a(op, 3, x, w)
        po, pg = _port_mode_a(op, 3, x, w)
        assert _bitwise(po, jo) and _bitwise(pg, jg)


class TestStochastic:
    @pytest.mark.parametrize("codec", ["bf16r", "q8_ef_hop"])
    def test_within_bound_and_identical_across_ranks(self, codec):
        x = _data(4, seed=71)
        gathered = codec != "bf16r"
        w = np.random.default_rng(72).standard_normal(
            (4, 2800) if gathered else x.shape).astype(np.float32)

        def op(c, t):
            return c.Allgather(t, 0, compression=codec) if codec != "bf16r" \
                else c.Allreduce(t, P.MPI_SUM, compression=codec)

        po, pg = _port_mode_a(op, 4, x, w)
        jo, _ = _jax_mode_a(op, 4, x, w)
        exact = (x.sum(0) if codec == "bf16r" else x.reshape(-1))
        bound = 1e-2 if codec == "bf16r" else 2.5e-2
        for r in range(4):
            assert _bitwise(po[r], po[0])
            assert np.linalg.norm(po[r] - exact) <= bound * np.linalg.norm(
                exact)
            assert np.linalg.norm(po[r] - jo[r]) <= 2 * bound \
                * np.linalg.norm(exact)
        assert np.isfinite(pg).all()

    def test_bf16r_unbiased_over_seeds(self):
        # Sixteen seeded payloads: the mean signed error of the
        # stochastic ring stays well inside round-to-nearest bf16's.
        errs = []
        for seed in range(16):
            x = _data(4, m=512, seed=100 + seed)
            out = P.run_spmd(lambda v: pcomm.Allreduce(
                v[pcomm.rank], P.MPI_SUM, compression="bf16r"), nranks=4,
                device="cpu")(torch.from_numpy(x))[0].double().numpy()
            errs.append(out - x.astype(np.float64).sum(0))
        errs = np.stack(errs)
        se = errs.std() / np.sqrt(errs.size)
        assert abs(errs.mean()) <= 4 * se

    def test_q8_ef_hop_unbiased_over_salts(self):
        from mpi4torch_tpu_torch.compress import spmd as cs

        x = torch.from_numpy(_data(4, m=512, seed=53))
        exact = x.double().sum(0)
        codec = P.compress.get_codec("q8_ef_hop")

        def body(v, salt):
            ctx = P.ops.spmd.current_spmd_context()
            out, _ = cs._fused_channel(ctx, v[pcomm.rank], codec, salt,
                                       None, 1, track=False)
            return out

        acc = torch.zeros(512, dtype=torch.float64)
        for salt in range(24):
            acc += P.run_spmd(lambda v: body(v, 1000 + salt), nranks=4,
                              device="cpu")(x)[0].double()
        det = P.run_spmd(lambda v: pcomm.Allreduce(
            v[pcomm.rank], P.MPI_SUM, compression="q8"), nranks=4,
            device="cpu")(x)[0].double()
        assert (acc / 24 - exact).abs().mean() < (det - exact).abs().mean()


class TestFusedBuckets:
    @pytest.mark.parametrize("codec,algo", [("q8", None), ("q8_ef", "bidir"),
                                            ("q8_ef_hop", "torus"),
                                            ("bf16", None)])
    def test_tree_bitwise_jax_mode_a_and_port_mode_b(self, codec, algo):
        rng = np.random.default_rng(81)
        n = 4
        x = (rng.standard_normal((n, 300)) * 2).astype(np.float32)

        def jop(c, t):
            tree = {"a": t[:100].reshape(10, 10), "b": t[100:]}
            out = c.Allreduce_tree(tree, mpi.MPI_SUM, compression=codec,
                                   algorithm=algo, mean=True)
            return jnp.concatenate([out["a"].reshape(-1), out["b"]])

        def pop(c, t):
            tree = {"a": t[:100].reshape(10, 10), "b": t[100:]}
            out = c.Allreduce_tree(tree, P.MPI_SUM, compression=codec,
                                   algorithm=algo, mean=True)
            return torch.cat([out["a"].reshape(-1), out["b"]])

        w = _cotangent(x, 82)
        jo, jg = _jax_mode_a(jop, n, x, w)
        po, pg = _port_mode_a(pop, n, x, w)
        assert _bitwise(po, jo) and _bitwise(pg, jg)
        b = _port_mode_b(pop, n, x, w)
        if codec != "bf16":
            for r in range(n):
                assert _bitwise(po[r], b[r][0]) and _bitwise(pg[r], b[r][1])

    def test_scope_codec_reaches_the_buckets(self):
        x = torch.from_numpy(_data(2, m=300, seed=83))

        def fn(v):
            return pcomm.Allreduce_tree({"a": v[pcomm.rank]}, P.MPI_SUM)["a"]

        with P.config.compression_scope("q8"):
            scoped = P.run_spmd(fn, nranks=2, device="cpu")(x)
        explicit = P.run_spmd(lambda v: pcomm.Allreduce_tree(
            {"a": v[pcomm.rank]}, P.MPI_SUM, compression="q8")["a"],
            nranks=2, device="cpu")(x)
        assert torch.equal(scoped, explicit)


class TestTierStack:
    def test_explicit_codec_raises_scope_degrades(self):
        mesh = P.device_mesh({"dp": 2, "tp": 2}, devices=["cpu"] * 4)
        hc = P.comm_from_mesh(mesh, ("dp", "tp"))

        def explicit(v):
            return hc.Allreduce(v, P.MPI_SUM, compression="q8")

        with pytest.raises(ValueError, match="tier-stack"):
            P.run_spmd(explicit, mesh=mesh, axis_name="dp")(torch.ones(4))

        def scoped(v):
            return hc.Allreduce(v, P.MPI_SUM)

        with P.config.compression_scope("q8"):
            out = P.run_spmd(scoped, mesh=mesh, axis_name="dp")(
                torch.full((4,), 0.3))
        exact = P.run_spmd(scoped, mesh=mesh, axis_name="dp")(
            torch.full((4,), 0.3))
        assert torch.equal(out, exact)


def test_cli_smoke_exits_zero(capsys):
    from mpi4torch_tpu_torch.compress.__main__ import main

    assert main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "q8_ef_hop-on-bidir == reduce_q8_hop oracle" in out
    assert "int8 collective_permutes on both" in out
    assert "quant-smoke: OK" in out
