"""The port's schedule synthesis against the JAX package's, on the CPU.

Follows JAX ``tests/test_csched.py`` ``TestSynthesis``:

* ``factorization_chains``, ``fold_program`` (JSON and digest, with and
  without a tier stack) and the ``synthesize`` / ``autotune_synthesis``
  reports (winners, chains, censuses, candidates) equal JAX's;
* winners persist under the tune cache's ``codec="synth"`` slot, reload
  and reinstall from the file, and a version bump discards them;
* ``select_auto`` serves an installed winner in deterministic mode only,
  and a deterministic auto Allreduce under ``run_spmd`` takes it, with
  the exchange count of the program's census;
* synthesized Allreduces in Mode A (``run_spmd``) and Mode B
  (``run_ranks``), values and gradients, are bitwise JAX's Mode B and
  its interpretation (``interpret_allreduce``) in float32 on (3,), (8,)
  and (2, 4) worlds (the last: a 4-rank program on each ``tp`` row of a
  2 x 4 mesh, and the 8-rank world under ``config.tier_stack((2, 4))``);
* a name that is not installed raises when explicit and degrades when a
  default, in both modes.

A synthesized program's recorded census (its predicted collective
counts against ``analyze.parse_program`` of its recording) is the
``csched --smoke`` synthesis leg (``tests/test_torch_cli.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import csched as jcs
from mpi4torch_tpu import tune as jtune
from mpi4torch_tpu.csched import synth as JS
from mpi4torch_tpu_torch import constants as C
from mpi4torch_tpu_torch import csched as pcs
from mpi4torch_tpu_torch import runtime
from mpi4torch_tpu_torch import tune as ptune
from mpi4torch_tpu_torch.csched import synth as PS
from mpi4torch_tpu_torch.tune import autotuner as PA

NR = 8
CPU = torch.device("cpu")


def _reset():
    for cfg in (jmpi.config, P.config):
        cfg.set_tier_stack(None)
        cfg.set_tier_bandwidths(None)
        cfg.set_latency_crossover_bytes(None)
    jtune.clear()
    ptune.clear()
    JS.clear_installed()
    PS.clear_installed()


def _auto(**kw):
    """The port's selector on a float32 payload."""
    return ptune.select_auto(dtype=torch.float32, **kw)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("MPI4TORCH_TPU_TUNE_CACHE",
                       str(tmp_path / "jax_cache.json"))
    monkeypatch.setenv(PA.CACHE_ENV, str(tmp_path / "torch_cache.json"))
    _reset()
    with runtime._bind_rank(runtime.RankContext(
            runtime.World(1, device=CPU), 0)):
        yield
    _reset()


def _jsonable(report):
    """A synthesis report with its Program objects as JSON."""
    out = {}
    for k, v in report.items():
        if hasattr(v, "to_json"):
            v = v.to_json()
        out[k] = v
    return out


class _Exchanges:
    """Rank 0's ``World.exchange`` signatures, in order, while entered."""

    def __enter__(self):
        self.seq = []
        saved, seq = runtime.World.exchange, self.seq
        self._saved = saved

        def exchange(w, rank, signature, *a, **kw):
            if rank == 0:
                seq.append(signature)
            return saved(w, rank, signature, *a, **kw)

        runtime.World.exchange = exchange
        return self

    def __exit__(self, *exc):
        runtime.World.exchange = self._saved
        return False


# ------------------------------------------------------------ reports


class TestReports:
    @pytest.mark.parametrize("max_levels", [2, 3, 4])
    def test_factorization_chains_equal_jax(self, max_levels):
        for n in range(1, 25):
            assert pcs.factorization_chains(n, max_levels) == \
                jcs.factorization_chains(n, max_levels)

    @pytest.mark.parametrize("n", [2, 4, 6, 8, 12, 16])
    def test_fold_programs_equal_jax(self, n):
        for chain in jcs.factorization_chains(n):
            for tiers in (None, chain, (n,)):
                p = pcs.fold_program(n, chain, tiers)
                j = jcs.fold_program(n, chain, tiers)
                assert p.to_json() == j.to_json()
                assert p.digest() == j.digest()
        for bad in ((1, n), (n + 1,), (2, 2, 2, 2, 2)):
            with pytest.raises(P.CommError, match="factor"):
                pcs.fold_program(n, bad)

    @pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
    def test_synthesize_equals_jax(self, n):
        for nbytes in (1 << 10, 1 << 14, 1 << 18, 1 << 22):
            for itemsize in (2, 4, 8):
                got = _jsonable(pcs.synthesize(n, nbytes, itemsize))
                want = _jsonable(jcs.synthesize(n, nbytes, itemsize))
                assert got == want, (n, nbytes, itemsize)

    def test_deterministic_and_beats_ring(self):
        a = pcs.synthesize(NR, 1 << 14, 4)
        b = pcs.synthesize(NR, 1 << 14, 4)
        assert a["winner"] == b["winner"] and a["chain"] == [2, 2, 2]
        assert a["synthesis_beats_ring"]
        assert a["census"]["wire_bytes_per_rank"] \
            < a["ring_census"]["wire_bytes_per_rank"]

    @pytest.mark.parametrize("n", [3, 4, 8])
    def test_autotune_synthesis_report_equals_jax(self, n):
        sizes = (1 << 10, 1 << 14, 1 << 18)
        got = pcs.autotune_synthesis(nranks=n, sizes=sizes, device="cpu")
        want = jcs.autotune_synthesis(nranks=n, sizes=sizes)
        assert got == want
        for s in sizes:
            jn = jtune.lookup_algorithm("allreduce", jnp.float32, s, n,
                                        codec="synth")
            pn = ptune.lookup_algorithm("allreduce", torch.float32, s, n,
                                        codec="synth")
            assert pn == jn
            if pn is not None:
                assert pcs.installed_program(pn, n).to_json() == \
                    jcs.installed_program(jn, n).to_json()


# ------------------------------------------------------ cache + select


class TestSynthesis:
    def test_cache_round_trip_and_version_bump(self, monkeypatch):
        rep = pcs.autotune_synthesis(nranks=NR, sizes=(1 << 14,),
                                     device="cpu")
        ent = rep["entries"][str(1 << 14)]
        assert ent["recorded"] and ent["winner"].startswith("synth:")
        name = ent["winner"]
        PS.clear_installed()
        ptune.clear()
        got = ptune.lookup_algorithm("allreduce", torch.float32, 1 << 14,
                                     NR, codec="synth")
        assert got == name and PS.synth_applicable(name, NR)
        assert ptune.lookup_algorithm("allreduce", torch.float32, 1 << 14,
                                      NR) is None
        PS.clear_installed()
        ptune.clear()
        monkeypatch.setattr(PA, "CACHE_VERSION", PA.CACHE_VERSION + 1)
        assert ptune.lookup_algorithm("allreduce", torch.float32, 1 << 14,
                                      NR, codec="synth") is None

    def test_corrupt_program_entry_is_stale_not_fatal(self):
        rep = pcs.autotune_synthesis(nranks=NR, sizes=(1 << 14,),
                                     device="cpu")
        name = rep["entries"][str(1 << 14)]["winner"]
        data = json.load(open(ptune.cache_path()))
        for ent in data["entries"].values():
            ent["program"]["phases"][0]["steps"][0]["kind"] = "warp9"
        json.dump(data, open(ptune.cache_path(), "w"))
        PS.clear_installed()
        ptune.clear()
        assert ptune.lookup("allreduce", torch.float32, 1 << 14, NR,
                            codec="synth") is None
        assert not PS.synth_applicable(name, NR)
        with P.config.deterministic_mode(True):
            assert _auto(nbytes=1 << 14, nranks=NR,
                                     deterministic=True) == "ring"

    def test_select_auto_serves_synth_in_det_mode_only(self):
        pcs.autotune_synthesis(nranks=NR, sizes=(1 << 14,), device="cpu")
        jcs.autotune_synthesis(nranks=NR, sizes=(1 << 14,))
        for det in (True, False):
            for nbytes in (1 << 13, 1 << 14, 1 << 15):
                got = _auto(nbytes=nbytes, nranks=NR,
                                        deterministic=det)
                assert got == jtune.select_auto(
                    nbytes=nbytes, dtype=jnp.float32, nranks=NR,
                    deterministic=det)
        assert _auto(nbytes=1 << 14, nranks=NR,
                                 deterministic=True).startswith("synth:")
        assert _auto(nbytes=1 << 14, nranks=NR) == "ring"

    def test_det_auto_allreduce_takes_the_winner(self):
        # Deterministic auto selection under run_spmd takes the recorded
        # winner: bitwise its interpretation, with the exchanges of its
        # census (one grouped all-gather a tier).
        res = pcs.autotune_synthesis(nranks=NR, sizes=(1 << 14,),
                                     device="cpu")
        name = res["entries"][str(1 << 14)]["winner"]
        prog = pcs.installed_program(name, NR)
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (NR, 4096)).astype(np.float32))

        def body(v):
            return P.COMM_WORLD.Allreduce(v[P.COMM_WORLD.rank], P.MPI_SUM)

        with P.config.deterministic_mode(True), _Exchanges() as ex:
            out = P.run_spmd(body, nranks=NR, device="cpu")(x)
        oracle = pcs.interpret_allreduce(prog, P.MPI_SUM, list(x))
        assert all(torch.equal(out[r], oracle) for r in range(NR))
        census = pcs.program_census(prog, 4096, 4)
        assert len(ex.seq) == sum(census["hlo"].values()) == 3
        with P.config.deterministic_mode(True), _Exchanges() as ring:
            P.run_spmd(body, nranks=NR, device="cpu")(x[:, :3000])
        assert ring.seq != ex.seq   # another bucket: the ordered fold

    def test_tune_show_renders_synth_distinctly(self):
        from mpi4torch_tpu.tune.__main__ import _rows as jrows
        from mpi4torch_tpu_torch.tune.__main__ import _rows

        pcs.autotune_synthesis(nranks=NR, sizes=(1 << 14,), device="cpu")
        data = json.load(open(ptune.cache_path()))
        rows = _rows(data)
        synth_rows = [r for r in rows if r[6].startswith("synth:")]
        assert synth_rows and synth_rows[0][7] == "synthesized(3 steps)"
        assert rows == jrows(data)

    def test_synth_degrades_when_not_installed(self):
        assert ptune.resolve_request("synth:0000000000", nranks=NR) is None
        with pytest.raises(P.CommError, match="not installed"):
            ptune.resolve_request("synth:0000000000", nranks=NR,
                                  explicit=True)
        # A program installed for another world does not serve this one.
        name = pcs.install(pcs.fold_program(4, (2, 2)))
        with pytest.raises(P.CommError, match="not installed"):
            P.run_ranks(lambda: P.COMM_WORLD.Allreduce(
                torch.ones(3), P.MPI_SUM, algorithm=name), NR,
                device="cpu")
        with pytest.raises(P.CommError, match="not installed"):
            P.run_spmd(lambda: P.COMM_WORLD.Allreduce(
                torch.ones(3), P.MPI_SUM, algorithm=name), nranks=NR,
                device="cpu")()

    def test_program_cache_follows_installs(self):
        # A tuning run bumps the generation the program cache keys on,
        # and synthesized programs are never served from it stale.
        from mpi4torch_tpu_torch.csched import programs

        g0 = programs._knobs()
        pcs.autotune_synthesis(nranks=NR, sizes=(1 << 14,), device="cpu")
        assert programs._knobs() != g0
        name = pcs.install(pcs.fold_program(NR, (4, 2)))
        assert programs.cached(pcs.allreduce_program, name, NR,
                               P.MPI_SUM, deterministic=True, nelems=8,
                               itemsize=4).digest() == name[len("synth:"):]
        PS.clear_installed()
        with pytest.raises(P.CommError, match="not installed"):
            programs.cached(pcs.allreduce_program, name, NR, P.MPI_SUM,
                            deterministic=True, nelems=8, itemsize=4)


# ---------------------------------------------------- bitwise parity


def _install_both(prog_json):
    p = pcs.Program.from_json(prog_json)
    j = jcs.Program.from_json(prog_json)
    name = pcs.install(p)
    assert jcs.install(j) == name
    return name, p, j


def _jax_mode_b(name, xs, ws):
    """JAX Mode B value and gradient of ``vdot(Allreduce(x_r), w_r)`` on
    every rank, with the synthesized algorithm."""
    n = len(xs)
    xj = [jnp.asarray(x) for x in xs]
    wj = [jnp.asarray(w) for w in ws]

    def body(rank):
        def loss(v):
            return jnp.vdot(jmpi.COMM_WORLD.Allreduce(
                v, jmpi.MPI_SUM, algorithm=name), wj[rank])
        y = jmpi.COMM_WORLD.Allreduce(xj[rank], jmpi.MPI_SUM,
                                      algorithm=name)
        return np.asarray(y), np.asarray(jax.grad(loss)(xj[rank]))

    return jmpi.run_ranks(body, n)


def _port_mode_b(name, xs, ws):
    def body(rank):
        x = torch.from_numpy(xs[rank]).requires_grad_()
        y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, algorithm=name)
        (g,) = torch.autograd.grad((y * torch.from_numpy(ws[rank])).sum(),
                                   x)
        return y.detach().numpy(), g.numpy()

    return P.run_ranks(body, len(xs), device="cpu")


def _port_mode_a(name, xs, ws, **kw):
    X = torch.from_numpy(np.stack(xs)).requires_grad_()
    W = torch.from_numpy(np.stack(ws))
    from mpi4torch_tpu_torch.ops.spmd import world_rank

    def body(v):
        return P.COMM_WORLD.Allreduce(v[world_rank()], P.MPI_SUM,
                                      algorithm=name)

    with P.config.deterministic_mode(True):
        out = P.run_spmd(body, device="cpu", **kw)(X)
    (g,) = torch.autograd.grad((out * W).sum(), X)
    return out.detach().numpy(), g.numpy()


def _rows(n, seed, m=50):
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal(m).astype(np.float32) for _ in range(n)],
            [rng.standard_normal(m).astype(np.float32) for _ in range(n)])


class TestModeABitwise:
    @pytest.mark.parametrize("n, chain", [(3, (3,)), (8, (2, 2, 2)),
                                          (8, (4, 2)), (8, (2, 4))])
    def test_mode_a_b_bitwise_jax(self, n, chain):
        name, p, j = _install_both(jcs.fold_program(n, chain).to_json())
        xs, ws = _rows(n, 11 + n)
        oracle = np.asarray(jcs.interpret_allreduce(
            j, jmpi.MPI_SUM, [jnp.asarray(x) for x in xs]))
        goracle = np.asarray(jcs.interpret_allreduce(
            jcs.transpose(j), jmpi.MPI_SUM, [jnp.asarray(w) for w in ws]))
        jb = _jax_mode_b(name, xs, ws)
        pb = _port_mode_b(name, xs, ws)
        av, ag = _port_mode_a(name, xs, ws, nranks=n)
        for r in range(n):
            assert np.array_equal(jb[r][0], oracle)
            assert np.array_equal(jb[r][1], goracle)
            assert np.array_equal(pb[r][0], oracle)
            assert np.array_equal(pb[r][1], goracle)
            assert np.array_equal(av[r], oracle)
            assert np.array_equal(ag[r], goracle)

    def test_tier_stack_world_bitwise_jax(self):
        # The 8-rank world under config.tier_stack((2, 4)): the tier
        # search's exact winner, tier-annotated, in both modes.
        for cfg in (jmpi.config, P.config):
            cfg.set_tier_stack((2, 4))
            cfg.set_tier_bandwidths((1.0, 0.25))
        res = jcs.synthesize_tiers(NR, 1 << 12, 4)
        name, p, j = _install_both(res["exact_program"].to_json())
        assert name == res["exact_winner"]
        xs, ws = _rows(NR, 5)
        oracle = np.asarray(jcs.interpret_allreduce(
            j, jmpi.MPI_SUM, [jnp.asarray(x) for x in xs]))
        jb = _jax_mode_b(name, xs, ws)
        pb = _port_mode_b(name, xs, ws)
        av, ag = _port_mode_a(name, xs, ws, nranks=NR)
        for r in range(NR):
            assert np.array_equal(jb[r][0], oracle)
            assert np.array_equal(pb[r][0], oracle)
            assert np.array_equal(av[r], oracle)
            assert np.array_equal(pb[r][1], jb[r][1])
            assert np.array_equal(ag[r], jb[r][1])

    def test_mesh_rows_bitwise_jax(self):
        # A (2, 4) mesh: each tp row of four ranks runs the 4-rank
        # synthesized program, bitwise JAX's Mode B on that row.
        name, p, j = _install_both(
            jcs.fold_program(4, (2, 2)).to_json())
        xs, ws = _rows(NR, 9)
        mesh = P.device_mesh({"dp": 2, "tp": 4}, devices=["cpu"] * NR)
        tp = P.comm_from_mesh(mesh, "tp")
        from mpi4torch_tpu_torch.ops.spmd import world_rank

        X = torch.from_numpy(np.stack(xs)).requires_grad_()
        W = torch.from_numpy(np.stack(ws))

        def body(v):
            return tp.Allreduce(v[world_rank()], P.MPI_SUM, algorithm=name)

        with P.config.deterministic_mode(True):
            out = P.run_spmd(body, mesh=mesh, axis_name="dp")(X)
        (g,) = torch.autograd.grad((out * W).sum(), X)
        for d in range(2):
            rows = slice(4 * d, 4 * d + 4)
            jb = _jax_mode_b(name, xs[rows], ws[rows])
            pb = _port_mode_b(name, xs[rows], ws[rows])
            for t in range(4):
                assert np.array_equal(out[4 * d + t].detach().numpy(),
                                      jb[t][0])
                assert np.array_equal(g[4 * d + t].numpy(), jb[t][1])
                assert np.array_equal(pb[t][0], jb[t][0])
                assert np.array_equal(pb[t][1], jb[t][1])

    def test_scope_default_synth_degrades_in_both_modes(self):
        # An algorithm scope can name only registered algorithms; a
        # synthesized winner reaches Mode B's fold as a resolved name,
        # and when it is not installed for the world a default degrades
        # to the ascending-rank fold.
        from mpi4torch_tpu_torch.ops import eager

        name = pcs.install(pcs.fold_program(4, (2, 2)))
        assert eager._rendezvous_fold(NR, name)[0] == "ring"
        assert eager._rendezvous_fold(4, name)[0] == name
        with pytest.raises(P.CommError, match="not installed"):
            eager._rendezvous_fold(NR, name, explicit=True)
        with pytest.raises(ValueError, match="unknown collective"):
            P.config.set_default_algorithm(name)
