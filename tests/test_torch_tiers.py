"""The port's tier stack, tier synthesis and tier window against the JAX
package's, on the CPU.

Follows JAX ``tests/test_tiers.py`` class by class:

* the knobs: ``config.tier_stack`` / ``tier_bandwidths`` validation, the
  process-state round trip, ``resolve_tier_stack``;
* the nested parity matrix: deterministic ``hier`` on the (2, 2, 2),
  (4, 2) and (2, 4) stacks of an 8-rank world, Mode A bitwise Mode B
  and JAX's Mode B, forward and backward; the exact and ``q8-slow``
  synthesized compositions bitwise their interpretation and JAX's;
* the per-tier census and the weighted synthesis verdict
  (``synthesize_tiers`` reports equal JAX's on every stack and skew);
* the tier-keyed cache (``make_key(tiers=)``, the version gate,
  ``autotune_tier_synthesis`` records, the CLI's tiers column);
* the tier window: ``overlap.tier_window_depth`` equals JAX's, and a
  skewed config widens the split-phase window (another exchange order,
  the same bits).

* ``obs.reconcile(..., tiers=)`` (``TestReconcileTiers``): a traced
  synthesized tier-stack Allreduce prices its per-tier traffic exactly
  against its recorded program, equal to JAX's split and to the
  synthesis report's.

The registry guard (``TestRegistryGuard``) is mirrored in
``tests/test_torch_analyze.py``; the tier tables and identities of
recorded programs run in ``python -m mpi4torch_tpu_torch.csched --tiers``
(``tests/test_torch_cli.py``).
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
from mpi4torch_tpu_torch import csched as pcs
from mpi4torch_tpu_torch import overlap as pov
from mpi4torch_tpu_torch import runtime
from mpi4torch_tpu_torch import tune as ptune
from mpi4torch_tpu_torch.csched import synth as PS
from mpi4torch_tpu_torch.tune import autotuner as PA

NR = 8
STACKS = ((2, 2, 2), (4, 2), (2, 4), (8,))
SKEW = (1.0, 1.0, 0.05)
CPU = torch.device("cpu")


def _reset():
    for cfg in (jmpi.config, P.config):
        cfg.set_tier_stack(None)
        cfg.set_tier_bandwidths(None)
        cfg.set_hier_group_size(None)
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


def _both(setter, *a):
    getattr(jmpi.config, setter)(*a)
    getattr(P.config, setter)(*a)


def _skew_for(stack):
    return tuple([1.0] * (len(stack) - 1) + [0.05]) \
        if len(stack) > 1 else (1.0,)


def _jsonable(report):
    return {k: (v.to_json() if hasattr(v, "to_json") else v)
            for k, v in report.items()}


class _Exchanges:
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


# -------------------------------------------------------------- knobs


class TestConfigKnobs:
    def test_tier_stack_validation(self):
        P.config.set_tier_stack((2, 2, 2))
        assert P.config.tier_stack() == (2, 2, 2)
        P.config.set_tier_stack(None)
        for bad in ((1, 4), (), 5, ("x",)):
            with pytest.raises(ValueError):
                P.config.set_tier_stack(bad)

    def test_tier_bandwidths_validation(self):
        P.config.set_tier_bandwidths((1.0, 0.05))
        assert P.config.tier_bandwidths() == (1.0, 0.05)
        P.config.set_tier_bandwidths([2, 1])
        assert P.config.tier_bandwidths() == (2.0, 1.0)
        P.config.set_tier_bandwidths(None)
        for bad in ((), (1.0, 0.0), (1.0, -2.0), "fast"):
            with pytest.raises(ValueError):
                P.config.set_tier_bandwidths(bad)
            with pytest.raises(ValueError):
                jmpi.config.set_tier_bandwidths(bad)

    def test_process_state_round_trip(self):
        P.config.set_tier_stack((2, 2, 2))
        P.config.set_tier_bandwidths((1.0, 1.0, 0.05))
        snap = P.config.snapshot_process_state()
        assert snap["tier_stack"] == (2, 2, 2)
        assert snap["tier_bandwidths"] == (1.0, 1.0, 0.05)
        _reset()
        P.config.apply_process_state(snap)
        assert P.config.tier_stack() == (2, 2, 2)
        assert P.config.tier_bandwidths() == (1.0, 1.0, 0.05)

    def test_resolve_tier_stack_contract(self):
        assert ptune.resolve_tier_stack(8) == jtune.resolve_tier_stack(8) \
            == (2, 4)
        _both("set_tier_stack", (2, 2, 2))
        assert ptune.resolve_tier_stack(8) == (2, 2, 2)
        with pytest.raises(P.CommError, match="does not factor"):
            ptune.resolve_tier_stack(6)


# ----------------------------------------------------- parity matrix


def _payload(seed, m=37):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(m).astype(np.float32) for _ in range(NR)]


def _mode_a(xs, ws, algorithm="hier"):
    from mpi4torch_tpu_torch.ops.spmd import world_rank

    X = torch.from_numpy(np.stack(xs)).requires_grad_()

    def body(v):
        return P.COMM_WORLD.Allreduce(v[world_rank()], P.MPI_SUM,
                                      algorithm=algorithm)

    with P.config.deterministic_mode(True):
        out = P.run_spmd(body, nranks=NR, device="cpu")(X)
    if ws is None:
        return out.detach().numpy(), None
    (g,) = torch.autograd.grad((out * torch.from_numpy(np.stack(ws))).sum(),
                               X)
    return out.detach().numpy(), g.numpy()


def _mode_b(xs, ws, algorithm="hier"):
    def body(rank):
        x = torch.from_numpy(xs[rank]).requires_grad_()
        y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, algorithm=algorithm)
        g = None
        if ws is not None:
            (g,) = torch.autograd.grad(
                (y * torch.from_numpy(ws[rank])).sum(), x)
            g = g.numpy()
        return y.detach().numpy(), g

    return P.run_ranks(body, NR, device="cpu")


def _jax_mode_b(xs, ws, algorithm="hier"):
    def body(rank):
        x = jnp.asarray(xs[rank])
        y = jmpi.COMM_WORLD.Allreduce(x, jmpi.MPI_SUM, algorithm=algorithm)
        g = jax.grad(lambda v: jnp.vdot(jmpi.COMM_WORLD.Allreduce(
            v, jmpi.MPI_SUM, algorithm=algorithm), jnp.asarray(ws[rank])))(x)
        return np.asarray(y), np.asarray(g)

    return jmpi.run_ranks(body, NR)


class TestNestedParityMatrix:
    @pytest.mark.parametrize("stack", [(2, 2, 2), (4, 2), (2, 4)])
    def test_det_hier_bitwise_fwd_bwd(self, stack):
        _both("set_tier_stack", stack)
        xs, ws = _payload(1), _payload(2)
        av, ag = _mode_a(xs, ws)
        b = _mode_b(xs, ws)
        j = _jax_mode_b(xs, ws)
        for r in range(NR):
            assert np.array_equal(av[r], av[0])
            assert np.array_equal(b[r][0], av[0])
            assert np.array_equal(j[r][0], av[0])
            assert np.array_equal(b[r][1], ag[r])
            assert np.array_equal(j[r][1], ag[r])

    @pytest.mark.parametrize("stack", [(2, 2, 2), (4, 2)])
    def test_nondet_hier_correct(self, stack):
        P.config.set_tier_stack(stack)
        xs = _payload(3)
        out = P.run_spmd(lambda v: P.COMM_WORLD.Allreduce(
            v[P.COMM_WORLD.rank], P.MPI_SUM, algorithm="hier"), nranks=NR,
            device="cpu")(torch.from_numpy(np.stack(xs)))
        np.testing.assert_allclose(out[0].numpy(), np.sum(xs, axis=0),
                                   rtol=1e-5, atol=1e-6)

    def test_single_tier_stack_raises_for_explicit_hier(self):
        P.config.set_tier_stack((8,))
        xs = _payload(4)
        with pytest.raises(P.CommError, match="single flat tier"):
            _mode_b(xs, None)
        with pytest.raises(P.CommError, match="single flat tier"):
            _mode_a(xs, None)

    @pytest.mark.parametrize("comp", ["exact", "q8-slow"])
    def test_synth_composition_bitwise(self, comp):
        # Integer-valued payloads: power-of-two block-q8 carries integer
        # grids exactly, so the q8-slow cell compares real schedules.
        stack = (2, 2, 2)
        rng = np.random.default_rng(18)
        xs = [rng.integers(-40, 40, 257).astype(np.float32)
              for _ in range(NR)]
        ws = [rng.integers(-40, 40, 257).astype(np.float32)
              for _ in range(NR)]
        prog = jcs.fold_program(NR, stack, stack)
        if comp == "q8-slow":
            prog = jcs.rewrite_fold_codec(prog, (len(stack) - 1,))
            assert pcs.rewrite_fold_codec(
                pcs.fold_program(NR, stack, stack),
                (len(stack) - 1,)).to_json() == prog.to_json()
        name = jcs.install(prog)
        assert pcs.install(pcs.Program.from_json(prog.to_json())) == name
        oracle = np.asarray(jcs.interpret_allreduce(
            prog, jmpi.MPI_SUM, [jnp.asarray(x) for x in xs]))
        av, ag = _mode_a(xs, ws, algorithm=name)
        b = _mode_b(xs, ws, algorithm=name)
        j = _jax_mode_b(xs, ws, algorithm=name)
        for r in range(NR):
            assert np.array_equal(av[r], oracle)
            assert np.array_equal(b[r][0], oracle)
            assert np.array_equal(j[r][0], oracle)
            assert np.array_equal(b[r][1], j[r][1])
            assert np.array_equal(ag[r], j[r][1])


# ------------------------------------------------------------- census


class TestTierCensus:
    def test_tier_of_group_attribution_rule(self):
        tiers = (2, 2, 2)
        for grp in ((0, 1), (0, 2), (0, 4), (0, 5), (3, 7), (1, 3)):
            assert pcs.tier_of_group(grp, tiers) == \
                jcs.tier_of_group(grp, tiers)
        assert pcs.tier_of_groups(None, tiers) == 2
        assert pcs.tier_of_groups(((0, 1), (2, 3)), tiers) == 0

    def test_weighted_cost_arithmetic(self):
        assert pcs.weighted_cost((100, 50), (1.0, 0.05)) == \
            jcs.weighted_cost((100, 50), (1.0, 0.05)) == 100 + 50 / 0.05
        assert pcs.weighted_cost((100, 50)) == 150.0

    @pytest.mark.parametrize("stack", [(2, 2, 2), (4, 2), (2, 4)])
    def test_program_tier_census_sums_to_wire(self, stack):
        prog = pcs.fold_program(NR, stack, stack)
        per = pcs.program_tier_census(prog, 1024, 4, stack)
        assert per == jcs.program_tier_census(
            jcs.fold_program(NR, stack, stack), 1024, 4, stack)
        assert len(per) == len(stack) and all(w > 0 for w in per)
        assert sum(per) == pcs.program_census(
            prog, 1024, 4)["wire_bytes_per_rank"]


# ---------------------------------------------------------- synthesis


class TestSynthesisWeighted:
    def test_pinned_skewed_verdict(self):
        res = pcs.synthesize_tiers(NR, 4096, 4, tiers=(2, 2, 2),
                                   tier_bandwidths=SKEW)
        assert res["tier_wire"] == [4096, 4096, 1040]
        assert res["weighted_cost"] == 28992.0
        assert res["bidir_tier_wire"] == [0, 0, 7168]
        assert res["bidir_weighted_cost"] == 143360.0
        assert res["beats_bidir"] and res["composition"] == "q8-slow"
        assert res["exact_tier_wire"][-1] < res["bidir_tier_wire"][-1]

    @pytest.mark.parametrize("stack", STACKS)
    def test_reports_equal_jax(self, stack):
        for bws in (None, _skew_for(stack), tuple(range(len(stack), 0,
                                                        -1))):
            for nbytes in (1 << 10, 4096, 1 << 16):
                got = pcs.synthesize_tiers(NR, nbytes, 4, tiers=stack,
                                           tier_bandwidths=bws)
                want = jcs.synthesize_tiers(NR, nbytes, 4, tiers=stack,
                                            tier_bandwidths=bws)
                assert _jsonable(got) == _jsonable(want), (stack, bws)

    def test_config_fallbacks_equal_jax(self):
        _both("set_tier_stack", (2, 2, 2))
        _both("set_tier_bandwidths", SKEW)
        assert _jsonable(pcs.synthesize_tiers(NR, 4096)) == \
            _jsonable(jcs.synthesize_tiers(NR, 4096))
        for bad in ({"tiers": (3, 3)}, {"tier_bandwidths": (1.0, 2.0)}):
            with pytest.raises(P.CommError):
                pcs.synthesize_tiers(NR, 4096, **bad)
        _both("set_tier_stack", None)
        _both("set_tier_bandwidths", None)
        assert _jsonable(pcs.synthesize_tiers(1, 4096)) == \
            _jsonable(jcs.synthesize_tiers(1, 4096))
        assert pcs.synthesize_tiers(1, 4096)["winner"] is None

    @pytest.mark.parametrize("stack", [(2, 2, 2), (4, 2), (2, 4)])
    def test_uniform_bandwidths_stay_exact(self, stack):
        res = pcs.synthesize_tiers(NR, 4096, 4, tiers=stack)
        assert all(c["composition"] == "exact" for c in res["candidates"])
        assert res["winner"] == res["exact_winner"]

    def test_two_level_stack_is_hier(self):
        # A 2-level stack under uniform weights: hier's exchanges and
        # bits are those of the same hier_group_size.
        xs = _payload(6)
        P.config.set_hier_group_size(2)
        with _Exchanges() as base:
            a, _ = _mode_a(xs, None)
        P.config.set_hier_group_size(None)
        P.config.set_tier_stack((2, 4))
        with _Exchanges() as tiered:
            b, _ = _mode_a(xs, None)
        assert base.seq == tiered.seq and np.array_equal(a, b)


# -------------------------------------------------------------- cache


class TestCacheTiers:
    def test_make_key_tier_dimension(self):
        for kw in ({}, {"tiers": (2, 2, 2)}, {"tiers": "2x2x2"},
                   {"codec": "synth", "tiers": (2, 4),
                    "transition": "warm"}):
            assert ptune.make_key("allreduce", "float32", 1 << 14, NR,
                                  platform="cpu", **kw) == \
                jtune.make_key("allreduce", "float32", 1 << 14, NR,
                               platform="cpu", **kw)

    def test_cache_version_is_3_and_v2_files_silently_ignored(self):
        assert PA.CACHE_VERSION == 3
        key = ptune.make_key("allreduce", "float32", 512, NR)
        with open(ptune.cache_path(), "w") as f:
            json.dump({"version": 2,
                       "entries": {key: {"algorithm": "hier"}}}, f)
        ptune.clear()
        assert ptune.lookup("allreduce", "float32", 512, NR) is None
        assert _auto(nbytes=512, nranks=NR) == "ring"

    def test_tier_synthesis_records_under_tier_keys(self):
        rep = pcs.autotune_tier_synthesis(
            nranks=NR, sizes=(1 << 12,), tiers=(2, 2, 2),
            tier_bandwidths=SKEW, device="cpu")
        want = jcs.autotune_tier_synthesis(
            nranks=NR, sizes=(1 << 12,), tiers=(2, 2, 2),
            tier_bandwidths=SKEW)
        assert rep == want
        ent = rep["entries"][str(1 << 12)]
        assert ent["recorded"]
        assert ptune.lookup_algorithm(
            "allreduce", torch.float32, 1 << 12, NR, codec="synth",
            tiers=(2, 2, 2)) == ent["exact_winner"]
        assert ptune.lookup_algorithm(
            "allreduce", torch.float32, 1 << 12, NR, codec="synth_q8",
            tiers=(2, 2, 2)) == ent["winner"]
        assert ptune.lookup_algorithm("allreduce", torch.float32, 1 << 12,
                                      NR) is None
        assert not _auto(
            nbytes=1 << 12, nranks=NR,
            deterministic=True).startswith("synth:")

    def test_tune_show_has_tier_column(self):
        from mpi4torch_tpu.tune.__main__ import _rows as jrows
        from mpi4torch_tpu_torch.tune.__main__ import _COLUMNS, _rows

        assert "tiers" in _COLUMNS
        pcs.autotune_tier_synthesis(nranks=NR, sizes=(1 << 12,),
                                    tiers=(2, 2, 2), tier_bandwidths=SKEW,
                                    device="cpu")
        ptune.record("allreduce", "float32", 512, NR, "tree",
                     platform="cpu")
        data = json.load(open(ptune.cache_path()))
        rows = _rows(data)
        assert rows == jrows(data)
        assert {"2x2x2", "-"} <= {r[5] for r in rows}
        assert all(r[6].startswith("synth:")
                   for r in rows if r[5] == "2x2x2")


# -------------------------------------------------------- tier window


class TestOverlapTierWindow:
    def test_tier_window_depth_derivation(self):
        cases = ((None, None), ((2, 2, 2), None),
                 ((2, 2, 2), (1.0, 1.0, 0.05)), ((2, 2, 2), (1.0, 1.0, 1.0)),
                 ((2, 2, 2), (1.0, 0.05)), ((4, 2), (1.0, 0.3)),
                 ((2, 4), (100.0, 25.0)), ((2, 2, 2), (100.0, 25.0, 3.125)))
        for stack, bws in cases:
            _both("set_tier_stack", stack)
            _both("set_tier_bandwidths", bws)
            assert pov.tier_window_depth() == \
                jmpi.overlap.tier_window_depth(), (stack, bws)
        _both("set_tier_stack", (2, 2, 2))
        _both("set_tier_bandwidths", (1.0, 1.0, 0.05))
        assert pov.tier_window_depth() == 21
        _both("set_tier_bandwidths", (100.0, 25.0, 3.125))
        assert pov.tier_window_depth() == 33

    def _tree(self, overlap, tier_window="default"):
        from mpi4torch_tpu_torch.fuse.collectives import fused_allreduce_tree

        tree = [torch.from_numpy(np.random.default_rng(i).standard_normal(
            1024).astype(np.float32)) for i in range(4)]
        kw = {} if tier_window == "default" else {"tier_window": tier_window}

        def body():
            return fused_allreduce_tree(P.COMM_WORLD, tree, P.MPI_SUM,
                                        bucket_bytes=4096, overlap=overlap,
                                        **kw)

        with _Exchanges() as ex:
            out = P.run_spmd(body, nranks=NR, device="cpu")()
        return out, ex.seq

    def test_skewed_config_widens_the_window(self):
        blocking, bseq = self._tree(False)
        default, dseq = self._tree(True)
        P.config.set_tier_stack((2, 2, 2))
        P.config.set_tier_bandwidths((1.0, 1.0, 0.05))
        wide, wseq = self._tree(True)
        for a, b in zip(wide, default):
            assert torch.equal(a, b)
        for a, b in zip(default, blocking):
            assert torch.equal(a, b)
        # the widened window is another schedule: every start issued
        # before the first wait
        assert sorted(map(str, wseq)) == sorted(map(str, dseq))
        assert wseq != dseq

    def test_explicit_tier_window_parameter(self):
        _, none = self._tree(True, None)
        _, four = self._tree(True, 4)
        _, one = self._tree(True, 1)
        assert four != none
        assert one == none   # widen-only


# ---------------------------------------------------------------------------
# obs.reconcile prices per-tier traffic exactly
# ---------------------------------------------------------------------------


def _jlower_fwd(name, x, det):
    from jax.sharding import Mesh, PartitionSpec as JP

    from mpi4torch_tpu import constants as JC
    from mpi4torch_tpu._compat import shard_map
    from mpi4torch_tpu.ops import spmd as jspmd

    mesh = Mesh(np.asarray(jax.devices()[:NR]), ("w",))
    ctx = jspmd.SpmdContext(axis_name="w", size=NR)
    wrapped = shard_map(
        lambda v: jspmd._allreduce_fwd_value(ctx, v, JC.MPI_SUM, name),
        mesh=mesh, in_specs=JP(), out_specs=JP(), check_vma=False)
    with jmpi.config.deterministic_mode(det):
        return jax.jit(wrapped).lower(x).as_text()


def _plower_fwd(name, x, det):
    from mpi4torch_tpu_torch import constants as C
    from mpi4torch_tpu_torch.ops import spmd as pspmd

    call = P.run_spmd(lambda v: pspmd._allreduce_fwd_value(
        pspmd.current_spmd_context(), v, C.MPI_SUM, name), nranks=NR,
        device="cpu")
    with P.config.deterministic_mode(det):
        return P.analyze.lower(call, x)


def _tier_reports(name, nelem, det, tiers):
    a = np.arange(nelem, dtype=np.float32)
    jx, px = jnp.asarray(a), torch.from_numpy(a)
    with jmpi.obs.trace() as jt:
        jmpi.run_ranks(lambda rank: jmpi.COMM_WORLD.Allreduce(
            jx * (rank + 1), jmpi.MPI_SUM, algorithm=name), NR)
    with P.obs.trace() as pt:
        P.run_ranks(lambda rank: P.COMM_WORLD.Allreduce(
            px * (rank + 1), P.MPI_SUM, algorithm=name), NR, device="cpu")
    jrep = jmpi.obs.reconcile(jt.events, _jlower_fwd(name, jx, det),
                              dropped=jt.dropped, tiers=tiers)
    prep = P.obs.reconcile(pt, _plower_fwd(name, px, det), tiers=tiers,
                           device="cpu")
    return jrep, prep


class TestReconcileTiers:
    def test_measured_tier_wire_matches_predicted_exactly(self):
        stack = (2, 2, 2)
        jres = jcs.synthesize_tiers(NR, 4096, 4, tiers=stack,
                                    tier_bandwidths=SKEW)
        res = pcs.synthesize_tiers(NR, 4096, 4, tiers=stack,
                                   tier_bandwidths=SKEW)
        name = pcs.install(res["program"])
        assert jcs.install(jres["program"]) == name
        jrep, prep = _tier_reports(name, 1024, True, stack)
        assert prep["ok"], prep
        assert prep["matches"]["tier_wire"]
        assert prep["measured"]["tier_wire"] \
            == prep["predicted"]["tier_wire"] == res["tier_wire"]
        for side in ("measured", "predicted"):
            for k in ("wire_bytes", "counts", "tier_wire"):
                assert prep[side][k] == jrep[side][k], (side, k)

    def test_reconcile_without_tiers_is_unchanged(self):
        jrep, prep = _tier_reports("ring", 256, False, None)
        assert prep["ok"], prep
        assert "tier_wire" not in prep["measured"]
        assert "tier_wire" not in prep["matches"]
        assert prep["measured"]["wire_bytes"] \
            == jrep["measured"]["wire_bytes"]
