"""The port's static-vs-runtime reconciliation (``obs.reconcile``) against
the JAX package's, on the CPU.

Follows JAX ``tests/test_obs.py::TestReconcile`` case by case: the same
traced Mode B programs on the same inputs go through each package's
tracer, and each package's report is held against the other's.  The
port's prediction reads a recorded program (``analyze.lower``) where
JAX's reads a StableHLO lowering; measured and predicted wire bytes and
collective counts must equal JAX's figures exactly.  Beyond JAX's
cases:

* the equivalent-recording path (a codec or a non-ring algorithm on the
  wire): the fused q8 buckets, bidir, tree and hier, and the overlap
  serve decode step, each exact and equal to JAX;
* the fused exact tree: a blocking bucket (and its adjoint) runs in
  Mode A as a reduce_scatter + all_gather pair, which the port's
  conversion counts and JAX's does not (ROADMAP.md Queue 3 item 21), so
  the port reconciles it with JAX's bytes; the windowed Mode B tree runs
  over p2p and reconciles in neither package;
* loops (ROADMAP.md Queue 3 item 17): JAX prices a ``lax.scan`` body
  once, the port every trip, so a bidir chain past
  ``config.chain_unroll_max`` reconciles in both packages but to other
  figures; the port's figure does not move with the knob;
* a reconcile inside an open trace adds no event to it, and without a
  card every entry point raises unless given ``device="cpu"``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import obs as jobs
from mpi4torch_tpu._compat import shard_map
from mpi4torch_tpu_torch import obs
from mpi4torch_tpu_torch.analyze.sweep import _flat_lowerer

# The module (the package's ``reconcile`` attribute is the function).
prec = importlib.import_module("mpi4torch_tpu_torch.obs.reconcile")

jcomm = jmpi.COMM_WORLD
pcomm = P.COMM_WORLD


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("MPI4TORCH_TPU_TUNE_CACHE",
                       str(tmp_path / "tune_cache.json"))
    P.tune.clear()
    jmpi.tune.clear()
    yield
    for cfg in (P.config, jmpi.config):
        cfg.set_chain_unroll_max(cfg.DEFAULT_CHAIN_UNROLL_MAX)
    P.tune.clear()
    jmpi.tune.clear()


def _jlower(fn, *args, n=8):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("w",))
    cm = jmpi.comm_from_mesh(mesh, "w")
    return jax.jit(shard_map(lambda *a: fn(cm, *a), mesh=mesh,
                             in_specs=JP(), out_specs=JP(),
                             check_vma=False)).lower(*args)


def _plower(fn, *args, n=8):
    lower, _ = _flat_lowerer(n, "cpu")
    return lower(fn, *args)


def _jtrace(body, n, **kw):
    with jobs.trace(**kw) as t:
        jmpi.run_ranks(body, n)
    return t


def _ptrace(body, n, **kw):
    with obs.trace(**kw) as t:
        P.run_ranks(body, n, device="cpu")
    return t


def _figures(rep):
    m, p = rep["measured"], rep["predicted"]
    return (rep["ok"], m["wire_bytes"], m["counts"], p["wire_bytes"],
            p["counts"], m["logical_events"], m["per_rank_consistent"])


def _both(jbody, pbody, n, jlow, plow):
    """Each package's report of the same traced run and lowering."""
    jt, pt = _jtrace(jbody, n), _ptrace(pbody, n)
    jrep = jobs.reconcile(jt.events, jlow, dropped=jt.dropped)
    prep = obs.reconcile(pt.events, plow, dropped=pt.dropped,
                         device="cpu")
    return jrep, prep


# =========================================================================
# JAX's TestReconcile, case by case
# =========================================================================

class TestReconcile:
    def test_ring_allreduce_exact(self):
        a = np.arange(512, dtype=np.float32)
        jx, px = jnp.asarray(a), torch.from_numpy(a)
        jrep, prep = _both(
            lambda r: jcomm.Allreduce(jx * (r + 1), jmpi.MPI_SUM,
                                      algorithm="ring"),
            lambda r: pcomm.Allreduce(px * (r + 1), P.MPI_SUM,
                                      algorithm="ring"), 8,
            _jlower(lambda c, v: c.Allreduce(v, jmpi.MPI_SUM,
                                             algorithm="ring"), jx),
            _plower(lambda c, v: c.Allreduce(v, P.MPI_SUM,
                                             algorithm="ring"), px))
        assert prep["ok"], prep
        assert _figures(prep) == _figures(jrep)
        assert prep["measured"]["wire_bytes"] \
            == prep["predicted"]["wire_bytes"] == 2 * 7 * 512 * 4 // 8
        assert prep["measured"]["counts"] == {"all_reduce": 1}

    def test_reshard_migration_exact(self):
        jrs, prs = jmpi.reshard, P.reshard
        G = (64, 32)
        jfl, jtl = jrs.layout((8,), 0, None), jrs.layout((2, 4), 0, 1)
        pfl, ptl = prs.layout((8,), 0, None), prs.layout((2, 4), 0, 1)
        shard = pfl.shard_shape(G)
        base = np.arange(int(np.prod(shard)),
                         dtype=np.float32).reshape(shard)
        jrep, prep = _both(
            lambda r: jcomm.Reshard(jnp.asarray(base) * (r + 1), jfl, jtl),
            lambda r: pcomm.Reshard(torch.from_numpy(base) * (r + 1), pfl,
                                    ptl), 8,
            _jlower(lambda c, v: c.Reshard(v, jfl, jtl),
                    jnp.zeros(shard, jnp.float32)),
            _plower(lambda c, v: c.Reshard(v, pfl, ptl),
                    torch.zeros(shard)))
        assert prep["ok"], prep
        assert _figures(prep) == _figures(jrep)

    def test_bookkeeping_excluded_and_determinism_checked(self):
        def jbody(rank):
            from mpi4torch_tpu.runtime import current_rank_context
            ctx = current_rank_context()
            ctx.world.barrier(ctx.rank)
            return jcomm.Allreduce(jnp.ones(4, jnp.float32), jmpi.MPI_SUM)

        def pbody(rank):
            ctx = P.runtime.current_rank_context()
            ctx.world.barrier(ctx.rank)
            return pcomm.Allreduce(torch.ones(4), P.MPI_SUM)

        jmt = jobs.measured_wire_table(_jtrace(jbody, 2).events)
        pmt = obs.measured_wire_table(_ptrace(pbody, 2).events,
                                      device="cpu")
        assert pmt["excluded"]["bookkeeping"] == 1
        assert pmt["logical_events"] == 1
        assert pmt["per_rank_consistent"]
        for k in ("excluded", "logical_events", "per_rank_consistent",
                  "wire_bytes", "counts", "by_op", "ranks", "rank"):
            assert pmt[k] == jmt[k], k

    def test_mismatch_detected(self):
        a = np.arange(512, dtype=np.float32)
        jrep, prep = _both(
            lambda r: jcomm.Allreduce(jnp.asarray(a), jmpi.MPI_SUM,
                                      algorithm="ring"),
            lambda r: pcomm.Allreduce(torch.from_numpy(a), P.MPI_SUM,
                                      algorithm="ring"), 4,
            _jlower(lambda c, v: c.Allreduce(v, jmpi.MPI_SUM,
                                             algorithm="ring"),
                    jnp.arange(1024, dtype=jnp.float32)),
            _plower(lambda c, v: c.Allreduce(v, P.MPI_SUM,
                                             algorithm="ring"),
                    torch.arange(1024, dtype=torch.float32)))
        assert not prep["ok"]
        assert not prep["matches"]["wire_bytes"]
        assert _figures(prep) == _figures(jrep)
        assert prep["matches"] == jrep["matches"]

    def test_dropped_events_fail_the_contract(self):
        x = torch.ones(64)
        t = _ptrace(lambda r: pcomm.Allreduce(x, P.MPI_SUM,
                                              algorithm="ring"), 8)
        low = _plower(lambda c, v: c.Allreduce(v, P.MPI_SUM,
                                               algorithm="ring"), x)
        good = obs.reconcile(t.events, low, dropped=0, device="cpu")
        bad = obs.reconcile(t.events, low, dropped=3, device="cpu")
        assert good["ok"] and not bad["ok"]
        assert bad["dropped_events"] == 3
        # Passing the tracer itself reads .dropped.
        assert obs.reconcile(t, low, device="cpu")["ok"]
        t.dropped = 5
        assert not obs.reconcile(t, low, device="cpu")["ok"]

    def test_spmd_events_counted_in_exclusions(self):
        with obs.trace(mode_a=True) as t:
            P.run_spmd(lambda v: pcomm.Allreduce(v, P.MPI_SUM), nranks=4,
                       device="cpu")(torch.ones(16))
        mt = obs.measured_wire_table(t.events, device="cpu")
        assert mt["excluded"]["spmd"] == len(
            t.events_for(channel="spmd")) == 4
        with jobs.trace(mode_a=True) as jt:
            step = jmpi.run_spmd(
                lambda v: jcomm.Allreduce(v, jmpi.MPI_SUM), nranks=4)
            jax.block_until_ready(step(jnp.ones(16, jnp.float32)))
        jmt = jobs.measured_wire_table(jt.events)
        assert mt["excluded"] == jmt["excluded"]

    def test_compressed_allgather_unmodeled_not_crashed(self):
        def jbody(r):
            return jcomm.Allgather(jnp.linspace(-1, 1, 64,
                                                dtype=jnp.float32)
                                   * (r + 1), 0, compression="q8")

        def pbody(r):
            return pcomm.Allgather(torch.linspace(-1, 1, 64) * (r + 1), 0,
                                   compression="q8")

        pmt = obs.measured_wire_table(_ptrace(pbody, 2).events,
                                      device="cpu")
        jmt = jobs.measured_wire_table(_jtrace(jbody, 2).events)
        assert pmt["excluded"]["unmodeled"].get("Allgather.c", 0) == 1
        assert pmt["logical_events"] == 0
        assert pmt["excluded"] == jmt["excluded"]

    def test_wire_contribution_shared_formula(self):
        from mpi4torch_tpu import analyze as ja
        from mpi4torch_tpu_torch import analyze as pa

        for kind, nbytes, g in (("collective_permute", 100, None),
                                ("all_gather", 100, 4),
                                ("all_reduce", 100, 4),
                                ("reduce_scatter", 100, 4),
                                ("all_to_all", 96, 3)):
            assert pa.wire_contribution(kind, nbytes, g) \
                == pytest.approx(ja.wire_contribution(kind, nbytes, g))
        assert pa.wire_contribution("all_gather", 100, 4) == 300
        with pytest.raises(ValueError):
            pa.wire_contribution("all_reduce", 100, None)
        with pytest.raises(ValueError):
            pa.wire_contribution("nosuch", 100, 4)


# =========================================================================
# The equivalent-recording path, against JAX's equivalent lowering
# =========================================================================

def _trees(rank, lib):
    a = np.linspace(-1, 1, 768, dtype=np.float32) * (rank + 1)
    b = np.linspace(-2, 2, 512, dtype=np.float32) * (rank + 1)
    if lib == "jax":
        return {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    return {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}


class TestEquivalentRecording:
    def test_fused_q8_buckets_exact(self):
        bb = 2048
        prec._equiv_cache.clear()
        prec._equiv_program_cache.clear()
        jrep, prep = _both(
            lambda r: jcomm.Allreduce_tree(_trees(r, "jax"), jmpi.MPI_SUM,
                                           compression="q8",
                                           bucket_bytes=bb),
            lambda r: pcomm.Allreduce_tree(_trees(r, "torch"), P.MPI_SUM,
                                           compression="q8",
                                           bucket_bytes=bb), 8,
            _jlower(lambda c, t: c.Allreduce_tree(
                t, jmpi.MPI_SUM, compression="q8", bucket_bytes=bb),
                _trees(0, "jax")),
            _plower(lambda c, t: c.Allreduce_tree(
                t, P.MPI_SUM, compression="q8", bucket_bytes=bb),
                _trees(0, "torch")))
        assert prep["ok"], prep
        assert _figures(prep) == _figures(jrep)
        assert prep["measured"]["counts"] == {"collective_permute": 28,
                                              "all_gather": 4}
        # One equivalent recording per distinct bucket signature.
        assert len(prec._equiv_program_cache) == 2

    @pytest.mark.parametrize("algo", ["bidir", "tree", "hier"])
    def test_non_ring_algorithm_exact(self, algo):
        a = np.arange(512, dtype=np.float32)
        jx, px = jnp.asarray(a), torch.from_numpy(a)
        jrep, prep = _both(
            lambda r: jcomm.Allreduce(jx * (r + 1), jmpi.MPI_SUM,
                                      algorithm=algo),
            lambda r: pcomm.Allreduce(px * (r + 1), P.MPI_SUM,
                                      algorithm=algo), 8,
            _jlower(lambda c, v: c.Allreduce(v, jmpi.MPI_SUM,
                                             algorithm=algo), jx),
            _plower(lambda c, v: c.Allreduce(v, P.MPI_SUM,
                                             algorithm=algo), px))
        assert prep["ok"], prep
        assert _figures(prep) == _figures(jrep)

    @pytest.mark.parametrize("overlap", [False, True])
    def test_fused_exact_buckets_families(self, overlap):
        """A blocking fused exact bucket runs in Mode A as a reduce_scatter
        + all_gather pair and in Mode B as one Allreduce rendezvous.  The
        port converts the Mode B bucket (and its adjoint, which carries
        the bucket's label) to the pair, as JAX's rule converts a
        split-phase bucket, and reconciles; JAX counts it as one
        ``all_reduce`` and does not (ROADMAP.md Queue 3 item 21, found in
        the reference).  The bytes are JAX's on both sides.  The windowed
        Mode B tree runs its buckets over p2p, which both packages
        exclude, so neither reconciles it."""
        jrep, prep = _both(
            lambda r: jcomm.Allreduce_tree(_trees(r, "jax"), jmpi.MPI_SUM,
                                           bucket_bytes=2048,
                                           overlap=overlap),
            lambda r: pcomm.Allreduce_tree(_trees(r, "torch"), P.MPI_SUM,
                                           bucket_bytes=2048,
                                           overlap=overlap), 8,
            _jlower(lambda c, t: c.Allreduce_tree(
                t, jmpi.MPI_SUM, bucket_bytes=2048, overlap=overlap),
                _trees(0, "jax")),
            _plower(lambda c, t: c.Allreduce_tree(
                t, P.MPI_SUM, bucket_bytes=2048, overlap=overlap),
                _trees(0, "torch")))
        pair = {"reduce_scatter": 2, "all_gather": 2}
        for side in ("measured", "predicted"):
            assert prep[side]["wire_bytes"] == jrep[side]["wire_bytes"]
        assert prep["predicted"]["counts"] == jrep["predicted"]["counts"] \
            == pair
        assert prep["measured"]["excluded"] == jrep["measured"]["excluded"]
        if overlap:
            assert not prep["ok"] and not jrep["ok"]
            assert prep["measured"]["logical_events"] == 0
            assert prep["measured"]["excluded"]["p2p"] > 0
        else:
            assert prep["ok"], prep
            assert prep["measured"]["counts"] == pair
            assert jrep["measured"]["counts"] == {"all_reduce": 2}
            assert jrep["matches"] == {"wire_bytes": True,
                                       "counts": False}

    def test_fused_bucket_adjoint_reconciles(self):
        """The DP gradient path (``dp_value_and_grad``: the parameter
        average's adjoint is the gradient's fused Allreduce) reconciles
        forward and backward, the bucket odd-sized so the pair pads."""
        from mpi4torch_tpu_torch.parallel.dp import all_average_tree

        def tree_of(rank):
            rng = np.random.default_rng(rank)
            return {"w": torch.from_numpy(rng.standard_normal(
                        (7, 5)).astype(np.float32)).requires_grad_(),
                    "b": torch.from_numpy(rng.standard_normal(
                        11).astype(np.float32)).requires_grad_()}

        def body(rank):
            t = tree_of(rank)
            out = all_average_tree(pcomm, t)
            torch.autograd.grad(sum((v * v).sum() for v in out.values()),
                                list(t.values()))

        def spmd(w, b):
            out = all_average_tree(pcomm, {"w": w, "b": b})
            return sum((v * v).sum() for v in out.values())

        t = _ptrace(body, 3)
        w = torch.zeros(7, 5, requires_grad=True)
        b = torch.zeros(11, requires_grad=True)

        def program(w, b):
            out = P.run_spmd(spmd, nranks=3, device="cpu")(w, b)
            torch.autograd.grad(out.sum(), (w, b))

        rep = obs.reconcile(t, P.analyze.lower(program, w, b),
                            device="cpu")
        assert rep["ok"], rep
        assert rep["measured"]["counts"] == {"reduce_scatter": 2,
                                             "all_gather": 2}

    def test_serve_decode_step_exact(self):
        from mpi4torch_tpu import serve as jserve
        from mpi4torch_tpu.models import transformer as JT
        from mpi4torch_tpu.runtime import current_rank_context
        from mpi4torch_tpu_torch.models import transformer as PT
        from mpi4torch_tpu_torch.obs.__main__ import serve_decode_reconcile
        from mpi4torch_tpu_torch.models.transformer import params_from_jax

        shape = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                     max_seq=32)
        jcfg, pcfg = JT.TransformerConfig(**shape), \
            PT.TransformerConfig(**shape)
        jparams = JT.init_transformer(jax.random.PRNGKey(0), jcfg,
                                      dtype=jnp.float32)
        pparams = params_from_jax(jparams, device="cpu")
        prompts = [np.array([1, 2, 3]), np.array([4, 5, 6, 7, 8])]

        with jobs.trace() as t:
            def body(rank):
                ctx = current_rank_context()
                eng = jserve.Engine(jcfg, jparams, jserve.ServeConfig(
                    slots=2, overlap=True))
                for p in prompts:
                    eng.submit(p, max_new=3)
                eng.step()
                ctx.world.barrier(ctx.rank)
                eng.step()
                return True
            jmpi.run_ranks(body, 4)
        decode = []
        for r in range(4):
            er = t.events_for(rank=r)
            cut = max(i for i, e in enumerate(er) if e.op == "Barrier")
            decode.extend(er[cut + 1:])
        eng = jserve.Engine(jcfg, jparams,
                            jserve.ServeConfig(slots=2, overlap=True),
                            spmd=True, nranks=4)
        eng.submit(prompts[0], max_new=3)
        eng.step()
        jrep = jobs.reconcile(decode, eng.lower_step(), dropped=t.dropped)

        prep = serve_decode_reconcile(pcfg, pparams, prompts, 4, "cpu")
        assert prep["ok"], prep
        assert prep["predicted"]["scheduled_exposure"] == 0.0
        assert _figures(prep) == _figures(jrep)
        assert prep["measured"]["counts"] == {"reduce_scatter": 8,
                                              "all_gather": 8}


# =========================================================================
# Loops, tracing, devices
# =========================================================================

class TestPortConventions:
    def test_looped_chain_prices_every_trip(self):
        """bidir at 3 ranks past ``chain_unroll_max``: JAX's lowering
        holds each chain phase's ``lax.scan`` body once, so JAX reconciles
        to fewer permutes than it sends; the port's recording holds every
        hop, so its figures are the unrolled ones whatever the knob
        (ROADMAP.md Queue 3 item 17)."""
        a = np.arange(512, dtype=np.float32)
        jx, px = jnp.asarray(a), torch.from_numpy(a)

        def reports():
            prec._equiv_cache.clear()
            prec._equiv_program_cache.clear()
            return _both(
                lambda r: jcomm.Allreduce(jx * (r + 1), jmpi.MPI_SUM,
                                          algorithm="bidir"),
                lambda r: pcomm.Allreduce(px * (r + 1), P.MPI_SUM,
                                          algorithm="bidir"), 3,
                _jlower(lambda c, v: c.Allreduce(v, jmpi.MPI_SUM,
                                                 algorithm="bidir"), jx,
                        n=3),
                _plower(lambda c, v: c.Allreduce(v, P.MPI_SUM,
                                                 algorithm="bidir"), px,
                        n=3))

        jflat, pflat = reports()
        assert _figures(pflat) == _figures(jflat)
        # 2 channels x 2(n - 1) hops of a 256-element half over n = 3.
        assert pflat["measured"]["counts"] == {"collective_permute": 8}
        for cfg in (P.config, jmpi.config):
            cfg.set_chain_unroll_max(2)
        jloop, ploop = reports()
        assert jloop["ok"] and ploop["ok"]
        assert _figures(ploop) == _figures(pflat)
        assert jloop["measured"]["counts"] == {"collective_permute": 4}
        assert jloop["measured"]["wire_bytes"] \
            < ploop["measured"]["wire_bytes"]

    def test_reconcile_inside_an_open_trace_adds_no_event(self):
        bb = 2048
        prec._equiv_cache.clear()
        prec._equiv_program_cache.clear()
        with obs.trace() as t:
            P.run_ranks(lambda r: pcomm.Allreduce_tree(
                _trees(r, "torch"), P.MPI_SUM, compression="q8",
                bucket_bytes=bb), 8, device="cpu")
            n = len(t.events)
            low = _plower(lambda c, tr: c.Allreduce_tree(
                tr, P.MPI_SUM, compression="q8", bucket_bytes=bb),
                _trees(0, "torch"))
            rep = obs.reconcile(t, low, device="cpu")
            assert len(t.events) == n
        assert rep["ok"], rep

    def test_one_recording_serves_total_and_tiers(self):
        prec._equiv_cache.clear()
        prec._equiv_program_cache.clear()
        prec._equiv_tier_cache.clear()
        a = np.arange(1024, dtype=np.float32)
        t = _ptrace(lambda r: pcomm.Allreduce(
            torch.from_numpy(a) * (r + 1), P.MPI_SUM, algorithm="hier"), 8)
        ev = next(e for e in t.events if e.rank == 0)
        total, _ = obs.equivalent_wire(ev, device="cpu")
        for stack in ((2, 2, 2), (2, 4), (4, 2)):
            assert sum(obs.equivalent_tier_wire(ev, stack,
                                                device="cpu")) == total
        assert len(prec._equiv_program_cache) == 1

    def test_no_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is CUDA")
        x = torch.ones(64)
        t = _ptrace(lambda r: pcomm.Allreduce(x, P.MPI_SUM), 2)
        low = _plower(lambda c, v: c.Allreduce(v, P.MPI_SUM), x, n=2)
        ev = t.events[0]
        for call in (lambda: obs.reconcile(t, low),
                     lambda: obs.measured_wire_table(t.events),
                     lambda: obs.equivalent_wire(ev),
                     lambda: obs.equivalent_tier_wire(ev, (2,))):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()

    def test_text_raises_type_error(self):
        with pytest.raises(TypeError, match="recorded program"):
            obs.reconcile([], "module @m {}", device="cpu")
