"""The port's static collective-schedule verifier
(``mpi4torch_tpu_torch.analyze``) against the JAX package's, on the CPU.

* **Parser** (JAX's ``TestParser``): the type and bucket grammars equal
  JAX's; a recorded ring Allreduce is one ``all_reduce`` over every rank
  under ``mpi4torch.Allreduce``; bidir's two rotations appear as
  ``source_target_pairs`` on distinct channels.
* **Parity with JAX's parse**: for every registered algorithm x codec on
  (3,), (8,) and the (2, 4) mesh (the mesh's native/hier/torus forms),
  the port's recorded ``CollectiveOp`` sequence equals JAX's, op for op,
  in kind, pairs or groups, dtype, bytes and span label — forward, with
  the gradient (label aside: JAX's adjoint scope is
  ``transpose(jvp(...))``, the port's the ``...Backward`` span), and the
  Bcast_/Reduce_ forms.  Where JAX's program has a loop (bidir past
  ``chain_unroll_max``, the ordered ring fold) the port holds JAX's ops
  times the loop's trip count.
* **Pinned values**, reproduced exactly: the q8 / fp32 bidir wire
  (7280 B with 28 permutes + 4 all-gathers, 28672 B), the (8,) -> (2, 4)
  reshard (98304 B one all-to-all planned, 917504 B one all-gather), the
  serve decode step's 14336 B; its exposure equals the JAX package's own
  lowering today, (16, 0.5) with overlap and (8, 1.0) blocking (the
  JAX test file's literal 0.5625 is not what its lowering gives on this
  JAX; ROADMAP.md Queue 3 item 18).
* **peak_live_bytes**: planned below gather, each within a factor of 2
  of JAX's pinned 426039 / 1343606 and of the reshard plan's estimate.
* **Purity**: two lowerings are equal; ``Engine.lower_step`` leaves the
  next tokens unchanged and raises without ``spmd=True``.
* **Lints, defect corpus, registry guards** (JAX's ``TestLints``,
  ``TestDefectCorpus``, ``TestRegistryGuards``) and the **config knobs**
  (``chain_unroll_max``, ``thresholds_fingerprint``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import analyze as ja
from mpi4torch_tpu import tune as jtune
from mpi4torch_tpu.analyze.sweep import _flat_lowerer as _jflat
from mpi4torch_tpu.analyze.sweep import _mesh2d_lowerer as _jmesh
from mpi4torch_tpu.compress import available_codecs, codec_rides_algorithm
from mpi4torch_tpu.compress import get_codec as jget_codec
from mpi4torch_tpu_torch import analyze as pa
from mpi4torch_tpu_torch import config
from mpi4torch_tpu_torch.analyze.parse import CollectiveOp, OpEvent
from mpi4torch_tpu_torch.analyze.sweep import _flat_lowerer as _pflat
from mpi4torch_tpu_torch.analyze.sweep import _mesh2d_lowerer as _pmesh

NR = 8


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A private tune cache per test on both sides (the selector must not
    read a winner another test measured), and every knob reset after."""
    monkeypatch.setenv("MPI4TORCH_TPU_TUNE_CACHE",
                       str(tmp_path / "tune_cache.json"))
    P.tune.clear()
    jmpi.tune.clear()
    yield
    P.tune.clear()
    jmpi.tune.clear()
    for cfg in (config, jmpi.config):
        cfg.set_chain_unroll_max(cfg.DEFAULT_CHAIN_UNROLL_MAX)
        cfg.set_ordered_fold_gather_max_bytes(
            cfg.DEFAULT_ORDERED_FOLD_GATHER_MAX_BYTES)
        cfg.set_ordered_ring_chunk_bytes(
            cfg.DEFAULT_ORDERED_RING_CHUNK_BYTES)
        cfg.set_latency_crossover_bytes(None)
        cfg.set_comm_finite_guard("off")
    config.set_ctl_halflife(4.0)
    config.set_ctl_drift_thresholds(0.5, 0.8)


def _sig(parsed, label=True):
    """The per-op comparison key: kind, pairs, groups, dtype, payload
    bytes, result bytes and (optionally) the outermost span label."""
    return [(op.kind, op.source_target_pairs, op.replica_groups, op.dtype,
             op.payload_bytes, ja.tensor_bytes(op.result_types[0]),
             op.label if label else None) for op in parsed.collectives]


def _cases(n):
    """Every registered (algorithm, codec) pair a world of ``n`` serves,
    by the JAX package's registries (the port's are held equal to them
    by its own tests)."""
    out = []
    for algo in jtune.available_algorithms():
        if jtune.get_algorithm(algo).why_not(n) is not None:
            continue
        out.append((algo, None))
        out += [(algo, c) for c in available_codecs()
                if codec_rides_algorithm(jget_codec(c), algo)]
    return out


def _jbody(algo, codec):
    return lambda c, v: c.Allreduce(v, jmpi.MPI_SUM, algorithm=algo,
                                    compression=codec or False)


def _pbody(algo, codec):
    return lambda c, v: c.Allreduce(v, P.MPI_SUM, algorithm=algo,
                                    compression=codec or False)


def _jgrad(body):
    return lambda c, v: jax.value_and_grad(
        lambda u: jnp.sum(body(c, u)))(v)


# =========================================================================
# Parser
# =========================================================================

class TestParser:
    def test_tensor_bytes_equals_jax(self):
        for desc in ("8x128xf32", "16xi8", "f64", "?xf32", "4x!quant",
                     "0x3xbf16", "2x2xi1", "3xc128"):
            assert pa.tensor_bytes(desc) == ja.tensor_bytes(desc), desc
        assert pa.tensor_bytes("8x128xf32") == 8 * 128 * 4

    def test_bucket_of_equals_jax(self):
        for scope in ("jit(f)/mpi4torch.Allreduce_tree.bucket2of5.start/x",
                      "mpi4torch.Allreduce", "mpi4torch.ServeDecode."
                      "bucket3of16.wait", "mpi4torch.A.bucket0of1.q8"):
            assert pa.bucket_of(scope) == ja.bucket_of(scope), scope

    def test_tensor_type_grammar(self):
        from mpi4torch_tpu_torch.analyze.record import tensor_type
        assert tensor_type((8, 128), torch.float32) == "8x128xf32"
        assert tensor_type((), torch.bfloat16) == "bf16"
        assert tensor_type((3,), "torch.int8") == "3xi8"

    def test_real_ring_lowering(self):
        lower, _ = _pflat(NR, "cpu")
        p = pa.parse_program(lower(
            lambda c, x: c.Allreduce(x, P.MPI_SUM), torch.ones(64)))
        assert p.num_partitions == NR
        (op,) = p.collectives
        assert op.kind == "all_reduce" and op.group_size == NR
        assert sorted(v for g in op.replica_groups for v in g) == \
            list(range(NR))
        assert op.label == "mpi4torch.Allreduce"
        assert p.events[op.line].kind == "all_reduce"

    def test_real_bidir_rotations(self):
        lower, _ = _pflat(NR, "cpu")
        p = pa.parse_program(lower(
            lambda c, x: c.Allreduce(x, P.MPI_SUM, algorithm="bidir"),
            torch.ones(512)))
        tables = {op.source_target_pairs
                  for op in p.ops("collective_permute")}
        fwd = tuple((i, (i + 1) % NR) for i in range(NR))
        bwd = tuple((i, (i - 1) % NR) for i in range(NR))
        assert fwd in tables and bwd in tables
        chans = [op.channel for op in p.ops("collective_permute")]
        assert len(set(chans)) == len(chans)

    def test_parse_rejects_text(self):
        with pytest.raises(TypeError, match="recorded program"):
            pa.parse_program("module @m {}")


# =========================================================================
# Parity with the JAX package's parse
# =========================================================================

class TestParityWithJax:
    @pytest.mark.parametrize("n,algo,codec", [
        (n, algo, codec) for n in (3, 8) for algo, codec in _cases(n)])
    def test_flat_allreduce_sequences(self, n, algo, codec):
        jlower, _ = _jflat(n)
        plower, plower_grad = _pflat(n, "cpu")
        xj, xp = jnp.ones((512,), jnp.float32), torch.ones(512)
        jp = ja.parse_program(jlower(_jbody(algo, codec), xj))
        pp = pa.parse_program(plower(_pbody(algo, codec), xp))
        assert _sig(pp) == _sig(jp)
        assert pp.num_partitions == jp.num_partitions == n
        jg = ja.parse_program(jlower(_jgrad(_jbody(algo, codec)), xj))
        pg = pa.parse_program(plower_grad(_pbody(algo, codec), xp))
        assert _sig(pg, False) == _sig(jg, False)

    def test_every_pair_is_covered(self):
        assert len(_cases(3)) == 11 and len(_cases(8)) == 17
        for n in (3, 8):
            assert {(a, c) for a, c in _cases(n)} == {
                (a, c) for a in P.tune.available_algorithms()
                if P.tune.get_algorithm(a).why_not(n) is None
                for c in [None] + [
                    c for c in P.compress.available_codecs()
                    if P.compress.codec_rides_algorithm(
                        P.compress.get_codec(c), a)]}

    @pytest.mark.parametrize("n", [3, 8])
    def test_bcast_reduce_sequences(self, n):
        jlower, _ = _jflat(n)
        plower, _ = _pflat(n, "cpu")
        xj, xp = jnp.ones((512,), jnp.float32), torch.ones(512)
        for algo in jtune.available_algorithms():
            if jtune.get_algorithm(algo).why_not(n, "bcast") is None:
                assert _sig(pa.parse_program(plower(
                    lambda c, v: c.Bcast_(v, 0, algorithm=algo), xp))) \
                    == _sig(ja.parse_program(jlower(
                        lambda c, v: c.Bcast_(v, root=0, algorithm=algo),
                        xj))), algo
            if jtune.get_algorithm(algo).why_not(n, "reduce") is None:
                assert _sig(pa.parse_program(plower(
                    lambda c, v: c.Reduce_(v, P.MPI_SUM, 0,
                                           algorithm=algo), xp))) \
                    == _sig(ja.parse_program(jlower(
                        lambda c, v: c.Reduce_(v, jmpi.MPI_SUM, root=0,
                                               algorithm=algo), xj))), algo

    def test_mesh_2x4_sequences(self):
        jlower, _ = _jmesh((2, 4))
        plower, plower_grad = _pmesh((2, 4), "cpu")
        xj, xp = jnp.ones((512,), jnp.float32), torch.ones(512)
        for algo in (None, "hier", "torus"):
            pp = pa.parse_program(plower(_pbody(algo, None), xp))
            jp = ja.parse_program(jlower(_jbody(algo, None), xj))
            assert _sig(pp) == _sig(jp), algo
            assert pp.num_partitions == jp.num_partitions == 8
            pg = pa.parse_program(plower_grad(_pbody(algo, None), xp))
            jg = ja.parse_program(jlower(_jgrad(_jbody(algo, None)), xj))
            assert _sig(pg, False) == _sig(jg, False), algo

    def test_loops_count_once_per_trip(self):
        """JAX's text holds a ``lax.scan`` body once; the port records
        every trip: its ops are JAX's times the trip count."""
        n = 3
        jlower, _ = _jflat(n)
        plower, _ = _pflat(n, "cpu")
        xj, xp = jnp.ones((512,), jnp.float32), torch.ones(512)

        def held(jp, pp, trips):
            jkeys = [k[:-1] for k in _sig(jp)]
            pkeys = [k[:-1] for k in _sig(pp)]
            assert sorted(set(jkeys)) == sorted(set(pkeys))
            for k in set(jkeys):
                assert pkeys.count(k) == jkeys.count(k) * trips, k

        # bidir past chain_unroll_max: each of the 4 chain phases is a
        # scan of n - 1 hops.
        for cfg in (config, jmpi.config):
            cfg.set_chain_unroll_max(2)
        jp = ja.parse_program(jlower(_jbody("bidir", None), xj))
        pp = pa.parse_program(plower(_pbody("bidir", None), xp))
        assert jp.text.count("stablehlo.while") == 4
        held(jp, pp, n - 1)
        # The ordered ring fold (deterministic, past the gather
        # threshold): 2048 B in 256 B chunks, one scan of
        # nchunks + 2(n - 1) steps, two permutes a step.
        for cfg in (config, jmpi.config):
            cfg.set_chain_unroll_max(cfg.DEFAULT_CHAIN_UNROLL_MAX)
            cfg.set_ordered_fold_gather_max_bytes(0)
            cfg.set_ordered_ring_chunk_bytes(256)
        with jmpi.config.deterministic_mode(True):
            jp = ja.parse_program(jlower(_jbody("ring", None), xj))
        with config.deterministic_mode(True):
            pp = pa.parse_program(plower(_pbody("ring", None), xp))
        assert jp.text.count("stablehlo.while") == 1
        held(jp, pp, 2048 // 256 + 2 * (n - 1))
        # JAX's wire accounting prices the loop body once (ROADMAP.md
        # Queue 3 item 17); the port's record prices every trip.
        assert ja.wire_bytes_per_device(jp)[0] == 2 * 256
        assert pa.wire_bytes_per_device(pp)[0] == 24 * 256

    def test_census_hlo_prediction_equals_record(self):
        """The schedule census's predicted collective counts (the JAX
        lowering's) equal the recorded programs' wherever nothing
        loops."""
        lower, _ = _pflat(NR, "cpu")
        for algo in P.tune.available_algorithms():
            if P.tune.get_algorithm(algo).why_not(NR) is not None:
                continue
            prog = P.csched.allreduce_program(
                algo, NR, P.MPI_SUM, deterministic=False, nelems=512,
                itemsize=4)
            want = P.csched.program_census(prog, 512, 4)["hlo"]
            got = pa.parse_program(lower(_pbody(algo, None),
                                         torch.ones(512))).census()
            assert got == want, algo


# =========================================================================
# Pinned values
# =========================================================================

class TestPinnedValues:
    def test_bidir_wire_bytes(self):
        lower, _ = _pflat(NR, "cpu")
        x = torch.ones((1 << 12,), dtype=torch.float32)
        q8 = lower(_pbody("bidir", "q8"), x)
        fp = lower(_pbody("bidir", None), x)
        assert pa.wire_bytes_per_device(q8) == (
            7280, {"collective_permute": 28, "all_gather": 4})
        assert pa.wire_bytes_per_device(fp) == (
            28672, {"collective_permute": 28})
        assert round(28672 / 7280, 3) == 3.938

    @pytest.fixture(scope="class")
    def migration(self):
        fl = P.reshard.layout((NR,), 0, None)
        tl = P.reshard.layout((2, 4), 0, 1)
        G = (1024, 256)
        lower, _ = _pflat(NR, "cpu")
        x = torch.zeros(fl.shard_shape(G), dtype=torch.float32)
        out = {}
        for strategy in (None, "gather"):
            out[strategy or "planned"] = (
                lower(lambda c, v, s=strategy: c.Reshard(
                    v, fl, tl, strategy=s), x),
                P.reshard.plan_reshard(fl, tl, G, torch.float32, strategy))
        return out

    def test_reshard_wire_pinned(self, migration):
        assert pa.wire_bytes_per_device(migration["planned"][0]) == (
            98304, {"all_to_all": 1})
        assert pa.wire_bytes_per_device(migration["gather"][0]) == (
            917504, {"all_gather": 1})

    def test_peak_live_bytes_bounds(self, migration):
        planned = pa.peak_live_bytes(migration["planned"][0])
        gather = pa.peak_live_bytes(migration["gather"][0])
        assert planned < gather
        # Aten ops are not XLA's: within a factor of 2 of JAX's pinned
        # scan and of the plan's own estimate.
        for got, jax_pinned, plan in ((planned, 426039,
                                       migration["planned"][1]),
                                      (gather, 1343606,
                                       migration["gather"][1])):
            assert jax_pinned / 2 <= got <= 2 * jax_pinned
            assert plan.peak_bytes / 2 <= got <= 2 * plan.peak_bytes

    def test_reshard_entry_points_delegate(self, migration):
        prog = migration["planned"][0]
        assert P.reshard.peak_live_bytes(prog) == pa.peak_live_bytes(prog)
        assert P.reshard.tensor_bytes("4x2xf32") == 32

    @pytest.fixture(scope="class")
    def decode(self):
        kw = dict(vocab=256, d_model=64, n_heads=8, n_layers=4, d_ff=128,
                  max_seq=64)
        out = {}
        prev = (config.latency_crossover_bytes(),
                jmpi.config.latency_crossover_bytes())
        config.set_latency_crossover_bytes(1 << 14)
        jmpi.config.set_latency_crossover_bytes(1 << 14)
        try:
            cfg = P.models.transformer.TransformerConfig(**kw)
            params = P.models.transformer.init_transformer(
                0, cfg, dtype=torch.float32, device="cpu")
            from mpi4torch_tpu._compat import lowered_text
            from mpi4torch_tpu.models import transformer as JT
            jcfg = JT.TransformerConfig(**kw)
            jparams = JT.init_transformer(jax.random.PRNGKey(0), jcfg,
                                          dtype=jnp.float32)
            for name, ov in (("overlap", True), ("blocking", False)):
                eng = P.serve.Engine(cfg, params,
                                     P.serve.ServeConfig(slots=4,
                                                         overlap=ov),
                                     spmd=True, nranks=NR, device="cpu")
                eng.submit(np.array([1, 2, 3, 4, 5]), max_new=3)
                eng.step()
                jeng = jmpi.serve.Engine(
                    jcfg, jparams, jmpi.serve.ServeConfig(
                        slots=4, overlap=ov), spmd=True, nranks=NR)
                jeng.submit(np.array([1, 2, 3, 4, 5]), max_new=3)
                jeng.step()
                out[name] = (eng.lower_step(), lowered_text(
                    jeng.lower_step(), debug_info=True))
        finally:
            config.set_latency_crossover_bytes(prev[0])
            jmpi.config.set_latency_crossover_bytes(prev[1])
        return out

    def test_decode_wire_bytes_pinned(self, decode):
        for name in ("overlap", "blocking"):
            prog, jtext = decode[name]
            wire, counts = pa.wire_bytes_per_device(prog)
            assert wire == 14336, name
            assert round(wire / 4, 1) == 3584.0
            assert (wire, counts) == ja.wire_bytes_per_device(jtext)
            assert _sig(pa.parse_program(prog), False) == _sig(
                ja.parse_program(jtext), False)

    def test_decode_exposure_equals_jax(self, decode):
        ov = pa.scheduled_exposure(decode["overlap"][0])
        bl = pa.scheduled_exposure(decode["blocking"][0])
        assert (ov["n_buckets"], ov["exposed_fraction"]) == (16, 0.5)
        assert (bl["n_buckets"], bl["exposed_fraction"]) == (8, 1.0)
        for name, got in (("overlap", ov), ("blocking", bl)):
            assert got == ja.scheduled_exposure(decode[name][1]), name

    def test_overlap_entry_point_delegates(self, decode):
        prog = decode["overlap"][0]
        assert P.overlap.scheduled_exposure(prog) == \
            pa.scheduled_exposure(prog)

    def test_int8_rotation_census_equals_jax(self):
        plower, _ = _pflat(NR, "cpu")
        jlower, _ = _jflat(NR)
        prog = plower(_pbody("bidir", "q8"), torch.ones(4096))
        seen, fwd, bwd = P.compress.int8_rotation_census(prog, NR)
        assert fwd in seen and bwd in seen
        jtext = jlower(_jbody("bidir", "q8"), jnp.ones((4096,),
                                                       jnp.float32))
        assert (seen, fwd, bwd) == jmpi.compress.int8_rotation_census(
            jtext, NR)


# =========================================================================
# Purity of the lowering
# =========================================================================

class TestLoweringIsPure:
    def test_two_lowerings_equal(self):
        lower, lower_grad = _pflat(3, "cpu")
        x = torch.linspace(-1.0, 1.0, 300)
        for body in (_pbody("bidir", "q8"), _pbody("ring", "bf16r")):
            assert lower(body, x) == lower(body, x)
            assert lower_grad(body, x) == lower_grad(body, x)

    def test_forward_region_is_the_forward_program(self):
        # The sweep lints a value-and-gradient recording's first run as
        # the forward program: its collectives are a forward recording's.
        lower, lower_grad = _pflat(3, "cpu")
        x = torch.linspace(-1.0, 1.0, 300)
        for body in (_pbody("bidir", "q8"), _pbody("tree", None)):
            fwd = lower(body, x)
            both = lower_grad(body, x)
            assert len(both.regions) == 2 and both.regions[0] == 0
            head = both.region(0)
            assert [dataclasses.replace(op, line=0)
                    for op in head.collectives] == [
                dataclasses.replace(op, line=0) for op in fwd.collectives]
            tail = both.region(1)
            assert len(head.collectives) + len(tail.collectives) == \
                len(both.collectives)
            assert all(ev.line >= both.regions[1] for ev in tail.events)

    def test_lowering_leaves_inputs_alone(self):
        lower, _ = _pflat(3, "cpu")
        x = torch.linspace(-1.0, 1.0, 300)
        before = x.clone()
        lower(_pbody("ring", "q8"), x)
        assert torch.equal(x, before) and not x.requires_grad

    def test_lowering_unseen_by_tracer_and_fault_plan(self):
        # A lowering records a program, it serves none: an installed comm
        # tracer (its Mode A step events too) sees nothing of it, and a
        # fault plan fires on none of its exchanges.
        lower, _ = _pflat(3, "cpu")
        x = torch.linspace(-1.0, 1.0, 300)
        body = _pbody("ring", None)
        clean = lower(body, x)
        rz = P.resilience
        plan = rz.FaultPlan([rz.FaultSpec("corrupt_nan", rank=0)])
        with P.obs.trace(mode_a=True) as t, rz.fault_scope(plan):
            assert lower(body, x) == clean
        assert t.events_for() == [] and plan.fired == []

    @pytest.mark.parametrize("paged", [False, True])
    def test_lower_step_leaves_tokens(self, paged):
        cfg = P.models.transformer.TransformerConfig(
            vocab=37, d_model=16, n_heads=4, n_layers=2, d_ff=32,
            max_seq=24)
        params = P.models.transformer.init_transformer(
            1, cfg, dtype=torch.float64, device="cpu")
        extra = dict(block_size=4, num_blocks=16) if paged else {}

        def run(lower_every_step):
            eng = P.serve.Engine(cfg, params,
                                 P.serve.ServeConfig(slots=2, **extra),
                                 spmd=True, nranks=2, device="cpu")
            eng.submit(np.array([1, 2, 3]), max_new=5)
            eng.submit(np.array([4, 5]), max_new=4)
            progs, logits = [], []
            while eng.pending():
                if lower_every_step and eng.occupancy():
                    progs.append(eng.lower_step())
                eng.step()
                if eng.last_logits is not None:
                    logits.append(eng.last_logits.clone())
            res = eng.results()
            return {k: v.tolist() for k, v in res.items()}, logits, progs

        plain, plain_logits, _ = run(False)
        lowered, logits, progs = run(True)
        assert plain == lowered
        assert len(plain_logits) == len(logits)
        assert all(torch.equal(a, b)
                   for a, b in zip(plain_logits, logits))
        assert progs and all(pa.run_lints(p) == [] for p in progs)

    def test_lower_step_needs_spmd(self):
        cfg = P.models.transformer.TransformerConfig(
            vocab=37, d_model=16, n_heads=4, n_layers=1, d_ff=32,
            max_seq=16)
        params = P.models.transformer.init_transformer(
            0, cfg, dtype=torch.float32, device="cpu")
        eng = P.serve.Engine(cfg, params, P.serve.ServeConfig(slots=2),
                             device="cpu")
        with pytest.raises(P.CommError, match="spmd=True"):
            eng.lower_step()

    def test_lower_needs_a_region_and_one_world(self):
        with pytest.raises(P.CommError, match="no run_spmd"):
            pa.lower(lambda x: x + 1, torch.ones(3))
        call = P.run_spmd(lambda v: P.COMM_WORLD.Allreduce(v, P.MPI_SUM),
                          nranks=2, device="cpu")
        with pytest.raises(P.CommError, match="more than one"):
            pa.lower(lambda x: (call(x), call(x)), torch.ones(3))


# =========================================================================
# Lints: hand-built corners
# =========================================================================

def synth(*ops, npart=8):
    """A parsed program of ``ops`` (CollectiveOp fields as dicts), one
    event each."""
    events, colls = [], []
    for i, kw in enumerate(ops):
        kw = dict(kw)
        kw.setdefault("scope", "")
        kw.setdefault("operand_types", ("32xf32",))
        kw.setdefault("result_types", kw["operand_types"])
        events.append(OpEvent(line=i, kind=kw["kind"], scope=kw["scope"]))
        colls.append(CollectiveOp(line=i, channel=i + 1, **kw))
    return pa.ParsedProgram(num_partitions=npart, events=tuple(events),
                            collectives=tuple(colls))


def permute(pairs, **kw):
    return dict(kind="collective_permute",
                source_target_pairs=tuple(map(tuple, pairs)), **kw)


def grouped(kind, groups, **kw):
    groups = tuple(map(tuple, groups))
    return dict(kind=kind, replica_groups=groups,
                group_shape=(len(groups), len(groups[0])), **kw)


class TestLints:
    def test_clean_permute_lints_clean(self):
        assert pa.run_lints(synth(permute([(0, 1), (1, 2)]))) == []

    def test_duplicate_target_fires(self):
        (v,) = pa.run_lints(synth(permute([(0, 1), (2, 1)])))
        assert v.lint == "permute-pairs" and "target" in v.detail

    def test_duplicate_source_fires(self):
        (v,) = pa.run_lints(synth(permute([(0, 1), (0, 2)])))
        assert v.lint == "permute-pairs" and "source" in v.detail

    def test_out_of_range_rank_fires(self):
        (v,) = pa.run_lints(synth(permute([(0, 9)])))
        assert v.lint == "permute-pairs" and "outside" in v.detail
        assert "@ event 0" in str(v)

    def test_partial_permutation_is_legal(self):
        assert pa.run_lints(synth(permute([(4, 0), (5, 1)]))) == []

    def test_non_partitioning_group_fires(self):
        viols = pa.run_lints(synth(grouped(
            "all_gather", [[0, 1, 2, 3], [4, 5, 6, 6]])))
        assert {v.lint for v in viols} == {"replica-groups"}
        details = " ".join(v.detail for v in viols)
        assert "[6]" in details and "[7]" in details

    def test_group_partition_of_subset_world(self):
        assert pa.run_lints(synth(grouped("all_gather", [[0, 1], [2, 3]]),
                                  npart=4)) == []

    def test_split_phase_pairs(self):
        start = "mpi4torch.Allreduce_tree.bucket0of1.start"
        wait = "mpi4torch.Allreduce_tree.bucket0of1.wait"
        ok = synth(grouped("reduce_scatter", [range(8)], scope=start),
                   grouped("all_gather", [range(8)], scope=wait))
        assert pa.run_lints(ok) == []
        (v,) = pa.run_lints(synth(grouped("reduce_scatter", [range(8)],
                                          scope=start)))
        assert v.lint == "split-phase" and "never waited" in v.detail
        twice = synth(grouped("all_gather", [range(8)], scope=start),
                      grouped("all_gather", [range(8)], scope=wait),
                      grouped("all_gather", [range(8)], scope=wait))
        assert any("completes the same" in v.detail
                   for v in pa.run_lints(twice))

    def test_vjp_symmetry_self(self):
        fwd = synth(permute([(0, 1), (1, 0)]))
        both = synth(permute([(0, 1), (1, 0)]), permute([(0, 1), (1, 0)]))
        assert pa.check_vjp_symmetry(fwd, both, "self") == []
        (v,) = pa.check_vjp_symmetry(fwd, fwd, "self")
        assert v.lint == "vjp-symmetry"

    def test_vjp_symmetry_transpose_mapping(self):
        fwd = synth(grouped("all_gather", [range(8)]))
        both = synth(grouped("all_gather", [range(8)]),
                     grouped("reduce_scatter", [range(8)]))
        decl = {"all_gather": "reduce_scatter"}
        assert pa.check_vjp_symmetry(fwd, both, decl) == []
        assert pa.check_vjp_symmetry(fwd, both, "self") != []

    def test_unknown_declaration_raises(self):
        fwd = synth(permute([(0, 1)]))
        with pytest.raises(ValueError, match="vjp_census"):
            pa.check_vjp_symmetry(fwd, fwd, "mirror")

    def test_verdicts_equal_jax_on_recorded_programs(self):
        """The same verdicts as JAX's on the same programs: clean on a
        recording and its JAX twin, and the same lint names on both
        sides' mutants."""
        plower, _ = _pflat(NR, "cpu")
        jlower, _ = _jflat(NR)
        pp = pa.parse_program(plower(_pbody("bidir", None),
                                     torch.ones(512)))
        jp = ja.parse_program(jlower(_jbody("bidir", None),
                                     jnp.ones((512,), jnp.float32)))
        assert pa.run_lints(pp) == [] and ja.run_lints(jp) == []
        mutant = pa.DEFECTS["duplicated-permute-target"].mutate(pp)
        jmutant = ja.DEFECTS["duplicated-permute-target"].mutate(jp.text)
        assert [v.lint for v in pa.run_lints(mutant)] == \
            [v.lint for v in ja.run_lints(jmutant)] == ["permute-pairs"]

    def test_every_registered_algorithm_declares_symmetry(self):
        for name in P.tune.available_algorithms():
            n = 8 if P.tune.get_algorithm(name).why_not(8) is None else 6
            decl = P.csched.declared_vjp_census(name, n)
            assert decl == "self" or isinstance(decl, dict), (name, decl)


# =========================================================================
# Seeded-defect corpus
# =========================================================================

@pytest.fixture(scope="module")
def corpus_programs():
    from mpi4torch_tpu_torch.analyze.__main__ import _corpus_programs
    return _corpus_programs(NR, "cpu")


class TestDefectCorpus:
    def test_every_defect_caught_by_its_named_lint(self, corpus_programs):
        records = pa.run_defect_corpus(corpus_programs)
        assert sorted(r["defect"] for r in records) == sorted(pa.DEFECTS)
        assert sorted(pa.DEFECTS) == sorted(ja.DEFECTS)
        for rec in records:
            assert rec["clean_ok"], rec
            assert rec["fired"], rec
            assert rec["lint"] == ja.DEFECTS[rec["defect"]].lint

    def test_ledger_every_lint_covered(self, corpus_programs):
        records = pa.run_defect_corpus(corpus_programs)
        assert pa.defect_ledger_problems(records) == []
        assert pa.LINT_NAMES == ja.LINT_NAMES

    def test_ledger_detects_uncovered_lint(self):
        ghost = pa.DEFECTS.pop("non-partitioning-group")
        try:
            problems = pa.defect_ledger_problems()
            assert problems and "replica-groups" in " ".join(problems)
        finally:
            pa.DEFECTS[ghost.name] = ghost

    def test_ledger_detects_unfired_defect(self, corpus_programs):
        records = pa.run_defect_corpus(corpus_programs)
        records[0] = dict(records[0], fired=False)
        problems = pa.defect_ledger_problems(records)
        assert any("did not fire" in p for p in problems)

    def test_mutations_leave_the_clean_program(self, corpus_programs):
        clean = pa.parse_program(corpus_programs.split_phase)
        before = dataclasses.replace(clean)
        for name in ("dropped-wait", "orphan-wait", "double-wait"):
            assert pa.DEFECTS[name].mutate(clean) != clean
        assert clean == before and pa.run_lints(clean) == []


# =========================================================================
# Registry guards
# =========================================================================

class TestRegistryGuards:
    def test_set_drift_formats_message(self):
        from mpi4torch_tpu_torch.analyze.registry import set_drift
        assert set_drift({"a"}, {"a"}, "x") == []
        (msg,) = set_drift({"a", "b"}, {"a"},
                           "reg {registered} cov {covered}")
        assert msg == "reg ['a', 'b'] cov ['a']"

    def test_standing_problems_clean(self):
        from mpi4torch_tpu_torch.analyze.registry import standing_problems
        assert standing_problems() == []

    def test_serve_guards_against_the_jax_literals(self):
        from mpi4torch_tpu.serve.__main__ import (MIRRORED_SERVE_COUNTERS,
                                                  PAGED_PARITY_POLICIES,
                                                  PARITY_POLICIES)
        from mpi4torch_tpu_torch.analyze.registry import (
            serve_paging_problems, serve_policy_problems)
        assert serve_policy_problems(PARITY_POLICIES) == []
        assert serve_paging_problems(PAGED_PARITY_POLICIES,
                                     MIRRORED_SERVE_COUNTERS) == []
        assert serve_policy_problems(set(PARITY_POLICIES) | {"ghost"})

    def test_tune_guard_catches_ghost_algorithm(self):
        from mpi4torch_tpu_torch.analyze.registry import tune_problems
        from mpi4torch_tpu_torch.tune.registry import (_REGISTRY,
                                                       AlgorithmSpec)
        algos = tuple(P.tune.available_algorithms())
        capable = tuple(a for a in algos
                        if P.tune.get_algorithm(a).codec_capable)
        assert tune_problems(algos, algos, capable) == []
        ghost = AlgorithmSpec(name="ghost_algo")
        _REGISTRY[ghost.name] = ghost
        try:
            problems = tune_problems(algos, algos, capable)
            assert problems and "ghost_algo" in " ".join(problems)
        finally:
            del _REGISTRY[ghost.name]

    def test_overlap_and_tier_guards(self):
        from mpi4torch_tpu_torch.analyze.registry import (
            overlap_split_phase_problems, tier_program_problems)
        forms = tuple(P.overlap.SPLIT_PHASE_FORMS)
        assert overlap_split_phase_problems(forms) == []
        assert overlap_split_phase_problems(forms[1:])
        comps = tuple(P.csched.TIER_COMPOSITIONS)
        assert tier_program_problems(comps, comps) == []
        assert tier_program_problems(comps[1:], comps)


# =========================================================================
# Config knobs (JAX's tests/test_tune.py, test_obs.py, test_resilience.py
# and test_ctl.py fingerprint cases)
# =========================================================================

class TestConfigKnobs:
    def test_chain_unroll_max_validated_and_fingerprinted(self):
        before = config.thresholds_fingerprint()
        config.set_chain_unroll_max(7)
        assert config.chain_unroll_max() == 7
        assert config.thresholds_fingerprint() != before
        with pytest.raises(ValueError, match="chain_unroll_max"):
            config.set_chain_unroll_max(0)
        with pytest.raises(ValueError, match="chain_unroll_max"):
            config.set_chain_unroll_max("many")
        assert config.DEFAULT_CHAIN_UNROLL_MAX == \
            jmpi.config.DEFAULT_CHAIN_UNROLL_MAX

    def test_mode_a_flag_rides_fingerprint(self):
        base = config.thresholds_fingerprint()
        assert base[-1] is False
        with P.obs.trace(mode_a=True):
            assert config.thresholds_fingerprint()[-1] is True
        with P.obs.trace():
            assert config.thresholds_fingerprint() == base

    def test_guard_rides_the_trace_fingerprint(self):
        fp0 = config.thresholds_fingerprint()
        config.set_comm_finite_guard("warn")
        fp1 = config.thresholds_fingerprint()
        config.set_comm_finite_guard("off")
        assert fp0 != fp1

    def test_fingerprint_covers_ctl_knobs(self):
        fp = config.thresholds_fingerprint()
        config.set_ctl_halflife(9.0)
        fp2 = config.thresholds_fingerprint()
        assert fp != fp2
        config.set_ctl_drift_thresholds(0.11, 0.91)
        assert config.thresholds_fingerprint() != fp2
        assert config.thresholds_fingerprint()[-1] is False

    def test_fingerprint_equals_jax_at_defaults(self):
        assert config.thresholds_fingerprint() == \
            jmpi.config.thresholds_fingerprint()

    def test_chain_unroll_max_moves_only_the_census(self):
        # The knob moves the predicted op count of the bidir chains and
        # nothing the port runs: the recorded exchanges stay, and a
        # worker process is not sent it.
        lower, _ = _pflat(8, "cpu")
        x = torch.ones(512)
        prog = P.csched.allreduce_program(
            "bidir", NR, P.MPI_SUM, deterministic=False, nelems=512,
            itemsize=4)
        body = _pbody("bidir", None)
        before = lower(body, x)
        # Two chains of 2(n - 1) hops; rolled, two permutes a chain.
        assert P.csched.program_census(prog, 512, 4)["hlo"][
            "collective_permute"] == 2 * 2 * (NR - 1) == \
            pa.parse_program(before).census()["collective_permute"]
        config.set_chain_unroll_max(2)
        assert P.csched.program_census(prog, 512, 4)["hlo"][
            "collective_permute"] == 2 * 2
        assert lower(body, x) == before
        assert "chain_unroll_max" not in config.snapshot_process_state()
