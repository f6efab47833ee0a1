"""The port's elastic runtime (``mpi4torch_tpu_torch.elastic``) against
the JAX package's (``mpi4torch_tpu.elastic``) on the CPU.

* membership: ``WorldView``, ``fence_tag`` and ``_ratify``'s verdicts
  equal JAX's for the same proposals; ``agree_world_view`` on (3,) and
  (8,) rank-thread worlds, with ``leaving`` and ``joining``, ratifies
  JAX's view field for field; disagreement and a second failure raise
  the same types naming the same ids; a failed consensus snapshots a
  flight-recorder postmortem (``ConsensusError`` is in the recorder's
  failure set);
* replan and spare: ``replan_axis0``, ``replan_axis0_tree``,
  ``replan_zero`` on (8,)->(6,) and (4,)->(2,) drains and (2,)->(4,)
  grows, and ``zero_spare_step``/``takeover_shard``/``bank_spare_step``/
  ``takeover_bank_slot``, bitwise JAX's Mode B on the same seeded float32
  and float64 numpy inputs;
* serving: a (4,) TP world drained and re-admitted on (2,), dense and
  paged, on the matrix's f32 config with JAX's parameters
  (``params_from_jax``): stitched tokens equal JAX's and ``generate()``'s;
  ``admit_expired`` and deadline tickets as JAX's;
* the matrix: the fast cells' records (status, fired kinds, fallback,
  expected) equal JAX's; the coverage literals equal JAX's; the full
  sweep is ``slow``, as in JAX.
"""

import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu import elastic as JE
from mpi4torch_tpu.elastic import matrix as jmatrix
from mpi4torch_tpu.elastic import membership as jmembership
from mpi4torch_tpu_torch import config, elastic as E
from mpi4torch_tpu_torch.elastic import matrix as ematrix
from mpi4torch_tpu_torch.elastic import membership
from mpi4torch_tpu_torch.elastic.__main__ import elastic_problems
from mpi4torch_tpu_torch.runtime import RankFailedError

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset():
    yield
    for cfg in (config, jmpi.config):
        cfg.set_fault_plan(None)
        cfg.set_comm_tracer(None)


def _fields(v):
    return (v.epoch, tuple(v.alive), tuple(v.mesh_shape))


# --------------------------------------------------------------------------
# registry and coverage
# --------------------------------------------------------------------------


def test_coverage_literals_equal_jax():
    assert ematrix.KINDS == jmatrix.KINDS
    assert ematrix.SUBSYSTEMS == jmatrix.SUBSYSTEMS
    assert ematrix.ACTIONS == jmatrix.ACTIONS
    assert ematrix.COVERAGE == jmatrix.COVERAGE
    assert ematrix.CONSENSUS_COVERAGE == jmatrix.CONSENSUS_COVERAGE
    assert ematrix.SPARE_FALLBACK == jmatrix.SPARE_FALLBACK
    assert {k: v.__name__ for k, v in
            ematrix.EXPECTED_CONSENSUS_ERROR.items()} == \
        {k: v.__name__ for k, v in jmatrix.EXPECTED_CONSENSUS_ERROR.items()}
    assert list(ematrix.coverage_cells()) == list(jmatrix.coverage_cells())
    assert (ematrix.PROBE_TIMEOUT_S, ematrix.WORLD_TIMEOUT_S) == \
        (jmatrix.PROBE_TIMEOUT_S, jmatrix.WORLD_TIMEOUT_S)


def test_registry_guard_clean_and_fires_like_jax(monkeypatch):
    from mpi4torch_tpu.analyze.registry import elastic_problems as jprob

    assert elastic_problems() == [] == jprob()
    for mod in (ematrix, jmatrix):
        cov = dict(mod.COVERAGE)
        cov.pop(("preempt", "serve", "grow"))
        monkeypatch.setattr(mod, "COVERAGE", cov)
    assert elastic_problems() == jprob() != []


# --------------------------------------------------------------------------
# membership
# --------------------------------------------------------------------------


def test_world_view_and_fence_tags_equal_jax():
    for args in [(0, (0, 1, 2, 3), (4,)), (3, (0, 2, 5), (3,)),
                 (7, (1, 2, 3, 4, 5, 6), (2, 3))]:
        v, jv = E.WorldView(*args), JE.WorldView(*args)
        assert _fields(v) == _fields(jv)
        assert v.describe() == jv.describe() and v.size == jv.size
        assert [v.position(r) for r in v.alive] == \
            [jv.position(r) for r in jv.alive]
    for bad in [(-1, (0,), (1,)), (0, (1, 0), (2,)), (0, (0, 0), (2,)),
                (0, (0, 1, 2), (2, 2)), (0, (), (1,)), (0, (0,), (0,))]:
        with pytest.raises(E.ElasticError) as pe:
            E.WorldView(*bad)
        with pytest.raises(JE.ElasticError) as je:
            JE.WorldView(*bad)
        assert str(pe.value) == str(je.value)
    assert [E.fence_tag(e, p) for e in range(6) for p in range(4)] == \
        [JE.fence_tag(e, p) for e in range(6) for p in range(4)]
    assert _fields(E.initial_view(6, (2, 3))) == \
        _fields(JE.initial_view(6, (2, 3)))
    with pytest.raises(ValueError):
        E.fence_tag(0, 4)


def _ratify_cases():
    def mk(pkg, *a):
        return pkg.WorldView(*a)

    return [
        # unanimous
        lambda pkg: (mk(pkg, 0, (0, 1, 2, 3), (4,)),
                     {p: mk(pkg, 1, (0, 1, 3), (3,)) for p in range(3)}),
        # one dissenter on the mesh
        lambda pkg: (mk(pkg, 0, (0, 1, 2, 3), (4,)),
                     {0: mk(pkg, 1, (0, 1, 2, 3), (4,)),
                      1: mk(pkg, 1, (0, 1, 2, 3), (4,)),
                      2: mk(pkg, 1, (0, 1, 2, 3), (2, 2)),
                      3: mk(pkg, 1, (0, 1, 2, 3), (4,))}),
        # a stale proposal
        lambda pkg: (mk(pkg, 2, (0, 4, 5), (3,)),
                     {0: mk(pkg, 3, (0, 4), (2,)),
                      1: mk(pkg, 2, (0, 4), (2,)),
                      2: mk(pkg, 3, (0, 4), (2,))}),
        # a tie: the lowest proposing position wins, the rest lose
        lambda pkg: (mk(pkg, 0, (0, 1, 2, 3), (4,)),
                     {0: mk(pkg, 1, (0, 1), (2,)),
                      1: mk(pkg, 1, (0, 1), (2,)),
                      2: mk(pkg, 1, (0, 1, 2, 3), (4,)),
                      3: mk(pkg, 1, (0, 1, 2, 3), (4,))}),
        # everyone stale
        lambda pkg: (mk(pkg, 1, (0, 1), (2,)),
                     {0: mk(pkg, 1, (0, 1), (2,)), 1: "junk"}),
    ]


@pytest.mark.parametrize("case", range(5))
def test_ratify_verdicts_equal_jax(case):
    view, props = _ratify_cases()[case](E)
    jview, jprops = _ratify_cases()[case](JE)
    kind, payload = membership._ratify(view, props)
    jkind, jpayload = jmembership._ratify(jview, jprops)
    assert kind == jkind
    if kind == "ok":
        assert _fields(payload) == _fields(jpayload)
    else:
        assert payload == jpayload


@pytest.mark.parametrize("n,leaving,joining,mesh", [
    (3, (), (), None), (3, (1,), (), None), (3, (), (5, 4), (5,)),
    (8, (2, 7), (), (2, 3)), (8, (0,), (9,), None)])
def test_agree_world_view_ratifies_jax_view(n, leaving, joining, mesh):
    view, jview = E.initial_view(n), JE.initial_view(n)

    def body(rank):
        return E.agree_world_view(view, leaving=leaving, joining=joining,
                                  mesh_shape=mesh, probe_timeout=5.0)

    def jbody(rank):
        return JE.agree_world_view(jview, leaving=leaving, joining=joining,
                                   mesh_shape=mesh, probe_timeout=5.0)

    outs = mpi.run_ranks(body, n, timeout=20.0, device=CPU)
    jouts = jmpi.run_ranks(jbody, n, timeout=20.0)
    assert {_fields(v) for v in outs} == {_fields(jouts[0])}
    assert len({_fields(v) for v in jouts}) == 1


def test_agree_world_view_refusals_equal_jax():
    for kw in (dict(leaving=[5]), dict(joining=[1])):
        view, jview = E.initial_view(2), JE.initial_view(2)
        with pytest.raises(E.ElasticError) as pe:
            mpi.run_ranks(lambda r: E.agree_world_view(
                view, probe_timeout=1.0, **kw), 2, timeout=5.0,
                device=CPU)
        with pytest.raises(JE.ElasticError) as je:
            jmpi.run_ranks(lambda r: JE.agree_world_view(
                jview, probe_timeout=1.0, **kw), 2, timeout=5.0)
        assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("kind", ["disagree", "second_failure"])
def test_consensus_failures_equal_jax(kind):
    rec = ematrix.run_consensus_cell(kind, device=CPU)
    jrec = jmatrix.run_consensus_cell(kind)
    assert rec == jrec
    assert rec["status"] == "ok", rec["detail"]


def test_runtime_consensus_past_a_dead_rank_and_fence():
    rt = E.ElasticRuntime(4, probe_timeout=0.5, world_timeout=8.0,
                          device=CPU)
    jrt = JE.ElasticRuntime(4, probe_timeout=0.5, world_timeout=8.0)
    stale = rt.view
    for r in (rt, jrt):
        r.note_dead(2, "reported by the caller")
    got, jgot = rt.consensus(), jrt.consensus()
    assert _fields(got) == _fields(jgot) == (1, (0, 1, 3), (3,))
    assert rt.dead_ids == jrt.dead_ids == {}
    with pytest.raises(E.StaleEpochError) as ei:
        rt.run_phase(lambda pos, rid: None, view=stale)
    assert (ei.value.have, ei.value.want) == (0, 1)
    assert rt.run_phase(lambda pos, rid: (pos, rid)) == \
        [(0, 0), (1, 1), (2, 3)]
    with pytest.raises(E.ElasticError):
        E.ElasticRuntime(4, view=E.initial_view(4))


def test_transition_metrics():
    from mpi4torch_tpu_torch.obs import metrics as om

    om.reset_metrics()
    E.ElasticRuntime(3, world_timeout=8.0, device=CPU).consensus()
    snap = om.snapshot()
    assert snap["counters"]["elastic_epoch_transitions_total"] == 1
    assert snap["gauges"]["elastic_world_epoch"] == 1
    assert snap["gauges"]["elastic_world_size"] == 3


def test_consensus_failure_gets_flight_postmortem():
    """A failed resize gets its postmortem: ``ConsensusError`` is in the
    flight recorder's failure set, so the reaper snapshots the wire
    tails and names the disagreeing id, as in JAX."""
    from mpi4torch_tpu import obs as jobs
    from mpi4torch_tpu_torch import obs

    def run(pkg, runner, tracer_pkg, **kw):
        view = pkg.initial_view(3)

        def body(rank):
            def propose(p):
                if rank == 1:
                    return pkg.WorldView(p.epoch, p.alive, (1, 3))
                return p
            return pkg.agree_world_view(view, probe_timeout=0.5,
                                        _propose=propose)

        with tracer_pkg.trace() as tr:
            with pytest.raises(pkg.ConsensusError):
                runner(body, 3, timeout=8.0, **kw)
            return tr.last_postmortem()

    pm = run(E, mpi.run_ranks, obs, device=CPU)
    jpm = run(JE, jmpi.run_ranks, jobs)
    assert pm is not None
    assert pm["error"] == jpm["error"] == "ConsensusError"
    assert pm["failed_ranks"] == jpm["failed_ranks"] == [1]


def test_pending_preemptions_by_stable_id():
    from mpi4torch_tpu_torch.resilience import FaultSpec, fault_scope

    rt = E.ElasticRuntime(4, world_timeout=8.0, device=CPU)
    rt.note_dead(0, "gone")
    rt.consensus()                  # ids (1, 2, 3) at positions 0..2

    def body(pos, rid):
        for _ in range(2):
            mpi.COMM_WORLD.Allreduce(torch.ones(4), mpi.MPI_SUM)

    spec = FaultSpec("preempt", rank=1, op="Allreduce", index=0,
                     count=100)
    with fault_scope([spec]):
        rt.run_phase(body)
        assert rt.pending_preemptions() == {2: 98}
        rt.consensus(leaving=[2])
        assert rt.pending_preemptions() == {}


# --------------------------------------------------------------------------
# replan
# --------------------------------------------------------------------------


def _views(pkg, old_ids, new_ids):
    old = pkg.WorldView(0, tuple(old_ids), (len(old_ids),))
    new = pkg.WorldView(1, tuple(new_ids), (len(new_ids),))
    return old, new


RESIZES = [("drain_8_6", range(8), (0, 1, 3, 4, 5, 6), "drain"),
           ("drain_4_2", range(4), (0, 2), "drain"),
           ("grow_2_4", (0, 2), range(4), "grow")]


def _pad_deal(flat, size):
    per = -(-flat.size // size)
    return np.pad(flat, (0, per * size - flat.size)).reshape(size, per)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,old_ids,new_ids,mode", RESIZES,
                         ids=[r[0] for r in RESIZES])
def test_replan_bitwise_jax(name, old_ids, new_ids, mode, dtype):
    """replan_axis0 (rows of 3), replan_axis0_tree and replan_zero on the
    same numpy shards: bitwise JAX's Mode B and the numpy re-deal."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    old, new = _views(E, old_ids, new_ids)
    jold, jnew = _views(JE, old_ids, new_ids)
    n_units = 24
    rows = rng.standard_normal((n_units, 3)).astype(dtype)
    zero = {"w": rng.standard_normal((5, 7)).astype(dtype),
            "b": rng.standard_normal(9).astype(dtype)}
    exec_ids = old.alive if mode == "drain" else new.alive
    per_old = n_units // old.size

    def inputs(rid):
        if rid not in old.alive:
            return (np.zeros((per_old, 3), dtype),
                    {k: np.zeros_like(_pad_deal(v.reshape(-1),
                                                old.size)[0])
                     for k, v in zero.items()})
        j = old.position(rid)
        return (rows[j * per_old:(j + 1) * per_old],
                {k: _pad_deal(v.reshape(-1), old.size)[j]
                 for k, v in zero.items()})

    def body(pos):
        comm = mpi.COMM_WORLD
        r, z = inputs(exec_ids[pos])
        a = E.replan_axis0(comm, torch.from_numpy(r), n_units, old, new,
                           mode=mode)
        t = E.replan_axis0_tree(comm, {"r": torch.from_numpy(r)}, n_units,
                                old, new, mode=mode)
        zz = E.replan_zero(comm, {k: torch.from_numpy(v)
                                  for k, v in z.items()},
                           {k: torch.from_numpy(v) for k, v in zero.items()},
                           old, new, mode=mode)
        return (a.numpy(), t["r"].numpy(),
                {k: v.numpy() for k, v in zz.items()})

    def jbody(pos):
        comm = jmpi.COMM_WORLD
        r, z = inputs(exec_ids[pos])
        a = JE.replan_axis0(comm, jnp.asarray(r), n_units, jold, jnew,
                            mode=mode)
        t = JE.replan_axis0_tree(comm, {"r": jnp.asarray(r)}, n_units,
                                 jold, jnew, mode=mode)
        zz = JE.replan_zero(comm, {k: jnp.asarray(v) for k, v in z.items()},
                            zero, jold, jnew, mode=mode)
        return (np.asarray(a), np.asarray(t["r"]),
                {k: np.asarray(v) for k, v in zz.items()})

    outs = mpi.run_ranks(body, len(exec_ids), timeout=30.0, device=CPU)
    jouts = jmpi.run_ranks(jbody, len(exec_ids), timeout=30.0)
    per_new = n_units // new.size
    for pos, rid in enumerate(exec_ids):
        (a, t, z), (ja, jt, jz) = outs[pos], jouts[pos]
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(t, jt)
        for k in zero:
            np.testing.assert_array_equal(z[k], jz[k])
        if rid in new.alive:
            j = new.position(rid)
            np.testing.assert_array_equal(
                a, rows[j * per_new:(j + 1) * per_new])
            for k, v in zero.items():
                np.testing.assert_array_equal(
                    z[k], _pad_deal(v.reshape(-1), new.size)[j])
        else:
            assert not a.any()


def test_resize_embeds_equal_jax():
    for _name, old_ids, new_ids, mode in RESIZES:
        a = E.resize_embeds(*_views(E, old_ids, new_ids), mode)
        b = JE.resize_embeds(*_views(JE, old_ids, new_ids), mode)
        assert a == b
    with pytest.raises(E.ElasticError):
        E.resize_embeds(*_views(E, (0, 1), (0, 5)), "drain")
    with pytest.raises(E.ElasticError):
        E.resize_embeds(*_views(E, (0, 1), (0, 5)), "sideways")


# --------------------------------------------------------------------------
# spare
# --------------------------------------------------------------------------


class _JMomentum:
    def init(self, params):
        import jax

        return jax.tree.map(lambda p: p * 0, params)

    def update(self, grads, state, params=None):
        import jax

        m = jax.tree.map(lambda mm, gg: mm * 0.5 + gg, state, grads)
        return jax.tree.map(lambda mm: mm * (-0.25), m), m


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_zero_spare_step_and_takeover_bitwise_jax(dtype):
    """Three data ranks and a spare, two steps of the mirrored ZeRO step
    with momentum on seeded gradients: parameters, shard states and the
    spare's full mirror bitwise JAX's; the mirror's slot slices
    (takeover_shard) bitwise each owner's shard."""
    import jax
    import jax.numpy as jnp

    n_data, world = 3, 4
    rng = np.random.default_rng(11)
    params = {"w": rng.standard_normal((5, 4)).astype(dtype),
              "b": rng.standard_normal(7).astype(dtype)}
    grads = [[{k: rng.standard_normal(v.shape).astype(dtype)
               for k, v in params.items()} for _ in range(world)]
             for _ in range(2)]
    opt = ematrix._Momentum()
    jopt = _JMomentum()

    def body(pos):
        comm = mpi.COMM_WORLD
        slot = pos if pos < n_data else None
        p = {k: torch.from_numpy(v) for k, v in params.items()}
        st = E.zero_spare_init(opt, p, n_data, slot)
        for step in range(2):
            g = {k: (torch.from_numpy(v) if slot is not None
                     else torch.zeros(v.shape, dtype=p[k].dtype))
                 for k, v in grads[step][pos].items()}
            p, st = E.zero_spare_step(comm, opt, p, g, st, n_data=n_data,
                                      slot=slot)
        return ({k: v.numpy() for k, v in p.items()},
                {k: v.numpy() for k, v in st.items()})

    def jbody(pos):
        comm = jmpi.COMM_WORLD
        slot = pos if pos < n_data else None
        p = {k: jnp.asarray(v) for k, v in params.items()}
        st = JE.zero_spare_init(jopt, p, n_data, slot)
        for step in range(2):
            g = {k: (jnp.asarray(v) if slot is not None
                     else jnp.zeros(v.shape, v.dtype))
                 for k, v in grads[step][pos].items()}
            p, st = JE.zero_spare_step(comm, jopt, p, g, st,
                                       n_data=n_data, slot=slot)
        return jax.tree.map(np.asarray, (p, st))

    outs = mpi.run_ranks(body, world, timeout=30.0, device=CPU)
    jouts = jmpi.run_ranks(jbody, world, timeout=30.0)
    for (p, st), (jp, jst) in zip(outs, jouts):
        for k in params:
            np.testing.assert_array_equal(p[k], jp[k])
            np.testing.assert_array_equal(st[k], jst[k])
    mirror = outs[n_data][1]
    for slot in range(n_data):
        got = E.takeover_shard({k: torch.from_numpy(v)
                                for k, v in mirror.items()}, slot, n_data,
                               {k: torch.from_numpy(v)
                                for k, v in params.items()})
        want = JE.takeover_shard({k: jnp.asarray(v)
                                  for k, v in mirror.items()}, slot,
                                 n_data, params)
        for k in params:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            np.testing.assert_array_equal(got[k].numpy(), outs[slot][1][k])
    with pytest.raises(E.ElasticError):
        mpi.run_ranks(lambda r: E.zero_spare_step(
            mpi.COMM_WORLD, opt, {}, {}, {}, n_data=2, slot=None,
            slots=(0, 0)), 2, timeout=5.0, device=CPU)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bank_spare_step_and_takeover_bitwise_jax(dtype):
    import jax.numpy as jnp

    n_data, world = 2, 3
    rng = np.random.default_rng(12)
    bank = rng.standard_normal((6, 4)).astype(dtype)
    deltas = rng.standard_normal((world, 6, 4)).astype(dtype)
    deltas[n_data:] = 0

    def state(pos):
        per = 6 // n_data
        return bank if pos >= n_data else bank[pos * per:(pos + 1) * per]

    outs = mpi.run_ranks(lambda pos: E.bank_spare_step(
        mpi.COMM_WORLD, torch.from_numpy(state(pos)),
        torch.from_numpy(deltas[pos]), n_data=n_data,
        slot=pos if pos < n_data else None).numpy(), world, timeout=10.0,
        device=CPU)
    jouts = jmpi.run_ranks(lambda pos: np.asarray(JE.bank_spare_step(
        jmpi.COMM_WORLD, jnp.asarray(state(pos)), jnp.asarray(deltas[pos]),
        n_data=n_data, slot=pos if pos < n_data else None)), world,
        timeout=10.0)
    for a, b in zip(outs, jouts):
        np.testing.assert_array_equal(a, b)
    for slot in range(n_data):
        got = E.takeover_bank_slot(torch.from_numpy(outs[-1]), slot, n_data)
        np.testing.assert_array_equal(got.numpy(), outs[slot])
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JE.takeover_bank_slot(
                jnp.asarray(jouts[-1]), slot, n_data)))
    assert [E.is_spare(p, 2) for p in range(3)] == \
        [JE.is_spare(p, 2) for p in range(3)]


# --------------------------------------------------------------------------
# serving: drain on (4,), re-admit on (2,)
# --------------------------------------------------------------------------


def _serve_fixture():
    import jax

    from mpi4torch_tpu.models import transformer as JT
    from mpi4torch_tpu_torch.models import transformer as T

    jcfg = jmatrix._serve_cfg()
    cfg = ematrix._serve_cfg()
    jparams = JT.init_transformer(jax.random.PRNGKey(7), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), CPU)
    return cfg, params, jcfg, jparams


def _drain_readmit(pkg, runner, eng_mod, cfg, params, scfg, **kw):
    """Serve 3 steps on (4,), drain, re-admit on (2,) and run: the
    stitched results of rank 0, with the tickets."""
    prompts, budgets = ematrix._SERVE_PROMPTS, ematrix._SERVE_BUDGETS

    def phase1(rank):
        eng = eng_mod.Engine(cfg, params, scfg, **kw)
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            eng.submit(np.asarray(p), rid=i, max_new=n)
        for _ in range(3):
            eng.step()
        return pkg.drain_tickets(eng)

    tickets, done = runner(phase1, 4)[0]

    def phase2(rank):
        eng = eng_mod.Engine(cfg, params, scfg, **kw)
        pkg.readmit(eng, tickets)
        return pkg.stitched_results({**done, **eng.run()}, tickets)

    return runner(phase2, 2)[0], tickets


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_drain_readmit_tokens_equal_jax_and_generate(paged):
    import jax.numpy as jnp

    from mpi4torch_tpu import serve as jserve
    from mpi4torch_tpu.models import transformer as JT
    from mpi4torch_tpu_torch import serve
    from mpi4torch_tpu_torch.models import transformer as T

    cfg, params, jcfg, jparams = _serve_fixture()
    extra = dict(block_size=4, num_blocks=16) if paged else {}
    got, tickets = _drain_readmit(
        E, lambda f, n: mpi.run_ranks(f, n, timeout=60.0, device=CPU),
        serve, cfg, params, serve.ServeConfig(slots=2, **extra),
        device=CPU)
    jgot, jtickets = _drain_readmit(
        JE, lambda f, n: jmpi.run_ranks(f, n, timeout=60.0), jserve, jcfg,
        jparams, jserve.ServeConfig(slots=2, **extra))
    assert [(t.rid, list(t.emitted), t.max_new) for t in tickets] == \
        [(t.rid, list(t.emitted), t.max_new) for t in jtickets]
    assert any(t.emitted for t in tickets)
    for i, (p, n) in enumerate(zip(ematrix._SERVE_PROMPTS,
                                   ematrix._SERVE_BUDGETS)):
        want = T.generate(cfg, params, torch.tensor([p]), n)[0].numpy()
        jwant = np.asarray(JT.generate(jcfg, jparams,
                                       jnp.asarray([p], jnp.int32), n)[0])
        np.testing.assert_array_equal(got[i], jgot[i])
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(want, jwant)


def test_deadline_tickets_and_admit_expired_equal_jax():
    from mpi4torch_tpu import serve as jserve
    from mpi4torch_tpu_torch import serve

    cfg, params, jcfg, jparams = _serve_fixture()

    def run(pkg, eng_mod, c, p, **kw):
        t = [0.0]
        eng = eng_mod.Engine(c, p, eng_mod.ServeConfig(slots=1),
                             clock=lambda: t[0], **kw)
        eng.submit(np.asarray([3, 4, 5]), rid="a", max_new=4,
                   deadline_s=5.0)
        eng.submit(np.asarray([6, 7]), rid="b", max_new=3, deadline_s=1.0)
        eng.step()
        t[0] = 0.5
        tickets, _ = pkg.drain_tickets(eng, snapshot=True)
        snap = [(tk.rid, list(tk.emitted), tk.deadline_s) for tk in tickets]
        tickets, _ = pkg.drain_tickets(eng)
        assert eng.pending() == 0
        t2 = [10.0]
        eng2 = eng_mod.Engine(c, p, eng_mod.ServeConfig(slots=2),
                              clock=lambda: t2[0], **kw)
        tickets[1].deadline_s = 0.0        # spent during the resize
        readmitted = pkg.readmit(eng2, tickets)
        eng2.run()
        return (snap, readmitted, eng2.statuses(),
                {k: v.tolist() for k, v in eng2.results().items()})

    ours = run(E, serve, cfg, params, device=CPU)
    theirs = run(JE, jserve, jcfg, jparams)
    assert ours == theirs
    assert ours[2]["b"] == serve.STATUS_EXPIRED


# --------------------------------------------------------------------------
# the matrix
# --------------------------------------------------------------------------


_FAST_CELLS = [
    ("preempt", "plain", "shrink"),
    ("rank_death", "plain", "spare"),
    ("preempt", "zero", "shrink"),
    ("rank_death", "moe", "shrink"),
]

_RECORD_KEYS = ("kind", "subsystem", "action", "expected", "status",
                "fired", "fallback")


def _record(rec):
    return {k: rec.get(k) for k in _RECORD_KEYS}


@pytest.mark.parametrize("kind,subsystem,action", _FAST_CELLS)
def test_matrix_fast_cell_equals_jax(kind, subsystem, action):
    rec = ematrix.run_cell(kind, subsystem, action, device=CPU)
    assert rec["status"] == "ok", rec["detail"]
    assert kind in rec["fired"]
    assert _record(rec) == _record(jmatrix.run_cell(kind, subsystem,
                                                    action))


@pytest.mark.slow
def test_matrix_every_cell_equals_jax():
    for key in sorted(ematrix.COVERAGE):
        rec = ematrix.run_cell(*key, device=CPU)
        assert rec["status"] == "ok", (key, rec["detail"])
        assert _record(rec) == _record(jmatrix.run_cell(*key)), key


def test_run_cell_without_coverage_row_fails_typed():
    rec = ematrix.run_cell("rank_death", "nosuch", "shrink", device=CPU)
    jrec = jmatrix.run_cell("rank_death", "nosuch", "shrink")
    assert _record(rec) == _record(jrec)
    assert rec["status"] == "fail"


def test_membership_failure_raises_typed_on_every_rank():
    """A rank dying between the probe and its proposal ends consensus in
    the attributed RankFailedError (the runtime's bounded wait)."""
    from mpi4torch_tpu_torch.resilience import FaultSpec, fault_scope

    view = E.initial_view(3)
    with fault_scope([FaultSpec("rank_death", rank=2, op="p2p",
                                index=0)]):
        with pytest.raises(RankFailedError) as ei:
            mpi.run_ranks(lambda r: E.agree_world_view(
                view, probe_timeout=0.5), 3, timeout=8.0, device=CPU)
    assert 2 in ei.value.ranks
