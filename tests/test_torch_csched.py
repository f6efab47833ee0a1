"""The port's collective-schedule IR against the JAX package's, on the CPU.

Follows JAX ``tests/test_csched.py`` class by class; synthesis is
``tests/test_torch_synth.py``, and the recorded-program legs of JAX's
``csched --smoke`` (re-expression, the synthesis census) run in
``tests/test_torch_cli.py``.
The port's counterpart of JAX's lowered text is the exchange sequence:
the signatures rank 0 deposits through ``World.exchange``, in order.

* Programs: every ``allreduce_program`` / ``bcast_program`` /
  ``reduce_program`` / ``q8_allreduce_program`` of every algorithm in
  ``PROGRAM_ALGORITHMS``, on n in {1, 3, 6, 8} x SUM/MAX/PROD x
  deterministic or not, below and above the gather threshold, equals
  JAX's field for field as JSON, with the same ``digest()``, and its
  ``transpose`` equals JAX's; a constructor raises where JAX's raises.
* The census (``program_census``, ``program_tier_census``, the
  predicted collective counts included) is dict-equal to JAX's at the
  default knobs, with a lower chain-unroll ceiling
  (``config.chain_unroll_max`` on both sides),
  ``phase_pipelined_ring`` off and a 3-tier ``tier_stack`` set.
* The interpreter is bitwise JAX's ``interpret_allreduce`` (f32) and the
  port's rendezvous fold; ``reduce_grouped``/``reduce_torus`` are bitwise
  JAX's; the q8 interpretation is bitwise the hop oracle.
* Mode A through the IR is bitwise the port's hand-written forms (values,
  gradients from outside and the exchange sequence, forward and
  backward) and JAX's Mode A, per algorithm, on (3,), (8,) and per axis
  of the (2, 4) mesh; the q8 IR route is bitwise the hand-composed
  pipeline (with the same exchanges) and JAX's Mode A.
* The registry-sync guard (beside the port's
  ``analyze.registry.csched_problems``): every registered
  algorithm has a program, and lowering, interpreter, transposition
  and census each cover ``STEP_KINDS``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import constants as JC
from mpi4torch_tpu import csched as jcs
from mpi4torch_tpu._compat import shard_map
from mpi4torch_tpu_torch import constants as C
from mpi4torch_tpu_torch import csched as pcs
from mpi4torch_tpu_torch import runtime
from mpi4torch_tpu_torch.compress import get_codec
from mpi4torch_tpu_torch.compress import spmd as cspmd
from mpi4torch_tpu_torch.ops import eager as peager
from mpi4torch_tpu_torch.ops import spmd as pspmd

ALGOS = ("ring", "rhd", "tree", "hier", "bidir", "torus")
Q8_ALGOS = ("ring", "bidir", "torus")
CODECS = ("q8", "q8_ef", "q8_ef_hop")
WORLDS = (1, 3, 6, 8)
OPS = (C.MPI_SUM, C.MPI_MAX, C.MPI_PROD)
# Below and above the default gather threshold (4 MiB gathered at
# itemsize 4); a one-element payload keeps one multipath channel.
SIZES = (1, 64, 1 << 20)

pcomm = P.COMM_WORLD
jcomm = mpi.COMM_WORLD



def _defaults(cfg):
    return {
        "ordered_fold_gather_max_bytes":
            cfg.DEFAULT_ORDERED_FOLD_GATHER_MAX_BYTES,
        "ordered_ring_chunk_bytes": cfg.DEFAULT_ORDERED_RING_CHUNK_BYTES,
        "bcast_tree_max_bytes": cfg.DEFAULT_BCAST_TREE_MAX_BYTES,
        "phase_pipelined_ring": True, "hier_group_size": None,
        "tier_stack": None}


def _set_both(**kw):
    for cfg in (P.config, mpi.config):
        for k, v in kw.items():
            getattr(cfg, f"set_{k}")(v)


@pytest.fixture(autouse=True)
def _reset_knobs():
    yield
    _reset_both()
    P.config.set_quant_hop_impl("auto")


def _build(cs, fn, *args, **kw):
    """``("ok", program)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", getattr(cs, fn)(*args, **kw))
    except (mpi.CommError, P.CommError, NotImplementedError,
            ValueError) as e:
        return ("raise", type(e).__name__, str(e))


def _same_program(p, j, what):
    """Port and JAX programs are one program: the same JSON, digest and
    transpose."""
    assert json.dumps(p.to_json(), sort_keys=True, default=list) \
        == json.dumps(j.to_json(), sort_keys=True, default=list), what
    assert p.to_json() == j.to_json(), what
    assert p.digest() == j.digest(), what
    assert p.nsteps == j.nsteps, what
    assert pcs.transpose(p).to_json() == jcs.transpose(j).to_json(), what
    assert pcs.transpose(p).digest() == jcs.transpose(j).digest(), what


def _same_outcome(pb, jb, what):
    """The same program, or the same raise.  The constructors' own messages
    are the JAX package's text; those of the helpers they delegate to
    (``combine2``'s MINLOC/MAXLOC refusal, ``resolve_hier_group``'s
    factorization rule) keep the port's wording, so there the type and
    the subject are held."""
    assert pb[0] == jb[0], (what, pb, jb)
    if pb[0] == "ok":
        _same_program(pb[1], jb[1], what)
        return
    assert pb[1] == jb[1], (what, pb, jb)
    if pb[2] == jb[2]:
        return
    if pb[1] == "NotImplementedError":
        assert any(m in pb[2] and m in jb[2]
                   for m in ("MPI_MINLOC", "MPI_MAXLOC")), (what, pb, jb)
    else:
        assert "factorization" in pb[2] and "factorization" in jb[2], \
            (what, pb, jb)


def _allreduce_cases(n):
    for op in OPS + (C.MPI_MINLOC,):
        for det in (False, True):
            for nelems in SIZES:
                yield op, det, nelems


def _all_programs(n, det=None):
    """Every allreduce program of every algorithm on ``n`` ranks, in both
    packages: ``[(what, port, jax)]``, builds that raise left out."""
    out = []
    for algo in ALGOS:
        for op in OPS:
            for d in ((False, True) if det is None else (det,)):
                kw = dict(deterministic=d, nelems=64, itemsize=4)
                pb = _build(pcs, "allreduce_program", algo, n, op, **kw)
                jb = _build(jcs, "allreduce_program", algo, n, op, **kw)
                if pb[0] == "ok":
                    out.append(((algo, n, op, d), pb[1], jb[1]))
    return out


class TestPrograms:
    @pytest.mark.parametrize("n", WORLDS)
    @pytest.mark.parametrize("algo", ALGOS)
    def test_allreduce_program_equals_jax(self, algo, n):
        for op, det, nelems in _allreduce_cases(n):
            kw = dict(deterministic=det, nelems=nelems, itemsize=4)
            _same_outcome(
                _build(pcs, "allreduce_program", algo, n, op, **kw),
                _build(jcs, "allreduce_program", algo, n, op, **kw),
                (algo, n, op, det, nelems))

    @pytest.mark.parametrize("n", WORLDS)
    def test_bcast_reduce_programs_equal_jax(self, n):
        for algo in (None, "ring", "tree"):
            for root in sorted({0, n - 1}):
                for nbytes in (256, 1 << 20):
                    _same_outcome(
                        _build(pcs, "bcast_program", algo, n, root,
                               nbytes=nbytes),
                        _build(jcs, "bcast_program", algo, n, root,
                               nbytes=nbytes), ("bcast", algo, root))
                for op in OPS:
                    for det in (False, True):
                        for nelems in SIZES:
                            kw = dict(deterministic=det, nelems=nelems,
                                      itemsize=4)
                            _same_outcome(
                                _build(pcs, "reduce_program", algo, n, op,
                                       root, **kw),
                                _build(jcs, "reduce_program", algo, n, op,
                                       root, **kw),
                                ("reduce", algo, root, op, det, nelems))

    @pytest.mark.parametrize("n", (2, 3, 4, 8))
    @pytest.mark.parametrize("algo", Q8_ALGOS)
    def test_q8_programs_equal_jax(self, algo, n):
        for codec in CODECS:
            for reverse in (False, True):
                _same_outcome(
                    _build(pcs, "q8_allreduce_program", algo, n, codec, 256,
                           reverse=reverse),
                    _build(jcs, "q8_allreduce_program", algo, n, codec, 256,
                           reverse=reverse), (algo, n, codec, reverse))

    @pytest.mark.parametrize("stack", [(2, 2, 2), (2, 4), (4, 2)])
    def test_tier_stack_programs_equal_jax(self, stack):
        _set_both(tier_stack=stack)
        for det in (False, True):
            for algo in ("hier", "torus"):
                kw = dict(deterministic=det, nelems=64, itemsize=4)
                _same_outcome(
                    _build(pcs, "allreduce_program", algo, 8, C.MPI_SUM,
                           **kw),
                    _build(jcs, "allreduce_program", algo, 8, C.MPI_SUM,
                           **kw), (stack, algo, det))
        prog = pcs.allreduce_program("hier", 8, C.MPI_SUM,
                                     deterministic=True, nelems=64,
                                     itemsize=4)
        if len(stack) > 2:
            assert [s.tier for s in prog.steps()] == [0, 1, 2]
        # A stack that does not factor the world raises in both.
        _same_outcome(
            _build(pcs, "allreduce_program", "hier", 6, C.MPI_SUM,
                   deterministic=True, nelems=8, itemsize=4),
            _build(jcs, "allreduce_program", "hier", 6, C.MPI_SUM,
                   deterministic=True, nelems=8, itemsize=4), "6 ranks")

    def test_knobs_change_programs_as_in_jax(self):
        for knobs in ({"ordered_fold_gather_max_bytes": 0},
                      {"hier_group_size": 4},
                      {"bcast_tree_max_bytes": 1 << 30}):
            _set_both(**knobs)
            for algo in ALGOS:
                for det in (False, True):
                    kw = dict(deterministic=det, nelems=64, itemsize=4)
                    _same_outcome(
                        _build(pcs, "allreduce_program", algo, 8, 3, **kw),
                        _build(jcs, "allreduce_program", algo, 8, 3, **kw),
                        (knobs, algo, det))
            _same_outcome(_build(pcs, "bcast_program", None, 8, 1,
                                 nbytes=1 << 20),
                          _build(jcs, "bcast_program", None, 8, 1,
                                 nbytes=1 << 20), knobs)
            _reset_both()

    def test_raises_where_jax_raises(self):
        with pytest.raises(P.CommError, match="power-of-two"):
            pcs.allreduce_program("rhd", 6, C.MPI_SUM, deterministic=False,
                                  nelems=8, itemsize=4)
        with pytest.raises(NotImplementedError, match="MPI_MINLOC"):
            pcs.allreduce_program("bidir", 8, C.MPI_MINLOC,
                                  deterministic=False, nelems=8,
                                  itemsize=4)
        with pytest.raises(P.CommError, match="no IR program"):
            pcs.allreduce_program("nope", 8, C.MPI_SUM,
                                  deterministic=False, nelems=8,
                                  itemsize=4)
        with pytest.raises(P.CommError, match="not installed"):
            pcs.allreduce_program("synth:0123456789", 8, C.MPI_SUM,
                                  deterministic=True, nelems=8, itemsize=4)
        for name in ALGOS + ("synth:ab", "nope", "auto"):
            assert pcs.has_program(name) == jcs.has_program(name)
        assert pcs.PROGRAM_ALGORITHMS == jcs.PROGRAM_ALGORITHMS
        assert pcs.NATIVE_EXEMPT == jcs.NATIVE_EXEMPT
        assert pcs.STEP_KINDS == jcs.STEP_KINDS

    def test_program_cache_follows_the_knobs(self):
        from mpi4torch_tpu_torch.csched import programs

        def build():
            return programs.cached(pcs.allreduce_program, "ring", 8,
                                   C.MPI_SUM, deterministic=True,
                                   nelems=1 << 16, itemsize=4)

        a = build()
        assert build() is a
        assert a.steps()[0].kind == "level_fold"
        P.config.set_ordered_fold_gather_max_bytes(0)
        b = build()
        assert b.steps()[0].kind == "ring_fold"
        P.config.set_hier_group_size(2)
        h = programs.cached(pcs.allreduce_program, "hier", 8, C.MPI_SUM,
                            deterministic=False, nelems=64, itemsize=4)
        assert h.steps()[0].params[0] == 2
        P.config.set_hier_group_size(4)
        h4 = programs.cached(pcs.allreduce_program, "hier", 8, C.MPI_SUM,
                             deterministic=False, nelems=64, itemsize=4)
        assert h4.steps()[0].params[0] == 4


def test_program_cache_under_concurrent_rank_threads():
    # The call-site cache is shared by every rank thread: built from many
    # threads at once (a short switch interval, more threads than cores),
    # every lookup returns the program the constructor gives for its
    # arguments.
    import sys
    import threading

    from mpi4torch_tpu_torch.csched import programs

    args = [(algo, n, det, nelems) for algo in ("ring", "bidir", "torus")
            for n in (4, 8) for det in (False, True)
            for nelems in (1, 64, 1 << 20)]
    want = {a: pcs.allreduce_program(a[0], a[1], C.MPI_SUM,
                                     deterministic=a[2], nelems=a[3],
                                     itemsize=4) for a in args}
    bad = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for i in rng.integers(0, len(args), 300):
            a = args[i]
            got = programs.cached(pcs.allreduce_program, a[0], a[1],
                                  C.MPI_SUM, deterministic=a[2],
                                  nelems=a[3], itemsize=4)
            if got != want[a]:
                bad.append(a)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad


def _reset_both():
    for cfg in (P.config, mpi.config):
        for k, v in _defaults(cfg).items():
            getattr(cfg, f"set_{k}")(v)
    for cfg in (P.config, mpi.config):
        cfg.set_chain_unroll_max(cfg.DEFAULT_CHAIN_UNROLL_MAX)


class TestTransposition:
    @pytest.mark.parametrize("algo", ALGOS)
    def test_vjp_census_agreement(self, algo):
        assert pcs.declared_vjp_census(algo, 8) == "self"
        assert pcs.declared_vjp_census(algo, 8) \
            == jcs.declared_vjp_census(algo, 8)

    def test_bidir_transpose_flips_directions(self):
        prog = pcs.allreduce_program("bidir", 8, C.MPI_SUM,
                                     deterministic=False, nelems=64,
                                     itemsize=4)
        back = pcs.transpose(prog)
        assert [s.params[0] for s in prog.steps()] == [1, -1]
        assert [s.params[0] for s in back.steps()] == [-1, 1]
        assert pcs.transpose(back) == prog

    def test_tree_reduce_is_transposed_bcast(self):
        bcast = pcs.bcast_program("tree", 8, 1, nbytes=256)
        assert pcs.transpose(bcast) == pcs.reduce_program(
            "tree", 8, C.MPI_SUM, 1, deterministic=False, nelems=64,
            itemsize=4)
        ring = pcs.bcast_program("ring", 8, 0, nbytes=1 << 20)
        red = pcs.transpose(ring)
        assert [s.kind for s in red.steps()] == ["native_allreduce",
                                                 "mask_root"]
        assert pcs.transpose(red).steps() == ring.steps()

    def test_every_step_kind_has_dispatch_coverage(self):
        kinds = set(pcs.STEP_KINDS)
        assert set(pcs.lowering_covers()) == kinds
        assert set(pcs.interpreter_covers()) == kinds
        assert set(pcs.transposition_covers()) == kinds
        assert set(pcs.census_covers()) == kinds

    def test_registry_guard_clean(self):
        # The port's stand-in for analyze.registry.csched_problems: every
        # registered algorithm has a program or is exempt, and the four
        # dispatch tables cover the grammar.
        from mpi4torch_tpu_torch.tune import registry

        names = set(registry._REGISTRY)
        assert names <= set(pcs.PROGRAM_ALGORITHMS) | set(pcs.NATIVE_EXEMPT)
        for covers in (pcs.lowering_covers, pcs.interpreter_covers,
                       pcs.transposition_covers, pcs.census_covers):
            assert tuple(covers()) == pcs.STEP_KINDS


class TestCensus:
    @pytest.mark.parametrize("knobs", [
        {}, {"chain_unroll_max": 4}, {"phase_pipelined_ring": False},
        {"tier_stack": (2, 2, 2)}, {"ordered_fold_gather_max_bytes": 0,
                                    "ordered_ring_chunk_bytes": 64}])
    def test_census_equals_jax(self, knobs):
        knobs = dict(knobs)
        # The chain-unroll ceiling is a config knob on both sides, with
        # one default.
        default = P.config.DEFAULT_CHAIN_UNROLL_MAX
        assert default == mpi.config.DEFAULT_CHAIN_UNROLL_MAX
        unroll = knobs.pop("chain_unroll_max", default)
        _set_both(chain_unroll_max=unroll, **knobs)
        for n in (3, 8):
            for what, p, j in _all_programs(n):
                for nelems in (1, 64, 1000):
                    assert pcs.program_census(p, nelems, 4) \
                        == jcs.program_census(j, nelems, 4), what
                for tiers in ((n,), (2, 4), (4, 2), (2, 2, 2)):
                    if int(np.prod(tiers)) != n:
                        continue
                    pt = pcs.program_tier_census(p, 1000, 4, tiers)
                    assert pt == jcs.program_tier_census(j, 1000, 4,
                                                         tiers), what
                    assert pcs.weighted_cost(pt, (1.0,) * len(tiers)) \
                        == jcs.weighted_cost(pt, (1.0,) * len(tiers))
        for algo in Q8_ALGOS:
            for codec in CODECS:
                p = pcs.q8_allreduce_program(algo, 8, codec, 256)
                j = jcs.q8_allreduce_program(algo, 8, codec, 256)
                assert pcs.program_census(p, 4096, 4) \
                    == jcs.program_census(j, 4096, 4)
        assert pcs.program_census(None, 8, 4) == jcs.program_census(
            None, 8, 4)

    def test_q8_level_fold_and_tier_attribution(self):
        inner, outer, _ = pcs.programs._hier_groups(8, 4)
        steps = (pcs.Step("q8_level_fold", (inner, 4), codec="q8"),
                 pcs.Step("q8_level_fold", (outer, 2), codec="q8"))
        jsteps = (jcs.Step("q8_level_fold", (inner, 4), codec="q8"),
                  jcs.Step("q8_level_fold", (outer, 2), codec="q8"))
        p = pcs.Program("allreduce", "hier", 8, (pcs.Phase("seq", steps),))
        j = jcs.Program("allreduce", "hier", 8, (jcs.Phase("seq", jsteps),))
        assert p.digest() == j.digest()
        for nelems in (1, 300, 4096):
            assert pcs.program_census(p, nelems, 4) == jcs.program_census(
                j, nelems, 4)
            assert pcs.program_tier_census(p, nelems, 4, (4, 2)) \
                == jcs.program_tier_census(j, nelems, 4, (4, 2))
        for grp in ((0, 1), (0, 4), (1, 5, 3), (2, 6)):
            for tiers in ((2, 4), (4, 2), (2, 2, 2)):
                assert pcs.tier_of_group(grp, tiers) == jcs.tier_of_group(
                    grp, tiers)
        assert pcs.tier_of_groups(None, (2, 4)) == 1
        assert pcs.weighted_cost([10, 20], (1.0, 0.5)) == \
            jcs.weighted_cost([10, 20], (1.0, 0.5))
        with pytest.raises(P.CommError, match="tier_bandwidths"):
            pcs.weighted_cost([1, 2], (1.0,))

    def test_wire_accounting_matches_registry_formulas(self):
        s = 1 << 14
        ring = pcs.program_census(pcs.allreduce_program(
            "ring", 8, C.MPI_SUM, deterministic=False, nelems=s // 4,
            itemsize=4), s // 4, 4)
        assert ring["wire_bytes_per_rank"] == int(2 * s * 7 / 8)
        det = pcs.program_census(pcs.allreduce_program(
            "ring", 8, C.MPI_SUM, deterministic=True, nelems=s // 4,
            itemsize=4), s // 4, 4)
        assert det["wire_bytes_per_rank"] == 7 * s


def _f32_values(n, numel, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(numel).astype(np.float32) for _ in range(n)]


def _bits(t):
    return np.asarray(t).view(np.uint32) if np.asarray(t).dtype \
        == np.float32 else np.asarray(t).view(np.uint8)


class TestInterpreter:
    @pytest.mark.parametrize("n", [3, 8])
    @pytest.mark.parametrize("algo", ALGOS)
    def test_interpreter_bitwise_jax_and_rendezvous_fold(self, algo, n):
        vals = _f32_values(n, 41, seed=3 + n)
        pv = [torch.from_numpy(v) for v in vals]
        jv = [jnp.asarray(v) for v in vals]
        applicable = algo in _algos_for(n)
        checked = 0
        for op in OPS:
            for det in (False, True):
                kw = dict(deterministic=det, nelems=41, itemsize=4)
                pb = _build(pcs, "allreduce_program", algo, n, op, **kw)
                if pb[0] != "ok":
                    continue
                jprog = jcs.allreduce_program(algo, n, op, **kw)
                got = pcs.interpret_allreduce(pb[1], op, pv)
                want = jcs.interpret_allreduce(jprog, op, jv)
                assert np.array_equal(_bits(got.numpy()), _bits(want)), \
                    (op, det)
                if det:
                    _, fold = peager._rendezvous_fold(n, algo)
                    assert torch.equal(got, fold(op, pv)), (op, det)
                checked += 1
        assert checked == (2 * len(OPS) if applicable else 0)

    def test_interpreter_matches_mode_a_deterministic(self):
        stack = np.random.default_rng(4).standard_normal(
            (8, 33)).astype(np.float32)

        def body(v):
            return pcomm.Allreduce(v[pcomm.rank], P.MPI_SUM,
                                   algorithm="hier")

        with P.config.deterministic_mode(True):
            outs = P.run_spmd(body, nranks=8, device="cpu")(
                torch.from_numpy(stack))
        prog = pcs.allreduce_program("hier", 8, C.MPI_SUM,
                                     deterministic=True, nelems=33,
                                     itemsize=4)
        oracle = pcs.interpret_allreduce(prog, C.MPI_SUM,
                                         list(torch.from_numpy(stack)))
        assert torch.equal(outs, oracle[None].expand(8, 33))

    def test_tier_stack_chain_fold(self):
        # A 3-tier stack: Mode A's deterministic hier lowers the tier
        # chain, Mode B folds through the interpreter's level_fold path,
        # and both equal JAX's Mode B.
        _set_both(tier_stack=(2, 2, 2))
        x = np.random.default_rng(8).standard_normal((8, 257))
        prog = pcs.allreduce_program("hier", 8, C.MPI_SUM,
                                     deterministic=True, nelems=257,
                                     itemsize=8)
        oracle = pcs.interpret_allreduce(prog, C.MPI_SUM,
                                         list(torch.from_numpy(x)))
        two = C.reduce_grouped(C.MPI_SUM, list(torch.from_numpy(x)), 2)
        assert not torch.equal(oracle, two)   # the chain is its own fold
        with P.config.deterministic_mode(True):
            a = P.run_spmd(lambda v: pcomm.Allreduce(
                v[pcomm.rank], P.MPI_SUM, algorithm="hier"), nranks=8,
                device="cpu")(torch.from_numpy(x))
        b = P.run_ranks(lambda r: pcomm.Allreduce(
            torch.from_numpy(x[r]), P.MPI_SUM, algorithm="hier"), 8,
            device="cpu")
        j = mpi.run_ranks(lambda: np.asarray(jcomm.Allreduce(
            jnp.asarray(x[jcomm.rank]), mpi.MPI_SUM, algorithm="hier")), 8)
        for r in range(8):
            assert torch.equal(a[r], oracle)
            assert torch.equal(b[r], oracle)
            assert np.array_equal(j[r], oracle.numpy())

    def test_q8_level_fold_bitwise_jax(self):
        inner, outer, _ = pcs.programs._hier_groups(8, 4)
        for groups, g in ((inner, 4), (None, 8)):
            p = pcs.Program("allreduce", "hier", 8, (pcs.Phase("seq", (
                pcs.Step("q8_level_fold", (groups, g), codec="q8"),)),))
            j = jcs.Program("allreduce", "hier", 8, (jcs.Phase("seq", (
                jcs.Step("q8_level_fold", (groups, g), codec="q8"),)),))
            vals = _f32_values(8, 300, seed=5)
            got = pcs.interpret_allreduce(
                p, C.MPI_SUM, [torch.from_numpy(v) for v in vals])
            want = jcs.interpret_allreduce(
                j, C.MPI_SUM, [jnp.asarray(v) for v in vals])
            assert np.array_equal(_bits(got.numpy()), _bits(want))

    def test_misuse(self):
        prog = pcs.allreduce_program("ring", 4, C.MPI_SUM,
                                     deterministic=True, nelems=4,
                                     itemsize=4)
        with pytest.raises(P.CommError, match="built for 4 ranks"):
            pcs.interpret_allreduce(prog, C.MPI_SUM, [torch.ones(4)] * 3)
        with pytest.raises(ValueError, match="at least one"):
            pcs.interpret_allreduce(prog, C.MPI_SUM, [])
        one = torch.ones(3)
        assert pcs.interpret_allreduce(prog, C.MPI_SUM, [one]) is one


class TestGroupedFoldDedupe:
    """``reduce_grouped``/``reduce_torus`` run through the interpreter's
    level_fold path: bitwise JAX's and copies of the port's earlier
    folds, on (3,), (8,) and the (2, 4) grid."""

    @staticmethod
    def _legacy_grouped(op, values, group):
        vals = list(values)
        partials = [C.reduce_ordered(op, vals[b:b + group])
                    for b in range(0, len(vals), group)]
        return C.reduce_ordered(op, partials)

    @classmethod
    def _legacy_torus(cls, op, values, inner):
        vals = list(values)
        n = len(vals)
        outer = n // inner
        shape = vals[0].shape
        flats = [v.reshape(-1) for v in vals]
        total = flats[0].numel()
        m = C.multipath_split(total)
        h0 = cls._legacy_grouped(op, [f[:m] for f in flats], inner)
        if m >= total:
            return h0.reshape(shape)
        perm = [o * inner + i for i in range(inner) for o in range(outer)]
        h1 = cls._legacy_grouped(op, [flats[p][m:] for p in perm], outer)
        return torch.cat([h0, h1]).reshape(shape)

    @pytest.mark.parametrize("n,group", [(3, 3), (8, 2), (8, 4)])
    @pytest.mark.parametrize("op", [C.MPI_SUM, C.MPI_PROD])
    def test_reduce_grouped_bitwise(self, n, group, op):
        vals = _f32_values(n, 29, seed=n * 10 + group)
        pv = [torch.from_numpy(v) for v in vals]
        got = C.reduce_grouped(op, pv, group)
        assert torch.equal(got, self._legacy_grouped(op, pv, group))
        want = JC.reduce_grouped(op, [jnp.asarray(v) for v in vals], group)
        assert np.array_equal(_bits(got.numpy()), _bits(want))

    @pytest.mark.parametrize("n,inner", [(3, 3), (8, 2), (8, 4)])
    @pytest.mark.parametrize("numel", [1, 37])
    def test_reduce_torus_bitwise(self, n, inner, numel):
        vals = _f32_values(n, numel, seed=n * 100 + inner)
        pv = [torch.from_numpy(v) for v in vals]
        got = C.reduce_torus(C.MPI_SUM, pv, inner)
        assert torch.equal(got, self._legacy_torus(C.MPI_SUM, pv, inner))
        want = JC.reduce_torus(C.MPI_SUM, [jnp.asarray(v) for v in vals],
                               inner)
        assert np.array_equal(_bits(got.numpy()), _bits(want))

    def test_bad_group_raises(self):
        with pytest.raises(ValueError, match="divide"):
            C.reduce_grouped(C.MPI_SUM, [torch.ones(2)] * 6, 4)
        with pytest.raises(ValueError, match="divide"):
            C.reduce_torus(C.MPI_SUM, [torch.ones(2)] * 6, 4)


class TestCodecRewrite:
    def test_q8_steps_carry_codec_annotation(self):
        prog = pcs.q8_allreduce_program("bidir", 8, "q8_ef_hop", 256)
        assert prog.codec == "q8_ef_hop"
        assert all(s.kind == "q8_ring_channel" and s.codec == "q8_ef_hop"
                   for s in prog.steps())
        rev = pcs.q8_allreduce_program("bidir", 8, "q8_ef_hop", 256,
                                       reverse=True)
        assert rev == pcs.transpose(prog)
        torus = pcs.q8_allreduce_program("torus", 8, "q8", 256)
        assert torus.steps()[1].params[0] == ("torus_col", 2)

    @pytest.mark.parametrize("algo,codec", [
        ("bidir", "q8_ef_hop"), ("ring", "q8_ef"), ("torus", "q8"),
        ("torus", "q8_ef_hop")])
    def test_q8_interpreter_matches_hop_oracle(self, algo, codec):
        c = get_codec(codec)
        base = c.base()
        vals = _f32_values(8, 300, seed=9)
        pv = [torch.from_numpy(v) for v in vals]
        prog = pcs.q8_allreduce_program(algo, 8, codec, base.block)
        got = pcs.interpret_allreduce(prog, C.MPI_SUM, pv)
        inner = 2 if algo == "torus" else None
        ref = C.reduce_q8_hop(pv, block=base.block, algorithm=algo,
                              inner=inner, stochastic=base.stochastic,
                              hop_ef=base.hop_ef, ef_rounds=c.ef_rounds)
        assert torch.equal(got, ref)
        want = jcs.interpret_allreduce(
            jcs.q8_allreduce_program(algo, 8, codec, base.block),
            C.MPI_SUM, [jnp.asarray(v) for v in vals])
        assert np.array_equal(_bits(got.numpy()), _bits(want))


class TestSerialization:
    @pytest.mark.parametrize("algo", ALGOS)
    def test_json_round_trip(self, algo):
        for det in (False, True):
            prog = pcs.allreduce_program(algo, 8, C.MPI_SUM,
                                         deterministic=det, nelems=64,
                                         itemsize=4)
            back = pcs.Program.from_json(json.loads(json.dumps(
                prog.to_json())))
            assert back == prog and back.digest() == prog.digest()
            # JAX's JSON reads back as the same port program.
            jprog = jcs.allreduce_program(algo, 8, C.MPI_SUM,
                                          deterministic=det, nelems=64,
                                          itemsize=4)
            assert pcs.Program.from_json(json.loads(json.dumps(
                jprog.to_json()))) == prog

    def test_unknown_kinds_rejected(self):
        with pytest.raises(P.CommError, match="closed"):
            pcs.Step("nope")
        with pytest.raises(P.CommError, match="phase kind"):
            pcs.Phase("nope")


# ---------------------------------------------------------------------------
# Mode A: the lowering against the hand-written forms and JAX's Mode A
# ---------------------------------------------------------------------------


class _HandWritten(torch.autograd.Function):
    """The hand-written Allreduce dispatch, forward and adjoint (``bidir``
    with its halves swapped)."""

    @staticmethod
    def forward(fctx, x, ctx, op, algo):
        fctx.ctx, fctx.algo = ctx, algo
        return pspmd._handwritten_allreduce_value(ctx, x, op, algo)

    @staticmethod
    def backward(fctx, g):
        return (pspmd._handwritten_allreduce_value(
            fctx.ctx, g.contiguous(), C.MPI_SUM, fctx.algo, reverse=True),
            None, None, None)


def _legacy_bcast(ctx, x, root, algorithm):
    if ctx.size == 1:
        return x
    nbytes = x.numel() * x.element_size()
    if algorithm == "tree" or (algorithm != "ring" and nbytes
                               <= P.config.bcast_tree_max_bytes()):
        return pspmd._tree_bcast_value(ctx, x, root)
    return pspmd._psum(ctx, pspmd._mask_to_root(ctx, x, root), C.MPI_SUM)


def _legacy_reduce(ctx, x, op, root, algorithm):
    if algorithm == "tree":
        return pspmd._tree_reduce_value(ctx, x, op, root)
    return pspmd._mask_to_root(
        ctx, pspmd._handwritten_allreduce_value(ctx, x, op, "ring"), root)


class _HandWrittenRooted(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, kind, op, root, algo):
        fctx.args = (ctx, kind, root, algo)
        if kind == "bcast":
            return _legacy_bcast(ctx, x, root, algo)
        return _legacy_reduce(ctx, x, op, root, algo)

    @staticmethod
    def backward(fctx, g):
        ctx, kind, root, algo = fctx.args
        g = g.contiguous()
        out = (_legacy_reduce(ctx, g, C.MPI_SUM, root, algo)
               if kind == "bcast" else _legacy_bcast(ctx, g, root, algo))
        return out, None, None, None, None, None


class _Exchanges:
    """Rank 0's ``World.exchange`` signatures, in order, while entered."""

    def __enter__(self):
        self.seq = []
        self._saved = runtime.World.exchange
        saved, seq = self._saved, self.seq

        def exchange(w, rank, signature, *a, **kw):
            if rank == 0:
                seq.append(signature)
            return saved(w, rank, signature, *a, **kw)

        runtime.World.exchange = exchange
        return self

    def __exit__(self, *exc):
        runtime.World.exchange = self._saved
        return False


def _value_grad_exchanges(fn, x, w, **kw):
    """``(out, grad of vdot(out, w) from outside, forward exchanges,
    backward exchanges)`` of ``run_spmd(fn)`` on ``x``."""
    f = P.run_spmd(fn, device="cpu", **kw)
    xt = torch.from_numpy(x).requires_grad_()
    with _Exchanges() as fwd:
        out = f(xt)
    if w is None:
        return out.detach(), None, fwd.seq, None
    with _Exchanges() as bwd:
        (g,) = torch.autograd.grad(
            torch.vdot(out.reshape(-1), torch.from_numpy(w).reshape(-1)),
            xt)
    return out.detach(), g, fwd.seq, bwd.seq


def _assert_same_run(a, b, what):
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)), what
    if a[1] is not None:
        assert torch.equal(a[1].view(torch.int32),
                           b[1].view(torch.int32)), what
    assert a[2] == b[2], what
    assert a[3] == b[3], what


def _algos_for(n):
    return [a for a in ALGOS
            if not (a == "rhd" and n & (n - 1))
            and not (a in ("hier", "torus")
                     and all(n % g for g in range(2, n)))]


class TestModeALowering:
    @pytest.mark.parametrize("n", [3, 8])
    @pytest.mark.parametrize("det", [False, True])
    def test_allreduce_lowered_equals_hand_written(self, n, det):
        x = np.random.default_rng(n).standard_normal(
            (n, 131)).astype(np.float32)
        w = np.random.default_rng(n + 1).standard_normal(
            (n, 131)).astype(np.float32)
        for algo in _algos_for(n):
            for op in OPS:
                def ir(v, op=op, algo=algo):
                    return pcomm.Allreduce(v[pcomm.rank], op, algorithm=algo)

                def hw(v, op=op, algo=algo):
                    return _HandWritten.apply(
                        v[pcomm.rank], pspmd.current_spmd_context(), op,
                        algo)

                ww = w if op == C.MPI_SUM else None
                with P.config.deterministic_mode(det):
                    a = _value_grad_exchanges(ir, x, ww, nranks=n)
                    b = _value_grad_exchanges(hw, x, ww, nranks=n)
                _assert_same_run(a, b, (algo, op, det))
                assert a[2], "the lowering issued no exchange"

    def test_ring_fold_and_knobs_lowered_equal_hand_written(self):
        x = np.random.default_rng(2).standard_normal(
            (8, 515)).astype(np.float32)
        w = np.random.default_rng(3).standard_normal(
            (8, 515)).astype(np.float32)
        for pipelined in (True, False):
            P.config.set_ordered_fold_gather_max_bytes(0)
            P.config.set_ordered_ring_chunk_bytes(256)
            P.config.set_phase_pipelined_ring(pipelined)
            for algo in ("ring", "bidir"):
                with P.config.deterministic_mode(True):
                    a = _value_grad_exchanges(
                        lambda v: pcomm.Allreduce(v[pcomm.rank], P.MPI_SUM,
                                                  algorithm=algo), x, w,
                        nranks=8)
                    b = _value_grad_exchanges(
                        lambda v: _HandWritten.apply(
                            v[pcomm.rank], pspmd.current_spmd_context(),
                            C.MPI_SUM, algo), x, w, nranks=8)
                _assert_same_run(a, b, (algo, pipelined))
        P.config.set_hier_group_size(2)
        P.config.set_ordered_fold_gather_max_bytes(
            P.config.DEFAULT_ORDERED_FOLD_GATHER_MAX_BYTES)
        for algo in ("hier", "torus"):
            a = _value_grad_exchanges(
                lambda v: pcomm.Allreduce(v[pcomm.rank], P.MPI_SUM,
                                          algorithm=algo), x, w, nranks=8)
            b = _value_grad_exchanges(
                lambda v: _HandWritten.apply(
                    v[pcomm.rank], pspmd.current_spmd_context(), C.MPI_SUM,
                    algo), x, w, nranks=8)
            _assert_same_run(a, b, algo)

    @pytest.mark.parametrize("n", [3, 8])
    def test_bcast_reduce_lowered_equal_hand_written(self, n):
        x = np.random.default_rng(20 + n).standard_normal(
            (n, 96)).astype(np.float32)
        w = np.random.default_rng(21 + n).standard_normal(
            (n, 96)).astype(np.float32)
        for root in range(n):
            for algo in (None, "ring", "tree"):
                for kind in ("bcast", "reduce"):
                    for op in ((C.MPI_SUM,) if kind == "bcast" else OPS):
                        for det in (False, True):
                            def ir(v, kind=kind, op=op, root=root,
                                   algo=algo):
                                t = v[pcomm.rank]
                                if kind == "bcast":
                                    return pcomm.Bcast_(t, root,
                                                        algorithm=algo)
                                return pcomm.Reduce_(t, op, root,
                                                     algorithm=algo)

                            def hw(v, kind=kind, op=op, root=root,
                                   algo=algo):
                                return _HandWrittenRooted.apply(
                                    v[pcomm.rank],
                                    pspmd.current_spmd_context(), kind, op,
                                    root, algo)

                            ww = w if op == C.MPI_SUM else None
                            with P.config.deterministic_mode(det):
                                a = _value_grad_exchanges(ir, x, ww,
                                                          nranks=n)
                                b = _value_grad_exchanges(hw, x, ww,
                                                          nranks=n)
                            _assert_same_run(a, b, (kind, root, algo, op))

    @pytest.mark.parametrize("axis", ["dp", "tp"])
    def test_mesh_axis_lowered_equals_hand_written(self, axis):
        mesh = P.device_mesh({"dp": 2, "tp": 4},
                             devices=[torch.device("cpu")] * 8)
        dp, tp = P.comm_from_mesh(mesh, "dp"), P.comm_from_mesh(mesh, "tp")
        c = dp if axis == "dp" else tp
        x = np.random.default_rng(30).standard_normal(
            (8, 77)).astype(np.float32)
        w = np.random.default_rng(31).standard_normal(
            (8, 77)).astype(np.float32)
        for algo in _algos_for(c.size):
            for det in (False, True):
                def ir(v, algo=algo):
                    return c.Allreduce(v[dp.rank * 4 + tp.rank], P.MPI_SUM,
                                       algorithm=algo)

                def hw(v, algo=algo):
                    ctx = pspmd._current_region().ctx(axis)
                    return _HandWritten.apply(v[dp.rank * 4 + tp.rank], ctx,
                                              C.MPI_SUM, algo)

                with P.config.deterministic_mode(det):
                    a = _value_grad_exchanges(ir, x, w, mesh=mesh,
                                              axis_name="dp")
                    b = _value_grad_exchanges(hw, x, w, mesh=mesh,
                                              axis_name="dp")
                _assert_same_run(a, b, (axis, algo, det))


def _jax_mode_a(op_fn, x, w, n=None, mesh_shape=None):
    """JAX's Mode A of ``op_fn(row)`` on rank rows of ``x``: the stacked
    values and the gradient of ``vdot(out, w)``.  ``mesh_shape`` runs a
    (dp, tp) mesh through ``shard_map`` with the output stacked over both
    axes."""
    if mesh_shape is None:
        f = mpi.run_spmd(lambda v: op_fn(v, jax.lax.dynamic_index_in_dim(
            v, jnp.asarray(jcomm.rank + 0), 0, keepdims=False)), nranks=n)
    else:
        mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(mesh_shape),
                    ("dp", "tp"))

        def body(v):
            return jnp.expand_dims(op_fn(v, mesh), 0)

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=JP(),
                              out_specs=JP(("dp", "tp")), check_vma=False))
    out = np.asarray(f(jnp.asarray(x)))
    g = np.asarray(jax.grad(lambda v: jnp.vdot(f(v), jnp.asarray(w)))(
        jnp.asarray(x)))
    return out, g


class TestModeAvsJax:
    @pytest.mark.parametrize("n", [3, 8])
    def test_allreduce_bitwise_jax_mode_a(self, n):
        x = np.random.default_rng(40 + n).standard_normal(
            (n, 100)).astype(np.float32)
        w = np.random.default_rng(41 + n).standard_normal(
            (n, 100)).astype(np.float32)
        for algo in _algos_for(n):
            with mpi.config.deterministic_mode(True):
                jo, jg = _jax_mode_a(lambda v, row, a=algo: jcomm.Allreduce(
                    row, mpi.MPI_SUM, algorithm=a), x, w, n=n)
            with P.config.deterministic_mode(True):
                po, pg, _, _ = _value_grad_exchanges(
                    lambda v, a=algo: pcomm.Allreduce(
                        v[pcomm.rank], P.MPI_SUM, algorithm=a), x, w,
                    nranks=n)
            assert np.array_equal(_bits(po.numpy()), _bits(jo)), algo
            assert np.array_equal(_bits(pg.numpy()), _bits(jg)), algo

    def test_mesh_axes_bitwise_jax_mode_a(self):
        x = np.random.default_rng(50).standard_normal(
            (8, 64)).astype(np.float32)
        w = np.random.default_rng(51).standard_normal(
            (8, 64)).astype(np.float32)
        mesh = P.device_mesh({"dp": 2, "tp": 4},
                             devices=[torch.device("cpu")] * 8)
        dp, tp = P.comm_from_mesh(mesh, "dp"), P.comm_from_mesh(mesh, "tp")
        for axis, size in (("tp", 4), ("dp", 2)):
            for algo in _algos_for(size):
                def jop(v, jmesh, axis=axis, algo=algo):
                    jdp = mpi.comm_from_mesh(jmesh, "dp")
                    jtp = mpi.comm_from_mesh(jmesh, "tp")
                    row = jax.lax.dynamic_index_in_dim(
                        v, jnp.asarray(jdp.rank) * 4 + jnp.asarray(jtp.rank),
                        0, keepdims=False)
                    c = jdp if axis == "dp" else jtp
                    return c.Allreduce(row, mpi.MPI_SUM, algorithm=algo)

                with mpi.config.deterministic_mode(True):
                    jo, jg = _jax_mode_a(jop, x, w, mesh_shape=(2, 4))
                c = dp if axis == "dp" else tp
                with P.config.deterministic_mode(True):
                    po, pg, _, _ = _value_grad_exchanges(
                        lambda v, c=c, algo=algo: c.Allreduce(
                            v[dp.rank * 4 + tp.rank], P.MPI_SUM,
                            algorithm=algo), x, w, mesh=mesh,
                        axis_name="dp")
                assert np.array_equal(_bits(po.numpy()), _bits(jo)), \
                    (axis, algo)
                assert np.array_equal(_bits(pg.numpy()), _bits(jg)), \
                    (axis, algo)


class TestQ8Route:
    @pytest.mark.parametrize("algo", Q8_ALGOS)
    def test_lowered_equals_hand_composed(self, algo):
        # The IR route against compress/spmd._fused_allreduce_value:
        # values, gradients and exchanges, every codec; and its K1
        # entry-point calls (the plain hop on the CPU) equal in number.
        n = 4
        x = np.random.default_rng(60).standard_normal(
            (n, 1000)).astype(np.float32)
        w = np.random.default_rng(61).standard_normal(
            (n, 1000)).astype(np.float32)

        class _HandComposed(torch.autograd.Function):
            @staticmethod
            def forward(fctx, t, ctx, codec):
                fctx.ctx, fctx.codec = ctx, codec
                return cspmd._fused_allreduce_value(ctx, t, codec, algo,
                                                    False)

            @staticmethod
            def backward(fctx, g):
                return (cspmd._fused_allreduce_value(
                    fctx.ctx, g.contiguous(), fctx.codec, algo, True),
                    None, None)

        from mpi4torch_tpu_torch.ops import quant_kernels as qk

        calls = []
        real = qk.dequant_accum_requant

        def counting(*a, **kw):
            calls.append(a[0] is None)
            return real(*a, **kw)

        qk.dequant_accum_requant = counting
        try:
            for codec in CODECS:
                c = get_codec(codec)
                runs = []
                for fn in (
                        lambda v: pcomm.Allreduce(v[pcomm.rank], P.MPI_SUM,
                                                  compression=codec,
                                                  algorithm=algo),
                        lambda v: _HandComposed.apply(
                            v[pcomm.rank], pspmd.current_spmd_context(),
                            c)):
                    calls.clear()
                    runs.append(_value_grad_exchanges(fn, x, w, nranks=n)
                                + ((sum(calls), len(calls)),))
                _assert_same_run(runs[0][:4], runs[1][:4], (algo, codec))
                assert runs[0][4] == runs[1][4] and runs[0][4][1] > 0
        finally:
            qk.dequant_accum_requant = real

    @pytest.mark.parametrize("algo,codec", [
        ("ring", "q8"), ("bidir", "q8_ef"), ("torus", "q8_ef_hop")])
    def test_bitwise_jax_mode_a(self, algo, codec):
        n = 4
        x = np.random.default_rng(70).standard_normal(
            (n, 600)).astype(np.float32)
        w = np.random.default_rng(71).standard_normal(
            (n, 600)).astype(np.float32)
        jo, jg = _jax_mode_a(lambda v, row: jcomm.Allreduce(
            row, mpi.MPI_SUM, compression=codec, algorithm=algo), x, w, n=n)
        po, pg, _, _ = _value_grad_exchanges(
            lambda v: pcomm.Allreduce(v[pcomm.rank], P.MPI_SUM,
                                      compression=codec, algorithm=algo),
            x, w, nranks=n)
        assert np.array_equal(_bits(po.numpy()), _bits(jo))
        assert np.array_equal(_bits(pg.numpy()), _bits(jg))
