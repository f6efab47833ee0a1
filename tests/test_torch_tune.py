"""The port's algorithm selection and autotuner against the JAX package's.

Follows JAX ``tests/test_tune.py`` class by class, on the CPU, with the
same inputs in each package and each package's own temporary tune
cache:

* keys: ``make_key`` (every dimension, f32/f64/f16/bf16 as torch dtypes)
  and ``bucket_nbytes`` equal JAX's byte for byte;
* the selector: ``select_auto`` makes JAX's decision at every point of a
  grid of sizes, 3/4/8 ranks, no codec / q8 / bf16, deterministic or
  not, crossovers unset or set, and cache winners recorded the same way
  in both; ``resolve_request`` raises or resolves as JAX does;
* the facade: scope defaults degrade and explicit requests raise, on
  ``run_spmd`` and ``run_ranks`` alike; auto picks reach the wire;
* the cache: round trips, corrupt / truncated / wrong-version / stale
  files fall back to the defaults, concurrent saves union, an
  unwritable directory degrades, and a file written by either package
  loads in the other with the same winners;
* the CLI, the measurement (``autotune_allreduce``, its codec leg,
  ``ensure_tuned_allreduce``, min-of-k), the fused per-bucket picks and
  the knobs (``TestFusePerBucket``, ``TestConfigKnobs``), and serving's
  ``latency_report``.

* the census (``TestAlgorithmCensus``, ``TestCodecAlgorithmCensus``):
  each algorithm's and each (algorithm x codec) pair's recorded program
  (``analyze.lower``) parses to JAX's collective counts and permute
  widths, tables and dtypes, forward and with the gradient, and meets
  JAX's structural expectations (the int8 dual-ring rotations
  included).

The registry guard (``TestRegistryGuard``) is mirrored in
``tests/test_torch_analyze.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import tune as jtune
from mpi4torch_tpu.csched import synth as JS
from mpi4torch_tpu_torch import runtime
from mpi4torch_tpu_torch import tune as ptune
from mpi4torch_tpu_torch.csched import synth as PS
from mpi4torch_tpu_torch.tune import autotuner as PA

CPU = torch.device("cpu")
DTYPES = ((torch.float32, jnp.float32), (torch.float64, jnp.float64),
          (torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16))


def _reset():
    for cfg in (jmpi.config, P.config):
        cfg.set_latency_crossover_bytes(None)
        cfg.set_bandwidth_crossover_bytes(None)
        cfg.set_hier_group_size(None)
        cfg.set_default_algorithm(None)
        cfg.set_tier_stack(None)
        cfg.set_tier_bandwidths(None)
        cfg.set_serve_decode_buckets(2)
    jtune.clear()
    ptune.clear()
    JS.clear_installed()
    PS.clear_installed()


def _auto(**kw):
    """The port's selector on a float32 payload."""
    return ptune.select_auto(dtype=torch.float32, **kw)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Each package gets its own cache file and pristine knobs, and the
    test thread runs in a one-rank CPU world, so the port's keys carry
    the ``cpu`` platform as JAX's do on this host."""
    monkeypatch.setenv("MPI4TORCH_TPU_TUNE_CACHE",
                       str(tmp_path / "jax_cache.json"))
    monkeypatch.setenv(PA.CACHE_ENV, str(tmp_path / "torch_cache.json"))
    _reset()
    with runtime._bind_rank(runtime.RankContext(
            runtime.World(1, device=CPU), 0)):
        yield
    _reset()


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raise", type(e).__name__)


# --------------------------------------------------------------- keys


class TestKeys:
    @pytest.mark.parametrize("tdt, jdt", DTYPES)
    def test_make_key_equals_jax(self, tdt, jdt):
        for nbytes in (1, 3000, 4096, 1 << 20):
            for kw in ({}, {"codec": "q8"}, {"tiers": (2, 2, 2)},
                       {"codec": "synth", "tiers": (2, 4),
                        "transition": "warm"}):
                want = jtune.make_key("allreduce", jdt, nbytes, 8, **kw)
                assert ptune.make_key("allreduce", tdt, nbytes, 8,
                                      **kw) == want
                assert ptune.make_key("allreduce", tdt, nbytes, 8,
                                      platform="cpu", **kw) == want

    def test_codec_objects_and_names_key_alike(self):
        from mpi4torch_tpu.compress import get_codec as jget
        from mpi4torch_tpu_torch.compress import get_codec as pget

        want = jtune.make_key("allreduce", jnp.float32, 512, 4,
                              codec=jget("q8"))
        assert ptune.make_key("allreduce", torch.float32, 512, 4,
                              codec=pget("q8")) == want
        assert ptune.make_key("allreduce", "float32", 512, 4,
                              codec="q8") == want

    def test_bucket_nbytes_public_rule(self):
        for n in (0, 1, 3, 1023, 1024, 1025, 3000, 4096, 1 << 26):
            assert ptune.bucket_nbytes(n) == jtune.bucket_nbytes(n)

    def test_platform_token_is_the_worlds(self):
        # The world's device decides, never whether a card exists.
        assert PA._platform() == "cpu"
        assert PA.platform_of(torch.device("cuda", 0)) == "gpu"
        assert PA.platform_of("cpu") == "cpu"
        got = P.run_ranks(lambda: PA._platform(), 2, device="cpu")
        assert got == ["cpu", "cpu"]
        got = P.run_spmd(lambda: torch.tensor(
            float(PA._platform() == "cpu")), nranks=2, device="cpu")()
        assert got.tolist() == [1.0, 1.0]

    def test_default_cache_path_is_the_ports_own(self, monkeypatch):
        monkeypatch.delenv(PA.CACHE_ENV)
        monkeypatch.delenv("MPI4TORCH_TPU_TUNE_CACHE")
        assert ptune.cache_path() != jtune.cache_path()
        assert ptune.cache_path().endswith(os.path.join(
            "mpi4torch_tpu_torch", "tune_cache.json"))


# ----------------------------------------------------------- selector

SIZES = (64, 512, 2048, 4096, 65536, 1 << 20, 4 << 20)
CROSSOVERS = ((None, None), (4096, None), (None, 1 << 20),
              (4096, 1 << 20), (1 << 20, 1 << 20))
# (nbytes, nranks, algorithm, codec) cache winners recorded in both.
WINNERS = ((512, 8, "tree", None), (2048, 8, "bidir", None),
           (1 << 20, 4, "torus", None), (1 << 20, 3, "torus", None),
           (65536, 4, "rhd", None), (4 << 20, 8, "torus", "q8"),
           (2048, 8, "bidir", "q8"))


def _codecs():
    from mpi4torch_tpu.compress import get_codec as jget
    from mpi4torch_tpu_torch.compress import get_codec as pget

    return [(None, None)] + [(pget(n), jget(n)) for n in ("q8", "bf16")]


class TestSelector:
    @pytest.mark.parametrize("lat, bw", CROSSOVERS)
    @pytest.mark.parametrize("cached", [False, True])
    def test_grid_equals_jax(self, lat, bw, cached):
        for cfg in (jmpi.config, P.config):
            cfg.set_latency_crossover_bytes(lat)
            cfg.set_bandwidth_crossover_bytes(bw)
        codecs = _codecs()
        if cached:
            names = dict((j.name, (p, j)) for p, j in codecs[1:])
            for nbytes, n, algo, cname in WINNERS:
                pc, jc = names[cname] if cname else (None, None)
                jtune.record("allreduce", jnp.float32, nbytes, n, algo,
                             codec=jc)
                ptune.record("allreduce", torch.float32, nbytes, n, algo,
                             codec=pc)
        for nbytes in SIZES:
            for n in (1, 3, 4, 8):
                for pc, jc in codecs:
                    for det in (False, True):
                        want = jtune.select_auto(
                            nbytes=nbytes, dtype=jnp.float32, nranks=n,
                            deterministic=det, codec=jc)
                        got = ptune.select_auto(
                            nbytes=nbytes, dtype=torch.float32, nranks=n,
                            deterministic=det, codec=pc)
                        assert got == want, (nbytes, n, jc, det)

    def test_hier_group_config_voids_cached_torus(self):
        for mod, cfg, dt in ((jtune, jmpi.config, jnp.float32),
                             (ptune, P.config, torch.float32)):
            mod.record("allreduce", dt, 1 << 20, 8, "torus")
            cfg.set_hier_group_size(3)
        assert ptune.select_auto(nbytes=1 << 20, dtype=torch.float32,
                                 nranks=8) == jtune.select_auto(
            nbytes=1 << 20, dtype=jnp.float32, nranks=8) == "ring"

    def test_latency_tier_guard(self):
        # A bandwidth winner under a decode-sized key is voided at or
        # below the latency crossover; a latency winner is honored; a
        # codec-keyed winner is exempt.
        from mpi4torch_tpu_torch.compress import get_codec

        ptune.record("allreduce", torch.float32, 2048, 8, "bidir")
        assert _auto(nbytes=2048, nranks=8) == "bidir"
        P.config.set_latency_crossover_bytes(4096)
        assert _auto(nbytes=2048, nranks=8) == "rhd"
        ptune.record("allreduce", torch.float32, 2048, 8, "tree")
        assert _auto(nbytes=2048, nranks=8) == "tree"
        ptune.record("allreduce", torch.float32, 2048, 8, "bidir",
                     codec="q8")
        assert _auto(nbytes=2048, nranks=8,
                                 codec=get_codec("q8")) == "bidir"

    def test_selection_is_deterministic(self):
        P.config.set_latency_crossover_bytes(4096)
        assert len({_auto(nbytes=512, nranks=8)
                    for _ in range(5)}) == 1


class TestResolveRequest:
    NAMES = ("ring", "rhd", "tree", "hier", "bidir", "torus", "auto",
             None, False, "warp9", "synth:0000000000")

    def test_outcomes_equal_jax(self):
        for name in self.NAMES:
            for coll in ("allreduce", "bcast", "reduce"):
                for n in (1, 2, 3, 5, 6, 8):
                    for explicit in (False, True):
                        kw = dict(collective=coll, nranks=n,
                                  explicit=explicit)
                        assert _outcome(ptune.resolve_request, name, **kw) \
                            == _outcome(jtune.resolve_request, name, **kw), \
                            (name, coll, n, explicit)

    def test_installed_synth_resolves(self):
        res = PS.synthesize(8, 1 << 14)
        name = PS.install(res["program"])
        assert ptune.resolve_request(name, nranks=8, explicit=True) == name
        assert ptune.resolve_request(name, nranks=4) is None
        with pytest.raises(P.CommError, match="serves allreduce"):
            ptune.resolve_request(name, collective="bcast", nranks=8,
                                  explicit=True)


# ------------------------------------------------------------- facade


def _ar(n, algorithm=None, spmd=True, scope=None, **kw):
    """Rank 0's Allreduce of ones(4) on an ``n``-rank CPU world, and its
    exchange sequence; ``scope`` is an ``algorithm_scope`` opened in the
    rank body (scopes are per thread: rank threads do not see the
    launcher's, while ``run_spmd`` binds the caller's in its ranks)."""
    from contextlib import nullcontext

    from mpi4torch_tpu_torch import COMM_WORLD

    def body():
        with (P.config.algorithm_scope(scope) if scope is not None
              else nullcontext()):
            return COMM_WORLD.Allreduce(torch.ones(4), P.MPI_SUM,
                                        algorithm=algorithm, **kw)

    with _Exchanges() as ex:
        if spmd:
            out = P.run_spmd(body, nranks=n, device="cpu")()[0]
        else:
            out = P.run_ranks(body, n, device="cpu")[0]
    return out, ex.seq


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


class TestFacade:
    @pytest.mark.parametrize("spmd", [True, False])
    def test_explicit_rhd_non_power_of_two_raises(self, spmd):
        with pytest.raises(P.CommError, match="power-of-two"):
            _ar(6, "rhd", spmd=spmd)

    @pytest.mark.parametrize("spmd", [True, False])
    def test_scope_rhd_degrades_on_non_power_of_two(self, spmd):
        out, seq = _ar(6, spmd=spmd, scope="rhd")
        assert out.tolist() == [6.0] * 4
        assert seq == _ar(6, spmd=spmd)[1]

    @pytest.mark.parametrize("spmd", [True, False])
    def test_scope_changes_the_schedule(self, spmd):
        out, seq = _ar(8, spmd=spmd, scope="rhd")
        assert out.tolist() == [8.0] * 4
        assert seq == _ar(8, "rhd", spmd=spmd)[1]
        base = _ar(8, spmd=spmd)[1]
        assert seq != base
        # False / "auto" ask for the selector inside the scope.
        assert _ar(8, "auto", spmd=spmd, scope="rhd")[1] == base
        assert _ar(8, False, spmd=spmd, scope="rhd")[1] == base

    def test_run_spmd_binds_the_callers_scope(self):
        # run_spmd reads the caller's algorithm scope at the call and
        # binds it in its rank threads, as the JAX package's does.
        with P.config.algorithm_scope("rhd"):
            seq = _ar(8)[1]
        assert seq == _ar(8, "rhd")[1]

    def test_process_default_reaches_the_rank_threads(self):
        P.config.set_default_algorithm("tree")
        try:
            seq = _ar(4, spmd=False)[1]
        finally:
            P.config.set_default_algorithm(None)
        assert seq == _ar(4, "tree", spmd=False)[1]

    def test_explicit_torus_on_prime_world_raises_scope_degrades(self):
        for spmd in (True, False):
            with pytest.raises(P.CommError, match="factorization"):
                _ar(5, "torus", spmd=spmd)
            out, seq = _ar(5, spmd=spmd, scope="torus")
            assert out.tolist() == [5.0] * 4
            assert seq == _ar(5, spmd=spmd)[1]

    def test_scope_hier_with_invalid_group_degrades(self):
        P.config.set_hier_group_size(3)   # does not divide 8
        for spmd in (True, False):
            with pytest.raises(P.CommError):
                _ar(8, "hier", spmd=spmd)
            out, seq = _ar(8, spmd=spmd, scope="hier")
            assert out.tolist() == [8.0] * 4
            assert seq == _ar(8, "ring", spmd=spmd)[1]

    def test_allreduce_scope_leaves_bcast_size_dispatch_alone(self):
        from mpi4torch_tpu_torch import COMM_WORLD

        def bcast():
            with _Exchanges() as ex:
                P.run_spmd(lambda: COMM_WORLD.Bcast_(torch.ones(16), 1),
                           nranks=8, device="cpu")()
            return ex.seq

        base = bcast()
        with P.config.algorithm_scope("rhd"):
            assert bcast() == base

    def test_auto_picks_reach_the_wire(self):
        # Below the latency crossover an auto Allreduce under run_spmd
        # takes rhd's exchanges, bitwise its explicit form; a cached
        # winner takes its own.
        P.config.set_latency_crossover_bytes(4096)
        out, seq = _ar(8)
        want, want_seq = _ar(8, "rhd")
        assert torch.equal(out, want) and seq == want_seq
        P.config.set_latency_crossover_bytes(None)
        with runtime._bind_rank(runtime.RankContext(
                runtime.World(1, device=CPU), 0)):
            ptune.record("allreduce", torch.float32, 16, 8, "tree")
        assert _ar(8)[1] == _ar(8, "tree")[1]

    def test_explicit_codec_plus_algorithm_conflict_raises(self):
        with pytest.raises(ValueError, match="ring"):
            _ar(8, "rhd", compression="q8")
        # a scope codec yields to an explicit algorithm, a scope
        # algorithm to an explicit codec (the codec then takes ring)
        with P.config.compression_scope("q8"):
            assert _ar(8, "rhd")[1] == _ar(8, "rhd")[1]
        _, seq = _ar(8, compression="q8", scope="rhd")
        assert seq == _ar(8, "ring", compression="q8")[1]

    def test_unknown_algorithm_raises(self):
        from mpi4torch_tpu_torch import COMM_WORLD

        with pytest.raises(ValueError, match="unknown collective"):
            COMM_WORLD.Allreduce(torch.ones(4), P.MPI_SUM,
                                 algorithm="warp9")
        with pytest.raises(ValueError, match="unknown collective"):
            P.config.set_default_algorithm("warp9")

    def test_rhd_not_valid_for_bcast(self):
        from mpi4torch_tpu_torch import COMM_WORLD

        with pytest.raises(P.CommError, match="serves"):
            P.run_spmd(lambda: COMM_WORLD.Bcast_(
                torch.ones(4), 0, algorithm="rhd"), nranks=8,
                device="cpu")()


# -------------------------------------------------------------- cache

KEY = dict(collective="allreduce", dtype="float32", nbytes=512, nranks=8)


class TestCacheRoundTrip:
    def test_record_persists_and_reloads(self):
        ptune.record("allreduce", "float32", 512, 8, "rhd",
                     measurements={"ring": 1e-3, "rhd": 5e-4})
        with open(ptune.cache_path()) as f:
            data = json.load(f)
        assert data["version"] == PA.CACHE_VERSION == 3
        assert any(v["algorithm"] == "rhd"
                   for v in data["entries"].values())
        ptune.clear()
        assert ptune.lookup_algorithm(**KEY) == "rhd"
        assert ptune.entry_from_disk(**KEY)

    @pytest.mark.parametrize("text", ["{ not json ][", "",
                                      '{"version": 3, "entries": {"a'])
    def test_corrupt_or_truncated_cache_falls_back(self, text):
        with open(ptune.cache_path(), "w") as f:
            f.write(text)
        ptune.clear()
        assert ptune.lookup(**KEY) is None
        assert _auto(nbytes=512, nranks=8) == "ring"
        ptune.record("allreduce", "float32", 512, 8, "tree")
        ptune.clear()
        assert ptune.lookup_algorithm(**KEY) == "tree"

    @pytest.mark.parametrize("version", [1, 2, 999])
    def test_wrong_version_ignored(self, version):
        with open(ptune.cache_path(), "w") as f:
            json.dump({"version": version, "entries": {
                ptune.make_key("allreduce", "float32", 512, 8):
                    {"algorithm": "rhd"}}}, f)
        ptune.clear()
        assert ptune.lookup(**KEY) is None

    def test_stale_algorithm_name_ignored(self):
        with open(ptune.cache_path(), "w") as f:
            json.dump({"version": 3, "entries": {
                ptune.make_key("allreduce", "float32", 512, 8):
                    {"algorithm": "warp9"}}}, f)
        ptune.clear()
        assert ptune.lookup(**KEY) is None
        assert _auto(nbytes=512, nranks=8) == "ring"
        with pytest.raises(ValueError):
            ptune.record("allreduce", "float32", 512, 8, "warp9")

    def test_clear_remove_file_resets_to_defaults(self):
        ptune.record("allreduce", "float32", 512, 8, "tree")
        ptune.clear(remove_file=True)
        assert ptune.lookup(**KEY) is None
        assert not os.path.exists(ptune.cache_path())

    def test_generation_bumps_on_mutation(self):
        g0 = ptune.generation()
        ptune.record("allreduce", "float32", 512, 8, "tree")
        g1 = ptune.generation()
        ptune.clear()
        assert g0 < g1 < ptune.generation()

    def test_concurrent_saves_union_instead_of_losing_work(self):
        ptune.record("allreduce", "float32", 512, 8, "rhd")
        with open(ptune.cache_path()) as f:
            data = json.load(f)
        foreign = ptune.make_key("allreduce", "float32", 1 << 20, 16,
                                 platform="cpu")
        data["entries"][foreign] = {"algorithm": "bidir"}
        with open(ptune.cache_path(), "w") as f:
            json.dump(data, f)
        ptune.record("allreduce", "float32", 2048, 8, "tree")
        with open(ptune.cache_path()) as f:
            final = json.load(f)
        assert final["entries"][foreign]["algorithm"] == "bidir"
        assert {e["algorithm"] for e in final["entries"].values()} == \
            {"rhd", "tree", "bidir"}
        cache_dir = os.path.dirname(ptune.cache_path())
        assert not [p for p in os.listdir(cache_dir) if p.endswith(".tmp")]

    def test_rank_threads_record_at_once(self):
        # Eight rank threads record and look up concurrently: every
        # winner lands, in memory and on disk.
        def body(rank):
            ptune.record("allreduce", "float32", 1 << (10 + rank), 8,
                         "tree")
            return ptune.lookup_algorithm("allreduce", "float32",
                                          1 << (10 + rank), 8)

        assert P.run_ranks(body, 8, device="cpu") == ["tree"] * 8
        ptune.clear()
        for r in range(8):
            assert ptune.lookup_algorithm("allreduce", "float32",
                                          1 << (10 + r), 8) == "tree"

    def test_unwritable_cache_dir_degrades_in_process(self, monkeypatch,
                                                      tmp_path):
        blocker = tmp_path / "blocker"
        blocker.write_text("not a directory")
        monkeypatch.setenv(PA.CACHE_ENV, str(blocker / "tune_cache.json"))
        ptune.clear()
        ptune.record("allreduce", "float32", 512, 8, "tree")
        assert ptune.lookup_algorithm(**KEY) == "tree"

    def test_jax_file_loads_in_the_port_and_back(self, tmp_path):
        # JAX writes measured, codec-keyed, reshard and synthesized
        # winners; the port reads the same winners from that file (the
        # synth entry installs the same program), and JAX reads the
        # port's file.
        jtune.record("allreduce", "float32", 512, 8, "rhd",
                     measurements={"ring": 2e-3, "rhd": 1e-3})
        jtune.record("allreduce", "float32", 1 << 20, 8, "torus",
                     codec="q8")
        jmpi.csched.autotune_synthesis(nranks=8, sizes=(1 << 14,))
        ptune.clear()
        os.environ[PA.CACHE_ENV] = jtune.cache_path()
        try:
            ptune.clear()
            assert ptune.lookup_algorithm(**KEY) == "rhd"
            assert ptune.lookup_algorithm(
                "allreduce", "float32", 1 << 20, 8, codec="q8") == "torus"
            name = ptune.lookup_algorithm("allreduce", "float32", 1 << 14,
                                          8, codec="synth")
            assert name == JS.synthesize(8, 1 << 14)["winner"]
            assert PS.synth_applicable(name, 8)
            assert PS.installed_program(name, 8).to_json() == \
                JS.synthesize(8, 1 << 14)["program"].to_json()
            with P.config.deterministic_mode(True):
                assert _auto(nbytes=1 << 14, nranks=8,
                                         deterministic=True) == name
        finally:
            os.environ[PA.CACHE_ENV] = str(tmp_path / "torch_cache.json")
        ptune.clear()
        ptune.record("allreduce", torch.bfloat16, 4096, 4, "tree")
        PS.clear_installed()
        P.csched.autotune_synthesis(nranks=8, sizes=(1 << 10,),
                                    device="cpu")
        os.environ["MPI4TORCH_TPU_TUNE_CACHE"] = ptune.cache_path()
        jtune.clear()
        JS.clear_installed()
        assert jtune.lookup_algorithm("allreduce", jnp.bfloat16, 4096,
                                      4) == "tree"
        jname = jtune.lookup_algorithm("allreduce", jnp.float32, 1 << 10,
                                       8, codec="synth")
        assert jname is not None and JS.synth_applicable(jname, 8)


class TestCacheCli:
    def _run(self, *argv):
        from mpi4torch_tpu_torch.tune.__main__ import _main
        return _main(list(argv))

    def test_show_prints_winners_table(self, capsys):
        import re

        ptune.record("allreduce", "float32", 512, 8, "rhd", platform="cpu",
                     measurements={"ring": 1e-3, "rhd": 5e-4})
        ptune.record("allreduce", "float32", 4 << 20, 8, "bidir",
                     platform="cpu")
        assert self._run("--show") == 0
        out = capsys.readouterr().out
        assert re.search(r"allreduce\s+float32\s+512\s+8\s+cpu\s+-\s+rhd",
                         out)
        assert re.search(
            r"allreduce\s+float32\s+4194304\s+8\s+cpu\s+-\s+bidir", out)
        assert "2 cached winner(s)" in out

    def test_rows_equal_jax(self):
        from mpi4torch_tpu.tune.__main__ import _rows as jrows
        from mpi4torch_tpu_torch.tune.__main__ import _rows as prows

        ptune.record("allreduce", "float32", 512, 8, "rhd",
                     measurements={"ring": 1e-3})
        ptune.record("allreduce", "float32", 1 << 20, 8, "torus",
                     codec="q8")
        ptune.record("allreduce", "float32", 4096, 8, "tree",
                     ctl={"provenance": "online-switched", "epoch": 3,
                          "trigger": "drift"})
        P.csched.autotune_tier_synthesis(nranks=8, sizes=(1 << 12,),
                                         tiers=(2, 2, 2),
                                         tier_bandwidths=(1.0, 1.0, 0.05),
                                         device="cpu")
        data = json.load(open(ptune.cache_path()))
        assert prows(data) == jrows(data)
        assert any(r[7].startswith("synthesized(") for r in prows(data))

    def test_show_empty_and_missing_cache(self, capsys):
        assert self._run() == 0
        assert "no cache" in capsys.readouterr().out

    def test_clear_removes_file(self, capsys):
        ptune.record("allreduce", "float32", 512, 8, "tree")
        assert self._run("--clear") == 0
        ptune.clear()
        assert ptune.lookup("allreduce", "float32", 512, 8) is None
        assert self._run("--clear") == 0
        assert "no cache file" in capsys.readouterr().out

    def test_json_dump(self, capsys):
        ptune.record("allreduce", "float32", 512, 8, "tree")
        assert self._run("--json") == 0
        data = json.loads(capsys.readouterr().out)
        assert any(e["algorithm"] == "tree"
                   for e in data["entries"].values())


# -------------------------------------------------------- measurement


class TestAutotunerMeasurement:
    def test_measure_then_serve_from_cache(self):
        sizes = (256, 2048)
        rep = ptune.autotune_allreduce(sizes=sizes, nranks=4, iters=1,
                                       device="cpu")
        assert rep["tuned_from_cache"] is False
        assert rep["platform"] == "cpu" and rep["dtype"] == "float32"
        assert set(rep["entries"]) == {"256", "2048"}
        for ent in rep["entries"].values():
            assert ent["winner"] in ptune.available_algorithms()
            assert set(ent["algorithms"]) == {"ring", "rhd", "tree",
                                              "hier", "bidir", "torus"}
        assert rep["crossover_bytes"] == PA._crossover_from(rep["entries"])
        ptune.clear()
        P.config.set_latency_crossover_bytes(None)
        rep2 = ptune.ensure_tuned_allreduce(sizes=sizes, nranks=4,
                                            iters=1, device="cpu")
        assert rep2["tuned_from_cache"] is True and rep2["from_disk"]
        assert {k: v["winner"] for k, v in rep2["entries"].items()} == \
            {k: v["winner"] for k, v in rep["entries"].items()}
        assert rep2["crossover_bytes"] == rep["crossover_bytes"]
        assert P.config.latency_crossover_bytes() == rep["crossover_bytes"]

    def test_sweep_codec_dimension(self):
        rep = ptune.autotune_allreduce(sizes=(1 << 12,), nranks=4, iters=1,
                                       persist=False, codecs=(None, "q8"),
                                       device="cpu")
        ent = rep["entries"][str(1 << 12)]
        assert "winner" in ent
        q8 = ent["codecs"]["q8"]
        assert set(q8["algorithms"]) == {"ring", "bidir", "torus"}
        assert ptune.lookup_algorithm("allreduce", torch.float32, 1 << 12,
                                      4, codec="q8") == q8["winner"]
        assert not os.path.exists(ptune.cache_path())

    def test_failing_candidate_is_reported_not_raised(self, monkeypatch):
        # A candidate that raises lands under "error"; the sweep goes on.
        real = PA._time_step

        def flaky(step, x, iters, device=None):
            if flaky.n == 1:
                flaky.n += 1
                raise RuntimeError("boom")
            flaky.n += 1
            return real(step, x, iters, device)

        flaky.n = 0
        monkeypatch.setattr(PA, "_time_step", flaky)
        rep = ptune.autotune_allreduce(sizes=(256,), nranks=4, iters=1,
                                       persist=False, device="cpu")
        algos = rep["entries"]["256"]["algorithms"]
        errs = [k for k, v in algos.items() if "error" in v]
        assert len(errs) == 1
        assert algos[errs[0]]["error"] == "RuntimeError: boom"
        assert rep["entries"]["256"]["winner"] != errs[0]

    def test_crossover_rules_equal_jax(self):
        from mpi4torch_tpu.tune import autotuner as JA

        rng = np.random.default_rng(0)
        for _ in range(50):
            entries = {}
            for s in (1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18):
                w = str(rng.choice(["ring", "rhd", "tree", "bidir",
                                    "torus", "hier"]))
                spec = ptune.get_algorithm(w)
                entries[str(s)] = {
                    "winner": w,
                    "winner_latency_optimal": spec.latency_optimal,
                    "winner_bandwidth_optimal": spec.bandwidth_optimal}
            assert PA._crossover_from(entries) == \
                JA._crossover_from(entries)
            assert PA._bandwidth_crossover_from(entries) == \
                JA._bandwidth_crossover_from(entries)


class TestMeasurementRobustness:
    def test_time_step_is_outlier_immune(self):
        import time as _time

        calls = {"n": 0}

        def step(x):
            calls["n"] += 1
            if calls["n"] in (4, 5, 6):
                _time.sleep(0.12)
            return (x,)

        dt = PA._time_step(step, torch.ones(8), iters=5)
        assert dt < 0.06

    def test_outlier_cannot_flip_a_winner(self, monkeypatch):
        def measure(samples):
            acc = {"t": 0.0}
            calls = {"n": 0}

            def step(x):
                calls["n"] += 1
                if calls["n"] > 2:
                    acc["t"] += samples[calls["n"] - 3]
                return (x,)

            monkeypatch.setattr(PA.time, "perf_counter", lambda: acc["t"])
            return PA._time_step(step, torch.ones(4), iters=len(samples))

        assert measure([0.001, 0.50, 0.48, 0.52, 0.001]) < \
            measure([0.002] * 5)

    def test_cache_version_keys_in_the_min_rule(self):
        from mpi4torch_tpu.tune import autotuner as JA

        assert PA.CACHE_VERSION == JA.CACHE_VERSION >= 2


# ------------------------------------------------------ fused buckets


class TestFusePerBucket:
    TREE = {"big": np.ones(3000, np.float32),
            "small": np.ones(10, np.float32)}

    def _picks(self, algorithm=None, compression=None):
        """Each bucket's (codec, algorithm) in both packages, Mode A on 8
        ranks, at 8 KiB buckets."""
        from mpi4torch_tpu.compress import get_codec as jget
        from mpi4torch_tpu.fuse.bucketing import flatten_buckets as jflat
        from mpi4torch_tpu.fuse.collectives import _plan_bucket as jplan
        from mpi4torch_tpu_torch.compress import get_codec as pget
        from mpi4torch_tpu_torch.fuse.bucketing import \
            flatten_buckets as pflat
        from mpi4torch_tpu_torch.fuse.collectives import _plan_bucket as pplan

        jb, _ = jflat({k: jnp.asarray(v) for k, v in self.TREE.items()},
                      8192)
        pb, _ = pflat({k: torch.from_numpy(v) for k, v in self.TREE.items()},
                      8192)
        jc = jget(compression) if compression else None
        pc = pget(compression) if compression else None
        kw = dict(explicit=compression is not None,
                  algo_explicit=algorithm is not None,
                  owns_resolution=False, size=8, mode_a=True)
        want = [jplan(None, b, jmpi.MPI_SUM, jc, algorithm, **kw)
                for b in jb]
        got = [pplan(b, P.MPI_SUM, pc, algorithm, **kw) for b in pb]
        name = lambda c: None if c is None else c.name  # noqa: E731
        return ([(name(c), a) for c, a in got],
                [(name(c), a) for c, a in want])

    @pytest.mark.parametrize("lat, bw", [(None, None), (1024, None),
                                         (1024, 8192)])
    @pytest.mark.parametrize("algorithm, compression", [
        (None, None), ("tree", None), (None, "q8"), ("bidir", "q8")])
    def test_picks_equal_jax(self, lat, bw, algorithm, compression):
        for cfg in (jmpi.config, P.config):
            cfg.set_latency_crossover_bytes(lat)
            cfg.set_bandwidth_crossover_bytes(bw)
        got, want = self._picks(algorithm, compression)
        assert got == want
        if (lat, bw, algorithm, compression) == (1024, 8192, None, None):
            assert [a for _, a in got] == ["bidir", "rhd"]

    def _tree_run(self, **kw):
        from mpi4torch_tpu_torch import COMM_WORLD

        tree = {k: torch.from_numpy(v) for k, v in self.TREE.items()}
        with _Exchanges() as ex:
            out = P.run_spmd(lambda: COMM_WORLD.Allreduce_tree(
                tree, P.MPI_SUM, bucket_bytes=8192, mean=True, **kw),
                nranks=8, device="cpu")()
        return out, ex.seq

    def test_tail_bucket_takes_the_latency_algorithm(self):
        base_out, base = self._tree_run()
        P.config.set_latency_crossover_bytes(1024)
        out, seq = self._tree_run()
        assert torch.equal(out["small"], base_out["small"])
        assert torch.equal(out["big"], base_out["big"])
        assert out["small"][0].tolist() == [1.0] * 10
        assert seq != base and len(seq) > len(base)

    def test_scope_hier_with_invalid_group_degrades_in_fused_path(self):
        P.config.set_hier_group_size(3)
        with P.config.algorithm_scope("hier"):
            out, _ = self._tree_run()
        assert out["small"][0].tolist() == [1.0] * 10
        tree = {k: torch.from_numpy(v) for k, v in self.TREE.items()}

        def eager():
            with P.config.algorithm_scope("hier"):
                return P.COMM_WORLD.Allreduce_tree(tree, P.MPI_SUM,
                                                   bucket_bytes=8192)

        assert P.run_ranks(eager, 8, device="cpu")[0]["small"].tolist() \
            == [8.0] * 10

    def test_conflict_exception_type_matches_facade(self):
        tree = {k: torch.from_numpy(v) for k, v in self.TREE.items()}
        with pytest.raises(ValueError, match="ring"):
            P.run_spmd(lambda: P.COMM_WORLD.Allreduce_tree(
                tree, P.MPI_SUM, compression="q8", algorithm="rhd"),
                nranks=8, device="cpu")()

    def test_scope_algorithm_on_overlap_pipeline_message(self):
        tree = {k: torch.from_numpy(v) for k, v in self.TREE.items()}

        def body():
            with P.config.algorithm_scope("rhd"):
                return P.COMM_WORLD.Allreduce_tree(tree, P.MPI_SUM,
                                                   overlap=True)

        with pytest.raises(P.CommError, match="algorithm_scope"):
            P.run_ranks(body, 2, device="cpu")


# -------------------------------------------------------------- knobs


class TestConfigKnobs:
    def test_validation_equals_jax(self):
        for setter, bad in (
                ("set_latency_crossover_bytes", ("lots", -1)),
                ("set_bandwidth_crossover_bytes", ("lots", -1)),
                ("set_serve_decode_buckets", (0, "x")),
                ("set_tier_bandwidths", ((), (1.0, 0.0), "fast")),
                ("set_default_algorithm", ("warp9",))):
            for v in bad:
                assert _outcome(getattr(P.config, setter), v) == \
                    _outcome(getattr(jmpi.config, setter), v), (setter, v)
                assert _outcome(getattr(P.config, setter), v)[0] == "raise"

    def test_algorithm_scope_nesting(self):
        assert P.config.default_algorithm() is None
        with P.config.algorithm_scope("tree"):
            assert P.config.default_algorithm() == "tree"
            with P.config.algorithm_scope(None):
                assert P.config.default_algorithm() is None
            with P.config.algorithm_scope("auto"):
                assert P.config.default_algorithm() is None
            assert P.config.default_algorithm() == "tree"
        assert P.config.default_algorithm() is None
        assert P.algorithm_scope is P.config.algorithm_scope

    def test_scope_is_per_thread_default_is_process_wide(self):
        with P.config.algorithm_scope("tree"):
            seen = P.run_ranks(lambda: P.config.default_algorithm(), 2,
                               device="cpu")
        assert seen == [None, None]
        P.config.set_default_algorithm("rhd")
        seen = P.run_ranks(lambda: P.config.default_algorithm(), 2,
                           device="cpu")
        assert seen == ["rhd", "rhd"]

    def test_process_state_round_trip(self):
        P.config.set_default_algorithm("tree")
        P.config.set_latency_crossover_bytes(4096)
        P.config.set_bandwidth_crossover_bytes(1 << 20)
        P.config.set_tier_bandwidths((1.0, 0.5))
        P.config.set_serve_decode_buckets(3)
        snap = P.config.snapshot_process_state()
        _reset()
        P.config.apply_process_state(snap)
        assert (P.config.default_algorithm(),
                P.config.latency_crossover_bytes(),
                P.config.bandwidth_crossover_bytes(),
                P.config.tier_bandwidths(),
                P.config.serve_decode_buckets()) == \
            ("tree", 4096, 1 << 20, (1.0, 0.5), 3)

    def test_knobs_reach_process_workers(self):
        from mpi4torch_tpu_torch.transport import shutdown

        P.config.set_default_algorithm("tree")
        P.config.set_latency_crossover_bytes(4096)
        try:
            got = P.run_ranks(lambda: (
                P.config.default_algorithm(),
                P.config.latency_crossover_bytes()), 2, backend="process",
                device="cpu")
        finally:
            shutdown()
        assert got == [("tree", 4096)] * 2


class TestServingLatencyReport:
    @pytest.mark.parametrize("lat", [None, 1 << 10, 1 << 14, 1 << 20])
    @pytest.mark.parametrize("nranks", [2, 3, 4])
    def test_latency_report_equals_jax(self, lat, nranks):
        from mpi4torch_tpu.models import transformer as JT
        from mpi4torch_tpu.serve import ServeConfig as JSC
        from mpi4torch_tpu.serve import latency_report as jreport
        from mpi4torch_tpu_torch.models import transformer as PT
        from mpi4torch_tpu_torch.serve import ServeConfig as PSC
        from mpi4torch_tpu_torch.serve import latency_report as preport

        for cfg in (jmpi.config, P.config):
            cfg.set_latency_crossover_bytes(lat)
        jtune.record("allreduce", jnp.float32, 1024, nranks, "bidir")
        ptune.record("allreduce", torch.float32, 1024, nranks, "bidir")
        jcfg = JT.TransformerConfig(vocab=64, d_model=64, n_heads=4,
                                    n_layers=2, d_ff=128, max_seq=32)
        pcfg = PT.TransformerConfig(vocab=64, d_model=64, n_heads=4,
                                    n_layers=2, d_ff=128, max_seq=32)
        for slots in (4, 8):
            assert preport(pcfg, PSC(slots=slots), nranks) == \
                jreport(jcfg, JSC(slots=slots), nranks)
            assert P.serve.decode_message_bytes(
                pcfg, PSC(slots=slots), torch.bfloat16) == \
                jmpi.serve.decode_message_bytes(jcfg, JSC(slots=slots),
                                                jnp.bfloat16)


# ---------------------------------------------------------------------------
# The census of each algorithm's schedule, forward and backward, on
# recorded programs (JAX's TestAlgorithmCensus / TestCodecAlgorithmCensus
# read the lowered StableHLO; both packages' parses are held equal here)
# ---------------------------------------------------------------------------

CENSUS_NR = 4
_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
          "collective_permute", "all_to_all")


def _only(**expected):
    out = {k: 0 for k in _KINDS}
    out.update(expected)
    return out


def _jparse(fn, x):
    """JAX's parse of ``fn(comm, x)`` lowered on CENSUS_NR devices."""
    from jax.sharding import Mesh, PartitionSpec as JP

    from mpi4torch_tpu import analyze as ja
    from mpi4torch_tpu._compat import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:CENSUS_NR]), ("w",))
    c = jmpi.comm_from_mesh(mesh, "w")
    txt = jax.jit(shard_map(lambda a: fn(c, a), mesh=mesh, in_specs=JP(),
                            out_specs=JP(), check_vma=False)).lower(x) \
        .as_text()
    return ja.parse_program(txt)


def _pparse(fn, x, grad=False):
    """The port's parse of ``fn(comm, x)`` recorded on CENSUS_NR rank
    threads (``grad``: with its gradient taken from outside)."""
    from mpi4torch_tpu_torch import analyze as pa
    from mpi4torch_tpu_torch.analyze.sweep import _flat_lowerer

    lower, lower_grad = _flat_lowerer(CENSUS_NR, "cpu")
    return pa.parse_program((lower_grad if grad else lower)(fn, x))


def _jgrad(fn):
    return lambda c, v: jax.value_and_grad(
        lambda u: jnp.vdot(fn(c, u), u))(v)


def _permutes(parsed):
    """``(width in elements, pairs, dtype)`` of each permute."""
    return sorted((int(op.operand_types[0].split("x")[0]),
                   tuple(map(tuple, op.source_target_pairs)), op.dtype)
                  for op in parsed.ops("collective_permute"))


def _census_pair(algo, grad=False, codec=None, x=None):
    """The port's and JAX's parse of the same Allreduce."""
    x = np.ones(16) if x is None else x

    def jbody(c, v):
        return c.Allreduce(v, jmpi.MPI_SUM, algorithm=algo,
                           compression=codec or False)

    def pbody(c, v):
        return c.Allreduce(v, P.MPI_SUM, algorithm=algo,
                           compression=codec or False)

    jp = _jparse(_jgrad(jbody) if grad else jbody, jnp.asarray(x))
    pp = _pparse(pbody, torch.from_numpy(x), grad=grad)
    assert pp.census() == jp.census()
    assert _permutes(pp) == _permutes(jp)
    return pp


class TestAlgorithmCensus:
    FWD_RING = tuple((i, (i + 1) % CENSUS_NR) for i in range(CENSUS_NR))
    REV_RING = tuple((i, (i - 1) % CENSUS_NR) for i in range(CENSUS_NR))

    def test_ring_is_one_all_reduce(self):
        assert _census_pair("ring").census() == _only(all_reduce=1)

    def test_rhd_is_log_permutes_of_shrinking_width(self):
        pp = _census_pair("rhd")
        assert pp.census() == _only(collective_permute=4)
        assert {w for w, _, _ in _permutes(pp)} == {8, 4}

    def test_tree_is_log_permutes_full_width(self):
        pp = _census_pair("tree")
        assert pp.census() == _only(collective_permute=4)
        assert {w for w, _, _ in _permutes(pp)} == {16}

    def test_hier_is_rs_ar_ag_triple(self):
        assert _census_pair("hier").census() == _only(
            reduce_scatter=1, all_reduce=1, all_gather=1)

    def test_bidir_is_two_counter_rotating_half_payload_chains(self):
        pp = _census_pair("bidir")
        n = CENSUS_NR
        assert pp.census() == _only(collective_permute=4 * (n - 1))
        tables = [t for _, t, _ in _permutes(pp)]
        assert tables.count(self.FWD_RING) == 2 * (n - 1)
        assert tables.count(self.REV_RING) == 2 * (n - 1)
        assert {w for w, _, _ in _permutes(pp)} == {16 // 2 // n}

    def test_bidir_backward_rides_swapped_channels(self):
        pp = _census_pair("bidir", grad=True)
        n = CENSUS_NR
        assert pp.census() == _only(collective_permute=8 * (n - 1))
        tables = [t for _, t, _ in _permutes(pp)]
        assert tables.count(self.FWD_RING) == 4 * (n - 1)
        assert tables.count(self.REV_RING) == 4 * (n - 1)

    def test_torus_is_one_grouped_channel_per_axis(self):
        pp = _census_pair("torus")
        assert pp.census() == _only(reduce_scatter=2, all_reduce=2,
                                    all_gather=2)
        assert {op.replica_groups for op in pp.ops("reduce_scatter")} \
            == {((0, 1), (2, 3)), ((0, 2), (1, 3))}

    def test_torus_backward_census_doubles(self):
        assert _census_pair("torus", grad=True).census() == _only(
            reduce_scatter=4, all_reduce=4, all_gather=4)

    def test_backward_census_matches_forward_per_algorithm(self):
        assert _census_pair("ring", grad=True).census() \
            == _only(all_reduce=2)
        for algo in ("rhd", "tree"):
            assert _census_pair(algo, grad=True).census() \
                == _only(collective_permute=8), algo
        assert _census_pair("hier", grad=True).census() == _only(
            reduce_scatter=2, all_reduce=2, all_gather=2)


def _codec_algorithm_pairs():
    """Every (codec-capable algorithm x codec declaring it) pair, from the
    port's registries (held equal to JAX's by ``TestKeys`` and the
    registry guards)."""
    from mpi4torch_tpu_torch.compress import available_codecs, get_codec

    return [(algo, name) for algo in ptune.available_algorithms()
            if ptune.get_algorithm(algo).codec_capable
            for name in available_codecs()
            if algo in get_codec(name).algorithms]


class TestCodecAlgorithmCensus:
    X = np.ones(4096, np.float32)

    def test_pairs_equal_jax(self):
        from mpi4torch_tpu.compress import available_codecs, get_codec

        assert _codec_algorithm_pairs() == [
            (algo, name) for algo in jtune.available_algorithms()
            if jtune.get_algorithm(algo).codec_capable
            for name in available_codecs()
            if algo in get_codec(name).algorithms]

    @pytest.mark.parametrize("algo,codec", _codec_algorithm_pairs())
    def test_pair_census(self, algo, codec):
        from mpi4torch_tpu.compress import get_codec as jget

        cobj = jget(codec)
        leaves = len(jax.tree_util.tree_leaves(
            cobj.base().encode(jnp.ones(64, jnp.float32))[0]))
        channels = 2 if algo in ("bidir", "torus") else 1
        rounds = cobj.ef_rounds
        got = _census_pair(algo, codec=codec, x=self.X)
        n = CENSUS_NR
        census = got.census()
        assert census["all_reduce"] == 0
        assert census["collective_permute"] == \
            rounds * channels * (n - 1) * leaves
        assert census["all_gather"] == rounds * channels * leaves
        if cobj.base().hop_fused:
            # the quantized payload rides int8 end to end
            assert got.ops("collective_permute", dtype="i8")
            assert got.ops("all_gather", dtype="i8")

    @pytest.mark.parametrize("codec", ["q8", "q8_ef_hop"])
    def test_bidir_int8_permutes_on_both_rotations(self, codec):
        from mpi4torch_tpu.compress import int8_rotation_census as jrot
        from mpi4torch_tpu_torch.analyze.sweep import _flat_lowerer
        from mpi4torch_tpu_torch.compress import int8_rotation_census

        lower, _ = _flat_lowerer(CENSUS_NR, "cpu")
        prog = lower(lambda c, v: c.Allreduce(
            v, P.MPI_SUM, compression=codec, algorithm="bidir"),
            torch.from_numpy(self.X))
        seen, fwd, bwd = int8_rotation_census(prog, CENSUS_NR)
        assert fwd in seen and bwd in seen, sorted(seen)
        jtxt = _jparse(lambda c, v: c.Allreduce(
            v, jmpi.MPI_SUM, compression=codec, algorithm="bidir"),
            jnp.asarray(self.X))
        jseen, jfwd, jbwd = jrot(jtxt.text, CENSUS_NR)
        assert (fwd, bwd) == (jfwd, jbwd) and seen == jseen

    def test_bidir_fwd_bwd_census_doubles_with_swapped_rotations(self):
        got = _census_pair("bidir", grad=True, codec="q8", x=self.X)
        n = CENSUS_NR
        census = got.census()
        assert census["collective_permute"] == 2 * 2 * 2 * (n - 1)
        assert census["all_gather"] == 2 * 2 * 2
        assert census["all_reduce"] == 0
