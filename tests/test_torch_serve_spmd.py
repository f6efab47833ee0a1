"""The port's SPMD serving engine (``Engine(spmd=True)``) against the JAX
package, on the CPU.

Mirrors the ``spmd=True`` cases of ``tests/test_serve.py``
(``TestEngineOracleParity``, ``TestSlotTable``, ``TestDeadlinesAndShedding``,
``TestPagedOracleParity``, ``TestPagedNoRetrace``, ``TestCrossModeBitwise``)
with the JAX test's config, prompts and budgets in float64, the JAX
weights carried across: four requests through two slots on (4,) rank
threads and on the ``tp`` axis of a (2, 4) mesh.  Every request's tokens
equal the JAX package's per-request ``generate()`` exactly (greedy and
sampled, dense and paged, chunked prefill, deadline evictions), and the
JAX package's own ``Engine(spmd=True)`` on the same requests; the port's
Mode A decode step is bitwise its Mode B step under deterministic mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu_torch as P
from mpi4torch_tpu import serve as jserve
from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu_torch import serve as pserve
from mpi4torch_tpu_torch.models import transformer as PT
from mpi4torch_tpu_torch.serve import kv as pkv

KW = dict(vocab=37, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_seq=24)
PROMPTS = [np.array([1, 2, 3]), np.array([4, 5, 6, 7, 8]),
           np.array([9, 10]), np.array([11, 12, 13, 14])]
BUDGETS = [6, 4, 5, 3]
PAGED_TIGHT = dict(slots=2, block_size=4, num_blocks=5)


@pytest.fixture(scope="module")
def model():
    jcfg = JT.TransformerConfig(**KW)
    jparams = JT.init_transformer(jax.random.PRNGKey(0), jcfg,
                                  dtype=jnp.float64)
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, PT.TransformerConfig(**KW), pparams


@pytest.fixture(autouse=True)
def _isolation():
    yield
    pserve.reset_stats()


_GREEDY = {}


def _oracle(jcfg, jparams, temperature=0.0, top_k=0, keys=None):
    if temperature == 0.0 and "tokens" in _GREEDY:
        return _GREEDY["tokens"]
    out = []
    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        seq = JT.generate(jcfg, jparams, jnp.asarray(p, jnp.int32)[None],
                          n, dtype=jnp.float64, temperature=temperature,
                          top_k=top_k,
                          key=None if keys is None else keys[i])
        out.append(np.asarray(seq[0]).tolist())
    if temperature == 0.0:
        _GREEDY["tokens"] = out
    return out


def _drive(eng, keys=None):
    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        eng.submit(p, max_new=n, key=None if keys is None else keys[i])
    res = eng.run()
    return [np.asarray(res[i]).tolist() for i in range(len(PROMPTS))]


def _mesh():
    return P.device_mesh({"dp": 2, "tp": 4}, devices=["cpu"] * 8)


def _spmd_kw(world):
    if world == "mesh2x4":
        return dict(spmd=True, mesh=_mesh(), axis_name="tp")
    return dict(spmd=True, nranks=4)


class TestEngineOracleParity:
    @pytest.mark.parametrize("world,overlap", [("spmd4", True),
                                               ("spmd4", False),
                                               ("mesh2x4", True)])
    def test_tokens_equal_generate(self, model, world, overlap):
        jcfg, jparams, pcfg, pparams = model
        eng = pserve.Engine(pcfg, pparams,
                            pserve.ServeConfig(slots=2, overlap=overlap),
                            device="cpu", **_spmd_kw(world))
        assert _drive(eng) == _oracle(jcfg, jparams)
        snap = eng.stats.snapshot()
        assert snap["admitted"] == snap["finished"] == len(PROMPTS)

    def test_tokens_equal_jax_spmd_engine(self, model):
        jcfg, jparams, pcfg, pparams = model
        jeng = jserve.Engine(jcfg, jparams, jserve.ServeConfig(slots=2),
                             spmd=True, nranks=4)
        want = _drive(jeng)
        eng = pserve.Engine(pcfg, pparams, pserve.ServeConfig(slots=2),
                            spmd=True, nranks=4, device="cpu")
        assert _drive(eng) == want == _oracle(jcfg, jparams)

    def test_sampled_tokens_equal_generate(self, model):
        jcfg, jparams, pcfg, pparams = model
        jkeys = [jax.random.PRNGKey(100 + i) for i in range(len(PROMPTS))]
        keys = [np.asarray(k) for k in jkeys]
        eng = pserve.Engine(pcfg, pparams,
                            pserve.ServeConfig(slots=2, temperature=0.9,
                                               top_k=7),
                            spmd=True, nranks=4, device="cpu")
        assert _drive(eng, keys) == _oracle(jcfg, jparams, 0.9, 7, jkeys)

    def test_mode_b_engine_gives_the_same_tokens(self, model):
        _, _, pcfg, pparams = model
        scfg = pserve.ServeConfig(slots=2)
        a = _drive(pserve.Engine(pcfg, pparams, scfg, spmd=True, nranks=4,
                                 device="cpu"))
        b = P.run_ranks(lambda: _drive(pserve.Engine(pcfg, pparams, scfg,
                                                     device="cpu")),
                        4, device="cpu")
        assert all(r == a for r in b)


class TestSlotTable:
    def test_config_validation(self, model):
        _, _, pcfg, pparams = model
        with pytest.raises(P.CommError, match="n_heads"):
            pserve.Engine(pcfg, pparams, pserve.ServeConfig(slots=1),
                          spmd=True, nranks=3, device="cpu")
        with pytest.raises(ValueError, match="axis_name"):
            pserve.Engine(pcfg, pparams, pserve.ServeConfig(slots=1),
                          spmd=True, mesh=_mesh())
        # shards= is the rank-thread extension: no SPMD form.
        shards = pkv.shard_params_tp(pcfg, pparams, P.COMM_WORLD)
        with pytest.raises(ValueError, match="shards="):
            pserve.Engine(pcfg, None, pserve.ServeConfig(slots=1),
                          spmd=True, nranks=4, device="cpu", shards=shards)

    def test_stacked_state_and_poisoned_free_slots(self, model):
        _, _, pcfg, pparams = model
        eng = pserve.Engine(pcfg, pparams, pserve.ServeConfig(slots=2),
                            spmd=True, nranks=4, device="cpu")
        # One row per rank: the shards, and the cache NaN-poisoned.
        assert eng._shards["blocks"][0]["wo"].shape == (4, 4, 16)
        assert eng._cache[0]["k"].shape == (4, 2, 24, 1, 4)
        assert torch.isnan(eng._cache[0]["k"]).all()
        eng.submit(PROMPTS[0], max_new=BUDGETS[0])
        eng.step()
        k = eng._cache[0]["k"]
        assert not torch.isnan(k[:, 0, :len(PROMPTS[0]) + 1]).any()
        # A free slot decodes a garbage row at position 0 (as in the JAX
        # package); the rest of its row stays poisoned.
        assert torch.isnan(k[:, 1, 1:]).all()
        eng.run()
        assert torch.isnan(eng._cache[0]["k"][:, 0]).all()


class TestDeadlinesAndShedding:
    @pytest.mark.parametrize("world", ["spmd4", "mesh2x4"])
    def test_deadline_evictions_bitwise_vs_oracle(self, model, world):
        jcfg, jparams, pcfg, pparams = model
        t = [0.0]
        eng = pserve.Engine(pcfg, pparams, pserve.ServeConfig(slots=2),
                            clock=lambda: t[0], device="cpu",
                            **_spmd_kw(world))
        eng.submit(PROMPTS[0], max_new=BUDGETS[0], deadline_s=2.5)
        eng.submit(PROMPTS[1], max_new=BUDGETS[1])
        eng.submit(PROMPTS[2], max_new=BUDGETS[2])
        eng.submit(PROMPTS[3], max_new=BUDGETS[3], deadline_s=1.5)
        expired = []
        for _ in range(32):
            expired += eng.step()["expired"]
            t[0] += 1.0
            if not eng.pending():
                break
        res, st = eng.results(), eng.statuses()
        want = _oracle(jcfg, jparams)
        assert sorted(expired) == [0, 3]
        assert st[0] == st[3] == pserve.STATUS_EXPIRED
        assert st[1] == st[2] == pserve.STATUS_OK
        assert res[1].tolist() == want[1] and res[2].tolist() == want[2]
        got0 = res[0].tolist()
        assert len(PROMPTS[0]) < len(got0) < len(want[0])
        assert got0 == want[0][:len(got0)]
        assert res[3].tolist() == PROMPTS[3].tolist()


class TestPagedOracleParity:
    @pytest.mark.parametrize("world", ["spmd4", "mesh2x4"])
    def test_paged_tokens_equal_generate(self, model, world):
        jcfg, jparams, pcfg, pparams = model
        eng = pserve.Engine(pcfg, pparams,
                            pserve.ServeConfig(overlap=True, **PAGED_TIGHT),
                            device="cpu", **_spmd_kw(world))
        assert _drive(eng) == _oracle(jcfg, jparams)
        snap = eng.stats.snapshot()
        assert snap["finished"] == len(PROMPTS)

    @pytest.mark.parametrize("chunk", [1, 3])
    def test_chunked_prefill(self, model, chunk):
        jcfg, jparams, pcfg, pparams = model
        eng = pserve.Engine(pcfg, pparams,
                            pserve.ServeConfig(slots=2, block_size=4,
                                               prefill_chunk=chunk),
                            spmd=True, nranks=4, device="cpu")
        assert _drive(eng) == _oracle(jcfg, jparams)
        assert eng.stats.snapshot()["prefill_tokens"] >= sum(
            len(p) for p in PROMPTS)

    def test_prefix_sharing_and_sampled(self, model):
        jcfg, jparams, pcfg, pparams = model
        jkeys = [jax.random.PRNGKey(7 + i) for i in range(len(PROMPTS))]
        eng = pserve.Engine(pcfg, pparams,
                            pserve.ServeConfig(slots=2, block_size=4,
                                               temperature=0.8, top_k=5),
                            spmd=True, nranks=4, device="cpu")
        got = _drive(eng, [np.asarray(k) for k in jkeys])
        assert got == _oracle(jcfg, jparams, 0.8, 5, jkeys)
        # The same prompt again hits its own pages, a partly matched tail
        # page copied on write; its tokens are generate()'s again.
        eng.submit(PROMPTS[0], rid=10, max_new=BUDGETS[0],
                   key=np.asarray(jkeys[0]))
        again = eng.run()[10].tolist()
        snap = eng.stats.snapshot()
        assert snap["prefix_hits"] >= 1 and snap["cow_copies"] >= 1
        assert again == got[0]


class TestPagedNoRetrace:
    def test_one_step_program_across_table_states(self, model):
        # One run_spmd step function serves every table state (the table
        # is data), and the recorded decode programs of two table states
        # hold the same collectives (JAX: the identical program text; the
        # port's host-side page gathers differ, so event indices do).
        import dataclasses

        from mpi4torch_tpu_torch import analyze
        jcfg, jparams, pcfg, pparams = model
        eng = pserve.Engine(pcfg, pparams,
                            pserve.ServeConfig(slots=2, block_size=4,
                                               overlap=True),
                            spmd=True, nranks=4, device="cpu")
        call = eng._step_call
        eng.submit(PROMPTS[0], max_new=6)
        eng.step()
        t1 = eng._table.copy()
        p1 = eng.lower_step()
        eng.submit(PROMPTS[1], max_new=4)
        eng.step()
        assert eng._step_call is call and not np.array_equal(t1, eng._table)
        p2 = eng.lower_step()
        assert [dataclasses.replace(op, line=0) for op in p1.collectives] \
            == [dataclasses.replace(op, line=0) for op in p2.collectives]
        assert analyze.run_lints(p1) == analyze.run_lints(p2) == []
        res = eng.run()
        want = _oracle(jcfg, jparams)
        assert res[0].tolist() == want[0] and res[1].tolist() == want[1]


class TestCrossModeBitwise:
    def test_decode_step_tp_det_mode_a_vs_b(self, model):
        _, _, pcfg, pparams = model
        tokens = torch.tensor([3, 5, 7])
        pos = torch.tensor([0, 1, 2])
        cache0 = pkv.init_kv_cache_tp(pcfg, 3, 4, torch.float64, "cpu")
        stacked = [{k: v.unsqueeze(0).expand((4,) + v.shape).contiguous()
                    for k, v in c.items()} for c in cache0]
        with P.config.deterministic_mode():
            def step_a(cache, t, p):
                comm = P.COMM_WORLD
                sh = pkv.shard_params_tp(pcfg, pparams, comm)
                local = [{k: v[comm.rank].clone() for k, v in c.items()}
                         for c in cache]
                return pkv.decode_step_tp(pcfg, sh, local, t, p, comm,
                                          overlap=True)[0]

            la = P.run_spmd(step_a, nranks=4, device="cpu")(stacked, tokens,
                                                             pos)

            def rank_fn():
                comm = P.COMM_WORLD
                sh = pkv.shard_params_tp(pcfg, pparams, comm)
                local = pkv.init_kv_cache_tp(pcfg, 3, 4, torch.float64,
                                             "cpu")
                return pkv.decode_step_tp(pcfg, sh, local, tokens, pos,
                                          comm, overlap=True)[0]

            lb = P.run_ranks(rank_fn, 4, device="cpu")
        for r in range(4):
            assert torch.equal(la[r], lb[r])

