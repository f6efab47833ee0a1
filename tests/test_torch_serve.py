"""The port's serving engine against the JAX package's.

Six requests through two slots, so admission and eviction churn is real,
ending at EOS or at their budgets.  On the size-1 world and on (2,) and
(4,) tensor-parallel rank-thread worlds, in float64 with the JAX weights
carried across, the port's ``Engine`` emits exactly the tokens of the JAX
``models/transformer.generate`` per request and of the JAX
``serve.Engine`` on the same world size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import serve as jserve
from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu_torch import serve as pserve
from mpi4torch_tpu_torch.models import transformer as PT

CFG = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=32)
CFG_ROPE_GQA = dict(CFG, norm="rmsnorm", ffn="swiglu", rope=True,
                    n_kv_heads=2, attn_window=6)
# Two prompt lengths and one budget keep the JAX side's compilations few;
# EOS still ends some requests early, so slots free at different steps.
PROMPTS = [np.array([1, 2, 3]), np.array([4, 5, 6, 7, 8]),
           np.array([9, 10, 11]), np.array([12, 13, 14, 15, 16]),
           np.array([17, 18, 19]), np.array([20, 21, 22, 23, 24])]
BUDGETS = [6] * len(PROMPTS)


def _weights(kw, seed=0):
    jcfg = JT.TransformerConfig(**kw)
    jparams = JT.init_transformer(jax.random.PRNGKey(seed), jcfg,
                                  dtype=jnp.float64)
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, PT.TransformerConfig(**kw), pparams


def _oracle(jcfg, jparams, eos):
    out = []
    for p, n in zip(PROMPTS, BUDGETS):
        seq = np.asarray(JT.generate(jcfg, jparams,
                                     jnp.asarray(p, jnp.int32)[None], n,
                                     dtype=jnp.float64)[0])
        if eos is not None:
            hits = np.where(seq[len(p):] == eos)[0]
            if hits.size:
                seq = seq[:len(p) + hits[0] + 1]
        out.append(seq.tolist())
    return out


def _pick_eos(jcfg, jparams):
    """A token the first request emits mid-budget, so EOS really ends a
    request early."""
    seq = np.asarray(JT.generate(jcfg, jparams,
                                 jnp.asarray(PROMPTS[0], jnp.int32)[None],
                                 BUDGETS[0], dtype=jnp.float64)[0])
    return int(seq[len(PROMPTS[0]) + 2])


def _drive(eng):
    for p, n in zip(PROMPTS, BUDGETS):
        eng.submit(p, max_new=n)
    res = eng.run()
    return [res[i].tolist() for i in range(len(PROMPTS))], \
        eng.stats.snapshot()


def _port_run(pcfg, pparams, scfg, nranks):
    def body():
        return _drive(pserve.Engine(pcfg, pparams, scfg, device="cpu"))

    if nranks == 1:
        return [body()]
    return P.run_ranks(body, nranks, device="cpu")


def _jax_run(jcfg, jparams, scfg, nranks):
    def body():
        eng = jserve.Engine(jcfg, jparams, scfg)
        for p, n in zip(PROMPTS, BUDGETS):
            eng.submit(p, max_new=n)
        res = eng.run()
        return [res[i].tolist() for i in range(len(PROMPTS))]

    return body() if nranks == 1 else mpi.run_ranks(body, nranks)[0]


@pytest.fixture(scope="module")
def weights():
    jcfg, jparams, pcfg, pparams = _weights(CFG)
    eos = _pick_eos(jcfg, jparams)
    return jcfg, jparams, pcfg, pparams, eos, _oracle(jcfg, jparams, eos)


@pytest.mark.parametrize("nranks", [1, 2, 4])
def test_engine_tokens_equal_jax_generate_and_engine(weights, nranks):
    jcfg, jparams, pcfg, pparams, eos, oracle = weights
    kw = dict(slots=2, max_new=8, eos=eos)
    runs = _port_run(pcfg, pparams, pserve.ServeConfig(**kw), nranks)
    for tokens, _ in runs:
        assert tokens == oracle           # every rank, every request
    assert any(len(t) < len(p) + n
               for t, p, n in zip(oracle, PROMPTS, BUDGETS))   # eos hit
    assert _jax_run(jcfg, jparams, jserve.ServeConfig(**kw), nranks) \
        == oracle
    stats = runs[0][1]
    assert stats["admitted"] == stats["finished"] == len(PROMPTS)
    assert stats["evicted"] <= stats["finished"]
    assert stats["decode_tokens"] == sum(len(t) - len(p) - 1
                                         for t, p in zip(oracle, PROMPTS))
    assert 0 < stats["occupancy"] <= 1
    assert stats["ttft_s"]["p50"] <= stats["ttft_s"]["p99"]


@pytest.fixture(scope="module")
def rope_weights():
    jcfg, jparams, pcfg, pparams = _weights(CFG_ROPE_GQA, seed=1)
    return pcfg, pparams, _oracle(jcfg, jparams, None)


@pytest.mark.parametrize("policy", sorted(pserve.POLICIES))
def test_rope_gqa_window_engine_matches_generate(rope_weights, policy):
    pcfg, pparams, oracle = rope_weights
    (tokens, _), = _port_run(pcfg, pparams,
                             pserve.ServeConfig(slots=2, max_new=8,
                                                policy=policy), 1)
    assert tokens == oracle


def test_free_slots_are_poisoned_and_inert(weights):
    _, _, pcfg, pparams, _, _ = weights
    eng = pserve.Engine(pcfg, pparams, pserve.ServeConfig(slots=3),
                        device="cpu")
    eng.submit(PROMPTS[1], max_new=4)
    eng.step()
    # A free slot writes its garbage row at position 0 (as in the JAX
    # package); every later row stays NaN, and the row guard keeps the
    # poison out of the residual stream, so no logit row is NaN.
    assert torch.isnan(eng._cache[0]["k"][1:, 1:]).all()
    assert torch.isfinite(eng.last_logits).all()


@pytest.mark.parametrize("kw", [
    dict(slots=0), dict(max_new=0), dict(policy="lifo"),
    dict(temperature=-1.0), dict(queue_limit=-1), dict(shed_policy="x"),
    dict(block_size=-1), dict(num_blocks=0), dict(prefill_chunk=4),
    dict(block_size=4, prefill_chunk=0),
])
def test_serve_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jserve.ServeConfig(**kw)
    with pytest.raises(ValueError) as perr:
        pserve.ServeConfig(**kw)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    dict(serve_cfg=pserve.ServeConfig(temperature=0.5)),
    dict(serve_cfg=pserve.ServeConfig(block_size=4)),
    dict(serve_cfg=pserve.ServeConfig(overlap=True)),
    dict(serve_cfg=pserve.ServeConfig(algorithm="tree")),
    dict(spmd=True),
])
def test_unported_engine_options_raise(weights, kw):
    # Sampling, paging and the SPMD engine still raise; the overlap
    # window and the decode schedule are ported and must give the
    # blocking ring engine's tokens (here on two ranks).
    _, _, pcfg, pparams, eos, oracle = weights
    scfg = kw.get("serve_cfg")
    if scfg is not None and (scfg.overlap or scfg.algorithm):
        scfg = dataclasses.replace(scfg, slots=2, max_new=8, eos=eos)
        for tokens, _ in _port_run(pcfg, pparams, scfg, 2):
            assert tokens == oracle
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pserve.Engine(pcfg, pparams, device="cpu", **kw)


def test_queue_full_and_shed(weights):
    _, _, pcfg, pparams, _, _ = weights
    eng = pserve.Engine(pcfg, pparams,
                        pserve.ServeConfig(slots=1, queue_limit=0),
                        device="cpu")
    eng.submit(PROMPTS[0])
    with pytest.raises(pserve.QueueFullError):
        eng.submit(PROMPTS[1])
    assert eng.stats.counters["rejected"] == 1
    shed = pserve.Engine(pcfg, pparams,
                         pserve.ServeConfig(slots=1, queue_limit=0,
                                            shed_policy="drop_oldest"),
                         device="cpu")
    first = shed.submit(PROMPTS[0])
    shed.submit(PROMPTS[1])
    assert shed.status(first) == pserve.STATUS_SHED


def test_deadline_keeps_an_oracle_prefix(weights):
    _, _, pcfg, pparams, _, _ = weights
    full = PT.generate(pcfg, pparams, torch.as_tensor(PROMPTS[0])[None],
                       BUDGETS[0])[0].tolist()
    now = [0.0]
    eng = pserve.Engine(pcfg, pparams, pserve.ServeConfig(slots=1),
                        clock=lambda: now[0], device="cpu")
    rid = eng.submit(PROMPTS[0], max_new=BUDGETS[0], deadline_s=2.5)
    for _ in range(3):
        eng.step()
        now[0] += 1.0
    eng.step()
    assert eng.status(rid) == pserve.STATUS_EXPIRED
    got = eng.results()[rid].tolist()
    assert got == full[:len(got)] and len(PROMPTS[0]) < len(got) < len(full)


def test_tp_world_must_divide_heads(weights):
    _, _, pcfg, pparams, _, _ = weights
    with pytest.raises(P.CommError, match="whole-head"):
        P.run_ranks(lambda: pserve.Engine(pcfg, pparams, device="cpu"), 3,
                    device="cpu")


def test_submit_validation(weights):
    _, _, pcfg, pparams, _, _ = weights
    eng = pserve.Engine(pcfg, pparams, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.submit(np.arange(30), max_new=4)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(np.array([], np.int64))
    rid = eng.submit(PROMPTS[0], rid="a")
    with pytest.raises(ValueError, match="already in use"):
        eng.submit(PROMPTS[1], rid=rid)
    eng.run()
    assert list(eng.pop_results()) == ["a"]
    assert eng.results() == {}
    assert eng.submit(PROMPTS[1], rid="a") == "a"


def test_moe_refused(weights):
    cfg = PT.TransformerConfig(**dict(CFG, n_experts=2, capacity=2))
    _, _, _, pparams, _, _ = weights
    with pytest.raises(P.CommError, match="MoE"):
        pserve.Engine(cfg, pparams, device="cpu")


def test_cache_dtype_override(weights):
    _, _, pcfg, pparams, _, _ = weights
    eng = pserve.Engine(pcfg, pparams,
                        pserve.ServeConfig(cache_dtype=torch.float32),
                        device="cpu")
    assert eng._cache[0]["k"].dtype == torch.float32
    eng.submit(PROMPTS[0], max_new=3)
    assert len(eng.run()[0]) == len(PROMPTS[0]) + 3


def test_single_rank_serving_path_equals_prefill(weights):
    # At size 1 the TP prefill is the transformer's prefill, bit for bit.
    _, _, pcfg, pparams, _, _ = weights
    prompt = torch.as_tensor(PROMPTS[4])[None]
    shards = pserve.shard_params_tp(pcfg, pparams, P.COMM_WORLD)
    a, _ = pserve.prefill_tp(
        pcfg, shards, pserve.init_kv_cache_tp(pcfg, 1, 1, torch.float64,
                                              "cpu"), prompt, P.COMM_WORLD)
    b, _ = PT.prefill(pcfg, pparams,
                      PT.init_kv_cache(pcfg, 1, torch.float64, "cpu"),
                      prompt)
    assert torch.equal(a, b)
    assert dataclasses.is_dataclass(pserve.ServeConfig())


@pytest.mark.parametrize("kw", [dict(overlap=True), dict(algorithm="rhd"),
                                dict(overlap=3, algorithm="rhd")],
                         ids=["overlap", "rhd", "overlap3_rhd"])
def test_decode_overlap_and_schedule_match_the_blocking_ring(weights, kw):
    # TP=2: decode_step_tp's logits through the split-phase chunk window
    # and/or the rhd schedule are bitwise the blocking ring's (on two
    # ranks every schedule is the one addition, and the chunks split an
    # elementwise sum); the engine emits the oracle's tokens, as the JAX
    # engine does with the same ServeConfig.
    jcfg, jparams, pcfg, pparams, eos, oracle = weights

    def body():
        c = P.COMM_WORLD
        shards = pserve.shard_params_tp(pcfg, pparams, c)
        outs = []
        for dkw in (dict(), kw):
            cache = pserve.init_kv_cache_tp(pcfg, 2, c.size, torch.float64,
                                            "cpu")
            for t in range(3):
                logits, cache = pserve.decode_step_tp(
                    pcfg, shards, cache, torch.tensor([5 + t, 9 + t]),
                    torch.tensor([t, t]), c, **dkw)
            outs.append(logits)
        return torch.equal(outs[0], outs[1])

    assert all(P.run_ranks(body, 2, device="cpu"))
    scfg = dict(slots=2, max_new=8, eos=eos, **kw)
    for tokens, _ in _port_run(pcfg, pparams, pserve.ServeConfig(**scfg), 2):
        assert tokens == oracle
    assert _jax_run(jcfg, jparams, jserve.ServeConfig(**scfg), 2) == oracle
