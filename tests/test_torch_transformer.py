"""The port's transformer against the JAX package's, on the same weights.

A small JAX configuration is initialised with ``jax.random``, its
parameter tree carried across with ``params_from_jax``, and both packages
run in float64 on the CPU: ``prefill`` and ``decode_step`` logits agree
to 1e-10 absolute, and greedy ``generate`` emits the same tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu_torch.models import transformer as PT

BASE = dict(vocab=61, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=32)
CONFIGS = {
    "layernorm_gelu_mha": BASE,
    "rmsnorm_swiglu_rope_gqa_window": dict(
        BASE, norm="rmsnorm", ffn="swiglu", rope=True, n_kv_heads=2,
        attn_window=5),
}


def _pair(name, seed=0):
    kw = CONFIGS[name]
    jcfg, pcfg = JT.TransformerConfig(**kw), PT.TransformerConfig(**kw)
    jparams = JT.init_transformer(jax.random.PRNGKey(seed), jcfg,
                                  dtype=jnp.float64)
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, pcfg, pparams


def _prompt(n, seed=1, vocab=61):
    return np.random.default_rng(seed).integers(0, vocab, (2, n))


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_logits_match(name):
    jcfg, jparams, pcfg, pparams = _pair(name)
    prompt = _prompt(9)
    jlog, jcache = JT.prefill(jcfg, jparams,
                              JT.init_kv_cache(jcfg, 2, jnp.float64),
                              jnp.asarray(prompt, jnp.int32))
    plog, pcache = PT.prefill(pcfg, pparams,
                              PT.init_kv_cache(pcfg, 2, torch.float64,
                                               "cpu"),
                              torch.from_numpy(prompt))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=1e-10,
                               rtol=0)
    # Teacher-force the same tokens through both decoders past the
    # window, so the sliding-window bucket slice is exercised.
    toks = np.random.default_rng(2).integers(0, 61, (8, 2))
    for i, t in enumerate(toks):
        jlog, jcache = JT.decode_step(jcfg, jparams, jcache,
                                      jnp.asarray(t, jnp.int32), 9 + i)
        plog, pcache = PT.decode_step(pcfg, pparams, pcache,
                                      torch.from_numpy(t), 9 + i)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=1e-10, rtol=0)
    for jl, pl in zip(jcache, pcache):
        np.testing.assert_allclose(pl["k"].numpy(), np.asarray(jl["k"]),
                                   atol=1e-10, rtol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_generate_tokens_equal(name):
    jcfg, jparams, pcfg, pparams = _pair(name, seed=3)
    prompt = _prompt(6, seed=4)
    ref = JT.generate(jcfg, jparams, jnp.asarray(prompt, jnp.int32), 10)
    got = PT.generate(pcfg, pparams, torch.from_numpy(prompt), 10)
    assert got.tolist() == np.asarray(ref).tolist()


@pytest.mark.parametrize("name", CONFIGS)
def test_init_matches_jax_shapes(name):
    jcfg, jparams, pcfg, _ = _pair(name)
    p = PT.init_transformer(0, pcfg, torch.float64, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    pshapes = jax.tree.map(lambda t: tuple(t.shape), p)
    assert pshapes == jshapes
    # The same scalings: embeddings at 0.02, matrices at 1/sqrt(fan_in).
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    w = p["blocks"][0]["w1"]
    assert abs(w.std().item() * np.sqrt(w.shape[0]) - 1.0) < 0.05


def test_init_is_seeded():
    cfg = PT.TransformerConfig(**BASE)
    a = PT.init_transformer(5, cfg, device="cpu")
    b = PT.init_transformer(torch.Generator().manual_seed(5), cfg,
                            device="cpu")
    assert torch.equal(a["blocks"][1]["wqkv"], b["blocks"][1]["wqkv"])


def test_params_from_jax_casts():
    _, jparams, pcfg, _ = _pair("layernorm_gelu_mha")
    p = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                           torch.float32)
    assert p["blocks"][0]["wqkv"].dtype == torch.float32
    assert p["ln_f"]["bias"].shape == (pcfg.d_model,)


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.init_transformer(0, PT.TransformerConfig(**BASE))


@pytest.mark.parametrize("bad", [
    dict(n_kv_heads=3), dict(attn_window=-1), dict(norm="batchnorm"),
    dict(ffn="relu"), dict(n_experts=2), dict(d_model=30, rope=True,
                                              n_heads=10),
    dict(n_experts=2, capacity=4, ffn="swiglu"),
])
def test_config_validation_matches_jax(bad):
    kw = dict(BASE, **bad)
    with pytest.raises(ValueError) as jerr:
        JT.TransformerConfig(**kw)
    with pytest.raises(ValueError) as perr:
        PT.TransformerConfig(**kw)
    assert str(perr.value) == str(jerr.value)


def test_unported_paths_raise():
    cfg = PT.TransformerConfig(**dict(BASE, n_experts=2, capacity=4))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PT.init_transformer(0, cfg, device="cpu")


def test_generate_bounds():
    cfg = PT.TransformerConfig(**BASE)
    p = PT.init_transformer(0, cfg, torch.float64, device="cpu")
    prompt = torch.zeros(1, 30, dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        PT.generate(cfg, p, prompt, 3)
    with pytest.raises(ValueError, match="out of range"):
        PT.decode_step(cfg, p, PT.init_kv_cache(cfg, 1, torch.float64,
                                                "cpu"),
                       torch.zeros(1, dtype=torch.int64), 32)
    assert PT.generate(cfg, p, prompt, 0) is prompt


def test_window_bucket():
    cfg = PT.TransformerConfig(**BASE)
    assert PT._window_bucket(cfg) == 32
    assert PT._window_bucket(dataclasses.replace(cfg, attn_window=5)) == 8
    assert PT._window_bucket(dataclasses.replace(cfg, attn_window=40)) == 32
