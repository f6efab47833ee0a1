"""The port's transformer against the JAX package's, on the same weights.

A small JAX configuration (2 layers, d_model 64, 4 heads; one variant
with four MoE experts) is initialised with ``jax.random``, its parameter
tree carried across with ``params_from_jax``, and both packages run in
float64 on the CPU: ``prefill`` and ``decode_step`` logits agree to 1e-10
absolute, and greedy ``generate`` emits the same tokens (the MoE config
through the dense experts).

Sequence and expert parallelism run on 2 rank threads of each package
(the JAX side on its own rank threads, op by op, as its eager SP tests
do): ``lm_loss`` and ``train_step`` under ``attn="ring"``, ``"zigzag"``
and ``"ulysses"`` (learned positions, and rope with GQA and a window),
and the MoE ``train_step`` over ``comm_ep``, agree with the JAX
package's to 1e-10 (loss and every updated parameter), every rank ends
bitwise identical, and the sp loss equals the single-device loss on the
whole sequence to 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu_torch.models import transformer as PT
from mpi4torch_tpu_torch.utils.tree import tree_leaves

BASE = dict(vocab=61, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=32)
CONFIGS = {
    "layernorm_gelu_mha": BASE,
    "rmsnorm_swiglu_rope_gqa_window": dict(
        BASE, norm="rmsnorm", ffn="swiglu", rope=True, n_kv_heads=2,
        attn_window=5),
    # Capacity large enough that no call's routing drops a token, so
    # prefill and decode route alike.
    "layernorm_moe": dict(BASE, n_experts=4, capacity=32),
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
    blk = p["blocks"][0]
    w = blk["moe"]["w1"][0] if "moe" in blk else blk["w1"]
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
    # MoE models train and decode; serving them is refused, as in the
    # JAX package (serve/kv.py validate_tp).
    from mpi4torch_tpu_torch import serve

    cfg = PT.TransformerConfig(**dict(BASE, n_experts=2, capacity=4))
    params = PT.init_transformer(0, cfg, device="cpu")
    assert set(params["blocks"][0]["moe"]) == {"gate", "w1", "b1", "w2",
                                               "b2"}
    with pytest.raises(P.CommError, match="MoE"):
        serve.Engine(cfg, params, device="cpu")


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


def test_moe_params_round_trip():
    _, jparams, _, pparams = _pair("layernorm_moe")
    back = PT.params_to_numpy(pparams)
    jleaves = jax.tree.leaves(jparams)
    assert len(tree_leaves(back)) == len(jleaves)
    for a, b in zip(tree_leaves(back), jleaves):
        assert np.array_equal(a, np.asarray(b))
    assert back["blocks"][1]["moe"]["w1"].shape == (4, 64, 128)


def test_moe_generate_is_the_stepwise_argmax_of_forward():
    _, _, pcfg, pparams = _pair("layernorm_moe")
    prompt = torch.from_numpy(_prompt(5))
    out = PT.generate(pcfg, pparams, prompt, 6)
    seq = prompt
    for _ in range(6):
        nxt = PT.forward(pcfg, pparams, seq)[:, -1].argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert torch.equal(out, seq)


# ------------------------------------------- sequence and expert parallel

SP_CONFIGS = {
    "learned_pos": BASE,
    "rope_gqa": dict(BASE, rope=True, n_kv_heads=2),
    "rope_gqa_window": CONFIGS["rmsnorm_swiglu_rope_gqa_window"],
}
SP, B_SP, S_SP = 2, 2, 16


def _sp_pair(name):
    kw = SP_CONFIGS[name]
    jcfg, pcfg = JT.TransformerConfig(**kw), PT.TransformerConfig(**kw)
    jparams = JT.init_transformer(jax.random.PRNGKey(3), jcfg,
                                  dtype=jnp.float64)
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, pcfg, pparams


def _local_tokens(tokens, attn, r):
    if attn == "zigzag":
        from mpi4torch_tpu_torch.parallel import zigzag_positions

        return tokens[:, zigzag_positions(SP, S_SP // SP)[r]]
    sl = S_SP // SP
    return tokens[:, r * sl:(r + 1) * sl]


def _close_trees(got, want, tol):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("name, attn", [
    ("learned_pos", "ring"), ("learned_pos", "zigzag"),
    ("learned_pos", "ulysses"), ("rope_gqa", "zigzag"),
    ("rope_gqa_window", "ring"), ("rope_gqa_window", "ulysses")])
def test_sp_train_step_matches_jax(name, attn):
    jcfg, jparams, pcfg, pparams = _sp_pair(name)
    tokens = np.random.default_rng(4).integers(0, BASE["vocab"],
                                               (B_SP, S_SP))

    def jbody(r):
        local = jnp.asarray(_local_tokens(tokens, attn, r))
        loss = JT.lm_loss(jcfg, jparams, local, comm_sp=mpi.COMM_WORLD,
                          attn=attn, vocab_chunk=0)
        tloss, new = JT.train_step(jcfg, jparams, local,
                                   comm_sp=mpi.COMM_WORLD, attn=attn,
                                   lr=0.1)
        return float(loss), float(tloss), jax.tree.map(np.asarray, new)

    def pbody(r):
        local = torch.from_numpy(_local_tokens(tokens, attn, r))
        loss = PT.lm_loss(pcfg, pparams, local, comm_sp=P.COMM_WORLD,
                          attn=attn)
        chunked = PT.lm_loss(pcfg, pparams, local, comm_sp=P.COMM_WORLD,
                             attn=attn, vocab_chunk=61)
        tloss, new = PT.train_step(pcfg, pparams, local,
                                   comm_sp=P.COMM_WORLD, attn=attn, lr=0.1)
        return (loss.item(), tloss.item(), PT.params_to_numpy(new),
                chunked.item())

    ref = mpi.run_ranks(jbody, SP)
    got = P.run_ranks(pbody, SP, device="cpu")
    single = PT.lm_loss(pcfg, pparams, torch.from_numpy(tokens)).item()
    for r in range(SP):
        np.testing.assert_allclose(got[r][0], ref[r][0], rtol=1e-10)
        np.testing.assert_allclose(got[r][1], ref[r][1], rtol=1e-10)
        _close_trees(got[r][2], ref[r][2], 1e-10)
        np.testing.assert_allclose(got[r][0], single, rtol=1e-12)
        assert got[r][3] == got[r][0]
        # Both sp ranks end bitwise identical.
        assert got[r][1] == got[0][1]
        for a, b in zip(tree_leaves(got[r][2]), tree_leaves(got[0][2])):
            assert np.array_equal(a, b)


def test_sp_vocab_chunk_loss_matches_jax():
    tokens = np.random.default_rng(5).integers(0, BASE["vocab"],
                                               (B_SP, S_SP))
    cfg = dict(BASE, vocab=64)
    jcfg, pcfg = JT.TransformerConfig(**cfg), PT.TransformerConfig(**cfg)
    jparams = JT.init_transformer(jax.random.PRNGKey(3), jcfg,
                                  dtype=jnp.float64)
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")

    def jbody(r):
        return float(JT.lm_loss(jcfg, jparams, jnp.asarray(
            _local_tokens(tokens, "ring", r)), comm_sp=mpi.COMM_WORLD,
            attn="ring", vocab_chunk=16))

    def pbody(r):
        return PT.lm_loss(pcfg, pparams, torch.from_numpy(
            _local_tokens(tokens, "ring", r)), comm_sp=P.COMM_WORLD,
            attn="ring", vocab_chunk=16).item()

    for a, b in zip(P.run_ranks(pbody, SP, device="cpu"),
                    mpi.run_ranks(jbody, SP)):
        np.testing.assert_allclose(a, b, rtol=1e-10)


def test_sp_forward_refuses_a_global_length_past_max_seq():
    cfg = PT.TransformerConfig(**dict(BASE, max_seq=16))
    params = PT.init_transformer(0, cfg, torch.float64, device="cpu")
    rcfg = dataclasses.replace(cfg, rope=True)
    rparams = PT.init_transformer(0, rcfg, torch.float64, device="cpu")

    def body():
        tok = torch.zeros((1, 12), dtype=torch.int64)
        with pytest.raises(ValueError, match="exceeds cfg.max_seq"):
            PT.forward(cfg, params, tok, comm_sp=P.COMM_WORLD)
        # Rope has no position table and no cap.
        return PT.forward(rcfg, rparams, tok, comm_sp=P.COMM_WORLD).shape

    assert P.run_ranks(body, SP, device="cpu") == [(1, 12, 61)] * SP


def test_moe_ep_train_step_matches_jax():
    kw = dict(BASE, n_experts=4, capacity=6)
    jcfg, pcfg = JT.TransformerConfig(**kw), PT.TransformerConfig(**kw)
    jparams = JT.init_transformer(jax.random.PRNGKey(2), jcfg,
                                  dtype=jnp.float64)
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(6).integers(0, BASE["vocab"], (4, 8))

    def jbody(r):
        local = jnp.asarray(tokens[2 * r:2 * r + 2])
        loss, new = JT.train_step(jcfg, jparams, local,
                                  comm_ep=mpi.COMM_WORLD, lr=0.1)
        return float(loss), jax.tree.map(np.asarray, new)

    def pbody(r):
        local = torch.from_numpy(tokens[2 * r:2 * r + 2])
        loss, new = PT.train_step(pcfg, pparams, local,
                                  comm_ep=P.COMM_WORLD, lr=0.1)
        _, aux = PT.forward(pcfg, pparams, local, comm_ep=P.COMM_WORLD,
                            return_aux=True)
        return loss.item(), PT.params_to_numpy(new), aux.item()

    ref = mpi.run_ranks(jbody, 2)
    got = P.run_ranks(pbody, 2, device="cpu")
    for r in range(2):
        np.testing.assert_allclose(got[r][0], ref[r][0], rtol=1e-10)
        _close_trees(got[r][1], ref[r][1], 1e-10)
        assert got[r][0] == got[0][0]
        for a, b in zip(tree_leaves(got[r][1]), tree_leaves(got[0][1])):
            assert np.array_equal(a, b)
        assert got[r][2] > 0
    # The ep step is the mean of the two shards' dense-expert losses (the
    # capacity applies per source rank).
    dense = [PT.lm_loss(pcfg, pparams, torch.from_numpy(
        tokens[2 * r:2 * r + 2])).item() for r in range(2)]
    np.testing.assert_allclose(got[0][0], sum(dense) / 2, rtol=1e-12)


def test_zero_steps_accept_comm_sp():
    # With every rank both an sp and a dp rank, the dp mean of the (equal)
    # sp gradients is that gradient: ZeRO-1 and ZeRO-3 with SGD give the
    # sp train_step's parameters.
    from mpi4torch_tpu_torch.parallel.zero import zero3_init, zero3_params, \
        zero_init
    from mpi4torch_tpu_torch.utils.optim import sgd

    _, _, pcfg, pparams = _sp_pair("learned_pos")
    tokens = np.random.default_rng(7).integers(0, BASE["vocab"],
                                               (B_SP, S_SP))

    def body(r):
        c, opt = P.COMM_WORLD, sgd(0.1)
        local = torch.from_numpy(_local_tokens(tokens, "ring", r))
        want_loss, want = PT.train_step(pcfg, pparams, local, comm_sp=c,
                                        lr=0.1)
        loss1, new1, _ = PT.zero_train_step(
            pcfg, pparams, local, opt, zero_init(c, opt, pparams), c,
            comm_sp=c)
        shards, state = zero3_init(c, opt, pparams)
        loss3, new3, _ = PT.zero3_train_step(pcfg, shards, pparams, local,
                                             opt, state, c, comm_sp=c)
        new3 = zero3_params(c, new3, pparams)
        return [x.item() for x in (want_loss, loss1, loss3)], [
            PT.params_to_numpy(t) for t in (want, new1, new3)]

    for losses, trees in P.run_ranks(body, SP, device="cpu"):
        np.testing.assert_allclose(losses[1:], [losses[0]] * 2, rtol=1e-14)
        for tree in trees[1:]:
            for a, b in zip(tree_leaves(tree), tree_leaves(trees[0])):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)
