"""The port's sequence-parallel attention against the JAX package.

``merge_partials``, ``flash_attention(kv_chunk=...)``, ``dense_attention``,
``ring_attention`` (with and without a sliding window), the zigzag
layout helpers and ``zigzag_ring_attention``, and ``ulysses_attention``
(with grouped-query KV) run on the same numpy inputs through both
packages.  Distributed cases run on 2 and 4 rank threads: the JAX side
on its own rank-thread runtime (``mpi4torch_tpu.run_ranks`` with
``COMM_WORLD``, op by op), the port's on ``run_ranks(device="cpu")``,
where each block runs the plain attention.  Everything is float64;
values and the gradients of ``vdot(out, w_r)`` with respect to each
rank's q, k and v agree with the JAX package's to 1e-12, and with
``dense_attention`` over the full sequence to 1e-10 (the ring sums its
blocks in another order).  ``zigzag_positions``/``zigzag_slice`` are
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.ops import flash as jflash
from mpi4torch_tpu.parallel import attention as JA
from mpi4torch_tpu_torch.ops import _kernels
from mpi4torch_tpu_torch.ops import flash as pflash
from mpi4torch_tpu_torch.parallel import attention as PA

TOL_JAX = 1e-12     # port vs the JAX package, same algorithm
TOL_DENSE = 1e-10   # distributed vs the dense oracle on the full sequence


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


# ----------------------------------------------------------------- merge


def test_merge_partials_values_and_grads_match_jax():
    b, s, h, d = 2, 5, 3, 4
    oa, ob = _rand((b, s, h, d), 0), _rand((b, s, h, d), 1)
    la, lb = _rand((b, s, h), 2) * 3, _rand((b, s, h), 3) * 3
    # A fully masked partial on one side of some rows, and on both.
    la[0, 0] = jflash.NEG_BIG
    lb[1, 2] = jflash.NEG_BIG
    la[1, 3, 0] = lb[1, 3, 0] = jflash.NEG_BIG
    oa[0, 0] = 0.0
    ob[1, 2] = 0.0
    oa[1, 3, 0] = ob[1, 3, 0] = 0.0
    wo, wl = _rand((b, s, h, d), 4), _rand((b, s, h), 5)

    def jf(*args):
        out, lse = jflash.merge_partials(*args)
        return jnp.vdot(out, wo) + jnp.vdot(lse, wl), (out, lse)

    jargs = [jnp.asarray(x) for x in (oa, la, ob, lb)]
    (_, (jo, jl)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                           has_aux=True)(*jargs)
    pargs = [torch.from_numpy(x).requires_grad_() for x in (oa, la, ob, lb)]
    po, pl = pflash.merge_partials(*pargs)
    pg = torch.autograd.grad(
        (po * torch.from_numpy(wo)).sum() + (pl * torch.from_numpy(wl)).sum(),
        pargs)
    _close(po.detach(), jo, TOL_JAX)
    _close(pl.detach(), jl, TOL_JAX)
    assert po[1, 3, 0].abs().max() == 0 and pl[1, 3, 0] == jflash.NEG_BIG
    # Where both partials are masked, logaddexp's derivative is a
    # convention: torch splits the tie (1/2 each), JAX gives each 1.  It
    # reaches no q/k/v there (a masked block's p is 0; see the test of
    # the blocks' gradients below), so only those two entries differ.
    tie = np.zeros((b, s, h), bool)
    tie[1, 3, 0] = True
    for i, (a, bb) in enumerate(zip(pg, jg)):
        assert torch.isfinite(a).all()
        a, bb = a.numpy(), np.asarray(bb)
        if i in (1, 3):
            _close(a[tie], 0.5 * wl[tie], TOL_JAX)
            a, bb = a[~tie], bb[~tie]
        _close(a, bb, TOL_JAX)


def test_merge_partials_block_grads_match_jax():
    # Two KV blocks of a causal shard: rows 0-3 see neither (both wholly
    # masked, the tie above), rows 4-7 only the first.  The gradients of
    # vdot(out, wo) + vdot(lse, wl), a live dlse, reach q, k and v
    # through both blocks' backward as the JAX package's do.
    b, s, h, d = 2, 8, 2, 4
    q = _rand((b, s, h, d), 0)
    ka, va, kb, vb = (_rand((b, 4, h, d), i) for i in (1, 2, 3, 4))
    wo, wl = _rand((b, s, h, d), 5), _rand((b, s, h), 6)

    def jf(q, ka, va, kb, vb):
        oa, la = jflash.flash_block_attention(q, ka, va, causal=True,
                                              kv_offset=4, impl="jnp")
        ob, lb = jflash.flash_block_attention(q, kb, vb, causal=True,
                                              kv_offset=8, impl="jnp")
        out, lse = jflash.merge_partials(oa, la, ob, lb)
        return jnp.vdot(out, wo) + jnp.vdot(lse, wl), out

    args = (q, ka, va, kb, vb)
    (_, jo), jg = jax.value_and_grad(jf, argnums=tuple(range(5)),
                                     has_aux=True)(
        *(jnp.asarray(x) for x in args))
    pq, pka, pva, pkb, pvb = pargs = [torch.from_numpy(x).requires_grad_()
                                      for x in args]
    oa, la = pflash.flash_block_attention(pq, pka, pva, causal=True,
                                          kv_offset=4, impl="torch")
    ob, lb = pflash.flash_block_attention(pq, pkb, pvb, causal=True,
                                          kv_offset=8, impl="torch")
    po, pl = pflash.merge_partials(oa, la, ob, lb)
    assert torch.all(pl[:, :4] == jflash.NEG_BIG)
    pg = torch.autograd.grad(
        (po * torch.from_numpy(wo)).sum() + (pl * torch.from_numpy(wl)).sum(),
        pargs)
    _close(po.detach(), jo, TOL_JAX)
    for a, bb in zip(pg, jg):
        assert torch.isfinite(a).all()
        _close(a, bb, TOL_JAX)
    assert not pg[3].any() and not pg[4].any()   # block b: wholly masked


def test_merge_partials_rounds_to_out_a_dtype():
    o = torch.ones((1, 2, 1, 4), dtype=torch.bfloat16) / 3
    lse = torch.zeros((1, 2, 1))
    out, merged = pflash.merge_partials(o, lse, o * 2, lse)
    assert out.dtype == torch.bfloat16 and merged.dtype == torch.float32
    want = ((o.float() + 2 * o.float()) / 2).to(torch.bfloat16)
    assert torch.equal(out, want)


# ------------------------------------------------------- flash kv_chunk


@pytest.mark.parametrize("causal, window, chunk, impl", [
    (True, 0, 4, "torch"), (False, 0, 6, "torch"), (True, 5, 8, "torch"),
    (True, 0, 128, "auto"), (True, 100, 128, "auto")])
def test_flash_attention_kv_chunk_matches_jax(causal, window, chunk, impl):
    sk = 24 if chunk < 128 else 256
    q, k, v = (_rand((2, sk, 2, 8), s) for s in (0, 1, 2))
    w = _rand(q.shape, 3)
    jimpl = "jnp" if impl == "torch" else "auto"

    def jf(q, k, v):
        out = jflash.flash_attention(q, k, v, causal=causal, impl=jimpl,
                                     kv_chunk=chunk, window=window)
        return jnp.vdot(out, w), out

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    pq, pk, pv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    po = pflash.flash_attention(pq, pk, pv, causal=causal, impl=impl,
                                kv_chunk=chunk, window=window)
    pg = torch.autograd.grad((po * torch.from_numpy(w)).sum(), (pq, pk, pv))
    _close(po.detach(), jo, TOL_JAX)
    for a, b in zip(pg, jg):
        _close(a, b, TOL_JAX)
    # The merged chunks are the one-call result up to the merges' rounding.
    one = pflash.flash_attention(pq, pk, pv, causal=causal, window=window)
    _close(po.detach(), one.detach(), 1e-13)


def test_flash_attention_kv_chunk_refusals():
    q = torch.zeros((1, 256, 1, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="must divide"):
        pflash.flash_attention(q, q, q, kv_chunk=100, impl="torch")
    # A kernel path needs whole 128-row KV tiles per chunk.
    with pytest.raises(ValueError, match="multiple of 128"):
        pflash.flash_attention(q, q, q, kv_chunk=64)
    with pytest.raises(ValueError, match="must divide"):
        pflash.flash_attention(q, q, q, kv_chunk=-128)


@pytest.mark.parametrize("causal", [True, False])
def test_jax_default_chunk_choice_against_the_ports_single_call(causal):
    # At d = 64 in float64 the JAX package's VMEM budget caps one call at
    # 4096 keys, so with kv_chunk=0 its CPU path chunks 8192 keys into
    # two merged halves (_kv_chunk_for); the port makes one call.  Under
    # the causal mask the second half is wholly masked for these 128
    # queries.  The two agree to the merge's rounding: 1e-12.
    q = _rand((1, 128, 1, 64), 0)
    k, v = _rand((1, 8192, 1, 64), 1), _rand((1, 8192, 1, 64), 2)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    assert not jflash._eligible(jq, jk)
    assert jflash._kv_chunk_for(jq, jk) == 4096
    want = jflash.flash_attention(jq, jk, jv, causal=causal)
    got = pflash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal)
    _close(got, want, TOL_JAX)


# ---------------------------------------------------------------- dense


@pytest.mark.parametrize("causal, q_off, kv_off",
                         [(False, 0, 0), (True, 0, 0), (True, 7, 3),
                          (True, 0, 9)])
def test_dense_attention_matches_jax(causal, q_off, kv_off):
    q, k, v = _rand((2, 6, 3, 4), 0), _rand((2, 9, 3, 4), 1), \
        _rand((2, 9, 3, 4), 2)
    want = JA.dense_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=causal, q_offset=q_off,
                              kv_offset=kv_off)
    got = PA.dense_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, q_offset=q_off,
                             kv_offset=kv_off)
    _close(got, want, TOL_JAX)


# ------------------------------------------------------------ the ring


def _global_inputs(n, s_local, h=4, h_kv=4, d=8, b=2):
    s = n * s_local
    return (_rand((b, s, h, d), 10), _rand((b, s, h_kv, d), 11),
            _rand((b, s, h_kv, d), 12), _rand((b, s, h, d), 13))


def _shard(x, r, s_local):
    return x[:, r * s_local:(r + 1) * s_local]


def _jax_grads(fn, ql, kl, vl, wl):
    def f(q, k, v):
        out = fn(mpi.COMM_WORLD, q, k, v)
        return jnp.vdot(out, wl), out

    (_, out), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (ql, kl, vl)))
    return np.asarray(out), [np.asarray(x) for x in g]


def _port_grads(fn, ql, kl, vl, wl):
    ts = [torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
          for x in (ql, kl, vl)]
    out = fn(P.COMM_WORLD, *ts)
    g = torch.autograd.grad((out * torch.from_numpy(
        np.ascontiguousarray(wl))).sum(), ts)
    return out.detach().numpy(), [x.numpy() for x in g]


def _dense_grads(q, k, v, w, window=0):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    if window:
        out, _ = pflash.flash_block_attention(*ts, causal=True,
                                              window=window)
    else:
        out = PA.dense_attention(*ts, causal=True)
    g = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    return out.detach().numpy(), [x.numpy() for x in g]


def _run_both(n, jfn, pfn, shards):
    """Run both packages on ``n`` rank threads; ``shards(r)`` gives rank
    r's (q, k, v, w)."""
    ref = mpi.run_ranks(lambda r: _jax_grads(jfn, *shards(r)), n)
    got = P.run_ranks(lambda r: _port_grads(pfn, *shards(r)), n,
                      device="cpu")
    for (go, gg), (ro, rg) in zip(got, ref):
        _close(go, ro, TOL_JAX)
        for a, b in zip(gg, rg):
            _close(a, b, TOL_JAX)
    return got


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("window", [0, 5])
def test_ring_attention_matches_jax_and_dense(n, window):
    s_local = 6
    q, k, v, w = _global_inputs(n, s_local)

    def shards(r):
        return tuple(_shard(x, r, s_local) for x in (q, k, v, w))

    got = _run_both(
        n,
        lambda c, *a: JA.ring_attention(c, *a, causal=True, window=window),
        lambda c, *a: PA.ring_attention(c, *a, causal=True, window=window),
        shards)
    want_out, want_g = _dense_grads(q, k, v, w, window)
    _close(np.concatenate([o for o, _ in got], axis=1), want_out, TOL_DENSE)
    for i in range(3):
        _close(np.concatenate([g[i] for _, g in got], axis=1), want_g[i],
               TOL_DENSE)


@pytest.mark.parametrize("window, s_local, want_steps",
                         [(0, 8, 4), (5, 8, 2), (9, 8, 2), (10, 8, 3),
                          (40, 8, 4)])
def test_ring_window_cuts_the_steps(monkeypatch, window, s_local,
                                    want_steps):
    # The window's cut-off: min(size, ceil((window - 1) / s_local) + 1)
    # block computations and one fewer K/V hop pair, on every rank.
    n = 4
    q, k, v, _ = _global_inputs(n, s_local, b=1)
    calls = {"block": [0] * n, "shift": [0] * n}
    block, shift = PA.flash_block_attention, PA.ring_shift

    def counted_block(*a, **kw):
        calls["block"][P.COMM_WORLD.rank] += 1
        return block(*a, **kw)

    def counted_shift(*a, **kw):
        calls["shift"][P.COMM_WORLD.rank] += 1
        return shift(*a, **kw)

    monkeypatch.setattr(PA, "flash_block_attention", counted_block)
    monkeypatch.setattr(PA, "ring_shift", counted_shift)
    outs = P.run_ranks(lambda r: PA.ring_attention(
        P.COMM_WORLD, *(torch.from_numpy(_shard(x, r, s_local))
                        for x in (q, k, v)),
        causal=True, window=window).numpy(), n, device="cpu")
    assert calls["block"] == [want_steps] * n
    assert calls["shift"] == [2 * (want_steps - 1)] * n
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    want = block(*ts, causal=True, window=window)[0] if window else \
        PA.dense_attention(*ts, causal=True)
    _close(np.concatenate(outs, axis=1), want, TOL_DENSE)


def test_ring_block_wholly_in_the_future_is_neutral():
    # Rank 0 at ring step 1 holds rank 1's block: every key is after every
    # query.  The block gives out = 0, lse = -1e30 and exactly zero
    # gradients, in the port and in the JAX package, and merging it leaves
    # the accumulated partial unchanged.
    s = 6
    q, k, v = _rand((2, s, 2, 4), 0), _rand((2, s, 2, 4), 1), \
        _rand((2, s, 2, 4), 2)
    wo, wl = _rand((2, s, 2, 4), 3), _rand((2, s, 2), 4)
    assert _kernels.block_masked(s, s, 0, s, True)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = pflash.flash_block_attention(*ts, causal=True, q_offset=0,
                                          kv_offset=s)
    jo, jl = jflash.flash_block_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, q_offset=0,
        kv_offset=s, impl="jnp")
    assert torch.equal(o, torch.zeros_like(o)) and np.all(np.asarray(jo) == 0)
    assert torch.all(lse == jflash.NEG_BIG) and np.all(
        np.asarray(jl) == jflash.NEG_BIG)
    g = torch.autograd.grad((o * torch.from_numpy(wo)).sum()
                            + (lse * torch.from_numpy(wl)).sum(), ts)
    for x in g:
        assert torch.equal(x, torch.zeros_like(x))
    o0, l0 = pflash.flash_block_attention(*ts, causal=True)
    mo, ml = pflash.merge_partials(o0, l0, o, lse)
    assert torch.equal(mo, o0) and torch.equal(ml, l0)


@pytest.mark.parametrize("sq, sk, q_off, kv_off, window, masked", [
    (4, 4, 0, 4, 0, True), (4, 4, 0, 3, 0, False), (4, 4, 8, 0, 0, False),
    (4, 4, 8, 0, 5, True), (4, 4, 8, 0, 6, False), (4, 4, 0, 9, 0, True)])
def test_block_masked_rule(sq, sk, q_off, kv_off, window, masked):
    assert _kernels.block_masked(sq, sk, q_off, kv_off, True,
                                 window) is masked
    assert not _kernels.block_masked(sq, sk, q_off, kv_off, False)
    # The rule is the plain attention's: a masked block has no live pair.
    q = torch.ones((1, sq, 1, 2), dtype=torch.float64)
    kv = torch.ones((1, sk, 1, 2), dtype=torch.float64)
    _, lse = pflash.flash_block_attention(q, kv, kv, causal=True,
                                          q_offset=q_off, kv_offset=kv_off,
                                          window=window)
    assert bool(torch.all(lse == jflash.NEG_BIG)) is masked


# --------------------------------------------------------------- zigzag


@pytest.mark.parametrize("n, s_local", [(2, 4), (4, 6), (3, 2)])
def test_zigzag_positions_and_slice_bitwise(n, s_local):
    assert np.array_equal(PA.zigzag_positions(n, s_local),
                          JA.zigzag_positions(n, s_local))
    x = _rand((2, n * s_local, 3), 0)
    ref = mpi.run_ranks(lambda: np.asarray(JA.zigzag_slice(
        mpi.COMM_WORLD, jnp.asarray(x))), n)
    got = P.run_ranks(lambda: PA.zigzag_slice(
        P.COMM_WORLD, torch.from_numpy(x)).numpy(), n, device="cpu")
    pos = PA.zigzag_positions(n, s_local)
    for r in range(n):
        assert np.array_equal(got[r], ref[r])
        assert np.array_equal(got[r], x[:, pos[r]])


def test_zigzag_slice_refuses_uneven_chunks():
    def body():
        with pytest.raises(ValueError, match="2\\*size"):
            PA.zigzag_slice(P.COMM_WORLD, torch.zeros((1, 6)))
        with pytest.raises(ValueError, match="odd s_local"):
            t = torch.zeros((1, 3, 1, 2), dtype=torch.float64)
            PA.zigzag_ring_attention(P.COMM_WORLD, t, t, t)

    P.run_ranks(body, 2, device="cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_ring_attention_matches_jax_and_dense(n):
    s_local = 6
    q, k, v, w = _global_inputs(n, s_local)
    pos = PA.zigzag_positions(n, s_local)

    def shards(r):
        return tuple(x[:, pos[r]] for x in (q, k, v, w))

    got = _run_both(n, JA.zigzag_ring_attention, PA.zigzag_ring_attention,
                    shards)
    perm = np.concatenate(list(pos))
    want_out, want_g = _dense_grads(q, k, v, w)
    _close(np.concatenate([o for o, _ in got], axis=1), want_out[:, perm],
           TOL_DENSE)
    for i in range(3):
        _close(np.concatenate([g[i] for _, g in got], axis=1),
               want_g[i][:, perm], TOL_DENSE)


# -------------------------------------------------------------- ulysses


@pytest.mark.parametrize("n, h, h_kv", [(2, 4, 2), (2, 4, 4), (4, 8, 4)])
def test_ulysses_attention_matches_jax_and_dense(n, h, h_kv):
    s_local = 5
    q, k, v, w = _global_inputs(n, s_local, h=h, h_kv=h_kv)

    def shards(r):
        return tuple(_shard(x, r, s_local) for x in (q, k, v, w))

    kw = dict(causal=True)
    got = _run_both(n, lambda c, *a: JA.ulysses_attention(c, *a, **kw),
                    lambda c, *a: PA.ulysses_attention(c, *a, **kw), shards)
    g = h // h_kv
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = PA.dense_attention(ts[0], ts[1].repeat_interleave(g, 2),
                             ts[2].repeat_interleave(g, 2), causal=True)
    want_g = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    _close(np.concatenate([o for o, _ in got], axis=1), out.detach(),
           TOL_DENSE)
    for i in range(3):
        _close(np.concatenate([gg[i] for _, gg in got], axis=1), want_g[i],
               TOL_DENSE)


def test_ulysses_refuses_heads_off_the_communicator():
    def body():
        q = torch.zeros((1, 2, 4, 2), dtype=torch.float64)
        kv = torch.zeros((1, 2, 2, 2), dtype=torch.float64)
        with pytest.raises(ValueError, match="divisible"):
            PA.ulysses_attention(P.COMM_WORLD, q, kv, kv, causal=True)

    P.run_ranks(body, 4, device="cpu")
