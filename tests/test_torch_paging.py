"""The port's paged KV cache against the JAX package's.

* ``serve/paging.py``: the same scripted sequence of ``BlockManager``
  operations (alloc, ref, release, match, register; cached pages evicted
  LRU when the free list runs dry) gives equal returns and equal
  populations after every operation.
* ``ops/ragged.py`` ``block_gather`` / ``block_scatter``: bitwise equal
  to JAX's, unmapped (``-1``) pages, out-of-range cells and inactive
  writers included (the port writes in place, JAX rebuilds the pool).
* ``serve/kv.py`` ``prefill_chunk_tp`` and ``decode_step_paged``: within
  1e-5 of JAX's in float32, and held to the port's own dense functions:
  the paged decode's logits bitwise ``decode_step_tp``'s; a chunk's
  logits and rows those of the one-shot ``prefill_tp`` (bitwise for a
  chunk that is the whole prompt, and for the chunks of 5 rows or more
  here; torch's CPU GEMMs at 1-4 rows round otherwise, within 2e-6).  Bitwise equality with JAX does not hold in float32 for any of
  the port's transformer layers, dense ones included: torch's CPU GEMMs
  and XLA's round differently (the port's ``prefill_tp`` is ~1e-6 from
  JAX's in float32 on these weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu.ops import ragged as jragged
from mpi4torch_tpu.serve import kv as jkv
from mpi4torch_tpu.serve import paging as jpaging
from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu_torch.ops import ragged as pragged
from mpi4torch_tpu_torch.serve import kv as pkv
from mpi4torch_tpu_torch.serve import paging as ppaging
from mpi4torch_tpu_torch.models import transformer as PT

# Tolerance of the port's float32 transformer layers against JAX's.
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _census(m):
    return (m.free_blocks, m.cached_blocks, m.blocks_in_use,
            [m.refcount(b) for b in range(m.num_blocks)])


def _script(rng, steps, num_blocks, block_size):
    """A random but valid operation sequence, decided from the reference
    manager's state so that both managers see the same calls."""
    ref = jpaging.BlockManager(num_blocks, block_size)
    vocab = 3                      # few tokens: hashes collide on purpose
    seqs = [rng.integers(0, vocab, int(rng.integers(1, 4 * block_size)))
            for _ in range(6)]
    ops = []
    for _ in range(steps):
        held = [b for b in range(num_blocks) if ref.refcount(b) > 0]
        kind = rng.choice(["alloc", "ref", "release", "match", "register"])
        if kind == "alloc":
            args = (int(rng.integers(1, 4)),)
        elif kind == "ref" and held:
            args = ([int(b) for b in rng.choice(held, int(rng.integers(
                1, len(held) + 1)), replace=False)],)
        elif kind == "release" and held:
            args = ([int(b) for b in rng.choice(held, int(rng.integers(
                1, len(held) + 1)), replace=False)],)
        elif kind == "register" and held:
            seq = seqs[int(rng.integers(len(seqs)))]
            n = int(rng.integers(1, len(seq) + 1))
            need = -(-n // block_size)
            args = (seq, [int(b) for b in rng.choice(held, need)], n)
        elif kind == "match":
            seq = seqs[int(rng.integers(len(seqs)))]
            args = (seq, int(rng.integers(0, len(seq) + 1)))
        else:
            continue
        getattr(ref, kind)(*args)
        ops.append((kind, args))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("num_blocks, block_size", [(6, 2), (9, 4), (3, 1)])
def test_block_manager_script_matches_jax(seed, num_blocks, block_size):
    ops = _script(np.random.default_rng(seed), 120, num_blocks, block_size)
    j = jpaging.BlockManager(num_blocks, block_size)
    p = ppaging.BlockManager(num_blocks, block_size)
    kinds = set()
    for kind, args in ops:
        assert getattr(p, kind)(*args) == getattr(j, kind)(*args), kind
        assert _census(p) == _census(j), kind
        kinds.add(kind)
    assert kinds == {"alloc", "ref", "release", "match", "register"}


def test_block_manager_lru_eviction_and_prefix_cache_off():
    toks = np.array([5, 6, 7, 8, 9])
    for cache in (True, False):
        seen = []
        for m in (jpaging.BlockManager(4, 2, prefix_cache=cache),
                  ppaging.BlockManager(4, 2, prefix_cache=cache)):
            ids = m.alloc(3)
            m.register(toks, ids, 5)
            m.release(ids)
            hit = m.match(toks, 4)
            # Alloc past the free list reclaims cached pages, oldest first,
            # and their index entries go with them.
            got = m.alloc(3)
            after = m.match(toks, 4)
            m.release(got)
            seen.append((ids, hit, got, after, _census(m), m.alloc(5)))
        assert seen[0] == seen[1]
        assert seen[1][1] == (([0, 1], 4) if cache else ([], 0))
        assert seen[1][3] == ([], 0) and seen[1][5] is None
    with pytest.raises(ValueError, match="unreferenced block 0"):
        ppaging.BlockManager(2, 2).release([0])
    for kw in (dict(num_blocks=0, block_size=2),
               dict(num_blocks=2, block_size=0)):
        with pytest.raises(ValueError) as perr:
            ppaging.BlockManager(**kw)
        with pytest.raises(ValueError) as jerr:
            jpaging.BlockManager(**kw)
        assert str(perr.value) == str(jerr.value)


def test_chain_hash_equals_jax():
    parent = jpaging._SEED
    for toks in ([1, 2, 3], np.arange(16), [2**40]):
        assert ppaging._chain_hash(parent, toks) == \
            jpaging._chain_hash(parent, toks)
        parent = ppaging._chain_hash(parent, toks)


@pytest.mark.parametrize("dtypes", [(np.float32, torch.float32),
                                    (np.float64, torch.float64)])
def test_block_gather_bitwise(dtypes):
    ndt, tdt = dtypes
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((7, 4, 3, 5)).astype(ndt)
    table = np.array([[3, -1, 0, 6], [-1, -1, -1, -1], [6, 5, 4, 3]])
    want = np.asarray(jragged.block_gather(jnp.asarray(pool), table))
    got = pragged.block_gather(torch.from_numpy(pool), table)
    assert got.shape == want.shape == (3, 16, 3, 5)
    assert np.array_equal(got.numpy(), want)
    assert (got[0, 4:8] == 0).all() and (got[1] == 0).all()
    for kw in (dict(pool=torch.zeros(3)), dict(table=np.zeros(4, int))):
        args = {**dict(pool=torch.from_numpy(pool), table=table), **kw}
        with pytest.raises(ValueError) as perr:
            pragged.block_gather(**args)
        with pytest.raises(ValueError) as jerr:
            jragged.block_gather(jnp.asarray(args["pool"].numpy()),
                                 jnp.asarray(args["table"]))
        assert str(perr.value).split(";")[0] == str(jerr.value).split(";")[0]


@pytest.mark.parametrize("active", [None, [1, 1, 0, 1, 1, 1]])
def test_block_scatter_bitwise(active):
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((5, 4, 2, 3)).astype(np.float32)
    vals = rng.standard_normal((6, 2, 3))
    # Distinct cells, a -1 page, an id and an offset out of range, and
    # (with `active`) an inactive writer.
    ids = np.array([2, -1, 0, 4, 7, 1])
    offs = np.array([3, 1, 0, 0, 2, 4])
    want = np.asarray(jragged.block_scatter(
        jnp.asarray(pool), ids, offs, jnp.asarray(vals),
        active=None if active is None else jnp.asarray(active)))
    mine = torch.from_numpy(pool.copy())
    out = pragged.block_scatter(mine, ids, offs, torch.from_numpy(vals),
                                active=active)
    assert out is mine                           # written in place
    assert np.array_equal(mine.numpy(), want)
    assert not np.array_equal(want, pool)
    with pytest.raises(ValueError, match="feature shape"):
        pragged.block_scatter(mine, ids, offs, torch.zeros(6, 3, 3))


@pytest.mark.parametrize("active", [None, [0, 0, 0, 0, 0, 0]])
def test_live_cells_picked_once_write_every_pool(active):
    """A decode step picks its write cells once and writes them into
    every layer's K and V pool: each pool ends as the JAX block_scatter
    of its own values (no cell at all when no writer is live)."""
    rng = np.random.default_rng(2)
    pools = [rng.standard_normal((5, 4, 2, 3)).astype(np.float32)
             for _ in range(3)]
    vals = [rng.standard_normal((6, 2, 3)) for _ in pools]
    ids = np.array([2, -1, 0, 4, 7, 1])
    offs = np.array([3, 1, 0, 0, 2, 4])
    cells = pragged.live_cells(ids, offs, torch.from_numpy(pools[0]), active)
    assert (cells is None) == (active is not None)
    for pool, v in zip(pools, vals):
        want = np.asarray(jragged.block_scatter(
            jnp.asarray(pool), ids, offs, jnp.asarray(v),
            active=None if active is None else jnp.asarray(active)))
        mine = torch.from_numpy(pool.copy())
        assert pragged.write_cells(mine, cells, torch.from_numpy(v)) is mine
        assert np.array_equal(mine.numpy(), want)


CFGS = {
    "gelu": dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                 max_seq=32),
    "rope_gqa_window": dict(vocab=61, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64, max_seq=32, norm="rmsnorm",
                            ffn="swiglu", rope=True, n_kv_heads=2,
                            attn_window=6),
}


def _models(name, dtype=jnp.float32):
    kw = CFGS[name]
    jcfg = JT.TransformerConfig(**kw)
    jparams = JT.init_transformer(jax.random.PRNGKey(0), jcfg, dtype=dtype)
    pcfg = PT.TransformerConfig(**kw)
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jkv.shard_params_tp(jcfg, jparams, mpi.COMM_WORLD),
            pcfg, pkv.shard_params_tp(pcfg, pparams, P.COMM_WORLD))


@pytest.fixture(scope="module", params=sorted(CFGS))
def models(request):
    return _models(request.param)


PROMPT = np.random.default_rng(2).integers(0, 61, 13)
# The port's chunked prefill against its one-shot prefill in float32
# (torch's CPU GEMMs at 1-4 rows round otherwise than at 13).
CHUNK_TOL = dict(rtol=2e-6, atol=2e-6)


def _chunk_close(a, b):
    return torch.allclose(a, b, **CHUNK_TOL)


@pytest.mark.parametrize("p_len", [0, 1, 5, 8, 12])
def test_prefill_chunk_matches_one_shot_and_jax(models, p_len):
    jcfg, js, pcfg, ps = models
    n = len(PROMPT)
    full = pkv.init_kv_cache_tp(pcfg, 1, 1, torch.float32, "cpu")
    logits, full = pkv.prefill_tp(pcfg, ps, full, torch.as_tensor(PROMPT)[None])
    past = [{"k": c["k"][:, :p_len].clone(), "v": c["v"][:, :p_len].clone()}
            for c in full]
    got, rows = pkv.prefill_chunk_tp(pcfg, ps, past,
                                     torch.as_tensor(PROMPT[p_len:])[None])
    # The chunk's last logits and its rows against the one-shot prefill's:
    # bitwise when the chunk is the whole prompt (the same computation);
    # otherwise the projections run torch's CPU GEMMs at another row
    # count, which round alike for chunks of 5 rows or more here and
    # otherwise within CHUNK_TOL.
    same = torch.equal if p_len == 0 else _chunk_close
    assert same(got, logits)
    for r, c in zip(rows, full):
        assert same(r["k"], c["k"][:, p_len:n])
        assert same(r["v"], c["v"][:, p_len:n])
    jpast = [{"k": jnp.asarray(c["k"][:, :p_len].numpy()),
              "v": jnp.asarray(c["v"][:, :p_len].numpy())} for c in full]
    want, jrows = jkv.prefill_chunk_tp(
        jcfg, js, jpast, jnp.asarray(PROMPT[p_len:], jnp.int32)[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for r, jr in zip(rows, jrows):
        np.testing.assert_allclose(r["k"].numpy(), np.asarray(jr["k"]),
                                   **F32_TOL)
        assert r["k"].dtype == torch.float32


def test_prefill_chunk_in_three_chunks_equals_one_shot(models):
    _, _, pcfg, ps = models
    full = pkv.init_kv_cache_tp(pcfg, 1, 1, torch.float32, "cpu")
    logits, full = pkv.prefill_tp(pcfg, ps, full,
                                  torch.as_tensor(PROMPT)[None])
    past = [{"k": c["k"][:, :0], "v": c["v"][:, :0]} for c in full]
    for lo, hi in ((0, 4), (4, 9), (9, 13)):
        got, rows = pkv.prefill_chunk_tp(pcfg, ps, past,
                                         torch.as_tensor(PROMPT[lo:hi])[None])
        past = [{"k": torch.cat([p["k"], r["k"]], 1),
                 "v": torch.cat([p["v"], r["v"]], 1)}
                for p, r in zip(past, rows)]
    assert _chunk_close(got, logits)
    for p, c in zip(past, full):
        assert _chunk_close(p["k"], c["k"][:, :13])


def _paged_state(pcfg, bs, nb, dtype, lens, rng):
    """A pool and block table holding ``lens[s]`` rows of random K/V for
    each slot (``-1`` rows for a slot of length None), pages scattered
    over the pool; and the dense cache with the same rows."""
    slots = len(lens)
    nblk = pcfg.max_seq // bs
    pool = pkv.init_kv_pool_tp(pcfg, nb, bs, 1, dtype, "cpu")
    dense = pkv.init_kv_cache_tp(pcfg, slots, 1, dtype, "cpu")
    table = np.full((slots, nblk), -1, np.int64)
    free = list(rng.permutation(nb))
    for s, n in enumerate(lens):
        if n is None:
            continue
        for bi in range(-(-(n + 1) // bs)):
            table[s, bi] = free.pop()
    for c, d in zip(pool, dense):
        for name in ("k", "v"):
            rows = torch.from_numpy(rng.standard_normal(
                (slots, pcfg.max_seq) + tuple(c[name].shape[2:]))).to(dtype)
            for s, n in enumerate(lens):
                if n is None:
                    continue
                d[name][s, :n] = rows[s, :n]
                for r in range(n):
                    c[name][table[s, r // bs], r % bs] = rows[s, r]
    return pool, dense, table


def test_decode_step_paged_matches_dense_and_jax(models):
    jcfg, js, pcfg, ps = models
    bs, nb = 4, 20
    rng = np.random.default_rng(3)
    lens = [5, None, 11, 0]
    pool, dense, table = _paged_state(pcfg, bs, nb, torch.float32, lens, rng)
    jpool = [{k: jnp.asarray(v.numpy()) for k, v in c.items()} for c in pool]
    active = np.array([n is not None for n in lens])
    pos = np.array([0 if n is None else n for n in lens])
    tokens = np.array([3, 9, 17, 30])
    got, pool = pkv.decode_step_paged(pcfg, ps, pool, table,
                                      torch.as_tensor(tokens), pos,
                                      active=active)
    want_dense, dense = pkv.decode_step_tp(
        pcfg, ps, dense, torch.as_tensor(tokens), torch.as_tensor(pos),
        active=torch.as_tensor(active))
    live = torch.as_tensor(active)
    assert torch.equal(got[live], want_dense[live])
    want, jpool = jkv.decode_step_paged(
        jcfg, js, jpool, jnp.asarray(table, jnp.int32), jnp.asarray(tokens),
        jnp.asarray(pos), active=jnp.asarray(active))
    np.testing.assert_allclose(got.numpy()[active],
                               np.asarray(want)[active], **F32_TOL)
    # The new rows landed in the slots' pages, and only there.
    for c, jc, d in zip(pool, jpool, dense):
        for s, n in enumerate(lens):
            if n is not None:
                cell = c["k"][table[s, n // bs], n % bs]
                assert torch.equal(cell, d["k"][s, n])
        np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]),
                                   **F32_TOL)


def test_decode_step_paged_on_two_rank_threads_equals_one_rank():
    _, _, pcfg, _ = _models("gelu")
    pparams = PT.init_transformer(4, pcfg, torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    lens = [7, None, 2]
    active = np.array([n is not None for n in lens])
    pos = np.array([0 if n is None else n for n in lens])
    tokens = torch.tensor([1, 2, 3])

    def body():
        c = P.COMM_WORLD
        shards = pkv.shard_params_tp(pcfg, pparams, c)
        pool, _, table = _paged_state(pcfg, 4, 12, torch.float64, lens,
                                      np.random.default_rng(5))
        # Each rank keeps its own KV heads of the same rows.
        hkv = pcfg.kv_heads // c.size
        pool = [{k: v[:, :, c.rank * hkv:(c.rank + 1) * hkv].contiguous()
                 for k, v in layer.items()} for layer in pool]
        logits, _ = pkv.decode_step_paged(pcfg, shards, pool, table, tokens,
                                          pos, c, active=active)
        return logits

    one = P.run_ranks(body, 1, device="cpu")[0]
    two = P.run_ranks(body, 2, device="cpu")
    assert torch.equal(two[0], two[1])
    np.testing.assert_allclose(two[0][active].numpy(),
                               one[active].numpy(), rtol=1e-12, atol=1e-12)
    del rng


def test_init_kv_pool_tp_matches_jax():
    kw = CFGS["rope_gqa_window"]
    pcfg, jcfg = PT.TransformerConfig(**kw), JT.TransformerConfig(**kw)
    pool = pkv.init_kv_pool_tp(pcfg, 9, 4, 2, torch.float32, "cpu")
    want = jkv.init_kv_pool_tp(jcfg, 9, 4, 2)
    assert len(pool) == len(want) == kw["n_layers"]
    assert tuple(pool[0]["k"].shape) == want[0]["k"].shape == (9, 4, 1, 8)
    assert (pool[0]["v"] == 0).all()
    assert pool[0]["k"].data_ptr() != pool[0]["v"].data_ptr()
    with pytest.raises(P.CommError) as perr:
        pkv.init_kv_pool_tp(pcfg, 9, 5, 1, torch.float32, "cpu")
    with pytest.raises(mpi.CommError) as jerr:
        jkv.init_kv_pool_tp(jcfg, 9, 5, 1)
    assert str(perr.value) == str(jerr.value)
