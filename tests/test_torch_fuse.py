"""The port's fused bucketed collectives against the JAX package, on the
CPU.

* **Layouts**: ``bucket_layout`` / ``shard_layout`` of the port equal the
  JAX package's slot for slot (bucket, offset, size, shape, dtype; rows
  and per-rank lengths) on trees with mixed dtypes, an oversize leaf and
  several bucket sizes — the trees walked in the JAX pytree order.
* **Exact fused Allreduce**: blocking and ``overlap=True`` (the
  Isend/Irecv pipeline, window depths 1 to 3), values and gradients
  bitwise equal to the JAX package's eager fused form and to the port's
  per-leaf form, on (2,), (3,), (4,) and (8,) worlds; the pipeline's
  backward finishes (no deadlock) on 2, 3 and 8 ranks.
* **Compressed fused buckets**: ``q8``, ``q8_ef`` and ``q8_ef_hop`` on
  ``ring``, ``bidir`` and ``torus``, values and gradients bitwise equal
  to the JAX package's eager fused form for normal inputs.
* The ZeRO pair (``fused_reduce_scatter_tree`` /
  ``fused_allgather_tree``) bitwise against JAX, the degrade/raise rules
  of codecs and overlap, ``fusion_scope`` and the DP lock-step.
* **Mode A** (``run_spmd``): the SPMD form of the fused Allreduce (the
  ``Reduce_scatter`` + ``Allgather`` pair a bucket outside deterministic
  mode, one ``Allreduce`` a bucket under it; the split-phase scheduler
  with ``overlap=True``), values and in-body gradients bitwise the port's
  Mode B fused form, bitwise the JAX package's Mode A under
  deterministic mode and within ``MODE_A_RTOL`` of it outside (where
  XLA's native collectives fold in their own order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import fuse as jfuse
from mpi4torch_tpu_torch import config as pconfig
from mpi4torch_tpu_torch import fuse as pfuse
from mpi4torch_tpu_torch.parallel.dp import all_average_tree
from mpi4torch_tpu_torch.utils.tree import tree_leaves, tree_map

SIZES = [2, 3, 4, 8]


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).reshape(-1)
                               .view(np.uint8),
                               np.ascontiguousarray(b).reshape(-1)
                               .view(np.uint8)))


def _np_tree(seed, dtypes=("f4", "f8", "f4", "f8"), scale=1.0):
    """A nested dict/list tree of numpy leaves: odd sizes, a 0-d leaf and
    (by key order) leaves of two float dtypes interleaved."""
    rng = np.random.default_rng(seed)

    def leaf(shape, dt):
        return (rng.standard_normal(shape) * scale).astype(dt)

    return {"w": leaf((7, 3), dtypes[0]),
            "b": [leaf((5,), dtypes[1]), leaf((), dtypes[2])],
            "a": {"z": leaf((33,), dtypes[3]), "y": leaf((2, 4), dtypes[0])},
            "c": leaf((300,), dtypes[1])}


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _to_torch(t, grad=False):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(
        grad), t)


def _leaf_pairs(ptree, jtree):
    pl = [np.asarray(x.detach()) for x in tree_leaves(ptree)]
    jl = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    assert len(pl) == len(jl)
    return zip(pl, jl)


# --------------------------------------------------------------- layouts


@pytest.mark.parametrize("bb", [8, 64, 200, 1 << 20])
def test_bucket_and_shard_layouts_match_jax(bb):
    t = _np_tree(0)
    t["i"] = np.arange(6, dtype=np.int32)
    t["big"] = np.zeros(1000, np.float32)          # larger than 200 B
    jl = jfuse.bucket_layout(_to_jax(t), bb)
    pl = pfuse.bucket_layout(_to_torch(t), bb)
    assert pl.bucket_sizes == jl.bucket_sizes
    assert [str(d).replace("torch.", "") for d in pl.bucket_dtypes] == \
        [np.dtype(d).name for d in jl.bucket_dtypes]
    for ps, js in zip(pl.slots, jl.slots, strict=True):
        assert (ps.bucket, ps.offset, ps.size, ps.shape) == \
            (js.bucket, js.offset, js.size, js.shape)
    for n in (2, 3, 8):
        js = jfuse.shard_layout(_to_jax(t), n, bb)
        ps = pfuse.shard_layout(_to_torch(t), n, bb)
        assert ps.row_sizes == js.row_sizes
        for a, b in zip(ps.slots, js.slots, strict=True):
            assert (a.bucket, a.offset, a.per_rank, a.size, a.shape) == \
                (b.bucket, b.offset, b.per_rank, b.size, b.shape)


def test_flatten_round_trip_cache_and_homogeneous_buckets():
    t = _to_torch(_np_tree(1))
    buckets, layout = pfuse.flatten_buckets(t, 64)
    assert layout is pfuse.bucket_layout(_to_torch(_np_tree(2)), 64)
    assert layout.num_buckets > 2
    for b, dt in zip(buckets, layout.bucket_dtypes):
        assert b.dtype == dt and b.dim() == 1
    back = pfuse.unflatten_buckets(buckets, layout)
    assert list(back) == list(t)                   # key order kept
    for x, y in zip(tree_leaves(back), tree_leaves(t)):
        assert torch.equal(x, y)
    # A leaf larger than the bucket takes a bucket of its own.
    big = {"a": torch.zeros(3), "b": torch.zeros(100), "c": torch.zeros(3)}
    lay = pfuse.bucket_layout(big, 40)
    assert [s.bucket for s in lay.slots] == [0, 1, 2]
    assert lay.bucket_sizes == (3, 100, 3)


# ------------------------------------------------ exact fused Allreduce


def _jax_fused(n, trees, **kw):
    def body(r):
        t = _to_jax(trees[r])

        def loss(tt):
            y = mpi.COMM_WORLD.Allreduce_tree(tt, mpi.MPI_SUM, **kw)
            return sum(jnp.sum(v * v * (i + 1))
                       for i, v in enumerate(jax.tree.leaves(y))), y

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(t)
        return y, g

    return mpi.run_ranks(body, n)


def _torch_fused(n, trees, **kw):
    def body(r):
        t = _to_torch(trees[r], grad=True)
        y = P.COMM_WORLD.Allreduce_tree(t, P.MPI_SUM, **kw)
        loss = sum(torch.sum(v * v * (i + 1))
                   for i, v in enumerate(tree_leaves(y)))
        g = torch.autograd.grad(loss, tree_leaves(t))
        return y, g

    return P.run_ranks(body, n, device="cpu")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kw", [dict(bucket_bytes=96),
                                dict(bucket_bytes=1 << 20, mean=True),
                                dict(bucket_bytes=96, overlap=True),
                                dict(bucket_bytes=96, overlap=3,
                                     mean=True)],
                         ids=["blocking", "one_bucket_mean", "overlap",
                              "overlap_depth3_mean"])
def test_exact_fused_bitwise_vs_jax_and_per_leaf(n, kw):
    trees = [_np_tree(10 + r) for r in range(n)]
    want = _jax_fused(n, trees, **kw)
    got = _torch_fused(n, trees, **kw)
    per_leaf = _torch_fused(n, trees, **dict(kw, bucket_bytes=0,
                                             overlap=None))
    for (yg, gg), (yw, gw), (yl, gl) in zip(got, want, per_leaf):
        for a, b in _leaf_pairs(yg, yw):
            assert _bitwise(a, b)
        for a, b in zip(gg, jax.tree.leaves(gw)):
            assert _bitwise(a.numpy(), b)
        for a, b in zip(tree_leaves(yg), tree_leaves(yl)):
            assert torch.equal(a, b)
        for a, b in zip(gg, gl):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_overlap_pipeline_backward_finishes(n):
    # Eight buckets in flight through forward and backward, twice in one
    # graph; a deadlock would raise DeadlockError after the timeout.
    def body(r):
        t = {f"p{i}": torch.arange(8, dtype=torch.float64) + r + i
             for i in range(8)}
        leaves = [v.requires_grad_() for v in t.values()]
        y = pfuse.fused_allreduce_tree(P.COMM_WORLD, t, P.MPI_SUM,
                                       bucket_bytes=128, overlap=True)
        z = pfuse.fused_allreduce_tree(P.COMM_WORLD, y, P.MPI_SUM,
                                       bucket_bytes=64, overlap=2)
        g = torch.autograd.grad(sum(v.sum() for v in z.values()), leaves)
        return g

    for g in P.run_ranks(body, n, timeout=30, device="cpu"):
        assert all(torch.equal(x, torch.full((8,), float(n * n),
                                             dtype=torch.float64))
                   for x in g)


def test_nonsum_fused_and_mean_rules():
    def body(r):
        c = P.COMM_WORLD
        t = _to_torch(_np_tree(20 + r))
        fused = c.Allreduce_tree(t, P.MPI_MAX, bucket_bytes=64)
        ref = tree_map(lambda v: c.Allreduce(v, P.MPI_MAX), t)
        with pytest.raises(P.CommError, match="MPI_SUM"):
            c.Allreduce_tree(t, P.MPI_MAX, mean=True)
        with pytest.raises(ValueError, match=">= 0"):
            c.Allreduce_tree(t, P.MPI_SUM, bucket_bytes=-1)
        return all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(fused), tree_leaves(ref)))

    assert all(P.run_ranks(body, 3, device="cpu"))


# ------------------------------------------------- compressed buckets

CODECS = ["q8", "q8_ef", "q8_ef_hop"]
# (world, algorithm); torus only where a 2-level group exists.
SCHEDULES = [(n, a) for n in SIZES for a in ("ring", "bidir", "torus")
             if a != "torus" or n in (4, 8)]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n, algo", SCHEDULES)
def test_compressed_buckets_bitwise_vs_jax_fused(n, algo, codec):
    # Normal inputs (no subnormal partial sums; ROADMAP.md Queue 3); two
    # dtypes, so the float32 and float64 leaves fill separate buckets.
    trees = [_np_tree(30 + r, scale=3.0) for r in range(n)]
    kw = dict(compression=codec, algorithm=algo, bucket_bytes=700)
    want = _jax_fused(n, trees, **kw)
    got = _torch_fused(n, trees, **kw)
    for (yg, gg), (yw, gw) in zip(got, want):
        for a, b in _leaf_pairs(yg, yw):
            assert _bitwise(a, b)
        for a, b in zip(gg, jax.tree.leaves(gw)):
            assert _bitwise(a.numpy(), b)


def test_compressed_buckets_quantize_other_blocks_than_leaves():
    # The reason parity is with the fused form: a 300-element leaf shares
    # its bucket's 256-element blocks with its neighbours.
    n = 2
    trees = [_np_tree(40 + r, dtypes=("f4",) * 4) for r in range(n)]
    fused = _torch_fused(n, trees, compression="q8", bucket_bytes=1 << 20)
    leaf = _torch_fused(n, trees, compression="q8", bucket_bytes=0)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(fused[0][0]), tree_leaves(leaf[0][0])))


def test_codec_degrade_and_raise_rules_per_bucket():
    def body(r):
        c = P.COMM_WORLD
        t = {"f": torch.full((8,), 1.0 + r), "i": torch.arange(4) + r}
        with pconfig.compression_scope("q8"):
            got = c.Allreduce_tree(t, P.MPI_SUM)
            exact = c.Allreduce_tree(t, P.MPI_SUM, compression=False)
            mx = c.Allreduce_tree(t, P.MPI_MAX)
        with pytest.raises(ValueError, match="floating"):
            c.Allreduce_tree({"i": torch.arange(4)}, P.MPI_SUM,
                             compression="q8")
        ref_i = c.Allreduce(t["i"], P.MPI_SUM)
        ref_f = c.Allreduce(t["f"], P.MPI_SUM, compression="q8")
        ok = (torch.equal(got["i"], ref_i) and torch.equal(got["f"], ref_f)
              and torch.equal(exact["f"], c.Allreduce(t["f"], P.MPI_SUM))
              and torch.equal(mx["f"], c.Allreduce(t["f"], P.MPI_MAX)))
        return ok

    assert all(P.run_ranks(body, 2, device="cpu"))


def test_overlap_conflicts_raise_explicit_and_degrade_in_scope():
    def body(r):
        c = P.COMM_WORLD
        t = {"a": torch.arange(6.) + r, "b": torch.ones(3) * r}
        for kw, msg in ((dict(compression="q8"), "exact-only"),
                        (dict(algorithm="rhd"), "ring"),
                        (dict(op=P.MPI_MAX), "MPI_SUM only")):
            op = kw.pop("op", P.MPI_SUM)
            with pytest.raises(P.CommError, match=msg):
                c.Allreduce_tree(t, op, overlap=True, **kw)
        with pconfig.compression_scope("q8"):
            with pytest.raises(P.CommError, match="compression_scope"):
                c.Allreduce_tree(t, P.MPI_SUM, overlap=True)
        with pconfig.overlap_scope(True):
            q = c.Allreduce_tree(t, P.MPI_SUM, compression="q8")
            m = c.Allreduce_tree(t, P.MPI_MAX)
            e = c.Allreduce_tree(t, P.MPI_SUM)
        return (torch.equal(q["a"], c.Allreduce(t["a"], P.MPI_SUM,
                                                compression="q8"))
                and torch.equal(m["b"], c.Allreduce(t["b"], P.MPI_MAX))
                and torch.equal(e["a"], c.Allreduce(t["a"], P.MPI_SUM)))

    assert all(P.run_ranks(body, 2, device="cpu"))


def test_fusion_scope_and_process_default():
    t = {"a": torch.zeros(10), "b": torch.zeros(10)}
    assert pconfig.default_bucket_bytes() == pconfig.DEFAULT_BUCKET_BYTES \
        == 4 * 1024 * 1024
    with pconfig.fusion_scope(40):
        assert pconfig.default_bucket_bytes() == 40
        with pconfig.fusion_scope(False):
            assert pconfig.default_bucket_bytes() == 0
        assert pconfig.default_bucket_bytes() == 40
    pconfig.set_default_bucket_bytes(40)
    try:
        assert pconfig.default_bucket_bytes() == 40
        assert pfuse.bucket_layout(t, pconfig.default_bucket_bytes()) \
            .num_buckets == 2
    finally:
        pconfig.set_default_bucket_bytes(pconfig.DEFAULT_BUCKET_BYTES)
    for bad in (-1, "many"):
        with pytest.raises(ValueError):
            pconfig.set_default_bucket_bytes(bad)

    def body(r):
        # Per-leaf (fusion off) and fused give the same bits.
        c = P.COMM_WORLD
        x = {"a": torch.arange(5.) * (r + 1), "b": torch.ones(2) * r}
        with pconfig.fusion_scope(0):
            a = c.Allreduce_tree(x, P.MPI_SUM, mean=True)
        b = c.Allreduce_tree(x, P.MPI_SUM, mean=True)
        return all(torch.equal(a[k], b[k]) for k in x)

    assert all(P.run_ranks(body, 3, device="cpu"))


# ----------------------------------------------------------- ZeRO pair


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("bb", [0, 96, 1 << 20])
def test_reduce_scatter_and_allgather_trees_bitwise_vs_jax(n, bb):
    trees = [_np_tree(50 + r) for r in range(n)]

    def jbody(r):
        c = mpi.COMM_WORLD
        t = _to_jax(trees[r])
        shards = jfuse.fused_reduce_scatter_tree(c, t, mpi.MPI_SUM,
                                                 bucket_bytes=bb, mean=True)

        def loss(s):
            full = jfuse.fused_allgather_tree(c, s, t, bucket_bytes=bb)
            return sum(jnp.sum(v * v) for v in jax.tree.leaves(full)), full

        (_, full), g = jax.value_and_grad(loss, has_aux=True)(shards)
        return shards, full, g

    def pbody(r):
        c = P.COMM_WORLD
        t = _to_torch(trees[r])
        shards = pfuse.fused_reduce_scatter_tree(c, t, P.MPI_SUM,
                                                 bucket_bytes=bb, mean=True)
        s = [x.detach().requires_grad_() for x in tree_leaves(shards)]
        it = iter(s)
        sh = tree_map(lambda _: next(it), shards)
        full = pfuse.fused_allgather_tree(c, sh, t, bucket_bytes=bb)
        g = torch.autograd.grad(
            sum(torch.sum(v * v) for v in tree_leaves(full)), s)
        return shards, full, g

    want = mpi.run_ranks(jbody, n)
    got = P.run_ranks(pbody, n, device="cpu")
    for (ps, pf, pg), (js, jf, jg) in zip(got, want):
        for a, b in _leaf_pairs(ps, js):
            assert _bitwise(a, b)
        for a, b in _leaf_pairs(pf, jf):
            assert _bitwise(a, b)
        for a, b in zip(pg, jax.tree.leaves(jg)):
            assert _bitwise(a.numpy(), b)


def test_stale_shard_tree_raises():
    def body(r):
        c = P.COMM_WORLD
        template = {"a": torch.zeros(5), "b": torch.zeros(3)}
        with pytest.raises(ValueError, match="structure"):
            pfuse.fused_allgather_tree(c, {"a": torch.zeros(3)}, template,
                                       bucket_bytes=64)
        with pytest.raises(ValueError, match="elements"):
            pfuse.fused_allgather_tree(
                c, {"a": torch.zeros(2), "b": torch.zeros(1)}, template,
                bucket_bytes=64)
        return True

    assert all(P.run_ranks(body, 2, device="cpu"))


def test_all_average_tree_keeps_ranks_in_lockstep():
    n = 4
    trees = [_np_tree(60 + r) for r in range(n)]

    def body(r):
        t = _to_torch(trees[r], grad=True)
        y = all_average_tree(P.COMM_WORLD, t)
        loss = sum(torch.sum(v * v) * (r + 1) for v in tree_leaves(y))
        return torch.autograd.grad(loss, tree_leaves(t))

    outs = P.run_ranks(body, n, device="cpu")
    for g in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g, outs[0]))


# ----------------------------------------------------------------- Mode A

MODE_A_RTOL = 1e-6    # float32 leaves of sums of 8 normals, XLA's order


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def _jax_mode_a_fused(n, trees, det, **kw):
    comm = mpi.COMM_WORLD

    def body(st):
        t = jax.tree.map(lambda a: jax.lax.dynamic_index_in_dim(
            a, jnp.asarray(comm.rank + 0), 0, keepdims=False), st)

        def loss(tt):
            y = comm.Allreduce_tree(tt, mpi.MPI_SUM, **kw)
            return sum(jnp.sum(v * v * (i + 1))
                       for i, v in enumerate(jax.tree.leaves(y))), y

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(t)
        return y, g

    with mpi.config.deterministic_mode(det):
        y, g = mpi.run_spmd(body, nranks=n)(_to_jax(_stack(trees)))
    return [[np.asarray(v)[r] for v in jax.tree.leaves(y)]
            for r in range(n)], \
        [[np.asarray(v)[r] for v in jax.tree.leaves(g)] for r in range(n)]


def _torch_mode_a_fused(n, trees, det, **kw):
    comm = P.COMM_WORLD

    def body(st):
        t = tree_map(lambda a: a[comm.rank].detach().requires_grad_(), st)
        y = comm.Allreduce_tree(t, P.MPI_SUM, **kw)
        loss = sum(torch.sum(v * v * (i + 1))
                   for i, v in enumerate(tree_leaves(y)))
        return y, list(torch.autograd.grad(loss, tree_leaves(t)))

    with pconfig.deterministic_mode(det):
        y, g = P.run_spmd(body, nranks=n, device="cpu")(
            _to_torch(_stack(trees)))
    return [[v[r].numpy() for v in tree_leaves(y)] for r in range(n)], \
        [[v[r].numpy() for v in g] for r in range(n)]


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("kw", [dict(bucket_bytes=96),
                                dict(bucket_bytes=1 << 20, mean=True),
                                dict(bucket_bytes=96, overlap=True,
                                     mean=True)],
                         ids=["blocking", "one_bucket_mean",
                              "overlap_mean"])
def test_mode_a_fused_vs_mode_b_and_jax(n, det, kw):
    trees = [_np_tree(40 + r) for r in range(n)]
    ya, ga = _torch_mode_a_fused(n, trees, det, **kw)
    mode_b = _torch_fused(n, trees, **kw)
    for r, (yb, gb) in enumerate(mode_b):
        for a, b in zip(ya[r], tree_leaves(yb)):
            assert _bitwise(a, b.detach().numpy()), r
        for a, b in zip(ga[r], gb):
            assert _bitwise(a, b.numpy()), r
    yj, gj = _jax_mode_a_fused(n, trees, det, **kw)
    # Inside its jit XLA turns the mean's ``/ size`` into a multiply by
    # the reciprocal, one ulp off a true division when size is not a
    # power of two; the port divides (the Mode B bits).
    exact = not kw.get("mean") or not n & (n - 1)
    for r in range(n):
        for a, b in zip(ya[r] + ga[r], yj[r] + gj[r]):
            if det and exact:
                assert _bitwise(a, b), r
            else:
                np.testing.assert_allclose(a, b, rtol=MODE_A_RTOL,
                                           atol=1e-6)


def test_mode_a_fused_takes_the_pair_outside_deterministic_mode():
    # One Reduce_scatter + one Allgather a bucket (psum_scatter and a
    # tiled all-gather rendezvous), not an Allreduce; under deterministic
    # mode one ordered Allreduce a bucket.
    from mpi4torch_tpu_torch import obs

    trees = [_np_tree(50 + r) for r in range(2)]
    for det, want in ((False, {"spmd.psum_scatter": 4,
                               "spmd.all_gather_tiled": 4}),
                      (True, {"spmd.all_gather": 4})):
        with obs.trace() as t:
            _torch_mode_a_fused(2, trees, det, bucket_bytes=96)
        ops = [e.op for e in t.events if e.rank == 0]
        nb = pfuse.bucket_layout(_to_torch(trees[0]), 96).num_buckets
        got = {k: ops.count(k) for k in want}
        # Forward and backward: twice the buckets.
        assert got == {k: 2 * nb * v // 4 for k, v in want.items()}
