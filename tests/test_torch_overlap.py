"""The port's split-phase collectives and overlap scheduler against the
JAX package's Mode B and the blocking forms, on the CPU.

* ``Allreduce_start`` / ``Reduce_scatter_start`` / ``Allgather_start``
  completed by ``Wait``: values and gradients bitwise equal to the
  blocking ops and to the JAX package's eager split-phase forms, on
  (1,), (3,) and (8,) worlds and every exact Allreduce algorithm.
* The scheduler (``overlap_allreduce_tree``,
  ``overlap_reduce_scatter_tree``, ``prefetch_allgather_tree``,
  ``overlap_split_allreduce``) bitwise equal to the blocking forms and to
  the JAX package's scheduler on its eager rank threads.
* The handle API (``.dummy``, ``JoinDummiesHandle`` keeps the kind), the
  misuse guards (a second ``Wait`` raises ``BifurcationError``, also
  through a joined copy), the exact-wire rule for codecs, the overlap
  knobs and the spans.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import fuse as jfuse
from mpi4torch_tpu import overlap as jov
from mpi4torch_tpu_torch import config as pconfig
from mpi4torch_tpu_torch import fuse as pfuse
from mpi4torch_tpu_torch import overlap as pov
from mpi4torch_tpu_torch.utils.tree import tree_leaves


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).reshape(-1)
                               .view(np.uint8),
                               np.ascontiguousarray(b).reshape(-1)
                               .view(np.uint8)))


def _data(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n)], \
        [rng.standard_normal(shape) for _ in range(n)]


# name -> (split-phase op, blocking op, input shape(n)); both packages.
FORMS = {
    "allreduce": (lambda c, m, x: c.Wait(c.Allreduce_start(x, 3)),
                  lambda c, m, x: c.Allreduce(x, 3), lambda n: (5, 3)),
    "allreduce_tree": (
        lambda c, m, x: c.Wait(c.Allreduce_start(x, 3, algorithm="tree")),
        lambda c, m, x: c.Allreduce(x, 3, algorithm="tree"),
        lambda n: (7,)),
    "reduce_scatter": (
        lambda c, m, x: c.Wait(c.Reduce_scatter_start(x, 3, 0)),
        lambda c, m, x: c.Reduce_scatter(x, 3, 0), lambda n: (2 * n, 3)),
    "allgather": (lambda c, m, x: c.Wait(c.Allgather_start(x, 1)),
                  lambda c, m, x: c.Allgather(x, 1), lambda n: (2, 3)),
}


def _run(pkg, n, op, xs, ws):
    if pkg == "jax":
        def body(r):
            t = jnp.asarray(xs[r])
            f = lambda v: jnp.sum(op(mpi.COMM_WORLD, jnp, v)  # noqa: E731
                                  * jnp.asarray(ws[r]))
            return np.asarray(op(mpi.COMM_WORLD, jnp, t)), \
                np.asarray(jax.grad(f)(t))
        return mpi.run_ranks(body, n)

    def body(r):
        t = torch.from_numpy(xs[r]).requires_grad_()
        out = op(P.COMM_WORLD, torch, t)
        (g,) = torch.autograd.grad((out * torch.from_numpy(ws[r])).sum(), t)
        return out.detach().numpy(), g.numpy()
    return P.run_ranks(body, n, device="cpu")


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(FORMS))
def test_split_phase_bitwise_vs_blocking_and_jax(name, n):
    split, blocking, shape_of = FORMS[name]
    xs, _ = _data(n, shape_of(n), seed=n)
    out_shape = P.run_ranks(
        lambda r: blocking(P.COMM_WORLD, torch, torch.from_numpy(xs[r]))
        .shape, n, device="cpu")[0]
    ws = [np.random.default_rng(r).standard_normal(tuple(out_shape))
          for r in range(n)]
    got = _run("torch", n, split, xs, ws)
    ref = _run("torch", n, blocking, xs, ws)
    want = _run("jax", n, split, xs, ws)
    for (y, g), (yr, gr), (yw, gw) in zip(got, ref, want):
        assert _bitwise(y, yr) and _bitwise(g, gr)
        assert _bitwise(y, yw) and _bitwise(g, gw)


@pytest.mark.parametrize("algo", ["ring", "rhd", "tree", "hier", "bidir",
                                  "torus"])
def test_allreduce_start_every_algorithm(algo):
    n = 4
    xs, _ = _data(n, (9,), seed=7)

    def body(r):
        c = P.COMM_WORLD
        x = torch.from_numpy(xs[r])
        return torch.equal(c.Wait(c.Allreduce_start(x, P.MPI_SUM,
                                                    algorithm=algo)),
                           c.Allreduce(x, P.MPI_SUM, algorithm=algo))

    assert all(P.run_ranks(body, n, device="cpu"))


# ------------------------------------------------------------ scheduler


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(300).astype(np.float32),
            "b": rng.standard_normal((9, 5)),
            "c": rng.standard_normal(45).astype(np.float32)}


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_scheduler_trees_bitwise_vs_blocking_and_jax(depth):
    n, bb = 3, 256
    trees = [_tree(r) for r in range(n)]

    def pbody(r):
        c = P.COMM_WORLD
        t = {k: torch.from_numpy(np.array(v)).requires_grad_()
             for k, v in trees[r].items()}
        buckets, layout = pfuse.flatten_buckets(t, bb)
        red = pov.overlap_allreduce_tree(c, buckets, layout, P.MPI_SUM,
                                         depth=depth, mean=True)
        blk = c.Allreduce_tree(t, P.MPI_SUM, bucket_bytes=bb, mean=True)
        g = torch.autograd.grad(sum((v * v).sum() for v in red.values()),
                                list(t.values()))
        gb = torch.autograd.grad(sum((v * v).sum() for v in blk.values()),
                                 list(t.values()))
        rs = pov.overlap_reduce_scatter_tree(c, t, P.MPI_SUM,
                                             bucket_bytes=bb, depth=depth,
                                             mean=True)
        rsb = pfuse.fused_reduce_scatter_tree(c, t, P.MPI_SUM,
                                              bucket_bytes=bb, mean=True)
        ag = pov.prefetch_allgather_tree(c, rsb, t, bucket_bytes=bb,
                                         depth=depth)
        agb = pfuse.fused_allgather_tree(c, rsb, t, bucket_bytes=bb)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves((red, rs, ag)) + list(g),
            tree_leaves((blk, rsb, agb)) + list(gb)))
        return same, red, rs, ag

    def jbody(r):
        c = mpi.COMM_WORLD
        t = jax.tree.map(jnp.asarray, trees[r])
        buckets, layout = jfuse.flatten_buckets(t, bb)
        red = jov.overlap_allreduce_tree(c, buckets, layout, mpi.MPI_SUM,
                                         depth=depth, mean=True)
        rs = jov.overlap_reduce_scatter_tree(c, t, mpi.MPI_SUM,
                                             bucket_bytes=bb, depth=depth,
                                             mean=True)
        ag = jov.prefetch_allgather_tree(c, rs, t, bucket_bytes=bb,
                                         depth=depth)
        return red, rs, ag

    got = P.run_ranks(pbody, n, device="cpu")
    want = mpi.run_ranks(jbody, n)
    for (same, *pt), jt in zip(got, want):
        assert same
        pl = [x.detach().numpy() for x in tree_leaves(tuple(pt))]
        jl = [np.asarray(x) for x in jax.tree.leaves(jt)]
        assert len(pl) == len(jl)
        assert all(_bitwise(a, b) for a, b in zip(pl, jl))


@pytest.mark.parametrize("nsplits", [1, 2, 5])
def test_split_allreduce_bitwise_vs_blocking_and_jax(nsplits):
    n = 3
    xs, _ = _data(n, (4, 7), seed=nsplits)

    def pbody(r):
        c = P.COMM_WORLD
        x = torch.from_numpy(xs[r])
        y = pov.overlap_split_allreduce(c, x, P.MPI_SUM, nsplits=nsplits)
        return y, torch.equal(y, c.Allreduce(x, P.MPI_SUM))

    def jbody(r):
        return np.asarray(jov.overlap_split_allreduce(
            mpi.COMM_WORLD, jnp.asarray(xs[r]), mpi.MPI_SUM,
            nsplits=nsplits))

    for (y, same), w in zip(P.run_ranks(pbody, n, device="cpu"),
                            mpi.run_ranks(jbody, n)):
        assert same and _bitwise(y.numpy(), w)


# ---------------------------------------------------- handle API, misuse


def test_handle_api_and_double_wait():
    def body(r):
        c = P.COMM_WORLD
        x = torch.ones(8) * (r + 1)
        h = c.Allreduce_start(x, P.MPI_SUM)
        assert isinstance(h, P.WaitHandle) and isinstance(h,
                                                          pov.SpmdWaitHandle)
        assert pov.SpmdWaitHandle is pov.SplitWaitHandle
        y = P.JoinDummies(x * 2, [h.dummy])
        h2 = P.JoinDummiesHandle(h, [y])
        assert isinstance(h2, pov.SplitWaitHandle)
        out = c.Wait(h2)
        with pytest.raises(P.BifurcationError, match="already waited"):
            c.Wait(h)                         # through the other copy
        with pytest.raises(P.BifurcationError):
            c.Wait(h2)
        for h3 in (c.Reduce_scatter_start(torch.ones(4), P.MPI_SUM, 0),
                   c.Allgather_start(torch.ones(2), 0)):
            c.Wait(h3)
            with pytest.raises(P.BifurcationError):
                c.Wait(h3)
        return out

    for out in P.run_ranks(body, 2, device="cpu"):
        assert torch.equal(out, torch.full((8,), 3.0))


def test_codec_rules_of_the_split_phase_wire():
    def body(r):
        c = P.COMM_WORLD
        x = torch.arange(300, dtype=torch.float32) * 0.01 * (r + 1)
        with pytest.raises(ValueError, match="split-phase"):
            c.Allreduce_start(x, P.MPI_SUM, compression="q8")
        with pconfig.compression_scope("q8"):
            y = c.Wait(c.Allreduce_start(x, P.MPI_SUM))
        return torch.equal(y, c.Allreduce(x, P.MPI_SUM, compression=False))

    assert all(P.run_ranks(body, 2, device="cpu"))


def test_overlap_knobs():
    assert pconfig.default_overlap() is None
    with pconfig.overlap_scope(True):
        assert pov.resolve_overlap(None) is True
        with pconfig.overlap_scope(3):
            assert pov.resolve_overlap(None) == 3
        assert pov.resolve_overlap(False) is False
    pconfig.set_default_overlap(2)
    try:
        assert pconfig.default_overlap() == 2
        with pconfig.overlap_scope(None):
            assert pconfig.default_overlap() is None
    finally:
        pconfig.set_default_overlap(None)
    for bad in (0, -1, "deep"):
        with pytest.raises(ValueError):
            pconfig.set_default_overlap(bad)
        with pytest.raises(ValueError):
            pov.resolve_overlap(bad)
    assert pov.overlap_depth(True) == 2 and pov.overlap_depth(5) == 5
    for form in jov.SPLIT_PHASE_FORMS:
        assert callable(getattr(P.COMM_WORLD, f"{form}_start"))


def test_spans_name_the_resolved_algorithm():
    def calls(c):
        x = torch.ones(4)
        c.Wait(c.Allreduce_start(x, P.MPI_SUM, algorithm="rhd"))
        c.Wait(c.Allreduce_start(x, P.MPI_SUM))
        c.Wait(c.Reduce_scatter_start(torch.ones(2), P.MPI_SUM, 0))
        c.Allreduce_tree({"a": x, "b": x}, P.MPI_SUM, compression="q8")
        pov.overlap_split_allreduce(c, x, P.MPI_SUM, op_name="Site")

    def body(r):
        # The profiler is process-wide: only rank 0 records.
        if r != 0:
            calls(P.COMM_WORLD)
            return None
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            calls(P.COMM_WORLD)
        return {e.name for e in prof.events()}

    names = P.run_ranks(body, 2, device="cpu")[0]
    for want in ("mpi4torch.Allreduce_start.rhd", "mpi4torch.Allreduce_start",
                 "mpi4torch.Reduce_scatter_start", "mpi4torch.Wait",
                 "mpi4torch.Allreduce_tree.bucket0of1.q8",
                 "mpi4torch.Site.bucket1of2.start",
                 "mpi4torch.Site.bucket0of2.wait"):
        assert want in names, want
