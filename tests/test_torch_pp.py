"""The port's pipeline parallelism against the JAX package's.

GPipe (``pipeline_step``), interleaved virtual stages and 1F1B, blocking
and ``overlap=True``, on rank threads: loss and every stage's gradients
against the JAX package's ``mpi4torch_tpu.parallel`` on its own rank
threads within 1e-10 (f64, the same numpy stages), and against the
sequential composition on one device.  1F1B's blocking and overlapped
schedules give the same bits; ``schedule_1f1b`` is the JAX package's, op
for op, and keeps its memory bound.  Every multi-rank run has its own
deadlock time limit (the ``timeout`` of ``run_ranks``), so a receive that
never arrives fails the test instead of hanging it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import parallel as jpar
from mpi4torch_tpu_torch import parallel as ppar
from mpi4torch_tpu_torch.parallel import pp

B, D = 2, 6
LIMIT = 60.0          # seconds a rank may wait on a message


def make_stages(n, n_mb, seed, widths=None):
    rng = np.random.default_rng(seed)
    widths = widths or [D] * (n + 1)
    stages = [{"w": rng.standard_normal((widths[i], widths[i + 1]))
               / np.sqrt(widths[i]),
               "b": rng.standard_normal(widths[i + 1]) * 0.1}
              for i in range(n)]
    mbs = [rng.standard_normal((B, widths[0])) for _ in range(n_mb)]
    return stages, mbs


def j_apply(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def t_apply(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def loss_fn(y, i):
    return (i + 1.0) * (y ** 2).sum()


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _close(got, want, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, (got, want)


def sequential(stages, mbs):
    """The one-device oracle: loss and per-stage gradients of the summed
    microbatch losses of the whole stack, in the port."""
    ps = [{k: v.requires_grad_() for k, v in _t(s).items()} for s in stages]
    total = 0
    for i, mb in enumerate(mbs):
        x = torch.from_numpy(mb)
        for p in ps:
            x = t_apply(p, x)
        total = total + loss_fn(x, i)
    leaves = [p[k] for p in ps for k in ("b", "w")]
    grads = torch.autograd.grad(total, leaves)
    return total.item(), [{"b": grads[2 * r].numpy(),
                           "w": grads[2 * r + 1].numpy()}
                          for r in range(len(stages))]


def run_jax(kind, stages, mbs, n, **kw):
    fn = {"gpipe": jpar.pipeline_step, "1f1b": jpar.pipeline_step_1f1b,
          "interleaved": jpar.pipeline_step_interleaved}[kind]

    def body():
        r = int(mpi.COMM_WORLD.rank)
        mine = ([jax.tree.map(jnp.asarray, s) for s in stages[r::n]]
                if kind == "interleaved" else
                jax.tree.map(jnp.asarray, stages[r]))
        loss, g = fn(mpi.COMM_WORLD, j_apply, mine,
                     [jnp.asarray(m) for m in mbs], loss_fn,
                     recv_like=jnp.zeros((B, D)), **kw)
        g = [_np(x) for x in g] if kind == "interleaved" else _np(g)
        return np.asarray(loss), g

    return mpi.run_ranks(body, n, timeout=LIMIT)


def run_torch(kind, stages, mbs, n, recv_like=None, **kw):
    fn = {"gpipe": pp.pipeline_step, "1f1b": pp.pipeline_step_1f1b,
          "interleaved": pp.pipeline_step_interleaved}[kind]

    def body(r):
        mine = ([_t(s) for s in stages[r::n]] if kind == "interleaved"
                else _t(stages[r]))
        like = recv_like(r) if recv_like else torch.zeros(
            (B, D), dtype=torch.float64)
        loss, g = fn(P.COMM_WORLD, t_apply, mine,
                     [torch.from_numpy(m) for m in mbs], loss_fn,
                     recv_like=like, **kw)
        g = [{k: v.numpy() for k, v in x.items()} for x in g] \
            if kind == "interleaved" else {k: v.numpy() for k, v in g.items()}
        return loss.numpy(), g

    return P.run_ranks(body, n, device="cpu", timeout=LIMIT)


@pytest.mark.parametrize("n, n_mb", [(2, 3), (4, 3), (5, 2)])
def test_gpipe_matches_jax_and_sequential(n, n_mb):
    stages, mbs = make_stages(n, n_mb, seed=n)
    want = run_jax("gpipe", stages, mbs, n)
    got = run_torch("gpipe", stages, mbs, n)
    ref_loss, ref_grads = sequential(stages, mbs)
    for r in range(n):
        assert got[r][0].dtype == np.float64
        _close(got[r][0], want[r][0])
        _close(got[r][0], ref_loss)
        for k in ("w", "b"):
            _close(got[r][1][k], want[r][1][k])
            _close(got[r][1][k], ref_grads[r][k])


@pytest.mark.parametrize("n, n_mb", [(2, 4), (4, 6), (5, 5)])
def test_1f1b_matches_jax_and_overlap_is_bitwise(n, n_mb):
    stages, mbs = make_stages(n, n_mb, seed=10 * n + n_mb)
    want = run_jax("1f1b", stages, mbs, n)
    got = run_torch("1f1b", stages, mbs, n)
    over = run_torch("1f1b", stages, mbs, n, overlap=True)
    deep = run_torch("1f1b", stages, mbs, n, overlap=3)
    gpipe = run_torch("gpipe", stages, mbs, n)
    for r in range(n):
        _close(got[r][0], want[r][0])
        for k in ("w", "b"):
            _close(got[r][1][k], want[r][1][k])
            _close(got[r][1][k], gpipe[r][1][k])
            for other in (over, deep):
                assert np.array_equal(other[r][1][k], got[r][1][k])
        assert np.array_equal(over[r][0], got[r][0])


@pytest.mark.parametrize("n, v, n_mb", [(2, 2, 3), (4, 2, 4), (2, 3, 2)])
def test_interleaved_matches_jax_and_sequential(n, v, n_mb):
    stages, mbs = make_stages(n * v, n_mb, seed=100 * n + 10 * v + n_mb)
    want = run_jax("interleaved", stages, mbs, n)
    got = run_torch("interleaved", stages, mbs, n)
    ref_loss, ref_grads = sequential(stages, mbs)
    for r in range(n):
        _close(got[r][0], want[r][0])
        _close(got[r][0], ref_loss)
        for c in range(v):
            for k in ("w", "b"):
                _close(got[r][1][c][k], want[r][1][c][k])
                _close(got[r][1][c][k], ref_grads[c * n + r][k])


def test_1f1b_shape_changing_stages():
    # Widths 6 -> 10 -> 4: the cotangent buffer follows each rank's own
    # output, not recv_like.
    widths = [6, 10, 4]
    stages, mbs = make_stages(2, 4, seed=3, widths=widths)
    got = run_torch("1f1b", stages, mbs, 2, recv_like=lambda r: torch.zeros(
        (B, widths[r]), dtype=torch.float64))
    ref_loss, ref_grads = sequential(stages, mbs)
    for r in range(2):
        _close(got[r][0], ref_loss)
        _close(got[r][1]["w"], ref_grads[r]["w"])


@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "interleaved"])
def test_size_one_is_sequential(kind):
    stages, mbs = make_stages(3 if kind == "interleaved" else 1, 2, seed=7)
    ref_loss, ref_grads = sequential(stages, mbs)
    got = run_torch(kind, stages, mbs, 1)[0]
    _close(got[0], ref_loss)
    grads = got[1] if kind == "interleaved" else [got[1]]
    for g, want in zip(grads, ref_grads):
        _close(g["w"], want["w"])


@pytest.mark.parametrize("size, n_mb", [(2, 4), (4, 8), (8, 3), (3, 1)])
def test_schedule_1f1b_is_jaxs_and_keeps_its_memory_bound(size, n_mb):
    for rank in range(size):
        ops = pp.schedule_1f1b(rank, size, n_mb)
        assert ops == jpar.schedule_1f1b(rank, size, n_mb)
        assert [i for op, i in ops if op == "F"] == list(range(n_mb))
        assert [i for op, i in ops if op == "B"] == list(range(n_mb))
        live = peak = 0
        for op, _ in ops:
            live += 1 if op == "F" else -1
            peak = max(peak, live)
        assert peak <= min(size - rank, n_mb), (rank, peak)


def test_1f1b_stashes_at_most_the_bound(monkeypatch):
    # The activation graphs alive per stage: one more at every stage
    # forward, one fewer at every pullback; the peak is the bound.
    n, n_mb = 4, 6
    stages, mbs = make_stages(n, n_mb, seed=5)
    live, peaks = [0] * n, [0] * n
    real = pp._pullback

    def pullback(*a):
        live[P.COMM_WORLD.rank] -= 1
        return real(*a)

    def apply(p, x):
        r = P.COMM_WORLD.rank
        live[r] += 1
        peaks[r] = max(peaks[r], live[r])
        return t_apply(p, x)

    monkeypatch.setattr(pp, "_pullback", pullback)

    def body(r):
        return pp.pipeline_step_1f1b(
            P.COMM_WORLD, apply, _t(stages[r]),
            [torch.from_numpy(m) for m in mbs], loss_fn,
            recv_like=torch.zeros((B, D), dtype=torch.float64))

    P.run_ranks(body, n, device="cpu", timeout=LIMIT)
    assert peaks == [min(n - r, n_mb) for r in range(n)]
    assert live == [0] * n


def test_missing_recv_like_and_pipeline_spmd_raise():
    # GPipe: rank 1 raises, and rank 0's wait for its cotangent ends with
    # the world's failure; run_ranks re-raises rank 1's error.
    with pytest.raises(ValueError, match="recv_like"):
        P.run_ranks(lambda: pp.pipeline_step(
            P.COMM_WORLD, t_apply, {"w": torch.eye(D), "b": torch.zeros(D)},
            [torch.zeros(B, D)], loss_fn), 2, device="cpu", timeout=LIMIT)

    def body():
        with pytest.raises(ValueError, match="recv_like"):
            pp.pipeline_step_interleaved(
                P.COMM_WORLD, t_apply, [{"w": torch.eye(D)}],
                [torch.zeros(B, D)], loss_fn)
        return True

    assert all(P.run_ranks(body, 2, device="cpu", timeout=LIMIT))
    # pipeline_spmd is ported (ROADMAP.md Queue 1 item 4.6): on two ranks
    # under run_spmd it gives the sequential composition's loss on every
    # rank, and needs no recv_like.
    stages, mbs = make_stages(2, 2, seed=5)
    stacked = {k: torch.from_numpy(np.stack([s_[k] for s_ in stages]))
               for k in ("w", "b")}
    out = P.run_spmd(lambda st: ppar.pipeline_spmd(
        P.COMM_WORLD, t_apply, {k: v[P.COMM_WORLD.rank]
                                for k, v in st.items()},
        [torch.from_numpy(m) for m in mbs], loss_fn), nranks=2,
        device="cpu")(stacked)
    want = sum(loss_fn(t_apply(_t(stages[1]), t_apply(_t(stages[0]),
                                                       torch.from_numpy(m))),
                       i) for i, m in enumerate(mbs))
    assert torch.equal(out[0], out[1])
    assert torch.allclose(out[0], want, rtol=1e-12, atol=0)


def test_gpipe_training_converges_and_ranks_agree():
    n = 4
    stages, mbs = make_stages(n, 3, seed=9)

    def body(r):
        p = _t(stages[r])
        losses = []
        for _ in range(5):
            loss, g = pp.pipeline_step(
                P.COMM_WORLD, t_apply, p, [torch.from_numpy(m) for m in mbs],
                loss_fn, recv_like=torch.zeros((B, D), dtype=torch.float64))
            p = {k: p[k] - 0.05 * g[k] for k in p}
            losses.append(loss.item())
        return losses

    outs = P.run_ranks(body, n, device="cpu", timeout=LIMIT)
    assert all(o == outs[0] for o in outs)
    assert outs[0][-1] < outs[0][0]


class TestPipelineSPMD:
    """``pipeline_spmd`` under ``run_spmd`` against the JAX package's
    ``pipeline_spmd`` under its ``run_spmd`` and against the sequential
    composition (f64, the same numpy stages): the loss within 1e-12 and
    the stacked stage gradients within 1e-9 relative, 1e-12 absolute
    (the JAX test's tolerances); the loss bitwise the same on every
    rank."""

    @pytest.mark.parametrize("n,n_mb", [(4, 3), (8, 5)])
    def test_spmd_pipeline_matches_sequential(self, n, n_mb):
        stages, mbs = make_stages(n, n_mb, seed=21 + n)
        stacked = {k: np.stack([s_[k] for s_ in stages]) for k in ("w", "b")}

        def total_seq(st):
            tot = 0.0
            for i, mb in enumerate(mbs):
                x = jnp.asarray(mb)
                for r in range(n):
                    x = j_apply({k: v[r] for k, v in st.items()}, x)
                tot = tot + loss_fn(x, i)
            return tot

        jst = {k: jnp.asarray(v) for k, v in stacked.items()}
        val_d = float(total_seq(jst))
        g_d = _np(jax.grad(total_seq)(jst))

        def jfn(st):
            local = {k: v[jnp.asarray(mpi.COMM_WORLD.rank + 0)]
                     for k, v in st.items()}
            return jpar.pipeline_spmd(mpi.COMM_WORLD, j_apply, local,
                                      [jnp.asarray(m) for m in mbs],
                                      loss_fn)

        jout = np.asarray(mpi.run_spmd(jfn, nranks=n)(jst))
        jg = _np(jax.grad(lambda st: mpi.run_spmd(jfn, nranks=n)(st).sum())(
            jst))

        def pfn(st):
            local = {k: v[P.COMM_WORLD.rank] for k, v in st.items()}
            return ppar.pipeline_spmd(P.COMM_WORLD, t_apply, local,
                                      [torch.from_numpy(m) for m in mbs],
                                      loss_fn)

        pst = {k: torch.from_numpy(v).requires_grad_()
               for k, v in stacked.items()}
        out = P.run_spmd(pfn, nranks=n, device="cpu")(pst)
        pg = torch.autograd.grad(out.sum(), [pst["w"], pst["b"]])
        pout = out.detach().numpy()
        for r in range(n):
            assert pout[r] == pout[0]
        np.testing.assert_allclose(pout, jout, rtol=1e-12, atol=0)
        np.testing.assert_allclose(pout[0], val_d, rtol=1e-12, atol=0)
        for k, g in zip(("w", "b"), pg):
            # out stacks n identical losses; summing scales grads by n.
            np.testing.assert_allclose(g.numpy(), jg[k], rtol=1e-9,
                                       atol=1e-12, err_msg=k)
            np.testing.assert_allclose(g.numpy(), n * g_d[k], rtol=1e-9,
                                       atol=1e-12, err_msg=k)

    def test_gradient_inside_the_body(self):
        # torch.autograd.grad inside the body: each rank gets its own
        # stage's gradient, the rows of the stacked gradient from outside.
        n, n_mb = 4, 3
        stages, mbs = make_stages(n, n_mb, seed=77)
        stacked = {k: torch.from_numpy(np.stack([s_[k] for s_ in stages]))
                   for k in ("w", "b")}

        def inner(st):
            local = {k: v[P.COMM_WORLD.rank].clone().requires_grad_()
                     for k, v in st.items()}
            loss = ppar.pipeline_spmd(P.COMM_WORLD, t_apply, local,
                                      [torch.from_numpy(m) for m in mbs],
                                      loss_fn)
            gw, gb = torch.autograd.grad(loss, [local["w"], local["b"]])
            return loss.detach(), gw, gb

        loss, gw, gb = P.run_spmd(inner, nranks=n, device="cpu")(stacked)
        pst = {k: v.clone().requires_grad_() for k, v in stacked.items()}

        def outer(st):
            local = {k: v[P.COMM_WORLD.rank] for k, v in st.items()}
            return ppar.pipeline_spmd(P.COMM_WORLD, t_apply, local,
                                      [torch.from_numpy(m) for m in mbs],
                                      loss_fn)

        out = P.run_spmd(outer, nranks=n, device="cpu")(pst)
        # Inside, the loss Allreduce's adjoint sums every rank's unit
        # cotangent; outside, the stacked sum seeds each rank with one:
        # both give n times the stage gradient.
        ow, ob = torch.autograd.grad(out.sum(), [pst["w"], pst["b"]])
        assert torch.equal(loss, out.detach())
        torch.testing.assert_close(gw, ow, rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(gb, ob, rtol=1e-12, atol=1e-14)
