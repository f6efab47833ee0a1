"""The port's multi-process runtime against the JAX package, on the CPU.

Ports ``tests/test_distributed.py``: ``TestInitErrors``,
``TestLocalValues`` and ``TestMpi4pyInterop`` run both packages on the
same stand-in and compare results and errors.  The integration tests
launch real OS processes that rendezvous through
``mpi4torch_tpu_torch.init_distributed`` (gloo over loopback) and run
``run_spmd`` across them.  JAX's own versions of these tests are
``xfail`` here (its CPU backend has no multi-process collectives); the
port's must pass, and are held to answers computed in the test process:

* the two-process Allreduce forward and backward (JAX's ``_WORKER``
  body): bitwise JAX's one-process ``run_spmd(nranks=2)``;
* the hybrid shape at 2 processes x 4 local ranks: the tp sum 10, the dp
  sum 3, the dp gradient 2, and the deterministic fold on ``gather`` and
  ``ring`` bitwise JAX's eager ``run_ranks(8)`` oracle;
* the flagship's DP step (2 layers, d_model 16, float64) across two
  processes: loss and parameters bitwise the port's one-process
  ``run_spmd(nranks=2)``, and within the bounds the port's ``run_spmd``
  steps are held to JAX's (``tests/test_torch_transformer_mesh.py``:
  loss rtol 1e-12 / atol 1e-14, parameters rtol 1e-9 / atol 1e-11) of
  JAX's ``run_spmd(nranks=2)`` on the same weights and tokens;
* a gradient taken from outside, the q8 ``ring`` Allreduce and a traced
  Allreduce's per-rank events: bitwise (the events equal) the
  one-process run;
* a collective mismatch raises ``CollectiveMismatchError`` in both
  processes, and a process that exits early gives the survivor a
  ``RankFailedError`` naming its rank within a short world timeout;
* ``comm_from_mpi4py``'s rendezvous branch, with a stand-in whose
  ``bcast`` passes rank 0's address through a file.

Each launch runs once per module; every subprocess has a
``communicate(timeout=)``, so a hang fails instead of blocking.
"""

import os
import socket
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P
from mpi4torch_tpu import distributed as jdist
from mpi4torch_tpu.models import transformer as JT
from mpi4torch_tpu.parallel import dp as jdp
from mpi4torch_tpu_torch import distributed as pdist
from mpi4torch_tpu_torch.models import transformer as PT
from mpi4torch_tpu_torch.parallel import dp as pdp
from mpi4torch_tpu_torch.transport import dist as tdist
from mpi4torch_tpu_torch.utils.tree import tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One launch's processes must finish within this (seconds).
LAUNCH_TIMEOUT = 120

# The flagship at the JAX transformer tests' size (float64), two ranks
# of 4 rows each.
CFG = dict(vocab=31, d_model=16, n_heads=8, n_layers=2, d_ff=32,
           max_seq=16)
B, S, LR = 8, 16, 1e-3
LOSS_TOL = dict(rtol=1e-12, atol=1e-14)
PARAM_TOL = dict(rtol=1e-9, atol=1e-11)
# The deterministic fold's data: 8 ranks x 513 float32 (JAX's).
FOLD = np.stack([np.sin(np.arange(513, dtype=np.float32) * (r + 1))
                 for r in range(8)]).astype(np.float32)
# The q8 ring Allreduce's rows and the gradient-from-outside data.
Q8 = np.random.default_rng(3).standard_normal((2, 4096)).astype(np.float32)
GDATA = np.random.default_rng(4).standard_normal((2, 5))
GDATA8 = np.random.default_rng(5).standard_normal((8, 5))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp, script, nproc=2, env_extra=None, args=()):
    """Run ``script`` in ``nproc`` processes (argv: pid, nproc, port,
    tmp, *args); returns each process's ``(returncode, output)``."""
    path = os.path.join(tmp, "worker.py")
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, path, str(pid), str(nproc), port, tmp]
        + list(args), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=LAUNCH_TIMEOUT)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process run timed out (rendezvous hang?)\n"
                    + "\n".join(outs))
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _results(tmp, runs, tag):
    for pid, (rc, out) in enumerate(runs):
        assert rc == 0, f"worker {pid} failed:\n{out}"
        assert f"{tag}-{pid}-OK" in out, out
    return [torch.load(os.path.join(tmp, f"{tag}{pid}.pt"),
                       weights_only=False) for pid in range(len(runs))]


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.reshape(-1).view(np.uint8),
                               b.reshape(-1).view(np.uint8)))


# ---------------------------------------------------------------- launches

_HEAD = textwrap.dedent("""
    import os, sys, types
    import numpy as np
    import torch
    pid, n, port, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         sys.argv[4])
    import mpi4torch_tpu_torch as mpi
    comm = mpi.COMM_WORLD
    res = {}

    def save(tag):
        torch.save(res, os.path.join(tmp, f"{tag}{pid}.pt"))
        mpi.finalize_distributed()
        assert not mpi.is_distributed()
        print(f"{tag}-{pid}-OK", flush=True)
""")

_WORKER = _HEAD + textwrap.dedent("""
    from mpi4torch_tpu_torch import obs
    from mpi4torch_tpu_torch.models import transformer as PT
    from mpi4torch_tpu_torch.parallel import dp
    from mpi4torch_tpu_torch.utils.tree import tree_map

    info = mpi.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                                num_processes=n, process_id=pid,
                                device="cpu")
    assert info.process_id == pid and info.process_count == n, info
    assert info.n_devices == n and info.n_local_devices == 1, info
    assert mpi.is_distributed()
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)

    # JAX's _WORKER body: psum((r+1)*ones) over 2 ranks = 3, adjoint 2.
    def body():
        x = ((comm.rank + 1.0) * torch.ones(4, dtype=torch.float64)
             ).requires_grad_()
        y = comm.Allreduce(x, mpi.MPI_SUM)
        (g,) = torch.autograd.grad(torch.vdot(y, torch.ones_like(y)), x)
        return y, g

    y, g = mpi.run_spmd(body)()          # default world = global ranks
    ranks, yv = mpi.local_values(y)
    _, gv = mpi.local_values(g)
    res["allreduce"] = (ranks.tolist(), yv, gv)

    m = mpi.hybrid_mesh({"tp": 1}, {"dp": 2})
    res["hybrid"] = (m.axis_names, dict(m.shape), m.process_index.tolist())

    class FakeComm:
        def Get_rank(self): return pid
        def Get_size(self): return n
        def bcast(self, v, root=0): raise AssertionError("no rendezvous")
    fake = types.ModuleType("mpi4py"); fake.MPI = types.SimpleNamespace()
    sys.modules["mpi4py"] = fake
    c = mpi.comm_from_mpi4py(FakeComm())
    inside = mpi.run_spmd(lambda: c.Allreduce(
        torch.ones(3, dtype=torch.float64), mpi.MPI_SUM))()
    res["mpi4py"] = (c.rank, c.size, inside)

    # A gradient taken from outside run_spmd.
    w = inp["w"].clone().requires_grad_()
    def gbody(w, data):
        return comm.Allreduce(w * data[comm.rank], mpi.MPI_SUM) ** 2
    out = mpi.run_spmd(gbody)(w, inp["gdata"])
    (gw,) = torch.autograd.grad(out.sum(), w)
    res["outside"] = (out.detach(), gw)

    # A traced Allreduce: this process's ranks' events.
    with obs.trace() as tr:
        mpi.run_spmd(lambda: comm.Allreduce(
            torch.ones(5, dtype=torch.float64) * (comm.rank + 1.0),
            mpi.MPI_SUM))()
    res["events"] = [(e.rank, e.world_size, e.channel, e.op,
                      repr(e.signature), e.payload_bytes, e.status)
                     for e in tr.events]

    # A collective mismatch across the processes.
    def mbody():
        x = torch.ones(3)
        return comm.Allreduce(x, mpi.MPI_SUM) if pid == 0 \\
            else comm.Allgather(x, 0)
    try:
        mpi.run_spmd(mbody)()
        res["mismatch"] = None
    except mpi.CommError as e:
        res["mismatch"] = type(e).__name__

    # The flagship's DP step, two steps outside deterministic mode and
    # one inside it.
    cfg = PT.TransformerConfig(**inp["cfg"])
    rows = inp["tokens"].shape[0] // 2
    def step(p, toks):
        idx = comm.rank * rows + torch.arange(rows)
        x = toks.index_select(0, idx)
        loss, g = dp.dp_value_and_grad(
            comm, lambda q, b: PT.lm_loss(cfg, q, b))(p, x)
        with torch.no_grad():
            return loss, tree_map(lambda a, b: a - inp["lr"] * b, p, g)
    p, dps = inp["params"], []
    for det in (False, False, True):
        with mpi.config.deterministic_mode(det):
            loss, new = mpi.run_spmd(step)(p, inp["tokens"])
        p = tree_map(lambda t: t[0], new)
        dps.append((loss, p))
    res["dp"] = dps

    # The q8 ring Allreduce, value and gradient of vdot(y, y).
    def qbody(xs):
        x = xs[comm.rank].detach().requires_grad_()
        y = comm.Allreduce(x, mpi.MPI_SUM, compression="q8",
                           algorithm="ring")
        (g,) = torch.autograd.grad(torch.vdot(y, y), x)
        return y, g
    res["q8"] = mpi.run_spmd(qbody)(inp["q8"])
    res["stats"] = mpi.transport.dist.stats()

    # The health probe across the processes, on a distributed world.
    from mpi4torch_tpu_torch import distributed as d
    from mpi4torch_tpu_torch.runtime import run_rank_threads
    from mpi4torch_tpu_torch.transport.dist import DistWorld
    w = DistWorld(n, d.local_ranks(), d.process_of_ranks(), device="cpu")
    reports = {}
    run_rank_threads(w, lambda r: reports.__setitem__(
        r, w.health_check(r, 20.0)))
    h = reports[pid]
    res["health"] = (h.ok, sorted(h.arrived), sorted(h.missing),
                     sorted(h.arrival_s))
    save("WORKER")
""")

_HYBRID_WORKER = _HEAD + textwrap.dedent("""
    info = mpi.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                                num_processes=n, process_id=pid,
                                local_device_ids=[0, 0, 0, 0],
                                device="cpu")
    assert info.n_devices == 8 and info.n_local_devices == 4, info
    m = mpi.hybrid_mesh({"tp": 4}, {"dp": 2})
    res["mesh"] = (m.axis_names, m.devices.shape, m.process_index.tolist())
    ctp = mpi.comm_from_mesh(m, "tp")
    cdp = mpi.comm_from_mesh(m, "dp")
    assert ctp.size == 4 and cdp.size == 2

    def body():
        one = torch.ones((), dtype=torch.float64)
        tp_sum = ctp.Allreduce(one * (ctp.rank + 1.0), mpi.MPI_SUM)
        dp_sum = cdp.Allreduce(one * (cdp.rank + 1.0), mpi.MPI_SUM)
        x = ((cdp.rank + 1.0) * torch.ones(2, dtype=torch.float64)
             ).requires_grad_()
        y = cdp.Allreduce(x, mpi.MPI_SUM)
        (g,) = torch.autograd.grad(torch.vdot(y, torch.ones_like(y)), x)
        return tp_sum, dp_sum, g
    res["sums"] = mpi.run_spmd(body, mesh=m, axis_name="dp")()

    data = torch.load(os.path.join(tmp, "fold.pt"))
    det = {}
    for fold in ("gather", "ring"):
        if fold == "ring":
            mpi.config.set_ordered_fold_gather_max_bytes(0)
            mpi.config.set_ordered_ring_chunk_bytes(256)
        with mpi.config.deterministic_mode(True):
            out = mpi.run_spmd(lambda d: comm.Allreduce(
                d[comm.rank], mpi.MPI_SUM))(data)
        det[fold] = mpi.local_values(out)
    res["det"] = det

    # A gradient from outside with four ranks a process: the replicated
    # input's cotangent sums all eight ranks' in one global order.
    w = torch.arange(5, dtype=torch.float64, requires_grad=True)
    out = mpi.run_spmd(lambda w, g: comm.Allreduce(
        w * g[comm.rank], mpi.MPI_SUM) ** 2)(w, torch.load(
            os.path.join(tmp, "gdata.pt")))
    (gw,) = torch.autograd.grad(out.sum(), w)
    res["outside"] = (out.detach(), gw)
    save("HYBRID")
""")

_RENDEZVOUS_WORKER = _HEAD + textwrap.dedent("""
    import time

    class FileComm:
        # mpi4py's bcast, through a file: rank 0 writes, the others read.
        def Get_rank(self): return pid
        def Get_size(self): return n
        def bcast(self, v, root=0):
            path = os.path.join(tmp, "addr")
            if pid == root:
                with open(path + ".tmp", "w") as f:
                    f.write(v)
                os.replace(path + ".tmp", path)
                return v
            for _ in range(600):
                if os.path.exists(path):
                    with open(path) as f:
                        return f.read()
                time.sleep(0.05)
            raise TimeoutError("no address from rank 0")
    fake = types.ModuleType("mpi4py"); fake.MPI = types.SimpleNamespace()
    sys.modules["mpi4py"] = fake
    os.environ["MPI4TORCH_TPU_COORDINATOR_HOST"] = "127.0.0.1"
    c = mpi.comm_from_mpi4py(FileComm(), device="cpu")
    info = mpi.distributed_info()
    res["layout"] = (c.rank, c.size, info.process_id, info.process_count,
                     info.coordinator_address)

    def body():
        x = ((c.rank + 1.0) * torch.ones(4, dtype=torch.float64)
             ).requires_grad_()
        y = c.Allreduce(x, mpi.MPI_SUM)
        (g,) = torch.autograd.grad(torch.vdot(y, torch.ones_like(y)), x)
        return y, g
    res["allreduce"] = mpi.run_spmd(body)()
    try:
        c.Allreduce(torch.ones(2), mpi.MPI_SUM)
        res["top_level"] = None
    except mpi.CommError as e:
        res["top_level"] = str(e)
    save("RDV")
""")

_EXIT_WORKER = textwrap.dedent("""
    import os, sys, time
    import torch
    pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import mpi4torch_tpu_torch as mpi
    comm = mpi.COMM_WORLD
    mpi.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=n, process_id=pid, device="cpu")
    out = mpi.run_spmd(lambda: comm.Allreduce(torch.ones(2),
                                              mpi.MPI_SUM))()
    assert out.tolist() == [[2.0, 2.0]], out
    if pid == 1:
        print("EXIT-1-LEAVING", flush=True)
        os._exit(0)
    t0 = time.monotonic()
    try:
        mpi.run_spmd(lambda: comm.Allreduce(torch.ones(2), mpi.MPI_SUM))()
        print("EXIT-0-NO-ERROR", flush=True)
    except mpi.CommError as e:
        print(f"EXIT-0-{type(e).__name__}-{sorted(getattr(e, 'ranks', ()))}"
              f"-{time.monotonic() - t0:.3f}", flush=True)
""")


@pytest.fixture(scope="module")
def flagship():
    """JAX's f64 weights and tokens, and the port's copy of them."""
    cfg = JT.TransformerConfig(**CFG)
    jparams = JT.init_transformer(jax.random.PRNGKey(0), cfg,
                                  dtype=jnp.float64)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    pparams = PT.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tokens, pparams


@pytest.fixture(scope="module")
def launch_a(tmp_path_factory, flagship):
    _, _, tokens, pparams = flagship
    tmp = str(tmp_path_factory.mktemp("launch_a"))
    torch.save({"params": pparams, "tokens": torch.from_numpy(tokens),
                "cfg": CFG, "lr": LR, "q8": torch.from_numpy(Q8),
                "w": torch.arange(5, dtype=torch.float64),
                "gdata": torch.from_numpy(GDATA)},
               os.path.join(tmp, "inputs.pt"))
    return _results(tmp, _launch(tmp, _WORKER), "WORKER")


@pytest.fixture(scope="module")
def launch_hybrid(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("launch_hybrid"))
    torch.save(torch.from_numpy(FOLD), os.path.join(tmp, "fold.pt"))
    torch.save(torch.from_numpy(GDATA8), os.path.join(tmp, "gdata.pt"))
    return _results(tmp, _launch(tmp, _HYBRID_WORKER), "HYBRID")


def _port_run_spmd(fn, *args, n=2):
    return P.run_spmd(fn, nranks=n, device="cpu")(*args)


# ------------------------------------------------------------ unit parity


class TestInitErrors:
    def test_reinit_with_conflicting_layout_raises(self, monkeypatch):
        for pkg, mod in ((mpi, jdist), (P, pdist)):
            monkeypatch.setitem(
                mod._STATE, "info",
                mod.DistributedInfo(process_id=0, process_count=2,
                                    n_devices=2, n_local_devices=1,
                                    coordinator_address="x:1"))
            with pytest.raises(pkg.CommError, match="already called"):
                pkg.init_distributed(num_processes=4, process_id=3)
            # Matching (or omitted) arguments are idempotent.
            assert pkg.init_distributed(num_processes=2).process_count == 2
            assert pkg.distributed_info().process_count == 2
            assert pkg.is_distributed()

    def test_finalize_without_init_is_noop(self):
        for pkg in (mpi, P):
            assert not pkg.is_distributed()
            pkg.finalize_distributed()
            assert pkg.distributed_info() is None

    def test_missing_layout_names_what_is_missing(self, monkeypatch):
        # The port's counterpart of JAX's cluster auto-detection is
        # torchrun's environment; with neither it says what is missing.
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(P.CommError, match="coordinator_address.*"
                                               "num_processes.*process_id"):
            P.init_distributed(device="cpu")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")
        with pytest.raises(P.CommError) as e:
            P.init_distributed(device="cpu")
        assert "MASTER_ADDR" in str(e.value)
        assert "WORLD_SIZE" not in str(e.value)
        assert not P.is_distributed()


class TestLocalValues:
    def test_single_process_run_spmd_output(self):
        jout = mpi.run_spmd(
            lambda: jnp.asarray(mpi.COMM_WORLD.rank) * jnp.ones(2),
            nranks=4)()
        pout = _port_run_spmd(
            lambda: P.COMM_WORLD.rank * torch.ones(2, dtype=torch.float64),
            n=4)
        jranks, jvals = mpi.local_values(jout)
        pranks, pvals = P.local_values(pout)
        np.testing.assert_array_equal(pranks, jranks)
        np.testing.assert_array_equal(pvals.numpy(), jvals)
        for r in range(4):
            np.testing.assert_array_equal(pvals[r].numpy(), float(r))

    def test_ndarray_passthrough(self):
        a = np.arange(6.0).reshape(3, 2)
        for pkg in (mpi, P):
            ranks, vals = pkg.local_values(a)
            np.testing.assert_array_equal(ranks, np.arange(3))
            np.testing.assert_array_equal(vals, a)

    def test_rejects_pytree(self):
        with pytest.raises(TypeError, match="per leaf"):
            mpi.local_values({"a": jnp.ones(2)})
        with pytest.raises(TypeError, match="per leaf"):
            P.local_values({"a": torch.ones(2)})


class _FakeSize1Comm:
    def Get_rank(self):
        return 0

    def Get_size(self):
        return 1


class _Fake2Comm:
    def __init__(self, rank=1, size=2):
        self._rank, self._size = rank, size

    def Get_rank(self):
        return self._rank

    def Get_size(self):
        return self._size


def _two_process_info(mod, process_id=1):
    return mod.DistributedInfo(process_id=process_id, process_count=2,
                               n_devices=2, n_local_devices=1,
                               coordinator_address="x:1")


class TestMpi4pyInterop:
    """JAX's stand-in cases, each on both packages: rank/size agreement,
    the Allreduce forward and backward through the converted
    communicator, and the error paths with the same types."""

    def _with_fake_mpi4py(self, monkeypatch):
        fake = types.ModuleType("mpi4py")
        fake.MPI = types.SimpleNamespace(COMM_WORLD=_FakeSize1Comm())
        monkeypatch.setitem(sys.modules, "mpi4py", fake)
        return fake

    def test_rank_size_agreement(self, monkeypatch):
        self._with_fake_mpi4py(monkeypatch)
        mcomm = _FakeSize1Comm()
        for pkg in (mpi, P):
            comm = pkg.comm_from_mpi4py(mcomm)
            assert comm.rank == mcomm.Get_rank()
            assert comm.size == mcomm.Get_size()

    def test_allreduce_forward_backward(self, monkeypatch):
        self._with_fake_mpi4py(monkeypatch)
        jc = mpi.comm_from_mpi4py(_FakeSize1Comm())
        jval, jgrad = jax.value_and_grad(
            lambda x: jnp.sum(jc.Allreduce(x, mpi.MPI_SUM)))(jnp.ones(10))
        pc = P.comm_from_mpi4py(_FakeSize1Comm())
        x = torch.ones(10, dtype=torch.float64, requires_grad=True)
        pval = pc.Allreduce(x, P.MPI_SUM).sum()
        (pgrad,) = torch.autograd.grad(pval, x)
        assert float(pval.detach()) == float(jval) == 10.0 * pc.size
        np.testing.assert_array_equal(pgrad.numpy(), np.asarray(jgrad))

    def test_works_inside_spmd_region(self, monkeypatch):
        self._with_fake_mpi4py(monkeypatch)
        jc = mpi.comm_from_mpi4py(_FakeSize1Comm())
        pc = P.comm_from_mpi4py(_FakeSize1Comm())
        jout = mpi.run_spmd(lambda: jc.Allreduce(jnp.ones(3), mpi.MPI_SUM),
                            nranks=4)()
        pout = _port_run_spmd(lambda: pc.Allreduce(
            torch.ones(3, dtype=torch.float64), P.MPI_SUM), n=4)
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(pout.numpy(), 4.0)

    def test_missing_mpi4py_raises(self, monkeypatch):
        import builtins

        real_import = builtins.__import__

        def blocked(name, *a, **k):
            if name.startswith("mpi4py"):
                raise ModuleNotFoundError("No module named 'mpi4py'")
            return real_import(name, *a, **k)

        monkeypatch.delitem(sys.modules, "mpi4py", raising=False)
        monkeypatch.setattr(builtins, "__import__", blocked)
        for pkg in (mpi, P):
            with pytest.raises(RuntimeError, match="mpi4py is not available"):
                pkg.comm_from_mpi4py(_FakeSize1Comm())

    def test_multiprocess_layout_mismatch_raises(self, monkeypatch):
        self._with_fake_mpi4py(monkeypatch)
        for pkg, mod in ((mpi, jdist), (P, pdist)):
            monkeypatch.setitem(mod._STATE, "info",
                                _two_process_info(mod, 0))
            with pytest.raises(pkg.CommError, match="layout|processes"):
                pkg.comm_from_mpi4py(_Fake2Comm(0, 3))

    def test_size1_subcomm_under_multiprocess_launch_raises(self,
                                                            monkeypatch):
        # COMM_SELF inside a two-process launch must not silently adopt
        # the two-process world.
        self._with_fake_mpi4py(monkeypatch)
        for pkg, mod in ((mpi, jdist), (P, pdist)):
            monkeypatch.setitem(mod._STATE, "info",
                                _two_process_info(mod, 0))
            with pytest.raises(pkg.CommError, match="subcommunicator"):
                pkg.comm_from_mpi4py(_FakeSize1Comm())

    def test_rank_reordered_comm_raises(self, monkeypatch):
        self._with_fake_mpi4py(monkeypatch)
        for pkg, mod in ((mpi, jdist), (P, pdist)):
            # MPI says 0, the runtime says 1.
            monkeypatch.setitem(mod._STATE, "info",
                                _two_process_info(mod, 1))
            with pytest.raises(pkg.CommError,
                               match="rank-reordered|not match"):
                pkg.comm_from_mpi4py(_Fake2Comm(0, 2))

    def test_top_level_ops_on_multiprocess_comm_raise(self, monkeypatch):
        self._with_fake_mpi4py(monkeypatch)
        for pkg, mod, x in ((mpi, jdist, jnp.ones(2)),
                            (P, pdist, torch.ones(2))):
            monkeypatch.setitem(mod._STATE, "info",
                                _two_process_info(mod, 1))
            comm = pkg.comm_from_mpi4py(_Fake2Comm(1, 2))
            assert comm.rank == 1 and comm.size == 2
            with pytest.raises(pkg.CommError, match="run_spmd"):
                comm.Allreduce(x, pkg.MPI_SUM)


class TestDistWire:
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                       torch.bool, torch.int64])
    def test_serialize_roundtrip_bitwise(self, dtype):
        g = torch.Generator().manual_seed(0)
        t = (torch.randn(7, 13, generator=g) * 100).to(dtype)
        obj = (("sig", 3), (True,), {"a": t, "b": [t[1:, ::2], None],
                                     "e": torch.empty(0, 4, dtype=dtype)})
        p = tdist.pack(obj)
        lens, offs, total = tdist._layout(p)
        buf = np.empty(total + 5, np.uint8)
        tdist._serialize_into(buf, p, lens, offs)
        assert all(o % tdist._ALIGN == 0 for o in offs)
        got = tdist.unpack(tdist._deserialize(buf), torch.device("cpu"))
        assert got[:2] == obj[:2]

        def bits(x):
            x = x.contiguous()
            return x if x.dtype == torch.bool else x.view(torch.uint8)

        for a, b in ((got[2]["a"], t), (got[2]["b"][0], t[1:, ::2])):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(bits(a), bits(b))
        assert got[2]["b"][1] is None and got[2]["e"].shape == (0, 4)

    def test_p2p_seams_raise(self):
        w = tdist.DistWorld(2, range(0, 1), (0, 1), device="cpu")
        with pytest.raises(P.CommError, match="collectives only"):
            w.p2p_send(0, 1, 0, torch.ones(1))
        with pytest.raises(P.CommError, match="collectives only"):
            w.p2p_recv(1, 0, 0)


# ------------------------------------------------------------ two processes


class TestTwoProcessIntegration:
    def test_two_process_allreduce_fwd_bwd(self, launch_a):
        def body():
            r = jnp.asarray(mpi.COMM_WORLD.rank)
            x = (r + 1.0) * jnp.ones((4,))

            def loss(x):
                y = mpi.COMM_WORLD.Allreduce(x, mpi.MPI_SUM)
                return jnp.vdot(y, jnp.ones((4,))), y

            (_, y), grad = jax.value_and_grad(loss, has_aux=True)(x)
            return y, grad

        jy, jg = mpi.run_spmd(body, nranks=2)()
        for pid, res in enumerate(launch_a):
            ranks, yv, gv = res["allreduce"]
            assert ranks == [pid]
            assert _bitwise(yv[0].numpy(), np.asarray(jy)[pid])
            assert _bitwise(gv[0].numpy(), np.asarray(jg)[pid])
            np.testing.assert_array_equal(yv[0].numpy(), 3.0)
            np.testing.assert_array_equal(gv[0].numpy(), 2.0)

    def test_hybrid_mesh_over_single_rank_processes(self, launch_a):
        for res in launch_a:
            names, shape, procs = res["hybrid"]
            assert names == ("dp", "tp")
            assert shape == {"dp": 2, "tp": 1}
            assert procs == [[0], [1]]

    def test_comm_from_mpi4py_on_initialized_runtime(self, launch_a):
        for pid, res in enumerate(launch_a):
            rank, size, inside = res["mpi4py"]
            assert (rank, size) == (pid, 2)
            np.testing.assert_array_equal(inside.numpy(), [[2.0] * 3])

    def test_gradient_from_outside_bitwise(self, launch_a):
        w = torch.arange(5, dtype=torch.float64, requires_grad=True)
        out = _port_run_spmd(lambda w, d: P.COMM_WORLD.Allreduce(
            w * d[P.COMM_WORLD.rank], P.MPI_SUM) ** 2, w,
            torch.from_numpy(GDATA))
        (gw,) = torch.autograd.grad(out.sum(), w)
        for pid, res in enumerate(launch_a):
            pout, pg = res["outside"]
            assert _bitwise(pout[0].numpy(), out[pid].detach().numpy())
            assert _bitwise(pg.numpy(), gw.numpy())

    def test_traced_allreduce_events_per_rank(self, launch_a):
        from mpi4torch_tpu_torch import obs

        with obs.trace() as tr:
            _port_run_spmd(lambda: P.COMM_WORLD.Allreduce(
                torch.ones(5, dtype=torch.float64)
                * (P.COMM_WORLD.rank + 1.0), P.MPI_SUM))
        for pid, res in enumerate(launch_a):
            want = [(e.rank, e.world_size, e.channel, e.op,
                     repr(e.signature), e.payload_bytes, e.status)
                    for e in tr.events_for(rank=pid)]
            assert want and res["events"] == want

    def test_health_probe_across_processes(self, launch_a):
        for res in launch_a:
            ok, arrived, missing, timed = res["health"]
            assert ok and arrived == [0, 1] and missing == []
            assert timed == [0, 1]

    def test_collective_mismatch_in_both_processes(self, launch_a):
        assert [r["mismatch"] for r in launch_a] == [
            "CollectiveMismatchError"] * 2

    def test_q8_ring_allreduce_bitwise(self, launch_a):
        def qbody(xs):
            x = xs[P.COMM_WORLD.rank].detach().requires_grad_()
            y = P.COMM_WORLD.Allreduce(x, P.MPI_SUM, compression="q8",
                                       algorithm="ring")
            (g,) = torch.autograd.grad(torch.vdot(y, y), x)
            return y, g

        y, g = _port_run_spmd(qbody, torch.from_numpy(Q8))
        for pid, res in enumerate(launch_a):
            py, pg = res["q8"]
            assert _bitwise(py[0].numpy(), y[pid].numpy())
            assert _bitwise(pg[0].numpy(), g[pid].numpy())

    def test_cross_process_bytes_counted(self, launch_a):
        for res in launch_a:
            st = res["stats"]
            assert st["rounds"] > 0 and st["sent_bytes"] > 0
        # Two processes: what one sends, the other receives.
        assert launch_a[0]["stats"]["sent_bytes"] == \
            launch_a[1]["stats"]["received_bytes"]


class TestFlagshipDpStep:
    def _one_process(self, flagship):
        _, _, tokens, pparams = flagship
        cfg = PT.TransformerConfig(**CFG)
        comm = P.COMM_WORLD
        rows = B // 2

        def step(p, toks):
            x = toks.index_select(0, comm.rank * rows + torch.arange(rows))
            loss, g = pdp.dp_value_and_grad(
                comm, lambda q, b: PT.lm_loss(cfg, q, b))(p, x)
            with torch.no_grad():
                return loss, tree_map(lambda a, b: a - LR * b, p, g)

        p, out = pparams, []
        for det in (False, False, True):
            with P.config.deterministic_mode(det):
                loss, new = _port_run_spmd(step, p,
                                           torch.from_numpy(tokens))
            p = tree_map(lambda t: t[0], new)
            out.append((loss, new))
        return out

    def test_bitwise_one_process_run_spmd(self, launch_a, flagship):
        want = self._one_process(flagship)
        for pid, res in enumerate(launch_a):
            for (loss, p), (wloss, wnew) in zip(res["dp"], want):
                assert _bitwise(loss[0].numpy(), wloss[pid].numpy())
                for a, b in zip(tree_leaves(p), tree_leaves(wnew)):
                    assert _bitwise(a.numpy(), b[pid].numpy())

    def test_within_bounds_of_jax_mode_a(self, launch_a, flagship):
        cfg, jparams, tokens, _ = flagship
        rows = B // 2
        comm = mpi.COMM_WORLD

        def body(p, toks):
            x = jax.lax.dynamic_slice_in_dim(
                toks, jnp.asarray(comm.rank + 0) * rows, rows)
            loss, g = jdp.dp_value_and_grad(
                comm, lambda q, b: JT.lm_loss(cfg, q, b))(p, x)
            return loss, jax.tree.map(lambda a, b: a - LR * b, p, g)

        p = jparams
        for (loss, got), det in zip(launch_a[0]["dp"], (False, False, True)):
            with mpi.config.deterministic_mode(det):
                jloss, jnew = mpi.run_spmd(body, nranks=2)(
                    p, jnp.asarray(tokens))
            p = jax.tree.map(lambda t: t[0], jnew)
            np.testing.assert_allclose(loss[0].item(), float(jloss[0]),
                                       **LOSS_TOL)
            for a, b in zip(tree_leaves(got), jax.tree.leaves(p)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **PARAM_TOL)
        for a, b in zip(tree_leaves(launch_a[0]["dp"][-1][1]),
                        tree_leaves(launch_a[1]["dp"][-1][1])):
            assert _bitwise(a.numpy(), b.numpy())


class TestHybridMeshMultiGranule:
    def test_layout_keeps_tp_rows_inside_one_process(self, launch_hybrid):
        for res in launch_hybrid:
            names, shape, procs = res["mesh"]
            assert names == ("dp", "tp") and shape == (2, 4)
            rows = [set(r) for r in procs]
            assert all(len(s) == 1 for s in rows)
            assert rows[0] != rows[1]

    def test_tp_and_dp_sums_and_dp_gradient(self, launch_hybrid):
        for res in launch_hybrid:
            tp_sum, dp_sum, g = res["sums"]
            assert tp_sum.shape[0] == 4
            np.testing.assert_array_equal(tp_sum.numpy(), 10.0)
            np.testing.assert_array_equal(dp_sum.numpy(), 3.0)
            np.testing.assert_array_equal(g.numpy(), 2.0)

    def test_gradient_from_outside_bitwise_one_process(self, launch_hybrid):
        w = torch.arange(5, dtype=torch.float64, requires_grad=True)
        out = _port_run_spmd(lambda w, g: P.COMM_WORLD.Allreduce(
            w * g[P.COMM_WORLD.rank], P.MPI_SUM) ** 2, w,
            torch.from_numpy(GDATA8), n=8)
        (gw,) = torch.autograd.grad(out.sum(), w)
        for pid, res in enumerate(launch_hybrid):
            pout, pg = res["outside"]
            assert _bitwise(pout.numpy(),
                            out[4 * pid:4 * pid + 4].detach().numpy())
            assert _bitwise(pg.numpy(), gw.numpy())

    @pytest.mark.parametrize("fold", ["gather", "ring"])
    def test_deterministic_fold_bitwise_jax_oracle(self, launch_hybrid,
                                                   fold):
        datj = jnp.asarray(FOLD)
        oracle = mpi.run_ranks(lambda r: np.asarray(
            mpi.COMM_WORLD.Allreduce(datj[r], mpi.MPI_SUM)), 8)
        seen = []
        for res in launch_hybrid:
            ranks, vals = res["det"][fold]
            for rk, v in zip(ranks, vals):
                assert _bitwise(v.numpy(), oracle[rk]), (fold, rk)
                seen.append(int(rk))
        assert sorted(seen) == list(range(8))


class TestRendezvousAndFailures:
    def test_comm_from_mpi4py_rendezvous_branch(self, tmp_path):
        runs = _launch(str(tmp_path), _RENDEZVOUS_WORKER)
        got = _results(str(tmp_path), runs, "RDV")
        addrs = set()
        for pid, res in enumerate(got):
            rank, size, ip, ipc, addr = res["layout"]
            assert (rank, size, ip, ipc) == (pid, 2, pid, 2)
            addrs.add(addr)
            y, g = res["allreduce"]
            np.testing.assert_array_equal(y.numpy(), [[3.0] * 4])
            np.testing.assert_array_equal(g.numpy(), [[2.0] * 4])
            assert "run_spmd" in res["top_level"]
        # Rank 0 picked one address and every process joined it.
        assert len(addrs) == 1 and addrs.pop().startswith("127.0.0.1:")

    def test_worker_exit_gives_typed_error(self, tmp_path):
        runs = _launch(str(tmp_path), _EXIT_WORKER,
                       env_extra={"MPI4TORCH_TPU_WORLD_TIMEOUT": "10"})
        (rc0, out0), (rc1, out1) = runs
        assert rc1 == 0 and "EXIT-1-LEAVING" in out1, out1
        assert rc0 == 0, out0
        line = [ln for ln in out0.splitlines() if ln.startswith("EXIT-0-")]
        assert line, out0
        kind, ranks, secs = line[0].split("-")[2:5]
        assert kind == "RankFailedError" and ranks == "[1]", line
        assert float(secs) < 10.0


def _mpirun():
    import shutil

    return shutil.which("mpirun") or shutil.which("mpiexec")


def _have_mpi4py() -> bool:
    try:
        import mpi4py  # noqa: F401

        return True
    except ModuleNotFoundError:
        return False


_MPI4PY_WORKER = textwrap.dedent("""
    import torch
    from mpi4py import MPI
    import mpi4torch_tpu_torch as mpi

    world = MPI.COMM_WORLD
    rank, size = world.Get_rank(), world.Get_size()
    comm = mpi.comm_from_mpi4py(world, device="cpu")
    assert comm.rank == rank and comm.size == size
    info = mpi.distributed_info()
    assert info is not None and info.process_count == size

    def body():
        x = ((mpi.COMM_WORLD.rank + 1.0) * torch.ones(4)).requires_grad_()
        y = mpi.COMM_WORLD.Allreduce(x, mpi.MPI_SUM)
        (g,) = torch.autograd.grad(torch.vdot(y, torch.ones(4)), x)
        return y, g

    y, g = mpi.run_spmd(body)()
    _, yv = mpi.local_values(y)
    _, gv = mpi.local_values(g)
    assert (yv[0] == sum(range(1, size + 1))).all()
    assert (gv[0] == float(size)).all()
    assert world.allreduce(rank + 1.0) == sum(range(1, size + 1))
    print(f"MPIRUN-WORKER-{rank}-OK", flush=True)
""")


@pytest.mark.skipif(_mpirun() is None or not _have_mpi4py(),
                    reason="needs mpirun + mpi4py (installed in the CI "
                           "mpi-interop job; not in every dev image)")
class TestRealMpirunInterop:
    """comm_from_mpi4py under an actual 2-process MPI launch, as JAX's
    test of the same name runs it."""

    def test_two_rank_launch(self, tmp_path):
        script = tmp_path / "mpi4py_worker.py"
        script.write_text(_MPI4PY_WORKER)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["MPI4TORCH_TPU_COORDINATOR_HOST"] = "127.0.0.1"
        cmd = [_mpirun(), "-np", "2", "--oversubscribe", sys.executable,
               str(script)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300, env=env)
        except subprocess.TimeoutExpired:
            pytest.fail("mpirun interop launch timed out")
        if r.returncode != 0 and "--oversubscribe" in " ".join(
                r.stderr.splitlines()[:5]):
            cmd.remove("--oversubscribe")
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300, env=env)
        assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
        for rank in range(2):
            assert f"MPIRUN-WORKER-{rank}-OK" in r.stdout
