"""The port's process transport (``mpi4torch_tpu_torch.transport``) on the
CPU: ``run_ranks(backend="process")`` against the port's rank threads and
against the JAX package's own process backend.

Mirrors ``tests/test_transport.py``: the registry, bitwise thread-vs-process
parity on (3,) worlds (the plain Allreduce and p2p also bitwise JAX's
process backend on seeded numpy float64 inputs), the pool's reuse (PIDs
stay, a respawn only after a kill), real SIGKILL/SIGTERM attribution, the
postmortem shipped from a dead worker, function shipping and events
shipped to the parent tracer; plus what the port adds: the payload codec,
the configuration and torch numeric state shipped to workers, a
switchboard that only moves bytes, and workers without JAX.

Rank bodies are closures: a function defined at module level here does
not ship (the workers cannot import a test file).  JAX's ``slow``
cross-matrix class reruns elastic and chaos cells on worker processes.
"""

import os
import pickle
import signal
import sys

import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch import COMM_WORLD as comm
from mpi4torch_tpu_torch import config, transport
from mpi4torch_tpu_torch.resilience import FaultSpec, fault_scope
from mpi4torch_tpu_torch.resilience.matrix import run_cell
from mpi4torch_tpu_torch.runtime import (CollectiveMismatchError,
                                         CommError, DeadlockError,
                                         IntegrityError, RankFailedError)
from mpi4torch_tpu_torch.transport import _ship, process, wire
from mpi4torch_tpu_torch.transport.__main__ import (bitwise_equal,
                                                    parity_bodies,
                                                    transport_problems)
from mpi4torch_tpu_torch.transport.pool import WorkerPool, shared_pool

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_pool():
    # The JAX package's process pool is per pytest process: leave it
    # empty, as a fresh process would have it, for whichever file runs
    # next here (its pool tests count spawns).
    from mpi4torch_tpu import transport as jtransport

    yield
    jtransport.shutdown()


@pytest.fixture(autouse=True)
def _restore_config():
    yield
    config.set_comm_transport("thread")
    config.set_comm_finite_guard("off")
    config.set_comm_retries(0)
    config.set_default_bucket_bytes(config.DEFAULT_BUCKET_BYTES)
    config.set_comm_tracer(None)
    config.set_fault_plan(None)


def _inputs(n=3, numel=64):
    return np.random.default_rng(0).standard_normal((n, numel))


def _plain_body(xs):
    def body(rank):
        x = torch.from_numpy(xs[rank].copy())
        return comm.Allreduce(x, mpi.MPI_SUM), os.getpid()
    return body


def _jax_plain_body(xs):
    import jax.numpy as jnp

    def body(rank):
        x = jnp.asarray(xs[rank])
        return np.asarray(jmpi.COMM_WORLD.Allreduce(x, jmpi.MPI_SUM))
    return body


def _run(body, n, backend):
    return mpi.run_ranks(body, n, backend=backend, device=CPU)


def _first_difference(a, b):
    """Where two results part, for an assertion message."""
    from mpi4torch_tpu_torch.utils.tree import tree_leaves

    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) \
                and x.shape == y.shape and not torch.equal(x, y):
            k = int((x != y).reshape(-1).nonzero()[0])
            return (f"leaf {i} {x.dtype}{tuple(x.shape)} element {k}: "
                    f"{x.reshape(-1)[k].item()!r} vs {y.reshape(-1)[k].item()!r}")
    return f"structure: {a!r} vs {b!r}"


# ------------------------------------------------------------ registry


class TestRegistry:
    def test_both_backends_registered(self):
        assert transport.available_transports() == ["process", "thread"]
        assert transport_problems() == []

    def test_shadowing_refused(self):
        class Impostor(transport.Transport):
            name = "thread"

        with pytest.raises(ValueError, match="already registered"):
            transport.register_transport(Impostor)
        assert transport.TRANSPORTS["thread"] is not Impostor

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError, match="unknown transport"):
            transport.get_transport("smoke-signals")
        with pytest.raises(ValueError, match="unknown transport"):
            mpi.run_ranks(lambda r: r, 2, backend="smoke-signals",
                          device=CPU)
        with pytest.raises(ValueError, match="comm_transport"):
            config.set_comm_transport("smoke-signals")
        assert config.comm_transport() == "thread"

    @pytest.mark.parametrize("backend", ["thread", "process"])
    def test_size_zero_world_rejected_on_both_backends(self, backend):
        with pytest.raises(ValueError, match="World size"):
            mpi.run_ranks(lambda rank: rank, 0, backend=backend, device=CPU)


# -------------------------------------------------------------- parity


class TestProcessParity:
    def test_plain_allreduce_bitwise_threads_and_jax(self):
        xs = _inputs()
        got = _run(_plain_body(xs), 3, "process")
        oracle = _run(_plain_body(xs), 3, "thread")
        jax_proc = jmpi.run_ranks(_jax_plain_body(xs), 3, backend="process")
        launcher, pids = os.getpid(), set()
        for rank in range(3):
            assert got[rank][0].dtype == torch.float64
            assert bitwise_equal(got[rank][0], oracle[rank][0])
            np.testing.assert_array_equal(got[rank][0].numpy(),
                                          jax_proc[rank])
            assert got[rank][1] != launcher
            assert oracle[rank][1] == launcher
            pids.add(got[rank][1])
        assert len(pids) == 3, "ranks shared a worker process"

    def test_transport_scope_sets_default(self):
        xs = _inputs()
        with config.transport_scope("process"):
            assert config.comm_transport() == "process"
            got = mpi.run_ranks(_plain_body(xs), 3, device=CPU)
        assert config.comm_transport() == "thread"
        assert all(got[r][1] != os.getpid() for r in range(3))

    def test_p2p_over_the_wire(self):
        xs = _inputs(2, 8)

        def body(rank):
            if rank == 0:
                comm.Send(torch.from_numpy(xs[0].copy()), 1, 3)
                return None
            return comm.Recv(torch.zeros(8, dtype=torch.float64), 0, 3)

        def jbody(rank):
            import jax.numpy as jnp

            c = jmpi.COMM_WORLD
            if rank == 0:
                c.Send(jnp.asarray(xs[0]), dest=1, tag=3)
                return None
            return np.asarray(c.Recv(jnp.zeros(8, jnp.float64), source=0,
                                     tag=3))

        got = _run(body, 2, "process")
        assert bitwise_equal(got, _run(body, 2, "thread"))
        np.testing.assert_array_equal(
            got[1].numpy(), jmpi.run_ranks(jbody, 2, backend="process")[1])
        np.testing.assert_array_equal(got[1].numpy(), xs[0])

    @pytest.mark.parametrize("name", ["deterministic", "fused", "q8", "p2p"])
    def test_parity_lane_bitwise(self, name):
        n, body = parity_bodies()[name]
        a, b = _run(body, n, "thread"), _run(body, n, "process")
        assert bitwise_equal(a, b), _first_difference(a, b)

    def test_default_bucket_size_reaches_the_workers(self):
        # A process-wide knob set outside run_ranks changes the fused
        # layout on both backends alike.
        def body(rank):
            t = {"a": torch.arange(40.0, dtype=torch.float64) * (rank + 1),
                 "b": torch.ones(9, dtype=torch.float64) * rank}
            return comm.Allreduce_tree(t, mpi.MPI_SUM, mean=True), \
                config.default_bucket_bytes()

        config.set_default_bucket_bytes(128)
        a, b = _run(body, 3, "thread"), _run(body, 3, "process")
        assert bitwise_equal(a, b)
        assert [r[1] for r in b] == [128] * 3

    def test_finite_guard_raises_the_same_attribution(self):
        def body(rank):
            x = torch.arange(16, dtype=torch.float64) + rank
            try:
                comm.Allreduce(x, mpi.MPI_SUM)
            except Exception as e:  # noqa: BLE001 — the outcome under test
                return type(e).__name__, sorted(getattr(e, "ranks", ()))
            return "ok", []

        config.set_comm_finite_guard("raise")
        spec = FaultSpec("corrupt_nan", rank=1, op="Allreduce")
        outcomes = {}
        for backend in ("thread", "process"):
            with fault_scope([spec]) as plan:
                outcomes[backend] = _run(body, 3, backend)
            assert "corrupt_nan" in plan.fired_kinds()
        assert outcomes["process"] == outcomes["thread"] \
            == [("IntegrityError", [1])] * 3

    def test_mismatched_collectives_raise_not_hang(self):
        def body(rank):
            x = torch.ones(4, dtype=torch.float64)
            if rank == 0:
                return comm.Allgather(x, 0)
            return comm.Allreduce(x, mpi.MPI_SUM)

        with pytest.raises(CollectiveMismatchError):
            mpi.run_ranks(body, 3, backend="process", device=CPU,
                          timeout=10.0)

    def test_a_rank_that_never_arrives_is_attributed(self):
        def body(rank):
            x = torch.ones(4, dtype=torch.float64)
            if rank != 2:
                comm.Allreduce(x, mpi.MPI_SUM)

        with pytest.raises(DeadlockError) as ei:
            mpi.run_ranks(body, 3, backend="process", device=CPU,
                          timeout=0.5)
        assert ei.value.arrived == frozenset({0, 1})
        assert ei.value.missing == frozenset({2})


# ---------------------------------------------------- state and wire


class TestShippedState:
    def test_config_and_torch_numeric_state_reach_the_workers(self):
        def body(rank):
            return {
                "retries": config.comm_retries(),
                "backoff": config.comm_backoff(),
                "guard": config.comm_finite_guard(),
                "checksum": config.comm_wire_checksum(),
                "compression": getattr(config.default_compression(),
                                       "name", None),
                "hop": config.quant_hop_impl(),
                "timeout": os.environ.get(config.WORLD_TIMEOUT_ENV),
                "dtype": torch.get_default_dtype(),
                "precision": torch.get_float32_matmul_precision(),
                "threads": torch.get_num_threads(),
                "det_algos": torch.are_deterministic_algorithms_enabled(),
                "det_mode": config.deterministic_reductions(),
            }

        saved = (torch.get_default_dtype(),
                 torch.get_float32_matmul_precision(),
                 torch.get_num_threads(),
                 torch.are_deterministic_algorithms_enabled(),
                 os.environ.get(config.WORLD_TIMEOUT_ENV))
        try:
            config.set_comm_retries(3)
            config.set_comm_backoff(0.25)
            config.set_comm_finite_guard("warn")
            config.set_comm_wire_checksum(True)
            config.set_default_compression("q8_ef")
            config.set_quant_hop_impl("torch")
            os.environ[config.WORLD_TIMEOUT_ENV] = "7.5"
            torch.set_default_dtype(torch.float64)
            torch.set_float32_matmul_precision("medium")
            torch.set_num_threads(2)
            torch.use_deterministic_algorithms(True)
            # Thread-scoped state does not reach rank threads, nor workers.
            with config.deterministic_mode(True):
                got = _run(body, 2, "process")
                want = _run(body, 2, "thread")
        finally:
            config.set_comm_backoff(0.05)
            config.set_comm_wire_checksum(False)
            config.set_default_compression(None)
            config.set_quant_hop_impl("auto")
            torch.set_default_dtype(saved[0])
            torch.set_float32_matmul_precision(saved[1])
            torch.set_num_threads(saved[2])
            torch.use_deterministic_algorithms(saved[3])
            if saved[4] is None:
                os.environ.pop(config.WORLD_TIMEOUT_ENV, None)
            else:
                os.environ[config.WORLD_TIMEOUT_ENV] = saved[4]
        assert got == want
        assert got[0] == {
            "retries": 3, "backoff": 0.25, "guard": "warn",
            "checksum": True, "compression": "q8_ef", "hop": "torch",
            "timeout": "7.5", "dtype": torch.float64, "precision": "medium",
            "threads": 2, "det_algos": True, "det_mode": False}
        # ...and a later run ships the restored state.
        assert _run(body, 2, "process")[1]["dtype"] == saved[0]

    def test_no_jax_in_a_worker(self):
        def body(rank):
            return ("jax" in sys.modules,
                    any(m == "mpi4torch_tpu" or m.startswith("mpi4torch_tpu.")
                        for m in sys.modules))

        assert _run(body, 3, "process") == [(False, False)] * 3

    def test_a_worker_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA: the workers would find it")
        with pytest.raises(RuntimeError, match="CUDA"):
            mpi.run_ranks(lambda rank: rank, 2, backend="process")

    def test_a_worker_that_cannot_start_is_a_timeout(self, monkeypatch):
        pool = WorkerPool()
        monkeypatch.setattr(sys, "executable", "/bin/false")
        try:
            with pytest.raises(TimeoutError, match="before connecting"):
                pool.lease(1)
        finally:
            monkeypatch.undo()
            pool.shutdown()

    def test_the_switchboard_moves_only_bytes(self, monkeypatch):
        seen = []
        orig = process._Switchboard.handle_op

        def spy(self, f):
            if "payload" in f:
                p = f["payload"]
                seen.append((type(p), type(p.meta),
                             {(type(b), b.dtype, b.ndim) for b in p.bufs}))
            return orig(self, f)

        monkeypatch.setattr(process._Switchboard, "handle_op", spy)
        n, body = parity_bodies()["p2p"]
        _run(body, n, "process")
        _run(_plain_body(_inputs()), 3, "process")
        # Raw bytes: the structure's pickle and one uint8 buffer a tensor.
        assert seen and all(
            t is wire.Packed and m is bytes
            and bt <= {(np.ndarray, np.dtype(np.uint8), 1)}
            for t, m, bt in seen), seen
        assert not any(isinstance(v, torch.Tensor)
                       for v in vars(process).values())

    def test_wire_census(self):
        xs = _inputs(3, 1024)
        _run(_plain_body(xs), 3, "process")
        st = transport.get_transport("process").last_stats
        assert st["rendezvous"] == 1 and st["nranks"] == 3
        data = 3 * 1024 * 8
        assert data < st["payload_bytes_in"] < data + 3 * 1024
        assert st["payload_bytes_out"] == 3 * st["payload_bytes_in"]


class TestPayloadCodec:
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                       torch.bfloat16, torch.float16,
                                       torch.int8, torch.int64, torch.bool,
                                       torch.complex64])
    def test_round_trip_bitwise(self, dtype):
        g = torch.Generator().manual_seed(3)
        base = torch.randn(5, 7, generator=g, dtype=torch.float64)
        x = (base > 0) if dtype == torch.bool else base.to(dtype)
        tree = {"x": x, "scalar": x[2, 3], "empty": x[:0], "meta": (1, "a"),
                "none": None}
        back = wire.unpack(pickle.loads(pickle.dumps(wire.pack(tree),
                                                     protocol=5)))
        assert bitwise_equal(back, tree)
        assert back["scalar"].shape == () and back["empty"].shape == (0, 7)

    def test_a_view_carries_only_its_elements(self):
        big = torch.arange(1 << 16, dtype=torch.float32)
        view = big[100:116]
        p = wire.pack(view)
        assert sum(len(memoryview(b).cast("B")) for b in p.bufs) == 64
        back = wire.unpack(p)
        assert torch.equal(back, view)
        back += 1     # a tensor of its own
        assert big[100] == 100
        t = torch.arange(12.0).reshape(3, 4).t()      # non-contiguous
        assert torch.equal(wire.unpack(wire.pack(t)), t)

    def test_frames_carry_buffers_out_of_band(self):
        import socket
        import threading

        a, b = socket.socketpair()
        try:
            x = torch.arange(1 << 18, dtype=torch.float32)
            sent = []
            writer = threading.Thread(target=lambda: sent.append(
                wire.send_frame(a, {"kind": "x", "p": wire.pack(x)})))
            writer.start()
            f = wire.recv_frame(b)
            writer.join()
            assert sent[0] >= x.numel() * 4
            buf = f["p"].bufs[0]
            assert isinstance(buf, np.ndarray) and buf.dtype == np.uint8
            assert buf.nbytes == x.numel() * 4
            assert torch.equal(wire.unpack(f["p"]), x)
        finally:
            a.close()
            b.close()


# ------------------------------------------------------------------ pool


class TestWorkerPoolReuse:
    def test_pool_is_reused_and_pids_stable(self):
        xs = _inputs()
        a = _run(_plain_body(xs), 3, "process")
        before = shared_pool().spawned_total
        b = _run(_plain_body(xs), 3, "process")
        assert shared_pool().spawned_total == before, \
            "a fault-free rerun respawned workers"
        assert {r[1] for r in a} == {r[1] for r in b}

    @pytest.mark.parametrize("device", [None, "cpu"])
    def test_lease_hands_the_device_to_spawned_workers(self, device):
        pool = WorkerPool()
        try:
            (w,) = pool.lease(1, device=device)
            want = [pool.addr] if device is None else [pool.addr, device]
            assert w.proc.args[-len(want):] == want
            assert w.is_live()
        finally:
            pool.shutdown()

    def test_respawn_only_after_kill(self):
        xs = _inputs()
        _run(_plain_body(xs), 3, "process")     # the pool is warm
        before = shared_pool().spawned_total
        rec = run_cell("rank_death", "plain", nranks=3, backend="process",
                       device=CPU)
        assert rec["status"] == "ok", rec["detail"]
        _run(_plain_body(xs), 3, "process")
        after = shared_pool().spawned_total
        assert after == before + 1, \
            f"one SIGKILL must cost exactly one respawn ({before} -> {after})"


# --------------------------------------------------------------- signals


class TestRealSignals:
    def test_rank_death_is_a_real_sigkill_and_attributed(self):
        xs = _inputs()
        pids = [r[1] for r in _run(_plain_body(xs), 3, "process")]
        rec = run_cell("rank_death", "plain", nranks=3, backend="process",
                       device=CPU)
        assert rec["status"] == "ok", rec["detail"]
        assert rec["backend"] == "process"
        assert rec["fired"] == ["rank_death"]
        assert "naming rank [1]" in rec["detail"], rec["detail"]
        # The kill was real: rank 1's worker is gone and reaped.
        with pytest.raises(ProcessLookupError):
            os.kill(pids[1], 0)
        assert pids[1] not in shared_pool().pids()

    def test_preempt_cell_over_process_backend(self):
        rec = run_cell("preempt", "plain", nranks=3, backend="process",
                       device=CPU)
        assert rec["status"] == "ok", rec["detail"]
        assert "preempt" in rec["fired"]

    def test_real_sigterm_lands_on_the_preemption_board(self):
        def body(rank):
            if rank == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            x = torch.ones(8, dtype=torch.float64) * (rank + 1)
            return comm.Allreduce(x, mpi.MPI_SUM)

        from mpi4torch_tpu_torch.resilience import pending_preemptions

        try:
            got = _run(body, 3, "process")
            for r in range(3):
                assert torch.equal(got[r], torch.full((8,), 6.0,
                                                      dtype=torch.float64))
            assert transport.external_preemptions().get(1) == 64
            assert pending_preemptions().get(1) == 64
            # The worker took the notice and lives on.
            assert len(set(shared_pool().pids())) >= 3
        finally:
            transport.clear_external_preemption(1)
        assert 1 not in transport.external_preemptions()
        assert 1 not in pending_preemptions()

    def test_postmortem_ships_from_the_dead_worker(self):
        spec = FaultSpec("rank_death", rank=1, op="Allreduce", index=0)

        def body(rank):
            return comm.Allreduce(torch.ones(8, dtype=torch.float64),
                                  mpi.MPI_SUM)

        with mpi.obs.trace() as t:
            with fault_scope([spec]) as plan:
                with pytest.raises(RankFailedError) as ei:
                    mpi.run_ranks(body, 3, timeout=30.0, backend="process",
                                  device=CPU)
        assert set(ei.value.ranks) == {1}
        assert plan.fired_kinds() == {"rank_death"}
        assert len(t.postmortems) == 1, t.postmortems
        pm = t.postmortems[0]
        assert tuple(pm["failed_ranks"]) == (1,)
        assert sorted(pm["observer_ranks"]) == [0, 1, 2], pm
        assert {0, 2} <= set(pm["tails"])


# -------------------------------------------------------------- shipping


class TestFunctionShipping:
    def test_closure_roundtrip(self):
        base = 17

        def fn(rank, scale=3):
            return (rank + base) * scale

        out = _ship.loads(_ship.dumps(fn))
        assert out(2) == fn(2) == 57
        assert out(0, scale=1) == 17

    def test_module_and_importable_travel_by_reference(self):
        back = _ship.loads(_ship.dumps({"torch": torch, "fn": torch.arange,
                                        "np": np}))
        assert back["torch"] is torch and back["fn"] is torch.arange
        assert back["np"] is np

    def test_comm_world_self_restores(self):
        assert _ship.loads(_ship.dumps(comm)) is comm

    def test_error_types_pickle_with_attribution(self):
        e = RankFailedError("rank 1 died", ranks=(1,))
        e.add_note("other rank failures: rank 2: CommError: aborted")
        e2 = pickle.loads(pickle.dumps(e))
        assert type(e2) is RankFailedError and e2.ranks == {1}
        assert e2.__notes__ == e.__notes__
        d = DeadlockError("deadlock", arrived=(0, 1), missing=(2,))
        d2 = pickle.loads(pickle.dumps(d))
        assert d2.arrived == {0, 1} and d2.missing == {2}
        i2 = pickle.loads(pickle.dumps(IntegrityError("nan", ranks=(2,))))
        assert i2.ranks == {2}
        m2 = pickle.loads(pickle.dumps(
            CollectiveMismatchError("sig mismatch at op 3")))
        assert type(m2) is CollectiveMismatchError
        assert "sig mismatch at op 3" in str(m2)
        assert isinstance(d2, CommError)


# -------------------------------------------------------------- tracing


class TestObsOverTheWire:
    def test_events_from_every_worker_reach_the_parent(self):
        xs = _inputs()
        counts = {}
        for backend in ("thread", "process"):
            with mpi.obs.trace() as t:
                _run(_plain_body(xs), 3, backend)
            evs = list(t.events)
            assert [e.seq for e in evs] == sorted(e.seq for e in evs)
            assert len({e.world for e in evs}) == 1
            counts[backend] = {r: len(t.events_for(rank=r))
                               for r in range(3)}
        assert counts["process"] == counts["thread"]
        assert all(n > 0 for n in counts["process"].values())


@pytest.mark.slow
class TestCrossMatrixProcessReruns:
    """The elastic matrix's rank_death and preempt cells and one chaos
    cell, rerun over worker processes through ``transport_scope``."""

    @pytest.mark.parametrize("kind", ["rank_death", "preempt"])
    def test_elastic_shrink_cells(self, kind):
        from mpi4torch_tpu_torch.elastic.matrix import run_cell as ecell

        with mpi.config.transport_scope("process"):
            rec = ecell(kind, "plain", "shrink", device="cpu")
        assert rec["status"] == "ok", rec["detail"]
        assert kind in rec["fired"]

    def test_chaos_slow_rank_cell(self):
        from mpi4torch_tpu_torch.resilience.chaos import run_chaos_cell

        with mpi.config.transport_scope("process"):
            rec = run_chaos_cell("slow_rank", "plain", device="cpu")
        assert rec["status"] == "ok", rec["detail"]
