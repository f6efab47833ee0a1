"""Communicator pickling in the port: ``COMM_WORLD`` round-trips to the
singleton, as in the JAX package (``tests/test_pickle.py::
TestCommWorldPickle``), and the restored communicator works on rank
threads and on process-transport workers, where every shipped rank body
that captures ``COMM_WORLD`` depends on it.  The JAX package's refusal to
pickle a mesh communicator is held in ``tests/test_torch_spmd.py``."""

import copy
import pickle

import torch

import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch import COMM_WORLD as comm


class TestCommWorldPickle:
    def test_round_trip_restores_singleton(self):
        assert pickle.loads(pickle.dumps(comm)) is mpi.COMM_WORLD

    def test_copies_are_the_singleton(self):
        assert copy.copy(comm) is comm
        state = {"comm": comm, "params": [torch.ones(2)]}
        state2 = copy.deepcopy(state)
        assert state2["comm"] is comm
        assert state2["params"][0] is not state["params"][0]

    def test_restored_comm_is_usable_on_rank_threads(self):
        restored = pickle.loads(pickle.dumps(comm))

        def body():
            x = torch.full((3,), float(restored.rank) + 1.0,
                           dtype=torch.float64)
            return restored.Allreduce(x, mpi.MPI_SUM)

        for out in mpi.run_ranks(body, 4, device="cpu"):
            assert torch.equal(out, torch.full((3,), 10.0,
                                               dtype=torch.float64))

    def test_restored_comm_is_usable_on_workers(self):
        restored = pickle.loads(pickle.dumps(comm))

        def body():
            x = torch.full((3,), float(restored.rank) + 1.0,
                           dtype=torch.float64)
            return (restored.Allreduce(x, mpi.MPI_SUM), restored.size,
                    pickle.loads(pickle.dumps(restored)) is mpi.COMM_WORLD)

        outs = mpi.run_ranks(body, 3, backend="process", device="cpu")
        for out, size, singleton in outs:
            assert torch.equal(out, torch.full((3,), 6.0,
                                               dtype=torch.float64))
            assert size == 3 and singleton

    def test_pickle_inside_rank_context(self):
        # Pickled on a rank thread, the blob still denotes the world, not
        # a rank-bound view: the rank is resolved where it is used.
        blobs = mpi.run_ranks(lambda: pickle.dumps(comm), 2, device="cpu")
        assert pickle.loads(blobs[0]) is mpi.COMM_WORLD
        assert blobs[0] == blobs[1]
