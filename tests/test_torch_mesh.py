"""The port's meshes (``mesh.device_mesh``/``hybrid_mesh``) against the JAX
package's, mirroring ``tests/test_mesh.py``: axis order and sizes, the
tier assignment, the refusals, and that a mesh plugs straight into
``comm_from_mesh``/``run_spmd`` collectives.  The ranks run as threads on
the CPU (``devices=``); without ``devices=`` every rank gets the world's
one device, where the JAX package needs distinct devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as mpi
import mpi4torch_tpu_torch as P


def _cpus(n):
    return [torch.device("cpu")] * n


class TestDeviceMesh:
    def test_axes_order_and_sizes(self):
        mesh = P.device_mesh({"dp": 2, "tp": 4}, devices=_cpus(8))
        jmesh = mpi.device_mesh({"dp": 2, "tp": 4})
        assert mesh.axis_names == tuple(jmesh.axis_names) == ("dp", "tp")
        assert mesh.shape == dict(jmesh.shape) == {"dp": 2, "tp": 4}
        assert mesh.devices.shape == jmesh.devices.shape == (2, 4)
        assert mesh.size == 8
        assert {str(d) for d in mesh.devices.reshape(-1)} == {"cpu"}

    @pytest.mark.parametrize("axes", [{"dp": 3, "tp": 2}, {"w": 7}])
    def test_size_mismatch_raises(self, axes):
        with pytest.raises(ValueError, match="multiply to"):
            P.device_mesh(axes, devices=_cpus(8))
        with pytest.raises(ValueError, match="multiply to"):
            mpi.device_mesh(axes)

    def test_collectives_over_helper_mesh(self):
        mesh = P.device_mesh({"dp": 2, "tp": 4}, devices=_cpus(8))
        comm_tp = P.comm_from_mesh(mesh, "tp")
        out = P.run_spmd(lambda: comm_tp.Allreduce(torch.ones(()),
                                                   P.MPI_SUM),
                         mesh=mesh, axis_name="dp")()
        np.testing.assert_array_equal(out.numpy(), np.full(8, 4.0))
        # The JAX package's mesh, through its own shard_map: the same.
        jmesh = mpi.device_mesh({"dp": 2, "tp": 4})
        jtp = mpi.comm_from_mesh(jmesh, "tp")
        from jax.sharding import PartitionSpec as PS
        from mpi4torch_tpu._compat import shard_map
        jout = jax.jit(shard_map(
            lambda: jtp.Allreduce(jnp.ones(()), mpi.MPI_SUM)[None],
            mesh=jmesh, in_specs=(), out_specs=PS(("dp", "tp")),
            check_vma=False))()
        np.testing.assert_array_equal(np.asarray(jout), out.numpy())

    def test_default_devices_repeat_the_world_device(self, monkeypatch):
        # One card hosts every rank thread: without devices= each rank of
        # the mesh gets the world's device (here a stand-in for CUDA).
        from mpi4torch_tpu_torch import runtime
        monkeypatch.setattr(runtime, "resolve_device",
                            lambda device=None: torch.device("cpu"))
        mesh = P.device_mesh({"dp": 2, "tp": 2})
        assert mesh.devices.shape == (2, 2)
        assert {str(d) for d in mesh.devices.reshape(-1)} == {"cpu"}

    def test_run_spmd_refuses_a_mesh_of_several_devices(self):
        mesh = P.device_mesh({"w": 2}, devices=["cpu", "meta"])
        with pytest.raises(P.CommError, match="one device"):
            P.run_spmd(lambda x: x, mesh=mesh, axis_name="w")


class TestHybridMesh:
    def test_single_granule_degrades_to_device_mesh(self):
        mesh = P.hybrid_mesh({"tp": 8}, {"dp": 1}, devices=_cpus(8))
        jmesh = mpi.hybrid_mesh({"tp": 8}, {"dp": 1})
        assert mesh.axis_names == tuple(jmesh.axis_names) == ("dp", "tp")
        assert mesh.shape == dict(jmesh.shape) == {"dp": 1, "tp": 8}

    def test_single_granule_rejects_wide_dcn(self):
        with pytest.raises(ValueError, match="one granule"):
            P.hybrid_mesh({"tp": 4}, {"dp": 2}, devices=_cpus(8))
        with pytest.raises(ValueError, match="one granule"):
            mpi.hybrid_mesh({"tp": 4}, {"dp": 2})

    def test_axis_name_collision_raises(self):
        with pytest.raises(ValueError, match="disjoint"):
            P.hybrid_mesh({"dp": 8}, {"dp": 1}, devices=_cpus(8))

    def test_size_mismatch_raises(self):
        with pytest.raises(ValueError, match="multiply to"):
            P.hybrid_mesh({"tp": 3}, {"dp": 1}, devices=_cpus(8))
