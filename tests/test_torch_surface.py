"""The port's package surface and its rank means.

Surface: every name the JAX package exports in the ``__all__`` of the
package and of every subpackage that has one exists in the port, or is
listed in ``UNPORTED`` under the ROADMAP.md Queue 1 item it waits for; a
listed name the port keeps as a stub raises ``NotImplementedError``
naming that item.

Means: a rank mean divides by a 0-d tensor on the operand's device
(``constants.divide``), which is a true division on every device.  At a
3-rank world, where ``1/3`` is inexact, the DP mean, ``Allreduce_tree``'s
mean (per leaf, fused and pipelined), the fused and scheduled
reduce-scatter means and ZeRO-1 with Adam are bitwise the JAX package's
Mode B on the same inputs."""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu_torch.constants import divide

# JAX name -> the ROADMAP.md Queue 1 item it waits for.
UNPORTED = {
    "": {
        "analyze": 7,
    },
    "ops": {},
    "utils": {},
    "reshard": {"peak_live_bytes": 7, "tensor_bytes": 7},
    "obs": {"measured_wire_table": 7,
            "reconcile": 7, "equivalent_wire": 7,
            "equivalent_tier_wire": 7},
    "transport": {},
    "resilience": {},
    "compress": {"int8_rotation_census": 7},
    "overlap": {"scheduled_exposure": 7},
    "serve": {},
    "tune": {},
    "csched": {},
    "fuse": {},
    "models": {},
    "parallel": {},
    "mesh": {},
    "elastic": {},
    "ctl": {},
}


def _modules(sub):
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module("mpi4torch_tpu" + suffix),
            importlib.import_module("mpi4torch_tpu_torch" + suffix))


@pytest.mark.parametrize("sub", sorted(UNPORTED))
def test_every_jax_export_is_ported_or_queued(sub):
    jmod, pmod = _modules(sub)
    table = UNPORTED[sub]
    assert set(table) <= set(jmod.__all__), "a stale UNPORTED entry"
    for name in jmod.__all__:
        if name in table:
            continue
        assert hasattr(pmod, name), f"{pmod.__name__}.{name} is missing"
    for name, item in table.items():
        stub = getattr(pmod, name, None)
        if stub is None:
            continue
        # A name kept as a stub raises, naming its queue item.
        nargs = sum(p.default is p.empty
                    for p in inspect.signature(stub).parameters.values())
        with pytest.raises(NotImplementedError,
                           match=f"Queue 1 item {item}"):
            stub(*([None] * nargs))
    exported = set(pmod.__all__)
    assert all(hasattr(pmod, n) for n in exported)
    assert set(jmod.__all__) - set(table) <= exported


def test_package_surface_repairs():
    for name in ("compression_scope", "fusion_scope", "overlap_scope",
                 "fuse", "overlap", "serve", "obs", "resilience",
                 "IntegrityError", "deactivate_cuda_aware_mpi_support",
                 "FaultPlan", "FaultSpec", "fault_scope", "tune",
                 "transport"):
        assert name in mpi.__all__ and hasattr(mpi, name)
    assert mpi.deactivate_cuda_aware_mpi_support() is None
    with mpi.compression_scope("q8_ef"):
        assert mpi.config.default_compression().name == "q8_ef"
    assert mpi.config.default_compression() is None
    assert issubclass(mpi.IntegrityError, mpi.CommError)


# ------------------------------------------------------------------ means

def test_divide_is_a_true_division():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096))
    for n in (3, 6, 7):
        for dt in (torch.float64, torch.float32, torch.bfloat16):
            y = x.to(dt)
            assert torch.equal(divide(y, n), y / n)
            assert divide(y, n).dtype == dt
    np.testing.assert_array_equal(
        divide(x, 3).numpy(), np.asarray(jnp.asarray(x.numpy()) / 3))


def _tree(rank, dtype):
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.standard_normal((17, 5)).astype(dtype),
            "b": rng.standard_normal(11).astype(dtype),
            "s": np.asarray(rng.standard_normal(), dtype=dtype)}


def _jax_means(rank, dtype):
    from mpi4torch_tpu import fuse as jfuse
    from mpi4torch_tpu.parallel import all_average_tree, zero
    from mpi4torch_tpu.parallel.dp import dp_loss

    c = jmpi.COMM_WORLD
    t = {k: jnp.asarray(v) for k, v in _tree(rank, dtype).items()}
    out = {}
    for name, kw in (("leaf", dict(bucket_bytes=0)), ("fused", {}),
                     ("pipeline", dict(bucket_bytes=128, overlap=True))):
        out[name] = c.Allreduce_tree(t, jmpi.MPI_SUM, mean=True, **kw)
    out["avg"] = all_average_tree(c, t)
    # A local loss without a reduction: the two packages' sums may
    # associate differently, and the mean is what is under test.
    out["dp_loss"] = jax.value_and_grad(lambda p: dp_loss(
        c, lambda q, b: q["s"] * b[0, 0] + q["b"][3] ** 2, p, t["w"]))(t)
    for name, kw in (("rs", {}), ("rs_overlap", dict(overlap=True))):
        out[name] = jfuse.fused_reduce_scatter_tree(
            c, t, jmpi.MPI_SUM, mean=True, bucket_bytes=256, **kw)
    opt = optax.adam(1e-2)
    p = {k: jnp.asarray(v) for k, v in _tree(0, dtype).items()}
    st = zero.zero_init(c, opt, p)
    for _ in range(2):
        p, st = zero.zero_step(c, opt, p, t, st)
    out["zero_adam"] = p
    return jax.tree.map(np.asarray, out)


def _port_means(rank, dtype):
    from mpi4torch_tpu_torch import fuse
    from mpi4torch_tpu_torch.parallel import all_average_tree, zero
    from mpi4torch_tpu_torch.parallel.dp import dp_loss
    from mpi4torch_tpu_torch.utils import optim
    from mpi4torch_tpu_torch.utils.tree import tree_map, value_and_grad

    c = mpi.COMM_WORLD
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         _tree(rank, dtype).items()}
    out = {}
    for name, kw in (("leaf", dict(bucket_bytes=0)), ("fused", {}),
                     ("pipeline", dict(bucket_bytes=128, overlap=True))):
        out[name] = c.Allreduce_tree(t, mpi.MPI_SUM, mean=True, **kw)
    out["avg"] = all_average_tree(c, t)
    out["dp_loss"] = value_and_grad(lambda p: dp_loss(
        c, lambda q, b: q["s"] * b[0, 0] + q["b"][3] ** 2, p, t["w"]), t)
    for name, kw in (("rs", {}), ("rs_overlap", dict(overlap=True))):
        out[name] = fuse.fused_reduce_scatter_tree(
            c, t, mpi.MPI_SUM, mean=True, bucket_bytes=256, **kw)
    opt = optim.adam(1e-2)
    p = {k: torch.from_numpy(np.array(v)) for k, v in
         _tree(0, dtype).items()}
    st = zero.zero_init(c, opt, p)
    for _ in range(2):
        p, st = zero.zero_step(c, opt, p, t, st)
    out["zero_adam"] = p
    return tree_map(lambda v: v.detach().numpy(), out)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_three_rank_means_bitwise_jax(dtype):
    want = jmpi.run_ranks(lambda r: _jax_means(r, dtype), 3)
    got = mpi.run_ranks(lambda r: _port_means(r, dtype), 3, device="cpu")
    leaves = jax.tree_util.tree_leaves
    for r in range(3):
        for a, b in zip(leaves(got[r]), leaves(want[r])):
            np.testing.assert_array_equal(a, b)
        assert len(leaves(got[r])) == len(leaves(want[r]))
    # ... and the means are means: 1/3 is inexact, so a reciprocal
    # multiplication would show here.
    t = [_tree(r, dtype) for r in range(3)]
    mean_w = (t[0]["w"] + t[1]["w"] + t[2]["w"]) / dtype(3)
    np.testing.assert_array_equal(got[0]["leaf"]["w"], mean_w)
