"""The PyTorch port stands alone: no module of ``mpi4torch_tpu_torch`` and
not ``chip_smoke.py`` imports JAX or anything of the JAX package, which
is the reference the port is tested against and not a dependency."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mpi4torch_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mpi4torch_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("constants.py", "config.py", "runtime.py", "comm.py",
                "ops/eager.py", "ops/flash.py", "ops/ragged.py",
                "ops/_kernels.py", "parallel/tp.py", "parallel/dp.py",
                "models/transformer.py", "serve/kv.py", "serve/engine.py",
                "utils/profiling.py", "utils/tree.py", "utils/threefry.py",
                "ops/quant_kernels.py", "compress/__init__.py",
                "compress/codecs.py", "compress/eager.py", "compress/ef.py",
                "tune/__init__.py", "tune/registry.py", "parallel/ring.py",
                "utils/lbfgs.py", "examples/__init__.py",
                "examples/simple_linear_regression.py",
                "examples/isend_recv_wait.py",
                "examples/halo_exchange_stencil.py", "ops/packed.py",
                "fuse/__init__.py", "fuse/bucketing.py",
                "fuse/collectives.py", "overlap/__init__.py",
                "overlap/scheduler.py", "parallel/zero.py",
                "utils/optim.py", "serve/paging.py",
                "parallel/attention.py", "parallel/moe.py",
                "examples/ring_attention_longcontext.py",
                "examples/expert_parallel_moe.py",
                "examples/tensor_parallel_mlp.py", "parallel/pp.py",
                "models/mlp.py", "models/resnet.py", "models/vit.py",
                "utils/data.py", "examples/compressed_data_parallel.py",
                "examples/resnet_cifar_dp.py",
                "examples/vit_patch_parallel.py",
                "examples/pipeline_training.py", "obs/__init__.py",
                "obs/events.py", "obs/metrics.py", "obs/trace.py",
                "obs/flight.py", "obs/export.py",
                "resilience/__init__.py", "resilience/faults.py",
                "resilience/guards.py", "resilience/health.py",
                "examples/generate_kv_cache.py",
                "examples/zero_sharded_optimizer.py", "mesh.py",
                "reshard/__init__.py", "reshard/plan.py",
                "reshard/rules.py", "reshard/executor.py",
                "utils/checkpoint.py", "resilience/recovery.py",
                "resilience/matrix.py", "examples/checkpoint_resume.py",
                "transport/__init__.py", "transport/__main__.py",
                "transport/base.py", "transport/thread.py",
                "transport/wire.py", "transport/_ship.py",
                "transport/pool.py", "transport/_worker.py",
                "transport/process.py", "ops/spmd.py",
                "examples/variable_token_exchange.py",
                "compress/spmd.py", "compress/__main__.py",
                "reshard/__main__.py", "elastic/__init__.py",
                "elastic/__main__.py", "elastic/membership.py",
                "elastic/runtime.py", "elastic/replan.py",
                "elastic/spare.py", "elastic/matrix.py",
                "ctl/__init__.py", "ctl/__main__.py", "ctl/ledger.py",
                "ctl/estimate.py", "ctl/drift.py", "ctl/controller.py",
                "distributed.py", "transport/dist.py",
                "resilience/degrade.py", "resilience/chaos.py",
                "resilience/__main__.py", "obs/reconcile.py",
                "obs/__main__.py", "overlap/__main__.py",
                "overlap/census.py", "reshard/census.py",
                "csched/__main__.py", "serve/__main__.py"):
        assert f"mpi4torch_tpu_torch/{rel}" in names
    for src in ("flash_fwd.cu", "flash_fwd_tc.cu", "flash_bwd.cu",
                "flash_bwd_tc.cu", "quant_hop.cu"):
        assert (ROOT / "mpi4torch_tpu_torch/ops/csrc" / src).exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_scan_catches_forbidden_imports():
    # The scan itself is live: the spellings it must catch are caught and
    # the port's own package name is not mistaken for the JAX package.
    assert _forbidden("jax.numpy")
    assert _forbidden("mpi4torch_tpu.ops.flash")
    assert not _forbidden("mpi4torch_tpu_torch.ops.flash")
    assert not _forbidden("torch")
