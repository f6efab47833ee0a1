"""The port's registry-wide lint sweep and its command line, on the CPU
(JAX's ``TestSweep``): every registered schedule recorded on the (1,),
(3,), (8,) rank-thread worlds and the (2, 4) mesh lints clean with no
registry drift; the serve decode leg lints clean, blocking at exposure
1.0 and overlapped below it; ``python -m mpi4torch_tpu_torch.analyze
--defects --device cpu`` exits 0 with every defect caught."""

import os
import subprocess
import sys

import pytest

import mpi4torch_tpu_torch as P
from mpi4torch_tpu import analyze as ja
from mpi4torch_tpu_torch import analyze as pa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MPI4TORCH_TPU_TUNE_CACHE",
                       str(tmp_path / "tune_cache.json"))
    P.tune.clear()
    yield
    P.tune.clear()


class TestSweep:
    @pytest.mark.parametrize("world", [(1,), (3,), (8,), (2, 4)])
    def test_sweep_world_lints_clean(self, world):
        res = pa.run_sweep(world, include_serve=False, device="cpu")
        assert res["violations"] == []
        assert res["problems"] == []
        assert res["n_cases"] > 0
        skipped = {r["case"].split(" ", 1)[1] for r in res["records"]
                   if r["skipped"]}
        if world == (8,):
            assert skipped == set()
        if world == (3,):
            assert {"allreduce.hier", "allreduce.rhd",
                    "allreduce.torus"} <= skipped

    def test_sweep_serve_leg_lints_clean(self):
        from mpi4torch_tpu_torch.analyze.sweep import _sweep_serve
        records = []
        _sweep_serve(records, 8, "cpu")
        assert [r["violations"] for r in records] == [[], []]
        exposures = {r["case"].split(".")[-1]: r["scheduled_exposure"]
                     for r in records}
        assert exposures["blocking"] == 1.0
        assert exposures["overlap"] < 1.0

    def test_sweep_worlds_enumeration(self):
        for n in (8, 2, 5):
            assert pa.sweep_worlds(n) == ja.sweep_worlds(n)
        assert pa.sweep_worlds(8) == [(8,), (3,), (1,), (2, 4)]

    def test_sweep_rejects_malformed_world(self):
        for world in ((0,), (2, 2, 2), ()):
            with pytest.raises(ValueError, match="world"):
                pa.run_sweep(world, device="cpu")


def test_defects_command_line():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "mpi4torch_tpu_torch.analyze", "--defects",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "every lint fires on its mutant" in out.stdout
    assert out.stdout.count("ok  : ") == len(pa.DEFECTS)
