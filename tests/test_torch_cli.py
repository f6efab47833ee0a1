"""The port's smoke CLIs on the CPU: ``python -m mpi4torch_tpu_torch.<pkg>
--smoke --device cpu`` for ``overlap``, ``obs`` and ``serve``, and the
``csched`` CLI's ``--smoke`` and ``--tiers`` lanes, each run in process
through its ``main`` and required to exit 0 with every lane's verdict
printed.  Their coverage literals equal the JAX package's, and without
``--device cpu`` on a machine with no card each raises (the lanes run on
the card unless asked for the CPU)."""

import json

import pytest
import torch

import mpi4torch_tpu_torch as P

CASES = {
    "overlap": (["--smoke", "--device", "cpu"], (
        "windowed split-phase == blocking fused (bitwise)",
        "prefetched all-gather == blocking step (bitwise)",
        "scheduled exposure: blocking 1.0", "overlap-smoke: OK")),
    "obs": (["--smoke", "--device", "cpu"], (
        "ok  : reconcile[ring-allreduce]",
        "ok  : reconcile[fused-q8-buckets]",
        "ok  : reconcile[reshard-(8,)->(2,4)]: measured 98304 B",
        "ok  : reconcile[serve-decode-step]",
        "exposure 0.0", "ok  : flight: rank_death postmortem names rank 1",
        "ok  : off-path", "ok  : metrics: prometheus exposition",
        "obs-smoke: all verdicts exact")),
    "csched-smoke": (["--smoke", "--device", "cpu"], ()),
    "csched-tiers": (["--tiers", "--device", "cpu"], ()),
    "serve": (["--smoke", "--device", "cpu"], (
        "scheduled exposure: overlap 0.0", "Allreduce_start.",
        "faults: rank_death mid-decode", "prefix sharing",
        "obs mirror: all 18 serve counters",
        "no-retrace: paged decode step recorded identical",
        "serve-smoke: OK")),
}


def _main(case):
    if case.startswith("csched"):
        from mpi4torch_tpu_torch.csched.__main__ import _main
        return _main
    mod = __import__(f"mpi4torch_tpu_torch.{case}.__main__",
                     fromlist=["main"])
    return mod.main


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("MPI4TORCH_TPU_TUNE_CACHE",
                       str(tmp_path / "tune_cache.json"))
    P.tune.clear()
    yield
    P.tune.clear()
    P.csched.synth.clear_installed()
    P.config.set_tier_stack(None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_smoke_exits_zero(case, capsys):
    argv, lines = CASES[case]
    assert _main(case)(argv) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, line
    assert "FAIL" not in out
    if case.startswith("csched"):
        report = json.loads(out)
        assert report["ok"] and report["failures"] == []
        if case == "csched-tiers":
            assert report["reconcile"]["ok"]
            assert report["two_level"] == {"flat_hier_record": True,
                                           "mesh_record": True}
        else:
            syn = report["synthesis"]
            assert syn["hlo_reconciles"]
            assert syn["census_recorded"] == syn["census_predicted"]
            assert all(all(cell.values())
                       for cell in report["reexpression"].values())


@pytest.mark.parametrize("case", sorted(CASES))
def test_smoke_needs_a_card_or_the_cpu(case):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    argv = [a for a in CASES[case][0] if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(case)(argv)


def test_coverage_literals_equal_jax():
    from mpi4torch_tpu.csched import __main__ as jcs
    from mpi4torch_tpu.serve import __main__ as jserve
    from mpi4torch_tpu_torch.csched import __main__ as pcs
    from mpi4torch_tpu_torch.serve import __main__ as pserve

    for name in ("PARITY_POLICIES", "PAGED_PARITY_POLICIES",
                 "MIRRORED_SERVE_COUNTERS"):
        assert getattr(pserve, name) == getattr(jserve, name), name
    for name in ("TIER_PARITY_COVERED", "TIER_CENSUS_COVERED",
                 "TIER_STACKS"):
        assert getattr(pcs, name) == getattr(jcs, name), name
