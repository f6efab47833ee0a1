"""The port's checkpoint, recovery and fault matrix
(``utils.checkpoint``, ``resilience.recovery``, ``resilience.matrix``)
against the JAX package's on the CPU.

The port writes its own format (``manifest.json`` + ``data.bin``), so the
two packages are compared on what they return: the same trees saved by
each restore bitwise (float32, float64, bfloat16, integer and 0-d leaves);
the manager keeps, lists and names the same steps; ``restore_resharded``
of the same saved tree gives each of eight rank threads the JAX
package's shard, with and without a saved layout; ``restore_or_init``
returns the JAX package's step and skipped steps on the same histories (a
torn newest step, a numeric directory holding no checkpoint beside a
stray one, an empty directory, an epoch fence); the checkpoint cell and
a sample of the fault matrix's cells end as the JAX package's.  The
layout guard is held to its contract here alone: the JAX package's guard
finds no orbax metadata under the installed orbax and does not fire
(ROADMAP.md, Queue 3)."""

import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4torch_tpu as jmpi
import mpi4torch_tpu_torch as mpi
from mpi4torch_tpu import reshard as jrs
from mpi4torch_tpu import mesh as jmesh
from mpi4torch_tpu.resilience import matrix as jmatrix
from mpi4torch_tpu_torch import mesh, reshard as rs
from mpi4torch_tpu_torch.resilience import matrix, restore_or_init
from mpi4torch_tpu_torch.resilience.faults import _truncate_tree
from mpi4torch_tpu_torch.runtime import CommError
from mpi4torch_tpu_torch.utils import (CheckpointManager, restore_checkpoint,
                                       restore_resharded, save_checkpoint)
from mpi4torch_tpu_torch.utils.checkpoint import CheckpointError, saved_epoch
from mpi4torch_tpu_torch.utils.tree import tree_leaves, tree_map

jutils = pytest.importorskip("mpi4torch_tpu.utils")

NR = 8


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.standard_normal((4, 4))),
                       "b": torch.zeros(4)},
            "opt": {"m": torch.ones((4, 4)),
                    "count": torch.tensor(3, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


# -------------------------------------------------------------- round trip

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16,
                                   torch.int32, torch.int64, torch.uint8,
                                   torch.bool])
@pytest.mark.parametrize("shape", [(), (1,), (5, 3), (0, 4)])
def test_round_trip_bitwise(tmp_path, dtype, shape):
    x = torch.from_numpy(np.asarray(
        np.random.default_rng(1).standard_normal(shape) * 100)).to(dtype)
    if dtype.is_floating_point and x.numel():
        x.view(-1)[0] = float("nan")          # a NaN's bits round-trip too
    state = {"x": x, "s": torch.tensor(2.5, dtype=torch.float64)}
    save_checkpoint(str(tmp_path / "ck"), state)
    got = restore_checkpoint(str(tmp_path / "ck"),
                             tree_map(torch.zeros_like, state))
    assert got["x"].dtype == dtype and got["x"].shape == x.shape
    assert torch.equal(got["x"].reshape(-1).view(torch.uint8),
                       x.reshape(-1).view(torch.uint8))
    assert got["s"].item() == 2.5


def test_restore_follows_the_template(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path / "ck"), state)
    got = restore_checkpoint(str(tmp_path / "ck"),
                             tree_map(torch.zeros_like, state))
    _equal(got, state)
    # The template's dtype, and a meta template's leaf on the CPU.
    tmpl = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state)
    tmpl["params"]["w"] = torch.zeros((4, 4), dtype=torch.float32)
    got = restore_checkpoint(str(tmp_path / "ck"), tmpl)
    assert got["params"]["w"].dtype == torch.float32
    assert torch.equal(got["params"]["w"],
                       state["params"]["w"].to(torch.float32))
    assert got["opt"]["m"].device.type == "cpu"
    # A restore owns its memory: writing it leaves a second restore alone.
    got["opt"]["m"].add_(1)
    again = restore_checkpoint(str(tmp_path / "ck"), state)
    assert torch.equal(again["opt"]["m"], state["opt"]["m"])
    with pytest.raises(FileExistsError):
        save_checkpoint(str(tmp_path / "ck"), state)
    save_checkpoint(str(tmp_path / "ck"), _state(1), force=True)
    _equal(restore_checkpoint(str(tmp_path / "ck"), state), _state(1))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    assert sorted(os.listdir(tmp_path / "ck")) == ["data.bin",
                                                   "manifest.json"]
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), state)


def test_torn_and_garbage_steps_raise(tmp_path):
    path = str(tmp_path / "ck")
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    save_checkpoint(path, state)
    assert _truncate_tree(path)              # halves data.bin
    with pytest.raises(CheckpointError, match="torn"):
        restore_checkpoint(path, state)
    os.makedirs(tmp_path / "junk")
    with pytest.raises(CheckpointError, match="no checkpoint manifest"):
        restore_checkpoint(str(tmp_path / "junk"), state)
    save_checkpoint(path, {"w": state["w"], "v": state["w"]}, force=True)
    with pytest.raises(CheckpointError, match="another tree"):
        restore_checkpoint(path, state)


# ----------------------------------------------------------- layout guard

def test_layout_guard_raises_and_resume_propagates(tmp_path):
    # Held to the contract: a template of other leaf shapes raises
    # CommError naming restore_resharded, from restore_checkpoint, the
    # manager and restore_or_init (which must not walk back through the
    # history and restart from init).
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"w": torch.ones((8, 4))})
    for wrong in ({"w": torch.ones(32)}, {"w": torch.ones((1, 4))}):
        with pytest.raises(CommError, match="restore_resharded") as ei:
            restore_checkpoint(path, wrong)
        assert "saved" in str(ei.value) and "requested" in str(ei.value)
    workdir = str(tmp_path / "run")
    state = {"w": torch.arange(32, dtype=torch.float64).reshape(8, 4)}
    with CheckpointManager(workdir) as mgr:
        for step in range(2):
            mgr.save(step, state, force=True)
    wrong = rs.shard_template(state, {"w": rs.layout((8,), 0, None)})
    with CheckpointManager(workdir) as mgr:
        with pytest.raises(CommError, match="restore_resharded"):
            mgr.restore(1, template=wrong)
    with pytest.raises(CommError, match="restore_resharded"):
        restore_or_init(workdir, template=wrong)
    got, step = restore_or_init(workdir, template=state)
    assert step == 1
    _equal(got, state)


# ----------------------------------------------------------------- manager

def _jstate(step):
    return {"w": jnp.arange(6, dtype=jnp.float32) * (step + 1),
            "step": jnp.asarray(step, jnp.int32)}


def _pstate(step):
    return {"w": torch.arange(6, dtype=torch.float32) * (step + 1),
            "step": torch.tensor(step, dtype=torch.int32)}


def test_manager_retention_and_steps_equal_jax(tmp_path):
    got = {}
    for name, Mgr, st in (("jax", jutils.CheckpointManager, _jstate),
                          ("port", CheckpointManager, _pstate)):
        with Mgr(str(tmp_path / name), max_to_keep=2) as mgr:
            first = mgr.latest_step()
            for step in range(5):
                mgr.save(step, st(step), force=True)
            mgr.wait_until_finished()
            kept = (first, mgr.latest_step(), list(mgr.all_steps()))
        with Mgr(str(tmp_path / f"{name}_i"),
                 save_interval_steps=2) as mgr:
            saved = [mgr.save(step, st(step)) for step in range(4)]
            mgr.wait_until_finished()
        got[name] = kept + (saved,)
    assert got["port"] == got["jax"] == (None, 4, [3, 4],
                                         [True, False, True, False])


def test_resume_matches_uninterrupted(tmp_path):
    def train_step(state):
        g = state["params"] * 0.1 + 1.0
        return {"params": state["params"] - 0.01 * g,
                "step": state["step"] + 1}

    init = {"params": torch.ones(3, dtype=torch.float64),
            "step": torch.tensor(0, dtype=torch.int32)}
    ref = init
    for _ in range(6):
        ref = train_step(ref)
    workdir = str(tmp_path / "run")
    with CheckpointManager(workdir) as mgr:
        state = init
        for step in range(3):
            state = train_step(state)
            mgr.save(step, state)
    with CheckpointManager(workdir) as mgr:
        latest = mgr.latest_step()
        assert latest == 2
        state = mgr.restore(latest, template=init)
        for step in range(latest + 1, 6):
            state = train_step(state)
            mgr.save(step, state)
    _equal(state, ref)


# --------------------------------------------------------------- recovery

def _history(kind, root, Mgr, st, truncate):
    """One checkpoint history of the given kind, written by one
    package's manager."""
    os.makedirs(root)
    epoch = 1 if kind == "epoch" else None
    with Mgr(root) as mgr:
        for step in range(3):
            mgr.save(step, st(step), force=True, epoch=epoch)
        mgr.wait_until_finished()
    if kind in ("torn", "garbage"):
        assert truncate(os.path.join(root, "2"))
    if kind == "garbage":
        os.makedirs(os.path.join(root, "7"))
        with open(os.path.join(root, "7", "junk"), "w") as f:
            f.write("not a checkpoint")
        os.makedirs(os.path.join(root, "stray-dir"))


def _outcome(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            res = fn()
        except Exception as e:  # noqa: BLE001 — the outcome under test
            return type(e).__name__, None, None
    return res.step, tuple(s.step for s in res.skipped), res


@pytest.mark.parametrize("kind", ["intact", "torn", "garbage", "epoch",
                                  "missing"])
def test_restore_or_init_equal_jax(tmp_path, kind):
    from mpi4torch_tpu.resilience import faults as jfaults
    from mpi4torch_tpu.resilience import restore_or_init as jrestore

    expect = 2 if kind == "epoch" else None
    res = {}
    for name, Mgr, st, restore, trunc in (
            ("jax", jutils.CheckpointManager, _jstate, jrestore,
             jfaults._truncate_tree),
            ("port", CheckpointManager, _pstate, restore_or_init,
             _truncate_tree)):
        root = str(tmp_path / name)
        if kind != "missing":
            _history(kind, root, Mgr, st, trunc)
        res[name] = _outcome(lambda: restore(root, template=st(0),
                                             init=st(9),
                                             expect_epoch=expect))
    assert res["port"][:2] == res["jax"][:2]
    want = {"intact": (2, ()), "torn": (1, (2,)), "garbage": (1, (7, 2)),
            "epoch": ("CommError", None), "missing": (None, ())}[kind]
    assert res["port"][:2] == want
    if res["port"][2] is not None:
        state = res["port"][2].state
        ref = _pstate(9 if want[0] is None else want[0])
        _equal(state, ref)
        # Every skip is a torn or garbage step: a ValueError in both
        # packages (orbax's JSONDecodeError / ValueError, the port's
        # CheckpointError).
        for skip in res["port"][2].skipped:
            assert skip.reason.startswith("CheckpointError: ")


def test_restore_or_init_propagates_device_errors(tmp_path, monkeypatch):
    # A failure to place the state on the template's device (out of
    # memory, say) says nothing about the step: it propagates, and the
    # walk back to older steps or to init never starts.
    from mpi4torch_tpu_torch.utils import checkpoint as ck

    root = str(tmp_path / "run")
    _history("intact", root, CheckpointManager, _pstate, _truncate_tree)

    def oom(*_):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(ck, "_target_device", oom)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="out of memory"):
            restore_or_init(root, template=_pstate(0), init=_pstate(9))


def test_epoch_stamp_and_fence(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, _pstate(1), epoch=4)
    assert saved_epoch(path) == 4
    _equal(restore_checkpoint(path, _pstate(0), expect_epoch=4), _pstate(1))
    with pytest.raises(CommError, match="epoch 4"):
        restore_checkpoint(path, _pstate(0), expect_epoch=5)
    save_checkpoint(path, _pstate(1), force=True)
    assert saved_epoch(path) is None
    assert saved_epoch(str(tmp_path / "none")) is None


def test_truncate_save_fault_fires_through_the_manager(tmp_path):
    spec = mpi.FaultSpec("truncate_save", rank=0, op="ckpt_save", index=1)
    with mpi.fault_scope([spec]) as plan:
        with CheckpointManager(str(tmp_path / "run"), max_to_keep=2) as mgr:
            for step in range(3):
                mgr.save(step, _pstate(step))
    assert [(f.kind, f.rank, f.op) for f in plan.fired] == \
        [("truncate_save", 0, "ckpt_save")]
    res = _outcome(lambda: restore_or_init(str(tmp_path / "run"),
                                           template=_pstate(0)))
    assert res[:2] == (2, ())
    with mpi.fault_scope([spec]):
        with CheckpointManager(str(tmp_path / "b"), max_to_keep=2) as mgr:
            for step in range(2):
                mgr.save(step, _pstate(step))
    res = _outcome(lambda: restore_or_init(str(tmp_path / "b"),
                                           template=_pstate(0)))
    assert res[:2] == (0, (1,))


def test_checkpoint_cell_equal_jax(tmp_path):
    got = matrix.run_checkpoint_cell(str(tmp_path / "port"))
    want = jmatrix.run_checkpoint_cell(str(tmp_path / "jax"))
    assert got == want
    assert got["status"] == "ok"


# ---------------------------------------------------- topology migration

def _migration_tree():
    from mpi4torch_tpu.models import transformer as JT

    cfg = JT.TransformerConfig(vocab=31, d_model=16, n_heads=8, n_layers=2,
                               d_ff=32, max_seq=16)
    return jax.tree.map(np.asarray, JT.init_transformer(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float64))


def _layouts(pkg, tree, mesh_shape):
    """The JAX checkpoint tests' per-leaf layouts: a 2-D mesh splits the
    first and last axes where they divide, a 1-D mesh the last dividing
    axis; the rest replicates."""
    n = int(np.prod(mesh_shape))

    def pick(shape):
        if not shape or int(np.prod(shape)) == 1:
            return pkg.Layout(mesh_shape, ((),) * len(shape))
        if (len(mesh_shape) == 2 and len(shape) >= 2
                and shape[0] % mesh_shape[0] == 0
                and shape[-1] % mesh_shape[1] == 0):
            spec = [()] * len(shape)
            spec[0], spec[-1] = (0,), (1,)
            return pkg.Layout(mesh_shape, tuple(spec))
        for a in reversed(range(len(shape))):
            if shape[a] % n == 0:
                spec = [()] * len(shape)
                spec[a] = tuple(range(len(mesh_shape)))
                return pkg.Layout(mesh_shape, tuple(spec))
        return pkg.Layout(mesh_shape, ((),) * len(shape))

    if pkg is jrs:
        return jax.tree.map(lambda x: pick(np.shape(x)), tree)
    return tree_map(lambda x: pick(tuple(x.shape)), tree)


@pytest.mark.parametrize("saved", [True, False])
@pytest.mark.parametrize("target", [(2, 4), (4, 2)])
def test_restore_resharded_bitwise_jax(tmp_path, target, saved):
    from mpi4torch_tpu_torch.models import transformer as PT

    jtree = _migration_tree()
    ptree = PT.params_from_jax(jtree, "cpu")
    jutils.save_checkpoint(str(tmp_path / "jax"), jtree)
    save_checkpoint(str(tmp_path / "port"), ptree)

    def jbody():
        c = jmpi.COMM_WORLD
        kw = dict(saved_layout=_layouts(jrs, jtree, (NR,))) if saved \
            else {}
        out = jutils.restore_resharded(str(tmp_path / "jax"), jtree,
                                       _layouts(jrs, jtree, target),
                                       comm=c, **kw)
        return jax.tree.map(np.asarray, out)

    def pbody():
        c = mpi.COMM_WORLD
        kw = dict(saved_layout=_layouts(rs, ptree, (NR,))) if saved else {}
        tmpl = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), ptree)
        out = restore_resharded(str(tmp_path / "port"), tmpl,
                                _layouts(rs, ptree, target), comm=c, **kw)
        return [t.numpy() for t in tree_leaves(out)]

    want = jmpi.run_ranks(jbody, NR)
    got = mpi.run_ranks(pbody, NR, device="cpu")
    for r in range(NR):
        oracle = tree_leaves(rs.shard_of(ptree, _layouts(rs, ptree, target),
                                         r))
        ref = jax.tree.leaves(want[r])
        assert len(got[r]) == len(ref) == len(oracle)
        for a, b, o in zip(got[r], ref, oracle):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, o.numpy())


@pytest.mark.parametrize("shape,region", [
    ((), ()),
    ((0, 4), ((0, 0), (0, 4))),
    ((8, 6), ((0, 8), (0, 6))),
    ((8, 6), ((2, 4), (0, 6))),
    ((8, 6), ((4, 8), (3, 6))),
    ((8, 6), ((0, 8), (2, 4))),
    ((4, 6, 2), ((0, 4), (3, 6), (0, 2))),
    ((4, 6, 2), ((0, 4), (0, 6), (1, 2))),
    ((4, 6, 2), ((2, 3), (0, 6), (0, 1))),
])
def test_read_region_reads_only_its_runs(tmp_path, monkeypatch, shape,
                                         region):
    # restore_resharded reads a leaf's block without reading the leaf:
    # the block's runs along its first partial axis, bitwise a slice of
    # the whole leaf, and never more bytes than those runs hold.
    from mpi4torch_tpu_torch.utils import checkpoint as ck

    x = torch.arange(math.prod(shape), dtype=torch.float64).reshape(shape)
    save_checkpoint(str(tmp_path / "ck"), {"pad": torch.ones(3), "x": x})
    path = str(tmp_path / "ck")
    manifest = ck._read_manifest(path)
    data_bytes = ck._check_data_size(path, manifest)
    dtype, shp, offset = ck._entry(path, manifest["leaves"][1], data_bytes)
    read = []
    real = ck._read_into
    monkeypatch.setattr(ck, "_read_into", lambda f, p, o, v: (
        read.append(len(v)), real(f, p, o, v)))
    with open(os.path.join(path, "data.bin"), "rb") as f:
        got = ck._read_region(f, path, dtype, shp, offset, region)
    want = x[tuple(slice(a, b) for a, b in region)]
    assert got.shape == want.shape and torch.equal(got, want)
    j = next((a for a, ((lo, hi), n) in enumerate(zip(region, shape))
              if (lo, hi) != (0, n)), len(shape))
    runs = math.prod(shape[:j + 1] if j == len(shape) else
                     shape[:j] + (region[j][1] - region[j][0],) +
                     shape[j + 1:])
    assert sum(read) == runs * 8


def test_restore_resharded_reads_its_shard_and_catches_torn(tmp_path,
                                                             monkeypatch):
    from mpi4torch_tpu_torch.utils import checkpoint as ck

    tree = {"e": torch.arange(64.0).reshape(16, 4),
            "b": torch.arange(8.0)}
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree)
    lay = rs.layout((NR,), 0)
    read = []
    real = ck._read_into
    monkeypatch.setattr(ck, "_read_into", lambda f, p, o, v: (
        read.append(len(v)), real(f, p, o, v)))

    def body():
        c = mpi.COMM_WORLD
        lays = {"e": rs.layout((NR,), 0, None), "b": lay}
        out = restore_resharded(path, tree, lays, comm=c)
        return {k: v.clone() for k, v in out.items()}

    got = mpi.run_ranks(body, NR, device="cpu")
    for r in range(NR):
        assert torch.equal(got[r]["e"], tree["e"][2 * r:2 * r + 2])
        assert torch.equal(got[r]["b"], tree["b"][r:r + 1])
    # Eight ranks read the tree's bytes once between them.
    assert sum(read) == (64 + 8) * 4
    assert _truncate_tree(path)
    with pytest.raises(CheckpointError, match="torn"):
        mpi.run_ranks(lambda: restore_resharded(
            path, tree, {"e": rs.layout((NR,), 0, None), "b": lay}),
            NR, device="cpu")


def test_mesh_coords_round_trip_equal_jax():
    for shape in ((8,), (2, 4), (4, 2), (2, 2, 2), (3, 1, 2)):
        for r in range(int(np.prod(shape))):
            c = mesh.mesh_coords(r, shape)
            assert c == jmesh.mesh_coords(r, shape)
            assert mesh.rank_of_coords(c, shape) == r == \
                jmesh.rank_of_coords(c, shape)
    for bad in (lambda: mesh.mesh_coords(8, (2, 4)),
                lambda: mesh.rank_of_coords((0, 4), (2, 4)),
                lambda: mesh.rank_of_coords((0,), (2, 4))):
        with pytest.raises(ValueError):
            bad()


# ------------------------------------------------------------ the matrix

def test_matrix_tables_equal_jax():
    from mpi4torch_tpu_torch.resilience.faults import FAULT_KINDS

    assert matrix.COVERAGE == jmatrix.COVERAGE
    assert set(matrix.COVERAGE) == set(FAULT_KINDS)
    assert {k: v.__name__ for k, v in matrix.EXPECTED_ERROR.items()} == \
        {k: v.__name__ for k, v in jmatrix.EXPECTED_ERROR.items()}
    assert list(matrix.coverage_cells()) == list(jmatrix.coverage_cells())
    assert (matrix.COMM_SUBSYSTEMS, matrix.WORLDS) == \
        (jmatrix.COMM_SUBSYSTEMS, jmatrix.WORLDS)


MATRIX_CELLS = [("rank_death", "plain", 3, None),
                ("corrupt_nan", "fused", 3, None),
                ("bitflip", "compressed", 3, None),
                ("bitflip", "plain", 3, None),
                ("drop_p2p", "overlap", 3, None),
                ("delay", "plain", 8, "torus"),
                ("preempt", "compressed", 8, None)]


@pytest.mark.parametrize("cell", MATRIX_CELLS,
                         ids=["-".join(map(str, c)) for c in MATRIX_CELLS])
def test_matrix_cells_equal_jax(cell):
    kind, subsystem, n, algo = cell
    got = matrix.run_cell(kind, subsystem, n, algo, device="cpu")
    want = jmatrix.run_cell(kind, subsystem, n, algo)
    keys = ("kind", "subsystem", "nranks", "algorithm", "expected",
            "backend", "fired", "status")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}, \
        (got["detail"], want["detail"])
    assert got["status"] == "ok", got["detail"]
