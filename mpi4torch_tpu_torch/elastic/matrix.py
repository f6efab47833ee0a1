"""The censused elastic matrix: every (failure kind × subsystem ×
action) cell ends **recovered-and-bitwise against the fresh-start
oracle on the new world** or in a typed, rank-attributed raise — never
a hang, never an unfired cell.

Port of ``mpi4torch_tpu/elastic/matrix.py``: the same cells, worlds,
fault specs and verdict records, on the port's rank threads (or worker
processes under ``config.transport_scope("process")``) on the device
``run_cell`` is given (CUDA unless ``"cpu"`` is asked for).
:data:`COVERAGE` is the literal table the registry-sync guard
(``analyze.registry.elastic_problems``) checks against the fault
registry and the declared subsystem/action sets.

Dimensions:

* **failure kind** — ``rank_death`` (no notice: recovery rewinds to
  the epoch-stamped phase-boundary checkpoint for the lost shard) and
  ``preempt`` (advance notice: the doomed rank answers through the
  drain, so recovery is the LIVE resize replan — no rewind).
* **subsystem** — ``plain`` (an axis-0-sharded TP-style parameter
  bank), ``zero`` (ZeRO-1 training: replicated params + sharded
  elementwise-momentum state through the real ``zero_step`` bucketed
  collectives), ``moe`` (an expert stack, with ``rebalance_experts``
  re-dealing composed on the new world), and ``serve`` (a
  continuous-batching engine whose in-flight requests drain to tickets
  and re-admit through the admission policies).
* **action** — ``shrink`` ((8,)→(6,); serve (4,)→(2,)), ``grow``
  (shrink then grow back), and ``spare`` (a hot-spare world:
  zero-reshard takeover from the mirror for plain/zero; moe and serve
  have no mirror and take the DOCUMENTED fallback — the planned drain
  path — with ``fallback: true`` recorded in the verdict).

Bitwise discipline: every training cell uses integer-valued
(dyadic-exact) data and SUM reduction, so the same global math is
exact under any world size and any fold association — the oracle is a
plain numpy replay of the schedule, and "recovered" means every new
world position's state equals the oracle's slice BIT FOR BIT.

The consensus cells (:func:`run_consensus_cell`) pin the failure side
of membership agreement itself: an injected proposal disagreement ends
in :class:`~.membership.ConsensusError` naming the disagreeing id, and
a rank dying MID-consensus ends in the runtime's attributed
``RankFailedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..runtime import RankFailedError
from ..resilience.faults import FaultSpec, fault_scope
from ..utils.tree import tree_map
from .membership import ConsensusError, WorldView, agree_world_view
from .runtime import ElasticRuntime

__all__ = [
    "KINDS", "SUBSYSTEMS", "ACTIONS", "COVERAGE",
    "CONSENSUS_COVERAGE", "EXPECTED_CONSENSUS_ERROR", "SPARE_FALLBACK",
    "coverage_cells", "run_cell", "run_consensus_cell",
]

KINDS = ("rank_death", "preempt")
SUBSYSTEMS = ("plain", "zero", "moe", "serve")
ACTIONS = ("shrink", "grow", "spare")

# Subsystems whose `spare` action has no mirror and takes the
# documented fallback (the planned drain path) instead of takeover.
SPARE_FALLBACK = frozenset({"moe", "serve"})

# Every (kind x subsystem x action) cell recovers; the registry-sync
# guard fails if this literal and the dimension tuples drift apart.
COVERAGE: Dict[Tuple[str, str, str], str] = {
    (k, s, a): "recover"
    for k in KINDS for s in SUBSYSTEMS for a in ACTIONS
}

CONSENSUS_COVERAGE: Dict[Tuple[str, str, str], str] = {
    ("disagree", "membership", "consensus"): "raise",
    ("second_failure", "membership", "consensus"): "raise",
}

EXPECTED_CONSENSUS_ERROR = {
    "disagree": ConsensusError,
    "second_failure": RankFailedError,
}

# Cell timing: probes on worlds with absent ranks burn exactly the
# probe timeout; world timeouts bound every other wait.
PROBE_TIMEOUT_S = 0.6
WORLD_TIMEOUT_S = 20.0

# Tensor-subsystem geometry: 24 leading units re-dealt 8 -> 6 -> 8
# (spare worlds: 4 data + 1 spare, width 4 throughout).  One failure
# takes the world to 7 survivors, but 24 units have no 7-way deal — so
# the ratified view descales to the largest usable mesh (6,) by also
# draining a surplus rank (_EXTRA).
_W, _M = 8, 6
_UNITS = 24
_DOOMED = 2          # the stable id that fails in shrink/grow cells
_EXTRA = 7           # the surplus id drained to reach the (6,) mesh
_SPARE_DATA = 4
_SPARE_DOOMED = 1


def coverage_cells():
    """Every declared cell, deterministic order (what the smoke lane
    iterates and the registry guard checks)."""
    for key in sorted(COVERAGE):
        yield key
    for key in sorted(CONSENSUS_COVERAGE):
        yield key


def _rt(n: int, device) -> ElasticRuntime:
    return ElasticRuntime(n, probe_timeout=PROBE_TIMEOUT_S,
                          world_timeout=WORLD_TIMEOUT_S, device=device)


def _delta(t: int, rid: int, shape) -> np.ndarray:
    """Deterministic small-integer contribution of stable id ``rid``
    at step ``t`` — dyadic-exact under SUM on any membership."""
    n = int(np.prod(shape))
    base = (np.arange(n, dtype=np.int64) * (rid + 2) + (t + 1) * 7) % 9
    return (base - 4).astype(np.float32).reshape(shape)


def _sum_delta(t: int, ids, shape) -> np.ndarray:
    out = np.zeros(shape, np.float32)
    for rid in ids:
        out += _delta(t, rid, shape)
    return out


def _dev(x, comm):
    """A numpy array as a tensor on ``comm``'s device."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(comm.device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class _verdict:
    """Accumulates one cell's verdict record."""

    def __init__(self, kind, subsystem, action, expected):
        self.rec = {"kind": kind, "subsystem": subsystem,
                    "action": action, "expected": expected,
                    "fired": []}

    def fail(self, detail):
        self.rec.update(status="fail", detail=detail)
        return self.rec

    def ok(self, detail):
        self.rec.update(status="ok", detail=detail)
        return self.rec


def _spec_for(kind: str, rank: int, op, index: int) -> FaultSpec:
    if kind == "preempt":
        # A wide window: the notice posts at `index`, the death op sits
        # far past everything the drain will ever issue.
        return FaultSpec("preempt", rank=rank, op=op, index=index,
                         count=100_000)
    return FaultSpec("rank_death", rank=rank, op=op, index=index)


# ---------------------------------------------------------------------------
# plain / moe: an axis-0-sharded bank updated by summed deltas.
# ---------------------------------------------------------------------------


def _bank_body(shards_by_id, ts, row):
    """Phase body: each rank updates its axis-0 shard of the bank from
    the SUM of the membership's per-id integer deltas."""
    import mpi4torch_tpu_torch as mpi

    def body(pos, rid):
        comm = mpi.COMM_WORLD
        size = comm.size
        per = _UNITS // size
        shard = _dev(shards_by_id[rid], comm)
        for t in ts:
            d = comm.Allreduce(_dev(_delta(t, rid, (_UNITS,) + row), comm),
                               mpi.MPI_SUM, compression=False)
            shard = shard + d[pos * per:(pos + 1) * per]
        return _host(shard)

    return body


def _bank_oracle(bank0, schedule):
    """Numpy replay: ``schedule`` is a list of (ts, alive_ids)."""
    bank = np.array(bank0, copy=True)
    for ts, ids in schedule:
        for t in ts:
            bank += _sum_delta(t, ids, bank.shape)
    return bank


def _run_bank_cell(v, kind: str, action: str, *, moe: bool, device):
    """The plain/moe shrink+grow cell (spare handled separately)."""
    import mpi4torch_tpu_torch as mpi
    from . import replan as _replan

    row = (3,)
    bank0 = np.arange(_UNITS * 3, dtype=np.float32).reshape(_UNITS, 3)
    rt = _rt(_W, device)
    view0 = rt.view
    ids0 = view0.alive
    shards = {rid: bank0[rid * 3:(rid + 1) * 3] for rid in ids0}

    ts1, ts2, ts3 = (0, 1), (2,), (3,)
    # Phase 1 issues len(ts1) Allreduce calls per rank; the fault lands
    # on the first op after the boundary (rank_death) or posts its
    # notice during phase 1 (preempt).
    spec = _spec_for(kind, _DOOMED, "Allreduce",
                     index=(1 if kind == "preempt" else len(ts1)))
    with fault_scope([spec]) as plan:
        res1 = rt.run_phase(_bank_body(shards, ts1, row))
        shards = {ids0[p]: res1[p] for p in range(_W)}
        snapshot = _bank_oracle(bank0, [(ts1, ids0)])
        if not all(np.array_equal(shards[rid],
                                  snapshot[view0.position(rid) * 3:
                                           (view0.position(rid) + 1) * 3])
                   for rid in ids0):
            return v.fail("phase-1 state diverged from the replay "
                          "before any fault acted")

        if kind == "preempt":
            notices = rt.pending_preemptions()
            if _DOOMED not in notices:
                return v.fail("no preemption notice posted "
                              f"(board: {notices})")

            def drain_body(pos, rid, old_view, new_view):
                comm = mpi.COMM_WORLD
                out = _replan.replan_axis0(
                    comm, _dev(shards[rid], comm), _UNITS, old_view,
                    new_view, mode="drain")
                return _host(out)

            outs = rt.drain(drain_body, leaving=[_DOOMED, _EXTRA])
            view1 = rt.view
            new_shards = {rid: outs[view0.position(rid)]
                          for rid in view1.alive}
        else:
            try:
                rt.run_phase(_bank_body(shards, ts2, row))
                return v.fail("rank_death never fired — the phase "
                              "completed")
            except RankFailedError as e:
                if _DOOMED not in e.ranks:
                    return v.fail(
                        f"RankFailedError unattributed: {sorted(e.ranks)}")
            view1 = rt.consensus(leaving=[_EXTRA])
            # Checkpoint rewind: the phase-boundary snapshot supplies
            # every new-world shard (the dead rank's memory is gone;
            # survivors rewind to the common point).
            per1 = _UNITS // view1.size
            new_shards = {
                rid: snapshot[view1.position(rid) * per1:
                              (view1.position(rid) + 1) * per1]
                for rid in view1.alive}
    v.rec["fired"] = sorted(plan.fired_kinds())
    if kind not in plan.fired_kinds():
        return v.fail("vacuous cell: the fault never fired")
    if view1.size != _M or _DOOMED in view1.alive or view1.epoch != 1:
        return v.fail(f"unexpected post-shrink view: {view1.describe()}")

    # Resume on the shrunk world (replaying ts2 after a rank_death
    # rewind; running it fresh after a drain — either way the schedule
    # below is what the oracle replays).
    resume_ts = ts2
    res2 = rt.run_phase(_bank_body(new_shards, resume_ts, row))
    new_shards = {view1.alive[p]: res2[p] for p in range(view1.size)}
    schedule = [(ts1, ids0), (resume_ts, view1.alive)]

    if action == "grow":
        view_pre = view1
        view2 = rt.consensus(joining=[_DOOMED, _EXTRA])
        if view2.size != _W or view2.epoch != 2:
            return v.fail(f"grow view wrong: {view2.describe()}")

        def grow_body(pos, rid, old=view_pre, new=view2):
            comm = mpi.COMM_WORLD
            per_old = _UNITS // old.size
            if rid in old.alive:
                x = _dev(new_shards[rid], comm)
            else:
                x = torch.zeros((per_old,) + row, dtype=torch.float32,
                                device=comm.device)
            out = _replan.replan_axis0(comm, x, _UNITS, old, new,
                                       mode="grow")
            shard = _host(out)
            per = _UNITS // new.size
            for t in ts3:
                d = comm.Allreduce(
                    _dev(_delta(t, rid, (_UNITS,) + row), comm),
                    mpi.MPI_SUM, compression=False)
                shard = shard + _host(d)[pos * per:(pos + 1) * per]
            return shard

        res3 = rt.run_phase(lambda pos, rid: grow_body(pos, rid))
        final = {view2.alive[p]: res3[p] for p in range(view2.size)}
        schedule.append((ts3, view2.alive))
        view_final = view2
    else:
        final, view_final = new_shards, view1

    oracle = _bank_oracle(bank0, schedule)

    if moe:
        # Compose the MoE re-deal on the final world: experts sorted by
        # a deterministic load vector, snake-dealt, moved by the
        # planned block permutation (rebalance_experts).
        from ..parallel.moe import balanced_assignment, rebalance_experts

        loads = [(e * 7) % 11 for e in range(_UNITS)]
        perm = balanced_assignment(loads, view_final.size)

        def reb_body(pos, rid):
            comm = mpi.COMM_WORLD
            out = rebalance_experts(comm, {"w": _dev(final[rid], comm)},
                                    perm)
            return _host(out["w"])

        res4 = rt.run_phase(reb_body)
        final = {view_final.alive[p]: res4[p]
                 for p in range(view_final.size)}
        oracle = oracle[list(perm)]

    per = _UNITS // view_final.size
    for rid in view_final.alive:
        j = view_final.position(rid)
        if not np.array_equal(final[rid], oracle[j * per:(j + 1) * per]):
            return v.fail(
                f"recovered state of id {rid} (position {j}) diverges "
                "from the fresh-start oracle")
    return v.ok(
        f"recovered bitwise on {view_final.describe()} "
        f"({'live drain' if kind == 'preempt' else 'checkpoint rewind'}"
        f"{' + rebalance' if moe else ''})")


# ---------------------------------------------------------------------------
# zero: ZeRO-1 steps (replicated params, sharded momentum) end to end.
# ---------------------------------------------------------------------------


class _Momentum:
    """Minimal elementwise momentum with the optimizer calling
    convention (dyadic coefficients: exact on integer gradients for the
    few steps a cell runs)."""

    def init(self, params):
        return tree_map(torch.zeros_like, params)

    def update(self, grads, state, params=None):
        m = tree_map(lambda mm, gg: mm * 0.5 + gg, state, grads)
        return tree_map(lambda mm: mm * (-0.25), m), m


_ZSHAPES = {"w": (12, 5), "b": (8,)}


def _zero_grads(t, rid):
    return {k: _delta(t, rid, s) for k, s in _ZSHAPES.items()}


def _zero_oracle(schedule):
    """Replicated numpy replay of the ZeRO schedule; returns
    (params, momentum) as full arrays."""
    params = {k: np.arange(int(np.prod(s)), dtype=np.float32)
              .reshape(s) for k, s in _ZSHAPES.items()}
    m = {k: np.zeros(s, np.float32) for k, s in _ZSHAPES.items()}
    for ts, ids in schedule:
        for t in ts:
            for k in _ZSHAPES:
                g = _sum_delta(t, ids, _ZSHAPES[k])
                m[k] = m[k] * 0.5 + g
                params[k] = params[k] + m[k] * (-0.25)
    return params, m


def _np_shard(full: np.ndarray, size: int, pos: int) -> np.ndarray:
    flat = full.reshape(-1)
    per = -(-flat.size // size)
    padded = np.pad(flat, (0, per * size - flat.size))
    return padded[pos * per:(pos + 1) * per]


def _zero_body(params_in, states_by_id, ts):
    import mpi4torch_tpu_torch as mpi
    from ..parallel.zero import zero_step

    opt = _Momentum()

    def body(pos, rid):
        comm = mpi.COMM_WORLD
        p = {k: _dev(v, comm) for k, v in params_in.items()}
        st = {k: _dev(v, comm) for k, v in states_by_id[rid].items()}
        for t in ts:
            p, st = zero_step(comm, opt, p,
                              {k: _dev(v, comm) for k, v in
                               _zero_grads(t, rid).items()},
                              st, mean=False)
        return ({k: _host(v) for k, v in p.items()},
                {k: _host(v) for k, v in st.items()})

    return body


def _zero_state(view, rid=None):
    return {k: np.zeros((-(-int(np.prod(_ZSHAPES[k])) // view.size),),
                        np.float32) for k in _ZSHAPES}


def _phase1_op_count(params0, view0, ts1, device) -> int:
    """The deterministic per-rank wire-op count of phase 1, measured
    once on a throwaway world under a never-firing counting spec (the
    plan's per-rank counters advance for every matching call regardless
    of the firing window) — so a rank_death lands exactly on phase 2's
    FIRST collective without hard-coding bucket counts."""
    probe_spec = FaultSpec("delay", rank=None, op=None, index=10 ** 6)
    with fault_scope([probe_spec]) as probe_plan:
        _rt(_W, device).run_phase(_zero_body(
            params0, {rid: _zero_state(view0) for rid in view0.alive},
            ts1))
        return max(probe_plan._counts.get((0, r), 0)
                   for r in range(_W))


def _run_zero_cell(v, kind: str, action: str, workdir: Optional[str],
                   device):
    import mpi4torch_tpu_torch as mpi
    from . import replan as _replan

    rt = _rt(_W, device)
    view0 = rt.view
    ids0 = view0.alive
    params0 = {k: np.arange(int(np.prod(s)), dtype=np.float32)
               .reshape(s) for k, s in _ZSHAPES.items()}
    template = {k: torch.zeros(s, dtype=torch.float32, device="meta")
                for k, s in _ZSHAPES.items()}

    states = {rid: _zero_state(view0) for rid in ids0}
    ts1, ts2 = (0, 1), (2,)
    if kind == "preempt":
        scope_spec = FaultSpec("preempt", rank=_DOOMED, op=None,
                               index=2, count=100_000)
    else:
        scope_spec = FaultSpec(
            "rank_death", rank=_DOOMED, op=None,
            index=_phase1_op_count(params0, view0, ts1, device))

    with fault_scope([scope_spec]) as plan:
        res1 = rt.run_phase(_zero_body(params0, states, ts1))
        params1 = res1[0][0]
        if any(not all(np.array_equal(res1[p][0][k], params1[k])
                       for k in _ZSHAPES) for p in range(_W)):
            return v.fail("phase-1 replicated params diverged "
                          "across ranks")
        states = {ids0[p]: res1[p][1] for p in range(_W)}
        m1_full = {k: np.concatenate([states[rid][k] for rid in ids0])
                   for k in _ZSHAPES}

        if kind == "preempt":
            notices = rt.pending_preemptions()
            if _DOOMED not in notices:
                return v.fail(f"no preemption notice (board {notices})")

            def drain_body(pos, rid, old_view, new_view):
                comm = mpi.COMM_WORLD
                out = _replan.replan_zero(
                    comm, {k: _dev(x, comm) for k, x in states[rid].items()},
                    template, old_view, new_view, mode="drain")
                return {k: _host(x) for k, x in out.items()}

            outs = rt.drain(drain_body, leaving=[_DOOMED, _EXTRA])
            view1 = rt.view
            new_states = {rid: outs[view0.position(rid)]
                          for rid in view1.alive}
        else:
            try:
                rt.run_phase(_zero_body(params1, states, ts2))
                return v.fail("rank_death never fired")
            except RankFailedError as e:
                if _DOOMED not in e.ranks:
                    return v.fail(
                        f"RankFailedError unattributed: {sorted(e.ranks)}")
            view1 = rt.consensus(leaving=[_EXTRA])
            # The real checkpoint leg: the phase-boundary state was
            # saved with the epoch stamp; a stale-epoch resume must
            # raise, then the deliberate restore re-lays the momentum.
            from ..runtime import CommError
            from ..utils.checkpoint import CheckpointManager

            full_state = {"params": {k: torch.from_numpy(x)
                                     for k, x in params1.items()},
                          "m": {k: torch.from_numpy(x)
                                for k, x in m1_full.items()}}
            with CheckpointManager(workdir) as mgr:
                mgr.save(0, full_state, force=True, epoch=0)
                mgr.wait_until_finished()
                try:
                    mgr.restore(0, template=full_state,
                                expect_epoch=view1.epoch)
                    return v.fail("stale-epoch restore did NOT raise")
                except CommError as e:
                    if "epoch 0" not in str(e):
                        return v.fail(
                            f"epoch fence names no epochs: {e}")
                restored = mgr.restore(0, template=full_state,
                                       expect_epoch=0)
            new_states = {
                rid: {k: _np_shard_from_flatcat(
                    restored["m"][k].numpy(), view0.size, view1.size,
                    view1.position(rid), _ZSHAPES[k])
                    for k in _ZSHAPES}
                for rid in view1.alive}
            params1 = {k: x.numpy() for k, x in restored["params"].items()}
    v.rec["fired"] = sorted(plan.fired_kinds())
    if kind not in plan.fired_kinds():
        return v.fail("vacuous cell: the fault never fired")
    if view1.size != _M or view1.epoch != 1:
        return v.fail(f"unexpected post-shrink view: {view1.describe()}")

    res2 = rt.run_phase(_zero_body(params1, new_states, ts2))
    params2 = res2[0][0]
    new_states = {view1.alive[p]: res2[p][1] for p in range(view1.size)}
    schedule = [(ts1, ids0), (ts2, view1.alive)]
    view_final, params_final, states_final = view1, params2, new_states

    if action == "grow":
        view_pre = view1
        view2 = rt.consensus(joining=[_DOOMED, _EXTRA])

        def grow_body(pos, rid, old=view_pre, new=view2):
            comm = mpi.COMM_WORLD
            st = states_final[rid] if rid in old.alive \
                else _zero_state(old)
            out = _replan.replan_zero(
                comm, {k: _dev(x, comm) for k, x in st.items()}, template,
                old, new, mode="grow")
            return {k: _host(x) for k, x in out.items()}

        res3 = rt.run_phase(lambda pos, rid: grow_body(pos, rid))
        states_grown = {view2.alive[p]: res3[p] for p in range(view2.size)}
        ts3 = (3,)
        res4 = rt.run_phase(_zero_body(params_final, states_grown, ts3))
        params_final = res4[0][0]
        states_final = {view2.alive[p]: res4[p][1]
                        for p in range(view2.size)}
        schedule.append((ts3, view2.alive))
        view_final = view2

    o_params, o_m = _zero_oracle(schedule)
    for k in _ZSHAPES:
        if not np.array_equal(params_final[k], o_params[k]):
            return v.fail(f"params[{k}] diverge from the oracle")
    for rid in view_final.alive:
        j = view_final.position(rid)
        for k in _ZSHAPES:
            want = _np_shard(o_m[k], view_final.size, j)
            if not np.array_equal(states_final[rid][k], want):
                return v.fail(
                    f"momentum shard [{k}] of id {rid} diverges from "
                    "the fresh-start oracle")
    return v.ok(
        f"recovered bitwise on {view_final.describe()} "
        f"({'live replan' if kind == 'preempt' else 'epoch-stamped checkpoint rewind'})")


def _np_shard_from_flatcat(full_flatcat: np.ndarray, old_size: int,
                           new_size: int, pos: int, shape) -> np.ndarray:
    """New-world momentum shard from the checkpointed FLAT-CONCAT form
    (the old world's padded per-rank segments back to back): unpad to
    the logical vector, re-pad for the new world, slice."""
    n = int(np.prod(shape))
    per_old = -(-n // old_size)
    logical = np.concatenate([
        full_flatcat[r * per_old:(r + 1) * per_old]
        for r in range(old_size)])[:n]
    per_new = -(-n // new_size)
    padded = np.pad(logical, (0, per_new * new_size - n))
    return padded[pos * per_new:(pos + 1) * per_new]


# ---------------------------------------------------------------------------
# spare: hot-spare worlds (4 data + 1 spare), zero-reshard takeover.
# ---------------------------------------------------------------------------


def _run_spare_cell(v, kind: str, subsystem: str, device):
    """True takeover for plain/zero; moe/serve fall back to the planned
    drain path (recorded) via their shrink cells."""
    import mpi4torch_tpu_torch as mpi
    from . import spare as _spare

    n_data = _SPARE_DATA
    world = n_data + 1
    spare_id = n_data
    doomed = _SPARE_DOOMED
    rt = _rt(world, device)
    view0 = rt.view
    slots0 = {rid: (rid if rid < n_data else None)
              for rid in view0.alive}

    if subsystem == "plain":
        bank0 = np.arange(_UNITS * 3, dtype=np.float32).reshape(
            _UNITS, 3)

        def mk_state(rid):
            slot = slots0[rid]
            if slot is None:
                return bank0
            per = _UNITS // n_data
            return bank0[slot * per:(slot + 1) * per]

        def bank_body(states, slots, ts):
            def body(pos, rid):
                comm = mpi.COMM_WORLD
                slot = slots[rid]
                st = _dev(states[rid], comm)
                for t in ts:
                    contrib = (_delta(t, slot, bank0.shape)
                               if slot is not None
                               else np.zeros(bank0.shape, np.float32))
                    st = _spare.bank_spare_step(
                        comm, st, _dev(contrib, comm),
                        n_data=n_data, slot=slot)
                return _host(st)
            return body

        states = {rid: mk_state(rid) for rid in view0.alive}
        ts1, ts2 = (0, 1), (2, 3)
        spec = _spec_for(kind, doomed, "Allreduce",
                         index=(1 if kind == "preempt" else len(ts1)))
        with fault_scope([spec]) as plan:
            res1 = rt.run_phase(bank_body(states, slots0, ts1))
            states = {view0.alive[p]: res1[p] for p in range(world)}
            if kind == "preempt":
                if doomed not in rt.pending_preemptions():
                    return v.fail("no preemption notice")
                view1 = rt.consensus(leaving=[doomed])
            else:
                try:
                    rt.run_phase(bank_body(states, slots0, ts2))
                    return v.fail("rank_death never fired")
                except RankFailedError as e:
                    if doomed not in e.ranks:
                        return v.fail(
                            f"unattributed: {sorted(e.ranks)}")
                view1 = rt.consensus()
        v.rec["fired"] = sorted(plan.fired_kinds())
        if kind not in plan.fired_kinds():
            return v.fail("vacuous cell: the fault never fired")
        if set(view1.alive) != {0, 2, 3, spare_id}:
            return v.fail(f"post-failure view wrong: {view1.describe()}")

        # Zero-reshard takeover: the spare assumes the doomed slot by a
        # LOCAL slice of its mirror; survivors keep their shards as-is.
        slots1 = {rid: slots0[rid] for rid in view1.alive
                  if rid != spare_id}
        slots1[spare_id] = slots0[doomed]
        states1 = {rid: states[rid] for rid in view1.alive
                   if rid != spare_id}
        states1[spare_id] = _host(_spare.takeover_bank_slot(
            torch.from_numpy(states[spare_id]), slots0[doomed], n_data))

        res2 = rt.run_phase(bank_body(states1, slots1, ts2))
        final = {view1.alive[p]: res2[p] for p in range(view1.size)}

        oracle = _bank_oracle(bank0, [(ts1 + ts2, range(n_data))])
        per = _UNITS // n_data
        for rid in view1.alive:
            slot = slots1[rid]
            want = oracle[slot * per:(slot + 1) * per]
            if not np.array_equal(final[rid], want):
                return v.fail(
                    f"slot {slot} (id {rid}) diverges after takeover")
        return v.ok("zero-reshard takeover bitwise (spare id "
                    f"{spare_id} assumed slot {slots0[doomed]})")

    # subsystem == "zero": the mirrored ZeRO step.
    opt = _Momentum()
    params0 = {k: np.arange(int(np.prod(s)), dtype=np.float32)
               .reshape(s) for k, s in _ZSHAPES.items()}
    template = {k: torch.from_numpy(x) for k, x in params0.items()}

    def init_state(rid):
        return {k: _host(x) for k, x in _spare.zero_spare_init(
            opt, template, n_data, slots0[rid]).items()}

    def zero_body(params_in, states, slots, view, ts):
        pos_slots = tuple(slots[view.alive[p]]
                          for p in range(view.size))

        def body(pos, rid):
            comm = mpi.COMM_WORLD
            slot = slots[rid]
            p = {k: _dev(v_, comm) for k, v_ in params_in.items()}
            st = {k: _dev(v_, comm) for k, v_ in states[rid].items()}
            for t in ts:
                grads = ({k: _dev(v_, comm) for k, v_ in
                          _zero_grads(t, slot).items()}
                         if slot is not None else
                         {k: torch.zeros(s, dtype=torch.float32,
                                         device=comm.device)
                          for k, s in _ZSHAPES.items()})
                p, st = _spare.zero_spare_step(
                    comm, opt, p, grads, st, n_data=n_data, slot=slot,
                    slots=pos_slots)
            return ({k: _host(v_) for k, v_ in p.items()},
                    {k: _host(v_) for k, v_ in st.items()})
        return body

    states = {rid: init_state(rid) for rid in view0.alive}
    ts1, ts2 = (0, 1), (2,)
    per_step_ops = len(_ZSHAPES) * 2   # one allreduce + one allgather a leaf
    spec = _spec_for(kind, doomed, None,
                     index=(1 if kind == "preempt"
                            else len(ts1) * per_step_ops))
    with fault_scope([spec]) as plan:
        res1 = rt.run_phase(zero_body(params0, states, slots0,
                                      view0, ts1))
        params1 = res1[0][0]
        states = {view0.alive[p]: res1[p][1] for p in range(world)}
        if kind == "preempt":
            if doomed not in rt.pending_preemptions():
                return v.fail("no preemption notice")
            view1 = rt.consensus(leaving=[doomed])
        else:
            try:
                rt.run_phase(zero_body(params1, states, slots0,
                                       view0, ts2))
                return v.fail("rank_death never fired")
            except RankFailedError as e:
                if doomed not in e.ranks:
                    return v.fail(f"unattributed: {sorted(e.ranks)}")
            view1 = rt.consensus()
    v.rec["fired"] = sorted(plan.fired_kinds())
    if kind not in plan.fired_kinds():
        return v.fail("vacuous cell: the fault never fired")

    slots1 = {rid: slots0[rid] for rid in view1.alive
              if rid != spare_id}
    slots1[spare_id] = slots0[doomed]
    states1 = {rid: states[rid] for rid in view1.alive
               if rid != spare_id}
    states1[spare_id] = {k: _host(x) for k, x in _spare.takeover_shard(
        {k: torch.from_numpy(x) for k, x in states[spare_id].items()},
        slots0[doomed], n_data, template).items()}

    res2 = rt.run_phase(zero_body(params1, states1, slots1,
                                  view1, ts2))
    params_final = res2[0][0]
    states_final = {view1.alive[p]: res2[p][1]
                    for p in range(view1.size)}
    o_params, o_m = _zero_oracle([(ts1 + ts2, range(n_data))])
    for k in _ZSHAPES:
        if not np.array_equal(params_final[k], o_params[k]):
            return v.fail(f"params[{k}] diverge after takeover")
    for rid in view1.alive:
        slot = slots1[rid]
        for k in _ZSHAPES:
            want = _np_shard(o_m[k], n_data, slot)
            if not np.array_equal(states_final[rid][k], want):
                return v.fail(
                    f"momentum shard [{k}] of slot {slot} diverges "
                    "after takeover")
    return v.ok("zero-reshard takeover bitwise (mirrored optimizer "
                f"slices; spare id {spare_id} assumed slot "
                f"{slots0[doomed]})")


# ---------------------------------------------------------------------------
# serve: drain in-flight requests, re-admit on the new world.
# ---------------------------------------------------------------------------


_SERVE_W, _SERVE_M = 4, 2
_SERVE_DOOMED = 1
_SERVE_EXTRA = 3     # surplus id drained so the TP head deal fits (2,)


def _serve_cfg():
    from ..models.transformer import TransformerConfig

    return TransformerConfig(vocab=31, d_model=8, n_heads=4, n_layers=1,
                             d_ff=16, max_seq=32)


_SERVE_PROMPTS = ([3, 4, 5], [6, 7], [8, 9, 10, 11])
_SERVE_BUDGETS = (6, 5, 4)


def _serve_params(cfg, device):
    from ..models.transformer import init_transformer
    from ..runtime import resolve_device

    return init_transformer(7, cfg, device=resolve_device(device))


def _serve_oracle(cfg, params):
    from ..models.transformer import generate

    out = {}
    dev = params["embed"].device
    for i, (p, n) in enumerate(zip(_SERVE_PROMPTS, _SERVE_BUDGETS)):
        seq = generate(cfg, params,
                       torch.tensor(p, dtype=torch.int32,
                                    device=dev)[None, :], n,
                       dtype=params["embed"].dtype)
        out[i] = _host(seq[0])
    return out


def _serve_phase(params, cfg, tickets, steps):
    """Phase body: build an engine, (re-)admit, run ``steps`` steps,
    ledger a snapshot after every one (the survivor-held drain source a
    mid-step death needs)."""
    import mpi4torch_tpu_torch as mpi
    from ..serve import Engine, ServeConfig
    from . import replan as _replan

    ledger = {}

    def body(pos, rid):
        eng = Engine(cfg, params, ServeConfig(slots=2),
                     device=mpi.COMM_WORLD.device)
        if tickets is None:
            for i, (p, n) in enumerate(zip(_SERVE_PROMPTS,
                                           _SERVE_BUDGETS)):
                eng.submit(np.asarray(p), rid=i, max_new=n)
        else:
            _replan.readmit(eng, tickets)
        # Ledger the post-admission state BEFORE the first step: a
        # death inside step 1 must still leave the survivors a
        # re-admission source (zero progress is a valid drain point).
        ledger[pos] = (eng.snapshot_inflight(), dict(eng.results()))
        done = 0
        while eng.pending() and (steps is None or done < steps):
            eng.step()
            done += 1
            ledger[pos] = (eng.snapshot_inflight(),
                           dict(eng.results()))
        return (eng.snapshot_inflight(), eng.results())

    return body, ledger


def _tickets_of(snap):
    from . import replan as _replan

    return [_replan.ServeTicket(rid=r["rid"], prompt=r["prompt"],
                                emitted=list(r["emitted"]),
                                max_new=r["max_new"], key=r["key"])
            for r in snap]


def _run_serve_cell(v, kind: str, action: str, device):
    from . import replan as _replan

    cfg = _serve_cfg()
    params = _serve_params(cfg, device)
    oracle = _serve_oracle(cfg, params)
    rt = _rt(_SERVE_W, device)

    if kind == "preempt":
        spec = _spec_for("preempt", _SERVE_DOOMED, None, index=2)
    else:
        # Measure phase 1's deterministic per-rank op count on a
        # throwaway world so the death reliably lands MID-phase-1 (an
        # overshooting literal index would fire in a later, smaller
        # world against an innocent position).
        probe_spec = FaultSpec("delay", rank=None, op=None,
                               index=10 ** 6)
        with fault_scope([probe_spec]) as probe_plan:
            b, _ = _serve_phase(params, cfg, None, steps=3)
            _rt(_SERVE_W, device).run_phase(b)
            n_ops = max(probe_plan._counts.get((0, r), 0)
                        for r in range(_SERVE_W))
        spec = _spec_for("rank_death", _SERVE_DOOMED, None,
                         index=max(1, n_ops // 2))
    body1, ledger1 = _serve_phase(params, cfg, None, steps=3)
    with fault_scope([spec]) as plan:
        if kind == "preempt":
            res1 = rt.run_phase(body1)
            snap, res_done = res1[0]
            if _SERVE_DOOMED not in rt.pending_preemptions():
                return v.fail("no preemption notice")
            view1 = rt.consensus(
                leaving=[_SERVE_DOOMED, _SERVE_EXTRA])
        else:
            try:
                rt.run_phase(body1)
                return v.fail("rank_death never fired mid-serving")
            except RankFailedError as e:
                if _SERVE_DOOMED not in e.ranks:
                    return v.fail(f"unattributed: {sorted(e.ranks)}")
            survivor = next(p for p in range(_SERVE_W)
                            if p != _SERVE_DOOMED and p in ledger1)
            snap, res_done = ledger1[survivor]
            view1 = rt.consensus(leaving=[_SERVE_EXTRA])
    v.rec["fired"] = sorted(plan.fired_kinds())
    if kind not in plan.fired_kinds():
        return v.fail("vacuous cell: the fault never fired")
    if view1.size != _SERVE_M:
        return v.fail(f"post-shrink view wrong: {view1.describe()}")

    tickets = _tickets_of(snap)
    results = dict(res_done)

    if action == "grow":
        body2, _ = _serve_phase(params, cfg, tickets, steps=2)
        res2 = rt.run_phase(body2)
        snap2, res2_done = res2[0]
        results.update(res2_done)
        tickets = _tickets_of(snap2)
        rt.consensus(joining=[_SERVE_DOOMED, _SERVE_EXTRA])

    body3, _ = _serve_phase(params, cfg, tickets, steps=None)
    res3 = rt.run_phase(body3)
    _snap3, res3_done = res3[0]
    results.update(res3_done)

    stitched = _replan.stitched_results(results, tickets)
    for i in oracle:
        got = stitched.get(i)
        if got is None:
            return v.fail(f"request {i} never finished after the resize")
        if not np.array_equal(np.asarray(got, np.int64),
                              np.asarray(oracle[i], np.int64)):
            return v.fail(
                f"request {i}'s stitched tokens diverge from the "
                "per-request generate() oracle")
    return v.ok(
        f"in-flight requests drained and re-admitted on "
        f"{rt.view.describe()}; all token streams bitwise vs "
        "generate()")


# ---------------------------------------------------------------------------
# cell dispatch + consensus cells
# ---------------------------------------------------------------------------


def run_cell(kind: str, subsystem: str, action: str,
             workdir: Optional[str] = None, device=None) -> dict:
    """Run one elastic matrix cell; returns the verdict record
    (``status`` ok/fail, ``detail``, the fired-fault ledger, and
    ``fallback`` for the mirror-less spare subsystems).  ``workdir``
    (a scratch directory) serves the cells that exercise the real
    epoch-stamped checkpoint leg (zero × rank_death; a temporary
    directory when None).  ``device`` is the rank worlds' (CUDA unless
    ``"cpu"`` is asked for)."""
    expected = COVERAGE.get((kind, subsystem, action))
    v = _verdict(kind, subsystem, action, expected)
    if expected is None:
        return v.fail("no COVERAGE row — the registry-sync guard "
                      "should have caught this")
    try:
        if action == "spare" and subsystem in SPARE_FALLBACK:
            v.rec["fallback"] = True
            if subsystem == "serve":
                return _run_serve_cell(v, kind, "shrink", device)
            return _run_bank_cell(v, kind, "shrink", moe=True,
                                  device=device)
        if action == "spare":
            return _run_spare_cell(v, kind, subsystem, device)
        if subsystem == "plain":
            return _run_bank_cell(v, kind, action, moe=False,
                                  device=device)
        if subsystem == "moe":
            return _run_bank_cell(v, kind, action, moe=True, device=device)
        if subsystem == "zero":
            import tempfile

            if workdir is not None or kind != "rank_death":
                return _run_zero_cell(v, kind, action, workdir, device)
            with tempfile.TemporaryDirectory() as d:
                return _run_zero_cell(v, kind, action, d, device)
        if subsystem == "serve":
            return _run_serve_cell(v, kind, action, device)
        return v.fail(f"unknown subsystem {subsystem!r}")
    except Exception as e:  # noqa: BLE001 — a cell must never hang the lane
        return v.fail(f"unexpected {type(e).__name__}: {str(e)[:300]}")


def run_consensus_cell(kind: str, device=None) -> dict:
    """The membership-failure cells: consensus must END — in a typed,
    rank-attributed raise — when a participant disagrees or dies
    mid-round."""
    import mpi4torch_tpu_torch as mpi

    expected = EXPECTED_CONSENSUS_ERROR[kind]
    v = _verdict(kind, "membership", "consensus", "raise")
    rt = _rt(4, device)
    view = rt.view

    if kind == "disagree":
        def body(pos):
            def propose(p):
                if pos == 2:
                    return WorldView(p.epoch, p.alive,
                                     (2, len(p.alive) // 2))
                return p
            return agree_world_view(view, probe_timeout=PROBE_TIMEOUT_S,
                                    _propose=propose)

        try:
            mpi.run_ranks(body, 4, timeout=WORLD_TIMEOUT_S, device=device)
            return v.fail("disagreement went undetected")
        except ConsensusError as e:
            if 2 not in e.ranks:
                return v.fail(f"ConsensusError unattributed: "
                              f"{sorted(e.ranks)}")
            return v.ok(f"ConsensusError naming id(s) {sorted(e.ranks)}")
        except Exception as e:  # noqa: BLE001
            return v.fail(f"expected ConsensusError, got "
                          f"{type(e).__name__}: {e}")

    # second_failure: rank 3 passes the probe, then dies on its very
    # first consensus p2p (the proposal send) — the coordinator's recv
    # must surface the attributed RankFailedError, not hang.
    spec = FaultSpec("rank_death", rank=3, op="p2p", index=0)
    with fault_scope([spec]) as plan:
        def body(pos):
            return agree_world_view(view, probe_timeout=PROBE_TIMEOUT_S)

        try:
            mpi.run_ranks(body, 4, timeout=WORLD_TIMEOUT_S, device=device)
            rec = v.fail("second failure went undetected")
        except RankFailedError as e:
            if 3 not in e.ranks:
                rec = v.fail(f"RankFailedError unattributed: "
                             f"{sorted(e.ranks)}")
            else:
                rec = v.ok("mid-consensus death raised RankFailedError "
                           f"naming rank(s) {sorted(e.ranks)}")
        except Exception as e:  # noqa: BLE001
            rec = v.fail(f"expected {expected.__name__}, got "
                         f"{type(e).__name__}: {e}")
    v.rec["fired"] = sorted(plan.fired_kinds())
    if rec["status"] == "ok" and "rank_death" not in plan.fired_kinds():
        return v.fail("vacuous cell: the mid-consensus death never "
                      "fired")
    return rec
