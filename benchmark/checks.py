"""The numbers that decide ``correct`` for a training cell, and their
comparison with the cell's limits.

The program's first steps are held to the plain float32 reference's:

* ``loss_gap`` — the worst step's ``|loss - reference loss| / reference
  loss``, over every rank;
* ``grad_gap`` / ``change_gap`` — for the first step's gradient as SGD
  applied it (``(p0 - p1) / lr``) and for the parameters' change over the
  checked steps (``p_n - p0``), leaf by leaf: ``| ||program|| -
  ||reference|| |`` over the reference's norm of that leaf or of the
  median leaf, whichever is larger; the worst leaf of any rank
  (``*_worst``) and the median leaf of the worst rank (``*_median``);
* ``ranks_differ`` — leaves whose parameters differ, bit for bit, between
  rank 0 and another rank after the checked steps (data-parallel ranks
  end every step with the same bits);
* ``unmoved_leaves`` — leaves that the reference moves and the program
  leaves bit for bit as they were, on any rank.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's move by round-off alone and are left out of the change.  The
reference moves a leaf when it changes at least a hundredth of its
elements over the checked steps: a bfloat16 norm scale at 1.0, whose
updates round away, may see one element cross a rounding tie on one side
and not on the other, which is no movement.

Two readings are judged by no limit and say what the median leaf's norm
hides: ``*_gap_small_own``, the worst gap of a moved leaf below the median
leaf, measured against that leaf's own reference norm.
"""

from __future__ import annotations

import statistics

QUIET_LEAF = 1e-3
MOVED_SHARE = 1e-2


def _rel_gaps(prog, ref, keep=None):
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return [abs(prog[i] - ref[i]) / max(ref[i], med, 1e-300) for i in idx]


def readings(prog: dict, ref: dict) -> dict:
    """``prog``: ``losses[rank][step]``, ``grad1[rank][leaf]`` and
    ``change[rank][leaf]`` norms, ``moved[rank][leaf]`` shares of changed
    elements, ``ranks_differ``; ``ref``: ``losses``, the ``grad1``,
    ``change`` and ``gradient`` (the first step's, as computed, for the
    rule on quiet leaves) norms and the ``moved`` shares, one per leaf in
    the same order."""
    out = {"loss_gap": max(abs(l - r) / abs(r)
                           for ranks in prog["losses"]
                           for l, r in zip(ranks, ref["losses"]))}
    med_g = statistics.median(ref["gradient"])
    moving = [g >= QUIET_LEAF * med_g for g in ref["gradient"]]
    for name, key, keep in (("grad", "grad1", None),
                            ("change", "change", moving)):
        per_rank = [_rel_gaps(p, ref[key], keep) for p in prog[key]]
        out[f"{name}_gap_worst"] = max(max(g) for g in per_rank)
        out[f"{name}_gap_median"] = max(statistics.median(g)
                                        for g in per_rank)
    out["ranks_differ"] = prog["ranks_differ"]
    out["quiet_leaves"] = moving.count(False)
    moved = [k and m >= MOVED_SHARE for k, m in zip(moving, ref["moved"])]
    out["unmoved_leaves"] = max(
        sum(1 for m, r in zip(mv, moved) if r and m == 0.0)
        for mv in prog["moved"])
    for name, key in (("grad", "grad1"), ("change", "change")):
        med = statistics.median(ref[key])
        small = [i for i, r in enumerate(ref[key])
                 if moved[i] and 0.0 < r < med]
        out[f"{name}_gap_small_own"] = max(
            (abs(p[i] - ref[key][i]) / ref[key][i]
             for p in prog[key] for i in small), default=0.0)
    return out


def judge(values: dict, limits: dict):
    """``(correct, [(name, value, limit, ok)])`` over the numbers that
    ``limits`` holds, in its order."""
    rows = [(name, values[name], lim, values[name] <= lim)
            for name, lim in limits.items()]
    return all(r[3] for r in rows), rows
