"""Faults planted in the dropless MoE under the timed path, for the MoE
cell's controls: each takes the model family and returns a step function
in the place of its entry.  A run with any of them must come out not
``correct``.

    python3 benchmark/faults_moe.py --workload <cell> --seeds 1,2 \\
        [--control-seeds 1] [--out readings.jsonl]

runs :mod:`benchmark.calibrate` with these faults beside
:mod:`benchmark.faults`'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_lock = threading.Lock()
_held = {}


@contextlib.contextmanager
def _patched(module, name, value):
    """``module.name`` replaced by ``value`` while any rank thread is
    inside a step that asked for it (the rank threads share the module)."""
    key = (module.__name__, name)
    with _lock:
        if key not in _held:
            _held[key] = [getattr(module, name), 0]
            setattr(module, name, value)
        _held[key][1] += 1
    try:
        yield
    finally:
        with _lock:
            _held[key][1] -= 1
            if _held[key][1] == 0:
                setattr(module, name, _held.pop(key)[0])


def _with_cfg(fam, change):
    def step(comm, cfg, params, batch, lr):
        return fam.train_step(comm, change(cfg), params, batch, lr)
    return step


def top1(fam):
    """Every token routed to its one most probable expert."""
    return _with_cfg(fam, lambda c: dataclasses.replace(
        c, experts_per_token=1))


def default_rope_on_full(fam):
    """The full layer rotated by the default rope, not YaRN."""
    return _with_cfg(fam, lambda c: dataclasses.replace(c, yarn_factor=0.0))


def window_on_full(fam):
    """The sliding window applied on the full layer too."""
    from mpi4torch_tpu_torch.models.transformer import TransformerConfig

    class Windowed(TransformerConfig):
        def layer_window(self, i):
            return self.attn_window

    def change(c):
        return Windowed(**{f.name: getattr(c, f.name)
                           for f in dataclasses.fields(c)})
    return _with_cfg(fam, change)


def gates_not_renormalised(fam):
    """The top-k probabilities used as the gates as they are."""
    import torch
    from mpi4torch_tpu_torch.parallel import moe

    def route(logits, k):
        top, experts = torch.topk(torch.softmax(logits.float(), -1), k, -1)
        return experts, top

    def step(comm, cfg, params, batch, lr):
        with _patched(moe, "topk_route", route):
            return fam.train_step(comm, cfg, params, batch, lr)
    return step


def other_experts_left_out(fam):
    """Each token given only its own rank's experts' part: the rows that
    come from the other ranks are zeroed on arrival, so their experts
    compute nothing for them and return nothing."""
    from mpi4torch_tpu_torch.parallel import moe

    exchange = moe.ragged_alltoall

    def own_rows_only(comm, x, send_counts, recv_counts=None):
        recv, counts = exchange(comm, x, send_counts, recv_counts)
        keep = recv.new_zeros(recv.shape[0], *([1] * (recv.dim() - 1)))
        keep[comm.rank] = 1
        return recv * keep, counts

    def step(comm, cfg, params, batch, lr):
        with _patched(moe, "ragged_alltoall", own_rows_only):
            return fam.train_step(comm, cfg, params, batch, lr)
    return step


FAULTS = {"top1": top1, "gates_not_renormalised": gates_not_renormalised,
          "other_experts_left_out": other_experts_left_out,
          "window_on_full": window_on_full,
          "default_rope_on_full": default_rope_on_full}


def main(argv=None):
    from benchmark import calibrate, faults

    class Both:
        FAULTS = {**faults.FAULTS, **FAULTS}

    calibrate.faults = Both
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
