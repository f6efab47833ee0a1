"""Faults planted under the timed path, for the checks' controls: each
takes a model family and returns a step function in the place of its
entry.  A run with any of them must come out not ``correct``."""

from __future__ import annotations


def _half(batch):
    """The first half of every rank-local batch tensor's rows."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_half(b) for b in batch)
    return batch[:batch.shape[0] // 2]


def unchanged(fam):
    """A step that returns its state unchanged."""
    def step(comm, cfg, params, batch, lr):
        return fam.train_step(comm, cfg, params, batch, lr)[0], params
    return step


def half_batch(fam):
    """Half of each rank's batch left out, the mean taken over the rest."""
    def step(comm, cfg, params, batch, lr):
        return fam.train_step(comm, cfg, params, _half(batch), lr)
    return step


def no_exchange(fam):
    """The exchange between the ranks left out: each rank steps on its own
    gradient."""
    def step(comm, cfg, params, batch, lr):
        return fam.train_step(None, cfg, params, batch, lr)
    return step


def altered_loss(fam):
    """The loss altered where it is produced: one nat added."""
    def step(comm, cfg, params, batch, lr):
        loss, new = fam.train_step(comm, cfg, params, batch, lr)
        return loss + 1.0, new
    return step


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "altered_loss": altered_loss}
