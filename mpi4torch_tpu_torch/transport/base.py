"""The transport abstraction: what a ``run_ranks`` backend owes.

Port of ``mpi4torch_tpu/transport/base.py``.  A transport executes one
:func:`mpi4torch_tpu_torch.run_ranks` call — N rank bodies against one
logical world — under the contract the rank threads set:

* **The chokepoints stay the chokepoints.**  Every rank body's
  communication goes through ``World.exchange`` and
  ``World.p2p_send``/``p2p_recv`` (runtime.py), whose tracer and fault
  hooks are inherited code on every backend: a transport replaces only
  the ``*_wire`` seams below them, so fault injection, tracing and
  retries compose over any backend with no hook of their own.
* **Bitwise results.**  A rank body computes the same bits on every
  backend: payloads cross the wire losslessly, and the process-wide
  configuration and torch numeric state a rank thread would see are
  shipped (never the launcher's thread-scoped state, which rank threads
  do not see either).
* **Attributed failures.**  A dead rank surfaces as the same
  rank-attributed :class:`~mpi4torch_tpu_torch.RankFailedError` on every
  survivor, a torn rendezvous as the same arrived/missing
  :class:`~mpi4torch_tpu_torch.DeadlockError`, and the first per-rank
  error is re-raised with the others in a note (``runtime._raise_primary``,
  one rule for every backend).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

__all__ = ["Transport"]


class Transport:
    """Base class of a registered ``run_ranks`` backend."""

    #: Registry name (the ``transport.TRANSPORTS`` key).
    name: str = "?"

    def run_ranks(self, fn: Callable, nranks: int,
                  timeout: Optional[float] = None,
                  return_results: bool = True, device=None) -> List[Any]:
        raise NotImplementedError

    def shutdown(self) -> None:
        """Release long-lived resources (worker pools).  Idempotent; the
        thread backend has none."""
