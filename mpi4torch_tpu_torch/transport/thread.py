"""The thread transport: ``run_ranks``' own rank threads.

Port of ``mpi4torch_tpu/transport/thread.py``.  It delegates to
``runtime.run_ranks`` with ``backend="thread"``, so the registry's
"thread" entry is the same code object the default path runs.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from .base import Transport

__all__ = ["ThreadTransport"]


class ThreadTransport(Transport):
    name = "thread"

    def run_ranks(self, fn: Callable, nranks: int,
                  timeout: Optional[float] = None,
                  return_results: bool = True, device=None) -> List[Any]:
        from ..runtime import run_ranks

        return run_ranks(fn, nranks, timeout=timeout,
                         return_results=return_results, backend="thread",
                         device=device)
