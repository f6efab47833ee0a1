"""Host-side block accounting for the paged KV cache.

Port of ``mpi4torch_tpu/serve/paging.py`` (pure Python and numpy, so the
port keeps its own copy).  The device side of paging is two primitives
(:func:`mpi4torch_tpu_torch.ops.ragged.block_gather` /
:func:`~mpi4torch_tpu_torch.ops.ragged.block_scatter`) driven by a
per-slot block table.  Everything else — which physical page holds which
logical positions, who may write where, what can be shared and what must
be copied — is plain host bookkeeping, and it lives here so the engine
stays a scheduler.

:class:`BlockManager` owns one block-id space shared by every layer
(block ``i`` of layer 0 and block ``i`` of layer N are the same logical
page — one table addresses all layers), with three populations:

* **in use** — referenced by at least one live slot (``refcount > 0``).
  Shared prefix pages carry one reference per sharing slot.
* **cached** — ``refcount == 0`` but still registered in the prefix
  index: the page outlives its last user so an identical prompt prefix
  can be re-referenced instead of re-prefilled.  Cached pages are the
  eviction pool — :meth:`BlockManager.alloc` reclaims them LRU when the
  free list runs dry, so caching never costs capacity.
* **free** — unreferenced, unregistered.

**Prefix index.**  Content-addressed chain hashes: page ``k`` of a
sequence is keyed by ``H(H_{k-1}, tokens[k*bs:(k+1)*bs])`` (sha256 over
the parent digest and the page's tokens as int64), so a hash fully
determines the page's K/V content and a match can only return a page
whose rows are what prefilling those tokens would produce.  One
partial-tail entry per chain (the last, partly-filled page of a
registered prompt) extends matches below page granularity; a matcher may
consume any prefix of the registered tail.  Matches are capped at
``len(prompt) - 1`` tokens: at least one suffix token must be computed,
because admission needs last-token logits.

**Copy-on-write rule.**  Pages reachable by anyone else — shared full
pages, and any partially-filled matched tail — are never written in
place.  A partial-tail hit is always copied into a fresh private page
before the suffix lands (``cow_copies`` counts them); full shared pages
are read-only by construction (every writer's frontier is beyond them).
The engine's write positions therefore always target private pages,
which is what makes :func:`block_scatter`'s distinct-cells invariant
hold.

Every method is host bookkeeping over deterministic inputs, so the
engines of N rank threads make identical decisions and their tables
never diverge under the decode collectives.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BlockManager"]

_SEED = b"mpi4torch_tpu.serve.paging"


def _chain_hash(parent: bytes, tokens) -> bytes:
    """Content hash of one page given its chain parent: collisions
    would alias DIFFERENT token prefixes onto one page, so this is
    sha256 over the parent digest + the page's tokens as fixed-width
    ints, not a fast noncryptographic hash."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class BlockManager:
    """Allocator + refcounts + prefix index for ``num_blocks`` pages of
    ``block_size`` tokens.  ``prefix_cache=False`` turns the index off
    (every match misses, nothing registers) while keeping the
    alloc/free discipline — the engine's exactness gate for cache
    dtypes below compute precision uses this."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 prefix_cache: bool = True):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        self._free: deque = deque(range(self.num_blocks))
        self._ref = [0] * self.num_blocks
        # LRU order: oldest-cached first (popitem(last=False) evicts).
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._full = {}      # chain hash -> block id
        self._partial = {}   # parent chain hash -> (token tuple, block id)
        self._keys = {}      # block id -> [("full"|"partial", hash), ...]

    # ------------------------------------------------------------ census

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free) - len(self._cached)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    # --------------------------------------------------------- alloc/free

    def alloc(self, n: int, keep: Sequence[int] = ()) -> Optional[List[int]]:
        """``n`` fresh private pages (``refcount`` 1, caller-owned), or
        ``None`` when even evicting every cached page cannot supply
        them — the caller then defers (admission) or preempts (decode).
        Cached pages are reclaimed LRU; their index entries drop with
        them, so a reclaimed id can never satisfy a later match.  Cached
        pages listed in ``keep`` are not reclaimed: an admission passes
        the pages its :meth:`match` just returned, which it has not
        referenced yet.  (The JAX package's ``alloc`` has no ``keep``; its
        engine can reclaim a matched page for the same request's fresh
        pages, and then reads a page its own prefill overwrites.)"""
        keep = set(keep)
        while len(self._free) < n:
            b = next((c for c in self._cached if c not in keep), None)
            if b is None:
                break
            del self._cached[b]
            self._drop_keys(b)
            self._free.append(b)
        if len(self._free) < n:
            return None
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def ref(self, blocks: Sequence[int]) -> None:
        """Take one reference per listed page (a slot adopting matched
        prefix pages).  A cached page returns to the in-use population."""
        for b in blocks:
            if self._ref[b] == 0:
                self._cached.pop(b, None)
            self._ref[b] += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per listed page.  At zero, a registered
        page parks in the cached (evictable) population; an unregistered
        one frees immediately."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise ValueError(f"release of unreferenced block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if self._keys.get(b):
                    self._cached[b] = None      # MRU end
                else:
                    self._free.append(b)

    def _drop_keys(self, block: int) -> None:
        for kind, h in self._keys.pop(block, []):
            if kind == "full" and self._full.get(h) == block:
                del self._full[h]
            elif kind == "partial" \
                    and self._partial.get(h, (None, None))[1] == block:
                del self._partial[h]

    # ------------------------------------------------------- prefix index

    def match(self, tokens, limit: int) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``tokens`` usable by a new
        sequence: ``(block_ids, n_tokens)`` with ``n_tokens <= limit``
        (the caller passes ``len(prompt) - 1`` so at least one suffix
        token remains to prefill).  Full pages chain-walk the index;
        one partial tail may follow, of which any leading sub-run
        counts (``n_tokens`` then lands mid-page — the engine's COW
        copy rule triggers on exactly that).  Returned pages are NOT
        yet referenced; the caller :meth:`ref`\\ s what it adopts."""
        if not self.prefix_cache or limit < 1:
            return [], 0
        tokens = np.asarray(tokens)
        bs = self.block_size
        ids: List[int] = []
        n = 0
        h = _SEED
        while n + bs <= limit:
            h2 = _chain_hash(h, tokens[n:n + bs])
            b = self._full.get(h2)
            if b is None:
                break
            ids.append(b)
            h = h2
            n += bs
        ent = self._partial.get(h)
        if ent is not None:
            ptoks, b = ent
            t = min(len(ptoks), limit - n)
            if t >= 1 and tuple(int(x) for x in tokens[n:n + t]) \
                    == tuple(ptoks[:t]):
                ids.append(b)
                n += t
        return ids, n

    def register(self, tokens, block_ids: Sequence[int],
                 n_tokens: int) -> None:
        """Index ``tokens[:n_tokens]`` as resident in ``block_ids``
        (which must cover ``ceil(n_tokens / block_size)`` pages).  Full
        pages register once per content hash (first writer wins — the
        hashes are content-addressed, so duplicates are bitwise
        interchangeable); a partial tail registers per chain, longest
        run winning.  Registration pins nothing: it only makes the page
        cached-not-freed when its refcount later hits zero."""
        if not self.prefix_cache or n_tokens < 1:
            return
        tokens = np.asarray(tokens)
        bs = self.block_size
        h = _SEED
        full = int(n_tokens) // bs
        for k in range(full):
            h = _chain_hash(h, tokens[k * bs:(k + 1) * bs])
            if h not in self._full:
                b = block_ids[k]
                self._full[h] = b
                self._keys.setdefault(b, []).append(("full", h))
        rem = int(n_tokens) - full * bs
        if rem:
            b = block_ids[full]
            cur = self._partial.get(h)
            if cur is None or len(cur[0]) < rem:
                self._partial[h] = (
                    tuple(int(x) for x in tokens[full * bs:n_tokens]), b)
                self._keys.setdefault(b, []).append(("partial", h))
