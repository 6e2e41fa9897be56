"""Paged KV-cache block manager (vLLM-style PagedAttention bookkeeping).

KV memory is a pool of fixed-size blocks (``block_size`` token slots each).
Every running request owns a *block table* — the ordered list of block ids
holding its KV — which the scheduler broadcasts to the workers each step,
so the control-plane payload scales with the batch like a real serving
engine ("Mind the Memory Gap", arXiv:2503.08311 studies exactly this
block-granular memory/batching interaction).

Prefix caching is refcount-based: when a full block of prompt tokens has
been computed, its chained hash (key(i) = hash(key(i-1), block_i tokens))
is registered in ``_cache``.  A later request whose prompt matches locks
(increfs) those blocks and skips their prefill.  Blocks whose refcount
drops to zero but that are still registered move to an LRU *evictable*
list: they keep their contents and can be re-locked for free, but are
reclaimed (hash dropped) when allocation would otherwise fail.  Because
the cache is backed by real blocks (not a grow-forever hash index), it
can never reference more KV than physically exists.

A second, host-memory tier (``HostSwapSpace``) backs swap-to-host
preemption: a preempted request's computed blocks are copied out of the
device pool into bounded host blocks (``swap_out``) and copied back into
freshly allocated device blocks on re-admission (``swap_in``).  The
manager only does the bookkeeping and emits (src, dst) block pairs; the
``repro.backend`` executors perform the actual page copies (see
docs/preemption.md for the full lifecycle).

Refcount rules (the invariants every caller relies on):

  * every block id returned by ``allocate``/``lock_prefix`` carries
    exactly one reference owned by the caller, released with ``free`` —
    alloc/free are symmetric by construction, shared prefix blocks are
    refcounted and never double-freed;
  * a refcount never goes negative (``free`` asserts), and
    ``free_blocks + used_blocks == num_blocks`` holds after every
    public call;
  * refcount-0 registered blocks are *evictable*, not free: contents
    survive until ``allocate`` reclaims them LRU-first;
  * ``swap_out`` moves a request's device references to host references
    atomically (all blocks or none); host references are dropped by
    ``swap_in`` or ``swap_release``, never both;
  * under the async copy engine (docs/copy_engine.md) the blocks a
    transfer reads stay IN_FLIGHT until its epoch retires:
    ``swap_out(..., defer_free=True)`` keeps the device references alive
    (released later by ``finish_swap_out``) and
    ``swap_in(..., defer_release=True)`` keeps the host ownership alive
    (released later via ``swap_space.release``) — so a page being copied
    can never be reallocated, and hence never overwritten, mid-copy;
  * device copies of swapped-out cached blocks are demoted to the cold
    end of the LRU — they are the cheapest eviction candidates since
    the host tier also holds their contents.

The manager is pure control-plane bookkeeping (no tensors); the
``repro.backend`` executors index their physical caches with the block
ids handed out here.

Copied from ``src/repro/serving/blocks.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import profiling


class HostSwapSpace:
    """Bounded host-memory block pool — the swap tier for preempted KV.

    Pure accounting, mirroring ``BlockManager``: host block ids index the
    backends' host pools the way device block ids index their page pools.
    Ownership is per-request (a swapped request's blocks are released as
    one unit on swap-in or abort), so there is no refcounting here — host
    blocks are never shared.
    """

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: collections.deque = collections.deque(range(num_blocks))
        self._owner: Dict[int, List[int]] = {}   # req_id -> host block ids

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def swapped_requests(self) -> int:
        return len(self._owner)

    def can_hold(self, n: int) -> bool:
        return n <= len(self._free)

    def allocate(self, req_id: int, n: int) -> Optional[List[int]]:
        """Reserve ``n`` host blocks for ``req_id`` (all-or-nothing)."""
        assert req_id not in self._owner, f"req {req_id} already swapped"
        if n > len(self._free):
            return None
        got = [self._free.popleft() for _ in range(n)]
        self._owner[req_id] = got
        return got

    def blocks_of(self, req_id: int) -> List[int]:
        return self._owner[req_id]

    def release(self, req_id: int) -> List[int]:
        """Return ``req_id``'s host blocks to the pool."""
        got = self._owner.pop(req_id)
        self._free.extend(got)
        return got


def chain_key(prev_key: int, block_tokens: Sequence[int]) -> int:
    """Chained block hash: O(n) per prompt, not O(n^2/block) full tuples."""
    return hash((prev_key, tuple(block_tokens)))


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int, *,
                 enable_prefix_cache: bool = True,
                 swap_space: Optional[HostSwapSpace] = None):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        self.swap_space = swap_space
        self._free: collections.deque = collections.deque(range(num_blocks))
        self._ref: List[int] = [0] * num_blocks
        self._hash_of: List[Optional[int]] = [None] * num_blocks
        self._cache: Dict[int, int] = {}           # chain key -> block id
        # refcount-0 blocks that still hold registered KV, in LRU order
        self._evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    # -- capacity ------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        """Blocks allocatable right now (truly free + evictable cached)."""
        return len(self._free) + len(self._evictable)

    @property
    def used_blocks(self) -> int:
        """Blocks referenced by at least one live request."""
        return self.num_blocks - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        return len(self._cache)

    def cache_keys(self) -> List[int]:
        """Chain keys of every resident prefix-cache block (locked or
        evictable).  Fleet routing folds these into a per-replica bloom
        summary (``repro.fleet.PrefixSummary``); the set is authoritative at
        call time but a router-side copy decays as LRU eviction reclaims
        blocks — consumers must treat hits as probabilistic."""
        return list(self._cache.keys())

    def ref_count(self, block_id: int) -> int:
        return self._ref[block_id]

    # -- prefix cache --------------------------------------------------------

    def _walk_prefix(self, tokens: Sequence[int],
                     max_tokens: Optional[int]) -> Tuple[int, List[int]]:
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(len(tokens),
                                                          max_tokens)
        n, key, blks = 0, 0, []
        for i in range(0, limit - bs + 1, bs):
            key = chain_key(key, tokens[i:i + bs])
            b = self._cache.get(key)
            if b is None:
                break
            blks.append(b)
            n = i + bs
        return n, blks

    def match_prefix(self, tokens: Sequence[int],
                     max_tokens: Optional[int] = None) -> Tuple[int, List[int]]:
        """Read-only probe: (cached token count, block ids), full blocks only.

        ``max_tokens`` caps the match (the scheduler passes n_prompt - 1 so
        the last prompt token is always computed, never skipped)."""
        if not self.enable_prefix_cache:
            return 0, []
        return self._walk_prefix(tokens, max_tokens)

    def lock_prefix(self, tokens: Sequence[int],
                    max_tokens: Optional[int] = None) -> Tuple[int, List[int]]:
        """Like match_prefix, but increfs the matched blocks (they become
        part of the caller's block table and must be freed with free())."""
        n, blks = self.match_prefix(tokens, max_tokens)
        for b in blks:
            self._incref(b)
        return n, blks

    def register(self, key: int, block_id: int) -> bool:
        """Publish a fully-computed block under its chain key.  First writer
        wins: a concurrent identical prompt keeps its duplicate block
        private (freed normally when its request finishes)."""
        if not self.enable_prefix_cache or key in self._cache:
            return False
        self._cache[key] = block_id
        self._hash_of[block_id] = key
        return True

    # -- alloc / free --------------------------------------------------------

    def _incref(self, block_id: int) -> None:
        if self._ref[block_id] == 0:
            # resurrect an evictable cached block
            self._evictable.pop(block_id, None)
        self._ref[block_id] += 1

    def _evict_one(self) -> int:
        block_id, _ = self._evictable.popitem(last=False)   # LRU
        key = self._hash_of[block_id]
        if key is not None:
            del self._cache[key]
            self._hash_of[block_id] = None
        return block_id

    def allocate(self, n: int) -> Optional[List[int]]:
        """Hand out ``n`` blocks (refcount 1 each), evicting LRU cached
        blocks if the free list runs dry.  All-or-nothing: returns None
        when fewer than ``n`` blocks are reclaimable (caller preempts)."""
        profiling.hit("block_alloc", n=n)
        if n > self.free_blocks:
            return None
        out = []
        for _ in range(n):
            block_id = self._free.popleft() if self._free else self._evict_one()
            assert self._ref[block_id] == 0
            self._ref[block_id] = 1
            out.append(block_id)
        return out

    def free(self, block_ids: Sequence[int]) -> None:
        """Drop one reference per block.  Registered blocks whose refcount
        hits zero become evictable (contents retained); unregistered ones
        return to the free list."""
        for b in block_ids:
            assert self._ref[b] > 0, f"double free of block {b}"
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if self._hash_of[b] is not None:
                    self._evictable[b] = None          # most-recently used
                    self._evictable.move_to_end(b)
                else:
                    self._free.append(b)

    # -- swap tier -----------------------------------------------------------

    def swap_out(self, req_id: int, block_table: Sequence[int], *,
                 defer_free: bool = False
                 ) -> Optional[List[Tuple[int, int]]]:
        """Move ``req_id``'s device references to the host tier.

        Reserves one host block per device block (all-or-nothing; None
        when the host pool cannot hold the table), drops the device
        references, and returns the ``(device_block, host_block)`` copy
        directives the backends execute *before* any block reuse in the
        same step.  Device blocks this request had registered in the
        prefix cache stay evictable — but are demoted to the cold (LRU)
        end, since their contents now also live on host.

        ``defer_free=True`` (async copy engine): the device references
        are NOT dropped — the copy is in flight, so the source pages
        must stay unreallocatable until the transfer's epoch retires and
        the caller runs ``finish_swap_out``."""
        if self.swap_space is None:
            return None
        host = self.swap_space.allocate(req_id, len(block_table))
        if host is None:
            return None
        pairs = list(zip(block_table, host))
        if not defer_free:
            self.finish_swap_out(block_table)
        return pairs

    def finish_swap_out(self, block_table: Sequence[int]) -> None:
        """Release a swap-out's source device blocks (inline for the
        serialized path; the copy engine's retire action for a deferred
        one): drop the references, then demote any still-cached copies
        to the cold LRU end — the host tier holds their contents too,
        so they are the cheapest eviction candidates."""
        self.free(block_table)
        for b in block_table:
            if b in self._evictable:       # cheapest eviction candidate now
                self._evictable.move_to_end(b, last=False)

    def swap_in(self, req_id: int, *, defer_release: bool = False
                ) -> Optional[List[Tuple[int, int]]]:
        """Bring a swapped request back: allocate fresh device blocks for
        its host blocks and release the host tier.  Returns the
        ``(host_block, device_block)`` restore directives (None — with no
        side effects — when the device pool cannot fit the table; the
        caller retries on a later step).

        ``defer_release=True`` (async copy engine): host ownership is
        kept — the restore copy still reads those host pages — until the
        transfer's epoch retires and the caller releases via
        ``swap_space.release(req_id)``."""
        assert self.swap_space is not None
        host = self.swap_space.blocks_of(req_id)
        dev = self.allocate(len(host))
        if dev is None:
            return None
        if not defer_release:
            self.swap_space.release(req_id)
        return list(zip(host, dev))

    def swap_release(self, req_id: int) -> None:
        """Drop a swapped request's host blocks without restoring (abort /
        client timeout while swapped)."""
        assert self.swap_space is not None
        self.swap_space.release(req_id)
