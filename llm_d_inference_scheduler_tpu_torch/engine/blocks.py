"""KV-cache block allocator (copy of ``llm_d_inference_scheduler_tpu/engine/blocks.py``).

Physical block 0 is reserved as the trash block: padding lanes and inactive
decode slots write their KV there (models/llama.py relies on this), so the
decode scatter needs no masking branches.
"""

from __future__ import annotations


class OutOfBlocks(Exception):
    pass


class BlockAllocator:
    TRASH = 0

    def __init__(self, n_blocks: int, block_size: int):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(n_blocks - 1, 0, -1))  # pop() yields 1,2,…

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_fraction(self) -> float:
        usable = self.n_blocks - 1
        return (usable - len(self._free)) / usable if usable else 0.0

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfBlocks(f"need {n} blocks, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        return out

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == self.TRASH:
                raise ValueError("attempt to free trash block 0")
            self._free.append(b)


class PrefixCachingAllocator(BlockAllocator):
    """Block allocator with automatic prefix caching (the engine-side analogue
    of vLLM's APC, which the reference's prefix scorers assume exists on every
    pod).

    Complete prompt blocks are content-addressed by their chained hash
    (utils/hashing.py). On release, hash-committed blocks with no remaining
    references park in a reusable LRU instead of the free list; a later
    request whose prompt shares the prefix re-acquires them (refcount++) and
    skips recomputing that KV. New allocations evict from the LRU only when
    the free list runs dry.
    """

    def __init__(self, n_blocks: int, block_size: int):
        super().__init__(n_blocks, block_size)
        from collections import OrderedDict

        self._ref: dict[int, int] = {}
        self._hash_of: dict[int, int] = {}        # block id -> content hash
        self._by_hash: dict[int, int] = {}        # content hash -> block id
        self._cached_lru: "OrderedDict[int, None]" = OrderedDict()  # bid -> None

    # ---- capacity ------------------------------------------------------

    @property
    def reusable_blocks(self) -> int:
        return len(self._free) + len(self._cached_lru)

    @property
    def used_fraction(self) -> float:
        usable = self.n_blocks - 1
        active = sum(1 for c in self._ref.values() if c > 0)
        return active / usable if usable else 0.0

    @property
    def cached_block_count(self) -> int:
        return len(self._cached_lru)

    def cached_hashes(self) -> list[int]:
        """All content-addressed block hashes (active + parked reusable)."""
        return list(self._by_hash.keys())

    # ---- prefix matching ----------------------------------------------

    def match_prefix(self, hashes: list[int]) -> list[int]:
        """Longest consecutive run of cached blocks for this hash chain
        (no refcount change; pair with acquire_cached)."""
        out = []
        for h in hashes:
            bid = self._by_hash.get(h)
            if bid is None:
                break
            out.append(bid)
        return out

    def acquire_cached(self, bids: list[int]) -> None:
        for bid in bids:
            self._ref[bid] = self._ref.get(bid, 0) + 1
            self._cached_lru.pop(bid, None)

    # ---- alloc / release ----------------------------------------------

    def alloc(self, n: int) -> list[int]:
        """Allocate n blocks, evicting parked cached blocks LRU-first when the
        free list is short. Returns block ids; evicted content hashes are
        collected in self.last_evicted_hashes for cache-event publication."""
        self.last_evicted_hashes: list[int] = []
        if n > self.reusable_blocks:
            raise OutOfBlocks(f"need {n} blocks, have {self.reusable_blocks}")
        out = []
        for _ in range(n):
            if self._free:
                bid = self._free.pop()
            else:
                bid, _ = self._cached_lru.popitem(last=False)  # LRU eviction
                h = self._hash_of.pop(bid, None)
                if h is not None:
                    self._by_hash.pop(h, None)
                    self.last_evicted_hashes.append(h)
            self._ref[bid] = 1
            out.append(bid)
        return out

    def commit_hashes(self, bids: list[int], hashes: list[int]) -> None:
        """Content-address freshly prefilled complete blocks."""
        for bid, h in zip(bids, hashes):
            prev = self._by_hash.get(h)
            if prev is not None and prev != bid:
                continue  # already cached elsewhere; keep the existing mapping
            self._hash_of[bid] = h
            self._by_hash[h] = bid

    def release(self, bids: list[int]) -> None:
        """Drop one reference; unreferenced blocks park (if hash-committed)
        or free."""
        for bid in bids:
            if bid == self.TRASH:
                raise ValueError("attempt to release trash block 0")
            c = self._ref.get(bid, 0) - 1
            if c > 0:
                self._ref[bid] = c
                continue
            self._ref.pop(bid, None)
            if bid in self._hash_of:
                self._cached_lru[bid] = None
                self._cached_lru.move_to_end(bid)
            else:
                self._free.append(bid)

    # Legacy API parity: free == release (used by abort paths).
    def free(self, blocks: list[int]) -> None:
        self.release(blocks)
