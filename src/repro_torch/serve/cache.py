"""Paged KV-cache geometry and the host-side block allocator — the
port's copy of ``repro/serve/cache.py`` (numpy and the standard library
only, so it is copied, not imported).

The serving runtime stores full-attention KV in a POOL of fixed-size
blocks shared by every layer: physical block ``b`` of layer L lives at
``pool_L[b]`` and one per-sequence BLOCK TABLE (``(width, blocks_per_seq)``
int32, shared across layers) maps a sequence's logical block index to the
physical id.  Memory then scales with LIVE tokens (allocated blocks)
instead of ``width × max_seq_len``, and a retired sequence's blocks return
to the free list for reuse.  Sliding-window layers keep their (already
bounded) per-lane ring buffers; ``kv_cache="dense"`` swaps the pool for
per-lane dense buffers of the SAME padded context width — the
oracle the paged path is pinned against bit-for-bit
(``tests/test_torch_serve.py``).

Physical block 0 is the TRASH block: never allocated, the write target of
dead decode lanes and padded prefill positions, and never reachable
through a block table (0 doubles as the table's "unallocated" marker), so
garbage writes are invisible by construction.

Allocation is lazy (a block is grabbed only when the sequence's length
first crosses into it) but admission is conservative: the scheduler
reserves a sequence's worst-case block count up front and admits only
when the reservation fits, so a running sequence can never hit an empty
pool mid-decode (the admission rule of ``serve/engine.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class Geometry:
    """Static shape bundle of the serving programs (hashable, so the
    programs of one (config, geometry) are built once)."""

    width: int                 # decode batch lanes
    block_size: int
    blocks_per_seq: int        # block-table width per lane
    num_blocks: int            # pool size INCLUDING the trash block 0
    kv_cache: str              # "paged" | "dense"

    def __post_init__(self):
        if self.kv_cache not in ("paged", "dense"):
            raise ValueError(f"kv_cache: unknown mode {self.kv_cache!r}")
        if self.width < 1 or self.block_size < 1 or self.blocks_per_seq < 1:
            raise ValueError("Geometry: width/block_size/blocks_per_seq "
                             "must be positive")
        if self.kv_cache == "paged" and self.num_blocks < 2:
            raise ValueError("Geometry: paged pool needs >= 2 blocks "
                             "(block 0 is the reserved trash block)")

    @property
    def context(self) -> int:
        """Padded per-sequence context width (= max servable seq len)."""
        return self.blocks_per_seq * self.block_size

    def blocks_for(self, total_len: int) -> int:
        """Blocks covering positions [0, total_len - 1); the LAST generated
        token's KV is never written, hence the -1."""
        last_written = max(total_len - 2, 0)
        return last_written // self.block_size + 1


class BlockAllocator:
    """Deterministic free-list allocator over physical ids 1..num_blocks-1.

    LIFO reuse (the most recently freed block is handed out first) keeps
    reuse observable in tests and maximizes page-locality.  Reservations
    implement the conservative admission rule: ``reserve(lane, n)`` holds
    n blocks for that lane, each ``alloc(lane)`` consumes one, and
    ``release(lane, ids)`` returns the allocated ids plus any unused
    reservation.  ``available()`` is what admission checks.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._reserved: Dict[int, int] = {}
        # stats (engine telemetry / tests)
        self.alloc_count = 0
        self.reuse_count = 0
        self._ever: set = set()

    def available(self) -> int:
        return len(self._free) - sum(self._reserved.values())

    def reserve(self, lane: int, n: int) -> None:
        if n > self.available():
            raise RuntimeError(
                f"reserve({n}) exceeds available blocks ({self.available()})")
        self._reserved[lane] = self._reserved.get(lane, 0) + n

    def alloc(self, lane: int) -> int:
        if self._reserved.get(lane, 0) <= 0:
            raise RuntimeError(f"lane {lane}: alloc without reservation")
        if not self._free:
            raise RuntimeError("block pool exhausted despite reservation "
                               "(allocator invariant broken)")
        self._reserved[lane] -= 1
        blk = self._free.pop()
        self.alloc_count += 1
        if blk in self._ever:
            self.reuse_count += 1
        self._ever.add(blk)
        return blk

    def release(self, lane: int, ids) -> None:
        """Free a retired lane's allocated blocks + drop its reservation."""
        self._reserved.pop(lane, None)
        for blk in ids:
            if not 0 < blk < self.num_blocks:
                raise ValueError(f"release: bad block id {blk}")
            self._free.append(int(blk))

    @property
    def in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)
