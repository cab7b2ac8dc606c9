"""Paged KV cache: a BlockPool of fixed-size token blocks and block tables
(the port's copy of deeplearning4j_tpu/decode/paged.py:37-126).

  pool   [num_blocks, block_size, H, Dh]   one allocation per layer, shared
                                           by all slots
  table  [slots, capacity//block_size] i32 logical block j of slot s lives
                                           in pool block table[s, j]

Token t of a slot lives at (table[s, t // block_size], t % block_size);
the decode kernel `kernels.flash_decode_paged` reads K/V through the table.
Block 0 is a SCRATCH block: unallocated table entries and the pad chunks
of a prefill bucket point there, so writes past a slot's blocks land where
nobody reads (every read is masked by the slot's length).

Everything here is host-side numpy, owned by the scheduler's loop thread:
`BlockPool` hands out physical block ids, the scheduler writes table rows,
and admission may oversubscribe the pool, preempting the youngest slot when
growth finds it dry (see DecodeScheduler).
"""
from __future__ import annotations

import numpy as np


class PoolExhausted(RuntimeError):
    """Allocation failed: fewer free blocks than requested. The scheduler
    answers by preempting the youngest slot, never by failing the
    request."""


def blocks_for(n_tokens, block_size):
    """Physical blocks needed to hold n_tokens."""
    return -(-int(n_tokens) // int(block_size))


class BlockPool:
    """Host-side free-list allocator over the pool's physical blocks.

    Block 0 is never handed out (the scratch block). Allocation is
    all-or-nothing; `defrag()` re-sorts the free list so later allocations
    prefer low block ids."""

    def __init__(self, num_blocks, block_size):
        num_blocks = int(num_blocks)
        block_size = int(block_size)
        if block_size < 1 or (block_size & (block_size - 1)):
            raise ValueError(f"block_size must be a power of two, got "
                             f"{block_size}")
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # pop() takes from the tail: descending order -> lowest id first
        self._free = list(range(num_blocks - 1, 0, -1))
        self.high_water = 0          # most blocks ever held at once

    @property
    def capacity_blocks(self):
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        return self.capacity_blocks - len(self._free)

    def utilization(self):
        """Allocated fraction of the allocatable pool."""
        return self.used_blocks / max(self.capacity_blocks, 1)

    def alloc(self, n):
        """n physical block ids, or PoolExhausted with the pool untouched."""
        n = int(n)
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool {self.capacity_blocks})")
        out = [self._free.pop() for _ in range(n)]
        self.high_water = max(self.high_water, self.used_blocks)
        return out

    def free(self, blocks):
        """Return blocks to the pool (double-free and scratch are errors)."""
        for b in blocks:
            b = int(b)
            if b <= 0 or b >= self.num_blocks:
                raise ValueError(f"block {b} is not allocatable")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)

    def defrag(self):
        """Re-sort the free list so the next allocations take the lowest
        block ids."""
        self._free.sort(reverse=True)

    def reset(self):
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self.high_water = 0


def make_table(slots, max_blocks):
    """All-scratch block table [slots, max_blocks] int32 (logical block j
    of slot s -> physical block table[s, j]; 0 = unallocated/scratch)."""
    return np.zeros((int(slots), int(max_blocks)), np.int32)
