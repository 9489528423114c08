"""Ragged batching state (counterpart of ``deepspeed_tpu/inference/v2/ragged.py``).

`BlockedAllocator`, `DSSequenceDescriptor` and `DSStateManager`: host-side
bookkeeping only; device state is the engine's cache. One free list hands
out cache slots (rows of the block table, or dense rows in the slot
layout), a second hands out physical KV blocks in the paged layout, so a
sequence pins ceil(len / block_size) blocks instead of a max_seq_len row.
A manager made without `num_blocks` (the slot layout) owns no blocks. Pure
Python, the same behaviour as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class BlockedAllocator:
    """Free-list allocator."""

    def __init__(self, num_blocks: int):
        self._num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))

    @property
    def num_blocks(self) -> int:
        return self._num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, num_blocks: int = 1) -> List[int]:
        if num_blocks > len(self._free):
            raise RuntimeError(
                f"cannot allocate {num_blocks} blocks ({len(self._free)} free)")
        out, self._free = self._free[:num_blocks], self._free[num_blocks:]
        return out

    def free(self, blocks) -> None:
        if isinstance(blocks, int):
            blocks = [blocks]
        for b in blocks:
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)


@dataclasses.dataclass
class DSSequenceDescriptor:
    """Per-sequence tracking."""
    uid: int
    slot: int                       # cache row (dense row / block-table row)
    seen_tokens: int = 0            # tokens already in the KV cache
    tokens: List[int] = dataclasses.field(default_factory=list)
    # tokens accepted but not yet in the cache: a non-empty list means the
    # sequence is mid-prefill and its next work unit is a chunk
    pending: List[int] = dataclasses.field(default_factory=list)
    # physical KV blocks owned (paged layout; empty in the slot layout)
    blocks: List[int] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.blocks) if self.blocks else 1


class DSStateManager:
    """Live sequences ↔ cache slots, plus their physical KV blocks."""

    def __init__(self, max_tracked_sequences: int,
                 num_blocks: Optional[int] = None,
                 block_size: Optional[int] = None):
        self.allocator = BlockedAllocator(max_tracked_sequences)
        self.block_allocator = (BlockedAllocator(num_blocks)
                                if num_blocks is not None else None)
        self.block_size = block_size
        self._seqs: Dict[int, DSSequenceDescriptor] = {}

    def blocks_for(self, n_tokens: int) -> int:
        assert self.block_size
        return -(-n_tokens // self.block_size)

    def ensure_blocks(self, seq: DSSequenceDescriptor,
                      total_tokens: int) -> List[int]:
        """Grow `seq`'s block ownership to cover `total_tokens`; returns the
        newly allocated physical block ids."""
        if self.block_allocator is None:
            return []
        need = self.blocks_for(total_tokens) - len(seq.blocks)
        if need <= 0:
            return []
        fresh = self.block_allocator.allocate(need)
        seq.blocks.extend(fresh)
        return fresh

    @property
    def tracked_sequences(self) -> Dict[int, DSSequenceDescriptor]:
        return self._seqs

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    def known_sequence(self, uid: int) -> bool:
        return uid in self._seqs

    def get_sequence(self, uid: int) -> DSSequenceDescriptor:
        return self._seqs[uid]

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        if uid in self._seqs:
            return self._seqs[uid]
        slot = self.allocator.allocate(1)[0]
        seq = DSSequenceDescriptor(uid=uid, slot=slot)
        self._seqs[uid] = seq
        return seq

    def flush_sequence(self, uid: int) -> None:
        seq = self._seqs.pop(uid)
        self.allocator.free(seq.slot)
        if seq.blocks:
            self.block_allocator.free(seq.blocks)
            seq.blocks = []
