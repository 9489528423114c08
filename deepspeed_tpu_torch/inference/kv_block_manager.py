"""KV block manager: refcounted physical blocks, prefix sharing, copy-on-write
(counterpart of ``deepspeed_tpu/inference/kv_block_manager.py``).

- Refcounts: a physical block may back several sequences' table entries.
  `allocate` hands out refcount-1 blocks; `free` decrements and only a
  0-count block returns to the free list. The API is a superset of
  `v2.ragged.BlockedAllocator`, so `DSStateManager` uses it unchanged.
- Prefix registry: full, committed blocks register under a chained hash
  h_i = hash((h_{i-1}, block_tokens)), so one probe per block is
  position-safe. Only full blocks are shared, so a matched sequence's cursor
  lands on a block boundary. A freed block keeps its entry until it is
  reallocated.
- Copy-on-write: `fork` shares every block of a parent, the partial tail
  included. The first write into a refcount>1 block calls `cow`, which
  allocates a fresh block and queues the (src, dst) pool copy for the
  engine's next table sync.

- Accounting: `KVBudget` says how many sequences' KV fit beside the
  resident bytes, at the configured KV dtype.

Host-side bookkeeping only. The JAX package's memory-plane telemetry hook
(`plane_wire`) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


class KVBlockManager:
    """Refcounted block allocator with a prefix registry and COW queue."""

    def __init__(self, num_blocks: int, block_size: int):
        self._num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks))
        self._refs: List[int] = [0] * num_blocks
        # chain hash → physical block, and the reverse map
        self._prefix: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}
        self._pending_copies: List[Tuple[int, int]] = []
        self.cow_copies = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0

    # ------------------------------------------------ BlockedAllocator API
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
        for b in out:
            self._refs[b] = 1
            self._invalidate(b)  # content is about to change
        return out

    def free(self, blocks) -> None:
        if isinstance(blocks, int):
            blocks = [blocks]
        for b in blocks:
            if self._refs[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                # the registry entry survives until reallocation; appended,
                # so a flushed shared prompt stays matchable the longest
                self._free.append(b)

    # --------------------------------------------------------- refcounting
    def refcount(self, block: int) -> int:
        return self._refs[block]

    def share(self, blocks: Sequence[int]) -> None:
        """Bump refcounts (fork: the child holds every parent block)."""
        for b in blocks:
            if self._refs[b] <= 0:
                raise ValueError(f"cannot share unowned block {b}")
            self._refs[b] += 1

    @property
    def shared_blocks(self) -> int:
        """Physical blocks currently referenced by more than one sequence."""
        return sum(1 for r in self._refs if r > 1)

    # ----------------------------------------------------- prefix registry
    @staticmethod
    def _chain(prev: int, chunk: Sequence[int]) -> int:
        return hash((prev, tuple(chunk)))

    def _invalidate(self, block: int) -> None:
        h = self._block_hash.pop(block, None)
        if h is not None and self._prefix.get(h) == block:
            del self._prefix[h]

    def commit_prefix(self, tokens: Sequence[int],
                      blocks: Sequence[int]) -> None:
        """Register `blocks` (physical ids, in logical order) as holding the
        full blocks of `tokens`; a partial tail stays private. Idempotent;
        the same content under another block keeps the first."""
        bs = self.block_size
        n_full = min(len(tokens) // bs, len(blocks))
        h = 0
        for i in range(n_full):
            h = self._chain(h, tokens[i * bs:(i + 1) * bs])
            b = blocks[i]
            if self._prefix.get(h) == b or h in self._prefix:
                continue
            self._invalidate(b)
            self._prefix[h] = b
            self._block_hash[b] = h

    def match_prefix(self, tokens: Sequence[int],
                     max_tokens: Optional[int] = None) -> Tuple[int, List[int]]:
        """Longest registered prefix of `tokens` in whole blocks →
        (n_tokens_matched, physical blocks with their refcounts bumped).
        `max_tokens` caps the match; blocks on the free list are reclaimed."""
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        matched: List[int] = []
        h = 0
        for i in range(limit // bs):
            h = self._chain(h, tokens[i * bs:(i + 1) * bs])
            b = self._prefix.get(h)
            if b is None:
                break
            matched.append(b)
        for b in matched:
            if self._refs[b] == 0:
                self._free.remove(b)
                self._refs[b] = 1
            else:
                self._refs[b] += 1
        if matched:
            self.prefix_hits += 1
            self.prefix_tokens_reused += len(matched) * bs
        return len(matched) * bs, matched

    # ------------------------------------------------------- copy-on-write
    def cow(self, block: int) -> int:
        """Allocate a private copy target for a shared `block`, drop the
        writer's reference to the original and queue the (src, dst) copy.
        Returns the new physical block id."""
        if self._refs[block] <= 1:
            raise ValueError(
                f"cow on block {block} with refcount {self._refs[block]} — "
                "an exclusively-owned block is written in place")
        dst = self.allocate(1)[0]
        self._refs[block] -= 1
        self._pending_copies.append((block, dst))
        self.cow_copies += 1
        return dst

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Take the queued (src, dst) copies."""
        out, self._pending_copies = self._pending_copies, []
        return out

    @property
    def has_pending_copies(self) -> bool:
        return bool(self._pending_copies)


@dataclasses.dataclass(frozen=True)
class KVBudget:
    """How many sequences fit: max_batch = floor(available / per_seq_kv_bytes)
    with available = hbm_bytes − resident_bytes (weights + workspace) and
    per_seq_kv_bytes the KV cache of one sequence at the configured dtype."""
    hbm_bytes: int
    resident_bytes: int
    per_seq_kv_bytes: int
    kv_dtype: str
    max_batch: int

    @property
    def available_bytes(self) -> int:
        return max(self.hbm_bytes - self.resident_bytes, 0)


def kv_budget(*, hbm_bytes: int, resident_bytes: int, per_seq_kv_bytes: int,
              kv_dtype: str = "bf16") -> KVBudget:
    avail = max(hbm_bytes - resident_bytes, 0)
    return KVBudget(hbm_bytes=hbm_bytes, resident_bytes=resident_bytes,
                    per_seq_kv_bytes=per_seq_kv_bytes, kv_dtype=kv_dtype,
                    max_batch=avail // max(per_seq_kv_bytes, 1))


def model_kv_budget(model_cfg, *, hbm_bytes: int, resident_bytes: int,
                    max_len: int, dtype, kv_dtype: Optional[str] = None) -> KVBudget:
    """`kv_budget` with the per-sequence bytes from the model config, by the
    `capacity_scan.kv_cache_bytes` formula `choose_serve_mode` reads."""
    from deepspeed_tpu_torch.inference.capacity_scan import kv_cache_bytes
    per_seq = kv_cache_bytes(model_cfg, 1, max_len, dtype, kv_dtype=kv_dtype)
    return kv_budget(hbm_bytes=hbm_bytes, resident_bytes=resident_bytes,
                     per_seq_kv_bytes=per_seq, kv_dtype=kv_dtype or "dense")
