"""Dense static-shape KV cache (counterpart of ``deepspeed_tpu/inference/kv_cache.py``).

Layout: (num_layers, batch, max_len, kv_heads, head_dim) with per-row
cursors `index` (B,): row b holds `index[b]` valid tokens. Validity is a
position mask (`decode_mask`), not a dynamic length.

Unlike the JAX package, whose arrays are immutable, `update_layer` writes
into the cache in place: the tensors a `KVCache` holds are the cache, and a
forward through it changes them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class KVCache:
    """Stacked per-layer K/V plus per-sequence cursors."""

    k: torch.Tensor      # (L, B, M, Hkv, D)
    v: torch.Tensor      # (L, B, M, Hkv, D)
    index: torch.Tensor  # (B,) int32

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @classmethod
    def create(cls, num_layers: int, batch: int, max_len: int, kv_heads: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> "KVCache":
        shape = (num_layers, batch, max_len, kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   index=torch.zeros((batch,), dtype=torch.int32, device=device))

    def replace(self, **changes) -> "KVCache":
        return dataclasses.replace(self, **changes)

    def truncate(self, index) -> "KVCache":
        """Roll the per-row cursors back to `index` (B,). Everything past a
        cursor is uncommitted by construction: `decode_mask` never lets a
        query attend past its own position, and the next write lands at the
        cursor."""
        return self.replace(index=torch.as_tensor(
            index, dtype=torch.int32, device=self.index.device))


def _drop_write(cache: torch.Tensor, new: torch.Tensor,
                index: torch.Tensor) -> None:
    """cache[b, index[b] + j] = new[b, j], dropping columns at or past
    max_len, in place and with no host sync. Every dropped column is sent to
    the last slot carrying the value that slot ends up with (the new token
    written there, or its old value), so the duplicate writes agree."""
    b, s = new.shape[:2]
    m = cache.shape[1]
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = index.long()[:, None] + torch.arange(s, device=cache.device)[None, :]
    valid = cols < m
    last = m - 1
    j_last = (last - index.long()).clamp(0, s - 1)              # (B,)
    writes_last = (index.long() <= last) & (index.long() + s - 1 >= last)
    keep_last = torch.where(writes_last[:, None, None],
                            new[torch.arange(b, device=cache.device), j_last],
                            cache[:, last])                      # (B, Hkv, D)
    vals = torch.where(valid[:, :, None, None], new,
                       keep_last[:, None].to(new.dtype))
    cache[rows, cols.clamp(max=last)] = vals.to(cache.dtype)


def update_layer(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 index: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert `k_new`/`v_new` (B, S, Hkv, D) at per-row positions `index`
    (B,) of one layer's dense cache (B, M, Hkv, D), in place. Columns at or
    past max_len are dropped, as JAX's `mode="drop"` does. Returns the
    caches."""
    _drop_write(k_cache, k_new, index)
    _drop_write(v_cache, v_new, index)
    return k_cache, v_cache


def decode_mask(q_positions: torch.Tensor, max_len: int,
                window: Optional[int] = None) -> torch.Tensor:
    """Causal validity mask (B, Sq, M) over the full static cache: key slot j
    is attendable iff j <= position of the query token (and, with a sliding
    `window`, j > position − window)."""
    kj = torch.arange(max_len, device=q_positions.device)[None, None, :]
    pos = q_positions[:, :, None]
    keep = kj <= pos
    if window is not None:
        keep = keep & (kj > pos - window)
    return keep
