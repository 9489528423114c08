"""KV caches (counterpart of ``deepspeed_tpu/inference/kv_cache.py``).

Dense (`KVCache`): (num_layers, batch, max_len, kv_heads, head_dim) with
per-row cursors `index` (B,): row b holds `index[b]` valid tokens. Validity
is a position mask (`decode_mask`), not a dynamic length. The v2 engine's
slot layout serves one row at a time through `row_view` and `merge_row`.

Block-paged (`PagedKVCache`, the v2 engine's layout): per layer a pool of
physical blocks (Hkv, NB, BS, D) and per-row block tables (B, T) that map
logical block j of row b onto a pool block; -1 marks an unowned entry.

Unlike the JAX package, whose arrays are immutable, every write here lands
in place with no host sync: the tensors a cache holds are the cache, and a
forward through it changes them. JAX's `mode="drop"` writes (past a row's
capacity, through a -1 table entry) go to a trash block that sits after the
last layer's pool in the same storage and that no table can name, so the
pools themselves hold exactly what the JAX package's hold.

int8 at rest (`kv_cache_dtype="int8"`): K and V are stored as int8 rows
with one f32 scale per (token slot, kv head), `quantize_kv_tokens` (in
`ops/quantization.py`). A dense cache holds `QuantizedKVLayer`s; a paged
cache holds int8 blocks beside f32 scale blocks of the same layout (trash block included), written by the same
scatters. The staged decode token stays in the compute dtype until
`apply_stage` quantizes it into the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.quantization import dequantize_kv, quantize_kv_tokens


@dataclasses.dataclass
class QuantizedKVLayer:
    """int8-at-rest form of a dense cache tensor (K or V): int8 rows and
    their (..., M, Hkv) f32 scales, with the same leading axes. Indexing
    takes both along the first axis (one layer's view)."""

    data: torch.Tensor    # (..., M, Hkv, D) int8
    scales: torch.Tensor  # (..., M, Hkv) f32

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def __getitem__(self, i) -> "QuantizedKVLayer":
        return QuantizedKVLayer(self.data[i], self.scales[i])


@dataclasses.dataclass
class KVCache:
    """Stacked per-layer K/V plus per-sequence cursors."""

    k: Any               # (L, B, M, Hkv, D), or a QuantizedKVLayer at rest
    v: Any
    index: torch.Tensor  # (B,) int32

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return isinstance(self.k, QuantizedKVLayer)

    @classmethod
    def create(cls, num_layers: int, batch: int, max_len: int, kv_heads: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               quantized: bool = False) -> "KVCache":
        shape = (num_layers, batch, max_len, kv_heads, head_dim)
        if quantized:
            def side():
                return QuantizedKVLayer(
                    data=torch.zeros(shape, dtype=torch.int8, device=device),
                    scales=torch.ones(shape[:-1], dtype=torch.float32, device=device))
            return cls(k=side(), v=side(),
                       index=torch.zeros((batch,), dtype=torch.int32, device=device))
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


def row_view(cache: KVCache, slot: int, start) -> KVCache:
    """Row `slot` of a dense cache as a batch of one at cursor `start` (the
    JAX v2 engine's `_row_view`). Its K and V are views of the cache's, so a
    forward through the row writes the cache in place."""
    start = torch.as_tensor(start, dtype=torch.int32, device=cache.index.device)
    return KVCache(k=cache.k[:, slot:slot + 1], v=cache.v[:, slot:slot + 1],
                   index=start.reshape(1))


def merge_row(cache: KVCache, slot: int, new_index) -> KVCache:
    """Fold a row view's update back (the JAX `_merge_row`): its K/V already
    landed in place, so only row `slot`'s cursor moves to `new_index`."""
    cache.index[slot] = new_index
    return cache


@dataclasses.dataclass
class PagedLayer:
    """One layer's view of a `PagedKVCache`: its pool, the block tables and
    its staged decode token. Every tensor aliases the stacked cache.

    `stage` (B, Hkv, D) or None: with staging on (the v2 engine's decode),
    a single-token `update_layer` writes the new K/V here instead of into
    the pool; attention folds it in, and `PagedKVCache.apply_stage` lands
    every layer's staged token with one scatter per pool. Multi-token writes
    (prefill, chunks) go to the pool.

    `blocks` is the storage behind the pool, (L·Hkv·NB + 1, BS, D): pool
    block (h, n) of this layer is `blocks[base + h·NB + n]`, and the last
    block is the trash block that dropped writes land in.

    `scales` (Hkv, NB, BS) f32, present iff the pool is int8: one scale per
    (kv head, block, slot), a view of `scale_blocks` (L·Hkv·NB + 1, BS),
    which the pool's scatters write row for row. The stage keeps the
    compute dtype."""

    pool: torch.Tensor                    # (Hkv, NB, BS, D)
    tables: torch.Tensor                  # (B, T) int32
    stage: Optional[torch.Tensor] = None  # (B, Hkv, D)
    blocks: Optional[torch.Tensor] = None
    base: int = 0
    # every write cursor is a multiple of BS (a host-side fact the engine
    # knows); None means "look", which syncs on a CUDA tensor
    aligned: Optional[bool] = None
    scales: Optional[torch.Tensor] = None        # (Hkv, NB, BS) f32
    scale_blocks: Optional[torch.Tensor] = None  # (L·Hkv·NB + 1, BS) f32


@dataclasses.dataclass
class PagedKVCache:
    """Block-paged KV cache with one set of (B, T) block tables shared by K,
    V and every layer (the JAX package keeps a broadcast copy per layer and
    side; the values are the same). Duck-typed to `KVCache`: `index`,
    `max_len`, `replace`."""

    k_blocks: torch.Tensor               # (L·Hkv·NB + 1, BS, D)
    v_blocks: torch.Tensor
    tables: torch.Tensor                 # (B, T) int32
    index: torch.Tensor                  # (B,) int32
    k_stage: Optional[torch.Tensor]      # (L, B, Hkv, D) or None
    v_stage: Optional[torch.Tensor]
    num_layers: int
    kv_heads: int
    aligned: Optional[bool] = None
    k_scale_blocks: Optional[torch.Tensor] = None  # (L·Hkv·NB + 1, BS) f32, int8 pools
    v_scale_blocks: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.k_blocks.shape[1]

    @property
    def head_dim(self) -> int:
        return self.k_blocks.shape[2]

    @property
    def num_blocks(self) -> int:
        return (self.k_blocks.shape[0] - 1) // (self.num_layers * self.kv_heads)

    @property
    def max_len(self) -> int:
        """Logical capacity per sequence: T · BS."""
        return self.tables.shape[1] * self.block_size

    @property
    def quantized(self) -> bool:
        return self.k_scale_blocks is not None

    def _pool(self, blocks: torch.Tensor) -> torch.Tensor:
        return blocks[:-1].view(self.num_layers, self.kv_heads, self.num_blocks,
                                self.block_size, *blocks.shape[2:])

    @property
    def k_pool(self) -> torch.Tensor:
        """(L, Hkv, NB, BS, D) view of the K pools."""
        return self._pool(self.k_blocks)

    @property
    def v_pool(self) -> torch.Tensor:
        return self._pool(self.v_blocks)

    @classmethod
    def create(cls, num_layers: int, batch: int, max_len: int, kv_heads: int,
               head_dim: int, num_blocks: int, block_size: int = 256,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               staged: bool = False, quantized: bool = False) -> "PagedKVCache":
        """`quantized` makes the pools int8 with f32 scale blocks (ones);
        the stage keeps `dtype`."""
        t = -(-max_len // block_size)  # logical blocks per sequence
        n = num_layers * kv_heads * num_blocks + 1
        pool_dtype = torch.int8 if quantized else dtype

        def stage():
            return (torch.zeros((num_layers, batch, kv_heads, head_dim),
                                dtype=dtype, device=device) if staged else None)

        def scales():
            return (torch.ones((n, block_size), dtype=torch.float32, device=device)
                    if quantized else None)

        return cls(
            k_blocks=torch.zeros((n, block_size, head_dim), dtype=pool_dtype, device=device),
            v_blocks=torch.zeros((n, block_size, head_dim), dtype=pool_dtype, device=device),
            tables=torch.full((batch, t), -1, dtype=torch.int32, device=device),
            index=torch.zeros((batch,), dtype=torch.int32, device=device),
            k_stage=stage(), v_stage=stage(),
            num_layers=num_layers, kv_heads=kv_heads,
            k_scale_blocks=scales(), v_scale_blocks=scales())

    def replace(self, **changes) -> "PagedKVCache":
        return dataclasses.replace(self, **changes)

    def layer(self, i: int) -> Tuple[PagedLayer, PagedLayer]:
        """Layer i's K and V views."""
        base = i * self.kv_heads * self.num_blocks

        def view(blocks, stage, scale_blocks):
            return PagedLayer(pool=self._pool(blocks)[i], tables=self.tables,
                              stage=None if stage is None else stage[i],
                              blocks=blocks, base=base, aligned=self.aligned,
                              scales=(None if scale_blocks is None
                                      else self._pool(scale_blocks)[i]),
                              scale_blocks=scale_blocks)

        return (view(self.k_blocks, self.k_stage, self.k_scale_blocks),
                view(self.v_blocks, self.v_stage, self.v_scale_blocks))

    def with_tables(self, tables) -> "PagedKVCache":
        """Install new (B, T) block tables, in place."""
        self.tables.copy_(torch.as_tensor(np.asarray(tables, np.int32)))
        return self

    def apply_stage(self) -> "PagedKVCache":
        """Land every layer's staged decode token in the pool with one
        scatter per pool. Call right after a staged single-token model step:
        each staged token belongs at `index[b] − 1` (the model has advanced
        the cursors). Parked rows and unowned entries drop. An int8 pool
        quantizes the staged tokens here, scales in the same rows. No-op
        without staging."""
        if self.k_stage is None:
            return self
        lh, nb, bs = self.num_layers * self.kv_heads, self.num_blocks, self.block_size
        t = self.tables.shape[1]
        dev = self.tables.device
        pos = self.index.long() - 1
        phys = self.tables.long().gather(1, (pos // bs).clamp(0, t - 1)[:, None])[:, 0]
        valid = (pos >= 0) & (pos < t * bs) & (phys >= 0)
        heads = torch.arange(lh, device=dev)[:, None]
        rows = (heads * nb + phys[None]) * bs + (pos % bs)[None]      # (L·Hkv, B)
        rows = torch.where(valid[None], rows, (lh * nb) * bs).reshape(-1)
        for blocks, stage, scale_blocks in (
                (self.k_blocks, self.k_stage, self.k_scale_blocks),
                (self.v_blocks, self.v_stage, self.v_scale_blocks)):
            vals = stage.permute(0, 2, 1, 3).reshape(-1, self.head_dim)  # (L·Hkv·B, D)
            if scale_blocks is not None:
                vals, sc = quantize_kv_tokens(vals)
                scale_blocks.view(-1).index_copy_(0, rows, sc)
            blocks.view(-1, self.head_dim).index_copy_(0, rows, vals.to(blocks.dtype))
        return self


def _trash(layer: PagedLayer) -> int:
    if layer.blocks is None:
        raise ValueError("a PagedLayer written to must be a view of a PagedKVCache")
    return layer.blocks.shape[0] - 1


def _quantized_vals(layer: PagedLayer, vals: torch.Tensor
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`vals` (..., D) in the pool's dtype; for an int8 pool, quantized, with
    their scales returned beside."""
    if layer.scale_blocks is None:
        return vals.to(layer.blocks.dtype), None
    return quantize_kv_tokens(vals)


def _token_scatter(layer: PagedLayer, new: torch.Tensor, index: torch.Tensor) -> None:
    hkv, nb, bs, d = layer.pool.shape
    t = layer.tables.shape[1]
    s = new.shape[1]
    dev = new.device
    pos = index.long()[:, None] + torch.arange(s, device=dev)[None, :]   # (B, S)
    phys = layer.tables.long().gather(1, (pos // bs).clamp(0, t - 1))
    # drop: parked rows (past capacity) and unowned entries (-1)
    valid = (pos < t * bs) & (phys >= 0)
    heads = torch.arange(hkv, device=dev)[:, None, None]
    rows = (layer.base + heads * nb + phys[None]) * bs + (pos % bs)[None]  # (Hkv, B, S)
    rows = torch.where(valid[None], rows, _trash(layer) * bs).reshape(-1)
    vals, sc = _quantized_vals(layer, new.permute(2, 0, 1, 3).reshape(-1, d))
    layer.blocks.view(-1, d).index_copy_(0, rows, vals)
    if sc is not None:
        layer.scale_blocks.view(-1).index_copy_(0, rows, sc)


def _block_scatter(layer: PagedLayer, new: torch.Tensor, index: torch.Tensor) -> None:
    """S == BS and every cursor block-aligned: each row's piece fills one
    block, so whole (BS, D) slabs are written."""
    hkv, nb, bs, d = layer.pool.shape
    t = layer.tables.shape[1]
    idx = index.long()
    phys = layer.tables.long().gather(1, (idx // bs).clamp(0, t - 1)[:, None])[:, 0]
    ok = (idx < t * bs) & (phys >= 0)
    heads = torch.arange(hkv, device=new.device)[:, None]
    blk = torch.where(ok[None], layer.base + heads * nb + phys[None], _trash(layer))
    blk = blk.reshape(-1)
    vals, sc = _quantized_vals(layer, new.permute(2, 0, 1, 3).reshape(-1, bs, d))
    layer.blocks.index_copy_(0, blk, vals)
    if sc is not None:
        layer.scale_blocks.index_copy_(0, blk, sc)


def _update_paged_layer(layer: PagedLayer, new: torch.Tensor,
                        index: torch.Tensor) -> PagedLayer:
    """Write `new` (B, S, Hkv, D) into the pool at each row's logical
    positions index[b]..index[b]+S through its block table, in place.
    Positions past the capacity and unowned entries drop. S == BS with
    every cursor aligned takes the block scatter, else the token scatter;
    both write the same values."""
    bs = layer.pool.shape[2]
    s = new.shape[1]
    aligned = s == bs and (layer.aligned if layer.aligned is not None
                           else bool((index % bs == 0).all()))
    (_block_scatter if aligned else _token_scatter)(layer, new, index)
    return layer


def gather_paged_layer(layer: PagedLayer, dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """The dense logical view (B, T·BS, Hkv, D) of a paged layer, gathered
    by whole blocks; unowned entries (-1) read block 0. An int8 pool is
    dequantized (f32 unless `dtype` says otherwise)."""
    hkv, nb, bs, d = layer.pool.shape
    b, t = layer.tables.shape
    phys = layer.tables.long().clamp(min=0).reshape(-1)
    blocks = layer.pool[:, phys]
    if layer.scales is not None:
        blocks = dequantize_kv(blocks, layer.scales[:, phys], dtype or torch.float32)
    elif dtype is not None:
        blocks = blocks.to(dtype)
    return blocks.reshape(hkv, b, t * bs, d).permute(1, 2, 0, 3)


def _drop_write(cache: torch.Tensor, new: torch.Tensor,
                index: torch.Tensor) -> None:
    """cache[b, index[b] + j] = new[b, j], dropping columns at or past
    max_len, in place and with no host sync. Every dropped column is sent to
    the last slot carrying the value that slot ends up with (the new token
    written there, or its old value), so the duplicate writes agree."""
    b, s = new.shape[:2]
    m = cache.shape[1]
    rest = (1,) * (new.dim() - 2)                               # trailing axes
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = index.long()[:, None] + torch.arange(s, device=cache.device)[None, :]
    valid = cols < m
    last = m - 1
    j_last = (last - index.long()).clamp(0, s - 1)              # (B,)
    writes_last = (index.long() <= last) & (index.long() + s - 1 >= last)
    keep_last = torch.where(writes_last.view(b, *rest),
                            new[torch.arange(b, device=cache.device), j_last],
                            cache[:, last].to(new.dtype))        # (B, ...)
    vals = torch.where(valid.view(b, s, *rest), new, keep_last[:, None])
    cache[rows, cols.clamp(max=last)] = vals.to(cache.dtype)


def update_layer(k_cache, v_cache, k_new: torch.Tensor, v_new: torch.Tensor,
                 index: torch.Tensor) -> Tuple:
    """Insert `k_new`/`v_new` (B, S, Hkv, D) at per-row positions `index`
    (B,) of one layer's cache, in place: dense (B, M, Hkv, D) tensors or
    `PagedLayer` views. Columns at or past the capacity are dropped, as
    JAX's `mode="drop"` does. A single token into a staged paged layer goes
    to the stage only. An int8 cache (`QuantizedKVLayer` or a paged layer
    with scales) stores the tokens quantized. Returns the caches."""
    if isinstance(k_cache, PagedLayer):
        if k_cache.stage is not None and k_new.shape[1] == 1:
            k_cache.stage.copy_(k_new[:, 0])
            v_cache.stage.copy_(v_new[:, 0])
            return k_cache, v_cache
        return (_update_paged_layer(k_cache, k_new, index),
                _update_paged_layer(v_cache, v_new, index))
    if isinstance(k_cache, QuantizedKVLayer):
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            q, sc = quantize_kv_tokens(new)
            _drop_write(cache.data, q, index)
            _drop_write(cache.scales, sc, index)
        return k_cache, v_cache
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
