"""Block-sparsity layouts (counterpart of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``).

A layout is a (num_heads, nq_blocks, nk_blocks) bool array marking which KV
blocks each query block attends. The port keeps its own copy of the JAX
package's numpy construction (it imports nothing of that package): local
windows, global and summary blocks, random blocks drawn from
`np.random.default_rng(seed)`, so the same config gives the same layout,
bit for bit.
"""

from __future__ import annotations

import numpy as np


class SparsityConfig:
    def __init__(self, num_heads: int, block: int = 64,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} % block {self.block} != 0")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), bool)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Reference `FixedSparsityConfig`: local blocks + periodic global
    summary blocks (the last block of each local window attends/is attended
    globally)."""

    def __init__(self, num_heads: int, block: int = 64,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 different_layout_per_head: bool = False, **kw):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        L = self.num_local_blocks
        for i in range(n):
            w = i // L
            layout[:, i, w * L:(w + 1) * L] = True        # local window
        for w in range(0, n, L):                           # global blocks:
            g0 = max(0, w + L - self.num_global_blocks)    # window tail
            layout[:, :, g0:w + L] = True
        if self.attention == "unidirectional":
            tri = np.tril(np.ones((n, n), bool))
            layout &= tri[None]
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + designated global blocks (reference BSLongformer)."""

    def __init__(self, num_heads: int, block: int = 64,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices=(0,), attention: str = "bidirectional",
                 **kw):
        super().__init__(num_heads, block)
        self.window = num_sliding_window_blocks
        self.global_blocks = tuple(global_block_indices)
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        half = self.window // 2
        for i in range(n):
            layout[:, i, max(0, i - half):min(n, i + half + 1)] = True
        for g in self.global_blocks:
            if g < n:
                layout[:, :, g] = True
                layout[:, g, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), bool))[None]
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global blocks (reference BigBird)."""

    def __init__(self, num_heads: int, block: int = 64,
                 num_random_blocks: int = 1, num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, attention: str = "bidirectional",
                 seed: int = 0, **kw):
        super().__init__(num_heads, block)
        self.num_random = num_random_blocks
        self.window = num_sliding_window_blocks
        self.num_global = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        half = self.window // 2
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads):
            for i in range(n):
                layout[h, i, max(0, i - half):min(n, i + half + 1)] = True
                picks = rng.choice(n, size=min(self.num_random, n), replace=False)
                layout[h, i, picks] = True
        g = self.num_global
        layout[:, :, :g] = True
        layout[:, :g, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), bool))[None]
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Reference `VariableSparsityConfig`: per-window VARIABLE local block
    sizes (`local_window_blocks`, last entry repeating for the remainder),
    designated global block indices (optionally ranges via
    `global_block_end_indices`), optional random blocks per row, and
    optional horizontal global attention (global blocks attend everything,
    not just everything attending them)."""

    def __init__(self, num_heads: int, block: int = 64,
                 num_random_blocks: int = 0,
                 local_window_blocks=(4,),
                 global_block_indices=(0,),
                 global_block_end_indices=None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0, **kw):
        super().__init__(num_heads, block)
        self.num_random = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices)
            if global_block_end_indices is not None else None)
        if self.global_block_end_indices is not None and \
                len(self.global_block_end_indices) != \
                len(self.global_block_indices):
            raise ValueError("global_block_end_indices must pair 1:1 with "
                             "global_block_indices")
        self.attention = attention
        self.horizontal_global = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        # variable local windows: consume sizes, last one repeats
        start = 0
        wi = 0
        while start < n:
            size = self.local_window_blocks[
                min(wi, len(self.local_window_blocks) - 1)]
            end = min(n, start + size)
            layout[:, start:end, start:end] = True
            start, wi = end, wi + 1
        # global blocks (single indices or [start, end) ranges)
        for j, g in enumerate(self.global_block_indices):
            if g >= n:
                continue
            e = g + 1 if self.global_block_end_indices is None \
                else min(n, self.global_block_end_indices[j])
            layout[:, :, g:e] = True                 # everyone attends them
            if self.horizontal_global:
                layout[:, g:e, :] = True             # they attend everyone
        if self.num_random:
            rng = np.random.default_rng(self.seed)
            for h in range(self.num_heads):
                for i in range(n):
                    picks = rng.choice(n, size=min(self.num_random, n),
                                       replace=False)
                    layout[h, i, picks] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), bool))[None]
        return layout


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Reference `LocalSlidingWindowSparsityConfig`: plain sliding window
    (no globals) — the cheapest long-sequence layout."""

    def __init__(self, num_heads: int, block: int = 64,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional", **kw):
        super().__init__(num_heads, block)
        self.window = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        half = self.window // 2
        for i in range(n):
            if self.attention == "unidirectional":
                layout[:, i, max(0, i - self.window + 1):i + 1] = True
            else:
                layout[:, i, max(0, i - half):min(n, i + half + 1)] = True
        return layout
