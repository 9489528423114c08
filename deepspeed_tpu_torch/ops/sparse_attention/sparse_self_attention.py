"""Block-sparse self-attention (counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

`sparse_attention(q, k, v, layout, block, causal, softmax_scale, impl)`
attends each query block of q/k/v (B, S, H, D) to the KV blocks its layout
row (H, S/block, S/block) marks. Two routes, as in the JAX package:

* `impl="reference"`, the gather path and the plain version: each query
  block's live KV blocks are gathered into a padded (Kmax, block, D)
  buffer, the padded and causally masked keys are masked, and softmax runs
  over the rest in f32. Differentiable by autograd.
* `impl="auto"`: `BlockSparseAttention`, whose forward is K7
  (`ops/cuda/block_sparse_attention.py`: the kernel for CUDA tensors, its
  plain version for CPU tensors) and whose backward recomputes the gather
  path under autograd, as the JAX `custom_vjp` does (the JAX package has no
  backward kernel for K7 either). On CUDA it runs for every shape the
  kernel takes (bf16, block in {32, 64, 128}, D in {64, 128}) and raises
  on any other; the JAX rule "block >= 64 and D >= 128" is a TPU tile
  limit, not the function's.

A layout's padded indices (idx, nlive, and the valid mask of the gather
path) go to a device once: they are cached per (layout digest, device) in a
small LRU, as the JAX package caches its kernel per layout digest.
`SparseSelfAttention` keeps one layout per sequence length.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
    _scale,
    block_sparse_attention,
    padded_layout_indices,
)

IMPLS = ("auto", "reference")
_LAYOUT_CACHE: "OrderedDict" = OrderedDict()
_LAYOUT_CACHE_SIZE = 32


def layout_tensors(layout: np.ndarray, device):
    """(idx, nlive, valid) of `layout` on `device`: idx (H, n, Kmax) and
    nlive (H, n) int32, valid (H, n, Kmax) bool. Uploaded once per layout
    and device; a hit refreshes the entry."""
    layout = np.asarray(layout, bool)
    device = torch.device(device)
    key = (hashlib.sha1(layout.tobytes()).hexdigest(), layout.shape, str(device))
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        _LAYOUT_CACHE.move_to_end(key)
        return hit
    idx, nlive = padded_layout_indices(layout)
    valid = np.arange(idx.shape[-1])[None, None, :] < nlive[..., None]
    entry = tuple(torch.from_numpy(a).to(device) for a in (idx, nlive, valid))
    if len(_LAYOUT_CACHE) >= _LAYOUT_CACHE_SIZE:
        _LAYOUT_CACHE.popitem(last=False)
    _LAYOUT_CACHE[key] = entry
    return entry


def gather_attention(q, k, v, idx, valid, block: int, causal: bool, scale: float):
    """The gather path: every (batch, head, query block) at once over its
    gathered (Kmax, block) keys. Returns (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    n = s // block
    kmax = idx.shape[-1]
    idx = idx.long()
    qb = q.transpose(1, 2).reshape(b, h, n, block, d)
    kb = k.transpose(1, 2).reshape(b, h, n, block, d)
    vb = v.transpose(1, 2).reshape(b, h, n, block, d)
    heads = torch.arange(h, device=q.device)[:, None, None]
    kg, vg = kb[:, heads, idx], vb[:, heads, idx]          # (B, H, nq, Kmax, blk, D)
    logits = torch.einsum("bhnqd,bhnkmd->bhnqkm", qb.float(), kg.float()) * scale
    mask = valid[None, :, :, None, :, None]
    if causal:
        offs = torch.arange(block, device=q.device)
        qpos = torch.arange(n, device=q.device)[:, None] * block + offs       # (nq, blk)
        kpos = idx[..., None] * block + offs                                  # (H, nq, Kmax, blk)
        mask = mask & (qpos[None, :, :, None, None] >= kpos[:, :, None, :, :])[None]
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits.reshape(b, h, n, block, kmax * block), dim=-1)
    probs = probs.nan_to_num(0.0).reshape(logits.shape)    # no live key: zeros
    ctx = torch.einsum("bhnqkm,bhnkmd->bhnqd", probs.to(vg.dtype), vg)
    return ctx.reshape(b, h, s, d).transpose(1, 2).to(q.dtype)


class BlockSparseAttention(torch.autograd.Function):
    """Forward: K7. Backward: the gather path's gradient, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, idx, nlive, valid, block, causal, scale):
        ctx.save_for_backward(q, k, v, idx, valid)
        ctx.block, ctx.causal, ctx.scale = block, causal, scale
        return block_sparse_attention(q, k, v, idx, nlive, block, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, idx, valid = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
            out = gather_attention(*inputs, idx, valid, ctx.block, ctx.causal, ctx.scale)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None, None, None, None)


def sparse_attention(q, k, v, layout: np.ndarray, block: int = 64, causal: bool = False,
                     softmax_scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """q/k/v (B, S, H, D); layout (H, S/block, S/block) bool. Returns
    (B, S, H, D). `impl="reference"` takes the gather path; `"auto"` takes
    K7 with the gather path's gradient (module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"sparse_attention: impl {impl!r} not in {IMPLS}")
    b, s, h, d = q.shape
    if s % block:
        raise ValueError(f"sparse_attention: S={s} is not a multiple of block {block}")
    n = s // block
    if tuple(layout.shape) != (h, n, n):
        raise ValueError(f"sparse_attention: layout {tuple(layout.shape)} != {(h, n, n)}")
    scale = _scale(d, softmax_scale)
    idx, nlive, valid = layout_tensors(layout, q.device)
    if impl == "reference":
        return gather_attention(q, k, v, idx, valid, block, causal, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return BlockSparseAttention.apply(q, k, v, idx, nlive, valid, block, causal, scale)
    return block_sparse_attention(q, k, v, idx, nlive, block, causal, scale)


class SparseSelfAttention(nn.Module):
    """The reference's `SparseSelfAttention` surface: `forward(q, k, v,
    causal)` over the layout `sparsity_config.make_layout(S)`, built once
    per sequence length. `attn_mask_mode` is accepted and unused, as in the
    JAX package."""

    def __init__(self, sparsity_config, softmax_scale: Optional[float] = None,
                 attn_mask_mode: str = "mul"):
        super().__init__()
        self.config = sparsity_config
        self.softmax_scale = softmax_scale
        self._layouts = {}

    def forward(self, q, k, v, causal: bool = False):
        s = q.shape[1]
        if s not in self._layouts:
            self._layouts[s] = self.config.make_layout(s)
        return sparse_attention(q, k, v, self._layouts[s], block=self.config.block,
                                causal=causal, softmax_scale=self.softmax_scale)
