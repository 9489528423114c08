"""Blockwise int8 quantization (counterpart of ``deepspeed_tpu/ops/quantization.py``).

Symmetric per-block int8 over the flattened tensor: blocks of `block`
consecutive elements share one f32 scale, amax / 127 (1.0 for an all-zero
block), and the values are round(x / scale) clipped to ±127. The operation
order is the JAX package's, so the int8 values and scales are equal to its
bit for bit. The KV cache's int8 form (`quantize_kv_tokens`, the
counterpart of ``deepspeed_tpu/inference/kv_cache.py``'s) keeps one scale
per row of the head dim instead. Only int8 is ported; int4, fp8, fp6 and
fp12 are not (ROADMAP.md, Queue 1, 'Weight quantization and serve modes').
"""

from __future__ import annotations

from typing import Tuple

import torch

_RECIPROCAL_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def quantize_int8_blockwise(x: torch.Tensor, block: int = 256,
                            reciprocal: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 of x's shape, scales f32 (nblocks,)). Where the element count
    is not a multiple of `block`, the block shrinks until it divides it.

    `reciprocal=True` takes the scale as amax · f32(1/127) instead of
    amax / 127: the form XLA compiles the JAX quantizer into under `jit`
    (as `quantize_layer_stacks` runs it), which differs in the last bit
    of some scales."""
    shape = x.shape
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    b = min(block, n)
    while n % b:
        b -= 1
    blocks = flat.reshape(n // b, b)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # divided by a tensor on amax's device: a CUDA kernel turns a division
    # by a Python number into a product with its reciprocal
    scale = amax * _RECIPROCAL_127 if reciprocal else amax / amax.new_tensor(127.0)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.reshape(shape), scale[:, 0]


def dequantize_int8_blockwise(q: torch.Tensor, scales: torch.Tensor,
                              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q × its block's scale in f32, cast to `dtype`."""
    shape = q.shape
    nb = scales.shape[0]
    blocks = q.reshape(nb, -1).float() * scales[:, None]
    return blocks.reshape(shape).to(dtype)


def quantize_kv_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head dim: (..., D) → ((..., D) int8,
    (...) f32 scales), scale = amax / 127 (1.0 for an all-zero row), values
    round(x / scale) clipped to ±127, as the JAX package computes them."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(data: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., D) int8 × (...) f32 → (..., D) in `dtype`: the masked paths'
    dense view of an int8 cache (the kernels fold the scales in instead)."""
    return (data.float() * scales[..., None]).to(dtype)
