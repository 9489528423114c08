"""Weight quantization of parameter trees (counterpart of ``deepspeed_tpu/inference/quantization.py``).

A parameter tree here is the JAX package's: nested dicts whose leaves are
tensors, with flax `Dense` kernels in their (in, out) layout. A quantized
leaf keeps the JAX package's shape, the dict `{"__q8__": int8, "scales":
f32}` (flat blockwise scales, or per-layer (L, nblocks) scales for a
layer-stacked leaf). `tree_map` walks such a tree and treats a quantized
leaf as one leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch

from deepspeed_tpu_torch.ops.quantization import (
    dequantize_int8_blockwise,
    quantize_int8_blockwise,
)


def is_quantized_leaf(x) -> bool:
    return isinstance(x, dict) and "__q8__" in x


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` over every leaf of nested dicts, a quantized leaf counting as
    one."""
    if isinstance(tree, dict) and not is_quantized_leaf(tree):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict) and not is_quantized_leaf(tree):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def _floating(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def quantize_param_tree(params: Any, group_size: int = 256,
                        min_size: int = 4096) -> Tuple[Any, Any]:
    """params → (int8/scale tree, None). Leaves below 2-D or `min_size`
    elements (norms, biases) stay as they are; quantized leaves pass
    through."""
    def q(leaf):
        if is_quantized_leaf(leaf):
            return leaf
        if _floating(leaf) and leaf.dim() >= 2 and leaf.numel() >= min_size:
            qv, s = quantize_int8_blockwise(leaf, group_size)
            return {"__q8__": qv, "scales": s}
        return leaf

    return tree_map(q, params), None


def dequantize_param_tree(qparams: Any, dtype=None) -> Any:
    """Every quantized leaf back to `dtype` (f32 by default); a leaf with
    per-layer (L, nblocks) scales dequantizes layer by layer."""
    dtype = dtype or torch.float32

    def dq(leaf):
        if not is_quantized_leaf(leaf):
            return leaf
        q, s = leaf["__q8__"], leaf["scales"]
        if s.dim() == 2:
            return torch.stack([dequantize_int8_blockwise(q[i], s[i], dtype)
                                for i in range(q.shape[0])])
        return dequantize_int8_blockwise(q, s, dtype)

    return tree_map(dq, qparams)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def quantized_memory_bytes(qparams: Any) -> int:
    total = 0
    for leaf in tree_leaves(qparams):
        if is_quantized_leaf(leaf):
            total += _nbytes(leaf["__q8__"]) + _nbytes(leaf["scales"])
        else:
            total += _nbytes(leaf)
    return total
