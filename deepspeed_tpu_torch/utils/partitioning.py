"""Tensor- and expert-parallel weight slicing (counterpart of ``deepspeed_tpu/utils/partitioning.py``).

The JAX package annotates each parameter with logical axes and maps them
onto mesh axes by `DEFAULT_RULES` (Megatron-style: column-parallel
projections shard their output features, row-parallel ones their input
features, the embedding and the head the vocabulary; the MoE expert stacks
their leading `expert` axis); the partitioner then moves the bytes. Here
each rank holds its own slice: `shard_tree` cuts a JAX-layout parameter
tree (numpy or torch leaves) down to one rank's part along the dimension
that the rules map onto the topology's nontrivial axis, `model` or
`expert`; every other leaf is replicated (the same object). The logical
axes are the JAX models' (`models/llama.py` there, and the MoE layer's
`Experts` and `TopKGate`, `moe/layer.py:81-87`, :137), copied here. A cut
over `expert` keeps experts [rank·E/ep, (rank+1)·E/ep) of each stack and
raises where E does not divide, as `sharded_grouped_gemm` does.

A quantized leaf (`{"__q8__", "scales"}`) is sliced with its flat
blockwise scales: the scales regroup onto their blocks' grid over the
weight, the grid is cut with the weight and flattened again, so a rank's
int8 bytes and scales dequantize to exactly the matching slice of the
whole weight. A cut that splits a scale block raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

DEFAULT_RULES: Dict[Optional[str], Optional[str]] = {
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "heads_in": "model",
    "mlp": "model",
    "mlp_in": "model",
    "expert": "expert",
    "layers": None,
    None: None,
}

# logical axes of the Llama tree's leaves by (parent, leaf) name; leaves
# under `layers` carry a leading "layers" axis
LLAMA_AXES: Dict[Tuple[str, str], Tuple[str, ...]] = {
    ("q_proj", "kernel"): ("embed", "heads"), ("q_proj", "bias"): ("heads",),
    ("k_proj", "kernel"): ("embed", "kv_heads"), ("k_proj", "bias"): ("kv_heads",),
    ("v_proj", "kernel"): ("embed", "kv_heads"), ("v_proj", "bias"): ("kv_heads",),
    ("o_proj", "kernel"): ("heads_in", "embed"), ("o_proj", "bias"): ("embed",),
    ("gate_proj", "kernel"): ("embed", "mlp"), ("up_proj", "kernel"): ("embed", "mlp"),
    ("down_proj", "kernel"): ("mlp_in", "embed"),
    ("input_layernorm", "weight"): ("embed",),
    ("post_attention_layernorm", "weight"): ("embed",),
    ("norm", "weight"): ("embed",),
    ("", "embed_tokens"): ("vocab", "embed"),
    ("", "lm_head"): ("embed", "vocab"),
}

# the MoE families' own leaves (Qwen2-MoE, Mixtral): the expert stacks, the
# router and Qwen's shared-expert gate; the shared expert's projections
# carry the Llama MLP's names
MOE_AXES: Dict[Tuple[str, str], Tuple[Optional[str], ...]] = {
    ("experts", "gate"): ("expert", "embed", "mlp"),
    ("experts", "up"): ("expert", "embed", "mlp"),
    ("experts", "down"): ("expert", "mlp_in", "embed"),
    ("gate", "wg"): ("embed", None),
    ("shared_expert_gate", "kernel"): ("embed", None),
}
LOGICAL_AXES = {**LLAMA_AXES, **MOE_AXES}


def logical_axes(path: Tuple[str, ...]) -> Tuple[Optional[str], ...]:
    """The logical axes of the leaf at `path` in a Llama or MoE tree."""
    key = (path[-2] if len(path) > 1 else "", path[-1])
    if key not in LOGICAL_AXES:
        raise KeyError(f"no logical axes for the leaf {'/'.join(path)}")
    axes = LOGICAL_AXES[key]
    return ("layers",) + axes if path[0] == "layers" else axes


def mesh_dim(path: Tuple[str, ...], axis: str = "model") -> Optional[int]:
    """The dimension of the leaf at `path` that shards over the mesh axis
    `axis`, or None (replicated)."""
    dims = [i for i, a in enumerate(logical_axes(path)) if DEFAULT_RULES[a] == axis]
    return dims[0] if dims else None


def model_dim(path: Tuple[str, ...]) -> Optional[int]:
    """The dimension of the leaf at `path` that shards over `model`, or
    None (replicated)."""
    return mesh_dim(path, "model")


def _contiguous(x):
    return x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)


def _stack(parts):
    return torch.stack(parts) if isinstance(parts[0], torch.Tensor) else np.stack(parts)


def _cut(x, dim: int, tp: int, rank: int, axis: str = "tp"):
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"shard_tree: dimension {dim} of size {n} does not divide {axis}={tp}")
    c = n // tp
    index = [slice(None)] * x.ndim
    index[dim] = slice(rank * c, (rank + 1) * c)
    return _contiguous(x[tuple(index)])


def shard_scales(shape: Tuple[int, ...], scales, dim: int, tp: int, rank: int):
    """One rank's flat blockwise scales of a quantized weight of `shape`
    cut along `dim`. Blocks of e consecutive elements either subdivide the
    last axis (a (..., N/e) grid, cut along `dim`; a cut of the last axis
    must keep whole blocks, `tp_shard_flavor`'s 'n') or span e/N whole
    rows (a grid of row blocks: a cut of the last axis keeps every block's
    scale, a cut of a leading axis must keep whole blocks, its 'k')."""
    total, nb = math.prod(shape), scales.shape[0]
    if nb <= 0 or total % nb:
        raise ValueError(f"shard_tree: {nb} scale blocks do not tile a {shape} weight")
    e, n = total // nb, shape[-1]
    last = dim == len(shape) - 1
    if n % e == 0:
        grid = scales.reshape(*shape[:-1], n // e)
        if last and (n // e) % tp:
            raise ValueError(f"shard_tree: {n // e} scale groups a row of a {shape} weight "
                             f"do not divide tp={tp}")
        return _cut(grid, dim, tp, rank).reshape(-1)
    if e % n:
        raise ValueError(f"shard_tree: scale blocks of {e} straddle the rows of a "
                         f"{shape} weight")
    if last:
        return _contiguous(scales)
    rows_per_block = e // n
    outer, cut_rows = math.prod(shape[:dim]), math.prod(shape[dim:-1])
    if (cut_rows // tp) % rows_per_block or cut_rows % tp:
        raise ValueError(f"shard_tree: a {shape} weight cut {tp} ways along dimension {dim} "
                         f"splits its scale blocks of {rows_per_block} rows")
    return _cut(scales.reshape(outer, cut_rows // rows_per_block), 1, tp, rank).reshape(-1)


def shard_leaf(leaf, dim: Optional[int], tp: int, rank: int, axis: str = "tp"):
    """One rank's slice of a leaf (a quantized leaf with its scales)."""
    if dim is None or tp == 1:
        return leaf
    if not (isinstance(leaf, dict) and "__q8__" in leaf):
        return _cut(leaf, dim, tp, rank, axis)
    q, s = leaf["__q8__"], leaf["scales"]
    if s.ndim == 2:  # per-layer scales of a stacked leaf
        scales = _stack([shard_scales(tuple(q.shape[1:]), s[i], dim - 1, tp, rank)
                         for i in range(q.shape[0])])
    else:
        scales = shard_scales(tuple(q.shape), s, dim, tp, rank)
    return {"__q8__": _cut(q, dim, tp, rank), "scales": scales}


def shard_tree(tree: Any, tp: int, rank: int, axis: str = "model") -> Any:
    """One rank's part of a parameter tree over a `tp`-way mesh `axis`:
    each leaf cut along its dimension that the rules map onto `axis`, the
    rest as they are (the same objects). `axis="model"` is tensor
    parallelism of a Llama-layout tree; `axis="expert"` keeps one expert
    rank's share of a Qwen2-MoE or Mixtral tree's expert stacks."""
    name = {"model": "tp", "expert": "ep"}[axis]

    def walk(node, path):
        if isinstance(node, dict) and "__q8__" not in node:
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return shard_leaf(node, mesh_dim(path, axis), tp, rank, name)

    if not 0 <= rank < tp:
        raise ValueError(f"shard_tree: rank {rank} outside {name}={tp}")
    return walk(tree, ())
