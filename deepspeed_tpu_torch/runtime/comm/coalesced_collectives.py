"""Quantized collectives, ZeRO++'s qgZ and qwZ (counterpart of
``deepspeed_tpu/runtime/comm/coalesced_collectives.py``).

The gradient reduce-scatter sends int8 values with one f32 scale a block
(`ops/quantization.quantize_int8_blockwise`) instead of f32, and stage 3's
parameter gathers do the same instead of sending the model dtype. The
blocks are the JAX package's: a reduce-scatter quantizes each of the p
chunks of the input along `scatter_dim` (moved to the front and flattened
row-major) on its own, a gather quantizes the rank's shard as it lies, in
blocks of the largest divisor of the chunk's elements up to `block`. The
collectives are `comm`'s, eager on the rank's tensors: an all-to-all of
the (int8, scales) pairs, each rank dequantizing and averaging what it
received in f32, where the JAX functions run inside a `shard_map` region.
The quantizers are plain torch, as the JAX package leaves them to XLA's
fusion (a CUDA quantize kernel is ROADMAP speed work). Each call counts
under its own kind in `comm.comm_stats()` (`comm.wire`): the bytes of the
int8 values and f32 scales it hands to the collectives, which the JAX
package records as `_record_quantized_wire` (`wire_bytes` predicts them).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.quantization import (
    dequantize_int8_blockwise,
    quantize_int8_blockwise,
)


def block_size(n: int, block: int = 256) -> int:
    """The block `quantize_int8_blockwise` takes for `n` elements: the
    largest divisor of n up to `block`."""
    b = min(block, n)
    while n % b:
        b -= 1
    return b


def wire_bytes(n: int, block: int = 256, chunks: int = 1) -> int:
    """The bytes of `n` elements quantized in `chunks` equal chunks: int8
    values plus an f32 scale a block of each chunk."""
    per = n // chunks
    return chunks * (per + 4 * (per // block_size(per, block)))


def quantize_rows(x: torch.Tensor, block: int = 256, reciprocal: bool = False):
    """Each row of a 2-D tensor quantized on its own: (int8 of x's shape,
    f32 scales (rows, blocks a row))."""
    qs = [quantize_int8_blockwise(row, block, reciprocal) for row in x]
    return torch.stack([q for q, _ in qs]), torch.stack([s for _, s in qs])


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """`quantize_rows` undone, in f32."""
    return torch.stack([dequantize_int8_blockwise(a, s) for a, s in zip(q, scales)])


def quantized_reduce_scatter(x: torch.Tensor, group: Optional[str] = "data",
                             scatter_dim: int = 0, block: int = 256, mean: bool = True,
                             reciprocal: bool = False) -> torch.Tensor:
    """The int8 reduce-scatter over `group` (qgZ): each rank quantizes its
    p chunks along `scatter_dim`, sends chunk j to rank j, and reduces
    the p chunks it receives in f32 (the mean, or the sum). Returns this
    rank's reduced chunk, of x's shape with `scatter_dim` divided by p."""
    p = comm.get_world_size(group)
    d = x.shape[scatter_dim]
    if d % p:
        raise ValueError(f"quantized_reduce_scatter: dim {scatter_dim} ({d}) is not "
                         f"divisible by the group's {p} ranks")
    moved = x.movedim(scatter_dim, 0)
    red, = reduce_scatter_segments([moved.reshape(p, -1)], group, block, reciprocal, mean)
    return red.reshape((d // p,) + tuple(moved.shape[1:])).movedim(0, scatter_dim)


def quantized_all_gather(x: torch.Tensor, group: Optional[str] = "data", gather_dim: int = 0,
                         block: int = 256, reciprocal: bool = False) -> torch.Tensor:
    """The int8 all-gather over `group` (qwZ): the rank's shard quantized,
    the (int8, scales) pairs gathered, each dequantized in f32 and the
    shards concatenated along `gather_dim`."""
    rows, = gather_segments([x.reshape(-1)], group, block, reciprocal)
    return torch.cat([r.view_as(x) for r in rows], dim=gather_dim)


def all_to_all_quant_reduce(tensors: Sequence[torch.Tensor], group: Optional[str] = "data",
                            scatter_dims: Optional[Sequence[int]] = None,
                            block: int = 256) -> list:
    """`quantized_reduce_scatter` over a list of tensors (the reference's
    name)."""
    scatter_dims = [0] * len(tensors) if scatter_dims is None else scatter_dims
    return [quantized_reduce_scatter(t, group, d, block) for t, d in zip(tensors, scatter_dims)]


def reduce_scatter_coalesced(tensors: Sequence[torch.Tensor], group: Optional[str] = "data",
                             scatter_dims: Optional[Sequence[int]] = None) -> list:
    """The unquantized counterpart: each tensor's sum over the group, tile r
    along its scatter dim on rank r."""
    scatter_dims = [0] * len(tensors) if scatter_dims is None else scatter_dims
    return [comm.reduce_scatter(t, group, d) for t, d in zip(tensors, scatter_dims)]


def reduce_scatter_segments(segments: Sequence[torch.Tensor], group: Optional[str] = "data",
                            block: int = 256, reciprocal: bool = False,
                            mean: bool = True) -> List[torch.Tensor]:
    """Several quantized reduce-scatters in one all-to-all pair: segment i
    is (p, n_i), its row j the chunk for rank j, each row quantized on its
    own (`quantized_reduce_scatter`'s blocks). Returns each segment's mean
    (or sum) over the group's ranks of the row this rank owns, (n_i,) in
    f32."""
    p = comm.get_world_size(group)
    pairs = [quantize_rows(seg, block, reciprocal) for seg in segments]
    q = torch.cat([a for a, _ in pairs], dim=1)
    s = torch.cat([b for _, b in pairs], dim=1)
    with comm.wire("quantized_reduce_scatter", group):
        q = comm.all_to_all_single(q, group)
        s = comm.all_to_all_single(s, group)
    qs = q.split([a.shape[1] for a, _ in pairs], dim=1)
    ss = s.split([b.shape[1] for _, b in pairs], dim=1)
    return [dequantize_rows(a, b).mean(0) if mean else dequantize_rows(a, b).sum(0)
            for a, b in zip(qs, ss)]


def gather_segments(segments: Sequence[torch.Tensor], group: Optional[str] = "data",
                    block: int = 256, reciprocal: bool = False) -> List[torch.Tensor]:
    """Several quantized all-gathers in one gather pair: segment i (this
    rank's shard, flat in the order it is quantized) comes back as (p, n_i)
    in f32, row j rank j's."""
    pairs = [quantize_int8_blockwise(seg, block, reciprocal) for seg in segments]
    q = torch.cat([a for a, _ in pairs])
    s = torch.cat([b for _, b in pairs])
    n = comm.get_world_size(group)
    qg, sg = q.new_empty((n, q.numel())), s.new_empty((n, s.numel()))
    with comm.wire("quantized_all_gather", group):
        comm.all_gather_into(qg, q, group)
        comm.all_gather_into(sg, s, group)
    qs = qg.split([a.numel() for a, _ in pairs], dim=1)
    ss = sg.split([b.numel() for _, b in pairs], dim=1)
    return [dequantize_rows(a, b) for a, b in zip(qs, ss)]
