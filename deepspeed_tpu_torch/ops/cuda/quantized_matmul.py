"""Fused int8 dequant-GEMM (counterpart of ``deepspeed_tpu/ops/pallas/quantized_matmul.py``).

`quantized_matmul(x, q, scales)` computes `x @ dequantize_int8_blockwise(q,
scales)` without forming the dequantized weight: for CUDA tensors it
launches the hand-written kernel `csrc/quantized_matmul.cu` (K5), for CPU
tensors it takes the plain version, `quantized_matmul_plain`. q is the
(K, N) = (in, out) int8 kernel in the JAX package's layout and `scales` its
flat blockwise f32 scales as `ops.quantization.quantize_int8_blockwise`
makes them; `scale_group_width` is the JAX package's host helper, and
`_scale_strides` reads them as its `_scales_t` does: one scale per (row k,
column group j).

Under tensor parallelism each rank holds its slice of the int8 weight and
its scales (`utils/partitioning.shard_tree`), and
`sharded_quantized_matmul` runs K5 on it: flavour 'n' (column-parallel,
the rank's output columns, no collective) or 'k' (row-parallel, the rank's
rows of K against its columns of x, then an all-reduce over the `model`
group). `tp_shard_flavor` is the JAX package's rule for which flavour a
weight's scale blocks allow; the layer scan holds a whole int8 tree to it
before the tree is cut (`inference/quantized_layer_scan.check_tp_flavors`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.op_builder import (
    KernelLibrary,
    on_current_stream,
    refuse_grad,
    split_workspace,
)
from deepspeed_tpu_torch.ops.quantization import dequantize_int8_blockwise

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("quantized_matmul.cu", {
    # + the split K's f32 partials and its per-tile counts
    "ds_quantized_matmul": [_P] * 6 + [_I] * 7 + [_P],
    "ds_quantized_matmul_workspace": [_I] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                                 ctypes.POINTER(ctypes.c_int)],
})
GROUP_MULTIPLE = 32  # scale groups of whole 32 columns: no 16-column weight chunk spans two


def scale_group_width(k: int, n: int, nblocks: int) -> Optional[int]:
    """Per-row group width g (divides N) implied by flat blockwise scales
    over a (K, N) weight, or None when blocks straddle rows misaligned."""
    total = k * n
    if nblocks <= 0 or total % nblocks:
        return None
    e = total // nblocks  # elements per scale block
    if n % e == 0:
        return e          # blocks subdivide each row
    if e % n == 0:
        return n          # one block spans e // n whole rows
    return None


def _scale_strides(k: int, n: int, scales: torch.Tensor) -> Tuple[torch.Tensor, int, int, int, int]:
    """The kernel's view of flat (nblocks,) scales, the JAX package's
    `_scales_t` without building it: (st, G, g, sj, sk) with st[j*sj + k*sk]
    the scale of row k in column group j, each g = N / G wide. Where blocks
    subdivide rows st is `scales` itself (no copy); where a block spans
    rows, one scale per row (G = 1)."""
    g = scale_group_width(k, n, scales.shape[0])
    if g is None:
        raise ValueError(
            f"quantized_matmul: {scales.shape[0]} scale blocks do not tile "
            f"a ({k}, {n}) weight row-aligned")
    e = k * n // scales.shape[0]
    if g == n and e != n:
        # one scale per e // n rows → one per row, one group per row
        return scales.repeat_interleave(e // n), 1, g, k, 1
    return scales.contiguous(), n // g, g, 1, n // g


@functools.lru_cache(maxsize=None)
def _workspace(m: int, k: int, n: int) -> Tuple[int, int]:
    """(f32 floats, column-tile counts) the kernel's split K needs for an
    (m, k) x (k, n) call: both 0 when it does not split."""
    floats, tiles = ctypes.c_longlong(0), ctypes.c_int(0)
    LIBRARY.check(LIBRARY.lib().ds_quantized_matmul_workspace(
        m, k, n, ctypes.byref(floats), ctypes.byref(tiles)), "quantized_matmul")
    return floats.value, tiles.value


def _launch(ptrs: Tuple[int, ...], m: int, k: int, n: int, layout: Tuple[int, ...],
            index: int, stream: int) -> int:
    """`ds_quantized_matmul` (x, q, st, out at `ptrs`; the scale `layout`
    G, g, sj, sk) on `stream`, with the split K's workspace where it splits."""
    floats, tiles = _workspace(m, k, n)
    work = split_workspace("quantized_matmul", index, stream, floats, tiles) if floats \
        else (None, None)
    return LIBRARY.lib().ds_quantized_matmul(*ptrs, *work, m, k, n, *layout, stream)


def quantized_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    """`x @ dequantize_int8_blockwise(q, scales)` in f32, cast to x's dtype.
    x (..., K), q (K, N) int8, scales (nblocks,) f32 → (..., N)."""
    _scale_strides(q.shape[0], q.shape[1], scales)  # the kernel's layout rule
    return (x.float() @ dequantize_int8_blockwise(q, scales)).to(x.dtype)


def _check(x, q, scales):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"quantized_matmul: x must be bfloat16 on CUDA, got {x.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError("quantized_matmul: q must be a contiguous (K, N) int8 tensor")
    if scales.dtype != torch.float32 or scales.dim() != 1:
        raise ValueError("quantized_matmul: scales must be a (nblocks,) f32 tensor")
    for name, t in (("q", q), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"quantized_matmul: {name} is on {t.device}, x on {x.device}")


def quantized_matmul(x: torch.Tensor, q: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """K5. x (..., K) bf16; q (K, N) int8; scales (nblocks,) f32 row-aligned
    blocks (`scale_group_width`). Returns (..., N) in x's dtype, f32
    accumulation.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise, on a scale layout the kernel does not take too."""
    *lead, k = x.shape
    kq, n = q.shape
    if k != kq:
        raise ValueError(f"quantized_matmul: x K={k} vs q K={kq}")
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, q, scales)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    refuse_grad("quantized_matmul", x, scales)
    _check(x, q, scales)
    st, groups, g, sj, sk = _scale_strides(k, n, scales)
    if groups > 1 and g % GROUP_MULTIPLE:
        raise ValueError(f"quantized_matmul: group width {g} is not a multiple of "
                         f"{GROUP_MULTIPLE}, the column groups the kernel takes")
    m = 1
    for d in lead:
        m *= d
    x2 = (x if len(lead) == 1 else x.reshape(m, k)).contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ptrs = (x2.data_ptr(), q.data_ptr(), st.data_ptr(), out.data_ptr())
    index = x.device.index
    code = on_current_stream(index, lambda stream: _launch(ptrs, m, k, n, (groups, g, sj, sk),
                                                           index, stream))
    LIBRARY.check(code, "quantized_matmul")
    quantized_matmul.launches += 1
    return out if len(lead) == 1 else out.reshape(*lead, n)


quantized_matmul.launches = 0


def tp_shard_flavor(k: int, n: int, nblocks: int, tp: int,
                    prefer: str = "n") -> Optional[str]:
    """Which tensor-parallel sharding of a (K, N) int8 weight with flat
    blockwise scales a tp-way `model` axis supports: 'n' (column-parallel:
    whole scale groups per shard, per-row blocks only), 'k' (row-parallel:
    row spans per shard cover whole blocks), or None. `prefer` breaks ties
    toward the weight's layout (q/k/v/gate/up 'n', o/down 'k')."""
    g = scale_group_width(k, n, nblocks)
    if g is None or tp <= 1:
        return None
    e = k * n // nblocks  # elements per scale block
    rows_per_block = e // n if (e % n == 0 and e != n) else 1

    def ok(f: str) -> bool:
        if f == "n":
            return e <= n and (n // g) % tp == 0
        return k % tp == 0 and (k // tp) % rows_per_block == 0

    order = ("n", "k") if prefer != "k" else ("k", "n")
    for f in order:
        if ok(f):
            return f
    return None


def sharded_quantized_matmul_plain(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                                   flavor: str, group="model") -> torch.Tensor:
    """The plain version of `sharded_quantized_matmul`: K5's plain version
    on the rank's shard, all-reduced over `group` for 'k'."""
    y = quantized_matmul_plain(x, q, scales)
    return comm.all_reduce(y, group=group) if flavor == "k" else y


def sharded_quantized_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                             flavor: str, group="model") -> torch.Tensor:
    """K5 on the rank's shard of a tensor-parallel int8 weight. 'n': q
    (K, N/tp) and its scales are the rank's columns, x (..., K) is whole,
    the result (..., N/tp) the rank's columns. 'k': q (K/tp, N) and its
    scales are the rank's rows, x (..., K/tp) the matching columns of the
    activation, and the partial products are all-reduced over `group` into
    the whole (..., N) on every rank. Counts its CUDA launches per flavour
    in `.launches_n` and `.launches_k`."""
    if flavor not in ("n", "k"):
        raise ValueError(f"sharded_quantized_matmul: flavor must be 'n' or 'k', got {flavor!r}")
    if x.device.type == "cpu":
        return sharded_quantized_matmul_plain(x, q, scales, flavor, group)
    y = quantized_matmul(x, q, scales)
    if flavor == "k":
        sharded_quantized_matmul.launches_k += 1
        return comm.all_reduce(y, group=group)
    sharded_quantized_matmul.launches_n += 1
    return y


sharded_quantized_matmul.launches_n = 0
sharded_quantized_matmul.launches_k = 0
