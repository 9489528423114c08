"""Fused int8 dequant-GEMM (counterpart of ``deepspeed_tpu/ops/pallas/quantized_matmul.py``).

`quantized_matmul(x, q, scales)` computes `x @ dequantize_int8_blockwise(q,
scales)` without forming the dequantized weight: for CUDA tensors it
launches the hand-written kernel `csrc/quantized_matmul.cu` (K5), for CPU
tensors it takes the plain version, `quantized_matmul_plain`. q is the
(K, N) = (in, out) int8 kernel in the JAX package's layout and `scales` its
flat blockwise f32 scales as `ops.quantization.quantize_int8_blockwise`
makes them; `scale_group_width` and `_scales_t` are the JAX package's host
helpers that relay them to one scale per (row k, column group j). The
tensor-parallel flavours (`tp_shard_flavor`, `sharded_quantized_matmul`) are
not ported (ROADMAP.md, Queue 1, 'Multi-GPU').
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.op_builder import KernelLibrary, refuse_grad
from deepspeed_tpu_torch.ops.quantization import dequantize_int8_blockwise

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("quantized_matmul.cu", {
    "ds_quantized_matmul": [_P] * 4 + [_I] * 7 + [_P],
})
GROUP_MULTIPLE = 32  # the kernel's narrowest N tile must divide a group


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


def _scales_t(k: int, n: int, scales: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Flat (nblocks,) scales → (G, K) f32, one row per column group of
    width g = N / G, and g. Where blocks subdivide rows this is a strided
    view of `scales` (no copy); where a block spans rows, one scale per row."""
    g = scale_group_width(k, n, scales.shape[0])
    if g is None:
        raise ValueError(
            f"quantized_matmul: {scales.shape[0]} scale blocks do not tile "
            f"a ({k}, {n}) weight row-aligned")
    e = k * n // scales.shape[0]
    if g == n and e != n:
        # one scale per e // n rows → one per row, one group per row
        return scales.repeat_interleave(e // n).reshape(1, k), g
    return scales.reshape(k, n // g).t(), g


def quantized_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    """`x @ dequantize_int8_blockwise(q, scales)` in f32, cast to x's dtype.
    x (..., K), q (K, N) int8, scales (nblocks,) f32 → (..., N)."""
    _scales_t(q.shape[0], q.shape[1], scales)  # the kernel's layout rule
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
    st, g = _scales_t(k, n, scales)
    groups = n // g
    if groups > 1 and g % GROUP_MULTIPLE:
        raise ValueError(f"quantized_matmul: group width {g} is not a multiple of "
                         f"{GROUP_MULTIPLE}, the kernel's narrowest tile")
    m = 1
    for d in lead:
        m *= d
    x2 = x.reshape(m, k).contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = LIBRARY.lib().ds_quantized_matmul(
            x2.data_ptr(), q.data_ptr(), st.data_ptr(), out.data_ptr(),
            m, k, n, groups, g, st.stride(0), st.stride(1), stream)
    LIBRARY.check(code, "quantized_matmul")
    quantized_matmul.launches += 1
    return out.reshape(*lead, n)


quantized_matmul.launches = 0
