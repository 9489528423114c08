"""Grouped (ragged) expert GEMM (counterpart of ``deepspeed_tpu/ops/pallas/grouped_gemm.py``).

`grouped_gemm(lhs, rhs, group_sizes)` computes `out[rows of group g] =
lhs[rows of group g] @ rhs[g]` over rows sorted by group: for CUDA tensors
it launches the hand-written kernel `csrc/grouped_gemm.cu` (K6), for CPU
tensors it takes the plain version, `grouped_gemm_plain`. rhs is the (G, K,
N) expert stack as the parameter tree holds it, read with no transpose.

The JAX wrapper pads M up to its row tile and hands the pad rows to the
last group; the kernel masks the ragged edge of each tile instead, and the
outputs are the same. `tiling` is the JAX package's megablox tile choice:
it is taken and ignored, since the kernel picks its own tiles from M and G.
The kernel reads `group_sizes` on the device, so a call makes no host sync.
The expert-parallel flavour (`sharded_grouped_gemm`) and the backward
(megablox `gmm` on rhsᵀ and `tgmm`) are not ported (ROADMAP.md, Queue 1,
'Multi-GPU' and 'MoE: the rest').
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.op_builder import KernelLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("grouped_gemm.cu", {
    "ds_grouped_gemm": [_P] * 4 + [_I] * 4 + [_P],
})


def grouped_gemm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """The f32 loop over groups, cast to lhs's dtype. Reads the sizes on the
    host. Rows past the sum of the sizes are zero, as the kernel writes them."""
    m, n = lhs.shape[0], rhs.shape[2]
    out = torch.zeros((m, n), dtype=torch.float32, device=lhs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), m)
        if end > start:
            out[start:end] = lhs[start:end].float() @ rhs[g].float()
        start = max(start, end)
    return out.to(lhs.dtype)


def _check(lhs, rhs, group_sizes):
    for name, t in (("lhs", lhs), ("rhs", rhs)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"grouped_gemm: {name} must be bfloat16 on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_gemm: {name} must be contiguous")
    if group_sizes.dtype != torch.int32 or not group_sizes.is_contiguous():
        raise ValueError("grouped_gemm: group_sizes must be a contiguous int32 tensor")
    for name, t in (("rhs", rhs), ("group_sizes", group_sizes)):
        if t.device != lhs.device:
            raise ValueError(f"grouped_gemm: {name} is on {t.device}, lhs on {lhs.device}")


def grouped_gemm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                 tiling: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """K6. lhs (M, K) bf16, rows sorted by group; rhs (G, K, N) bf16;
    group_sizes (G,) int32 on lhs's device, summing to M. Returns (M, N) in
    lhs's dtype, f32 accumulation. `tiling` is accepted for the JAX
    signature and ignored.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    del tiling
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"grouped_gemm: lhs {tuple(lhs.shape)} must be (M, K) and "
                         f"rhs {tuple(rhs.shape)} (G, K, N)")
    m, k = lhs.shape
    g, k2, n = rhs.shape
    if k != k2:
        raise ValueError(f"grouped_gemm: lhs K={k} vs rhs K={k2}")
    if tuple(group_sizes.shape) != (g,):
        raise ValueError(f"grouped_gemm: group_sizes {tuple(group_sizes.shape)} != ({g},)")
    if lhs.device.type == "cpu":
        return grouped_gemm_plain(lhs, rhs, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_gemm: unsupported device {lhs.device}")
    _check(lhs, rhs, group_sizes)
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        code = LIBRARY.lib().ds_grouped_gemm(
            lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
            m, k, n, g, stream)
    LIBRARY.check(code, "grouped_gemm")
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0
