"""Block-sparse attention forward (counterpart of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``).

`block_sparse_attention(q, k, v, idx, nlive, block, causal, softmax_scale)`
attends each query block to the live KV blocks of its layout row only: for
CUDA tensors it launches the hand-written kernel
`csrc/block_sparse_attention.cu` (K7), for CPU tensors it takes the plain
version, `block_sparse_attention_plain`. The layout arrives as its padded
indices (`padded_layout_indices`): idx (H, n, Kmax) int32 with the live
blocks of each (head, query block) in ascending order, tails repeating the
last one, and nlive (H, n) int32 their counts, as tensors on q's device
(`ops/sparse_attention/sparse_self_attention.py` uploads them once per
layout). A query row that sees no key (no live block, or a causal row whose
every live block lies above it) outputs zeros.

The kernel takes bf16 q/k/v (B, S, H, D) with block in `BLOCKS` and D in
`HEAD_DIMS`; anything else on CUDA raises. It has no backward: the JAX
package differentiates it through the gather path, and so does the port
(`sparse_self_attention.BlockSparseAttention`); the wrapper refuses grad
mode.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.op_builder import KernelLibrary, refuse_grad

BLOCKS = (32, 64, 128)
HEAD_DIMS = (64, 128)
LOG2E = 1.4426950408889634

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("block_sparse_attention.cu", {
    "ds_block_sparse_attention": [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P],
})


def padded_layout_indices(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, nq, nk) bool -> (idx, nlive): idx (H, nq, Kmax) int32 with the
    padded tail entries repeating the last live index, nlive (H, nq) int32
    live counts."""
    h, nq, nk = layout.shape
    kmax = max(int(layout.sum(-1).max()), 1)
    idx = np.zeros((h, nq, kmax), np.int32)
    nlive = np.zeros((h, nq), np.int32)
    for hh in range(h):
        for qi in range(nq):
            act = np.nonzero(layout[hh, qi])[0]
            nlive[hh, qi] = len(act)
            if len(act):
                idx[hh, qi, :len(act)] = act
                idx[hh, qi, len(act):] = act[-1]
    return idx, nlive


def _scale(d: int, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)


def block_sparse_attention_plain(q, k, v, idx, nlive, block: int, causal: bool = False,
                                 softmax_scale: Optional[float] = None) -> torch.Tensor:
    """The loop over query blocks, every (batch, head) at once: gather the
    live KV blocks of the row, softmax in f32 over their unmasked keys, and
    weight V. Returns (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    n = s // block
    scale = _scale(d, softmax_scale)
    idx = torch.as_tensor(idx, device=q.device).long()
    nlive = torch.as_tensor(nlive, device=q.device).long()
    kmax = idx.shape[-1]
    kb = k.float().reshape(b, n, block, h, d).permute(0, 3, 1, 2, 4)   # (B, H, n, blk, D)
    vb = v.float().reshape(b, n, block, h, d).permute(0, 3, 1, 2, 4)
    heads = torch.arange(h, device=q.device)[:, None]
    slot = torch.arange(kmax, device=q.device)
    offs = torch.arange(block, device=q.device)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    for qi in range(n):
        ids = idx[:, qi]                                                  # (H, Kmax)
        live = slot[None] < nlive[:, qi, None]
        if causal:
            live = live & (ids <= qi)
        kg, vg = kb[:, heads, ids], vb[:, heads, ids]                     # (B, H, Kmax, blk, D)
        qb = q[:, qi * block:(qi + 1) * block].float().permute(0, 2, 1, 3)
        logits = torch.einsum("bhqd,bhjkd->bhqjk", qb, kg) * scale
        mask = live[None, :, None, :, None]
        if causal:
            rows = qi * block + offs
            cols = ids[..., None] * block + offs                          # (H, Kmax, blk)
            mask = mask & (cols[None, :, None] <= rows[None, None, :, None, None])
        logits = logits.masked_fill(~mask, float("-inf")).reshape(b, h, block, kmax * block)
        probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)   # no live key: zeros
        ctx = torch.einsum("bhqjk,bhjkd->bhqd", probs.reshape(b, h, block, kmax, block), vg)
        out[:, qi * block:(qi + 1) * block] = ctx.permute(0, 2, 1, 3).to(q.dtype)
    return out


def _check(q, k, v, idx, nlive, block):
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"block_sparse_attention: {name} must be bfloat16 on CUDA, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"block_sparse_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"block_sparse_attention: {name} is on {t.device}, q on {q.device}")
    if block not in BLOCKS:
        raise ValueError(f"block_sparse_attention: block {block} not in {BLOCKS}")
    if d not in HEAD_DIMS:
        raise ValueError(f"block_sparse_attention: head dim {d} not in {HEAD_DIMS}")
    for name, t, shape in (("idx", idx, (h, s // block, idx.shape[-1])),
                           ("nlive", nlive, (h, s // block))):
        if t.device != q.device or t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"block_sparse_attention: {name} must be a contiguous int32 "
                             f"{shape} tensor on {q.device}")


def block_sparse_attention(q, k, v, idx, nlive, block: int, causal: bool = False,
                           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """K7. q/k/v (B, S, H, D); idx (H, n, Kmax), nlive (H, n) int32 on q's
    device (`padded_layout_indices`); S a multiple of `block`. Returns
    (B, S, H, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"block_sparse_attention: q/k/v must share one (B, S, H, D) shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if s % block:
        raise ValueError(f"block_sparse_attention: S={s} is not a multiple of block {block}")
    if q.device.type == "cpu":
        return block_sparse_attention_plain(q, k, v, idx, nlive, block, causal, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"block_sparse_attention: unsupported device {q.device}")
    refuse_grad("block_sparse_attention", q, k, v)
    _check(q, k, v, idx, nlive, block)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = LIBRARY.lib().ds_block_sparse_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(), nlive.data_ptr(),
            out.data_ptr(), b, s, h, d, block, idx.shape[-1], int(causal),
            _scale(d, softmax_scale) * LOG2E, stream)
    LIBRARY.check(code, "block_sparse_attention")
    block_sparse_attention.launches += 1
    return out


block_sparse_attention.launches = 0
