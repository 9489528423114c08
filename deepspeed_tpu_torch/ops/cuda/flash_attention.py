"""Flash attention forward (counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``).

`flash_attention_fwd` launches the hand-written kernel
`csrc/flash_attention_fwd.cu` for CUDA tensors and takes the plain PyTorch
version, `flash_attention_fwd_plain`, only for CPU tensors. Both compute the
TPU kernel's function: base-2 softmax over a query pre-scaled by
softmax_scale*log2(e) and rounded to its dtype, bottom-right aligned causal
masking with NEG_INF, GQA by KV head h // n_rep, and a base-2 lse.

Forward only: the backward kernels come with training.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.op_builder import KernelLibrary

NEG_INF = -1e30
LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("flash_attention_fwd.cu", {
    "ds_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P],
})


def _q_scale(q: torch.Tensor, softmax_scale: Optional[float]) -> torch.Tensor:
    """softmax_scale*log2(e) in q's dtype: the JAX kernel multiplies q by a
    weakly typed constant, which takes q's dtype before the multiply."""
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / (d ** 0.5)
    return torch.tensor(scale * LOG2E, dtype=q.dtype)


def flash_attention_fwd_plain(q, k, v, causal: bool = True,
                              softmax_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> out (B,Sq,H,D), lse (B,H,Sq,1) f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    qs = (q * _q_scale(q, softmax_scale).to(q.device)).to(q.dtype)
    qg = qs.reshape(b, sq, hkv, n_rep, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bkgd->bgrqd", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe_l).to(q.dtype)                      # (b, g, r, sq, d)
    out = out.reshape(b, h, sq, d).transpose(1, 2).contiguous()
    lse = (m + torch.log2(safe_l)).reshape(b, h, sq, 1)
    return out, lse


def _check(q, k, v, causal):
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash backward: training slice")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_fwd: {name} must be bfloat16 on "
                            f"CUDA, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} must be a contiguous "
                             "16-byte aligned 4-d tensor")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention_fwd: H={h} is not a multiple of "
                         f"Hkv={k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in {HEAD_DIMS}")
    if causal and sq > k.shape[1]:
        raise ValueError("flash_attention_fwd: causal attention needs Sq <= Sk")


def flash_attention_fwd(q, k, v, causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: (out (B,Sq,H,D), lse (B,H,Sq,1) f32, base 2).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    _check(q, k, v, causal)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    qscale = float(_q_scale(q, softmax_scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = LIBRARY.lib().ds_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, hkv, d, int(causal), qscale, stream)
    LIBRARY.check(code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = True,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,D); k/v (B,Sk,Hkv,D) -> (B,Sq,H,D)."""
    return flash_attention_fwd(q, k, v, causal, softmax_scale)[0]
