"""Flash attention (counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``).

`flash_attention_fwd` launches the hand-written kernel
`csrc/flash_attention_fwd.cu` for CUDA tensors and takes the plain PyTorch
version, `flash_attention_fwd_plain`, only for CPU tensors. Both compute the
TPU kernel's function: base-2 softmax over a query pre-scaled by
softmax_scale*log2(e) and rounded to its dtype, bottom-right aligned causal
masking with NEG_INF, GQA by KV head h // n_rep, and a base-2 lse.

The backward (`flash_attention_bwd`) is the TPU `_bwd` (:425, its
`pallas_call`s at :449, :474, :506 and :537): delta = rowsum(dO*O) in f32 as
a plain reduction, then the dq kernel and the dk/dv kernel of
`csrc/flash_attention_bwd.cu` on CUDA, or `flash_attention_bwd_plain` on the
CPU. Both kernels are built at the forward's head dims, 64, 80, 128 and
256 (`HEAD_DIMS`). On an H100 the tensor cores bound them: dq does 6*D
operations a live (query, key) pair and head, dk/dv 8*D (phi-2's training
call, B=2, S=2048, H = Hkv = 32, D = 80 causal: 0.065 and 0.087 ms;
pythia-1b's, B=4, H = Hkv = 8, D = 256: 0.104 and 0.139 ms). D = 80 runs on
tiles padded to 128 columns; D = 256 takes one warpgroup a dq block and
splits dk/dv's columns over two warpgroups that share 64 keys (the source's
header). `FlashAttention` is the autograd Function that joins the two, as
`jax.custom_vjp` does in the JAX package; `flash_attention` goes through it
whenever grad mode is on and an input requires grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.op_builder import KernelLibrary

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
HEAD_DIMS = (64, 80, 128, 256)     # the widths every K1 kernel is built at

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = KernelLibrary("flash_attention_fwd.cu", {
    "ds_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
})
BWD_LIBRARY = KernelLibrary("flash_attention_bwd.cu", {
    "ds_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "ds_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _F, _P],
})


def _softmax_scale(q: torch.Tensor, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _q_scale(q: torch.Tensor, softmax_scale: Optional[float]) -> torch.Tensor:
    """softmax_scale*log2(e) in q's dtype: the JAX kernel multiplies q by a
    weakly typed constant, which takes q's dtype before the multiply."""
    return torch.tensor(_softmax_scale(q, softmax_scale) * LOG2E, dtype=q.dtype)


def _scaled_q(q: torch.Tensor, softmax_scale: Optional[float]) -> torch.Tensor:
    """qs = q*(softmax_scale*log2 e) rounded to q's dtype; the forward and
    the backward both start from it."""
    return (q * _q_scale(q, softmax_scale).to(q.device)).to(q.dtype)


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """(Sq, Sk) True where key j is visible to query i (j <= i + Sk - Sq)."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return torch.arange(sk, device=device)[None, :] <= qi


def flash_attention_fwd_plain(q, k, v, causal: bool = True,
                              softmax_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> out (B,Sq,H,D), lse (B,H,Sq,1) f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    qg = _scaled_q(q, softmax_scale).reshape(b, sq, hkv, n_rep, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    if causal:
        s = torch.where(_causal_keep(sq, sk, q.device), s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bkgd->bgrqd", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe_l).to(q.dtype)                      # (b, g, r, sq, d)
    out = out.reshape(b, h, sq, d).transpose(1, 2).contiguous()
    lse = (m + torch.log2(safe_l)).reshape(b, h, sq, 1)
    return out, lse


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO*O) in f32, (B,Sq,H,D) -> (B,H,Sq,1), as `_bwd`
    computes it outside its kernels."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).unsqueeze(-1)


def _bwd_p_ds(q, k, v, do, lse, delta, causal, softmax_scale):
    """What both backward halves recompute: qs and dO grouped (B,Sq,Hkv,
    n_rep,D), p = exp2(qs*k^T - lse2) and ds = p*(dO*v^T - delta), each
    (B,Hkv,n_rep,Sq,Sk) in f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    qs = _scaled_q(q, softmax_scale).reshape(b, sq, hkv, n_rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qs.float(), k.float())
    if causal:
        s = torch.where(_causal_keep(sq, sk, q.device), s, torch.full_like(s, NEG_INF))
    p = torch.exp2(s - lse.reshape(b, hkv, n_rep, sq, 1))
    del s
    dof = do.reshape(b, sq, hkv, n_rep, d).float()
    ds = p * (torch.einsum("bqgrd,bkgd->bgrqk", dof, v.float())
              - delta.reshape(b, hkv, n_rep, sq, 1))
    return qs, dof, p, ds


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                                 softmax_scale: Optional[float] = None) -> torch.Tensor:
    """The dq kernel's function: dq = scale*(ds in k's dtype)*k, (B,Sq,H,D)
    in q's dtype."""
    ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, softmax_scale)[3]
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds.to(k.dtype).float(), k.float())
    return (dq * _softmax_scale(q, softmax_scale)).reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                                  softmax_scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function: dk = ln2*(ds in q's dtype)^T*qs and
    dv = p^T*dO in f32 per query head, summed over the GQA group and then
    cast; (B,Sk,Hkv,D) each."""
    qs, dof, p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, softmax_scale)
    dk = torch.einsum("bgrqk,bqgrd->bgrkd", ds.to(q.dtype).float(), qs.float()) * LN2
    dv = torch.einsum("bgrqk,bqgrd->bgrkd", p, dof)
    dk = dk.sum(2).transpose(1, 2).to(k.dtype)            # (b, sk, g, d)
    dv = dv.sum(2).transpose(1, 2).to(v.dtype)
    return dk.contiguous(), dv.contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal: bool = True,
                              softmax_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU backward step by step: (dq (B,Sq,H,D), dk, dv (B,Sk,Hkv,D)),
    from delta = rowsum(dO*O) and the two halves above."""
    delta = _delta(out, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal, softmax_scale)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal, softmax_scale)
    return dq, dk, dv


def _check(q, k, v, causal, what: str):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} must be bfloat16 on CUDA, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous 16-byte "
                             "aligned 4-d tensor")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if h % k.shape[2]:
        raise ValueError(f"{what}: H={h} is not a multiple of Hkv={k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {HEAD_DIMS}")
    if causal and sq > k.shape[1]:
        raise ValueError(f"{what}: causal attention needs Sq <= Sk")


def _check_rows(q, do, lse, delta, what: str):
    """The backward's per-query inputs: dO like q, lse and delta (B,H,Sq,1) f32."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError(f"{what}: dO must be a contiguous tensor shaped and "
                         f"typed like q, got {tuple(do.shape)} {do.dtype}")
    b, sq, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq, 1) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous f32 tensor "
                             f"of shape {(b, h, sq, 1)}, got {tuple(t.shape)} {t.dtype}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
    _check(q, k, v, causal, "flash_attention_fwd")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    qscale = float(_q_scale(q, softmax_scale))
    with torch.cuda.device(q.device):
        code = LIBRARY.lib().ds_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, hkv, d, int(causal), qscale, _stream(q.device))
    LIBRARY.check(code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """The dq kernel on CUDA tensors: dq (B,Sq,H,D) in q's dtype."""
    _check(q, k, v, causal, "flash_attention_bwd_dq")
    _check_rows(q, do, lse, delta, "flash_attention_bwd_dq")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = BWD_LIBRARY.lib().ds_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, sq, sk, h, hkv, d, int(causal),
            float(_q_scale(q, softmax_scale)), _softmax_scale(q, softmax_scale),
            _stream(q.device))
    BWD_LIBRARY.check(code, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            softmax_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel on CUDA tensors: (dk, dv) (B,Sk,Hkv,D) in k's dtype,
    each summed over its GQA group inside the kernel."""
    _check(q, k, v, causal, "flash_attention_bwd_dkv")
    _check_rows(q, do, lse, delta, "flash_attention_bwd_dkv")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = BWD_LIBRARY.lib().ds_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, hkv, d,
            int(causal), float(_q_scale(q, softmax_scale)), _stream(q.device))
    BWD_LIBRARY.check(code, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward: (dq, dk, dv) from the forward's out and
    base-2 lse. CPU tensors take the plain version; CUDA tensors launch the
    dq and dk/dv kernels or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check(q, k, v, causal, "flash_attention_bwd")
    delta = _delta(out, do).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, softmax_scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, softmax_scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward saves (q, k, v, out,
    lse), as `_flash_fwd_rule` does, and the backward runs
    `flash_attention_bwd` on them. Under activation checkpointing the
    forward runs again during backward, and so does its kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softmax_scale):
        out, lse = flash_attention_fwd(q, k, v, causal, softmax_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.softmax_scale = causal, softmax_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal, ctx.softmax_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,D); k/v (B,Sk,Hkv,D) -> (B,Sq,H,D). Differentiable through
    `FlashAttention` when grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, softmax_scale)
    return flash_attention_fwd(q, k, v, causal, softmax_scale)[0]
