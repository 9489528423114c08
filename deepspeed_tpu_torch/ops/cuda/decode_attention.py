"""Decode attention over a dense KV cache (counterpart of ``deepspeed_tpu/ops/pallas/decode_attention.py``).

`decode_attention` launches the hand-written kernel `csrc/decode_attention.cu`
for CUDA tensors and takes the plain PyTorch version,
`decode_attention_plain`, only for CPU tensors. One query per row attends the
first `lengths[b]` slots of its cache row; slots past the length are never
read. Natural-exp softmax in f32, probabilities in v's dtype before P.V, and
an empty row gives zeros.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.op_builder import KernelLibrary

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
GROUP_SIZES = (1, 2, 4, 8)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("decode_attention.cu", {
    "ds_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            ctypes.c_float, _P],
})


def _scale(d: int, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / (d ** 0.5)


def decode_attention_plain(q, k_cache, v_cache, lengths,
                           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q (B,1,H,D); caches (B,M,Hkv,D); lengths (B,) -> (B,1,H,D)."""
    b, _, h, d = q.shape
    m, hkv = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // hkv
    qg = q.reshape(b, hkv, n_rep, d).float()
    s = torch.einsum("bgrd,bmgd->bgrm", qg, k_cache.float()) * _scale(d, softmax_scale)
    valid = (torch.arange(m, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]   # (B,1,1,M)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - mx), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrm,bmgd->bgrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l).to(q.dtype).reshape(b, 1, h, d)


def _check(q, k_cache, v_cache, lengths):
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention: {name} must be bfloat16 on "
                            f"CUDA, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             "4-d tensor")
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError("decode_attention is single-query; use flash "
                         "attention for prefill")
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
                         "do not match")
    hkv = k_cache.shape[2]
    if h % hkv or h // hkv not in GROUP_SIZES:
        raise ValueError(f"decode_attention: H/Hkv = {h}/{hkv} is not one of "
                         f"the group sizes {GROUP_SIZES}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in {HEAD_DIMS}")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or lengths.shape != (b,) or not lengths.is_contiguous():
        raise ValueError("decode_attention: lengths must be a contiguous int32 "
                         f"(B,) tensor on {q.device}")


def decode_attention(q, k_cache, v_cache, lengths,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q (B,1,H,D); k/v_cache (B,M,Hkv,D); lengths (B,) valid slots per row
    (the new token's slot already written). Returns (B,1,H,D).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check(q, k_cache, v_cache, lengths)
    b, _, h, d = q.shape
    m, hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = LIBRARY.lib().ds_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, m, h, hkv, d,
            _scale(d, softmax_scale), stream)
    LIBRARY.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
