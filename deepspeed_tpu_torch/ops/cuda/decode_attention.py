"""Decode attention over a dense KV cache (counterpart of ``deepspeed_tpu/ops/pallas/decode_attention.py``).

`decode_attention` launches the hand-written kernel `csrc/decode_attention.cu`
for CUDA tensors and takes the plain PyTorch version,
`decode_attention_plain`, only for CPU tensors. One query per row attends the
first `lengths[b]` slots of its cache row; slots past the length are never
read. Natural-exp softmax in f32, probabilities in v's dtype before P.V, and
an empty row gives zeros. The kernel cuts each row's cache into chunks of a
length fixed in `csrc/decode_split.cuh`, one thread block each, so the split
is a function of M alone (`split_plan`), and merges their partials through
a per-stream workspace (`op_builder.split_workspace`).

An int8 cache (K2-int8) comes with `k_scales`/`v_scales` (B, M, Hkv) f32:
the kernel folds the K scale into the logit columns and the V scale into the
probability columns; the plain version dequantizes into q's dtype and runs
the same plain math. Its launches count in `decode_attention.launches_int8`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.quantization import dequantize_kv
from deepspeed_tpu_torch.op_builder import (
    KernelLibrary,
    on_current_stream,
    refuse_grad,
    split_workspace,
)

NEG_INF = -1e30
# the kernel's GQA group sizes by head width: 80 and 256 (the zoo's phi-2
# and pythia-1b) are built for a group of one only
GROUP_SIZES = {64: (1, 2, 4, 8), 80: (1,), 128: (1, 2, 4, 8), 256: (1,)}
HEAD_DIMS = tuple(GROUP_SIZES)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("decode_attention.cu", {
    # q, k, v, scales, lengths, out, the split's partials and counts
    "ds_decode_attention": [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P],
    "ds_decode_attention_workspace": [_I] * 5 + [ctypes.POINTER(_I)] * 2 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_I)],
})


def _scale(d: int, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / (d ** 0.5)


def decode_attention_plain(q, k_cache, v_cache, lengths,
                           softmax_scale: Optional[float] = None,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """q (B,1,H,D); caches (B,M,Hkv,D); lengths (B,) -> (B,1,H,D). With
    `k_scales`/`v_scales` (B,M,Hkv) the caches are int8 and are dequantized
    into q's dtype first."""
    if k_scales is not None:
        k_cache = dequantize_kv(k_cache, k_scales, q.dtype)
        v_cache = dequantize_kv(v_cache, v_scales, q.dtype)
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


def _check(q, k_cache, v_cache, lengths, k_scales, v_scales):
    """Raise unless the kernel takes these CUDA tensors; each attribute is
    read once (the checks run on every decode step)."""
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError("decode_attention: give both k_scales and v_scales or neither")
    index = q.get_device()
    kv = torch.int8 if quant else torch.bfloat16
    for name, t, want in (("q", q, torch.bfloat16), ("k_cache", k_cache, kv),
                          ("v_cache", v_cache, kv)):
        if t.get_device() != index:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != want:
            raise TypeError(f"decode_attention: {name} must be {want} on "
                            f"CUDA, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be a contiguous, "
                             "16-byte aligned 4-d tensor")
    b, s, h, d = q.shape
    shape = k_cache.shape
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)) if quant else ():
        if t.get_device() != index or t.dtype != torch.float32 \
                or t.shape != shape[:3] or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous f32 "
                             f"{tuple(shape[:3])} tensor on {q.device}")
    if s != 1:
        raise ValueError("decode_attention is single-query; use flash "
                         "attention for prefill")
    if shape != v_cache.shape or shape[0] != b or shape[3] != d:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(shape)}/{tuple(v_cache.shape)} "
                         "do not match")
    hkv = shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in {HEAD_DIMS}")
    if h % hkv or h // hkv not in GROUP_SIZES[d]:
        raise ValueError(f"decode_attention: H/Hkv = {h}/{hkv} is not one of "
                         f"the group sizes {GROUP_SIZES[d]} at head dim {d}")
    if lengths.get_device() != index or lengths.dtype != torch.int32 \
            or lengths.shape != (b,) or not lengths.is_contiguous():
        raise ValueError("decode_attention: lengths must be a contiguous int32 "
                         f"(B,) tensor on {q.device}")


@functools.lru_cache(maxsize=None)
def split_plan(b: int, m: int, h: int, hkv: int, d: int) -> Tuple[int, int, int, int]:
    """(positions a chunk takes, chunks, f32 floats of partials, arrival
    counts) of a call over a cache of M slots, from
    `ds_decode_attention_workspace`; the last two are 0 at one chunk."""
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()]
    LIBRARY.check(LIBRARY.lib().ds_decode_attention_workspace(
        b, m, h, hkv, d, *map(ctypes.byref, out)), "decode_attention")
    return tuple(x.value for x in out)


def _launch(ptrs, b: int, m: int, h: int, hkv: int, d: int, scale: float, index: int,
            stream: int) -> int:
    """`ds_decode_attention` on `stream`, with the split's workspace where
    the cache spans more than one chunk."""
    _, _, floats, counts = split_plan(b, m, h, hkv, d)
    work = split_workspace("decode_attention", index, stream, floats, counts) if floats \
        else (None, None)
    return LIBRARY.lib().ds_decode_attention(*ptrs, *work, b, m, h, hkv, d, scale, stream)


def decode_attention(q, k_cache, v_cache, lengths,
                     softmax_scale: Optional[float] = None,
                     k_scales=None, v_scales=None) -> torch.Tensor:
    """q (B,1,H,D); k/v_cache (B,M,Hkv,D); lengths (B,) valid slots per row
    (the new token's slot already written). Returns (B,1,H,D). An int8
    cache comes with `k_scales`/`v_scales` (B,M,Hkv) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            return decode_attention_plain(q, k_cache, v_cache, lengths, softmax_scale,
                                          k_scales, v_scales)
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    refuse_grad("decode_attention", q, k_cache, v_cache, k_scales, v_scales)
    _check(q, k_cache, v_cache, lengths, k_scales, v_scales)
    quant = k_scales is not None
    b, _, h, d = q.shape
    _, m, hkv, _ = k_cache.shape
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
            lengths.data_ptr(), out.data_ptr())
    index = q.get_device()
    scale = _scale(d, softmax_scale)
    code = on_current_stream(index, lambda stream: _launch(ptrs, b, m, h, hkv, d, scale, index,
                                                           stream))
    LIBRARY.check(code, "decode_attention")
    if quant:
        decode_attention.launches_int8 += 1
    else:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.launches_int8 = 0
