"""Attention over the block-paged KV cache (counterpart of ``deepspeed_tpu/ops/pallas/paged_attention.py``).

`paged_decode_attention` (one new query per row, K3) and
`paged_prefill_attention` (a chunk of S new queries per row, K4) launch the
hand-written kernels `csrc/paged_decode_attention.cu` (its alibi forms
built as `csrc/paged_decode_attention_alibi.cu`) and
`csrc/paged_prefill_attention.cu` for CUDA tensors, and take their plain
PyTorch versions only for CPU tensors.

Both compute the TPU kernels' function. Pools are (Hkv, NB, BS, D), tables
(B, T) int32 map logical block j of row b to a pool block. A table entry is
clamped into [0, NB-1] before it is read (a -1 entry or a parked row reads
block 0, and its output is ignored), logits are (q·k)·scale in f32, the
softmax uses natural exp, probabilities are cast to v's dtype before P·V,
and a row with no valid key gives zeros. The decode kernel folds a staged
token (`k_new`/`v_new`, not yet in the pool) in last, as f32 p·v; the
prefill kernel masks causally by absolute position start + i over a pool
that already holds the chunk. `window` keeps only keys in
(qpos − window, qpos]. The decode kernel cuts each row's T·BS positions
into chunks of a length fixed in `csrc/decode_split.cuh`, one thread block
each, so the split is a function of T·BS alone (`decode_split_plan`), and
merges them through a per-stream workspace (`op_builder.split_workspace`).

`alibi` (H,) f32 slopes (K3-alibi, K4-alibi) add slopes[h]·key_position to
the f32 logits before the mask; the decode kernel's staged column sits at
the query's position, lengths − 1. The bias stays in f32: at v2's positions
it reaches ~860, where a bf16 ulp is 4. Alibi launches count in
`.launches_alibi`, bf16 or int8 pools alike.

int8 pools (K3-int8, K4-int8) come with `k_scales`/`v_scales` (Hkv, NB, BS)
f32: the kernels fold the K scale into the logit columns and the V scale
into the probability columns, reading each scale through the same clamped
table entry as its value; the plain versions dequantize the pools into q's
dtype and run the same plain math. The staged token is in q's dtype and
folds in without a scale. int8 launches without alibi count in
`.launches_int8`, the rest in `.launches`.
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
HEAD_DIMS = (64, 80, 128, 256)
# K3's GQA group sizes by head width (80 and 256, the zoo's phi-2 and
# pythia-1b, are built for a group of one only); K4 takes 1, 2, 4 and 8 at
# every width; alibi is built at 64 and 128 (the widths of an alibi model)
DECODE_GROUP_SIZES = {64: (1, 2, 4, 8), 80: (1,), 128: (1, 2, 4, 8), 256: (1,)}
PREFILL_GROUP_SIZES = (1, 2, 4, 8)
ALIBI_HEAD_DIMS = (64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
_DECODE_FUNCTIONS = {
    # q, pools, scales, tables, lengths, staged token, slopes, out, the
    # split's partials and counts
    "ds_paged_decode_attention": [_P] * 13 + [_I] * 9 + [ctypes.c_float, _P],
    "ds_paged_decode_attention_workspace": [_I] * 6 + [ctypes.POINTER(_I)] * 2 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_I)],
}
# K3 without alibi, and K3-alibi: one source built twice, so the two compile
# in parallel
DECODE_LIBRARY = KernelLibrary("paged_decode_attention.cu", _DECODE_FUNCTIONS)
ALIBI_DECODE_LIBRARY = KernelLibrary("paged_decode_attention_alibi.cu", _DECODE_FUNCTIONS)
PREFILL_LIBRARY = KernelLibrary("paged_prefill_attention.cu", {
    "ds_paged_prefill_attention": [_P] * 9 + [_I] * 9 + [ctypes.c_float, _P],
})


def _scale(d: int, softmax_scale: Optional[float]) -> float:
    return softmax_scale if softmax_scale is not None else 1.0 / (d ** 0.5)


def _dequantized(q, k_pool, v_pool, k_scales, v_scales):
    """The pools in q's dtype: int8 pools times their scales, else as given."""
    if k_scales is None:
        return k_pool, v_pool
    return (dequantize_kv(k_pool, k_scales, q.dtype),
            dequantize_kv(v_pool, v_scales, q.dtype))


def _slopes(alibi: torch.Tensor, hkv: int, n_rep: int) -> torch.Tensor:
    """(H,) slopes as (Hkv, n_rep) f32: head g·n_rep + r is [g, r]."""
    return alibi.float().reshape(hkv, n_rep)


def _gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(Hkv, NB, BS, D) through clamped (B, T) tables → (Hkv, B, T·BS, D)."""
    hkv, nb, bs, d = pool.shape
    b, t = tables.shape
    phys = tables.long().clamp(0, nb - 1).reshape(-1)
    return pool[:, phys].reshape(hkv, b, t * bs, d)


def paged_decode_attention_plain(q, k_pool, v_pool, tables, lengths,
                                 softmax_scale: Optional[float] = None,
                                 k_new=None, v_new=None,
                                 window: Optional[int] = None,
                                 k_scales=None, v_scales=None,
                                 alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,1,H,D); pools (Hkv,NB,BS,D); tables (B,T); lengths (B,) valid
    tokens per row, the last one staged when `k_new`/`v_new` (B,Hkv,D) are
    given -> (B,1,H,D). int8 pools come with `k_scales`/`v_scales`;
    `alibi` (H,) adds slopes[h]·key_position to the logits."""
    k_pool, v_pool = _dequantized(q, k_pool, v_pool, k_scales, v_scales)
    b, _, h, d = q.shape
    hkv, nb, bs, _ = k_pool.shape
    t = tables.shape[1]
    n_rep = h // hkv
    scale = _scale(d, softmax_scale)
    staged = k_new is not None
    lengths = lengths.to(q.device).long()
    pool_len = lengths - 1 if staged else lengths
    qpos = lengths - 1                    # the query's absolute position
    qg = q.reshape(b, hkv, n_rep, d).float()
    s = torch.einsum("bgrd,gbmd->bgrm", qg, _gather(k_pool, tables).float()) * scale
    cols = torch.arange(t * bs, device=q.device)[None, :]
    if alibi is not None:
        s = s + _slopes(alibi, hkv, n_rep)[None, :, :, None] * cols.float()[:, None, None, :]
    keep = cols < pool_len[:, None]
    if window is not None:
        keep = keep & (cols > (qpos - window)[:, None])
    keep = keep[:, None, None, :]                               # (B,1,1,M)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    if staged:
        sn = (qg * k_new.float()[:, :, None, :]).sum(-1, keepdim=True) * scale
        if alibi is not None:
            sn = sn + _slopes(alibi, hkv, n_rep)[None, :, :, None] * \
                qpos.float()[:, None, None, None]
        m = torch.maximum(m, sn)
    p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrm,gbmd->bgrd", p.to(v_pool.dtype).float(),
                       _gather(v_pool, tables).float())
    if staged:
        pn = torch.exp(sn - m)
        l = l + pn
        acc = acc + pn * v_new.float()[:, :, None, :]
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l).to(q.dtype).reshape(b, 1, h, d)


def paged_prefill_attention_plain(q, k_pool, v_pool, tables, starts,
                                  softmax_scale: Optional[float] = None,
                                  window: Optional[int] = None,
                                  k_scales=None, v_scales=None,
                                  alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,S,H,D), the S new tokens of each row, already written to the
    pool at positions starts[b]..starts[b]+S-1; each attends every cached
    position <= its own -> (B,S,H,D). int8 pools come with
    `k_scales`/`v_scales`; `alibi` (H,) adds slopes[h]·key_position to the
    logits."""
    k_pool, v_pool = _dequantized(q, k_pool, v_pool, k_scales, v_scales)
    b, s, h, d = q.shape
    hkv, nb, bs, _ = k_pool.shape
    t = tables.shape[1]
    n_rep = h // hkv
    qg = q.reshape(b, s, hkv, n_rep, d).float()
    sc = torch.einsum("bsgrd,gbmd->bgrsm", qg, _gather(k_pool, tables).float()) \
        * _scale(d, softmax_scale)
    qpos = starts.to(q.device).long()[:, None] + torch.arange(s, device=q.device)[None]
    cols = torch.arange(t * bs, device=q.device)[None, None, :]
    if alibi is not None:
        sc = sc + _slopes(alibi, hkv, n_rep)[None, :, :, None, None] * cols.float()[:, None]
    keep = cols <= qpos[:, :, None]
    if window is not None:
        keep = keep & (cols > qpos[:, :, None] - window)
    keep = keep[:, None, None]                                  # (B,1,1,S,M)
    sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrsm,gbmd->bgrsd", p.to(v_pool.dtype).float(),
                       _gather(v_pool, tables).float())
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe_l).to(q.dtype)                            # (B,g,r,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def _check_alibi(name, q, alibi) -> None:
    """Slopes must be a contiguous f32 (H,) tensor on q's device."""
    h = q.shape[2]
    if alibi is not None and (alibi.device != q.device or alibi.dtype != torch.float32
                              or tuple(alibi.shape) != (h,) or not alibi.is_contiguous()):
        raise ValueError(f"{name}: alibi must be a contiguous f32 {(h,)} tensor on "
                         f"{q.device}, got {alibi.dtype} {tuple(alibi.shape)} on "
                         f"{alibi.device}")


def _count(fn, quant: bool, alibi) -> None:
    """One launch of `fn`'s kernel: alibi, int8 or bf16, in that order."""
    if alibi is not None:
        fn.launches_alibi += 1
    elif quant:
        fn.launches_int8 += 1
    else:
        fn.launches += 1


def _check(name, q, k_pool, v_pool, tables, per_row, window, k_scales, v_scales,
           alibi, group_sizes, extra=()):
    """Raise unless the kernel takes these CUDA tensors; each attribute is
    read once (the checks run on every step)."""
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError(f"{name}: give both k_scales and v_scales or neither")
    index = q.get_device()
    pools = torch.int8 if quant else torch.bfloat16
    for arg, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), *extra):
        if x.get_device() != index:
            raise ValueError(f"{name}: {arg} is on {x.device}, q on {q.device}")
        want = pools if arg in ("k_pool", "v_pool") else torch.bfloat16
        if x.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want} on CUDA, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    b, _, h, d = q.shape
    pool_shape = k_pool.shape
    hkv, nb, bs, dk = pool_shape
    for arg, x in (("k_scales", k_scales), ("v_scales", v_scales)) if quant else ():
        if x.get_device() != index or x.dtype != torch.float32 \
                or x.shape != pool_shape[:3] or not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous f32 {(hkv, nb, bs)} "
                             f"tensor on {q.device}")
    if v_pool.shape != pool_shape or dk != d:
        raise ValueError(f"{name}: q {tuple(q.shape)}, pools {tuple(pool_shape)}/"
                         f"{tuple(v_pool.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    sizes = group_sizes(d)
    if h % hkv or h // hkv not in sizes:
        raise ValueError(f"{name}: H/Hkv = {h}/{hkv} is not one of the group "
                         f"sizes {sizes} at head dim {d}")
    if alibi is not None and d not in ALIBI_HEAD_DIMS:
        raise ValueError(f"{name}: alibi at head dim {d}: the kernel's alibi form is built "
                         f"at {ALIBI_HEAD_DIMS} (ROADMAP.md, Queue 2)")
    for arg, x, shape in (("tables", tables, (b, tables.shape[-1])),
                          ("lengths/starts", per_row, (b,))):
        if x.get_device() != index or x.dtype != torch.int32 or x.shape != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous int32 {shape} "
                             f"tensor on {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")


@functools.lru_cache(maxsize=None)
def decode_split_plan(b: int, h: int, hkv: int, d: int, bs: int,
                      t: int) -> Tuple[int, int, int, int]:
    """(positions a chunk takes, chunks, f32 floats of partials, arrival
    counts) of a K3 call over tables of T blocks of BS, from
    `ds_paged_decode_attention_workspace`; the last two are 0 at one chunk."""
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()]
    DECODE_LIBRARY.check(DECODE_LIBRARY.lib().ds_paged_decode_attention_workspace(
        b, h, hkv, d, bs, t, *map(ctypes.byref, out)), "paged_decode_attention")
    return tuple(x.value for x in out)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                           softmax_scale: Optional[float] = None,
                           k_new=None, v_new=None,
                           window: Optional[int] = None,
                           k_scales=None, v_scales=None,
                           alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3. q (B,1,H,D); pools (Hkv,NB,BS,D); tables (B,T) int32; lengths (B,)
    int32 valid tokens per row. With `k_new`/`v_new` (B,Hkv,D) the last valid
    token is staged and folded in; without them its slot is already written.
    int8 pools come with `k_scales`/`v_scales` (Hkv,NB,BS) f32, alibi with
    its (H,) f32 slopes. Returns (B,1,H,D).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_alibi("paged_decode_attention", q, alibi)
    if not q.is_cuda:
        if q.device.type == "cpu":
            return paged_decode_attention_plain(q, k_pool, v_pool, tables, lengths,
                                                softmax_scale, k_new, v_new, window,
                                                k_scales, v_scales, alibi)
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    refuse_grad("paged_decode_attention", q, k_pool, v_pool, k_new, v_new, k_scales,
                v_scales, alibi)
    staged = k_new is not None
    quant = k_scales is not None
    extra = (("k_new", k_new), ("v_new", v_new)) if staged else ()
    _check("paged_decode_attention", q, k_pool, v_pool, tables, lengths, window,
           k_scales, v_scales, alibi, DECODE_GROUP_SIZES.__getitem__, extra)
    b, s, h, d = q.shape
    hkv, nb, bs, _ = k_pool.shape
    if s != 1:
        raise ValueError("paged_decode_attention is single-query; use "
                         "paged_prefill_attention for S > 1")
    if staged and (k_new.shape != (b, hkv, d) or v_new.shape != (b, hkv, d)):
        raise ValueError(f"paged_decode_attention: k_new/v_new must be {(b, hkv, d)}")
    out = torch.empty_like(q)
    t = tables.shape[1]
    _, _, floats, counts = decode_split_plan(b, h, hkv, d, bs, t)
    ptrs = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
            tables.data_ptr(), lengths.data_ptr(), k_new.data_ptr() if staged else None,
            v_new.data_ptr() if staged else None,
            alibi.data_ptr() if alibi is not None else None, out.data_ptr())
    index = q.get_device()

    library = DECODE_LIBRARY if alibi is None else ALIBI_DECODE_LIBRARY

    def launch(stream):
        work = split_workspace("paged_decode_attention", index, stream, floats, counts) \
            if floats else (None, None)
        return library.lib().ds_paged_decode_attention(
            *ptrs, *work, b, h, hkv, d, nb, bs, t, int(staged), window or 0,
            _scale(d, softmax_scale), stream)

    code = on_current_stream(index, launch)
    library.check(code, "paged_decode_attention")
    _count(paged_decode_attention, quant, alibi)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_int8 = 0
paged_decode_attention.launches_alibi = 0


def paged_prefill_attention(q, k_pool, v_pool, tables, starts,
                            softmax_scale: Optional[float] = None,
                            window: Optional[int] = None,
                            k_scales=None, v_scales=None,
                            alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4. q (B,S,H,D), already written to the pool at starts[b]..+S-1;
    pools (Hkv,NB,BS,D); tables (B,T) int32; starts (B,) int32. int8 pools
    come with `k_scales`/`v_scales` (Hkv,NB,BS) f32, alibi with its (H,) f32
    slopes. Returns (B,S,H,D).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_alibi("paged_prefill_attention", q, alibi)
    if not q.is_cuda:
        if q.device.type == "cpu":
            return paged_prefill_attention_plain(q, k_pool, v_pool, tables, starts,
                                                 softmax_scale, window, k_scales, v_scales,
                                                 alibi)
        raise ValueError(f"paged_prefill_attention: unsupported device {q.device}")
    refuse_grad("paged_prefill_attention", q, k_pool, v_pool, k_scales, v_scales, alibi)
    quant = k_scales is not None
    _check("paged_prefill_attention", q, k_pool, v_pool, tables, starts, window,
           k_scales, v_scales, alibi, lambda d: PREFILL_GROUP_SIZES)
    b, s, h, d = q.shape
    hkv, nb, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
            tables.data_ptr(), starts.data_ptr(),
            alibi.data_ptr() if alibi is not None else None, out.data_ptr(),
            b, s, h, hkv, d, nb, bs, tables.shape[1], window or 0, _scale(d, softmax_scale))
    code = on_current_stream(q.get_device(), lambda stream: PREFILL_LIBRARY.lib()
                             .ds_paged_prefill_attention(*args, stream))
    PREFILL_LIBRARY.check(code, "paged_prefill_attention")
    _count(paged_prefill_attention, quant, alibi)
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.launches_int8 = 0
paged_prefill_attention.launches_alibi = 0
