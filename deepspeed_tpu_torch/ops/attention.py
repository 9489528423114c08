"""Attention ops (counterpart of ``deepspeed_tpu/ops/attention.py``).

Dispatch: on a CUDA tensor, `attention` runs the flash forward kernel
(`ops/cuda/flash_attention.py`) and single-query `cached_attention` runs the
decode kernel (`ops/cuda/decode_attention.py`). A sliding window, alibi, or
`impl="reference"`/`"blockwise"` take the masked paths, as they do in the JAX
package; so does a CPU tensor, as off the TPU there. Layouts are the JAX
package's: q (B, S, H, D), k/v (B, S, Hkv, D), dense caches (B, M, Hkv, D).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.cuda.decode_attention import decode_attention
from deepspeed_tpu_torch.ops.cuda.flash_attention import flash_attention

_MASKED_MAX_LOGITS = 4096 * 4096  # above this, the masked path goes blockwise


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) → (B, S, Hkv*n_rep, D) for grouped-query attention."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def reference_attention(q, k, v, causal: bool = True,
                        segment_mask: Optional[torch.Tensor] = None,
                        softmax_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked softmax attention. q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D).
    Logits in f32, masked with finfo(f32).min; probabilities are cast to q's
    dtype before P·V. `window` bands the causal mask to the last `window`
    keys; `alibi` (H,) adds slopes[h]*key_position to the logits."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = repeat_kv(k, h // hkv)
        v = repeat_kv(v, h // hkv)
    scale = softmax_scale if softmax_scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    sk = k.shape[1]
    neg = torch.finfo(torch.float32).min
    if alibi is not None:
        logits = logits + alibi.float()[None, :, None, None] * \
            torch.arange(sk, dtype=torch.float32, device=q.device)[None, None, None, :]
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        keep = ki <= qi
        if window is not None:
            keep = keep & (ki > qi - window)
        logits = logits.masked_fill(~keep, neg)
    if segment_mask is not None:
        mask = segment_mask[:, None, :, :] if segment_mask.dim() == 3 else segment_mask
        logits = logits.masked_fill(~mask, neg)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_attention(q, k, v, causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        block_q: int = 1024, block_k: int = 1024,
                        window: Optional[int] = None,
                        alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Memory-efficient attention: loops over q and kv blocks with an
    online softmax, so only (block_q, block_k) logits live at once.
    q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D) → (B, Sq, H, D)."""
    b, sq, h, d = q.shape
    hkv, sk = k.shape[2], k.shape[1]
    if hkv != h:
        k = repeat_kv(k, h // hkv)
        v = repeat_kv(v, h // hkv)
    scale = softmax_scale if softmax_scale is not None else 1.0 / (d ** 0.5)
    block_q = min(block_q, sq)
    while sq % block_q:
        block_q -= 1
    block_k = min(block_k, sk)
    while sk % block_k:
        block_k -= 1
    if window is not None and not causal:
        raise ValueError("window requires causal attention")
    offset = sk - sq  # bottom-right-aligned causal
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (b, h, s, d)
    out = torch.empty_like(qt)
    for qi in range(sq // block_q):
        q_blk = qt[:, :, qi * block_q:(qi + 1) * block_q] * scale
        m = torch.full((b, h, block_q, 1), float("-inf"), device=q.device)
        l = torch.zeros((b, h, block_q, 1), device=q.device)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for ki in range(sk // block_k):
            ks = slice(ki * block_k, (ki + 1) * block_k)
            s = torch.einsum("bhqd,bhkd->bhqk", q_blk.float(), kt[:, :, ks].float())
            if alibi is not None:
                kpos = ki * block_k + torch.arange(block_k, dtype=torch.float32,
                                                   device=q.device)
                s = s + alibi.float()[None, :, None, None] * kpos[None, None, None, :]
            if causal:
                rows = offset + qi * block_q + torch.arange(block_q, device=q.device)[:, None]
                cols = ki * block_k + torch.arange(block_k, device=q.device)[None, :]
                keep = cols <= rows
                if window is not None:
                    keep = keep & (cols > rows - window)
                s = s.masked_fill(~keep, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            # fully-masked rows: keep m finite so exp() stays well-defined
            m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
            p = torch.exp(s - m_safe)
            alpha = torch.where(torch.isneginf(m), torch.zeros_like(m),
                                torch.exp(m - m_safe))
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd",
                                             p.to(v.dtype).float(), vt[:, :, ks].float())
            m = m_new
        out[:, :, qi * block_q:(qi + 1) * block_q] = \
            (acc / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)
    return out.transpose(1, 2)


def _masked(q, k, v, causal, softmax_scale, window, alibi, impl):
    if impl == "blockwise" or q.shape[1] * k.shape[1] > _MASKED_MAX_LOGITS:
        return blockwise_attention(q, k, v, causal=causal,
                                   softmax_scale=softmax_scale,
                                   window=window, alibi=alibi)
    return reference_attention(q, k, v, causal=causal,
                               softmax_scale=softmax_scale,
                               window=window, alibi=alibi)


def attention(q, k, v, causal: bool = True, softmax_scale: Optional[float] = None,
              impl: str = "auto", window: Optional[int] = None,
              alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The flash forward kernel on CUDA; the masked paths for a window,
    alibi, `impl="reference"`/`"blockwise"`, or a CPU tensor.
    `impl="pallas"` (the JAX package's name for its kernel) asks for the
    kernel: with a window or alibi it raises, as in the JAX package."""
    if impl == "pallas" and (alibi is not None or window is not None):
        raise NotImplementedError(
            "the flash kernel has no sliding-window band or alibi (ROADMAP.md, "
            "Queue 2, K1-fwd); use impl='auto'/'reference'/'blockwise'")
    use_kernel = impl == "pallas" or (impl == "auto" and q.is_cuda)
    if alibi is not None or window is not None or not use_kernel:
        return _masked(q, k, v, causal, softmax_scale, window, alibi, impl)
    return flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale)


def cached_attention(q, k_cache, v_cache, index, mask, impl: str = "auto",
                     window: Optional[int] = None,
                     alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of new tokens against a dense static KV cache.

    q: (B, S, H, D); caches (B, M, Hkv, D); index (B,) pre-insert cursors;
    mask (B, S, M) validity over cache slots. A single-query call on CUDA
    with no window or alibi runs the decode kernel over slots
    [0, index + 1) — the new token is written before attention — which
    assumes the prefix mask `kv_cache.decode_mask` makes; `impl="reference"`
    forces the masked path. Prefill (S > 1) and the CPU take the masked path.
    """
    if alibi is not None:
        return reference_attention(q, k_cache, v_cache, causal=False,
                                   segment_mask=mask, alibi=alibi)
    if impl == "decode_pallas" and window is not None:
        raise NotImplementedError(
            "the decode kernel is prefix-mask-only (ROADMAP.md, Queue 2, K2); "
            "a sliding window needs the masked path (impl='auto'/'reference')")
    if window is None and q.shape[1] == 1 and q.is_cuda and impl != "reference":
        return decode_attention(q, k_cache, v_cache, (index + 1).to(torch.int32))
    return reference_attention(q, k_cache, v_cache, causal=False,
                               segment_mask=mask)


def rms_norm_ref(x, weight, eps: float = 1e-6):
    """RMSNorm reference: normalise in f32, cast, then multiply."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0,
                 dtype=torch.float32):
    """cos/sin tables for rotary embedding; positions (B, S) or (S,),
    computed in f32 and cast to `dtype`."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    angles = positions[..., None].float() * inv_freq  # (..., S, D/2)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary_emb(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
