"""Per-shard serving kernels under tensor parallelism (counterpart of ``deepspeed_tpu/ops/pallas/sharded.py``).

The JAX package puts each serving kernel inside a full-manual `shard_map`
region over the `model` axis, since the partitioner cannot split a
`pallas_call`. Here every rank already holds its own shard (its H/tp query
heads and Hkv/tp KV heads, with their caches and pools), so a per-shard
call is the kernel itself on the rank's local tensors: K2
(`sharded_decode_attention`), K3 (`sharded_paged_decode_attention`) and K4
(`sharded_paged_prefill_attention`). Attention is per head, so none of them
needs a collective, and GQA's head grouping survives because H and Hkv
split by the same factor. Tables, lengths and starts are the same on every
rank; alibi slopes (H/tp,) and int8 scales are the rank's heads' own.

Each wrapper checks that the heads divide tp and that the local shapes are
the rank's share, and counts its CUDA launches in its own `.launches`
(beside the kernel wrapper's own count). A CPU tensor takes the kernel's
plain version, except under a topology whose device is CUDA, where it
raises. `kernel_fallback` is the JAX package's announcement that a sharded
route cannot run: on the CPU it warns once, on CUDA it raises, since the
port has no partitioner to fall back on. `serving_mesh` finds the
topology whose one nontrivial axis is `model` (these wrappers) or `expert`
(the grouped GEMM's expert-parallel flavour, `sharded_grouped_gemm` in
`ops/cuda/grouped_gemm.py`, K8-e, chosen by `moe/layer.gmm_mesh`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.cuda.decode_attention import decode_attention
from deepspeed_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.logging import logger

_WARNED: set = set()


def kernel_fallback(kernel: str, reason: str, device=None) -> None:
    """A sharded route cannot run `kernel`: raise on CUDA, warn once on the
    CPU (whose plain versions need no route)."""
    msg = f"kernel_fallback: {kernel}: {reason}"
    if device is not None and torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"{msg}; on CUDA the port launches the per-shard kernel or raises "
            "(ROADMAP.md, Queue 1, 'Multi-GPU')")
    if (kernel, reason) not in _WARNED:
        _WARNED.add((kernel, reason))
        logger.warning(f"{msg} — using the plain path")


def nontrivial_axes(mesh) -> Dict[str, int]:
    """{axis: size} of a topology's axes with size > 1."""
    if mesh is None:
        return {}
    return {a: n for a, n in mesh.sizes.items() if n > 1}


def serving_mesh(axis: str) -> Tuple[Optional["groups.MeshTopology"], int]:
    """(topology, size of `axis`) when the installed topology's only
    nontrivial axis is `axis`; (None, 1) otherwise."""
    try:
        mesh = groups.get_topology(create_default=False)
    except RuntimeError:
        return None, 1
    nt = nontrivial_axes(mesh)
    if set(nt) != {axis}:
        return None, 1
    return mesh, nt[axis]


def decode_heads_shardable(h: int, hkv: int, tp: int) -> bool:
    """True when the attention kernels can head-shard over a tp-way
    `model` axis: both the query heads and the KV heads must divide."""
    return tp > 1 and h % tp == 0 and hkv % tp == 0


def _check_shard(name: str, mesh, q: torch.Tensor, hkv_local: int,
                 heads: Optional[Tuple[int, int]]) -> None:
    """The rank's share of the heads: `heads` is the model's (H, Hkv),
    by default the local counts times tp."""
    tp = mesh.tp_size
    h_local = q.shape[2]
    h, hkv = heads if heads is not None else (h_local * tp, hkv_local * tp)
    if not decode_heads_shardable(h, hkv, tp):
        raise ValueError(f"{name}: heads (H={h}, Hkv={hkv}) do not shard over model={tp}")
    if (h_local, hkv_local) != (h // tp, hkv // tp):
        raise ValueError(f"{name}: local heads (H={h_local}, Hkv={hkv_local}) are not "
                         f"this rank's share of (H={h}, Hkv={hkv}) over model={tp}")
    if not q.is_cuda and mesh.device is not None and mesh.device.type == "cuda":
        raise ValueError(f"{name}: the topology serves {mesh.device} and q is on "
                         f"{q.device}; a per-shard call runs on the rank's card")


def _counted(fn, q):
    if q.is_cuda:
        fn.launches += 1


def sharded_decode_attention(q, k_cache, v_cache, lengths, mesh,
                             softmax_scale: Optional[float] = None,
                             k_scales=None, v_scales=None,
                             heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K2 on the rank's heads: q (B,1,H/tp,D), dense caches (B,M,Hkv/tp,D)
    (int8 with (B,M,Hkv/tp) scales), lengths (B,) → (B,1,H/tp,D)."""
    _check_shard("sharded_decode_attention", mesh, q, k_cache.shape[2], heads)
    out = decode_attention(q, k_cache, v_cache, lengths, softmax_scale=softmax_scale,
                           k_scales=k_scales, v_scales=v_scales)
    _counted(sharded_decode_attention, q)
    return out


def sharded_paged_decode_attention(q, k_pool, v_pool, tables, lengths, mesh,
                                   softmax_scale: Optional[float] = None,
                                   k_new=None, v_new=None,
                                   window: Optional[int] = None, alibi=None,
                                   k_scales=None, v_scales=None,
                                   heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K3 on the rank's heads: q (B,1,H/tp,D), pools (Hkv/tp,NB,BS,D), the
    staged token (B,Hkv/tp,D), slopes (H/tp,) and int8 scales
    (Hkv/tp,NB,BS) the rank's own; tables (B,T) and lengths (B,) shared."""
    _check_shard("sharded_paged_decode_attention", mesh, q, k_pool.shape[0], heads)
    out = paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                 softmax_scale=softmax_scale, k_new=k_new, v_new=v_new,
                                 window=window, k_scales=k_scales, v_scales=v_scales,
                                 alibi=alibi)
    _counted(sharded_paged_decode_attention, q)
    return out


def sharded_paged_prefill_attention(q, k_pool, v_pool, tables, starts, mesh,
                                    softmax_scale: Optional[float] = None,
                                    window: Optional[int] = None, alibi=None,
                                    k_scales=None, v_scales=None,
                                    heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """K4 on the rank's heads: q (B,S,H/tp,D) over head-sharded pools
    (the layout of `sharded_paged_decode_attention`), starts (B,)."""
    _check_shard("sharded_paged_prefill_attention", mesh, q, k_pool.shape[0], heads)
    out = paged_prefill_attention(q, k_pool, v_pool, tables, starts,
                                  softmax_scale=softmax_scale, window=window,
                                  k_scales=k_scales, v_scales=v_scales, alibi=alibi)
    _counted(sharded_paged_prefill_attention, q)
    return out


sharded_decode_attention.launches = 0
sharded_paged_decode_attention.launches = 0
sharded_paged_prefill_attention.launches = 0
