"""Serving byte accounting (counterpart of the accounting half of ``deepspeed_tpu/inference/capacity_scan.py``).

The KV-cache and decode-workspace formulas that `config.choose_serve_mode`
and `kv_block_manager.model_kv_budget` read. The capacity serve mode itself
(`CapacityRunner`, host-parked layers streamed per step) is not ported
(ROADMAP.md, Queue 1, 'The rest').
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

CACHE_LEN_MULTIPLE = 128


def round_up_len(n: int) -> int:
    """Cache-length rounding shared with the generate loops."""
    return -(-int(n) // CACHE_LEN_MULTIPLE) * CACHE_LEN_MULTIPLE


def _model_dims(model_cfg) -> Dict[str, int]:
    from deepspeed_tpu_torch.inference.engine import _cache_dims
    layers, hkv, hd = _cache_dims(model_cfg)
    hidden = getattr(model_cfg, "hidden_size", None) or getattr(model_cfg, "n_embd")
    inter = getattr(model_cfg, "intermediate_size", None) or 4 * hidden
    return {"layers": layers, "kv_heads": hkv, "head_dim": hd,
            "hidden": int(hidden), "inter": int(inter),
            "vocab": int(getattr(model_cfg, "vocab_size"))}


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kv_cache_bytes(model_cfg, batch: int, max_len: int, dtype,
                   kv_dtype: Optional[str] = None) -> int:
    """K + V cache bytes for a (batch, max_len) generate. `kv_dtype="int8"`
    is the quantized cache: one byte per element plus one f32 scale per
    (kv head, token slot); otherwise `dtype`'s width."""
    d = _model_dims(model_cfg)
    slots = 2 * d["layers"] * batch * max_len * d["kv_heads"]
    if kv_dtype in ("int8", torch.int8):
        return slots * (d["head_dim"] + 4)
    return slots * d["head_dim"] * _itemsize(dtype)


def decode_workspace_bytes(model_cfg, batch: int, max_len: int, dtype) -> int:
    """Activation bytes a generate keeps beside weights and KV: 2·hidden +
    2·inter per token position up to max_len, plus one f32 logits row per
    sequence."""
    d = _model_dims(model_cfg)
    return (batch * max_len * (2 * d["hidden"] + 2 * d["inter"]) * _itemsize(dtype)
            + batch * d["vocab"] * 4)
