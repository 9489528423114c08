"""Qwen2-MoE model family (counterpart of ``deepspeed_tpu/models/qwen2_moe.py``).

The Qwen1.5-MoE-A2.7B lineage: Llama attention with qkv biases, and an MoE
FFN beside a shared expert, a dense SwiGLU applied to every token and
gated per token by sigmoid(shared_expert_gate(h)). The router keeps the raw
softmax top-k weights (`norm_topk_prob=False`, HF's default for the
family). The decoder, its two routing semantics (cached: no drops; uncached:
the training semantics, with drops), training (labels, the aux loss, remat)
and the parameter-tree mapping are `models/moe_common.py`;
`qwen2_moe_loss_fn` is the engine loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.models.common import Dense
from deepspeed_tpu_torch.models.llama import LlamaAttention, LlamaConfig, RMSNorm
from deepspeed_tpu_torch.models.moe_common import (
    MoeForCausalLM,
    load_jax_params,
    moe_block_forward,
    moe_loss_fn,
    param_tree,
    to_jax_params,
)
from deepspeed_tpu_torch.moe.layer import MoE

__all__ = ["Qwen2MoeConfig", "Qwen2MoeForCausalLM", "qwen2_moe_config", "qwen2_moe_loss_fn",
           "load_jax_params", "param_tree", "to_jax_params"]


@dataclasses.dataclass(frozen=True)
class Qwen2MoeConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 60
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    norm_topk_prob: bool = False
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    max_position_embeddings: int = 8192
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    remat: bool = True
    remat_policy: str = "nothing"
    attn_impl: str = "auto"
    # MoE dispatch: 'auto' | 'gmm' | 'ragged' | 'einsum' (moe/layer.py)
    dispatch_impl: str = "auto"
    head_dim_override: Any = None
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads


PRESETS = {
    "qwen1.5-moe-a2.7b": dict(),
    "qwen2moe-tiny": dict(vocab_size=256, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, num_experts=4,
                          num_experts_per_tok=2, moe_intermediate_size=32,
                          shared_expert_intermediate_size=128,
                          max_position_embeddings=128, remat=False),
}


def qwen2_moe_config(name: str, **overrides) -> Qwen2MoeConfig:
    return Qwen2MoeConfig(**{**PRESETS[name], **overrides})


def _as_llama(cfg: Qwen2MoeConfig) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.shared_expert_intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
        attention_qkv_bias=True,  # the Qwen2 attention variant
        remat=cfg.remat, attn_impl=cfg.attn_impl,
        head_dim_override=cfg.head_dim_override, dtype=cfg.dtype)


class SharedExpert(nn.Module):
    """Dense SwiGLU applied to every token, sigmoid-gated per token."""

    def __init__(self, cfg: Qwen2MoeConfig, **factory):
        super().__init__()
        d, f, dt = cfg.hidden_size, cfg.shared_expert_intermediate_size, cfg.dtype
        self.gate_proj = Dense(d, f, False, dt, **factory)
        self.up_proj = Dense(d, f, False, dt, **factory)
        self.down_proj = Dense(f, d, False, dt, **factory)
        self.shared_expert_gate = Dense(d, 1, False, dt, **factory)

    def forward(self, h):
        out = self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))
        g = self.shared_expert_gate(h)
        return torch.sigmoid(g.float()).to(out.dtype) * out


class Qwen2MoeBlock(nn.Module):
    def __init__(self, cfg: Qwen2MoeConfig, experts: Optional[dict] = None, **factory):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, **factory)
        self.self_attn = LlamaAttention(_as_llama(cfg), **factory)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                cfg.dtype, **factory)
        self.mlp = MoE(hidden_size=cfg.hidden_size, num_experts=cfg.num_experts,
                       k=cfg.num_experts_per_tok, intermediate_size=cfg.moe_intermediate_size,
                       capacity_factor=cfg.capacity_factor, drop_tokens=True,
                       norm_topk_prob=cfg.norm_topk_prob, dispatch_impl=cfg.dispatch_impl,
                       dtype=cfg.dtype, device=factory["device"], param_dtype=factory["dtype"],
                       **(experts or {}))
        self.shared_expert = SharedExpert(cfg, **factory)

    @property
    def moe(self) -> MoE:
        return self.mlp

    def forward(self, h, cos_sin, kv=None, gate_noise=None):
        def ffn(h, normed, cached, noise):
            moe = self.mlp(normed, train=not cached, drop_tokens=not cached, gate_noise=noise)
            return h + moe + self.shared_expert(normed)
        return moe_block_forward(self, ffn, h, cos_sin, kv, gate_noise)


class Qwen2MoeForCausalLM(MoeForCausalLM):
    """Qwen2-MoE decoder; see `models/moe_common.MoeForCausalLM`."""

    def __init__(self, cfg: Qwen2MoeConfig, device=None, dtype=torch.float32,
                 ep_size: int = 1, ep_rank: int = 0):
        super().__init__(cfg, Qwen2MoeBlock, device=device, dtype=dtype, ep_size=ep_size,
                         ep_rank=ep_rank)


def qwen2_moe_loss_fn(model: Qwen2MoeForCausalLM, aux_coef: Optional[float] = None):
    """The engine loss: causal-LM loss + coef·l_aux, coef the config's
    `router_aux_loss_coef` unless `aux_coef` is given; aux {"lm_loss",
    "moe_aux_loss", "router_load", "router_drop"}."""
    return moe_loss_fn(aux_coef if aux_coef is not None else model.cfg.router_aux_loss_coef)
