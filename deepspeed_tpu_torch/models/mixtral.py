"""Mixtral-style MoE decoder (counterpart of ``deepspeed_tpu/models/mixtral.py``).

Llama attention blocks (no qkv bias) with a top-2 MoE FFN,
`block_sparse_moe`, whose top-k weights are renormalized over the kept
experts. The cached path routes with no drops at capacity factor 1.0, the
uncached one at the config's capacity factor with drops, as in the JAX
package; the decoder, training (labels, the aux loss, remat) and the
parameter-tree mapping are `models/moe_common.py`; `mixtral_loss_fn` is the
engine loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

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

__all__ = ["MixtralConfig", "MixtralForCausalLM", "mixtral_config", "mixtral_loss_fn",
           "load_jax_params", "param_tree", "to_jax_params"]


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    max_position_embeddings: int = 4096
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-5
    router_aux_loss_coef: float = 0.02
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
    "mixtral-8x7b": dict(),
    "mixtral-tiny": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, num_local_experts=4,
                         num_experts_per_tok=2, max_position_embeddings=128,
                         remat=False),
}


def mixtral_config(name: str, **overrides) -> MixtralConfig:
    return MixtralConfig(**{**PRESETS[name], **overrides})


def _as_llama(cfg: MixtralConfig) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
        remat=cfg.remat, attn_impl=cfg.attn_impl,
        head_dim_override=cfg.head_dim_override, dtype=cfg.dtype)


class MixtralBlock(nn.Module):
    def __init__(self, cfg: MixtralConfig, experts: Optional[dict] = None, **factory):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, **factory)
        self.self_attn = LlamaAttention(_as_llama(cfg), **factory)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                cfg.dtype, **factory)
        # the uncached MoE's settings; the cached call overrides the drops
        # (with no drops the capacity factor has no effect)
        self.block_sparse_moe = MoE(
            hidden_size=cfg.hidden_size, num_experts=cfg.num_local_experts,
            k=cfg.num_experts_per_tok, intermediate_size=cfg.intermediate_size,
            capacity_factor=cfg.capacity_factor, dispatch_impl=cfg.dispatch_impl,
            dtype=cfg.dtype, device=factory["device"], param_dtype=factory["dtype"],
            **(experts or {}))

    @property
    def moe(self) -> MoE:
        return self.block_sparse_moe

    def forward(self, h, cos_sin, kv=None, gate_noise=None):
        def ffn(h, normed, cached, noise):
            return h + self.block_sparse_moe(normed, train=not cached,
                                             drop_tokens=not cached, gate_noise=noise)
        return moe_block_forward(self, ffn, h, cos_sin, kv, gate_noise)


class MixtralForCausalLM(MoeForCausalLM):
    """Mixtral decoder; see `models/moe_common.MoeForCausalLM`."""

    def __init__(self, cfg: MixtralConfig, device=None, dtype=torch.float32,
                 ep_size: int = 1, ep_rank: int = 0):
        super().__init__(cfg, MixtralBlock, device=device, dtype=dtype, ep_size=ep_size,
                         ep_rank=ep_rank)


def mixtral_loss_fn(model: MixtralForCausalLM, aux_coef: Optional[float] = None):
    """The engine loss: causal-LM loss + coef·l_aux, coef the config's
    `router_aux_loss_coef` unless `aux_coef` is given; aux {"lm_loss",
    "moe_aux_loss", "router_load", "router_drop"}."""
    return moe_loss_fn(aux_coef if aux_coef is not None else model.cfg.router_aux_loss_coef)
