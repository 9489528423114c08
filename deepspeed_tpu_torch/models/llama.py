"""Llama model family (counterpart of ``deepspeed_tpu/models/llama.py``).

RMSNorm + RoPE + GQA attention + SwiGLU MLP, pre-norm decoder, as
`nn.Module`s. Parameters are f32 at construction, as the JAX package's
`param_dtype`; the inference engine casts them to its dtype. Compute runs in
`LlamaConfig.dtype`, with RMSNorm in f32.

The training knobs of the JAX config (remat, domino, ring attention, loss
and MLP chunking) are not ported yet; they come with training.
`load_jax_params` turns a JAX parameter tree into this module's weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.kv_cache import KVCache, decode_mask, update_layer
from deepspeed_tpu_torch.ops.attention import (
    apply_rotary_emb,
    attention,
    cached_attention,
    rope_cos_sin,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attn_impl: str = "auto"
    attention_qkv_bias: bool = False
    attention_o_bias: bool = False
    sliding_window: Optional[int] = None
    head_dim_override: Optional[int] = None
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads


PRESETS = {
    "llama3-8b": dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                      num_hidden_layers=32, num_attention_heads=32,
                      num_key_value_heads=8, max_position_embeddings=8192,
                      rope_theta=500000.0),
    "llama2-7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=32, num_attention_heads=32,
                      num_key_value_heads=32, max_position_embeddings=4096),
    "llama-1b": dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                     num_hidden_layers=22, num_attention_heads=32,
                     num_key_value_heads=4, max_position_embeddings=4096),
    "llama-tiny": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=128),
}


def llama_config(name: str, **overrides) -> LlamaConfig:
    return LlamaConfig(**{**PRESETS[name], **overrides})


class Dense(nn.Linear):
    """`nn.Linear` that computes in the config's dtype, as flax's
    `nn.Dense(dtype=...)` casts its input and kernel."""

    def __init__(self, in_features, out_features, bias, compute_dtype, **factory):
        super().__init__(in_features, out_features, bias=bias, **factory)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class RMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float, compute_dtype, **factory):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(hidden, **factory))

    def forward(self, x):
        # multiply in f32 by the (placed) weight, then cast
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return ((x32 * torch.rsqrt(var + self.eps)) * self.weight).to(self.compute_dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.cfg = cfg
        hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        qb = cfg.attention_qkv_bias
        self.q_proj = Dense(cfg.hidden_size, nh * hd, qb, cfg.dtype, **factory)
        self.k_proj = Dense(cfg.hidden_size, nkv * hd, qb, cfg.dtype, **factory)
        self.v_proj = Dense(cfg.hidden_size, nkv * hd, qb, cfg.dtype, **factory)
        self.o_proj = Dense(nh * hd, cfg.hidden_size, cfg.attention_o_bias,
                            cfg.dtype, **factory)

    def forward(self, h, cos, sin, kv=None, mask=None, index=None):
        cfg = self.cfg
        hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        b, s = h.shape[:2]
        q = apply_rotary_emb(self.q_proj(h).reshape(b, s, nh, hd), cos, sin)
        k = apply_rotary_emb(self.k_proj(h).reshape(b, s, nkv, hd), cos, sin)
        v = self.v_proj(h).reshape(b, s, nkv, hd)
        if kv is not None:
            # insert the S new tokens at `index`, then attend over the cache
            k_cache, v_cache = update_layer(kv[0], kv[1], k, v, index)
            ctx = cached_attention(q, k_cache, v_cache, index, mask,
                                   impl=cfg.attn_impl, window=cfg.sliding_window)
            return self.o_proj(ctx.reshape(b, s, nh * hd)), (k_cache, v_cache)
        ctx = attention(q, k, v, causal=True, impl=cfg.attn_impl,
                        window=cfg.sliding_window)
        return self.o_proj(ctx.reshape(b, s, nh * hd))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(d, i, False, cfg.dtype, **factory)
        self.up_proj = Dense(d, i, False, cfg.dtype, **factory)
        self.down_proj = Dense(i, d, False, cfg.dtype, **factory)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       cfg.dtype, **factory)
        self.self_attn = LlamaAttention(cfg, **factory)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                cfg.dtype, **factory)
        self.mlp = LlamaMLP(cfg, **factory)

    def forward(self, h, cos_sin, kv=None):
        if kv is not None:
            cos, sin, index, mask = cos_sin
            attn, new_kv = self.self_attn(self.input_layernorm(h), cos, sin,
                                          kv=kv, mask=mask, index=index)
            h = h + attn
            return h + self.mlp(self.post_attention_layernorm(h)), new_kv
        cos, sin = cos_sin
        h = h + self.self_attn(self.input_layernorm(h), cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaForCausalLM(nn.Module):
    """`forward(input_ids)` → logits (B, S, V); `forward(input_ids,
    cache=cache)` → (logits, cache) with the S new tokens written into the
    cache at its cursors and the cursors advanced."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        if cfg.attn_impl == "ring":
            raise NotImplementedError(
                "attn_impl='ring' is not ported to deepspeed_tpu_torch yet: "
                "ROADMAP.md, Queue 1, 'Multi-GPU'")
        factory = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, **factory))
        self.layers = nn.ModuleList(LlamaBlock(cfg, **factory)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, **factory)
        self.lm_head = None if cfg.tie_word_embeddings else Dense(
            cfg.hidden_size, cfg.vocab_size, False, cfg.dtype, **factory)
        nn.init.normal_(self.embed_tokens, std=0.02)

    def forward(self, input_ids, cache: Optional[KVCache] = None):
        cfg = self.cfg
        h = F.embedding(input_ids, self.embed_tokens.to(cfg.dtype))
        if cache is not None:
            b, s = input_ids.shape
            index = cache.index
            positions = index[:, None] + torch.arange(s, device=h.device)[None, :]
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
            mask = decode_mask(positions, cache.max_len, window=cfg.sliding_window)
            for i, layer in enumerate(self.layers):
                h, _ = layer(h, (cos, sin, index, mask), kv=(cache.k[i], cache.v[i]))
            h = self.norm(h)
            return self._lm_head(h), cache.replace(index=index + s)
        positions = torch.arange(input_ids.shape[1], device=h.device)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
        for layer in self.layers:
            h = layer(h, (cos, sin))
        return self._lm_head(self.norm(h))

    def _lm_head(self, h):
        if self.lm_head is None:
            return torch.einsum("bsd,vd->bsv", h, self.embed_tokens.to(self.cfg.dtype))
        return self.lm_head(h)


@torch.no_grad()
def init_params(model: LlamaForCausalLM, generator: torch.Generator,
                std: float = 0.02) -> LlamaForCausalLM:
    """Random weights as the JAX package initialises them: normal(std) for
    the embedding and every kernel, zeros for biases, ones for RMSNorm
    weights. Draws come from `generator`, on the parameters' device."""
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight") or name == "norm.weight":
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=generator)
    return model


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32))
                            ).to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def load_jax_params(model: LlamaForCausalLM, tree) -> LlamaForCausalLM:
    """Copy a JAX `LlamaForCausalLM` parameter tree (nested dicts of numpy
    arrays) into `model`. The scan-stacked `layers/...` leaves carry a
    leading L axis and are split per layer; a flax `Dense` kernel (in, out)
    is transposed into an `nn.Linear` weight (out, in); `lm_head` (D, V) is
    the untied head."""
    model.embed_tokens.copy_(_t(tree["embed_tokens"], model.embed_tokens))
    model.norm.weight.copy_(_t(tree["norm"]["weight"], model.norm.weight))
    if model.lm_head is not None:
        model.lm_head.weight.copy_(_t(np.asarray(tree["lm_head"]).T,
                                      model.lm_head.weight))
    stack = tree["layers"]
    for i, layer in enumerate(model.layers):
        for norm in ("input_layernorm", "post_attention_layernorm"):
            w = getattr(layer, norm).weight
            w.copy_(_t(stack[norm]["weight"][i], w))
        for group, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                dense = getattr(getattr(layer, group), name)
                leaves = stack[group][name]
                dense.weight.copy_(_t(np.asarray(leaves["kernel"][i]).T, dense.weight))
                if dense.bias is not None:
                    dense.bias.copy_(_t(leaves["bias"][i], dense.bias))
    return model
