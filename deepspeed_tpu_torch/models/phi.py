"""Phi model family (counterpart of ``deepspeed_tpu/models/phi.py``).

A parallel-residual LayerNorm decoder: one LayerNorm feeds both the
attention and the MLP, and their outputs add onto the residual together.
Rotary is partial (only the first `rotary_dim = partial_rotary_factor *
head_dim` dims of each head rotate), every projection carries a bias, the
LM head included, and the MLP is fc1, tanh GELU, fc2. Parameters are f32
at construction, as the JAX package's `param_dtype`; the engines cast them
to their dtype. Compute runs in `PhiConfig.dtype`, with the LayerNorms'
statistics in f32.

phi-2's heads are 80 wide: on the card `attention` runs the flash kernels
at that width, K1-fwd forward and K1-bwd (dq, dk/dv) backward, and the
cached paths the decode kernels (K2 on a dense cache, K3 and K4 on the v2
engine's paged cache).

`forward(input_ids, labels=...)` returns `(loss, {})` for training through
`initialize`, with each block under `torch.utils.checkpoint` when `remat`
is on (the JAX `remat_policy="nothing"`; other policies raise). Under ZeRO
stage 3 across data ranks a block's parameters are gathered inside its
checkpointed function and the root's (embedding, final LayerNorm, head and
its bias) around the whole forward, as in `models/llama.py`. The int8 and
layer-streamed serve modes and tensor parallelism refuse the module
(`resident_bf16_only`). The JAX parameter tree is `embed_tokens`,
`layers/...` stacked on the layer axis, `final_layernorm`, `lm_head` (D, V)
and `lm_head_bias` (V,).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache, decode_mask, update_layer
from deepspeed_tpu_torch.models.common import (
    Dense,
    LayerNorm,
    causal_lm_loss,
    check_zoo_config,
    gathered_block,
    gelu,
    init_zoo,
    make_causal_loss_fn,
)
from deepspeed_tpu_torch.models.llama import (
    load_jax_params,
    param_taker,
    stack_state,
    stack_tree,
    to_jax_params,
)
from deepspeed_tpu_torch.ops.attention import (
    apply_rotary_emb,
    attention,
    cached_attention,
    rope_cos_sin,
)
from deepspeed_tpu_torch.runtime.zero.partition import gathered

__all__ = ["PhiConfig", "PhiForCausalLM", "PRESETS", "phi_config", "phi_loss_fn", "init_phi",
           "load_jax_params", "to_jax_params"]


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 51200
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    partial_rotary_factor: float = 0.5
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    remat: bool = True
    remat_policy: str = "nothing"
    attn_impl: str = "auto"
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.partial_rotary_factor * self.head_dim)


PRESETS = {
    "phi-2": dict(vocab_size=51200, hidden_size=2560, intermediate_size=10240,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=32, max_position_embeddings=2048,
                  partial_rotary_factor=0.4),
    "phi-1_5": dict(vocab_size=51200, hidden_size=2048, intermediate_size=8192,
                    num_hidden_layers=24, num_attention_heads=32,
                    num_key_value_heads=32, max_position_embeddings=2048),
    "phi-tiny": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=4, max_position_embeddings=128,
                     remat=False),
}


def phi_config(name: str, **overrides) -> PhiConfig:
    return PhiConfig(**{**PRESETS[name], **overrides})


def _partial_rope(x, cos, sin, rot: int):
    """Rotary on the first `rot` dims of each head; the rest pass through."""
    if rot >= x.shape[-1]:
        return apply_rotary_emb(x, cos, sin)
    return torch.cat([apply_rotary_emb(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


def rope_tables(cfg, input_ids, index=None, device=None):
    """cos/sin of the rotary dims at the call's positions: 0..S-1, or each
    row's cursor onward when `index` (B,) is given; and the positions."""
    s = input_ids.shape[1]
    positions = torch.arange(s, device=device)
    if index is not None:
        positions = index[:, None] + positions[None, :]
    cos, sin = rope_cos_sin(positions, cfg.rotary_dim, cfg.rope_theta, cfg.dtype)
    return cos, sin, positions


class PhiAttention(nn.Module):
    def __init__(self, cfg: PhiConfig, **factory):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        self.q_proj = Dense(d, nh * hd, True, cfg.dtype, **factory)
        self.k_proj = Dense(d, nkv * hd, True, cfg.dtype, **factory)
        self.v_proj = Dense(d, nkv * hd, True, cfg.dtype, **factory)
        self.dense = Dense(nh * hd, d, True, cfg.dtype, **factory)

    def forward(self, h, cos, sin, kv=None, mask=None, index=None):
        cfg = self.cfg
        hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
        b, s = h.shape[:2]
        rot = cfg.rotary_dim
        q = _partial_rope(self.q_proj(h).reshape(b, s, nh, hd), cos, sin, rot)
        k = _partial_rope(self.k_proj(h).reshape(b, s, nkv, hd), cos, sin, rot)
        v = self.v_proj(h).reshape(b, s, nkv, hd)
        if kv is not None:
            k_cache, v_cache = update_layer(kv[0], kv[1], k, v, index)
            ctx = cached_attention(q, k_cache, v_cache, index, mask, impl=cfg.attn_impl)
            return self.dense(ctx.reshape(b, s, nh * hd)), (k_cache, v_cache)
        ctx = attention(q, k, v, causal=True, impl=cfg.attn_impl)
        return self.dense(ctx.reshape(b, s, nh * hd))


class PhiMLP(nn.Module):
    def __init__(self, cfg: PhiConfig, **factory):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, True, cfg.dtype, **factory)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, True, cfg.dtype, **factory)

    def forward(self, h):
        return self.fc2(gelu(self.fc1(h), approximate=True))


class PhiBlock(nn.Module):
    def __init__(self, cfg: PhiConfig, **factory):
        super().__init__()
        self.input_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype,
                                         **factory)
        self.self_attn = PhiAttention(cfg, **factory)
        self.mlp = PhiMLP(cfg, **factory)

    def forward(self, h, aux, kv=None):
        normed = self.input_layernorm(h)
        if kv is not None:
            cos, sin, index, mask = aux
            attn, new_kv = self.self_attn(normed, cos, sin, kv=kv, mask=mask, index=index)
            return h + attn + self.mlp(normed), new_kv
        cos, sin = aux
        return h + self.self_attn(normed, cos, sin) + self.mlp(normed)


def run_blocks(model, h, input_ids, cache, logits_at, labels, final_norm, lm_head):
    """The zoo decoders' shared body over `model.layers` (blocks called as
    `block(h, aux)` or `block(h, aux, kv=...)`, aux = rotary tables and,
    with a cache, cursors and mask): with a dense `KVCache` or a
    `PagedKVCache`, (logits, cache) with the cursors advanced (`logits_at`
    picks one position a row and the head runs on it alone); without,
    logits, or the causal-LM loss with `labels`, each block on its gathered
    parameters (`gathered_block`), under remat when it is on."""
    cfg = model.cfg
    if cache is not None:
        b, s = input_ids.shape
        index = cache.index
        cos, sin, positions = rope_tables(cfg, input_ids, index, h.device)
        paged = isinstance(cache, PagedKVCache)
        # the paged kernels evaluate their masks from the cursors
        mask = None if paged else decode_mask(positions, cache.max_len)
        for i, layer in enumerate(model.layers):
            kv = cache.layer(i) if paged else (cache.k[i], cache.v[i])
            h, _ = layer(h, (cos, sin, index, mask), kv=kv)
        if logits_at is not None:
            h = h[torch.arange(b, device=h.device), logits_at.long()][:, None]
        logits = lm_head(final_norm(h))
        if logits_at is not None:
            logits = logits[:, 0]
        return logits, cache.replace(index=index + s)
    cos, sin, _ = rope_tables(cfg, input_ids, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.layers:
        h = checkpoint(gathered_block, layer, h, (cos, sin), use_reentrant=False) if remat \
            else gathered_block(layer, h, (cos, sin))
    logits = lm_head(final_norm(h))
    if labels is None:
        return logits
    return causal_lm_loss(logits, input_ids, labels), {}


class PhiForCausalLM(nn.Module):
    """`forward(input_ids)` → logits (B, S, V); `forward(input_ids,
    labels=labels)` → (causal-LM loss, {}); `forward(input_ids,
    cache=cache)` → (logits, cache) with the S new tokens written into the
    cache (a dense `KVCache` or a `PagedKVCache`) at its cursors and the
    cursors advanced. `logits_at` (B,) picks one position per row, and the
    LM head then runs on those rows only: logits (B, V)."""

    zero3_gathers = True        # the forward gathers ZeRO-3 units (`gathered`)
    resident_bf16_only = True   # no int8 or layer-streamed serve mode (module docstring)

    def __init__(self, cfg: PhiConfig, device=None, dtype=torch.float32):
        super().__init__()
        check_zoo_config(cfg)
        factory = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, **factory))
        self.layers = nn.ModuleList(PhiBlock(cfg, **factory)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype,
                                         **factory)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, True, cfg.dtype, **factory)
        nn.init.normal_(self.embed_tokens, std=0.02)

    def forward(self, input_ids, cache=None, logits_at: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None):
        with gathered(self):
            h = F.embedding(input_ids, self.embed_tokens.to(self.cfg.dtype))
            return run_blocks(self, h, input_ids, cache, logits_at, labels,
                              self.final_layernorm, self.lm_head)

    def module_state(self, tree) -> dict:
        """Parameter names → tensors of a JAX tree (torch leaves)."""
        state = {"embed_tokens": tree["embed_tokens"], "lm_head.weight": tree["lm_head"].t(),
                 "lm_head.bias": tree["lm_head_bias"]}
        for key in ("scale", "bias"):
            state[f"final_layernorm.{key}"] = tree["final_layernorm"][key]
        state.update(stack_state("layers", len(self.layers), tree["layers"]))
        return state

    @torch.no_grad()
    def param_tree(self, dtype: Optional[torch.dtype] = None, device=None,
                   release: bool = False) -> dict:
        """This module's weights as a JAX parameter tree of torch tensors
        (`models/llama.py:param_tree`'s arguments)."""
        take = param_taker(dtype, device, release)
        return {"embed_tokens": take(self, "embed_tokens"),
                "layers": stack_tree(self.layers, take),
                "final_layernorm": {k: take(self.final_layernorm, k) for k in ("scale", "bias")},
                "lm_head": take(self.lm_head, "weight").t().contiguous(),
                "lm_head_bias": take(self.lm_head, "bias")}

    def load_jax_params(self, tree) -> "PhiForCausalLM":
        """Copy a JAX parameter tree into this module (`load_jax_params`)."""
        return load_jax_params(self, tree)


def init_phi(cfg: PhiConfig, generator: torch.Generator, device=None,
             dtype=torch.float32, std: float = 0.02) -> PhiForCausalLM:
    """A phi with random weights (`models/common.py:init_zoo`) from
    `generator`, which must live on `device`."""
    return init_zoo(PhiForCausalLM(cfg, device=device, dtype=dtype), generator, std)


def phi_loss_fn(model: Optional[PhiForCausalLM] = None):
    """The engine loss for a phi: `loss_fn(module, batch)` with labels
    shifted from `input_ids` when the batch carries none."""
    return make_causal_loss_fn(model)
