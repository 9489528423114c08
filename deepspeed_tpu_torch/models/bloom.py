"""BLOOM model family (counterpart of ``deepspeed_tpu/models/bloom.py``).

A sequential-residual LayerNorm decoder with ALiBi positional bias instead
of rotary, an embedding LayerNorm, biased projections, a tanh GELU MLP and
an LM head tied to the word embeddings. Parameters are f32 at
construction, as the JAX package's `param_dtype`; the engines cast them to
their dtype. Compute runs in `BloomConfig.dtype`, with the LayerNorms'
statistics in f32.

Attention takes the alibi slopes (`ops/attention.py:alibi_slopes`): the
uncached forward and a dense cache take the masked paths, as in the JAX
package, and a paged cache (the v2 engine's) the paged kernels' alibi
forms (K3-alibi, K4-alibi).

`forward(input_ids, labels=...)` returns `(loss, {})`, with each block under
`torch.utils.checkpoint` when `remat` is on (the JAX
`remat_policy="nothing"`; other policies raise). Under ZeRO stage 3 across
data ranks a block's parameters are gathered inside its checkpointed
function and the root's (the embedding, which is also the head, and the
two LayerNorms outside the blocks) around the whole forward, as in
`models/llama.py`; the blocks are `h` (`runtime/zero/partition.py`'s
`BLOCK_LISTS`). The JAX parameter tree is
`word_embeddings`, `word_embeddings_layernorm`, `h/...` stacked on the layer
axis and `ln_f`; the tied head is the embedding, one tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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
from deepspeed_tpu_torch.ops.attention import alibi_slopes, attention, cached_attention
from deepspeed_tpu_torch.runtime.zero.partition import gathered

__all__ = ["BloomConfig", "BloomForCausalLM", "PRESETS", "bloom_config", "bloom_loss_fn",
           "init_bloom", "load_jax_params", "to_jax_params"]


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    max_position_embeddings: int = 2048
    layer_norm_epsilon: float = 1e-5
    remat: bool = True
    remat_policy: str = "nothing"
    attn_impl: str = "auto"
    dtype: Any = torch.bfloat16
    # the v2 engine's automatic cache layout reads this
    uses_alibi: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads


PRESETS = {
    "bloom-560m": dict(vocab_size=250880, hidden_size=1024,
                       num_hidden_layers=24, num_attention_heads=16),
    "bloom-7b1": dict(vocab_size=250880, hidden_size=4096,
                      num_hidden_layers=30, num_attention_heads=32),
    "bloom-tiny": dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=128,
                       remat=False),
}


def bloom_config(name: str, **overrides) -> BloomConfig:
    return BloomConfig(**{**PRESETS[name], **overrides})


class BloomAttention(nn.Module):
    def __init__(self, cfg: BloomConfig, **factory):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.q_proj = Dense(d, d, True, cfg.dtype, **factory)
        self.k_proj = Dense(d, d, True, cfg.dtype, **factory)
        self.v_proj = Dense(d, d, True, cfg.dtype, **factory)
        self.dense = Dense(d, d, True, cfg.dtype, **factory)

    def forward(self, h, slopes, kv=None, mask=None, index=None):
        cfg = self.cfg
        hd, nh = cfg.head_dim, cfg.num_attention_heads
        b, s = h.shape[:2]
        q = self.q_proj(h).reshape(b, s, nh, hd)
        k = self.k_proj(h).reshape(b, s, nh, hd)
        v = self.v_proj(h).reshape(b, s, nh, hd)
        if kv is not None:
            k_cache, v_cache = update_layer(kv[0], kv[1], k, v, index)
            ctx = cached_attention(q, k_cache, v_cache, index, mask,
                                   impl=cfg.attn_impl, alibi=slopes)
            return self.dense(ctx.reshape(b, s, nh * hd)), (k_cache, v_cache)
        ctx = attention(q, k, v, causal=True, impl=cfg.attn_impl, alibi=slopes)
        return self.dense(ctx.reshape(b, s, nh * hd))


class BloomMLP(nn.Module):
    def __init__(self, cfg: BloomConfig, **factory):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.dense_h_to_4h = Dense(d, i, True, cfg.dtype, **factory)
        self.dense_4h_to_h = Dense(i, d, True, cfg.dtype, **factory)

    def forward(self, h):
        # flax's nn.gelu(approximate=True)
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(h), approximate="tanh"))


class BloomBlock(nn.Module):
    def __init__(self, cfg: BloomConfig, **factory):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.input_layernorm = LayerNorm(cfg.hidden_size, eps, cfg.dtype, **factory)
        self.self_attention = BloomAttention(cfg, **factory)
        self.post_attention_layernorm = LayerNorm(cfg.hidden_size, eps, cfg.dtype,
                                                  **factory)
        self.mlp = BloomMLP(cfg, **factory)

    def forward(self, h, aux, kv=None):
        if kv is not None:
            slopes, index, mask = aux
            attn, new_kv = self.self_attention(self.input_layernorm(h), slopes, kv=kv,
                                               mask=mask, index=index)
            h = h + attn
            return h + self.mlp(self.post_attention_layernorm(h)), new_kv
        h = h + self.self_attention(self.input_layernorm(h), aux)
        return h + self.mlp(self.post_attention_layernorm(h))


class BloomForCausalLM(nn.Module):
    """`forward(input_ids)` → logits (B, S, V); `forward(input_ids,
    labels=labels)` → (causal-LM loss, {}); `forward(input_ids,
    cache=cache)` → (logits, cache) with the S new tokens written into the
    cache (a dense `KVCache` or a `PagedKVCache`) at its cursors and the
    cursors advanced. `logits_at` (B,) picks one position per row, and the
    LM head then runs on those rows only: logits (B, V)."""

    zero3_gathers = True    # the forward gathers ZeRO-3 units (`gathered`)

    def __init__(self, cfg: BloomConfig, device=None, dtype=torch.float32):
        super().__init__()
        check_zoo_config(cfg)
        factory = dict(device=device, dtype=dtype)
        eps = cfg.layer_norm_epsilon
        self.cfg = cfg
        self.word_embeddings = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, **factory))
        self.word_embeddings_layernorm = LayerNorm(cfg.hidden_size, eps, cfg.dtype,
                                                   **factory)
        self.h = nn.ModuleList(BloomBlock(cfg, **factory)
                               for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, eps, cfg.dtype, **factory)
        nn.init.normal_(self.word_embeddings, std=0.02)
        self._slopes: Dict[torch.device, torch.Tensor] = {}

    def slopes(self, device) -> torch.Tensor:
        """The (H,) f32 alibi slopes on `device`, made once per device (a
        float buffer would follow the module's cast to bf16)."""
        device = torch.device(device)
        if device not in self._slopes:
            self._slopes[device] = alibi_slopes(self.cfg.num_attention_heads, device)
        return self._slopes[device]

    def forward(self, input_ids, cache=None, logits_at: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None):
        with gathered(self):
            return self._forward(input_ids, cache, logits_at, labels)

    def _forward(self, input_ids, cache, logits_at, labels):
        cfg = self.cfg
        h = F.embedding(input_ids, self.word_embeddings.to(cfg.dtype))
        h = self.word_embeddings_layernorm(h)
        slopes = self.slopes(h.device)
        if cache is not None:
            b, s = input_ids.shape
            index = cache.index
            paged = isinstance(cache, PagedKVCache)
            # the paged kernels evaluate their masks from the cursors
            mask = None if paged else decode_mask(
                index[:, None] + torch.arange(s, device=h.device)[None, :], cache.max_len)
            for i, layer in enumerate(self.h):
                kv = cache.layer(i) if paged else (cache.k[i], cache.v[i])
                h, _ = layer(h, (slopes, index, mask), kv=kv)
            if logits_at is not None:
                h = h[torch.arange(b, device=h.device), logits_at.long()][:, None]
            logits = self._lm_head(self.ln_f(h))
            if logits_at is not None:
                logits = logits[:, 0]
            return logits, cache.replace(index=index + s)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.h:
            h = checkpoint(gathered_block, layer, h, slopes, use_reentrant=False) if remat \
                else gathered_block(layer, h, slopes)
        logits = self._lm_head(self.ln_f(h))
        if labels is None:
            return logits
        return causal_lm_loss(logits, input_ids, labels), {}

    def _lm_head(self, h):
        # BLOOM ties the LM head to the word embeddings
        return torch.einsum("bsd,vd->bsv", h, self.word_embeddings.to(self.cfg.dtype))

    def module_state(self, tree) -> dict:
        """Parameter names → tensors of a JAX tree (torch leaves)."""
        state = {"word_embeddings": tree["word_embeddings"]}
        for ln in ("word_embeddings_layernorm", "ln_f"):
            for key in ("scale", "bias"):
                state[f"{ln}.{key}"] = tree[ln][key]
        state.update(stack_state("h", len(self.h), tree["h"]))
        return state

    @torch.no_grad()
    def param_tree(self, dtype: Optional[torch.dtype] = None, device=None,
                   release: bool = False) -> dict:
        """This module's weights as a JAX parameter tree of torch tensors
        (`models/llama.py:param_tree`'s arguments)."""
        take = param_taker(dtype, device, release)

        def ln(module):
            return {key: take(module, key) for key in ("scale", "bias")}

        return {"word_embeddings": take(self, "word_embeddings"),
                "word_embeddings_layernorm": ln(self.word_embeddings_layernorm),
                "h": stack_tree(self.h, take), "ln_f": ln(self.ln_f)}

    def load_jax_params(self, tree) -> "BloomForCausalLM":
        """Copy a JAX parameter tree into this module (`load_jax_params`)."""
        return load_jax_params(self, tree)


@torch.no_grad()
def init_bloom(cfg: BloomConfig, generator: torch.Generator, device=None,
               dtype=torch.float32, std: float = 0.02) -> BloomForCausalLM:
    """A BLOOM with random weights as the JAX package initialises them:
    normal(std) for the embedding and every kernel, zeros for the biases,
    ones for the LayerNorm scales. Draws come from `generator`, which must
    live on `device`."""
    return init_zoo(BloomForCausalLM(cfg, device=device, dtype=dtype), generator, std)


def bloom_loss_fn(model: Optional[BloomForCausalLM] = None):
    """The engine loss for a BLOOM: `loss_fn(module, batch)` with labels
    shifted from `input_ids` when the batch carries none."""
    return make_causal_loss_fn(model)
