"""GPT-NeoX model family, the pythia lineage (counterpart of
``deepspeed_tpu/models/gptneox.py``).

Two LayerNorms a block whose attention and MLP outputs add onto the
residual in parallel by default (`use_parallel_residual`; False gives the
sequential form), partial rotary (`rotary_pct` of the head dim, phi's
`_partial_rope`), biased projections, an exact (erf) GELU MLP and an untied
`embed_out` head without a bias. Parameters are f32 at construction; the
engines cast them to their dtype. Compute runs in `GPTNeoXConfig.dtype`,
with the LayerNorms' statistics in f32.

pythia-1b's heads are 256 wide: on the card `attention` runs K1-fwd and
K1-bwd and the cached paths K2, K3 and K4 at that width. Like phi, it trains
through `initialize` with remat `"nothing"` and gathers its ZeRO-3 units
(blocks inside their checkpointed functions, the root around the forward;
`phi.run_blocks`), and the int8 and layer-streamed serve modes and tensor
parallelism refuse it (`resident_bf16_only`). The JAX parameter tree is
`embed_in`, `layers/...` stacked on the layer axis, `final_layer_norm` and
`embed_out` (D, V).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.models.common import (
    Dense,
    LayerNorm,
    check_zoo_config,
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
from deepspeed_tpu_torch.models.phi import _partial_rope, run_blocks
from deepspeed_tpu_torch.ops.attention import attention, cached_attention
from deepspeed_tpu_torch.inference.kv_cache import update_layer
from deepspeed_tpu_torch.runtime.zero.partition import gathered

__all__ = ["GPTNeoXConfig", "GPTNeoXForCausalLM", "PRESETS", "gptneox_config",
           "gptneox_loss_fn", "init_gptneox", "load_jax_params", "to_jax_params"]


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50432
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    max_position_embeddings: int = 2048
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    remat: bool = True
    remat_policy: str = "nothing"
    attn_impl: str = "auto"
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.rotary_pct * self.head_dim)

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads


PRESETS = {
    "pythia-1b": dict(vocab_size=50304, hidden_size=2048,
                      intermediate_size=8192, num_hidden_layers=16,
                      num_attention_heads=8),
    "pythia-6.9b": dict(vocab_size=50432, hidden_size=4096,
                        intermediate_size=16384, num_hidden_layers=32,
                        num_attention_heads=32),
    "neox-tiny": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      max_position_embeddings=128, remat=False),
}


def gptneox_config(name: str, **overrides) -> GPTNeoXConfig:
    return GPTNeoXConfig(**{**PRESETS[name], **overrides})


class NeoXAttention(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, **factory):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.q_proj = Dense(d, d, True, cfg.dtype, **factory)
        self.k_proj = Dense(d, d, True, cfg.dtype, **factory)
        self.v_proj = Dense(d, d, True, cfg.dtype, **factory)
        self.dense = Dense(d, d, True, cfg.dtype, **factory)

    def forward(self, h, cos, sin, kv=None, mask=None, index=None):
        cfg = self.cfg
        hd, nh = cfg.head_dim, cfg.num_attention_heads
        b, s = h.shape[:2]
        rot = cfg.rotary_dim
        q = _partial_rope(self.q_proj(h).reshape(b, s, nh, hd), cos, sin, rot)
        k = _partial_rope(self.k_proj(h).reshape(b, s, nh, hd), cos, sin, rot)
        v = self.v_proj(h).reshape(b, s, nh, hd)
        if kv is not None:
            k_cache, v_cache = update_layer(kv[0], kv[1], k, v, index)
            ctx = cached_attention(q, k_cache, v_cache, index, mask, impl=cfg.attn_impl)
            return self.dense(ctx.reshape(b, s, nh * hd)), (k_cache, v_cache)
        ctx = attention(q, k, v, causal=True, impl=cfg.attn_impl)
        return self.dense(ctx.reshape(b, s, nh * hd))


class NeoXMLP(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, **factory):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.dense_h_to_4h = Dense(d, i, True, cfg.dtype, **factory)
        self.dense_4h_to_h = Dense(i, d, True, cfg.dtype, **factory)

    def forward(self, h):
        # HF GPT-NeoX's hidden_act="gelu" is the exact erf GELU
        return self.dense_4h_to_h(gelu(self.dense_h_to_4h(h), approximate=False))


class NeoXBlock(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, **factory):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.parallel = cfg.use_parallel_residual
        self.input_layernorm = LayerNorm(cfg.hidden_size, eps, cfg.dtype, **factory)
        self.post_attention_layernorm = LayerNorm(cfg.hidden_size, eps, cfg.dtype, **factory)
        self.attention = NeoXAttention(cfg, **factory)
        self.mlp = NeoXMLP(cfg, **factory)

    def forward(self, h, aux, kv=None):
        new_kv = None
        if kv is not None:
            cos, sin, index, mask = aux
            attn, new_kv = self.attention(self.input_layernorm(h), cos, sin, kv=kv, mask=mask,
                                          index=index)
        else:
            cos, sin = aux
            attn = self.attention(self.input_layernorm(h), cos, sin)
        if self.parallel:
            h = h + attn + self.mlp(self.post_attention_layernorm(h))
        else:
            h = h + attn
            h = h + self.mlp(self.post_attention_layernorm(h))
        return h if kv is None else (h, new_kv)


class GPTNeoXForCausalLM(nn.Module):
    """`forward(input_ids)` → logits (B, S, V); `forward(input_ids,
    labels=labels)` → (causal-LM loss, {}); `forward(input_ids,
    cache=cache)` → (logits, cache) over a dense `KVCache` or a
    `PagedKVCache`, cursors advanced; `logits_at` (B,) runs the head on
    one position a row: logits (B, V)."""

    zero3_gathers = True        # the forward gathers ZeRO-3 units (`gathered`)
    resident_bf16_only = True   # no int8 or layer-streamed serve mode (module docstring)

    def __init__(self, cfg: GPTNeoXConfig, device=None, dtype=torch.float32):
        super().__init__()
        check_zoo_config(cfg)
        factory = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_in = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, **factory))
        self.layers = nn.ModuleList(NeoXBlock(cfg, **factory)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype,
                                          **factory)
        self.embed_out = Dense(cfg.hidden_size, cfg.vocab_size, False, cfg.dtype, **factory)
        nn.init.normal_(self.embed_in, std=0.02)

    def forward(self, input_ids, cache=None, logits_at: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None):
        with gathered(self):
            h = F.embedding(input_ids, self.embed_in.to(self.cfg.dtype))
            return run_blocks(self, h, input_ids, cache, logits_at, labels,
                              self.final_layer_norm, self.embed_out)

    def module_state(self, tree) -> dict:
        """Parameter names → tensors of a JAX tree (torch leaves)."""
        state = {"embed_in": tree["embed_in"], "embed_out.weight": tree["embed_out"].t()}
        for key in ("scale", "bias"):
            state[f"final_layer_norm.{key}"] = tree["final_layer_norm"][key]
        state.update(stack_state("layers", len(self.layers), tree["layers"]))
        return state

    @torch.no_grad()
    def param_tree(self, dtype: Optional[torch.dtype] = None, device=None,
                   release: bool = False) -> dict:
        """This module's weights as a JAX parameter tree of torch tensors
        (`models/llama.py:param_tree`'s arguments)."""
        take = param_taker(dtype, device, release)
        return {"embed_in": take(self, "embed_in"), "layers": stack_tree(self.layers, take),
                "final_layer_norm": {k: take(self.final_layer_norm, k)
                                     for k in ("scale", "bias")},
                "embed_out": take(self.embed_out, "weight").t().contiguous()}

    def load_jax_params(self, tree) -> "GPTNeoXForCausalLM":
        """Copy a JAX parameter tree into this module (`load_jax_params`)."""
        return load_jax_params(self, tree)


def init_gptneox(cfg: GPTNeoXConfig, generator: torch.Generator, device=None,
                 dtype=torch.float32, std: float = 0.02) -> GPTNeoXForCausalLM:
    """A GPT-NeoX with random weights (`models/common.py:init_zoo`) from
    `generator`, which must live on `device`."""
    return init_zoo(GPTNeoXForCausalLM(cfg, device=device, dtype=dtype), generator, std)


def gptneox_loss_fn(model: Optional[GPTNeoXForCausalLM] = None):
    """The engine loss for a GPT-NeoX: `loss_fn(module, batch)` with labels
    shifted from `input_ids` when the batch carries none."""
    return make_causal_loss_fn(model)
