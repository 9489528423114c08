"""What the MoE decoder families share (`models/qwen2_moe.py`, `models/mixtral.py`).

`MoeForCausalLM` is the Llama decoder with an MoE block: the embedding,
the dense-cache and uncached forwards, the untied LM head, and the JAX
parameter-tree mapping. The JAX package writes the two families out in
full; the port keeps one copy of what they share.

Two semantics, as in the JAX package: the cached path (`cache=`, what
`generate` runs) routes with no capacity limit (`drop_tokens=False`,
`train=False`, so `auto` takes the grouped GEMM from 1024 rows), and the
uncached path is the training semantics whatever torch's grad mode is
(`drop_tokens=True` at the config's capacity factor, `train=True`: the
ragged buffer, which drops tokens over capacity). So `forward` and a cached
prefill of the same tokens differ by design wherever a token is dropped.

Parameter trees: the JAX layout, mapped by `models/llama.py`'s
`module_state`/`param_tree`: per-layer leaves stacked on a leading L axis,
a flax `Dense` kernel (in, out) an `nn.Linear` weight (out, in) transposed,
the router `wg` (D, E) and the expert stacks (E, D, F) / (E, F, D) kept as
they are, `lm_head` (D, V) the head transposed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache, decode_mask
from deepspeed_tpu_torch.models.llama import (  # noqa: F401 (to_jax_params: for the families)
    RMSNorm,
    load_jax_params,
    module_state,
    param_tree,
    to_jax_params,
)
from deepspeed_tpu_torch.ops.attention import rope_cos_sin
from deepspeed_tpu_torch.runtime.config_utils import unported


class MoeForCausalLM(nn.Module):
    """`forward(input_ids)` → logits (B, S, V); `forward(input_ids,
    cache=cache)` → (logits, cache) over a dense `KVCache`, the S new
    tokens written at the cursors and the cursors advanced. `logits_at`
    (B,) picks one position per row for the LM head. Subclasses build
    `self.layers` from their block."""

    def __init__(self, cfg, block_cls, device=None, dtype=torch.float32):
        super().__init__()
        if cfg.attn_impl == "ring":
            raise unported("attn_impl='ring'", "Multi-GPU")
        factory = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, **factory))
        self.layers = nn.ModuleList(block_cls(cfg, **factory)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, **factory)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **factory)
        nn.init.normal_(self.embed_tokens, std=0.02)
        nn.init.normal_(self.lm_head.weight, std=0.02)

    def forward(self, input_ids, cache=None, logits_at: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None):
        cfg = self.cfg
        if labels is not None:
            raise unported("MoE training (labels=, the router aux loss)", "MoE: the rest")
        h = F.embedding(input_ids, self.embed_tokens.to(cfg.dtype))
        if cache is not None:
            if isinstance(cache, PagedKVCache):
                raise unported("v2 FastGen with an MoE model (a paged cache)",
                               "MoE: the rest")
            b, s = input_ids.shape
            index = cache.index
            positions = index[:, None] + torch.arange(s, device=h.device)[None, :]
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
            mask = decode_mask(positions, cache.max_len)
            for i, layer in enumerate(self.layers):
                h, _ = layer(h, (cos, sin, index, mask), kv=(cache.k[i], cache.v[i]))
            if logits_at is not None:
                h = h[torch.arange(b, device=h.device), logits_at.long()][:, None]
            logits = self._lm_head(self.norm(h))
            if logits_at is not None:
                logits = logits[:, 0]
            return logits, cache.replace(index=index + s)
        positions = torch.arange(input_ids.shape[1], device=h.device)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
        for layer in self.layers:
            h = layer(h, (cos, sin))
        return self._lm_head(self.norm(h))

    def _lm_head(self, h):
        return F.linear(h, self.lm_head.weight.to(self.cfg.dtype))

    # the JAX tree mapping, shared with Llama
    module_state = module_state
    param_tree = param_tree
    load_jax_params = load_jax_params


def moe_block_forward(block, ffn, h, cos_sin, kv=None):
    """The pre-norm decoder block both families run: attention, then
    `ffn(h, normed, cached)`, which adds the MoE FFN (and whatever the
    family adds beside it) to h. Returns h, and with `kv` the layer's
    caches."""
    if kv is not None:
        cos, sin, index, mask = cos_sin
        attn, new_kv = block.self_attn(block.input_layernorm(h), cos, sin,
                                       kv=kv, mask=mask, index=index)
        h = h + attn
        return ffn(h, block.post_attention_layernorm(h), True), new_kv
    cos, sin = cos_sin
    h = h + block.self_attn(block.input_layernorm(h), cos, sin)
    return ffn(h, block.post_attention_layernorm(h), False)
