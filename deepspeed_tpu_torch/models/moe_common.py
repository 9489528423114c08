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

Training: `forward(input_ids, labels=labels)` returns `(causal-LM loss,
aux)` with aux = {"moe_aux_loss": the layers' load-balancing losses summed,
"router_load": (L, E), "router_drop": (L,)}; `moe_loss_fn` adds the aux
loss times its coefficient, as the JAX families' loss functions do. Each
block runs under `torch.utils.checkpoint` when `cfg.remat` and grad mode
hold (the JAX `remat_policy="nothing"`; other policies raise). A block
returns its MoE layer's aux loss and telemetry as outputs, so the ones the
loss uses are those of the forward, not of the recompute; and the noisy
gate's uniforms (`gate_rng`, a `torch.Generator`) are drawn before each
block, so the recompute routes as the forward did. Under ZeRO stage 3 each
block runs on its gathered parameters inside the checkpoint (so the
recompute gathers again) and the forward on the root's
(`runtime/zero/partition.gathered`), as Llama's does; over dp data ranks
the gate routes the global batch (`moe/sharded_moe.py`).

Expert parallelism (serving only): built with `ep_size` > 1 and `ep_rank`,
every MoE layer holds that rank's E/ep experts of each stack and the rest
of the model whole (`moe/layer.py`); its parameter tree is the whole tree
cut over `expert` (`utils/partitioning.shard_tree(tree, ep, rank,
"expert")`), which `load_jax_params` takes and `to_jax_params` gives back.
`llama.init_params` draws each expert stack whole and keeps the rank's
experts, so the shards of one seed are the cuts of the whole module.

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
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache, decode_mask
from deepspeed_tpu_torch.models.common import (
    causal_lm_loss,
    collect_router_metrics,
    shift_labels,
)
from deepspeed_tpu_torch.models.llama import (  # noqa: F401 (to_jax_params: for the families)
    RMSNorm,
    load_jax_params,
    module_state,
    param_tree,
    to_jax_params,
)
from deepspeed_tpu_torch.ops.attention import rope_cos_sin
from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.runtime.zero.partition import gathered


def _block(layer, h, cos_sin, noise):
    """One decoder block's uncached call on its whole parameters
    (gathered at stage 3)."""
    with gathered(layer):
        return layer(h, cos_sin, None, noise)


class MoeForCausalLM(nn.Module):
    """`forward(input_ids)` → logits (B, S, V); `forward(input_ids,
    labels=labels)` → (loss, aux) (module docstring); `forward(input_ids,
    cache=cache)` → (logits, cache) over a dense `KVCache`, the S new
    tokens written at the cursors and the cursors advanced. `logits_at`
    (B,) picks one position per row for the LM head. Subclasses build
    `self.layers` from their block, which exposes its MoE layer as
    `moe`; `ep_size`/`ep_rank` build one expert rank's shard (module
    docstring)."""

    zero3_gathers = True    # the forward gathers ZeRO-3 units (`gathered`)

    def __init__(self, cfg, block_cls, device=None, dtype=torch.float32,
                 ep_size: int = 1, ep_rank: int = 0):
        super().__init__()
        self.ep_size, self.ep_rank = int(ep_size), int(ep_rank)
        if not 0 <= self.ep_rank < self.ep_size:
            raise ValueError(f"ep_rank={self.ep_rank} outside ep_size={self.ep_size}")
        if cfg.attn_impl == "ring":
            raise unported("attn_impl='ring'", "Multi-GPU")
        if cfg.remat and cfg.remat_policy != "nothing":
            raise unported(f"remat_policy={cfg.remat_policy!r}", "Training: the rest")
        factory = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, **factory))
        experts = dict(ep_size=self.ep_size, ep_rank=self.ep_rank)
        self.layers = nn.ModuleList(block_cls(cfg, experts, **factory)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, **factory)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **factory)
        nn.init.normal_(self.embed_tokens, std=0.02)
        nn.init.normal_(self.lm_head.weight, std=0.02)

    def forward(self, input_ids, cache=None, logits_at: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                gate_rng: Optional[torch.Generator] = None):
        with gathered(self):
            return self._forward(input_ids, cache, logits_at, labels, gate_rng)

    def _forward(self, input_ids, cache, logits_at, labels, gate_rng):
        cfg = self.cfg
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
        b, s = input_ids.shape
        positions = torch.arange(s, device=h.device)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        l_aux, loads, drops = [], [], []
        for layer in self.layers:
            noise = layer.moe.draw_gate_noise(b * s, gate_rng)
            if remat:
                h, aux = checkpoint(_block, layer, h, (cos, sin), noise, use_reentrant=False)
            else:
                h, aux = _block(layer, h, (cos, sin), noise)
            l_aux.append(aux[0])
            loads.append(aux[1])
            drops.append(aux[2])
        logits = self._lm_head(self.norm(h))
        if labels is None:
            return logits
        return causal_lm_loss(logits, input_ids, labels), {
            "moe_aux_loss": torch.stack(l_aux).sum(), **collect_router_metrics(loads, drops)}

    def _lm_head(self, h):
        return F.linear(h, self.lm_head.weight.to(self.cfg.dtype))

    # the JAX tree mapping, shared with Llama
    module_state = module_state
    param_tree = param_tree
    load_jax_params = load_jax_params


def moe_block_forward(block, ffn, h, cos_sin, kv=None, gate_noise=None):
    """The pre-norm decoder block both families run: attention, then
    `ffn(h, normed, cached, gate_noise)`, which adds the MoE FFN (and
    whatever the family adds beside it) to h. Returns h and, with `kv`, the
    layer's caches, else the MoE layer's (l_aux, router_load,
    router_drop)."""
    if kv is not None:
        cos, sin, index, mask = cos_sin
        attn, new_kv = block.self_attn(block.input_layernorm(h), cos, sin,
                                       kv=kv, mask=mask, index=index)
        h = h + attn
        return ffn(h, block.post_attention_layernorm(h), True, None), new_kv
    cos, sin = cos_sin
    h = h + block.self_attn(block.input_layernorm(h), cos, sin)
    h = ffn(h, block.post_attention_layernorm(h), False, gate_noise)
    moe = block.moe
    return h, (moe.l_aux, moe.router_load, moe.router_drop)


def moe_loss_fn(coef: float):
    """The engine loss of an MoE family: `loss_fn(module, batch, rng)` with
    labels shifted from `input_ids` when the batch carries none and `rng`
    the noisy gate's generator. Returns (loss + coef * l_aux, {"lm_loss",
    "moe_aux_loss", "router_load", "router_drop"})."""
    def loss_fn(module, batch, rng=None):
        ids = batch["input_ids"]
        labels = batch.get("labels")
        if labels is None:
            labels = shift_labels(ids)
        loss, aux = module(ids, labels=labels, gate_rng=rng)
        l_aux = aux["moe_aux_loss"]
        return loss + coef * l_aux, {"lm_loss": loss, "moe_aux_loss": l_aux,
                                     "router_load": aux["router_load"],
                                     "router_drop": aux["router_drop"]}
    return loss_fn
