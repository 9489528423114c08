"""Llama model family (counterpart of ``deepspeed_tpu/models/llama.py``).

RMSNorm + RoPE + GQA attention + SwiGLU MLP, pre-norm decoder, as
`nn.Module`s. Parameters are f32 at construction, as the JAX package's
`param_dtype`; the engines cast them to their dtype. Compute runs in
`LlamaConfig.dtype`, with RMSNorm in f32.

`forward(input_ids, labels=...)` returns `(loss, {})` for training, with
each block under `torch.utils.checkpoint` when `remat` is on (the JAX
`remat_policy="nothing"`: the whole block is recomputed in backward).
Under ZeRO stage 3 across data ranks (`runtime/zero/partition.py`) a
block's parameters are gathered inside its checkpointed function, so the
recompute gathers them again and the checkpoint holds only the rank's
pieces, and the root's (embedding, final norm, head) around the whole
forward: at most one block's gathered weights live beside the root's. The
other remat policies, domino, ring attention and loss or MLP chunking are
not ported and raise. `load_jax_params` turns a JAX parameter tree into this
module's weights and `to_jax_params` turns them back.

Tensor parallelism (serving only): built with `tp_size` > 1, the module
holds one rank's shard in the Megatron layout the JAX package's logical
axes give (`utils/partitioning.py`): H/tp and Hkv/tp heads (q/k/v
column-parallel, o_proj row-parallel), intermediate/tp MLP columns
(gate/up column-parallel, down_proj row-parallel), V/tp rows of the
embedding (a vocab-parallel lookup) and V/tp columns of the head, whose
logits are gathered on every rank. Each row-parallel output is all-reduced
over the `model` group before its bias. `init_params` draws every weight
at its whole shape, as a tp = 1 module does, and keeps the rank's slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache, decode_mask, update_layer
from deepspeed_tpu_torch.models.common import (
    Dense,
    causal_lm_loss,
    gather_vocab,
    gathered_block,
    make_causal_loss_fn,
    vocab_parallel_embedding,
)
from deepspeed_tpu_torch.ops.attention import (
    apply_rotary_emb,
    attention,
    cached_attention,
    rope_cos_sin,
)
from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.runtime.zero.partition import gathered


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
    remat: bool = True
    # 'nothing' recomputes the whole block in backward; the JAX package's
    # other policies save or offload chosen tensors and are not ported
    remat_policy: str = "nothing"
    attn_impl: str = "auto"
    loss_chunk_size: Optional[int] = None
    mlp_chunk_size: Optional[int] = None
    attention_qkv_bias: bool = False
    attention_o_bias: bool = False
    domino: bool = False
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
                       num_key_value_heads=2, max_position_embeddings=128,
                       remat=False),
}


def llama_config(name: str, **overrides) -> LlamaConfig:
    return LlamaConfig(**{**PRESETS[name], **overrides})


def check_ported(cfg: LlamaConfig, tp: int = 1) -> None:
    """Raise on the config values this port does not run (`tp`: the
    tensor-parallel degree the module is built for)."""
    if cfg.attn_impl == "ring":
        raise unported("attn_impl='ring'", "Multi-GPU")
    if tp > 1 and cfg.sliding_window is not None:
        raise unported(f"sliding_window under tensor parallelism (tp={tp})", "Multi-GPU")
    if tp > 1 and (cfg.num_attention_heads % tp or cfg.num_key_value_heads % tp
                   or cfg.intermediate_size % tp or cfg.vocab_size % tp):
        raise ValueError(
            f"tensor parallelism tp={tp} needs the heads (H={cfg.num_attention_heads}, "
            f"Hkv={cfg.num_key_value_heads}), intermediate_size={cfg.intermediate_size} "
            f"and vocab_size={cfg.vocab_size} to divide it")
    if cfg.remat and cfg.remat_policy != "nothing":
        raise unported(f"remat_policy={cfg.remat_policy!r}", "Training: the rest")
    for name in ("loss_chunk_size", "mlp_chunk_size"):
        if getattr(cfg, name):
            raise unported(name, "Training: the rest")
    if cfg.domino:
        raise unported("domino", "Training: the rest")


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
    """GQA attention over this rank's H/tp query and Hkv/tp KV heads."""

    def __init__(self, cfg: LlamaConfig, tp: int = 1, **factory):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.heads = (cfg.num_attention_heads // tp, cfg.num_key_value_heads // tp)
        nh, nkv = self.heads
        qb = cfg.attention_qkv_bias
        self.q_proj = Dense(cfg.hidden_size, nh * hd, qb, cfg.dtype, **factory)
        self.k_proj = Dense(cfg.hidden_size, nkv * hd, qb, cfg.dtype, **factory)
        self.v_proj = Dense(cfg.hidden_size, nkv * hd, qb, cfg.dtype, **factory)
        self.o_proj = Dense(nh * hd, cfg.hidden_size, cfg.attention_o_bias,
                            cfg.dtype, reduce_over=tp, **factory)

    def forward(self, h, cos, sin, kv=None, mask=None, index=None):
        cfg = self.cfg
        hd, (nh, nkv) = cfg.head_dim, self.heads
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
    """SwiGLU over this rank's intermediate/tp columns."""

    def __init__(self, cfg: LlamaConfig, tp: int = 1, **factory):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size // tp
        self.gate_proj = Dense(d, i, False, cfg.dtype, **factory)
        self.up_proj = Dense(d, i, False, cfg.dtype, **factory)
        self.down_proj = Dense(i, d, False, cfg.dtype, reduce_over=tp, **factory)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, tp: int = 1, **factory):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       cfg.dtype, **factory)
        self.self_attn = LlamaAttention(cfg, tp, **factory)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                cfg.dtype, **factory)
        self.mlp = LlamaMLP(cfg, tp, **factory)

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
    labels=labels)` → (causal-LM loss, {}); `forward(input_ids,
    cache=cache)` → (logits, cache) with the S new tokens written into the
    cache at its cursors and the cursors advanced.

    `tp_size`/`tp_rank` build one rank's shard (module docstring)."""

    zero3_gathers = True    # the forward gathers ZeRO-3 units (`gathered`)

    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32,
                 tp_size: int = 1, tp_rank: int = 0):
        super().__init__()
        self.tp_size, self.tp_rank = int(tp_size), int(tp_rank)
        tp = self.tp_size
        if not 0 <= self.tp_rank < tp:
            raise ValueError(f"tp_rank={self.tp_rank} outside tp_size={tp}")
        check_ported(cfg, tp)
        factory = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size // tp, cfg.hidden_size, **factory))
        self.layers = nn.ModuleList(LlamaBlock(cfg, tp, **factory)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, **factory)
        self.lm_head = None if cfg.tie_word_embeddings else Dense(
            cfg.hidden_size, cfg.vocab_size // tp, False, cfg.dtype, **factory)
        nn.init.normal_(self.embed_tokens, std=0.02)

    def forward(self, input_ids, cache=None, logits_at: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None):
        """`cache` is a dense `KVCache` or a `PagedKVCache`; with a paged
        cache each layer gets `PagedLayer` views that alias the stacked
        pools. `logits_at` (B,) picks one position per row, and the LM head
        then runs on those rows only: logits (B, V) instead of (B, S, V)."""
        with gathered(self):
            return self._forward(input_ids, cache, logits_at, labels)

    def _forward(self, input_ids, cache, logits_at, labels):
        cfg = self.cfg
        if labels is not None and self.tp_size > 1:
            raise unported(f"training under tensor parallelism (tp={self.tp_size})",
                           "Multi-GPU")
        h = vocab_parallel_embedding(input_ids, self.embed_tokens.to(cfg.dtype),
                                     self.tp_size, self.tp_rank)
        if cache is not None:
            b, s = input_ids.shape
            index = cache.index
            positions = index[:, None] + torch.arange(s, device=h.device)[None, :]
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
            paged = isinstance(cache, PagedKVCache)
            # the paged kernels evaluate their masks from the cursors
            mask = None if paged else decode_mask(positions, cache.max_len,
                                                  window=cfg.sliding_window)
            for i, layer in enumerate(self.layers):
                kv = cache.layer(i) if paged else (cache.k[i], cache.v[i])
                h, _ = layer(h, (cos, sin, index, mask), kv=kv)
            if logits_at is not None:
                h = h[torch.arange(b, device=h.device), logits_at.long()][:, None]
            logits = self._lm_head(self.norm(h))
            if logits_at is not None:
                logits = logits[:, 0]
            return logits, cache.replace(index=index + s)
        positions = torch.arange(input_ids.shape[1], device=h.device)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            h = checkpoint(gathered_block, layer, h, (cos, sin), use_reentrant=False) \
                if remat else gathered_block(layer, h, (cos, sin))
        logits = self._lm_head(self.norm(h))
        if labels is None:
            return logits
        return causal_lm_loss(logits, input_ids, labels), {}

    def load_jax_params(self, tree) -> "LlamaForCausalLM":
        """Copy a JAX parameter tree into this module (`load_jax_params`)."""
        return load_jax_params(self, tree)

    def param_tree(self, dtype: Optional[torch.dtype] = None, device=None,
                   release: bool = False) -> dict:
        """This module's weights as a JAX parameter tree (`param_tree`)."""
        return param_tree(self, dtype=dtype, device=device, release=release)

    def module_state(self, tree) -> dict:
        """Parameter names → tensors of a JAX tree (`module_state`)."""
        return module_state(self, tree)

    def _lm_head(self, h):
        if self.lm_head is None:
            logits = torch.einsum("bsd,vd->bsv", h, self.embed_tokens.to(self.cfg.dtype))
        else:
            logits = self.lm_head(h)
        return gather_vocab(logits, self.tp_size)


def module_model_dim(name: str) -> Optional[int]:
    """The dimension of the module parameter `name` (a per-layer
    `nn.Linear` weight is the transposed kernel, without the stacked L
    axis) that shards over `model`, or None (replicated)."""
    from deepspeed_tpu_torch.utils.partitioning import model_dim
    parts = tuple(name.split("."))
    dense = parts[-1] == "weight" and (parts[-2].endswith("_proj") or parts[0] == "lm_head")
    if parts[0] == "layers":
        path = ("layers",) + parts[2:-1] + (("kernel",) if dense else parts[-1:])
        dim = model_dim(path)
        dim = None if dim is None else dim - 1
    else:
        path = ("lm_head",) if parts[0] == "lm_head" else parts
        dim = model_dim(path)
    if dim is None or not dense:
        return dim
    return 1 - dim


@torch.no_grad()
def init_params(model: LlamaForCausalLM, generator: torch.Generator,
                std: float = 0.02) -> LlamaForCausalLM:
    """Random weights as the JAX package initialises them: normal(std) for
    the embedding and every kernel, zeros for biases, ones for RMSNorm
    weights. Draws come from `generator`, on the parameters' device. A
    tensor-parallel shard draws each sharded weight at its whole shape, in
    the order a tp = 1 module does, and keeps its slice, so every rank's
    shard is the matching slice of the tp = 1 module's weights; an
    expert-parallel shard of an MoE model (`ep_size`) does the same with
    each expert stack, keeping its rank's experts."""
    tp, rank = getattr(model, "tp_size", 1), getattr(model, "tp_rank", 0)
    ep, ep_rank = getattr(model, "ep_size", 1), getattr(model, "ep_rank", 0)
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight") or name == "norm.weight":
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            dim, n, r = None, 1, 0
            if tp > 1:
                dim, n, r = module_model_dim(name), tp, rank
            elif ep > 1 and ".experts." in name:
                dim, n, r = 0, ep, ep_rank
            if dim is None:
                p.normal_(0.0, std, generator=generator)
                continue
            shape = list(p.shape)
            shape[dim] *= n
            whole = torch.empty(shape, dtype=p.dtype, device=p.device)
            whole.normal_(0.0, std, generator=generator)
            p.copy_(whole.narrow(dim, r * p.shape[dim], p.shape[dim]))
    return model


def llama_loss_fn(model: Optional[LlamaForCausalLM] = None):
    """The engine loss for a Llama: `loss_fn(module, batch)` with labels
    shifted from `input_ids` when the batch carries none."""
    return make_causal_loss_fn(model)


def _leaves(node, path=()):
    """(path, leaf) pairs of a nested dict."""
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _leaves(child, path + (key,))
    else:
        yield path, node


def module_state(model: nn.Module, tree) -> dict:
    """The module's parameter names → tensors of a JAX parameter tree of
    torch tensors (float leaves): per-layer views of the stacked `layers`
    leaves, a flax `Dense` kernel (in, out) as a transposed (out, in) view,
    other leaves (norm weights, biases, an MoE router or expert stack) as
    they are, `lm_head` (D, V) as the untied head. For `load_jax_params`,
    and for running the module on a tree's weights with
    `torch.func.functional_call`. Any decoder laid out as `embed_tokens`,
    `layers`, `norm` and `lm_head` maps this way (`models/moe_common.py`)."""
    state = {"embed_tokens": tree["embed_tokens"], "norm.weight": tree["norm"]["weight"]}
    if model.lm_head is not None:
        state["lm_head.weight"] = tree["lm_head"].t()
    state.update(stack_state("layers", len(model.layers), tree["layers"]))
    return state


def stack_state(prefix: str, num_layers: int, stack) -> dict:
    """Module names `{prefix}.{i}.…` → per-layer views of a tree's
    scan-stacked leaves: a flax `Dense` kernel (L, in, out) as transposed
    (out, in) `nn.Linear` weights, other leaves as they are."""
    state = {}
    for path, leaf in _leaves(stack):
        dense = path[-1] == "kernel"
        name = ".".join(path[:-1] + ("weight",)) if dense else ".".join(path)
        for i in range(num_layers):
            state[f"{prefix}.{i}.{name}"] = leaf[i].t() if dense else leaf[i]
    return state


def tree_to_torch(tree, dtype: Optional[torch.dtype] = None, device=None):
    """A JAX parameter tree of numpy (or JAX) arrays as torch tensors on
    `device`: float leaves cast to `dtype` when given; a quantized leaf
    keeps its int8 bytes and f32 scales."""
    from deepspeed_tpu_torch.inference.quantization import is_quantized_leaf, tree_map

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        a = np.ascontiguousarray(np.asarray(x))
        return torch.from_numpy(a if a.flags.writeable else a.copy())

    def leaf(x):
        if is_quantized_leaf(x):
            return {k: tensor(v).to(device) for k, v in x.items()}
        t = tensor(x)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)


@torch.no_grad()
def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree (nested dicts of numpy arrays) into
    `model`, which must have a leaf for every parameter. The scan-stacked
    `layers/...` leaves carry a leading L axis and are split per layer; a
    flax `Dense` kernel (in, out) is transposed into an `nn.Linear` weight
    (out, in); `lm_head` (D, V) is the untied head. Quantized leaves (`{"__q8__", "scales"}`, flat or
    per-layer scales) are dequantized into the float weights; an inference
    engine given such a tree keeps the int8 bytes instead."""
    from deepspeed_tpu_torch.inference.quantization import dequantize_param_tree
    tree = dequantize_param_tree(tree_to_torch(tree, dtype=torch.float32))
    state = model.module_state(tree)
    params = dict(model.named_parameters())
    missing, unknown = sorted(set(params) - set(state)), sorted(set(state) - set(params))
    if missing or unknown:
        raise KeyError(f"load_jax_params: the tree does not fit {type(model).__name__}: "
                       f"missing {missing[:4]}, unknown {unknown[:4]}")
    for name, value in state.items():
        params[name].copy_(value.to(params[name].dtype))
    return model


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@torch.no_grad()
def param_tree(model: nn.Module, dtype: Optional[torch.dtype] = None,
               device=None, release: bool = False) -> dict:
    """The module's weights as a JAX parameter tree of torch tensors (the
    inverse of `module_state`): per-layer leaves stacked on a leading L
    axis, `nn.Linear` weights transposed into flax (in, out) kernels, other
    parameters as they are, cast to `dtype` and moved to `device`
    (default: the parameters' own). `device="meta"` gives
    the shapes alone. `release=True` frees each module parameter once it is
    copied (the module's storage moves to the meta device), so building the
    tree never holds two copies of the weights."""
    take = param_taker(dtype, device, release)
    tree = {"embed_tokens": take(model, "embed_tokens"),
            "norm": {"weight": take(model.norm, "weight")}, "layers": {}}
    if model.lm_head is not None:
        tree["lm_head"] = take(model.lm_head, "weight").t().contiguous()
    tree["layers"] = stack_tree(model.layers, take)
    return tree


def param_taker(dtype: Optional[torch.dtype] = None, device=None, release: bool = False):
    """`take(owner, attr)`: the parameter cast to `dtype` on `device`; with
    `release`, the owner's parameter moves to the meta device once taken."""
    def take(owner, attr):
        p = getattr(owner, attr)
        t = p.detach().to(device=device, dtype=dtype)
        if release:
            setattr(owner, attr, nn.Parameter(
                torch.empty(p.shape, dtype=p.dtype, device="meta"),
                requires_grad=p.requires_grad))
        return t
    return take


def _slots(layer: nn.Module):
    """(owner path, attribute, dense) of each parameter of a layer module:
    `dense` marks an `nn.Linear` weight, whose JAX leaf is its transposed
    (in, out) `kernel`."""
    for name, _ in layer.named_parameters():
        *owner_path, attr = name.split(".")
        owner = layer.get_submodule(".".join(owner_path))
        yield owner_path, attr, isinstance(owner, nn.Linear) and attr == "weight"


def _put(tree: dict, owner_path, attr: str, dense: bool, value) -> None:
    node = tree
    for key in owner_path:
        node = node.setdefault(key, {})
    node["kernel" if dense else attr] = value


def stack_tree(layers: nn.ModuleList, take) -> dict:
    """The layers' parameters as scan-stacked JAX leaves (the inverse of
    `stack_state`): each stacked on a leading L axis, `nn.Linear` weights
    transposed into flax (in, out) kernels."""
    stack: dict = {}
    for owner_path, attr, dense in _slots(layers[0]):
        owners = [layer.get_submodule(".".join(owner_path)) for layer in layers]
        _put(stack, owner_path, attr, dense, torch.stack(
            [take(o, attr).t() if dense else take(o, attr) for o in owners]))
    return stack


def layer_tree(layer: nn.Module) -> dict:
    """One layer module's weights as its JAX layer tree, without a stack:
    `nn.Linear` weights as transposed (in, out) kernel views, other
    parameters as they are (no copy)."""
    tree: dict = {}
    for owner_path, attr, dense in _slots(layer):
        p = getattr(layer.get_submodule(".".join(owner_path)), attr).detach()
        _put(tree, owner_path, attr, dense, p.t() if dense else p)
    return tree


@torch.no_grad()
def to_jax_params(model) -> dict:
    """The inverse of `load_jax_params`: a JAX parameter tree of numpy
    arrays, from a module (f32, per-layer leaves stacked on a
    leading L axis, `nn.Linear` weights transposed into flax kernels) or
    from a tree of torch tensors such as an inference engine's `params`,
    whose quantized leaves come back as the same int8 bytes and f32
    scales."""
    from deepspeed_tpu_torch.inference.quantization import is_quantized_leaf, tree_map
    if isinstance(model, dict):
        return tree_map(lambda x: ({k: v.detach().cpu().numpy() for k, v in x.items()}
                                   if is_quantized_leaf(x) else _np(x)), model)
    return tree_map(_np, model.param_tree(dtype=torch.float32))
