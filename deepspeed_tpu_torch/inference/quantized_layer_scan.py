"""The `layer_scan` serve mode (counterpart of ``deepspeed_tpu/inference/quantized_layer_scan.py``).

Serves a llama-layout parameter tree whose layer leaves are stacked on a
leading L axis and quantized per layer (`quantize_layer_stacks`): the
embedding and the LM head stay in the serving dtype, and each layer's
q/k/v/o and gate/up/down products run the fused dequant-GEMM
(`ops/cuda/quantized_matmul.py`, K5) straight from the int8 bytes, so no
dequantized weight exists in device memory. Where the JAX package runs an
engine-level `lax.scan` over the stacks inside its generate program, this
module's `make_scan_apply` is an eager loop over the layers with the same
block body (`make_block_fn`), and the v1 engine's `generate` drives it with
its own prefill, decode, sampling and eos loop over the same dense KV cache
(length rounded up to 128, the serving dtype).

`fused=False` is the JAX package's naive path, `x @ dequantize(q, s)` per
product. With a tensor-parallel `mesh` (the topology; each rank holds its
shard of the tree, `utils/partitioning.shard_tree`) the products run K5 per
shard (`sharded_quantized_matmul`) in the flavour the JAX package's hints
give (`TP_HINTS`): 'n' (column-parallel) for q/k/v/gate/up, 'k'
(row-parallel, then an all-reduce over `model`, bias after it) for o/down;
the embedding is a vocab-parallel lookup and the head's logits are
gathered. `check_tp_flavors` holds a whole tree to the JAX rule before it
is cut.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference.kv_cache import decode_mask, update_layer
from deepspeed_tpu_torch.inference.quantization import (
    _nbytes,
    is_quantized_leaf,
    tree_leaves,
    tree_map,
)
from deepspeed_tpu_torch.models.common import gather_vocab, vocab_parallel_embedding
from deepspeed_tpu_torch.ops.attention import apply_rotary_emb, cached_attention, rope_cos_sin
from deepspeed_tpu_torch.ops.cuda.quantized_matmul import (
    quantized_matmul,
    scale_group_width,
    sharded_quantized_matmul,
    tp_shard_flavor,
)
from deepspeed_tpu_torch.ops.cuda.sharded import kernel_fallback
from deepspeed_tpu_torch.ops.quantization import (
    dequantize_int8_blockwise,
    quantize_int8_blockwise,
)

_ATTN_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP_KEYS = ("gate_proj", "up_proj", "down_proj")


def layer_scan_supported(params: Any) -> bool:
    """True for a llama-layout tree: stacked `layers` with self_attn/mlp/norm
    children, plus top-level embed_tokens and norm (lm_head optional)."""
    try:
        layers = params["layers"]
        for k in _ATTN_KEYS:
            _ = layers["self_attn"][k]["kernel"]
        for k in _MLP_KEYS:
            _ = layers["mlp"][k]["kernel"]
        _ = layers["input_layernorm"]["weight"]
        _ = layers["post_attention_layernorm"]["weight"]
        _ = params["embed_tokens"]
        _ = params["norm"]["weight"]
        return True
    except (KeyError, TypeError, IndexError):
        return False


def _quantize_stack(x: torch.Tensor, group_size: int) -> Dict[str, torch.Tensor]:
    """Quantize each layer of a stacked leaf on its own (the JAX package's
    jitted vmap, and its one-layer-at-a-time path for big leaves, whose
    scales XLA computes as amax · (1/127)): the f32 temporaries stay one
    layer wide. Scales (L, nblocks)."""
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = []
    for i in range(x.shape[0]):
        q[i], s = quantize_int8_blockwise(x[i], group_size, reciprocal=True)
        scales.append(s)
    return {"__q8__": q, "scales": torch.stack(scales)}


def quantize_layer_stacks(params: Any, group_size: int = 256,
                          min_size: int = 4096) -> Any:
    """Quantize the stacked layer kernels per layer (scales keep a leading L
    axis); norms, biases and the non-layer leaves (embed, head) stay as they
    are. A pre-quantized stacked leaf keeps its int8 values, its flat scales
    reshaped to (L, nblocks) when they tile the stack; a pre-quantized norm
    stack or non-layer leaf is dequantized back. The tree is rewritten in
    place, leaf by leaf, so each float stack is dropped as soon as its int8
    form exists; it is also returned."""

    def q_stacked(x):
        if is_quantized_leaf(x):
            q, s = x["__q8__"], x["scales"]
            if q.dim() < 3:
                return dequantize_int8_blockwise(q, s.reshape(-1))
            if s.dim() == 1 and s.shape[0] % q.shape[0] == 0:
                s = s.reshape(q.shape[0], -1)
            return {"__q8__": q, "scales": s}
        if not (isinstance(x, torch.Tensor) and x.dim() >= 3 and x[0].numel() >= min_size
                and x.is_floating_point()):
            return x
        return _quantize_stack(x, group_size)

    def rewrite(tree):
        for k, v in tree.items():
            if isinstance(v, dict) and not is_quantized_leaf(v):
                rewrite(v)
            else:
                tree[k] = q_stacked(v)

    rewrite(params["layers"])
    for k in [k for k in params if k != "layers"]:
        params[k] = tree_map(
            lambda leaf: (dequantize_int8_blockwise(leaf["__q8__"], leaf["scales"].reshape(-1))
                          if is_quantized_leaf(leaf) else leaf), params[k])
    return params


def _tree_nbytes(tree) -> int:
    total = 0
    for leaf in tree_leaves(tree):
        if is_quantized_leaf(leaf):
            total += _nbytes(leaf["__q8__"]) + _nbytes(leaf["scales"])
        else:
            total += _nbytes(leaf)
    return total


def weight_bytes_per_step(params: Any) -> int:
    """At-rest weight bytes a decode step reads: every layer leaf (int8,
    scales, norms), the final norm and the LM head. The embedding is a
    B-row gather, not a full read, and is left out."""
    total = _tree_nbytes(params.get("layers", {})) + _tree_nbytes(params.get("norm", {}))
    if params.get("lm_head") is not None:
        total += _tree_nbytes(params["lm_head"])
    return int(total)


def at_rest_bytes(params: Any) -> dict:
    """{'int8', 'scales', 'full_precision', 'total'} bytes of a tree."""
    out = {"int8": 0, "scales": 0, "full_precision": 0}
    for leaf in tree_leaves(params):
        if is_quantized_leaf(leaf):
            out["int8"] += _nbytes(leaf["__q8__"])
            out["scales"] += _nbytes(leaf["scales"])
        else:
            out["full_precision"] += _nbytes(leaf)
    out["total"] = out["int8"] + out["scales"] + out["full_precision"]
    return out


def dense_bytes_per_step(params: Any, dtype) -> int:
    """`weight_bytes_per_step` of the dequantized (dense) form in `dtype`:
    what a bf16 engine reads a step."""
    itemsize = torch.empty((), dtype=dtype).element_size()

    def nbytes(leaf):
        if is_quantized_leaf(leaf):
            return leaf["__q8__"].numel() * itemsize
        return _nbytes(leaf)

    total = 0
    for sub in ("layers", "norm"):
        for leaf in tree_leaves(params.get(sub, {})):
            total += nbytes(leaf)
    if params.get("lm_head") is not None:
        total += nbytes(params["lm_head"])
    return int(total)


def _rmsnorm(x, w, eps, dtype):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w).to(dtype)


# each projection's flavour under tensor parallelism, the JAX package's
# hints, which its at-rest cut (`utils/partitioning`) gives it
TP_HINTS = {"q_proj": "n", "k_proj": "n", "v_proj": "n", "o_proj": "k",
            "gate_proj": "n", "up_proj": "n", "down_proj": "k"}


def check_tp_flavors(params: Any, tp: int) -> None:
    """Raise unless every int8 projection of a whole per-layer-quantized
    tree shards over a tp-way `model` axis in its hint's flavour by the JAX
    rule (`tp_shard_flavor`). Where the rule picks the other flavour, or
    none, the JAX package reshards the weight or dequantizes it; here each
    rank holds the hint's cut, which K5 cannot run per shard."""
    for part in (params["layers"]["self_attn"], params["layers"]["mlp"]):
        for name, proj in part.items():
            w = proj["kernel"]
            if not is_quantized_leaf(w):
                continue
            _, k, n = w["__q8__"].shape
            hint = TP_HINTS[name]
            flavor = tp_shard_flavor(k, n, w["scales"].shape[-1], tp, prefer=hint)
            if flavor != hint:
                raise ValueError(
                    f"{name}: the scale blocks of a ({k}, {n}) int8 kernel shard over "
                    f"model={tp} as {flavor!r}, not as its {hint!r} cut; pick a quant "
                    "group_size that divides its rows' share")


def make_matmul(dtype, fused: bool = True, mesh=None) -> Callable:
    """x @ W (+ bias) over a projection dict whose `kernel` is a float (K, N)
    leaf or an int8 leaf with its scales. Fused: the K5 wrapper. On CUDA it
    launches the kernel or raises, on a scale layout the kernel does not
    tile too; on the CPU it takes the plain version, and a layout it does
    not tile takes the naive path, as in the JAX package. Naive: `x @
    dequantize(q, s)` in `dtype`, the whole-tree engine's values.

    With a `mesh` whose `model` axis is nontrivial the leaf is the rank's
    shard and `hint` its flavour ('n' or 'k'): fused, K5 per shard
    (`sharded_quantized_matmul`); a 'k' product's partial sums are
    all-reduced before the bias on every path."""
    tp = mesh.tp_size if mesh is not None else 1

    def matmul(x, proj, hint: str = "n"):
        w = proj["kernel"]
        reduce = tp > 1 and hint == "k"
        if is_quantized_leaf(w):
            q, sc = w["__q8__"], w["scales"]
            tiled = x.is_cuda or scale_group_width(q.shape[0], q.shape[1],
                                                   sc.shape[0]) is not None
            if fused and tiled and tp > 1:
                y = sharded_quantized_matmul(x, q, sc, hint)
                reduce = False
            elif fused and tiled:
                y = quantized_matmul(x, q, sc)
            else:
                if fused and tp > 1:
                    kernel_fallback("quantized_matmul",
                                    f"({q.shape[0]}, {q.shape[1]}) int8 shard: scale "
                                    "blocks don't tile its rows", x.device)
                y = x @ dequantize_int8_blockwise(q, sc, dtype)
        else:
            y = x @ w.to(dtype)
        if reduce:
            y = comm.all_reduce(y, group="model")
        bias = proj.get("bias")
        if bias is not None:
            y = y + bias.to(dtype)
        return y

    return matmul


def make_block_fn(model_cfg: Any, fused: bool = True, mesh=None) -> Callable:
    """LlamaBlock's cached path over one layer's (possibly quantized)
    leaves: block(h, lp, (cos, sin, index, mask), (k_cache, v_cache)) →
    (h, (k_cache, v_cache)); the caches are written in place. With a
    tensor-parallel `mesh`, over the rank's shard (`make_matmul`)."""
    cfg = model_cfg
    dtype = cfg.dtype
    tp = mesh.tp_size if mesh is not None else 1
    hd = cfg.head_dim
    nh, nkv = cfg.num_attention_heads // tp, cfg.num_key_value_heads // tp
    eps = cfg.rms_norm_eps
    window = getattr(cfg, "sliding_window", None)
    attn_impl = getattr(cfg, "attn_impl", "auto")
    matmul = make_matmul(dtype, fused=fused, mesh=mesh)

    def block(h, lp, aux, kv):
        cos, sin, index, mask = aux
        bsz, sl = h.shape[:2]
        attn_p, mlp_p = lp["self_attn"], lp["mlp"]
        hn = _rmsnorm(h, lp["input_layernorm"]["weight"], eps, dtype)
        q = apply_rotary_emb(matmul(hn, attn_p["q_proj"]).reshape(bsz, sl, nh, hd), cos, sin)
        k = apply_rotary_emb(matmul(hn, attn_p["k_proj"]).reshape(bsz, sl, nkv, hd), cos, sin)
        v = matmul(hn, attn_p["v_proj"]).reshape(bsz, sl, nkv, hd)
        k_cache, v_cache = update_layer(kv[0], kv[1], k, v, index)
        ctx = cached_attention(q, k_cache, v_cache, index, mask,
                               impl=attn_impl, window=window)
        h = h + matmul(ctx.reshape(bsz, sl, nh * hd), attn_p["o_proj"],
                       hint=TP_HINTS["o_proj"])
        hn = _rmsnorm(h, lp["post_attention_layernorm"]["weight"], eps, dtype)
        g = matmul(hn, mlp_p["gate_proj"])
        u = matmul(hn, mlp_p["up_proj"])
        h = h + matmul(F.silu(g) * u, mlp_p["down_proj"], hint=TP_HINTS["down_proj"])
        return h, (k_cache, v_cache)

    return block


def layer_slices(layers: Any) -> List[Any]:
    """The stacked layer tree as one tree of views per layer."""
    n = next(iter(tree_leaves(layers)))
    n = (n["__q8__"] if is_quantized_leaf(n) else n).shape[0]

    def take(i):
        return tree_map(lambda leaf: ({"__q8__": leaf["__q8__"][i], "scales": leaf["scales"][i]}
                                      if is_quantized_leaf(leaf) else leaf[i]), layers)

    return [take(i) for i in range(n)]


def scan_inputs(model_cfg: Any, params: Any, ids, index, max_len: int, tp: int = 1,
                rank: int = 0):
    """(h, aux) for the block body: the embedding of `ids` (B, S) at the
    per-row cursors `index`, and (cos, sin, index, mask) over a dense cache
    of `max_len` slots. Shared by the layer scan and the capacity runner."""
    cfg = model_cfg
    dtype = cfg.dtype
    h = vocab_parallel_embedding(ids, params["embed_tokens"].to(dtype), tp, rank)
    positions = index[:, None] + torch.arange(ids.shape[1], device=ids.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, dtype)
    mask = decode_mask(positions, max_len, window=getattr(cfg, "sliding_window", None))
    return h, (cos, sin, index, mask)


def scan_logits(model_cfg: Any, params: Any, h, tp: int = 1, logits_at=None,
                last_only: bool = False):
    """The final norm and the LM head over `h` (B, S, D): logits (B, S, V);
    with `last_only` (B, 1, V) at the last position; with `logits_at` (B,)
    (B, V) at one position a row, as the module's `logits_at` gives. The
    head runs only on the rows it returns."""
    cfg = model_cfg
    dtype = cfg.dtype
    if logits_at is not None:
        h = h[torch.arange(h.shape[0], device=h.device), logits_at.long()][:, None]
    elif last_only:
        h = h[:, -1:]
    h = _rmsnorm(h, params["norm"]["weight"], cfg.rms_norm_eps, dtype)
    head = params.get("lm_head")
    if head is None:
        logits = torch.einsum("bsd,vd->bsv", h, params["embed_tokens"].to(dtype))
    else:
        logits = h @ head.to(dtype)
    logits = gather_vocab(logits, tp)
    return logits[:, 0] if logits_at is not None else logits


def make_scan_apply(model_cfg: Any, fused: bool = False, mesh=None) -> Callable:
    """`apply(params, ids, cache, per_layer=None, logits_at=None,
    last_only=False) → (logits, cache)` over a per-layer-stacked llama tree
    and a dense `KVCache` (written in place; its cursors are left for the
    caller to advance); `logits_at` and `last_only` as in `scan_logits`.
    `per_layer` is `layer_slices(params["layers"])`, computed once by
    callers that step many times. With a tensor-parallel `mesh`, `params`
    is the rank's shard and the logits are gathered whole on every rank."""
    block = make_block_fn(model_cfg, fused=fused, mesh=mesh)
    tp = mesh.tp_size if mesh is not None else 1
    rank = mesh.coord("model") if mesh is not None else 0

    def apply(params, ids, cache, per_layer=None, logits_at=None, last_only=False):
        if per_layer is None:
            per_layer = layer_slices(params["layers"])
        h, aux = scan_inputs(model_cfg, params, ids, cache.index, cache.max_len, tp, rank)
        for i, lp in enumerate(per_layer):
            h, _ = block(h, lp, aux, (cache.k[i], cache.v[i]))
        return scan_logits(model_cfg, params, h, tp, logits_at, last_only), cache

    return apply
