"""Serve-mode resolution and weight placement (counterpart of ``deepspeed_tpu/inference/serve_modes.py``).

Both inference engines place their weights here. `dequant` serves the
module's own weights, or with `quant` a whole-tree int8 form dequantized at
use; `layer_scan` serves a per-layer-stacked int8 tree through
`quantized_layer_scan`; `capacity` parks the layers in host memory and NVMe
and streams them every pass (`capacity_scan.CapacityRunner`, which the
engine keeps as `_capacity`); `auto` picks by `config.choose_serve_mode`,
fed the card's memory. Capacity serves a llama-layout tree on one device:
another tree serves `dequant` with a warning, and a topology of more than
one rank goes through `kernel_fallback` (raises on CUDA, warns and serves
`dequant` on the CPU), as in the JAX package. The OOM degradation ladder
(`degraded_mode`, `note_degraded`), the telemetry and the memory plane are
not ported (ROADMAP.md, Queue 1, 'The rest' and 'Weight quantization and
serve modes').

The `engine` argument is duck-typed: the functions read `module`,
`model_cfg`, `_config`, `accelerator` and `device`, and write
`serve_mode`, `_quantized` and `module` back. The weights are reached
through the module's own `param_tree`, `load_jax_params` and
`module_state`, so any model family that has them is placed here. `quant`
on a tree without the layer-scan layout (the MoE families) raises: a
whole-tree int8 MoE tree is not ported (ROADMAP.md, Queue 1, 'Weight
quantization and serve modes').

Tensor and expert parallelism: `serving_topology` installs (or adopts) the
topology of `tensor_parallel.tp_size` ranks, or adopts an installed pure
`expert` topology for the MoE families, and `place_params` places this
rank's shard by one rule, over the topology's nontrivial axis: a whole
tree (`params`, or a whole module's own weights) is cut with
`utils/partitioning.shard_tree` into this rank's shard (a whole module is
rebuilt as one on the meta device); a module built as this rank's shard
(`tp_size`/`tp_rank`, or `ep_size`/`ep_rank`, at construction) and given no
tree keeps its weights. A shard built for another rank or another axis
raises.
With `quant`, a whole tree is quantized first and then cut, as the JAX
package does, so every rank's int8 bytes and scales are the matching slice
of the unsharded tree, and the fused layer scan needs each projection to
shard in its at-rest flavour by the JAX rule (`tp_shard_flavor`); a shard's
own weights are quantized alone, which equals that cut when the scale
groups tile its rows, which is checked.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from deepspeed_tpu_torch.inference import quantized_layer_scan as qls
from deepspeed_tpu_torch.inference.capacity_scan import (
    decode_workspace_bytes,
    kv_cache_bytes,
    round_up_len,
)
from deepspeed_tpu_torch.inference.config import _unported, choose_serve_mode
from deepspeed_tpu_torch.inference.quantization import (
    dequantize_param_tree,
    is_quantized_leaf,
    quantize_param_tree,
    tree_leaves,
)
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, tree_to_torch
from deepspeed_tpu_torch.models.moe_common import MoeForCausalLM
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.partitioning import shard_tree

_ALIASES = {"quantized_layer_scan": "layer_scan", "whole_tree": "dequant"}


def _size(x) -> int:
    n = 1
    for d in x.shape:
        n *= int(d)
    return n


def _is_float(x) -> bool:
    return torch.empty((), dtype=x.dtype).is_floating_point() \
        if isinstance(x.dtype, torch.dtype) else x.dtype.kind == "f"


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize


def serving_topology(engine) -> "groups.MeshTopology":
    """The installed topology, else, for tp > 1, one of
    `tensor_parallel.tp_size` ranks over the processes, installed
    (`comm.init_distributed` from the environment when no process group is
    up), serving `engine.device`. tp > 1 serves the Llama family only, and
    an `expert` axis above 1 the MoE families only; other models raise."""
    from deepspeed_tpu_torch import comm
    tp = engine._config.tp_size
    try:
        topo = groups.get_topology(create_default=False)
    except RuntimeError:
        if tp > 1:
            comm.init_distributed()
            if comm.get_world_size() != tp:
                raise ValueError(
                    f"tensor_parallel.tp_size={tp} needs {tp} ranks, one process each, "
                    f"and this run has {comm.get_world_size()}: start them with "
                    f"torchrun --nproc_per_node={tp}, or call "
                    "deepspeed_tpu_torch.init_distributed(...) in each")
            topo = groups.initialize(groups.MeshTopology(tp=tp, device=engine.device))
        else:
            # one rank: a topology of its own, not installed
            topo = groups.MeshTopology(device=engine.device)
    if tp > 1 and topo.tp_size != tp:
        raise ValueError(f"tensor_parallel.tp_size={tp} but the installed topology has "
                         f"model={topo.tp_size}")
    if topo.device is None:
        topo.device = engine.device
    if topo.tp_size > 1 and not isinstance(engine.module, LlamaForCausalLM):
        raise _unported(f"tensor parallelism (tp={topo.tp_size}) with "
                        f"{type(engine.module).__name__}", "Multi-GPU")
    if topo.ep_size > 1 and not isinstance(engine.module, MoeForCausalLM):
        raise _unported(f"expert parallelism (ep={topo.ep_size}) with "
                        f"{type(engine.module).__name__}, which has no experts",
                        "Multi-GPU")
    return topo


def resolve_serve_mode(engine, params: Any) -> str:
    """The serve mode for `params`, a whole JAX-layout tree (torch, numpy or
    meta leaves). `auto` accounts the weights in each mode's at-rest form
    plus the KV cache and decode workspace at the config's max batch and
    out tokens, against the memory of the topology's cards."""
    config = engine._config
    mode = getattr(config, "serve_mode", "auto") or "auto"
    mode = _ALIASES.get(mode, mode)
    if mode not in ("auto", "dequant", "layer_scan", "capacity"):
        raise ValueError(
            f"init_inference: unknown serve_mode {mode!r} (expected "
            "'auto', 'dequant', 'layer_scan' or 'capacity')")
    layout_ok = isinstance(params, dict) and qls.layer_scan_supported(params)
    topo = getattr(engine, "topology", None)
    sizes = topo.sizes if topo is not None else {}
    multi_device = any(n > 1 for n in sizes.values())
    tp_shardable = multi_device and {a for a, n in sizes.items() if n > 1} == {"model"}
    if mode == "capacity" and layout_ok and multi_device:
        from deepspeed_tpu_torch.ops.cuda.sharded import kernel_fallback
        kernel_fallback("capacity_scan",
                        f"mesh axes {sorted(a for a, n in sizes.items() if n > 1)} "
                        "unsupported: the capacity loop streams to one device's memory",
                        engine.device)
        logger.warning("serve_mode='capacity' needs a single device; falling back to "
                       "whole-tree dequant")
        return "dequant"
    if mode in ("layer_scan", "capacity") and not layout_ok:
        logger.warning(
            f"serve_mode={mode!r} needs a llama-layout param tree (stacked "
            "layers with self_attn/mlp projections); falling back to "
            "whole-tree dequant")
        return "dequant"
    if mode == "layer_scan" and not engine._quantized:
        logger.warning(
            "serve_mode='layer_scan' without quant={'enabled': True} "
            "has nothing to stream; serving device-resident (dequant). "
            "For bf16 streaming use serve_mode='capacity'.")
        return "dequant"
    if mode != "auto":
        return mode
    itemsize = torch.empty((), dtype=config.dtype).element_size()
    dense = int8 = 0
    for leaf in tree_leaves(params):
        if is_quantized_leaf(leaf):
            q, s = leaf["__q8__"], leaf["scales"]
            dense += _size(q) * itemsize
            int8 += _size(q) * _itemsize(q) + _size(s) * _itemsize(s)
        else:
            dense += _size(leaf) * itemsize
            # the quantizer's eligibility rule (>= 2-D, >= min_size, float)
            if len(leaf.shape) >= 2 and _size(leaf) >= 4096 and _is_float(leaf):
                int8 += _size(leaf)
            else:
                int8 += _size(leaf) * itemsize
    cfg = engine.model_cfg
    num_layers = getattr(cfg, "num_hidden_layers", None) or getattr(cfg, "n_layer", 1)
    b = int(getattr(config, "max_batch_size", None) or 1)
    max_len = round_up_len(getattr(config, "max_out_tokens", 1024))
    n_devices = topo.world_size if topo is not None else 1
    return choose_serve_mode(
        quantized=engine._quantized, layout_ok=layout_ok, multi_device=multi_device,
        dense_bytes=dense, int8_bytes=int8, layer_bytes=dense // max(1, int(num_layers)),
        kv_bytes=kv_cache_bytes(cfg, b, max_len, config.dtype,
                                kv_dtype=getattr(config, "kv_cache_dtype", None)),
        workspace_bytes=decode_workspace_bytes(cfg, b, max_len, config.dtype),
        hbm_bytes=engine.accelerator.total_memory(), n_devices=n_devices,
        tp_shardable=tp_shardable)


def place_params(engine, params: Optional[Any] = None) -> Optional[Any]:
    """Resolve the serve mode, then place the weights for it. `params` is a
    JAX parameter tree of numpy arrays (its quantized leaves kept as given)
    or None for the module's own weights.

    Unquantized, the module holds the weights, cast to the config's dtype on
    the engine's device, and None is returned. Quantized (`quant.enabled`),
    the weights become a JAX-layout tree of torch tensors, cast to the dtype
    and placed first as the JAX package does: `layer_scan` quantizes the
    layer stacks per layer, `dequant` the whole tree. The module's own
    storage moves to the meta device (it keeps its structure, and runs on a
    tree's weights through `torch.func.functional_call`), and the tree is
    returned.

    Capacity: the runner builds its tiers from `params` or the module's
    own weights, the module is replaced by a skeleton on the meta device
    (the engine keeps no reference to the caller's weights), and the
    runner's `params_view()` is returned.

    Under a tensor-parallel topology (`engine.topology`) the placed weights
    are this rank's shard (module docstring), and under an expert-parallel
    one its experts' share; `params` is the whole tree."""
    cfg = engine._config
    model = engine.module
    engine._quantized = bool(cfg.quant and cfg.quant.get("enabled"))
    engine._capacity = None
    mode = _ALIASES.get(cfg.serve_mode, cfg.serve_mode)
    if getattr(model, "resident_bf16_only", False) and (engine._quantized
                                                        or mode in ("layer_scan", "capacity")):
        # the zoo families serve their bf16 weights resident on the card
        what = "quant" if engine._quantized else f"serve_mode={cfg.serve_mode!r}"
        raise _unported(f"{what} on {type(model).__name__}",
                        "Weight quantization and serve modes")
    built = {"model": (getattr(model, "tp_size", 1), getattr(model, "tp_rank", 0)),
             "expert": (getattr(model, "ep_size", 1), getattr(model, "ep_rank", 0))}
    shard_built = any(n > 1 for n, _ in built.values())
    if params is not None:
        shapes = params
    else:  # the whole tree's shapes, also for a module built as a shard
        whole = type(model)(model.cfg, device="meta") if shard_built else model
        shapes = whole.param_tree(device="meta")
    engine.serve_mode = resolve_serve_mode(engine, shapes)
    if engine.serve_mode == "capacity":
        from deepspeed_tpu_torch.inference.capacity_scan import CapacityRunner
        engine._capacity = CapacityRunner(
            engine.model_cfg, cfg, params if params is not None else model, engine.device,
            quantized=engine._quantized, group_size=int((cfg.quant or {}).get("group_size", 256)),
            options=cfg.capacity, fused=use_fused_int8(engine))
        engine.module = type(model)(model.cfg, device="meta").eval()
        return engine._capacity.params_view()
    if engine._quantized and not qls.layer_scan_supported(shapes):
        raise _unported(f"quant on {type(model).__name__} (int8 weights outside the "
                        "llama layer-scan layout)", "Weight quantization and serve modes")
    topo = engine.topology
    axis = "expert" if topo.ep_size > 1 else "model"
    size, rank = topo.axis_size(axis), topo.coord(axis)
    prefix = {"model": "tp", "expert": "ep"}
    for a, (n, r) in built.items():
        if n > 1 and (a, n, r) != (axis, size, rank):
            raise ValueError(
                f"init_inference: the module is rank {r}'s shard of {prefix[a]}={n}, and "
                f"this process is rank {rank} of the {axis} axis of {size}")
    if size > 1 and not shard_built:
        # a whole module: rebuilt as this rank's shard, fed the cut whole tree
        if params is None:
            params = model.param_tree(dtype=cfg.dtype, release=True)
        model = type(model)(model.cfg, device="meta", **{f"{prefix[axis]}_size": size,
                                                         f"{prefix[axis]}_rank": rank})
        if not engine._quantized:
            model = model.to_empty(device=engine.device)
    whole = size > 1 and params is not None  # cut after quantizing
    if not engine._quantized:
        if params is not None:
            if next(model.parameters()).is_meta:
                # a skeleton (`module_inject.load_hf_checkpoint`): the weights are the tree's
                model = model.to(dtype=cfg.dtype).to_empty(device=engine.device)
            model.load_jax_params(shard_tree(params, size, rank, axis) if whole else params)
        engine.module = model.to(device=engine.device, dtype=cfg.dtype).eval()
        return None
    if params is not None:
        tree = tree_to_torch(params, dtype=cfg.dtype, device=engine.device)
        engine.module = model.to("meta").eval()
    else:
        tree = model.param_tree(dtype=cfg.dtype, device=engine.device, release=True)
        engine.module = model.eval()
    group, min_size = int(cfg.quant.get("group_size", 256)), 4096
    if size > 1 and not whole:
        # the quantizer takes a leaf by its whole size; every leaf it can
        # take (the kernels, the embedding, the head) is cut tp ways
        min_size = -(-min_size // size)
        _check_shard_quantizable(tree, group, engine.serve_mode == "layer_scan", min_size)
    if engine.serve_mode == "layer_scan":
        tree = qls.quantize_layer_stacks(tree, group_size=group, min_size=min_size)
        if whole and cfg.fused_int8 is not False:
            qls.check_tp_flavors(tree, size)
    else:
        tree = quantize_param_tree(tree, group_size=group, min_size=min_size)[0]
    return shard_tree(tree, size, rank, axis) if whole else tree


def _check_shard_quantizable(tree, group: int, layer_scan: bool, min_size: int) -> None:
    """A shard quantized on its own equals the matching cut of the
    quantized whole only when every block of `group` elements lies inside
    one row of a kernel it quantizes: the layer stacks' of at least
    `min_size` elements a layer (layer scan), or every such matrix's (the
    whole tree)."""
    leaves = tree_leaves(tree["layers"]) if layer_scan else tree_leaves(tree)
    for leaf in leaves:
        dims = 3 if layer_scan else 2
        size = leaf[0].numel() if layer_scan and leaf.dim() >= 3 else leaf.numel()
        if leaf.dim() >= dims and size >= min_size and leaf.shape[-1] % group:
            raise ValueError(
                f"quant group_size={group} does not tile the {tuple(leaf.shape[1:])} rows of "
                "a tensor-parallel shard: pass the whole tree as params, which is "
                "quantized before it is cut")


def use_fused_int8(engine) -> bool:
    """The fused dequant-GEMM (K5) in the streamed modes: `fused_int8=None`
    means the kernel on CUDA; an explicit False is the naive dequant
    matmul."""
    fused = engine._config.fused_int8
    return bool(fused) if fused is not None else engine.accelerator.is_cuda


def dense_state(engine) -> Optional[dict]:
    """With `quant`: the module's parameters from the engine's int8 tree,
    dequantized whole in the serving dtype, for `torch.func.functional_call`
    (the JAX engines' `_maybe_dequant`); else None (the module's own
    weights)."""
    if not engine._quantized:
        return None
    return engine.module.module_state(
        dequantize_param_tree(engine.params, dtype=engine._config.dtype))
