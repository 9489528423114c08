"""Serve-mode resolution and weight placement (counterpart of ``deepspeed_tpu/inference/serve_modes.py``).

Both inference engines place their weights here. `dequant` serves the
module's own weights, or with `quant` a whole-tree int8 form dequantized at
use; `layer_scan` serves a per-layer-stacked int8 tree through
`quantized_layer_scan`; `auto` picks by `config.choose_serve_mode`, fed the
card's memory. A resolved `capacity` raises: the capacity runner, the OOM
degradation ladder (`degraded_mode`, `note_degraded`), the telemetry and the
memory plane are not ported (ROADMAP.md, Queue 1, 'The rest' and 'Weight
quantization and serve modes').

The `engine` argument is duck-typed: the functions read `module`,
`model_cfg`, `_config`, `accelerator` and `device`, and write
`serve_mode`, `_quantized` and `module` back. The weights are reached
through the module's own `param_tree`, `load_jax_params` and
`module_state`, so any model family that has them is placed here. `quant`
on a tree without the layer-scan layout (the MoE families) raises: a
whole-tree int8 MoE tree is not ported (ROADMAP.md, Queue 1, 'Weight
quantization and serve modes').
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
from deepspeed_tpu_torch.models.llama import tree_to_torch
from deepspeed_tpu_torch.utils.logging import logger

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


def resolve_serve_mode(engine, params: Any) -> str:
    """The serve mode for `params`, a JAX-layout tree (torch, numpy or meta
    leaves). `auto` accounts the weights in each mode's at-rest form plus
    the KV cache and decode workspace at the config's max batch and out
    tokens, against the card's memory."""
    config = engine._config
    mode = getattr(config, "serve_mode", "auto") or "auto"
    mode = _ALIASES.get(mode, mode)
    if mode not in ("auto", "dequant", "layer_scan", "capacity"):
        raise ValueError(
            f"init_inference: unknown serve_mode {mode!r} (expected "
            "'auto', 'dequant', 'layer_scan' or 'capacity')")
    layout_ok = isinstance(params, dict) and qls.layer_scan_supported(params)
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
    return choose_serve_mode(
        quantized=engine._quantized, layout_ok=layout_ok, multi_device=False,
        dense_bytes=dense, int8_bytes=int8, layer_bytes=dense // max(1, int(num_layers)),
        kv_bytes=kv_cache_bytes(cfg, b, max_len, config.dtype,
                                kv_dtype=getattr(config, "kv_cache_dtype", None)),
        workspace_bytes=decode_workspace_bytes(cfg, b, max_len, config.dtype),
        hbm_bytes=engine.accelerator.total_memory())


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
    returned."""
    cfg = engine._config
    model = engine.module
    engine._quantized = bool(cfg.quant and cfg.quant.get("enabled"))
    shapes = params if params is not None else model.param_tree(device="meta")
    engine.serve_mode = resolve_serve_mode(engine, shapes)
    if engine.serve_mode == "capacity":
        raise _unported("serve_mode='capacity' (resolved by 'auto')", "The rest")
    if engine._quantized and not qls.layer_scan_supported(shapes):
        raise _unported(f"quant on {type(model).__name__} (int8 weights outside the "
                        "llama layer-scan layout)", "Weight quantization and serve modes")
    if not engine._quantized:
        if params is not None:
            model.load_jax_params(params)
        engine.module = model.to(device=engine.device, dtype=cfg.dtype).eval()
        return None
    if params is not None:
        tree = tree_to_torch(params, dtype=cfg.dtype, device=engine.device)
        engine.module = model.to("meta").eval()
    else:
        tree = model.param_tree(dtype=cfg.dtype, device=engine.device, release=True)
        engine.module = model.eval()
    group = int(cfg.quant.get("group_size", 256))
    if engine.serve_mode == "layer_scan":
        return qls.quantize_layer_stacks(tree, group_size=group)
    return quantize_param_tree(tree, group_size=group)[0]


def dense_state(engine) -> Optional[dict]:
    """With `quant`: the module's parameters from the engine's int8 tree,
    dequantized whole in the serving dtype, for `torch.func.functional_call`
    (the JAX engines' `_maybe_dequant`); else None (the module's own
    weights)."""
    if not engine._quantized:
        return None
    return engine.module.module_state(
        dequantize_param_tree(engine.params, dtype=engine._config.dtype))
