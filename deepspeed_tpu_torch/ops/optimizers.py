"""Optimizers (counterpart of ``deepspeed_tpu/ops/optimizers.py``).

`fused_adam` is the JAX package's `GradientTransformation` pair over
name -> tensor dicts: `init(params) -> state` and `update(grads, state,
params, lr) -> (params, state)`. The JAX package leaves the update to XLA
fusion; here it is plain torch over lists of tensors (`torch._foreach_*`), taken
in runs of at most `CHUNK_ELEMENTS` elements so its temporaries stay small. Unlike the JAX function it updates `params` and the
moments in place, which saves a copy of the f32 master and both moments;
the engine skips the call on an overflowed step instead of selecting the
old values.

Only Adam and AdamW are ported; the other optimizers of the JAX package
raise in `build_optimizer`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.config_utils import unported

Tree = Dict[str, torch.Tensor]


# the update's f32 temporaries (denominator, step) cover at most this many
# elements at a time: ~1 GB each, where whole-model lists would add two f32
# copies of the model to the step's peak memory
CHUNK_ELEMENTS = 1 << 28


def _chunks(params: Tree):
    """The parameter names in order, cut into runs of at most
    CHUNK_ELEMENTS elements (a larger tensor is a run of its own)."""
    run, size = [], 0
    for name, p in params.items():
        if run and size + p.numel() > CHUNK_ELEMENTS:
            yield run
            run, size = [], 0
        run.append(name)
        size += p.numel()
    if run:
        yield run


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state)


class AdamState(NamedTuple):
    count: int
    exp_avg: Tree
    exp_avg_sq: Tree


def fused_adam(betas: Tuple[float, float] = (0.9, 0.999),
               eps: float = 1e-8,
               weight_decay: float = 0.0,
               adam_w_mode: bool = True,
               bias_correction: bool = True) -> GradientTransformation:
    """Adam/AdamW with the JAX package's arithmetic: update =
    (m/c1)/(sqrt(v/c2)+eps), plus wd*p in AdamW mode, then p -= lr*update;
    in Adam mode wd*p is added to the gradient instead."""
    b1, b2 = betas

    def init(params: Tree) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def update(grads: Tree, state: AdamState, params: Tree, lr: float):
        count = state.count + 1
        if bias_correction:  # in f32, as the JAX package computes them
            c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        else:
            c1 = c2 = 1.0
        for names in _chunks(params):
            p = [params[k] for k in names]
            g = [grads[k] for k in names]
            m = [state.exp_avg[k] for k in names]
            v = [state.exp_avg_sq[k] for k in names]
            if not adam_w_mode and weight_decay > 0.0:
                g = torch._foreach_add(g, p, alpha=weight_decay)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, g, g, value=1 - b2)
            denom = torch._foreach_div(v, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(m, c1)
            torch._foreach_div_(upd, denom)
            del denom
            if adam_w_mode and weight_decay > 0.0:
                torch._foreach_add_(upd, p, alpha=weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr)
        return params, AdamState(count, state.exp_avg, state.exp_avg_sq)

    return GradientTransformation(init, update)


_UNPORTED = ("onebitadam", "zerooneadam", "onebitlamb", "lamb", "fusedlamb", "lion",
             "fusedlion", "cpulion", "adagrad", "cpuadagrad", "sgd", "musgd", "muadam",
             "muadamw")


def build_optimizer(name: str, params_cfg: Dict[str, Any]) -> Tuple[GradientTransformation, float]:
    """(transform, base_lr) from a DeepSpeed optimizer config's type and params."""
    name = (name or "adam").lower()
    lr = float(params_cfg.get("lr", 1e-3))
    betas = tuple(params_cfg.get("betas", (0.9, 0.999)))
    eps = float(params_cfg.get("eps", 1e-8))
    wd = float(params_cfg.get("weight_decay", 0.0))
    if name in ("adam", "fusedadam", "cpuadam"):
        # DeepSpeed semantics: adam_w_mode defaults True even for type "Adam"
        return fused_adam(betas=betas, eps=eps, weight_decay=wd,
                          adam_w_mode=bool(params_cfg.get("adam_w_mode", True)),
                          bias_correction=bool(params_cfg.get("bias_correction", True))), lr
    if name == "adamw":
        return fused_adam(betas=betas, eps=eps, weight_decay=wd, adam_w_mode=True), lr
    if name in _UNPORTED:
        raise unported(f"optimizer {name!r}", "Training: the rest")
    raise ValueError(f"Unknown optimizer type: {name}")
