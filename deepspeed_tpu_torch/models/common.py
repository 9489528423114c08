"""Shared model-zoo pieces (counterpart of ``deepspeed_tpu/models/common.py``):
the zoo's projection (`Dense`) and `LayerNorm`, and the causal-LM loss.

The loss is computed in f32, with `IGNORE_INDEX` labels left out of the
mean, as in the JAX package. A loss function for the engine has the
signature `loss_fn(module, batch)` and returns the loss or `(loss, aux)`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

IGNORE_INDEX = -100


class Dense(nn.Linear):
    """`nn.Linear` that computes in the config's dtype, as flax's
    `nn.Dense(dtype=...)` casts its input and kernel (and bias, when it has
    one)."""

    def __init__(self, in_features, out_features, bias, compute_dtype, **factory):
        super().__init__(in_features, out_features, bias=bias, **factory)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """flax's `nn.LayerNorm(dtype=...)` with a scale and a bias: the
    statistics in f32 (var = E[x²] − E[x]², clipped at 0), the normalised
    value times the scale plus the bias in f32, cast to `compute_dtype`.
    Parameters are named `scale` and `bias`, as in the JAX tree."""

    def __init__(self, hidden: int, eps: float, compute_dtype, **factory):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.scale = nn.Parameter(torch.ones(hidden, **factory))
        self.bias = nn.Parameter(torch.zeros(hidden, **factory))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((x32 - mean) * mul + self.bias.float()).to(self.compute_dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE_INDEX,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Mean token CE in f32. logits (B, S, V), labels (B, S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.clamp(0, logits.shape[-1] - 1).long()
    picked = torch.gather(logits, -1, idx[..., None])[..., 0]
    token_loss = lse - picked
    if z_loss > 0.0:
        token_loss = token_loss + z_loss * lse.square()
    mask = (labels != ignore_index).float()
    return (token_loss * mask).sum() / mask.sum().clamp(min=1.0)


def shift_labels(input_ids: torch.Tensor, ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Next-token labels: labels[t] = input_ids[t+1]; the last position is ignored."""
    return torch.cat([input_ids[:, 1:], torch.full_like(input_ids[:, :1], ignore_index)],
                     dim=1)


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                   labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    if labels is None:
        labels = shift_labels(input_ids)
    return cross_entropy_loss(logits, labels)


def collect_router_metrics(router_load, router_drop) -> dict:
    """Per-layer router telemetry of an MoE model's call: the MoE layers'
    `router_load` (E,) and `router_drop` () in layer order, stacked to
    (L, E) and (L,) as the JAX package's `nn.scan` stacks what its layers
    `sow`. Returned as plain aux-dict entries."""
    return {"router_load": torch.stack(list(router_load)),
            "router_drop": torch.stack(list(router_drop))}


def make_causal_loss_fn(model=None):
    """Engine loss function for a causal-LM zoo model: labels shifted from
    `input_ids` when the batch carries none. The engine passes its module,
    so `model` is kept only for the JAX signature."""
    def loss_fn(module, batch):
        ids = batch["input_ids"]
        labels = batch.get("labels")
        if labels is None:
            labels = shift_labels(ids)
        return module(ids, labels=labels)
    return loss_fn
