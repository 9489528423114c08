"""Shared model-zoo pieces: the causal-LM loss (counterpart of
``deepspeed_tpu/models/common.py``).

The loss is computed in f32, with `IGNORE_INDEX` labels left out of the
mean, as in the JAX package. A loss function for the engine has the
signature `loss_fn(module, batch)` and returns the loss or `(loss, aux)`.
"""

from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


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
