"""Shared model-zoo pieces (counterpart of ``deepspeed_tpu/models/common.py``):
the zoo's projection (`Dense`), `LayerNorm` and `gelu`, its random initialisation
(`init_zoo`) and refused options (`check_zoo_config`), the causal-LM loss, and the
tensor-parallel pieces: a row-parallel `Dense` (`reduce_over=tp`), the
vocab-parallel embedding lookup and the head's logit gather. Each of those
raises unless the installed topology's `model` group holds the tp ranks the
shard was cut for: with fewer, its collective would be the identity and the
result a partial sum.

The loss is computed in f32, with `IGNORE_INDEX` labels left out of the
mean, as in the JAX package. Over dp > 1 data ranks (the `repl` x `data`
ranks a batch's rows are split over) the mean is the global batch's: each
rank divides its own tokens' sum by the ranks' count of labels (one
all-reduce) and multiplies by dp, so the ranks' losses and gradients
average to the global ones even when the ranks hold different numbers of
labels. Inside `rank_local_loss()` each rank's loss is the mean over its
own labels instead, as the JAX engine's manual regions (ZeRO++'s
quantized collectives, the 1-bit wire) compute it. A loss function for the engine has the
signature `loss_fn(module, batch)` and returns the loss or `(loss, aux)`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.zero.partition import gathered

IGNORE_INDEX = -100
_RANK_LOCAL = False


@contextlib.contextmanager
def rank_local_loss():
    """Inside, `cross_entropy_loss` is the mean over this rank's labels."""
    global _RANK_LOCAL
    before, _RANK_LOCAL = _RANK_LOCAL, True
    try:
        yield
    finally:
        _RANK_LOCAL = before


class Dense(nn.Linear):
    """`nn.Linear` that computes in the config's dtype, as flax's
    `nn.Dense(dtype=...)` casts its input and kernel (and bias, when it has
    one). `reduce_over=tp` (> 1) makes it row-parallel: the rank's partial
    product is all-reduced over the tp ranks of the `model` group, and the
    (whole) bias is added once, after the reduction."""

    def __init__(self, in_features, out_features, bias, compute_dtype, reduce_over: int = 1,
                 **factory):
        super().__init__(in_features, out_features, bias=bias, **factory)
        self.compute_dtype = compute_dtype
        self.reduce_over = reduce_over

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.reduce_over == 1:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        check_model_group(self.reduce_over, "a row-parallel Dense")
        y = comm.all_reduce(F.linear(x.to(dt), self.weight.to(dt)), group="model")
        return y if bias is None else y + bias


def gathered_block(layer: nn.Module, h, aux):
    """One decoder block on its whole parameters: at ZeRO stage 3 across
    data ranks (`runtime/zero/partition.gathered`) its pieces are gathered
    here, so under `torch.utils.checkpoint` the recompute in backward
    gathers them again and the checkpoint keeps only the rank's pieces."""
    with gathered(layer):
        return layer(h, aux)


def check_zoo_config(cfg) -> None:
    """The options the zoo's modules (BLOOM, phi, GPT-NeoX) refuse."""
    from deepspeed_tpu_torch.runtime.config_utils import unported
    if cfg.attn_impl == "ring":
        raise unported("attn_impl='ring'", "Multi-GPU")
    if cfg.remat and cfg.remat_policy != "nothing":
        raise unported(f"remat_policy={cfg.remat_policy!r}", "Training: the rest")


@torch.no_grad()
def init_zoo(model: nn.Module, generator: torch.Generator, std: float = 0.02) -> nn.Module:
    """Random weights as the JAX zoo initialises them: normal(std) for the
    embeddings and every kernel (the heads included), zeros for the biases,
    ones for the LayerNorm scales. Draws come from `generator`, which must
    live on the parameters' device."""
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=generator)
    return model


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """flax's `nn.gelu`: the tanh form with `approximate` (phi's
    `gelu_new`), else the exact erf form (GPT-NeoX's `gelu`), in x's dtype."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def check_model_group(tp: int, what: str) -> None:
    """Raise unless the `model` group holds the `tp` ranks a shard was cut
    for (a process group up, a topology of model=tp installed)."""
    from deepspeed_tpu_torch.utils import groups
    try:
        n = groups.get_topology(create_default=False).tp_size if comm.is_initialized() else 1
    except RuntimeError:
        n = 1
    if n != tp:
        raise RuntimeError(
            f"{what}: a shard of tp={tp} runs in a `model` group of {n} rank(s), whose "
            "collectives would leave partial sums; serve it from tp ranks "
            "(init_distributed, then init_inference with tensor_parallel.tp_size)")


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor, tp: int = 1,
                             rank: int = 0) -> torch.Tensor:
    """Embedding rows of `ids` from the rank's (V/tp, D) slice of the
    table: ids outside the slice look up zeros, and the all-reduce over
    the `model` group fills in every row (one rank holds each, so the sum
    is exact)."""
    if tp == 1:
        return F.embedding(ids, table)
    check_model_group(tp, "a vocab-parallel embedding")
    v = table.shape[0]
    local = ids - rank * v
    outside = (local < 0) | (local >= v)
    h = F.embedding(local.clamp(0, v - 1), table).masked_fill(outside[..., None], 0)
    return comm.all_reduce(h, group="model")


def gather_vocab(logits: torch.Tensor, tp: int = 1) -> torch.Tensor:
    """A column-parallel head's logits (..., V/tp) → (..., V), in rank
    order, on every rank."""
    if tp == 1:
        return logits
    check_model_group(tp, "a column-parallel head")
    return comm.all_gather(logits, group="model", axis=-1)


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
    """Mean token CE in f32. logits (B, S, V), labels (B, S); over dp data
    ranks, this rank's share (module docstring)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.clamp(0, logits.shape[-1] - 1).long()
    picked = torch.gather(logits, -1, idx[..., None])[..., 0]
    token_loss = lse - picked
    if z_loss > 0.0:
        token_loss = token_loss + z_loss * lse.square()
    mask = (labels != ignore_index).float()
    count = mask.sum()
    from deepspeed_tpu_torch.utils.groups import BATCH_AXES
    dp = comm.get_world_size(BATCH_AXES) if comm.is_initialized() and not _RANK_LOCAL else 1
    if dp > 1:
        count = comm.all_reduce(count.detach().clone(), group=BATCH_AXES) / dp
    return (token_loss * mask).sum() / count.clamp(min=1.0 / dp)


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
