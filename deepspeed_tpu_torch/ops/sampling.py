"""Token sampling: greedy, temperature, top-k and top-p (counterpart of ``deepspeed_tpu/ops/sampling.py``).

Draws come from an explicit `torch.Generator`; JAX's and PyTorch's random
streams differ, so the same seed gives other tokens than the JAX package
does, from the same distribution.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches `p` (always at least the top-1); everything else is
    masked to -inf."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep while the exclusive prefix mass is < p; the top-1 always stays
    keep_sorted = (cum - probs) < p
    keep_sorted[..., :1] = True
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits,
                       torch.full_like(logits, float("-inf")))


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit to -inf."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, float("-inf")), logits)


def row_generator(seed: int, fold: int, device=None) -> torch.Generator:
    """The generator of one row's own stream, seeded from (seed, fold): the
    counterpart of JAX's `fold_in(key, fold)`. A serving engine folds in the
    sequence uid, so a row's draws depend on (seed, uid, draw index) and not
    on the cache slot it was given."""
    gen = torch.Generator(device=device)
    gen.manual_seed(hash((int(seed), int(fold))) & 0xFFFF_FFFF_FFFF_FFFF)
    return gen


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0,
                  row_generators: Optional[Sequence[torch.Generator]] = None
                  ) -> torch.Tensor:
    """Sample token ids from `logits` (..., V) → (...,) int64.

    temperature == 0 → greedy argmax (the generator is unused). Otherwise
    temperature scaling, then the top-k cut, then the top-p cut, then a
    categorical draw with `generator`. `row_generators` (one per row of
    (B, V) logits, from `row_generator`) draws each row from its own stream
    instead (the JAX package's `row_fold`)."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k and top_k > 0:
        logits = top_k_mask(logits, top_k)
    if top_p is not None and top_p < 1.0:
        logits = top_p_mask(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    if row_generators is not None:
        if probs.dim() != 2 or probs.shape[0] != len(row_generators):
            raise ValueError("row_generators needs (B, V) logits and one "
                             "generator per row")
        return torch.cat([torch.multinomial(row[None], 1, generator=gen)[0]
                          for row, gen in zip(probs, row_generators)])
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(probs.shape[:-1])
