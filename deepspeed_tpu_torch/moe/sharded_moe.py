"""MoE gating and dispatch (counterpart of ``deepspeed_tpu/moe/sharded_moe.py``).

Softmax gate, top-k expert choice with a capacity limit, the
load-balancing aux loss, and three dispatches that consume the same
decisions (`_gating_core`): the one-hot einsum golden path
(`dispatch_combine`), the scatter/gather buffer (`dispatch_combine_ragged`)
and the expert-sorted rows of the grouped GEMM (`dispatch_combine_gmm`,
kernel K6).

Expert parallelism: every rank holds the whole batch and routes it the same
way; `expert_fn` is the rank's `Experts`, which holds E/ep experts. The
grouped route's `expert_fn` returns the (T·k, D) rows already summed over
`expert` (K8-e and its all-reduce), with `group_sizes` over all E. On the
buffer routes it returns the rank's (E/ep, C, D) slice of the expert
outputs, and `_expert_outputs` all-gathers the slices over `expert` into
the whole (E, C, D) buffer: the JAX package's sharding transition at
`shard_along(expert_outputs, "expert", ...)`, after which the combine runs
as at ep = 1, on the same bits. Token-sharded dense layers with an
all-to-all (the reference's `_AllToAll`) are not ported (ROADMAP.md,
Queue 1, 'Multi-GPU').

Data parallelism: under GSPMD the JAX gate sees the global token axis,
the data ranks' rows in rank order. Over dp > 1 data ranks (a process
group up, the installed topology's `data` axis) each rank gates its own
rows with the global batch's decisions (`_route`): one all-gather over
`data` of each rank's per-slot, per-expert counts (k, E) and its gate
probabilities summed over its tokens gives the capacity from the global
token count, each token's place in its expert's k-major order (the earlier
slots' global totals, then the lower ranks' counts in its slot, then its
own rows' cumsum), `me` and `ce` as global means, and the router telemetry
as global shares. The dispatch buffers stay local. Each rank adds the same
global `l_aux`, and the engine averages the ranks' gradients, so the
backward of a rank's probability sum is scaled by dp, as the cross
entropy's label count is (`models/common.py`). The noisy gate's uniforms
are drawn for the global batch from the generator every rank holds alike,
each rank keeping its rows' (`gate_noise`): the ranks' draws differ, and
dp = 2 draws what dp = 1 draws for the same batch.

Nothing here reads a tensor back to the host: group sizes are built with
`scatter_add_`, dropped slots go to a trash row, and `argsort` is stable,
as JAX's is (`order // k` depends on it).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import comm


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int, k: int = 1) -> int:
    cap = int(num_tokens * k / num_experts * capacity_factor)
    cap = max(cap, min_capacity)
    # rounded up to a multiple of 8, as the JAX package does
    return min(-(-cap // 8) * 8, num_tokens)


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, ties to the lower
    index first (`jax.lax.top_k`'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def data_ranks() -> Tuple[int, int]:
    """(dp, this rank's `data` coordinate) where a process group is up and
    the installed topology's `data` axis holds more than one rank, else
    (1, 0): the ranks whose rows the gate routes together."""
    from deepspeed_tpu_torch.utils import groups
    if not comm.is_initialized():
        return 1, 0
    try:
        topo = groups.get_topology(create_default=False)
    except RuntimeError:
        return 1, 0
    dp = topo.axis_size("data")
    return (dp, topo.coord("data")) if dp > 1 else (1, 0)


def gate_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """The uniform draws under `noisy_gate_policy="RSample"`'s Gumbel noise,
    from `generator`, on its device: over dp data ranks, this rank's rows
    of the draws for the global batch (module docstring)."""
    dp, rank = data_ranks()
    rows = shape[0]
    u = torch.rand((rows * dp,) + tuple(shape[1:]), generator=generator,
                   device=generator.device)
    return u[rank * rows:(rank + 1) * rows]


def _route(logits: torch.Tensor, k: int, capacity_factor: float, min_capacity: int,
           drop_tokens: bool, noise_rng: Optional[torch.Generator],
           noisy_gate_policy: Optional[str], norm_topk_prob: bool = True,
           noise: Optional[torch.Tensor] = None):
    """The top-k decisions of this rank's tokens (T of the dp ranks' T·dp,
    module docstring). Returns (l_aux, gate_k (T,k), topk_idx (T,k), pos_k
    (T,k), kept (T,k), masks (T,k,E), cap, load (E,)), `load` the global
    count of (token, slot) assignments to each expert before the capacity
    cut. Under `noisy_gate_policy="RSample"` the experts are chosen from the
    logits plus Gumbel noise, -log(-log(u)), with u drawn from `noise_rng`
    (a torch generator; its draws are not the JAX package's) or given as
    `noise` (T, E), drawn beforehand (`gate_noise`); the gate weights and the
    aux loss take the noiseless softmax, as in the JAX package. The JAX
    package has no "Jitter" policy, and neither has the port: it is
    ignored."""
    t, e = logits.shape
    dp, rank = data_ranks()
    tokens = t * dp
    cap = _capacity(tokens, e, capacity_factor, min_capacity, k)
    if not drop_tokens:
        cap = tokens  # every token can fit
    gates = torch.softmax(logits.float(), dim=-1)

    select_from = logits
    if noisy_gate_policy == "RSample" and noise is None and noise_rng is not None:
        noise = gate_noise(logits.shape, noise_rng)
    if noisy_gate_policy == "RSample" and noise is not None:
        select_from = logits - torch.log(-torch.log(noise.clamp_min(1e-20)))

    topk_idx = _top_k(select_from, k)                               # (T, k)
    masks = F.one_hot(topk_idx, e).float()                          # (T, k, E)

    # load-balancing aux loss from the top-1 assignment, over the dp ranks'
    # (k, E) counts and probability sums (at dp = 1, this rank's own)
    mine = gates.sum(dim=0)
    seen = torch.cat([masks.sum(dim=0), mine.detach()[None]])
    if dp > 1:
        seen = comm.all_gather(seen, group="data")
    seen = seen.view(dp, k + 1, e)
    counts = seen[:, :k]                                            # (dp, k, E)
    # the global mean, whose backward is dp times this rank's share
    me = (seen[:, k].sum(dim=0) + dp * (mine - mine.detach())) / tokens
    slots = counts.sum(dim=0)                                       # (k, E)
    ce = slots[0] / tokens
    # this rank's offset in each (slot, expert) column: the earlier slots'
    # global totals and the lower ranks' counts, less its own earlier slots
    # (0 at dp = 1)
    before = torch.cumsum(slots, dim=0) - slots
    own = torch.cumsum(counts[rank], dim=0) - counts[rank]
    offset = before + counts[:rank].sum(dim=0) - own
    l_aux = (me * ce).sum() * e

    # position of each token within its expert's capacity, ordered by k-slot
    # then token index: a cumsum over the k-major flattened mask, run along
    # the contiguous axis of its (E, k*T) transpose (CUDA's scan over an
    # outer axis took 1.4 ms a layer at T·k = 8192 on an NVIDIA H100 80GB
    # HBM3 at 700 W)
    flat = masks.permute(2, 1, 0).reshape(e, k * t)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    pos = pos_flat.reshape(e, k, t).permute(2, 1, 0) + offset       # (T, k, E)
    masks = masks * (pos < cap).float()

    # combine weights: gate prob per selected expert, renormalized over kept
    gate_k = torch.gather(gates, -1, topk_idx)                      # (T, k)
    kept = masks.sum(dim=-1)                                        # (T, k) 0/1
    gate_k = gate_k * kept
    if norm_topk_prob:
        denom = gate_k.sum(dim=-1, keepdim=True)
        gate_k = gate_k / denom.clamp_min(1e-9)

    pos_k = (pos * masks).sum(dim=-1).to(torch.int32)               # (T, k)
    return l_aux, gate_k, topk_idx, pos_k, kept, masks, cap, slots.sum(dim=0)


def _gating_core(logits: torch.Tensor, k: int, capacity_factor: float,
                 min_capacity: int, drop_tokens: bool,
                 noise_rng: Optional[torch.Generator], noisy_gate_policy: Optional[str],
                 norm_topk_prob: bool = True, noise: Optional[torch.Tensor] = None):
    """Shared top-k decisions (`_route` without the load): (l_aux, gate_k,
    topk_idx, pos_k, kept, masks, cap)."""
    return _route(logits, k, capacity_factor, min_capacity, drop_tokens, noise_rng,
                  noisy_gate_policy, norm_topk_prob, noise)[:7]


def combine_weights(gate_k: torch.Tensor, masks: torch.Tensor, pos_k: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """The (T, E, C) combine weights of the one-hot path."""
    loc = F.one_hot(pos_k.long(), cap).float()                      # (T, k, C)
    return torch.einsum("tk,tke,tkc->tec", gate_k, masks, loc)


def topkgating(logits: torch.Tensor, k: int, capacity_factor: float = 1.0,
               min_capacity: int = 8, drop_tokens: bool = True,
               noise_rng: Optional[torch.Generator] = None,
               noisy_gate_policy: Optional[str] = None, norm_topk_prob: bool = True,
               noise: Optional[torch.Tensor] = None):
    """Generalized top-k gating. logits (T, E) → (l_aux, combine weights
    (T, E, C), dispatch mask (T, E, C) bool, capacity C)."""
    l_aux, gate_k, _, pos_k, _, masks, cap = _gating_core(
        logits, k, capacity_factor, min_capacity, drop_tokens, noise_rng,
        noisy_gate_policy, norm_topk_prob, noise)
    combine = combine_weights(gate_k, masks, pos_k, cap)
    return l_aux, combine, combine > 0, cap


def topkgating_ragged(logits: torch.Tensor, k: int, capacity_factor: float = 1.0,
                      min_capacity: int = 8, drop_tokens: bool = True,
                      noise_rng: Optional[torch.Generator] = None,
                      noisy_gate_policy: Optional[str] = None,
                      norm_topk_prob: bool = True):
    """Index-form gating for the scatter/gather and grouped dispatches:
    (l_aux, gate_k, topk_idx, pos_k, kept, cap), the decisions of
    `topkgating`."""
    l_aux, gate_k, topk_idx, pos_k, kept, _, cap = _gating_core(
        logits, k, capacity_factor, min_capacity, drop_tokens, noise_rng,
        noisy_gate_policy, norm_topk_prob)
    return l_aux, gate_k, topk_idx, pos_k, kept, cap


def top1gating(logits, capacity_factor=1.0, min_capacity=8, drop_tokens=True,
               noise_rng=None, noisy_gate_policy=None):
    return topkgating(logits, 1, capacity_factor, min_capacity, drop_tokens,
                      noise_rng, noisy_gate_policy)


def top2gating(logits, capacity_factor=1.0, min_capacity=8, drop_tokens=True,
               noise_rng=None):
    return topkgating(logits, 2, capacity_factor, min_capacity, drop_tokens, noise_rng)


def _expert_outputs(expert_fn: Callable, expert_inputs: torch.Tensor) -> torch.Tensor:
    """`expert_fn` on the (E, C, D) buffer; an expert rank's slice
    (E/ep, C, D) is all-gathered over `expert` into the whole buffer."""
    num_experts = expert_inputs.shape[0]
    out = expert_fn(expert_inputs)
    if out.shape[0] != num_experts:
        out = comm.all_gather(out, group="expert", axis=0)
        if out.shape[0] != num_experts:
            raise RuntimeError(f"the expert ranks' slices hold {out.shape[0]} of "
                               f"{num_experts} experts")
    return out


def dispatch_combine(x: torch.Tensor, combine: torch.Tensor, dispatch: torch.Tensor,
                     expert_fn: Callable) -> torch.Tensor:
    """The one-hot einsum path: x (T, D) → expert inputs (E, C, D) →
    `expert_fn` → combined back to (T, D). O(T·E·C·D); the golden reference."""
    expert_inputs = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    expert_outputs = _expert_outputs(expert_fn, expert_inputs)
    return torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_outputs)


def dispatch_combine_gmm(x: torch.Tensor, gate_k: torch.Tensor, topk_idx: torch.Tensor,
                         num_experts: int, grouped_fn: Callable) -> torch.Tensor:
    """Expert-sorted rows for the grouped GEMM: the T·k (token, slot) rows
    stable-sorted by expert, `grouped_fn(rows, group_sizes)` runs the expert
    FFN on them (K6), and the combine gathers back to token order weighted
    by the gate. Capacity-dropped slots are computed but weight-zeroed
    (`gate_k` is masked by `kept`). Under expert parallelism the sizes
    stay over all E, and `grouped_fn` returns the rows summed over the
    expert ranks."""
    t, d = x.shape
    k = topk_idx.shape[1]
    flat_e = topk_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)      # token order within an expert
    xs = x.index_select(0, order // k)
    group_sizes = torch.zeros(num_experts, dtype=torch.int32, device=x.device)
    group_sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    out_s = grouped_fn(xs, group_sizes)             # (T·k, D)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    out_k = out_s.index_select(0, inverse).reshape(t, k, d)
    return torch.einsum("tk,tkd->td", gate_k.to(x.dtype), out_k)


def dispatch_combine_ragged(x: torch.Tensor, gate_k: torch.Tensor, topk_idx: torch.Tensor,
                            pos_k: torch.Tensor, kept: torch.Tensor, cap: int,
                            num_experts: int, expert_fn: Callable) -> torch.Tensor:
    """Scatter/gather dispatch, O(T·k·D) movement: tokens go into the
    (E, C, D) expert buffer at slot expert·C + pos, the experts run as one
    batched product, and the combine gathers back to token order weighted
    by the gate. A dropped slot is written to a trash row past the buffer
    and read back as zeros, where the JAX package writes out of bounds
    (`mode="drop"`) and reads with `mode="fill"`."""
    t, d = x.shape
    k = topk_idx.shape[1]
    trash = num_experts * cap
    dest = torch.where(kept > 0, topk_idx * cap + pos_k, trash).reshape(-1)
    xk = x[:, None].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((trash + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, xk)   # each (expert, slot) receives at most one token
    expert_outputs = _expert_outputs(expert_fn, buf[:trash].reshape(num_experts, cap, d))
    flat = torch.cat([expert_outputs.reshape(trash, d),
                      torch.zeros((1, d), dtype=expert_outputs.dtype, device=x.device)])
    out_k = flat.index_select(0, dest).reshape(t, k, d)
    return torch.einsum("tk,tkd->td", gate_k.to(x.dtype), out_k)
