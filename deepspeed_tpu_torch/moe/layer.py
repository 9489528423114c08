"""MoE layer and experts (counterpart of ``deepspeed_tpu/moe/layer.py``).

`Experts` holds the expert stacks in the JAX package's layout, `gate`/`up`
(E, D, F) and `down` (E, F, D), so the grouped GEMM (K6) reads each
expert's weight as its (K, N) rhs with no transpose. `TopKGate` holds the
router `wg` (D, E) and computes its logits in f32. `MoE` runs one of the
dispatches of `sharded_moe.py`, chosen by `dispatch_impl` with the JAX
package's `auto` rule: the grouped GEMM for inference at b·s·k ≥ 1024 rows,
the ragged buffer otherwise. There is one process, so the grouped GEMM
always runs unsharded (the JAX `_gmm_mesh` of a trivial mesh).

Parameters are `param_dtype` (f32) at construction, as in the JAX package;
the engines cast them to their dtype, and the products run in `dtype`. Each
call leaves on the module what the JAX layer `sow`s: the load-balancing
aux loss `l_aux` (differentiable to the router `wg`), `router_load` (E,),
the share of the T·k expert assignments routed to each expert (before the
capacity cut; after it on the einsum path, as in JAX), and `router_drop`
(), the share the capacity limit dropped. The decoder blocks read them
right after the call and return them, so that a recomputed block
(`torch.utils.checkpoint`) cannot replace the ones the loss uses. In
training, the grouped GEMM is differentiable (`ops/cuda/grouped_gemm.py`,
K6 and its backward kernels). Not ported: expert parallelism (`ep_size >
1`, ROADMAP.md, Queue 1, 'Multi-GPU') and the PR-MoE residual expert
(`use_residual`, Queue 1, 'MoE: the rest').
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.moe.sharded_moe import (
    _gating_core,
    dispatch_combine,
    dispatch_combine_gmm,
    dispatch_combine_ragged,
    gate_noise,
    topkgating,
)
from deepspeed_tpu_torch.ops.cuda.grouped_gemm import grouped_gemm
from deepspeed_tpu_torch.runtime.config_utils import unported

DISPATCH_IMPLS = ("auto", "gmm", "ragged", "einsum")
GMM_MIN_ROWS = 1024   # `auto` takes the grouped GEMM for inference from here


def choose_dispatch(impl: str, train: bool, rows: int) -> str:
    """The dispatch `MoE` runs for `rows` = b·s·k (token, expert) rows:
    `auto` is the grouped GEMM for inference at ≥ 1024 rows, else ragged."""
    if impl != "auto":
        return impl
    return "gmm" if not train and rows >= GMM_MIN_ROWS else "ragged"


class Experts(nn.Module):
    """E expert FFNs: gated SiLU (`gate`, `up`, `down`) or plain GELU (`up`,
    `down`; the JAX package's tanh-approximated `nn.gelu`)."""

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 dtype=torch.bfloat16, activation: str = "silu", device=None,
                 param_dtype=torch.float32):
        super().__init__()
        factory = dict(device=device, dtype=param_dtype)
        if activation not in ("silu", "gelu"):
            raise ValueError(f"Experts: activation {activation!r} is not 'silu' or 'gelu'")
        e, d, f = num_experts, hidden_size, intermediate_size
        self.compute_dtype = dtype
        self.up = nn.Parameter(torch.empty(e, d, f, **factory))
        self.down = nn.Parameter(torch.empty(e, f, d, **factory))
        self.gate = nn.Parameter(torch.empty(e, d, f, **factory)) \
            if activation == "silu" else None
        for p in self.parameters():
            nn.init.normal_(p, std=0.02)   # the JAX package's initializer

    def forward(self, x: torch.Tensor,
                group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Batched: x (E, C, D) → (E, C, D). Grouped, when `group_sizes` is
        given: x (M, D) rows sorted by expert, each expert's span through
        its FFN as grouped GEMMs (K6), → (M, D)."""
        dt = self.compute_dtype
        w_up, w_down = self.up.to(dt), self.down.to(dt)
        w_gate = self.gate.to(dt) if self.gate is not None else None
        if group_sizes is not None:
            def gg(lhs, rhs):
                return grouped_gemm(lhs, rhs, group_sizes)
            if w_gate is not None:
                h = F.silu(gg(x, w_gate)) * gg(x, w_up)
            else:
                h = F.gelu(gg(x, w_up), approximate="tanh")
            return gg(h, w_down)
        if w_gate is not None:
            h = F.silu(torch.einsum("ecd,edf->ecf", x, w_gate)) * \
                torch.einsum("ecd,edf->ecf", x, w_up)
        else:
            h = F.gelu(torch.einsum("ecd,edf->ecf", x, w_up), approximate="tanh")
        return torch.einsum("ecf,efd->ecd", h, w_down)


class TopKGate(nn.Module):
    """The router: logits = x(f32) @ wg, then top-k gating."""

    def __init__(self, hidden_size: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 8, drop_tokens: bool = True,
                 noisy_gate_policy: Optional[str] = None, norm_topk_prob: bool = True,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.drop_tokens = drop_tokens
        self.noisy_gate_policy = noisy_gate_policy
        self.norm_topk_prob = norm_topk_prob
        self.wg = nn.Parameter(torch.empty(hidden_size, num_experts, device=device,
                                           dtype=param_dtype))
        nn.init.normal_(self.wg, std=0.02)

    def forward(self, x: torch.Tensor, train: bool = True,
                noise_rng: Optional[torch.Generator] = None, ragged: bool = False,
                drop_tokens: Optional[bool] = None, noise: Optional[torch.Tensor] = None):
        """x (T, D). `ragged` gives the index form (l_aux, gate_k, topk_idx,
        pos_k, kept, cap), else (l_aux, combine, dispatch, cap).
        `drop_tokens` overrides the gate's own setting for this call;
        `noise` gives the RSample uniforms (T, E) instead of `noise_rng`."""
        logits = x.float() @ self.wg.float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        policy = self.noisy_gate_policy if train else None
        drop = self.drop_tokens if drop_tokens is None else drop_tokens
        if ragged:
            l_aux, gate_k, topk_idx, pos_k, kept, _, cap = _gating_core(
                logits, self.k, cf, self.min_capacity, drop, noise_rng, policy,
                self.norm_topk_prob, noise)
            return l_aux, gate_k, topk_idx, pos_k, kept, cap
        return topkgating(logits, self.k, cf, self.min_capacity, drop, noise_rng,
                          policy, self.norm_topk_prob, noise)


class MoE(nn.Module):
    """MoE FFN block: (B, S, D) → (B, S, D). The aux loss and the router
    telemetry of the call are left in `self.l_aux`, `self.router_load` and
    `self.router_drop`."""

    def __init__(self, hidden_size: int, num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 intermediate_size: Optional[int] = None, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 drop_tokens: bool = True, noisy_gate_policy: Optional[str] = None,
                 norm_topk_prob: bool = True, use_residual: bool = False,
                 dtype=torch.bfloat16, activation: str = "silu",
                 dispatch_impl: str = "auto", device=None, param_dtype=torch.float32):
        super().__init__()
        factory = dict(device=device, param_dtype=param_dtype)
        if ep_size > 1:
            raise unported("expert parallelism (ep_size > 1)", "Multi-GPU")
        if use_residual:
            raise unported("MoE use_residual (PR-MoE residual expert)", "MoE: the rest")
        if dispatch_impl not in DISPATCH_IMPLS:
            raise ValueError(f"MoE: dispatch_impl {dispatch_impl!r} not in {DISPATCH_IMPLS}")
        self.num_experts, self.k = num_experts, k
        self.dispatch_impl = dispatch_impl
        self.gate = TopKGate(hidden_size, num_experts, k, capacity_factor,
                             eval_capacity_factor, min_capacity, drop_tokens,
                             noisy_gate_policy, norm_topk_prob, **factory)
        self.experts = Experts(num_experts, hidden_size, intermediate_size or 4 * hidden_size,
                               dtype, activation, **factory)
        self.l_aux: Optional[torch.Tensor] = None
        self.router_load: Optional[torch.Tensor] = None
        self.router_drop: Optional[torch.Tensor] = None

    def draw_gate_noise(self, tokens: int,
                        generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        """The RSample uniforms (tokens, E) a training call with
        `noise_rng=generator` would draw, or None where it draws none. A
        caller that recomputes the call (a checkpointed block) draws them
        once, before it."""
        if generator is None or self.gate.noisy_gate_policy != "RSample":
            return None
        return gate_noise((tokens, self.num_experts), generator)

    def forward(self, hidden_states: torch.Tensor, train: bool = True,
                noise_rng: Optional[torch.Generator] = None,
                drop_tokens: Optional[bool] = None,
                gate_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`train` picks the capacity factor and the `auto` rule as the JAX
        layer's `train` does (not torch's grad mode); `drop_tokens`
        overrides the gate's setting for this call; `gate_noise` gives the
        RSample uniforms (`draw_gate_noise`) in place of `noise_rng`."""
        b, s, d = hidden_states.shape
        x = hidden_states.reshape(b * s, d)
        impl = choose_dispatch(self.dispatch_impl, train, b * s * self.k)
        assignments = float(b * s * self.k)
        if impl == "einsum":
            l_aux, combine, dispatch, _ = self.gate(x, train, noise_rng,
                                                    drop_tokens=drop_tokens, noise=gate_noise)
            out = dispatch_combine(x, combine, dispatch, self.experts)
            # only the post-capacity dispatch mask is at hand: its load is
            # post-drop (sums to 1 - drop), as in the JAX layer
            d32 = dispatch.detach().float()
            router_load = d32.sum(dim=(0, 2)) / assignments
            router_drop = 1.0 - d32.sum() / assignments
        else:
            l_aux, gate_k, topk_idx, pos_k, kept, cap = self.gate(
                x, train, noise_rng, ragged=True, drop_tokens=drop_tokens, noise=gate_noise)
            if impl == "gmm":
                out = dispatch_combine_gmm(x, gate_k, topk_idx, self.num_experts,
                                           self.experts)
            else:
                out = dispatch_combine_ragged(x, gate_k, topk_idx, pos_k, kept, cap,
                                              self.num_experts, self.experts)
            flat = topk_idx.reshape(-1)
            router_load = torch.zeros(self.num_experts, device=x.device).scatter_add_(
                0, flat, torch.ones(flat.shape, device=x.device)) / assignments
            router_drop = 1.0 - kept.detach().float().sum() / assignments
        self.l_aux, self.router_load, self.router_drop = l_aux, router_load, router_drop
        return out.reshape(b, s, d)
