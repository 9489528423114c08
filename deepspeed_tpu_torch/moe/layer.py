"""MoE layer and experts (counterpart of ``deepspeed_tpu/moe/layer.py``).

`Experts` holds the expert stacks in the JAX package's layout, `gate`/`up`
(E, D, F) and `down` (E, F, D), so the grouped GEMM (K6) reads each
expert's weight as its (K, N) rhs with no transpose. `TopKGate` holds the
router `wg` (D, E) and computes its logits in f32. `MoE` runs one of the
dispatches of `sharded_moe.py`, chosen by `dispatch_impl` with the JAX
package's `auto` rule: the grouped GEMM for inference at b·s·k ≥ 1024 rows
where the topology lets it run (`gmm_mesh`, the JAX `_gmm_mesh`), the
ragged buffer otherwise.

Expert parallelism (serving only): built with `ep_size` > 1 and `ep_rank`
(by default the installed topology's `expert` coordinate), `Experts` holds
experts [ep_rank·E/ep, (ep_rank+1)·E/ep) of each stack, and the router and
everything else stay whole on every rank. Every rank routes the same
tokens the same way. The grouped route runs K8-e (`sharded_grouped_gemm`)
over the rank's span and all-reduces once over `expert`, after `down`: a
row outside the span is zero after gate and up, and silu(0)·0 = 0, so the
sum equals the JAX package's all-reduce after each product bit for bit.
The ragged and einsum routes compute the rank's (E/ep, C, D) slice of the
expert buffer, which `sharded_moe.py` all-gathers over `expert`. A shard
runs only in an `expert` group of its ep ranks (with a process group up),
and a whole module only outside one; no backward is ported under expert
parallelism.

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
K6 and its backward kernels). Over dp > 1 data ranks each rank runs its
own rows through the gate's global decisions (`sharded_moe.py`) and any
dispatch, the grouped GEMM on its rows; `l_aux`, `router_load` and
`router_drop` are the global batch's. Not ported: training under expert
parallelism (ROADMAP.md, Queue 1, 'Multi-GPU') and the PR-MoE residual
expert (`use_residual`, Queue 1, 'MoE: the rest').
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.moe.sharded_moe import (
    _route,
    combine_weights,
    data_ranks,
    dispatch_combine,
    dispatch_combine_gmm,
    dispatch_combine_ragged,
    gate_noise,
)
from deepspeed_tpu_torch.ops.cuda.grouped_gemm import grouped_gemm, sharded_grouped_gemm
from deepspeed_tpu_torch.ops.cuda.sharded import kernel_fallback, serving_mesh
from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.utils import groups

DISPATCH_IMPLS = ("auto", "gmm", "ragged", "einsum")
GMM_MIN_ROWS = 1024   # `auto` takes the grouped GEMM for inference from here


def choose_dispatch(impl: str, train: bool, rows: int, gmm_ok: bool = True) -> str:
    """The dispatch `MoE` runs for `rows` = b·s·k (token, expert) rows:
    `auto` is the grouped GEMM for inference at ≥ 1024 rows where the
    topology lets it run (`gmm_ok`), else ragged."""
    if impl != "auto":
        return impl
    return "gmm" if not train and rows >= GMM_MIN_ROWS and gmm_ok else "ragged"


def _installed_topology() -> Optional["groups.MeshTopology"]:
    try:
        return groups.get_topology(create_default=False)
    except RuntimeError:
        return None


def gmm_mesh(num_experts: int) -> Tuple[Optional["groups.MeshTopology"], int]:
    """Where the grouped GEMM may run under the installed topology (the
    JAX `_gmm_mesh`): (None, 1) with every axis trivial or only `data`
    nontrivial, the kernel unsharded on the rank's rows; (topology, ep) on
    a pure `expert` topology with E % ep == 0, K8-e; (None, 0) on any other
    partitioned topology, where `auto` takes the ragged buffer and a forced
    `gmm` calls `kernel_fallback`."""
    topo = _installed_topology()
    if topo is None or topo.world_size == 1 or serving_mesh("data")[0] is not None:
        return None, 1      # a data rank runs the kernel on its own rows
    mesh, ep = serving_mesh("expert")
    if mesh is not None and ep > 1 and num_experts % ep == 0:
        return mesh, ep
    return None, 0


def expert_group(ep_size: int, ep_rank: int, what: str) -> Optional["groups.MeshTopology"]:
    """The installed topology when its `expert` axis holds the `ep_size`
    ranks a shard was built for, with this process as rank `ep_rank` and a
    process group up (whose all-reduce sums the ranks); None for a whole
    module (ep_size 1) outside such a group. Raises otherwise: a shard alone
    would leave partial sums, and a whole module on an expert rank would
    repeat every rank's work."""
    from deepspeed_tpu_torch import comm
    topo = _installed_topology()
    ep = topo.axis_size("expert") if topo is not None and comm.is_initialized() else 1
    rank = topo.coord("expert") if ep > 1 else 0
    if (ep, rank) != (ep_size, ep_rank):
        raise RuntimeError(
            f"{what}: experts built for rank {ep_rank} of ep={ep_size} run as rank {rank} "
            f"of an `expert` group of {ep} rank(s); serve a shard from its ep ranks "
            "(init_distributed, groups.initialize(MeshTopology(ep=...)), then "
            "init_inference, which builds each rank's shard)")
    return topo if ep > 1 else None


class Experts(nn.Module):
    """E expert FFNs: gated SiLU (`gate`, `up`, `down`) or plain GELU (`up`,
    `down`; the JAX package's tanh-approximated `nn.gelu`). With `ep_size`
    > 1 the module holds experts [first_expert, first_expert + E/ep) of the
    E (`num_experts` stays E)."""

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 dtype=torch.bfloat16, activation: str = "silu", device=None,
                 param_dtype=torch.float32, ep_size: int = 1, ep_rank: int = 0):
        super().__init__()
        factory = dict(device=device, dtype=param_dtype)
        if activation not in ("silu", "gelu"):
            raise ValueError(f"Experts: activation {activation!r} is not 'silu' or 'gelu'")
        if num_experts % ep_size:
            raise ValueError(f"Experts: {num_experts} experts not divisible by expert={ep_size}")
        if not 0 <= ep_rank < ep_size:
            raise ValueError(f"Experts: ep_rank={ep_rank} outside ep_size={ep_size}")
        e, d, f = num_experts // ep_size, hidden_size, intermediate_size
        self.num_experts, self.ep_size, self.ep_rank = num_experts, ep_size, ep_rank
        self.first_expert = ep_rank * e
        self.compute_dtype = dtype
        self.up = nn.Parameter(torch.empty(e, d, f, **factory))
        self.down = nn.Parameter(torch.empty(e, f, d, **factory))
        self.gate = nn.Parameter(torch.empty(e, d, f, **factory)) \
            if activation == "silu" else None
        for p in self.parameters():
            nn.init.normal_(p, std=0.02)   # the JAX package's initializer

    def forward(self, x: torch.Tensor,
                group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Batched: x (E, C, D) → (E, C, D), or under expert parallelism the
        rank's experts' slice (E/ep, C, D). Grouped, when `group_sizes` (E,)
        is given: x (M, D) rows sorted by expert, each expert's span through
        its FFN as grouped GEMMs (K6; K8-e under expert parallelism,
        all-reduced), → (M, D)."""
        mesh = expert_group(self.ep_size, self.ep_rank, "Experts")
        if mesh is not None and torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in self.parameters())):
            raise unported("training under expert parallelism", "Multi-GPU")
        dt = self.compute_dtype
        w_up, w_down = self.up.to(dt), self.down.to(dt)
        w_gate = self.gate.to(dt) if self.gate is not None else None
        if group_sizes is not None:
            if mesh is not None:
                def gg(lhs, rhs, reduce=False):
                    return sharded_grouped_gemm(lhs, rhs, group_sizes, mesh, reduce=reduce)
            else:
                if gmm_mesh(self.num_experts)[1] == 0:
                    kernel_fallback("grouped_gemm", "the topology is partitioned but not "
                                    "pure expert-parallel; running unsharded", x.device)

                def gg(lhs, rhs, reduce=False):
                    return grouped_gemm(lhs, rhs, group_sizes)
            if w_gate is not None:
                h = F.silu(gg(x, w_gate)) * gg(x, w_up)
            else:
                h = F.gelu(gg(x, w_up), approximate="tanh")
            return gg(h, w_down, reduce=True)
        if mesh is not None:
            x = x[self.first_expert:self.first_expert + w_up.shape[0]]
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
                noise_rng: Optional[torch.Generator] = None, drop_tokens: Optional[bool] = None,
                noise: Optional[torch.Tensor] = None):
        """x (T, D) → `sharded_moe._route`'s decisions (l_aux, gate_k,
        topk_idx, pos_k, kept, masks, cap, load). `drop_tokens` overrides
        the gate's own setting for this call; `noise` gives the RSample
        uniforms (T, E) instead of `noise_rng`."""
        logits = x.float() @ self.wg.float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        policy = self.noisy_gate_policy if train else None
        drop = self.drop_tokens if drop_tokens is None else drop_tokens
        return _route(logits, self.k, cf, self.min_capacity, drop, noise_rng, policy,
                      self.norm_topk_prob, noise)


class MoE(nn.Module):
    """MoE FFN block: (B, S, D) → (B, S, D). The aux loss and the router
    telemetry of the call are left in `self.l_aux`, `self.router_load` and
    `self.router_drop`. `ep_size` > 1 builds expert rank `ep_rank`'s shard
    (module docstring); `ep_rank` None takes the installed topology's
    `expert` coordinate, and an `ep_size` above 1 that the installed
    topology's `expert` axis does not match raises."""

    def __init__(self, hidden_size: int, num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 intermediate_size: Optional[int] = None, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 drop_tokens: bool = True, noisy_gate_policy: Optional[str] = None,
                 norm_topk_prob: bool = True, use_residual: bool = False,
                 dtype=torch.bfloat16, activation: str = "silu",
                 dispatch_impl: str = "auto", device=None, param_dtype=torch.float32,
                 ep_rank: Optional[int] = None):
        super().__init__()
        factory = dict(device=device, param_dtype=param_dtype)
        ep_size = int(ep_size)
        if ep_rank is None:
            topo = _installed_topology()
            if ep_size > 1 and (topo is None or topo.axis_size("expert") != ep_size):
                raise ValueError(
                    f"MoE: ep_size={ep_size} but the installed topology has expert="
                    f"{topo.axis_size('expert') if topo is not None else 1}; pass ep_rank, "
                    "or install MeshTopology(ep=ep_size) first")
            ep_rank = topo.coord("expert") if ep_size > 1 else 0
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
                               dtype, activation, ep_size=ep_size, ep_rank=ep_rank, **factory)
        self.ep_size, self.ep_rank = ep_size, ep_rank
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
        rows = b * s * self.k
        gmm_ok = gmm_mesh(self.num_experts)[1] > 0
        impl = choose_dispatch(self.dispatch_impl, train, rows, gmm_ok)
        if impl != choose_dispatch(self.dispatch_impl, train, rows):
            kernel_fallback("grouped_gemm", "auto would pick gmm but the topology is not "
                            "trivial or pure expert-parallel; using ragged dispatch", x.device)
        if gate_noise is None and train and noise_rng is not None:
            gate_noise = self.draw_gate_noise(b * s, noise_rng)
        l_aux, gate_k, topk_idx, pos_k, kept, masks, cap, load = self.gate(
            x, train, drop_tokens=drop_tokens, noise=gate_noise)
        # the telemetry over the global batch's assignments: an expert keeps
        # min(load, cap) of its own, since its places run 0, 1, ... in order
        assignments = float(b * s * self.k * data_ranks()[0])
        kept_load = torch.clamp(load, max=cap)
        router_drop = 1.0 - kept_load.sum() / assignments
        if impl == "einsum":
            combine = combine_weights(gate_k, masks, pos_k, cap)
            out = dispatch_combine(x, combine, combine > 0, self.experts)
            # the JAX layer's load here is post-drop (sums to 1 - drop)
            router_load = kept_load / assignments
        else:
            if impl == "gmm":
                out = dispatch_combine_gmm(x, gate_k, topk_idx, self.num_experts,
                                           self.experts)
            else:
                out = dispatch_combine_ragged(x, gate_k, topk_idx, pos_k, kept, cap,
                                              self.num_experts, self.experts)
            router_load = load / assignments
        self.l_aux, self.router_load, self.router_drop = l_aux, router_load, router_drop
        return out.reshape(b, s, d)
