"""Optimizers (counterpart of ``deepspeed_tpu/ops/optimizers.py``).

`fused_adam` is the JAX package's `GradientTransformation` pair over
name -> tensor dicts: `init(params) -> state` and `update(grads, state,
params, lr) -> (params, state)`. The JAX package leaves the update to XLA
fusion; here it is plain torch over lists of tensors (`torch._foreach_*`), taken
in runs of at most `CHUNK_ELEMENTS` elements so its temporaries stay small. Unlike the JAX function it updates `params` and the
moments in place, which saves a copy of the f32 master and both moments;
the engine skips the call on an overflowed step instead of selecting the
old values.

The 1-bit family is ported with it: `onebit_adam` (the update compressed
after its warm-up, for gradients that arrive already averaged) and the
wire optimizers `WireOnebitAdam`, `WireZeroOneAdam` and `WireOnebitLamb`,
which the engine runs instead of the `GradientTransformation` when the
config names one of them with `comm_backend_name` (`runtime/engine.py`,
wire mode): each rank keeps its own gradients, and the momentum (or 0/1
Adam's accumulated update) crosses ranks through the sign-compressed
all-reduce with error feedback (`runtime/comm/compressed.py`). Their
`update_local` runs on this rank's tensors and makes the collectives
itself, a run of leaves at a time (`CHUNK_ELEMENTS`); `local_fields` name
the state each rank keeps for itself, the rest is equal on every rank.
LAMB, Lion, Adagrad and SGD raise in `build_optimizer`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.utils.logging import logger

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


def _f32_power_gap(b: float, count: int) -> float:
    """1 - b ** count, in f32 as the JAX package computes it."""
    return float(np.float32(1) - np.float32(b) ** np.float32(count))


def _u_max(b2: float) -> float:
    """The consistent-statistics bound of a normalized update, 1 /
    sqrt(1 - b2), in f32."""
    return float(np.float32(1) / np.sqrt(np.float32(1.0 - b2)))


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def jax_leaves(names) -> List[List[str]]:
    """Parameter names grouped into the JAX package's leaves
    (`runtime/zero/partition.jax_leaf_key`: a decoder leaf stacked over
    the layers), in order."""
    from deepspeed_tpu_torch.runtime.zero.partition import jax_leaf_key
    out: Dict[str, List[str]] = {}
    for n in names:
        out.setdefault(jax_leaf_key(n), []).append(n)
    return list(out.values())


def _leaf_chunks(params: Tree):
    """The JAX leaves of `params` in runs of at most CHUNK_ELEMENTS
    elements (a larger leaf is a run of its own)."""
    run, size = [], 0
    for leaf in jax_leaves(params):
        n = sum(params[k].numel() for k in leaf)
        if run and size + n > CHUNK_ELEMENTS:
            yield run
            run, size = [], 0
        run.append(leaf)
        size += n
    if run:
        yield run


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors]) if len(tensors) > 1 \
        else tensors[0].reshape(-1)


def _unflat(flat: torch.Tensor, like) -> List[torch.Tensor]:
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in like]), like)]


class OnebitAdamState(NamedTuple):
    count: int
    exp_avg: Tree
    exp_avg_sq: Tree          # frozen after freeze_step
    error: Tree               # compression error feedback


def onebit_adam(betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                weight_decay: float = 0.0, freeze_step: int = 100) -> GradientTransformation:
    """1-bit Adam on gradients that arrive averaged (the JAX `onebit_adam`):
    exact Adam up to `freeze_step`; after it the variance is frozen and the
    normalized update, clipped to 1/sqrt(1 - b2), is sign-compressed with
    error feedback, one scale a JAX leaf (`jax_leaves`). The scale needs a
    leaf whole, so the engine refuses it on ZeRO pieces."""
    b1, b2 = betas
    u_max = _u_max(b2)

    def init(params: Tree) -> OnebitAdamState:
        return OnebitAdamState(0, _zeros(params), _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads: Tree, state: OnebitAdamState, params: Tree, lr: float):
        count = state.count + 1
        frozen = count > freeze_step
        c1 = _f32_power_gap(b1, count)
        c2 = _f32_power_gap(b2, min(count, freeze_step))
        for leaf in jax_leaves(params):
            upds = []
            for k in leaf:
                g, m, v = grads[k], state.exp_avg[k], state.exp_avg_sq[k]
                m.mul_(b1).add_(g, alpha=1 - b1)
                if not frozen:
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                upds.append((m / c1) / ((v / c2).sqrt_() + eps))
            if frozen:
                errors = [state.error[k] for k in leaf]
                corrected = _flat(upds).clamp_(-u_max, u_max).add_(_flat(errors))
                comp = torch.sign(corrected) * corrected.abs().mean()
                for e, ne in zip(errors, _unflat(corrected - comp, errors)):
                    e.copy_(ne)
                upds = _unflat(comp, upds)
            for k, u in zip(leaf, upds):
                p = params[k]
                if weight_decay > 0.0:
                    u = u.add(p, alpha=weight_decay)
                p.add_(u, alpha=-lr)
        return params, OnebitAdamState(count, state.exp_avg, state.exp_avg_sq, state.error)

    return GradientTransformation(init, update)


def _pmean(tensors, group) -> List[torch.Tensor]:
    """The group's mean of each tensor, in one all-reduce."""
    from deepspeed_tpu_torch import comm
    flat = torch.cat([t.reshape(-1) for t in tensors])
    comm.all_reduce(flat, op=comm.ReduceOp.AVG, group=group)
    return _unflat(flat, tensors)


def _compressed(leaves, xs: Tree, errors: Tree, group) -> Tree:
    """The compressed all-reduce of each JAX leaf of `xs` (one scale a
    leaf) with its error, the run's signs and scales in one gather each:
    the means by name; `errors` take the new errors in place."""
    from deepspeed_tpu_torch.runtime.comm.compressed import compressed_allreduce_many
    means, new_errors = compressed_allreduce_many(
        [_flat([xs[k] for k in leaf]) for leaf in leaves],
        [_flat([errors[k] for k in leaf]) for leaf in leaves], group)
    out = {}
    for leaf, mean, ne in zip(leaves, means, new_errors):
        like = [xs[k] for k in leaf]
        out.update(zip(leaf, _unflat(mean, like)))
        for k, e in zip(leaf, _unflat(ne, like)):
            errors[k].copy_(e)
    return out


class WireOnebitAdam:
    """1-bit Adam with the compressed wire (the JAX `WireOnebitAdam`):
    each rank proposes the momentum m_w = b1 m + (1 - b1) g of its own
    gradient; up to `freeze_step` the proposals' mean is exact and the
    variance is updated from the mean gradient it implies; after it the
    variance is frozen and the proposals go through the sign-compressed
    all-reduce with this rank's error (one scale a JAX leaf), the
    normalized update clipped to 1/sqrt(1 - b2)."""

    local_fields = ("error",)

    def __init__(self, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 freeze_step: int = 100):
        self.b1, self.b2 = betas
        self.eps, self.weight_decay, self.freeze_step = eps, weight_decay, freeze_step

    def init(self, params: Tree) -> OnebitAdamState:
        return OnebitAdamState(0, _zeros(params), _zeros(params), _zeros(params))

    def _momentum(self, grads: Tree, state, leaves, frozen: bool, group) -> Tree:
        """The run's new momentum, by name; the variance and error follow
        (updated in place)."""
        b1, b2 = self.b1, self.b2
        names = [k for leaf in leaves for k in leaf]
        m_w = {k: b1 * state.exp_avg[k] + (1 - b1) * grads[k] for k in names}
        if frozen:
            return _compressed(leaves, m_w, state.error, group)
        m_new = dict(zip(names, _pmean([m_w[k] for k in names], group)))
        for k in names:
            g = (m_new[k] - b1 * state.exp_avg[k]) / (1 - b1)
            state.exp_avg_sq[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            state.error[k].zero_()
        return m_new

    def _update(self, k, m, state, params, c1, c2, frozen):
        state.exp_avg[k].copy_(m)
        p = params[k]
        upd = (m / c1) / ((state.exp_avg_sq[k] / c2).sqrt_() + self.eps)
        if frozen:
            upd.clamp_(-_u_max(self.b2), _u_max(self.b2))
        if self.weight_decay > 0.0:
            upd.add_(p, alpha=self.weight_decay)
        return upd

    @torch.no_grad()
    def update_local(self, grads: Tree, state: OnebitAdamState, params: Tree, lr: float,
                     group) -> Tuple[Tree, OnebitAdamState]:
        count = state.count + 1
        frozen = count > self.freeze_step
        c1 = _f32_power_gap(self.b1, count)
        c2 = _f32_power_gap(self.b2, min(count, self.freeze_step))
        for leaves in _leaf_chunks(params):
            m_new = self._momentum(grads, state, leaves, frozen, group)
            for k, m in m_new.items():
                upd = self._update(k, m, state, params, c1, c2, frozen)
                params[k].add_(upd.to(params[k].dtype), alpha=-lr)
        return params, state._replace(count=count)


class ZeroOneAdamState(NamedTuple):
    count: int
    exp_avg: Tree             # this rank's: drifts on local steps
    exp_avg_sq: Tree          # updated at growing intervals, frozen after var_freeze_step
    error: Tree               # this rank's compression error
    momentum_acc: Tree        # this rank's accumulated update (0/1 Adam's u)
    lrs: float                # the lrs summed over the current local interval (f32)
    var_interval: int
    var_counter: int
    local_interval: int
    local_counter: int


class WireZeroOneAdam:
    """0/1 Adam (the JAX `WireZeroOneAdam`): before `var_freeze_step`, a
    step whose count the variance interval divides takes the exact mean
    gradient and updates momentum and variance, the others the
    sign-compressed mean gradient and the momentum alone, the interval
    doubling every `var_update_scaler` exact steps; after it each rank
    folds its own gradient into its momentum and adds the clipped update
    to `momentum_acc` with no communication, and every `local_interval`
    steps one compressed exchange of the accumulation (in momentum units)
    moves the parameters and resets the momentum to it over the summed
    lrs, the interval doubling every `local_step_scaler` steps up to
    `local_step_clipper`. The parameters stay put between exchanges."""

    local_fields = ("exp_avg", "error", "momentum_acc")

    def __init__(self, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 var_freeze_step: int = 100000, var_update_scaler: int = 16,
                 local_step_scaler: int = 32678, local_step_clipper: int = 16):
        self.b1, self.b2 = betas
        self.eps, self.weight_decay = eps, weight_decay
        self.var_freeze_step, self.var_update_scaler = var_freeze_step, var_update_scaler
        self.local_step_scaler, self.local_step_clipper = local_step_scaler, local_step_clipper

    def init(self, params: Tree) -> ZeroOneAdamState:
        return ZeroOneAdamState(0, _zeros(params), _zeros(params), _zeros(params),
                                _zeros(params), 0.0, 1, 0, 1, 0)

    @torch.no_grad()
    def update_local(self, grads: Tree, state: ZeroOneAdamState, params: Tree, lr: float,
                     group) -> Tuple[Tree, ZeroOneAdamState]:
        b1, b2, eps = self.b1, self.b2, self.eps
        count = state.count + 1
        frozen = count > self.var_freeze_step
        var_step = count % state.var_interval == 0
        sync_step = count % state.local_interval == 0
        u_max = _u_max(b2)
        lrs = float(np.float32(state.lrs) + np.float32(lr)) if frozen else 0.0
        m, v, acc = state.exp_avg, state.exp_avg_sq, state.momentum_acc
        for leaves in _leaf_chunks(params):
            names = [k for leaf in leaves for k in leaf]
            if not frozen:
                if var_step:
                    g = dict(zip(names, _pmean([grads[k] for k in names], group)))
                    for k in names:
                        v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                else:
                    g = _compressed(leaves, grads, state.error, group)
                c1, c2 = _f32_power_gap(b1, count), _f32_power_gap(b2, count)
                for k in names:
                    m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                    p = params[k]
                    upd = (m[k] / c1) / ((v[k] / c2).sqrt_() + eps)
                    if self.weight_decay > 0.0:
                        upd.add_(p, alpha=self.weight_decay)
                    p.add_(upd.to(p.dtype), alpha=-lr)
                continue
            for k in names:
                m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                acc[k].add_((m[k] / (v[k].sqrt() + eps)).clamp_(-u_max, u_max), alpha=lr)
            if not sync_step:
                continue
            denom = {k: v[k].sqrt() + eps for k in names}
            buf = _compressed(leaves, {k: acc[k] * denom[k] for k in names}, state.error,
                              group)
            cap = float(np.float32(lrs) * np.float32(u_max))
            for k in names:
                p = params[k]
                p.sub_((buf[k] / denom[k]).clamp_(-cap, cap).to(p.dtype))
                m[k].copy_(buf[k] / max(lrs, 1e-12))
                acc[k].zero_()
        if frozen and sync_step:
            lrs = 0.0
        vc = state.var_counter + int(not frozen and var_step)
        bump_var = vc >= self.var_update_scaler
        var_interval = state.var_interval * 2 if bump_var and not frozen else state.var_interval
        lc = state.local_counter + int(frozen)
        bump_loc = lc >= self.local_step_scaler
        local_interval = min(state.local_interval * 2, self.local_step_clipper) \
            if bump_loc and frozen else state.local_interval
        return params, state._replace(count=count, lrs=lrs, var_interval=var_interval,
                                      var_counter=0 if bump_var else vc,
                                      local_interval=local_interval,
                                      local_counter=0 if bump_loc else lc)


class OnebitLambState(NamedTuple):
    count: int
    exp_avg: Tree
    exp_avg_sq: Tree
    error: Tree               # this rank's compression error
    scaling_coeff: Tree       # each JAX leaf's trust ratio (0-d, on each of its names),
                              # frozen at freeze_step


class WireOnebitLamb(WireOnebitAdam):
    """1-bit LAMB (the JAX `WireOnebitLamb`): the 1-bit Adam wire, with
    each JAX leaf's update scaled by its LAMB trust ratio ||p|| / ||update||
    clipped to [min_coeff, max_coeff] (1 where either norm is 0), exact up
    to `freeze_step` and frozen at its last value after it."""

    local_fields = ("error",)

    def __init__(self, betas=(0.9, 0.999), eps: float = 1e-6, weight_decay: float = 0.0,
                 freeze_step: int = 100, max_coeff: float = 10.0, min_coeff: float = 0.01):
        super().__init__(betas, eps, weight_decay, freeze_step)
        self.max_coeff, self.min_coeff = max_coeff, min_coeff

    def init(self, params: Tree) -> OnebitLambState:
        coeff = {k: torch.ones((), dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return OnebitLambState(0, _zeros(params), _zeros(params), _zeros(params), coeff)

    @torch.no_grad()
    def update_local(self, grads: Tree, state: OnebitLambState, params: Tree, lr: float,
                     group) -> Tuple[Tree, OnebitLambState]:
        count = state.count + 1
        frozen = count > self.freeze_step
        c1 = _f32_power_gap(self.b1, count)
        c2 = _f32_power_gap(self.b2, min(count, self.freeze_step))
        for leaves in _leaf_chunks(params):
            m_new = self._momentum(grads, state, leaves, frozen, group)
            for leaf in leaves:
                upds = {k: self._update(k, m_new[k], state, params, c1, c2, frozen)
                        for k in leaf}
                coeff = state.scaling_coeff[leaf[0]]
                if not frozen:
                    pn = torch.stack([params[k].float().square().sum() for k in leaf]).sum().sqrt()
                    un = torch.stack([upds[k].square().sum() for k in leaf]).sum().sqrt()
                    live = torch.clamp(pn / torch.clamp(un, min=1e-12), self.min_coeff,
                                       self.max_coeff)
                    coeff = torch.where((pn > 0) & (un > 0), live, torch.ones_like(live))
                for k in leaf:
                    state.scaling_coeff[k].copy_(coeff)
                    params[k].sub_((lr * coeff * upds[k]).to(params[k].dtype))
        return params, state._replace(count=count)


WIRE_OPTIMIZERS = ("onebitadam", "zerooneadam", "onebitlamb")


def wire_optimizer(name: str, p: Dict[str, Any]):
    """The wire optimizer of a config's type and params (the JAX engine's
    choice, with its defaults), or None where the type has no wire."""
    name = name.lower().replace("_", "").replace("-", "")
    betas = tuple(p.get("betas", (0.9, 0.999)))
    if name == "zerooneadam":
        return WireZeroOneAdam(betas=betas, eps=float(p.get("eps", 1e-8)),
                               weight_decay=float(p.get("weight_decay", 0.0)),
                               var_freeze_step=int(p.get("var_freeze_step", 100000)),
                               var_update_scaler=int(p.get("var_update_scaler", 16)),
                               local_step_scaler=int(p.get("local_step_scaler", 32678)),
                               local_step_clipper=int(p.get("local_step_clipper", 16)))
    if name == "onebitlamb":
        return WireOnebitLamb(betas=betas, eps=float(p.get("eps", 1e-6)),
                              weight_decay=float(p.get("weight_decay", 0.0)),
                              freeze_step=int(p.get("freeze_step", 100)),
                              max_coeff=float(p.get("max_coeff", 10.0)),
                              min_coeff=float(p.get("min_coeff", 0.01)))
    if name == "onebitadam":
        return WireOnebitAdam(betas=betas, eps=float(p.get("eps", 1e-8)),
                              weight_decay=float(p.get("weight_decay", 0.0)),
                              freeze_step=int(p.get("freeze_step", 100)))
    return None


_UNPORTED = ("lamb", "fusedlamb", "lion", "fusedlion", "cpulion", "adagrad", "cpuadagrad",
             "sgd", "musgd", "muadam", "muadamw")


def build_optimizer(name: str, params_cfg: Dict[str, Any]) -> Tuple[GradientTransformation, float]:
    """(transform, base_lr) from a DeepSpeed optimizer config's type and
    params. ZeroOneAdam needs `comm_backend_name` (the engine's wire mode
    runs it; the transform returned is not used), as does OneBitLamb here,
    whose plain form is LAMB."""
    name = (name or "adam").lower()
    lr = float(params_cfg.get("lr", 1e-3))
    betas = tuple(params_cfg.get("betas", (0.9, 0.999)))
    eps = float(params_cfg.get("eps", 1e-8))
    wd = float(params_cfg.get("weight_decay", 0.0))
    wired = bool(params_cfg.get("comm_backend_name"))
    if name == "zerooneadam":
        if not wired:
            raise ValueError(
                "ZeroOneAdam requires wire mode: set optimizer.params.comm_backend_name "
                "(e.g. 'compressed') so the engine runs the local-step compressed exchange "
                "(WireZeroOneAdam)")
        return fused_adam(betas=betas, eps=eps, weight_decay=wd), lr
    if name == "onebitadam":
        return onebit_adam(betas=betas, eps=eps, weight_decay=wd,
                           freeze_step=int(params_cfg.get("freeze_step", 100))), lr
    if name == "onebitlamb":
        if not wired:
            raise unported("optimizer 'onebitlamb' without comm_backend_name (plain LAMB)",
                           "Training: the rest")
        logger.info("OnebitLamb runs through the engine's wire (WireOnebitLamb)")
        return fused_adam(betas=betas, eps=eps, weight_decay=wd), lr
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
