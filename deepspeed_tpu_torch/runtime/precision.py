"""Mixed precision: loss scaling, master weights and gradient norms
(counterpart of ``deepspeed_tpu/runtime/precision.py``).

The JAX package keeps the scaler state on the device inside its compiled
step. The port runs eagerly and keeps it on the host as Python numbers:
the scaler acts once per micro-batch and once per step, after one
device-to-host read of the overflow flag. Scales are powers of two or the
static value, so they are exact either way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch


@dataclasses.dataclass
class LossScaleState:
    scale: float            # current loss scale
    good_steps: int         # consecutive overflow-free steps
    hysteresis: int         # remaining hysteresis credits
    overflows: int          # total skipped steps
    window_overflow: int    # 0/1: any overflowed micro this GAS window
    good_micros: int        # finite micros accumulated this window


class LossScaler:
    """Static or dynamic loss scaler (dynamic iff cfg.loss_scale == 0)."""

    def __init__(self, fp16_cfg):
        self.dynamic = fp16_cfg.enabled and fp16_cfg.loss_scale == 0.0
        self.enabled = fp16_cfg.enabled
        self.static_scale = fp16_cfg.loss_scale if fp16_cfg.loss_scale else 1.0
        self.initial_scale = 2.0 ** fp16_cfg.initial_scale_power
        self.scale_window = fp16_cfg.loss_scale_window
        self.init_hysteresis = fp16_cfg.hysteresis
        self.min_scale = fp16_cfg.min_loss_scale
        self.consecutive_hysteresis = fp16_cfg.consecutive_hysteresis

    def init_state(self) -> LossScaleState:
        scale = self.initial_scale if self.dynamic else self.static_scale
        return LossScaleState(scale=float(scale), good_steps=0,
                              hysteresis=int(self.init_hysteresis), overflows=0,
                              window_overflow=0, good_micros=0)

    def scale_loss(self, loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
        if not self.enabled:
            return loss
        return loss * torch.tensor(state.scale, dtype=loss.dtype, device=loss.device)

    @staticmethod
    def check_overflow(grads: Iterable[torch.Tensor], group: Optional[str] = None) -> bool:
        """True if any gradient holds an inf or a nan (one host read). With
        a `group` the flag is all-reduced with MAX over it, so one rank's
        inf is every rank's overflow."""
        finite = [torch.isfinite(g).all() for g in grads]
        if group is None:
            return bool(finite) and not bool(torch.stack(finite).all())
        from deepspeed_tpu_torch import comm
        flag = (~torch.stack(finite).all()).float() if finite else torch.zeros([])
        return bool(comm.all_reduce(flag, op=comm.ReduceOp.MAX, group=group))

    @staticmethod
    def track_micro(state: LossScaleState, overflow: bool) -> LossScaleState:
        """Record one micro-batch's overflow as its gradients arrive."""
        o = int(overflow)
        return dataclasses.replace(state, window_overflow=max(state.window_overflow, o),
                                   good_micros=state.good_micros + 1 - o)

    def update(self, state: LossScaleState, overflow: bool,
               skipped: Optional[bool] = None) -> LossScaleState:
        """The reference's update_scale, with hysteresis. `overflow` drives
        the scale; `skipped` (default: the same) counts a skipped step. They
        differ only under per-micro skip, where a window can see an overflow
        and still step from its finite micros."""
        skipped = overflow if skipped is None else skipped
        if not self.dynamic:
            return dataclasses.replace(state, overflows=state.overflows + int(skipped),
                                       window_overflow=0, good_micros=0)
        hysteresis = state.hysteresis - 1 if overflow else state.hysteresis
        scale = state.scale
        if overflow and hysteresis <= 0:
            scale = max(scale / 2.0, self.min_scale)
        good = 0 if overflow else state.good_steps + 1
        grow = not overflow and good >= self.scale_window
        if grow:
            scale, good = scale * 2.0, 0
            if not self.consecutive_hysteresis:
                hysteresis = self.init_hysteresis
        if self.consecutive_hysteresis:
            hysteresis = max(hysteresis, 0)
        elif not overflow:
            hysteresis = self.init_hysteresis
        return LossScaleState(scale=scale, good_steps=good, hysteresis=int(hysteresis),
                              overflows=state.overflows + int(skipped),
                              window_overflow=0, good_micros=0)


def cast_tree(tree: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Each floating tensor of a name -> tensor dict cast to `dtype`."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


def global_grad_norm(grads: Iterable[torch.Tensor], sharded: Iterable[torch.Tensor] = (),
                     group: str = "data") -> torch.Tensor:
    """The global L2 norm, sqrt(sum of squares) in f32, as a 0-d tensor.
    `grads` are whole on every rank and counted once; the squares of the
    rank's pieces of `sharded` leaves are summed over `group` first."""
    sums = [g.float().square().sum() for g in grads]
    pieces = [g.float().square().sum() for g in sharded]
    if pieces:
        from deepspeed_tpu_torch import comm
        sums.append(comm.all_reduce(torch.stack(pieces).sum(), group=group))
    if not sums:
        return torch.zeros([], dtype=torch.float32)
    return torch.stack(sums).sum().sqrt()


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (norm + 1e-6)) in f32."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_grads_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                              norm: Optional[torch.Tensor] = None
                              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    if norm is None:
        norm = global_grad_norm(grads.values())
    factor = clip_factor(norm, max_norm)
    return {k: g * factor.to(g.dtype) for k, g in grads.items()}, norm
