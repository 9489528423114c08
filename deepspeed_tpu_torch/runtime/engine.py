"""DeepSpeedEngine, the training engine (counterpart of
``deepspeed_tpu/runtime/engine.py``), for one process on one device.

The JAX engine compiles a pure train step over an explicit `TrainState`;
this engine runs the same step eagerly on an `nn.Module` and keeps the same
state under the same field names (`engine.state`): `global_step`, `params`
(the module's parameters, in the model dtype), `master` (f32 copy when the
model dtype is not f32), `opt_state`, `grad_acc` (f32 accumulation, absent
between steps at GAS 1) and `scaler`. Tensor trees are name -> tensor dicts
in `named_parameters()` order.

Two user surfaces, as in the JAX package:
    loss = engine(batch); engine.backward(loss); engine.step()
and
    loss = engine.train_batch(data_iter)  # or batch=...

A loss function is `loss_fn(module, batch)` or, where it takes a third
argument, `loss_fn(module, batch, rng)`: the engine then hands it a
`torch.Generator` on its device seeded with `seed + micro_steps`, a fresh
stream for each micro-batch (the JAX engine's `_next_rng`; the draws are
not JAX's). The MoE loss functions route the noisy gate's draws from it.

ZeRO stages 0-3 are accepted: partitioning over one rank is the identity.
The state is updated in place; where the JAX step selects the old target
and optimizer state on an overflow, this one does not call the optimizer.
Checkpointing, the telemetry `MetricsState`, the flops profiler, curriculum
and offload are not ported; their config keys raise (`runtime/config.py`).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.ops.optimizers import GradientTransformation, build_optimizer
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.lr_schedules import LRScheduler, build_lr_schedule
from deepspeed_tpu_torch.runtime.precision import (
    LossScaler,
    LossScaleState,
    cast_tree,
    clip_factor,
    global_grad_norm,
)
from deepspeed_tpu_torch.utils.logging import logger

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The whole training state, under the JAX `TrainState`'s field names."""
    global_step: int                  # optimizer steps taken (not skipped ones)
    params: Tree                      # the module's parameters, model dtype
    master: Optional[Tree]            # f32 master copy (None when pure f32)
    opt_state: Any
    grad_acc: Optional[Tree]          # f32 accumulation buffers
    scaler: LossScaleState


def _split_loss(out):
    """A loss function's result as (loss, aux)."""
    if isinstance(out, tuple):
        return out[0], (out[1] if len(out) > 1 else {})
    return out, {}


class DeepSpeedEngine:
    def __init__(self, model: torch.nn.Module, loss_fn: Optional[Callable] = None,
                 config: Optional[DeepSpeedConfig] = None, model_parameters: Any = None,
                 training_data=None, collate_fn=None, lr_scheduler=None,
                 optimizer: Optional[GradientTransformation] = None, device=None):
        self.config = config if config is not None else DeepSpeedConfig(None)
        config = self.config
        self.accelerator = get_accelerator(device)
        self.device = self.accelerator.device
        self.module = model
        self.model_dtype = config.model_dtype
        self.mixed_precision = self.model_dtype != torch.float32
        self.loss_scaler = LossScaler(config.fp16)

        if optimizer is not None:
            self.opt = optimizer
            self.base_lr = config.optimizer.params.get("lr", 1e-3) if config.optimizer else 1e-3
        else:
            opt_cfg = config.optimizer
            self.opt, self.base_lr = build_optimizer(opt_cfg.type if opt_cfg else "adam",
                                                     opt_cfg.params if opt_cfg else {})
        sched = config.scheduler
        self.lr_fn = build_lr_schedule(sched.type if sched else None,
                                       sched.params if sched else {}, self.base_lr)
        self.lr_scheduler = lr_scheduler or LRScheduler(self.lr_fn, self.base_lr)
        self.loss_fn = loss_fn or (lambda module, batch: module(**batch))
        self._loss_takes_rng = len(inspect.signature(self.loss_fn).parameters) >= 3

        self.micro_steps = 0
        self.global_steps = 0
        self.global_samples = 0
        self._grad_norm: Optional[torch.Tensor] = None
        # GAS 1: the f32 accumulation buffers live only inside a step
        self._elide_grad_acc = config.gradient_accumulation_steps == 1
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = DeepSpeedDataLoader(
                training_data, batch_size=config.train_micro_batch_size_per_gpu,
                collate_fn=collate_fn, drop_last=config.dataloader_drop_last,
                seed=config.seed)
        self.state: Optional[TrainState] = None
        self.initialize_state(model_parameters)

    # ------------------------------------------------------------------ state
    @torch.no_grad()
    def initialize_state(self, model_parameters=None) -> TrainState:
        """Params to the model dtype on the device, then the master, the
        optimizer state and the accumulation buffers. The master is the
        model-dtype params upcast to f32, not the original f32 weights."""
        if model_parameters is not None:
            # the module owns the mapping from a JAX tree onto its weights
            if not hasattr(self.module, "load_jax_params"):
                raise TypeError(f"{type(self.module).__name__} has no load_jax_params(tree); "
                                "load its weights before initialize and pass "
                                "model_parameters=None")
            self.module.load_jax_params(model_parameters)
        self.module.to(device=self.device, dtype=self.model_dtype)
        params = dict(self.module.named_parameters())
        master = cast_tree({k: p.detach() for k, p in params.items()}, torch.float32) \
            if self.mixed_precision else None
        grad_acc = None if self._elide_grad_acc else \
            {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.state = TrainState(global_step=0, params=params, master=master,
                                opt_state=self.opt.init(master if self.mixed_precision
                                                        else params),
                                grad_acc=grad_acc, scaler=self.loss_scaler.init_state())
        self.total_params = sum(p.numel() for p in params.values())
        logger.info(f"engine initialized: {self.total_params / 1e6:.1f}M params on "
                    f"{self.accelerator.device_name()}, "
                    f"zero_stage={self.zero_optimization_stage()}, dtype={self.model_dtype}")
        return self.state

    def _put_batch(self, batch):
        if isinstance(batch, dict):
            return {k: self._put_batch(v) for k, v in batch.items()}
        return torch.as_tensor(np.asarray(batch) if not torch.is_tensor(batch) else batch,
                               device=self.device)

    # ----------------------------------------------------- micro and boundary
    def _accumulate(self) -> bool:
        """Fold the module's gradients (of the scaled loss / GAS) into the
        f32 `grad_acc`; under fp16 an overflowing micro adds nothing and is
        recorded in the scaler. Returns the micro's overflow flag."""
        st = self.state
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in st.params.items()}
        ovf = False
        if self.loss_scaler.enabled:
            ovf = self.loss_scaler.check_overflow(grads.values())
            st.scaler = self.loss_scaler.track_micro(st.scaler, ovf)
        with torch.no_grad():
            if st.grad_acc is None:
                st.grad_acc = {k: torch.zeros_like(g, dtype=torch.float32) if ovf
                               else g.float() for k, g in grads.items()}
            elif not ovf:
                for k, g in grads.items():
                    st.grad_acc[k].add_(g)
        for p in st.params.values():
            p.grad = None
        return ovf

    @torch.no_grad()
    def _take_model_step(self) -> torch.Tensor:
        """Unscale, clip, optimizer update, loss-scale update. Returns the
        pre-clip global grad norm (a 0-d device tensor)."""
        cfg, st = self.config, self.state
        if st.grad_acc is None:
            raise RuntimeError("step() before any forward(): no accumulated gradients")
        grads = list(st.grad_acc.values())
        overflow = scale_overflow = False
        if self.loss_scaler.enabled:
            # bad micros were zeroed on arrival; the boundary check guards
            # the accumulation itself
            window_ovf = st.scaler.window_overflow > 0
            boundary_ovf = self.loss_scaler.check_overflow(grads)
            if cfg.fp16.per_micro_overflow_skip:
                good = st.scaler.good_micros
                overflow = boundary_ovf or good == 0
                scale_overflow = window_ovf or boundary_ovf
                renorm = cfg.gradient_accumulation_steps / max(good, 1)
            else:
                overflow = scale_overflow = window_ovf or boundary_ovf
                renorm = 1.0
            torch._foreach_mul_(grads, renorm / st.scaler.scale)
        grad_norm = global_grad_norm(grads)
        if cfg.gradient_clipping > 0.0:
            torch._foreach_mul_(grads, clip_factor(grad_norm, cfg.gradient_clipping))
        lr = self.lr_fn(st.global_step)
        if not overflow:
            target = st.master if self.mixed_precision else st.params
            _, st.opt_state = self.opt.update(st.grad_acc, st.opt_state, target, lr)
            if self.mixed_precision:
                for k, p in st.params.items():
                    p.copy_(st.master[k])
            st.global_step += 1
        if self._elide_grad_acc:
            st.grad_acc = None
        else:
            torch._foreach_zero_(grads)
        if self.loss_scaler.enabled:
            st.scaler = self.loss_scaler.update(st.scaler, scale_overflow, skipped=overflow)
        self._grad_norm = grad_norm
        return grad_norm

    # ------------------------------------------------------------ user surface
    def __call__(self, batch):
        return self.forward(batch)

    def _next_rng(self) -> torch.Generator:
        """The micro-batch's generator: seeded with `seed + micro_steps`."""
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(self.config.seed + self.micro_steps)

    def _loss(self, batch):
        args = (self.module, self._put_batch(batch))
        if self._loss_takes_rng:
            args += (self._next_rng(),)
        return _split_loss(self.loss_fn(*args))

    def forward(self, batch) -> torch.Tensor:
        """The loss of one micro-batch, with its autograd graph."""
        return self._loss(batch)[0]

    def backward(self, loss: torch.Tensor, retain_graph: bool = False) -> torch.Tensor:
        """Gradients of loss / GAS (times the loss scale) into `grad_acc`."""
        self._backward(loss, retain_graph)
        return loss

    def _backward(self, loss: torch.Tensor, retain_graph: bool = False) -> bool:
        gas = self.config.gradient_accumulation_steps
        self.loss_scaler.scale_loss(loss / gas, self.state.scaler).backward(
            retain_graph=retain_graph)
        ovf = self._accumulate()
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu()
        return ovf

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.config.gradient_accumulation_steps == 0

    def step(self) -> None:
        """The optimizer step, at a GAS boundary only."""
        if not self.is_gradient_accumulation_boundary():
            return
        self._take_model_step()
        self.global_steps += 1
        self.lr_scheduler.step()

    def _micro_batches(self, data_iter=None, batch=None):
        """The GAS micro-batches of one step: drawn from `data_iter` (or the
        engine's dataloader), or cut from `batch` by the JAX fold rules."""
        gas = self.config.gradient_accumulation_steps
        if batch is None:
            it = data_iter if data_iter is not None else iter(self.training_dataloader)
            return [next(it) for _ in range(gas)]
        batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                 for k, v in batch.items()}
        leaf0 = next(iter(batch.values()))
        lead = leaf0.shape[0]
        local_rows = self.config.train_batch_size
        micro_rows = max(1, local_rows // gas)
        fold = True
        if lead == gas:
            # a flat batch of GAS rows or micros already stacked: flat iff it
            # has the configured rows and its second dim is not the micro size
            fold = lead == local_rows and not (leaf0.dim() >= 2
                                               and leaf0.shape[1] == micro_rows)
        elif lead % gas == 0:
            if lead != local_rows:
                logger.warning(f"train_batch got {lead} rows but the config "
                               f"triangulates to {local_rows}; training proceeds "
                               "with the given batch")
        else:
            raise ValueError(f"train_batch got leading dim {lead}, not divisible by "
                             f"gradient_accumulation_steps={gas}")
        if fold:
            batch = {k: v.reshape((gas, v.shape[0] // gas) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
        return [{k: v[i] for k, v in batch.items()} for i in range(gas)]

    def train_batch(self, data_iter=None, batch=None) -> torch.Tensor:
        """One full step: GAS micro-batches forward and backward, then the
        optimizer. Returns the mean micro loss (over the finite micros under
        fp16 per-micro overflow skip)."""
        losses, ovfs = [], []
        for micro in self._micro_batches(data_iter, batch):
            loss = self.forward(micro)
            ovfs.append(self._backward(loss))
            losses.append(loss.detach().float())
        self._take_model_step()
        self.global_steps += 1
        self.lr_scheduler.step()
        losses = torch.stack(losses)
        if self.loss_scaler.enabled and self.config.fp16.per_micro_overflow_skip:
            good = torch.isfinite(losses) & ~torch.tensor(ovfs, device=losses.device)
            loss = torch.where(good, losses, 0.0).sum() / good.float().sum().clamp(min=1.0)
        else:
            loss = losses.mean()
        return loss

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        return self._loss(batch)[0]

    # ---------------------------------------------------------------- accessors
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self) -> int:
        return self.config.zero_config.stage

    def zero_optimization(self) -> bool:
        return self.config.zero_enabled

    def get_lr(self):
        """The lr the next step takes: the schedule at `state.global_step`,
        which skipped steps do not advance."""
        return [float(self.lr_fn(self.state.global_step))]

    @property
    def skipped_steps(self) -> int:
        """Steps skipped for an fp16 overflow."""
        return self.state.scaler.overflows

    @property
    def cur_scale(self) -> float:
        return float(self.state.scaler.scale)

    def get_global_grad_norm(self) -> float:
        """The last step's pre-clip global grad norm."""
        if self._grad_norm is not None:
            return float(self._grad_norm)
        if self.state.grad_acc is None:
            return 0.0
        return float(global_grad_norm(self.state.grad_acc.values()))
