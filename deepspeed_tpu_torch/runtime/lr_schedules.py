"""LR schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

Each schedule is a plain `step -> lr` function in Python floats, wrapped in
a small object with the torch-style `step()`/`get_lr()` surface. The engine
reads the lr of the step it is about to take from the function.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

VALID_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR", "WarmupCosineLR"]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_) -> Callable:
    warmup_num_steps = max(2, warmup_num_steps)

    def fn(step):
        step = float(step)
        if warmup_type == "log":
            gamma = math.log1p(step) / math.log(warmup_num_steps + 1) if step > 0 else 0.0
            gamma = _clip(gamma, 0.0, 1.0)
        else:
            gamma = _clip(step / warmup_num_steps, 0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return fn


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Callable:
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def fn(step):
        step = float(step)
        if step < warmup_num_steps:
            return base(step)
        decay = _clip((total_num_steps - step) / max(1.0, total_num_steps - warmup_num_steps),
                      0.0, 1.0)
        return warmup_max_lr * decay

    return fn


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_type: str = "log", lr: float = 1e-3, **_) -> Callable:
    def fn(step):
        step = float(step)
        if step < warmup_num_steps:
            ratio = warmup_min_ratio + (1 - warmup_min_ratio) * _clip(
                step / max(1, warmup_num_steps), 0.0, 1.0)
        else:
            progress = _clip((step - warmup_num_steps)
                             / max(1.0, total_num_steps - warmup_num_steps), 0.0, 1.0)
            ratio = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (1 + math.cos(math.pi * progress))
        return lr * ratio

    return fn


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                  **_) -> Callable:
    def fn(step):
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1 + interval * lr_range_test_step_rate)

    return fn


def one_cycle(cycle_min_lr: float = 1e-3, cycle_max_lr: float = 1e-2,
              cycle_first_step_size: int = 2000, cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0, **_) -> Callable:
    second = cycle_second_step_size if cycle_second_step_size is not None \
        else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def fn(step):
        step = float(step)
        if step <= cycle_first_step_size:
            up = _clip(step / cycle_first_step_size, 0.0, 1.0)
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up
        if step <= total_cycle:
            down = _clip((step - cycle_first_step_size) / max(1, second), 0.0, 1.0)
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down
        post = step - total_cycle
        if decay_step_size > 0 and post > 0:
            return cycle_min_lr / (1 + decay_lr_rate
                                   * math.floor(post / max(1, decay_step_size)))
        return cycle_min_lr

    return fn


_FACTORIES = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "lrrangetest": lr_range_test,
    "onecycle": one_cycle,
}


class LRScheduler:
    """torch-style wrapper over a schedule function (engine-facing)."""

    def __init__(self, schedule_fn: Callable, base_lr: float):
        self.schedule_fn = schedule_fn
        self.base_lr = base_lr
        self.last_step = 0

    def step(self, increment: int = 1):
        self.last_step += increment

    def get_lr(self):
        return [float(self.schedule_fn(self.last_step))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self) -> Dict[str, Any]:
        return {"last_step": self.last_step}

    def load_state_dict(self, sd: Dict[str, Any]):
        self.last_step = int(sd["last_step"])


def build_lr_schedule(sched_type: Optional[str], params: Dict[str, Any],
                      base_lr: float) -> Callable:
    """A `step -> lr` function; the constant base lr when no scheduler is set."""
    if not sched_type:
        return lambda step: float(base_lr)
    key = sched_type.lower()
    if key not in _FACTORIES:
        raise ValueError(f"unknown scheduler {sched_type}; valid: {VALID_SCHEDULES}")
    p = dict(params)
    if key == "warmupcosinelr":
        p.setdefault("lr", base_lr)
    return _FACTORIES[key](**p)
