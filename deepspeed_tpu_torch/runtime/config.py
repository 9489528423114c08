"""The DeepSpeed JSON/dict config (counterpart of ``deepspeed_tpu/runtime/config.py``).

Same key schema as the JAX package's `DeepSpeedConfig`, including the
train_batch_size / train_micro_batch_size_per_gpu /
gradient_accumulation_steps triangulation: train_batch = micro x gas x dp,
where the data-parallel size dp is the world size (one process a rank)
over the tensor, pipeline and sequence degrees, as in the JAX package.
Any enabled block the port
does not run raises `NotImplementedError` naming its ROADMAP.md item:
offload and ZeRO++'s LoCo (`runtime/zero/config.py`), parallel sizes above
1, pipeline, curriculum, telemetry, the monitors, the flops profiler, the
comms logger and elasticity; LAMB, Lion, Adagrad and SGD raise in
`ops/optimizers.build_optimizer`.

The `checkpoint` block (`CheckpointConfig`): `tag_validation` ("Warn",
"Fail" or "Ignore": what a save does when the data ranks' tags differ) and
`load_universal` (`load_checkpoint` reads a universal folder,
`checkpoint/ds_export.py`; also `load_universal_checkpoint`). Each rank
writes its own files, so the JAX block's `use_node_local_storage` and
`parallel_write` have nothing to change and are ignored, as there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError, from_dict, unported
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig


@dataclasses.dataclass
class FP16Config:
    """loss_scale == 0 means dynamic scaling."""
    enabled: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    # step from the finite micros of a window that saw an overflow (the JAX
    # package's extension of the reference's whole-window skip)
    per_micro_overflow_skip: bool = False


@dataclasses.dataclass
class BF16Config:
    enabled: bool = False


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "Adam"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CheckpointConfig:
    tag_validation: str = "Warn"
    load_universal: bool = False


@dataclasses.dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


# enabled blocks the port does not run: (key, ROADMAP.md Queue 1 item)
_UNPORTED_BLOCKS = (
    (C.TELEMETRY, "Training: the rest"),
    (C.CURRICULUM_LEARNING_LEGACY, "Training: the rest"),
    (C.DATA_EFFICIENCY, "Training: the rest"),
    (C.FLOPS_PROFILER, "The rest"),
    (C.COMMS_LOGGER, "The rest"),
    (C.MONITOR_TENSORBOARD, "The rest"),
    (C.MONITOR_CSV, "The rest"),
    (C.MONITOR_WANDB, "The rest"),
    (C.MONITOR_COMET, "The rest"),
    (C.MONITOR_JSONL, "The rest"),
    (C.ELASTICITY, "The rest"),
)


def _check_ported(pd: Dict[str, Any]) -> None:
    for key, item in _UNPORTED_BLOCKS:
        block = pd.get(key) or {}
        if isinstance(block, dict) and block.get("enabled", False):
            raise unported(f"the {key!r} config block", item)
    tp = pd.get(C.TENSOR_PARALLEL) or {}
    sizes = {
        "tensor_parallel.tp_size": int(tp.get("tp_size", 1) or 1),
        "tensor_parallel.autotp_size": int(tp.get("autotp_size", 1) or 1),
        "pipeline.pipeline_parallel_size":
            int((pd.get(C.PIPELINE) or {}).get(C.PIPELINE_PARALLEL_SIZE, 1) or 1),
        C.SEQUENCE_PARALLEL_SIZE: int(pd.get(C.SEQUENCE_PARALLEL_SIZE, 1) or 1),
        C.EXPERT_PARALLEL_SIZE: int(pd.get(C.EXPERT_PARALLEL_SIZE, 1) or 1),
    }
    for name, size in sizes.items():
        if size > 1:
            raise unported(f"{name}={size}", "Multi-GPU")


class DeepSpeedConfig:
    """Parse and validate a DeepSpeed-schema config dict or JSON path."""

    def __init__(self, config: Any, world_size: Optional[int] = None):
        if isinstance(config, (str, os.PathLike)):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"config path does not exist: {config}")
            with open(config, "r") as f:
                self._param_dict = json.load(f)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        elif config is None:
            self._param_dict = {}
        else:
            raise DeepSpeedConfigError(f"Expected a dict or json path, got {type(config)}")
        pd = self._param_dict
        self.raw = pd
        _check_ported(pd)

        self.zero_config = DeepSpeedZeroConfig.from_dict(pd.get(C.ZERO_OPTIMIZATION))
        self.fp16 = from_dict(FP16Config, pd.get(C.FP16))
        self.bf16 = from_dict(BF16Config, pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD)))
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if self.fp16.per_micro_overflow_skip and self.fp16.enabled \
                and self.fp16.loss_scale != 0.0:
            # with a static scale nothing reacts to the overflow: the same
            # micro would be dropped every window
            raise DeepSpeedConfigError(
                "fp16.per_micro_overflow_skip requires dynamic loss scaling (loss_scale: 0)")

        opt = pd.get(C.OPTIMIZER)
        self.optimizer = from_dict(OptimizerConfig, opt) if isinstance(opt, dict) else None
        sched = pd.get(C.SCHEDULER)
        self.scheduler = from_dict(SchedulerConfig, sched) if isinstance(sched, dict) else None

        self.gradient_clipping = float(pd.get(C.GRADIENT_CLIPPING, 0.0))
        self.seed = int(pd.get(C.SEED, 1234))
        self.dataloader_drop_last = bool(pd.get(C.DATALOADER_DROP_LAST, False))
        self.checkpoint_config = from_dict(CheckpointConfig, pd.get(C.CHECKPOINT))
        if self.checkpoint_config.tag_validation.lower() not in ("warn", "fail", "ignore"):
            raise DeepSpeedConfigError(
                f"checkpoint.tag_validation {self.checkpoint_config.tag_validation!r} is not "
                "one of Warn, Fail, Ignore")
        self.load_universal_checkpoint = bool(self.checkpoint_config.load_universal)
        self._resolve_batch_sizes(world_size)

    def _resolve_batch_sizes(self, world_size: Optional[int] = None):
        """The reference's triangulation (runtime/config.py:768-794), as the
        JAX package's `_resolve_batch_sizes(world_size)`: `world_size`
        defaults to the process group's, and the data-parallel size is it
        over the tensor, pipeline and sequence degrees."""
        pd = self._param_dict
        if world_size is None:
            from deepspeed_tpu_torch import comm
            world_size = comm.get_world_size()
        tp = int((pd.get(C.TENSOR_PARALLEL) or {}).get("tp_size", 1) or 1)
        pp = int((pd.get(C.PIPELINE) or {}).get(C.PIPELINE_PARALLEL_SIZE, 1) or 1)
        sp = int(pd.get(C.SEQUENCE_PARALLEL_SIZE, 1) or 1)
        self.world_size = int(world_size)
        dp = max(1, self.world_size // max(1, tp * pp * sp))
        self.data_parallel_size = dp
        train_batch = pd.get(C.TRAIN_BATCH_SIZE)
        micro_batch = pd.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        grad_acc = pd.get(C.GRADIENT_ACCUMULATION_STEPS)
        train_batch = None if train_batch == "auto" else train_batch
        micro_batch = None if micro_batch == "auto" else micro_batch
        grad_acc = None if grad_acc == "auto" else grad_acc

        if train_batch is not None and micro_batch is not None and grad_acc is not None:
            if train_batch != micro_batch * grad_acc * dp:
                raise DeepSpeedConfigError(
                    f"train_batch_size ({train_batch}) != micro_batch "
                    f"({micro_batch}) * gas ({grad_acc}) * dp ({dp})")
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // (micro_batch * dp)
            if grad_acc == 0 or train_batch % (micro_batch * dp) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train_batch} not divisible by micro_batch*dp "
                    f"{micro_batch * dp}")
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // (grad_acc * dp)
            if micro_batch == 0 or train_batch % (grad_acc * dp) != 0:
                raise DeepSpeedConfigError("cannot infer micro batch size")
        elif train_batch is not None:
            grad_acc = 1
            micro_batch = train_batch // dp
            if micro_batch == 0 or train_batch % dp != 0:
                raise DeepSpeedConfigError("cannot infer micro batch size")
        elif micro_batch is not None:
            grad_acc = grad_acc or 1
            train_batch = micro_batch * grad_acc * dp
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu must be provided")
        self.train_batch_size = int(train_batch)
        self.train_micro_batch_size_per_gpu = int(micro_batch)
        self.gradient_accumulation_steps = int(grad_acc)

    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def model_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32
