"""ZeRO configuration (counterpart of ``deepspeed_tpu/runtime/zero/config.py``).

Stages 0-3 partition the training state over the `data` axis
(`runtime/zero/partition.py`): stage 0 replicates everything and
all-reduces the gradients; stage 1 and up shard the f32 master, the
optimizer moments and the f32 gradient accumulation, and reduce-scatter the
gradients (the JAX package shards the accumulation from stage 1 too, so
stage 2 computes what stage 1 does); stage 3 also shards the parameters,
except leaves under `param_persistence_threshold` elements
(`stage3_param_persistence_threshold`), and gathers them where they are
used. Over one rank every stage is the identity. Offload and the ZeRO++
quantized collectives are not ported and raise; the other keys of the
block are accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError, from_dict, unported

# the JAX block's aliases of the keys the plan reads
_ALIASES = {"stage3_param_persistence_threshold": "param_persistence_threshold"}


@dataclasses.dataclass
class DeepSpeedZeroConfig:
    stage: int = 0
    param_persistence_threshold: int = int(1e5)
    offload_param: Optional[dict] = None
    offload_optimizer: Optional[dict] = None
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = 1
    mics_shard_size: int = -1
    zeropp_loco_param: Optional[dict] = None

    @classmethod
    def from_dict(cls, values: Optional[dict]) -> "DeepSpeedZeroConfig":
        values = {_ALIASES.get(k, k): v for k, v in (values or {}).items()}
        cfg = from_dict(cls, values)
        if not 0 <= int(cfg.stage) <= 3:
            raise DeepSpeedConfigError(f"zero_optimization.stage must be 0..3, "
                                       f"got {cfg.stage}")
        if int(cfg.param_persistence_threshold) < 0:
            raise DeepSpeedConfigError("zero_optimization.stage3_param_persistence_threshold "
                                       f"must be >= 0, got {cfg.param_persistence_threshold}")
        for name in ("offload_param", "offload_optimizer"):
            block = getattr(cfg, name) or {}
            if block.get("device", "none") not in (None, "none"):
                raise unported(f"zero_optimization.{name}", "Training: the rest")
        if cfg.zeropp_loco_param:
            # the JAX config takes the key and no code reads it: refused, not ignored
            raise unported("ZeRO++ LoCo error feedback (zeropp_loco_param)", "Multi-GPU")
        if int(cfg.zero_hpz_partition_size) < 0:
            raise DeepSpeedConfigError("zero_optimization.zero_hpz_partition_size must be "
                                       f">= 0, got {cfg.zero_hpz_partition_size}")
        return cfg

    @property
    def shard_group_size(self) -> int:
        """The data ranks a MiCS/hpZ group holds (`mics_shard_size`, else
        `zero_hpz_partition_size` above 1), or 0: the JAX `initialize`'s
        mapping onto `MeshTopology(mics_shard_size=...)`."""
        mics = int(self.mics_shard_size or 0)
        if mics <= 0:
            hpz = int(self.zero_hpz_partition_size or 0)
            mics = hpz if hpz > 1 else 0
        return max(mics, 0)

    @property
    def quantized(self) -> bool:
        """qgZ or qwZ: the collectives of the ZeRO++ region."""
        return bool(self.zero_quantized_gradients or self.zero_quantized_weights)
