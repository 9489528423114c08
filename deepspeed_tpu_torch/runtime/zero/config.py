"""ZeRO configuration (counterpart of ``deepspeed_tpu/runtime/zero/config.py``).

The port trains in one process on one device, where ZeRO stages 0-3 all
partition over one rank, which is the identity: every stage is accepted and
computes the same step. Offload and the ZeRO++ quantized collectives are not
ported and raise; the remaining keys of the block are accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError, from_dict, unported


@dataclasses.dataclass
class DeepSpeedZeroConfig:
    stage: int = 0
    offload_param: Optional[dict] = None
    offload_optimizer: Optional[dict] = None
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = 1
    mics_shard_size: int = -1

    @classmethod
    def from_dict(cls, values: Optional[dict]) -> "DeepSpeedZeroConfig":
        cfg = from_dict(cls, values)
        if not 0 <= int(cfg.stage) <= 3:
            raise DeepSpeedConfigError(f"zero_optimization.stage must be 0..3, "
                                       f"got {cfg.stage}")
        for name in ("offload_param", "offload_optimizer"):
            block = getattr(cfg, name) or {}
            if block.get("device", "none") not in (None, "none"):
                raise unported(f"zero_optimization.{name}", "Training: the rest")
        if cfg.zero_quantized_weights or cfg.zero_quantized_nontrainable_weights \
                or cfg.zero_quantized_gradients or cfg.zero_hpz_partition_size > 1 \
                or cfg.mics_shard_size > 0:
            raise unported("ZeRO++ (quantized collectives, hpZ, MiCS)", "Multi-GPU")
        return cfg
