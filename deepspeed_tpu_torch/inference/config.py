"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``).

Same keys as the JAX package's `DeepSpeedInferenceConfig`. Values this port
does not serve yet raise `NotImplementedError` naming the ROADMAP.md item
that brings them; unknown keys are accepted and ignored with a warning.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.utils.logging import logger

# fp16 names map to bf16, as in the JAX package: the port's kernels are bf16
_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "torch.bfloat16": torch.bfloat16,
    "fp16": torch.bfloat16, "half": torch.bfloat16, "torch.half": torch.bfloat16,
    "torch.float16": torch.bfloat16,
    "fp32": torch.float32, "float": torch.float32, "torch.float32": torch.float32,
}


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet: ROADMAP.md, "
        f"Queue 1, '{item}'")


@dataclasses.dataclass
class DeepSpeedTPConfig:
    enabled: bool = True
    tp_size: int = 1


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    dtype: Any = torch.bfloat16
    tensor_parallel: DeepSpeedTPConfig = dataclasses.field(
        default_factory=DeepSpeedTPConfig)
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_batch_size: Optional[int] = None
    quant: Optional[dict] = None
    serve_mode: str = "auto"
    speculative: Optional[dict] = None
    capacity: Optional[dict] = None
    kv_cache_dtype: Optional[str] = None
    fused_int8: Optional[bool] = None
    resilience: Optional[dict] = None
    replace_with_kernel_inject: bool = False
    checkpoint: Optional[str] = None
    zero: Optional[dict] = None
    triangular_masking: bool = True
    return_tuple: bool = True
    decode_donate: bool = True
    auto_layouts: Optional[bool] = None

    def __init__(self, **kwargs):
        tp = kwargs.pop("tensor_parallel", None) or {}
        if isinstance(tp, DeepSpeedTPConfig):
            self.tensor_parallel = tp
        else:
            if "mp_size" in kwargs:  # legacy alias
                tp.setdefault("tp_size", kwargs.pop("mp_size"))
            names = {f.name for f in dataclasses.fields(DeepSpeedTPConfig)}
            self.tensor_parallel = DeepSpeedTPConfig(
                **{k: v for k, v in tp.items() if k in names})
        dtype = kwargs.pop("dtype", torch.bfloat16)
        if dtype in ("int8", torch.int8):
            raise _unported("dtype='int8'", "Weight quantization and serve modes")
        if isinstance(dtype, str):
            dtype = _DTYPES[dtype.lower()]
        self.dtype = dtype
        for f in dataclasses.fields(self):
            if f.name in ("dtype", "tensor_parallel"):
                continue
            default = (f.default_factory() if f.default_factory
                       is not dataclasses.MISSING else f.default)
            setattr(self, f.name, kwargs.pop(f.name, default))
        if kwargs:
            logger.warning(f"init_inference: ignoring unsupported keys {sorted(kwargs)}")
        self._check_ported()

    def _check_ported(self) -> None:
        if self.serve_mode not in ("auto", "dequant"):
            raise _unported(f"serve_mode={self.serve_mode!r}",
                            "Weight quantization and serve modes")
        if self.quant and self.quant.get("enabled", True):
            raise _unported("quant", "Weight quantization and serve modes")
        if self.kv_cache_dtype == "int8":
            raise _unported("kv_cache_dtype='int8'", "int8 KV at rest")
        if self.kv_cache_dtype is not None:
            raise ValueError(f"kv_cache_dtype must be None or 'int8', got "
                             f"{self.kv_cache_dtype!r}")
        if self.speculative and self.speculative.get("enabled", True):
            raise _unported("speculative", "Speculative decoding")
        if self.capacity is not None:
            raise _unported("capacity", "Capacity streaming")
        if self.tensor_parallel.enabled and self.tensor_parallel.tp_size > 1:
            raise _unported(f"tensor_parallel.tp_size={self.tensor_parallel.tp_size}",
                            "Multi-GPU")
