"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``).

Same keys as the JAX package's `DeepSpeedInferenceConfig`. Values this port
does not serve yet raise `NotImplementedError` naming the ROADMAP.md item
that brings them; unknown keys are accepted and ignored with a warning.
`tensor_parallel.tp_size` > 1 serves the Llama family over that many ranks
(`serve_modes.serving_topology`); the engines refuse other models at tp > 1.
`choose_serve_mode` is the JAX package's `serve_mode="auto"` decision table.

The `capacity` block holds the capacity serve mode's options
(`inference/capacity_scan.py`): `double_buffer` (default True; False is the
synchronous A/B mode), `nvme_dir` and `nvme_layers` (the last N layers
parked in swap files under that directory). The resilience knobs
(`prefetch_watchdog_s`, `dispatch_deadline_s`, `stage_retries`), in this
block or in `resilience`, raise: they are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.runtime.config_utils import unported as _unported
from deepspeed_tpu_torch.utils.logging import logger

# fp16 names map to bf16, as in the JAX package: the port's kernels are bf16
_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "torch.bfloat16": torch.bfloat16,
    "fp16": torch.bfloat16, "half": torch.bfloat16, "torch.half": torch.bfloat16,
    "torch.float16": torch.bfloat16,
    "fp32": torch.float32, "float": torch.float32, "torch.float32": torch.float32,
}


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
    quant: Optional[dict] = None  # {"enabled": True, "group_size": N} → int8 weights
    # "dequant" (the whole tree resident; int8 dequantized at use),
    # "layer_scan" (int8 per-layer stacks through the fused dequant-GEMM),
    # "capacity" (the layers streamed from host memory and NVMe every pass)
    # or "auto" (`choose_serve_mode` on the card's memory)
    serve_mode: str = "auto"
    speculative: Optional[dict] = None
    capacity: Optional[dict] = None  # {"double_buffer", "nvme_dir", "nvme_layers"}
    kv_cache_dtype: Optional[str] = None  # "int8": the KV cache int8 at rest
    # the layer scan's products: None = the fused dequant-GEMM kernel on
    # CUDA (the naive path on the CPU); False = the naive dequant matmul
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
            # the JAX package's int8 compute dtype; weights quantize through
            # `quant` instead
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
        from deepspeed_tpu_torch.inference.capacity_scan import check_options
        check_options("capacity", self.capacity)
        check_options("resilience", self.resilience)
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', got "
                             f"{self.kv_cache_dtype!r}")
        if self.speculative and self.speculative.get("enabled", True):
            raise _unported("speculative", "The rest")

    @property
    def tp_size(self) -> int:
        """The tensor-parallel degree asked for (1 when disabled)."""
        tp = self.tensor_parallel
        return int(tp.tp_size) if tp.enabled else 1


def choose_serve_mode(*, quantized: bool, layout_ok: bool, multi_device: bool,
                      dense_bytes: int, int8_bytes: int, layer_bytes: int,
                      kv_bytes: int, workspace_bytes: int,
                      hbm_bytes: int, n_devices: int = 1,
                      tp_shardable: bool = False,
                      spec_bytes: int = 0) -> str:
    """The `serve_mode="auto"` decision table, first fit wins. Every mode
    must also hold the KV cache, the decode workspace and `spec_bytes`;
    `hbm_bytes` is per device and the resident modes size against
    `hbm_bytes × n_devices`.

    | condition                                               | mode       |
    |---------------------------------------------------------|------------|
    | HBM size unknown (0)                                    | dequant    |
    | unquantized: streaming unsupported or fits 0.9·HBM_tot  | dequant    |
    | unquantized otherwise                                   | capacity   |
    | quantized: layer_scan unsupported on this mesh/layout   | dequant    |
    | 1.5·dense + KV + ws ≤ 0.5·HBM_tot                       | dequant    |
    | int8 tree + one dense layer + KV + ws ≤ 0.8·HBM_tot     | layer_scan |
    | otherwise, capacity supported (single device)           | capacity   |
    | otherwise                                               | layer_scan |
    """
    if not hbm_bytes:
        return "dequant"
    overhead = kv_bytes + workspace_bytes + int(spec_bytes)
    hbm_total = hbm_bytes * max(1, int(n_devices))
    scan_ok = layout_ok and (not multi_device or tp_shardable)
    capacity_ok = layout_ok and not multi_device
    if not quantized:
        if not capacity_ok or dense_bytes + overhead <= 0.9 * hbm_total:
            return "dequant"
        return "capacity"
    if not scan_ok or 1.5 * dense_bytes + overhead <= 0.5 * hbm_total:
        return "dequant"
    if int8_bytes + layer_bytes + overhead <= 0.8 * hbm_total:
        return "layer_scan"
    return "capacity" if capacity_ok else "layer_scan"
