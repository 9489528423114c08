"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

Serves Llama models through `init_inference(...)` → `forward` / `generate`
on one CUDA device, with hand-written kernels for flash attention (forward)
and decode attention. It imports `torch`, never `jax`, and nothing of
`deepspeed_tpu`.
"""

from __future__ import annotations

from typing import Any

__version__ = "0.1.0"


def init_inference(model: Any = None, config: Any = None, device=None, **kwargs):
    """Build an inference engine (counterpart of
    `deepspeed_tpu.init_inference`).

    `model` is an `nn.Module` (e.g. `models.llama.LlamaForCausalLM`) or a
    `(module, params)` tuple, where `params` is a JAX parameter tree of numpy
    arrays; `params=` is accepted too. `config` is a dict or a
    `DeepSpeedInferenceConfig`, and keyword arguments are config keys.
    `device=None` means CUDA; without CUDA it raises unless `device="cpu"`.
    """
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    params = kwargs.pop("params", None)
    if not isinstance(config, DeepSpeedInferenceConfig):
        config = DeepSpeedInferenceConfig(**{**(config or {}), **kwargs})
    return InferenceEngine(model, config, params=params, device=device)
