"""Inference engine v1 (counterpart of ``deepspeed_tpu/inference/engine.py``).

`forward` scores a prompt with no cache; `generate` runs a prefill and then
a decode loop over a dense `KVCache`. Where the JAX package compiles the
whole loop into one program, this engine runs it eagerly, one model call per
token. The serve-mode ladder, telemetry hub, program ledger and recompile
detector of the JAX engine are not ported.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.kv_cache import KVCache
from deepspeed_tpu_torch.models.llama import load_jax_params
from deepspeed_tpu_torch.ops.sampling import sample_logits
from deepspeed_tpu_torch.utils.logging import logger

CACHE_LEN_MULTIPLE = 128  # the cache length is rounded up to a multiple of this


def _cache_dims(cfg) -> tuple:
    """(num_layers, kv_heads, head_dim) from a model config (duck-typed
    over llama/gpt2/falcon naming)."""
    layers = getattr(cfg, "num_hidden_layers", None) or getattr(cfg, "n_layer")
    heads = (getattr(cfg, "num_key_value_heads", None)
             or getattr(cfg, "num_kv_heads", None)
             or getattr(cfg, "num_attention_heads", None) or getattr(cfg, "n_head"))
    head_dim = getattr(cfg, "head_dim", None)
    if head_dim is None:
        hidden = getattr(cfg, "hidden_size", None) or getattr(cfg, "n_embd")
        n_attn = getattr(cfg, "num_attention_heads", None) or getattr(cfg, "n_head")
        head_dim = hidden // n_attn
    return int(layers), int(heads), int(head_dim)


class InferenceEngine:
    """Generation wrapper over a model (`nn.Module` with a `cfg`).

    `params`, when given, is a JAX parameter tree (numpy leaves) copied into
    the model with `load_jax_params`. Placement casts every floating
    parameter to `config.dtype` and moves the model to `device` (`None` →
    CUDA; a machine without CUDA raises unless `device="cpu"`)."""

    def __init__(self, model: Any, config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Any = None, device=None):
        if config is None:
            config = DeepSpeedInferenceConfig()
        self._config = config
        self.accelerator = get_accelerator(device)
        self.device = self.accelerator.device
        if isinstance(model, tuple):
            model, params = model
        if params is not None:
            load_jax_params(model, params)
        self.module = model.to(device=self.device, dtype=config.dtype).eval()
        self.model_cfg = model.cfg
        self.last_decode_tok_s: Optional[float] = None
        n_params = sum(p.numel() for p in self.module.parameters())
        logger.info(f"InferenceEngine: {n_params / 1e6:.1f}M params on "
                    f"{self.accelerator.device_name()}, dtype={config.dtype}")

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, dtype=torch.long, device=self.device)

    @torch.inference_mode()
    def forward(self, input_ids, *args, **kwargs) -> torch.Tensor:
        """Logits (B, S, V) of `input_ids` (B, S), with no cache."""
        return self.module(self._ids(input_ids))

    __call__ = forward

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 128,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id: Optional[int] = None,
                 seed: int = 0, pad_token_id: int = 0) -> torch.Tensor:
        """`input_ids` (B, S), left-aligned equal-length prompts →
        (B, S + max_new_tokens): the prompts followed by the new tokens.
        Greedy when temperature == 0, else temperature / top-k / top-p
        sampling from a generator seeded with `seed`. The first token comes
        from the prefill, then max_new_tokens − 1 decode steps; after a row
        emits `eos_token_id` its later tokens are `pad_token_id`."""
        cfg = self.model_cfg
        ids = self._ids(input_ids)
        b, s = ids.shape
        max_len = -(-(s + max_new_tokens) // CACHE_LEN_MULTIPLE) * CACHE_LEN_MULTIPLE
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)

        def sample(logits):
            return sample_logits(logits, generator, temperature=temperature,
                                 top_k=top_k, top_p=top_p)

        t0 = time.perf_counter()
        cache = KVCache.create(cfg.num_hidden_layers, b, max_len,
                               cfg.num_key_value_heads, cfg.head_dim,
                               dtype=self._config.dtype, device=self.device)
        logits, cache = self.module(ids, cache=cache)
        tok = sample(logits[:, -1, :])
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        if eos_token_id is not None:
            done = tok == eos_token_id
        new = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self.module(tok[:, None], cache=cache)
            tok = sample(logits[:, -1, :])
            if eos_token_id is not None:
                tok = torch.where(done, torch.full_like(tok, pad_token_id), tok)
                done = done | (tok == eos_token_id)
            new.append(tok)
        out = torch.cat([ids, torch.stack(new, dim=1)], dim=1)
        self.accelerator.synchronize()
        dt = time.perf_counter() - t0
        self.last_decode_tok_s = (b * max_new_tokens / dt) if dt > 0 else None
        return out
