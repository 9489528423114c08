"""Inference engine v1 (counterpart of ``deepspeed_tpu/inference/engine.py``).

`forward` scores a prompt with no cache; `generate` runs a prefill and then
a decode loop over a dense `KVCache`. Where the JAX package compiles the
whole loop into one program, this engine runs it eagerly, one model call per
token.

Serve modes (`serve_modes.py`): `dequant` runs the module, on its own
weights or, with `quant`, on the int8 tree dequantized whole (once per
`generate`, once per `forward`); `layer_scan` runs `generate` through
`quantized_layer_scan` on the per-layer int8 stacks with the fused
dequant-GEMM; `capacity` runs `forward` and `generate` through the capacity
runner (`capacity_scan.CapacityRunner`, `engine._capacity`), which streams
every layer from host memory or NVMe each pass (K2 and, with `quant`, K5 on
the streamed slices). `serving_stats()` reports the last `generate`'s
decode rate and, in the capacity mode, `h2d_bytes_step` and
`prefetch_stall_ms`. The layer-streamed modes run the LM head on the last
position only in `generate`. `kv_cache_dtype="int8"` stores the dequant
mode's cache int8 at rest. The serve-mode ladder, telemetry hub, program ledger and recompile
detector of the JAX engine are not ported.

Tensor parallelism (`tensor_parallel={"tp_size": N}`, Llama only): one
process per rank, started by `torchrun` or joined by
`deepspeed_tpu_torch.init_distributed`; each rank holds its shard of the
weights and of the KV cache (Hkv/N heads) and every rank returns the same
tokens. The gathered logits are the same bits on every rank, and a sampled
`generate` draws from a generator seeded identically on each.

Expert parallelism (the MoE families): under an installed
`MeshTopology(ep=N)` (one process per rank, as above) each rank holds the
whole dense model, the whole batch, a whole KV cache and its E/N experts of
every stack; the MoE layers sum or gather the ranks' expert outputs over
`expert` (`moe/layer.py`), so the logits, and the tokens, are the same bits
on every rank.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch
from torch.func import functional_call

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.capacity_scan import round_up_len
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.kv_cache import KVCache
from deepspeed_tpu_torch.inference.serve_modes import (
    dense_state,
    place_params,
    serving_topology,
    use_fused_int8,
)
from deepspeed_tpu_torch.ops.sampling import sample_logits
from deepspeed_tpu_torch.utils.logging import logger


def _cache_dims(cfg, tp: int = 1) -> tuple:
    """(num_layers, kv_heads, head_dim) from a model config (duck-typed
    over llama/gpt2/falcon naming); kv_heads is a tp-way rank's share."""
    layers = getattr(cfg, "num_hidden_layers", None) or getattr(cfg, "n_layer")
    heads = (getattr(cfg, "num_key_value_heads", None)
             or getattr(cfg, "num_kv_heads", None)
             or getattr(cfg, "num_attention_heads", None) or getattr(cfg, "n_head"))
    head_dim = getattr(cfg, "head_dim", None)
    if head_dim is None:
        hidden = getattr(cfg, "hidden_size", None) or getattr(cfg, "n_embd")
        n_attn = getattr(cfg, "num_attention_heads", None) or getattr(cfg, "n_head")
        head_dim = hidden // n_attn
    if int(heads) % tp:
        raise ValueError(f"{heads} KV heads do not divide over tp={tp}")
    return int(layers), int(heads) // tp, int(head_dim)


class InferenceEngine:
    """Generation wrapper over a model (`nn.Module` with a `cfg`): Llama,
    BLOOM (its alibi attention takes the masked path, with no kernel, as in
    the JAX package), or the MoE families Qwen2-MoE and Mixtral
    (`generate`'s prefill runs their experts through the grouped GEMM, its
    decode steps through the ragged buffer; `forward` routes with the
    training semantics' drops).

    `params`, when given, is a JAX parameter tree (numpy leaves), copied
    into the model with its `load_jax_params` or, with `quant`, kept as the
    engine's tree (a quantized leaf keeps its int8 bytes). Placement
    (`serve_modes.place_params`) casts every floating weight to
    `config.dtype` on `device` (`None` → CUDA; a machine without CUDA raises
    unless `device="cpu"`). `params` is then the placed tree with `quant`,
    else None (the module holds the weights)."""

    def __init__(self, model: Any, config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Any = None, device=None):
        if config is None:
            config = DeepSpeedInferenceConfig()
        self._config = config
        self.accelerator = get_accelerator(device)
        self.device = self.accelerator.device
        if isinstance(model, tuple):
            model, params = model
        self.module = model
        self.model_cfg = model.cfg
        self.topology = serving_topology(self)
        self.params = place_params(self, params)
        if config.kv_cache_dtype == "int8" and self.serve_mode != "dequant":
            logger.warning(f"kv_cache_dtype='int8' only quantizes the dequant serve "
                           f"mode's KV cache (resolved: {self.serve_mode}); the "
                           "layer-scan mode keeps a dense KV cache")
        self.last_decode_tok_s: Optional[float] = None
        logger.info(f"InferenceEngine: serve_mode={self.serve_mode}, "
                    f"quantized={self._quantized} on {self.accelerator.device_name()}, "
                    f"dtype={config.dtype}")

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, dtype=torch.long, device=self.device)

    def _use_fused_int8(self) -> bool:
        return use_fused_int8(self)

    def _call(self, state, *args, **kwargs):
        """The module on its own weights (`state` None) or on `state`."""
        if state is None:
            return self.module(*args, **kwargs)
        return functional_call(self.module, state, args, kwargs)

    @torch.inference_mode()
    def forward(self, input_ids, *args, **kwargs) -> torch.Tensor:
        """Logits (B, S, V) of `input_ids` (B, S), with no cache."""
        if self.serve_mode == "capacity":
            return self._capacity.forward(self._ids(input_ids))
        return self._call(dense_state(self), self._ids(input_ids))

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
        ids = self._ids(input_ids)
        b, s = ids.shape
        max_len = round_up_len(s + max_new_tokens)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)

        def sample(logits):
            return sample_logits(logits, generator, temperature=temperature,
                                 top_k=top_k, top_p=top_p)

        t0 = time.perf_counter()
        if self._capacity is not None:
            self._capacity.reset_stats()
        model_call = self._model_call()
        layers, kv_heads, head_dim = _cache_dims(self.model_cfg, self.topology.tp_size)
        cache = KVCache.create(layers, b, max_len, kv_heads, head_dim,
                               dtype=self._config.dtype, device=self.device,
                               quantized=(self._config.kv_cache_dtype == "int8"
                                          and self.serve_mode == "dequant"))
        logits, cache = model_call(ids, cache)
        tok = sample(logits[:, -1, :])
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        if eos_token_id is not None:
            done = tok == eos_token_id
        new = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = model_call(tok[:, None], cache)
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

    def serving_stats(self) -> dict:
        """The last `generate`: its serve mode and decode tok/s; in the
        capacity mode also the host-to-device bytes a step streams and the
        device ms the compute stream waited for copies (the prefetch stall;
        reading it waits for the last pass)."""
        stats = {"serve_mode": self.serve_mode, "decode_tok_s": self.last_decode_tok_s}
        if self._capacity is not None:
            stats.update(h2d_bytes_step=self._capacity.h2d_bytes_pass(),
                         prefetch_stall_ms=self._capacity.last_prefetch_stall_ms)
        return stats

    def _model_call(self):
        """`call(ids, cache) → (logits, cache)` with the cursors advanced, for
        one generate: the module (on the int8 tree dequantized once, with
        `quant`); in the `layer_scan` mode the layer scan over the per-layer
        int8 stacks, whose products run the fused dequant-GEMM; in the
        `capacity` mode the runner's streamed pass. The streamed modes give
        the last position's logits only."""
        if self.serve_mode == "capacity":
            runner = self._capacity
            return lambda ids, cache: runner.apply(ids, cache, last_only=True)
        if self.serve_mode != "layer_scan":
            state = dense_state(self)
            return lambda ids, cache: self._call(state, ids, cache=cache)
        from deepspeed_tpu_torch.inference.quantized_layer_scan import (
            layer_slices, make_scan_apply)
        apply = make_scan_apply(self.model_cfg, fused=self._use_fused_int8(),
                                mesh=self.topology if self.topology.tp_size > 1 else None)
        per_layer = layer_slices(self.params["layers"])

        def call(ids, cache):
            logits, cache = apply(self.params, ids, cache, per_layer, last_only=True)
            return logits, cache.replace(index=cache.index + ids.shape[1])

        return call
