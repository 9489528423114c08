"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

Trains Llama models through `initialize(...)` → `train_batch` (or
`forward`/`backward`/`step`) and serves them through `init_inference(...)`
→ `forward`/`generate` and the v2 `InferenceEngineV2` (paged cache or
dense slot rows), on one CUDA device; BLOOM (`models/bloom.py`, alibi),
phi (`models/phi.py`) and GPT-NeoX (`models/gptneox.py`, also from HF
checkpoints through `module_inject.load_hf_checkpoint`) serve through both
engines; the MoE families (`models/qwen2_moe.py`,
`models/mixtral.py`) serve through `init_inference` and train through
`initialize` with their loss functions; `ops/sparse_attention` is
block-sparse attention. Hand-written kernels: flash attention (forward and
backward), decode and paged attention (the paged kernels with alibi too),
the int8 dequant-GEMM, the grouped expert GEMM (forward and backward) and
block-sparse attention. Llama and the MoE families train data-parallel
over several ranks with ZeRO stages 0-3 (`init_distributed`, then
`initialize`); Llama also with ZeRO++ (int8 gradient reduce-scatters and
weight gathers, MiCS/hpZ groups over a `repl` axis) and with the 1-bit
optimizers' compressed wire (OneBitAdam, ZeroOneAdam, OneBitLamb with
`comm_backend_name`); and a run saves and resumes at any number of data ranks
(`engine.save_checkpoint`/`load_checkpoint`, `runtime/checkpointing.py`;
universal and reference-checkpoint files in `checkpoint/`). Llama
serves tensor-parallel over several ranks
(`init_distributed`, `tensor_parallel={"tp_size": N}`), each rank running
the kernels on its shard, and the MoE families serve expert-parallel
(`init_distributed`, `groups.initialize(MeshTopology(ep=N))`), each rank
holding its share of the experts. It imports `torch`, never
`jax`, and nothing of `deepspeed_tpu`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from deepspeed_tpu_torch import comm  # noqa: F401
from deepspeed_tpu_torch.comm import init_distributed  # noqa: F401

__version__ = "0.1.0"


def initialize(model: Any = None, model_parameters: Any = None, config: Any = None,
               loss_fn: Optional[Callable] = None, training_data=None, collate_fn=None,
               lr_scheduler=None, optimizer=None, device=None):
    """Build a training engine (counterpart of `deepspeed_tpu.initialize`):
    returns `(engine, optimizer, dataloader, lr_scheduler)`.

    The topology is the installed one, or else the process group's, which
    this call installs: every rank on the `data` axis (`MeshTopology()`, dp
    = the world size), or, where the config's `zero_optimization` sets
    `mics_shard_size` > 0 (else `zero_hpz_partition_size` > 1), groups of
    that many data ranks repeated across `repl` (the JAX `initialize`'s
    mapping); one process a rank (`torchrun`, or `init_distributed` in
    each), each on its local rank's card. An installed topology whose
    `data` axis is not that group size raises. ZeRO
    (`zero_optimization.stage` 0-3) then shards the state over the data
    ranks (`runtime/zero/partition.py`).

    `model` is an `nn.Module`; `model_parameters` is a JAX parameter tree of
    numpy arrays copied into it by the module's own `load_jax_params(tree)`,
    or None to keep the module's own weights. `config` is a DeepSpeed config dict, a JSON path
    or a `DeepSpeedConfig`. `loss_fn(module, batch)` returns the loss or
    `(loss, aux)`; by default the module is called with the batch as keyword
    arguments. `device=None` means CUDA; without CUDA it raises unless
    `device="cpu"`.
    """
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.utils import groups
    from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
    if isinstance(config, DeepSpeedConfig):
        shard = config.zero_config.shard_group_size
    else:
        raw = config
        if isinstance(config, str):
            import json
            with open(config) as f:
                raw = json.load(f)
        shard = DeepSpeedZeroConfig.from_dict((raw or {}).get("zero_optimization")) \
            .shard_group_size
    try:
        topology = groups.get_topology(create_default=False)
    except RuntimeError:
        topology = groups.initialize(groups.MeshTopology(mics_shard_size=shard))
    if shard and topology.dp_size != shard:
        raise ValueError(f"the config's MiCS/hpZ group of {shard} data ranks is not the "
                         f"installed {topology!r}'s data axis")
    if not isinstance(config, DeepSpeedConfig):
        config = DeepSpeedConfig(config, world_size=topology.world_size)
    engine = DeepSpeedEngine(model=model, loss_fn=loss_fn, config=config,
                             model_parameters=model_parameters,
                             training_data=training_data, collate_fn=collate_fn,
                             lr_scheduler=lr_scheduler, optimizer=optimizer, device=device)
    return engine, engine.opt, engine.training_dataloader, engine.lr_scheduler


def init_inference(model: Any = None, config: Any = None, device=None, **kwargs):
    """Build an inference engine (counterpart of
    `deepspeed_tpu.init_inference`).

    `model` is an `nn.Module` (`models.llama.LlamaForCausalLM`,
    `models.bloom.BloomForCausalLM`, `models.phi.PhiForCausalLM`,
    `models.gptneox.GPTNeoXForCausalLM`, or an MoE family:
    `models.qwen2_moe.Qwen2MoeForCausalLM`, `models.mixtral.MixtralForCausalLM`)
    or a `(module, params)` tuple, where `params` is a JAX parameter tree of
    numpy arrays; `params=` is accepted too. `config` is a dict or a
    `DeepSpeedInferenceConfig`, and keyword arguments are config keys.
    `device=None` means CUDA; without CUDA it raises unless `device="cpu"`.
    `tensor_parallel={"tp_size": N}` serves a Llama over N ranks, one
    process each (`init_distributed`; see `inference/engine.py`); an
    installed `utils.groups.MeshTopology(ep=N)` serves an MoE family over N
    expert ranks.
    """
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    params = kwargs.pop("params", None)
    if not isinstance(config, DeepSpeedInferenceConfig):
        config = DeepSpeedInferenceConfig(**{**(config or {}), **kwargs})
    return InferenceEngine(model, config, params=params, device=device)
