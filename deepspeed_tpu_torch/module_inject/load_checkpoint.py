"""Load Hugging Face checkpoints into the port's zoo modules (counterpart of
``deepspeed_tpu/module_inject/load_checkpoint.py``), for the families the
port serves from a checkpoint: phi (`model_type` "phi") and GPT-NeoX
("gpt_neox"). Any other `model_type` raises (ROADMAP.md, Queue 1, 'The
rest').

The weights come out as the JAX package's parameter tree of numpy arrays,
the layout every engine of the port takes (`init_inference((model,
params))`, `InferenceEngineV2((model, params))`, `model.load_jax_params`):
a torch `nn.Linear` weight (out, in) becomes a flax kernel (in, out),
per-layer tensors stack along a leading layer axis, and GPT-NeoX's fused
`query_key_value` (per head [q | k | v]) splits into q, k and v.
safetensors files are read with the `safetensors` package, which only a
`.safetensors` checkpoint needs; torch `.bin` files load everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.utils.logging import logger

FAMILIES = ("phi", "gpt_neox")


# ---------------------------------------------------------------- state dicts
def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read an HF model directory (safetensors shards, or torch .bin) into a
    flat name -> numpy dict."""
    if os.path.isfile(path):
        return _load_one(path)
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out: Dict[str, np.ndarray] = {}
        for shard in shards:
            out.update(_load_one(os.path.join(path, shard)))
        return out
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            return _load_one(p)
    raise FileNotFoundError(f"no model weights found under {path}")


def _load_one(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".safetensors"):
        from safetensors import safe_open   # only a safetensors checkpoint needs it
        out = {}
        with safe_open(path, framework="np") as f:
            for key in f.keys():
                out[key] = f.get_tensor(key)
        return out
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _to_np(v) for k, v in sd.items()}


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


# ---------------------------------------------------------------- configs
# The activation each family's module hardcodes, with the HF config values
# that name it: a checkpoint with another activation fails at import rather
# than giving wrong logits.
_FAMILY_ACTIVATIONS = {
    "phi": ("gelu_new", "gelu_pytorch_tanh"),       # models/phi.py: tanh GELU
    "gpt_neox": ("gelu",),                          # models/gptneox.py: exact erf GELU
}


def _check_activation(model_type: str, config: dict) -> None:
    allowed = _FAMILY_ACTIVATIONS.get(model_type)
    if allowed is None:
        return
    act = config.get("hidden_act")
    if act is not None and act not in allowed:
        raise NotImplementedError(
            f"{model_type} checkpoint uses hidden_act={act!r}; this model "
            f"hardcodes {allowed[0]!r}: importing would produce wrong logits")


def _config_dict(config: Any) -> dict:
    """An HF config.json (a dict, a path to it or its directory, or a
    transformers config) as a dict."""
    if isinstance(config, str):
        p = os.path.join(config, "config.json") if os.path.isdir(config) else config
        with open(p) as f:
            config = json.load(f)
    if not isinstance(config, dict):  # transformers PretrainedConfig
        config = config.to_dict()
    return config


def _refuse_family(model_type: str) -> NotImplementedError:
    return unported(f"HF checkpoints of model_type={model_type!r} (the port loads "
                    f"{', '.join(FAMILIES)})", "The rest")


def from_hf_config(config: Any):
    """HF config.json (dict / path / transformers config) -> the port's zoo
    config (`PhiConfig` or `GPTNeoXConfig`)."""
    config = _config_dict(config)
    model_type = config.get("model_type", "llama")
    if model_type not in FAMILIES:
        raise _refuse_family(model_type)
    _check_activation(model_type, config)
    if model_type == "phi":
        from deepspeed_tpu_torch.models.phi import PhiConfig
        if config.get("qk_layernorm"):
            raise NotImplementedError("phi qk_layernorm is not supported")
        return PhiConfig(
            vocab_size=config["vocab_size"], hidden_size=config["hidden_size"],
            intermediate_size=config["intermediate_size"],
            num_hidden_layers=config["num_hidden_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config.get("num_key_value_heads")
            or config["num_attention_heads"],
            max_position_embeddings=config.get("max_position_embeddings", 2048),
            partial_rotary_factor=config.get("partial_rotary_factor", 0.5),
            rope_theta=config.get("rope_theta", 10000.0),
            layer_norm_eps=config.get("layer_norm_eps", 1e-5))
    from deepspeed_tpu_torch.models.gptneox import GPTNeoXConfig
    if config.get("attention_bias") is False:
        raise NotImplementedError("gpt_neox attention_bias=False is not supported: the "
                                  "module's q/k/v/dense projections carry a bias")
    return GPTNeoXConfig(
        vocab_size=config["vocab_size"], hidden_size=config["hidden_size"],
        intermediate_size=config.get("intermediate_size") or 4 * config["hidden_size"],
        num_hidden_layers=config["num_hidden_layers"],
        num_attention_heads=config["num_attention_heads"],
        max_position_embeddings=config.get("max_position_embeddings", 2048),
        rotary_pct=config.get("rotary_pct", 0.25),
        rope_theta=config.get("rope_theta") or config.get("rotary_emb_base", 10000.0),
        layer_norm_eps=config.get("layer_norm_eps", 1e-5),
        use_parallel_residual=config.get("use_parallel_residual", True))


# ---------------------------------------------------------------- converters
def _stack(sd: Dict[str, np.ndarray], pattern: str, n: int,
           transpose: bool = False) -> np.ndarray:
    """Stack `pattern % i` for i in range(n) along a new leading layer axis."""
    mats = [sd[pattern % i] for i in range(n)]
    if transpose:
        mats = [m.T for m in mats]
    return np.stack(mats)


def _convert_phi(sd, cfg) -> Dict[str, Any]:
    L = cfg.num_hidden_layers
    pre = "model." if "model.embed_tokens.weight" in sd else ""

    def proj(pat):
        return {"kernel": _stack(sd, f"{pre}layers.%d.{pat}.weight", L, transpose=True),
                "bias": _stack(sd, f"{pre}layers.%d.{pat}.bias", L)}

    return {
        "embed_tokens": sd[f"{pre}embed_tokens.weight"],
        "final_layernorm": {"scale": sd[f"{pre}final_layernorm.weight"],
                            "bias": sd[f"{pre}final_layernorm.bias"]},
        "lm_head": sd["lm_head.weight"].T,
        "lm_head_bias": sd["lm_head.bias"],
        "layers": {
            "input_layernorm": {
                "scale": _stack(sd, f"{pre}layers.%d.input_layernorm.weight", L),
                "bias": _stack(sd, f"{pre}layers.%d.input_layernorm.bias", L)},
            "self_attn": {
                "q_proj": proj("self_attn.q_proj"),
                "k_proj": proj("self_attn.k_proj"),
                "v_proj": proj("self_attn.v_proj"),
                "dense": proj("self_attn.dense"),
            },
            "mlp": {"fc1": proj("mlp.fc1"), "fc2": proj("mlp.fc2")},
        },
    }


def _convert_gptneox(sd, cfg) -> Dict[str, Any]:
    L = cfg.num_hidden_layers
    pre = "gpt_neox." if "gpt_neox.embed_in.weight" in sd else ""
    nh, hd = cfg.num_attention_heads, cfg.head_dim

    def split_qkv(i):
        # fused per-head contiguous [q_h | k_h | v_h] (view(heads, 3*hd))
        w = sd[f"{pre}layers.{i}.attention.query_key_value.weight"]
        bvec = sd[f"{pre}layers.{i}.attention.query_key_value.bias"]
        w3 = w.reshape(nh, 3, hd, w.shape[-1])
        b3 = bvec.reshape(nh, 3, hd)
        return ([w3[:, j].reshape(nh * hd, -1).T for j in range(3)],
                [b3[:, j].reshape(nh * hd) for j in range(3)])

    qkv = [split_qkv(i) for i in range(L)]

    def ln(pat):
        return {"scale": _stack(sd, f"{pre}layers.%d.{pat}.weight", L),
                "bias": _stack(sd, f"{pre}layers.%d.{pat}.bias", L)}

    def proj(pat):
        return {"kernel": _stack(sd, f"{pre}layers.%d.{pat}.weight", L, transpose=True),
                "bias": _stack(sd, f"{pre}layers.%d.{pat}.bias", L)}

    def fused(j):
        return {"kernel": np.stack([t[0][j] for t in qkv]),
                "bias": np.stack([t[1][j] for t in qkv])}

    return {
        "embed_in": sd[f"{pre}embed_in.weight"],
        "final_layer_norm": {"scale": sd[f"{pre}final_layer_norm.weight"],
                             "bias": sd[f"{pre}final_layer_norm.bias"]},
        "embed_out": sd["embed_out.weight"].T,
        "layers": {
            "input_layernorm": ln("input_layernorm"),
            "post_attention_layernorm": ln("post_attention_layernorm"),
            "attention": {"q_proj": fused(0), "k_proj": fused(1), "v_proj": fused(2),
                          "dense": proj("attention.dense")},
            "mlp": {"dense_h_to_4h": proj("mlp.dense_h_to_4h"),
                    "dense_4h_to_h": proj("mlp.dense_4h_to_h")},
        },
    }


_CONVERTERS = {"phi": _convert_phi, "gpt_neox": _convert_gptneox}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def load_hf_checkpoint(path: str, config: Any = None, dtype: Any = None,
                       model_type: Optional[str] = None, param_dtype: Any = None):
    """(model, params) from an HF checkpoint directory (or weights file).

    `config`: the port's zoo config, or None to derive it from the
    directory's config.json (`from_hf_config`); `dtype` replaces its
    compute dtype. `model` is the family's module on the meta device, a
    skeleton as the JAX package returns an unbound module; `params` is the
    JAX-layout tree of C-contiguous numpy arrays in `param_dtype` (default
    float32, the master convention), which the engines place on their
    device in their dtype: `init_inference((model, params))`."""
    raw = None
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json")):
        raw = _config_dict(path)
    if model_type is None:
        model_type = raw.get("model_type", "llama") if raw is not None else "llama"
    if model_type not in _CONVERTERS:
        raise _refuse_family(model_type)
    if config is None:
        config = from_hf_config(path)
    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)
    from deepspeed_tpu_torch.models.gptneox import GPTNeoXForCausalLM
    from deepspeed_tpu_torch.models.phi import PhiForCausalLM
    cls = {"phi": PhiForCausalLM, "gpt_neox": GPTNeoXForCausalLM}[model_type]
    model = cls(config, device="meta")

    sd = load_state_dict(path)
    params = _CONVERTERS[model_type](sd, config)
    n = sum(np.asarray(v).size for v in _leaves(params))
    logger.info(f"loaded HF {model_type} checkpoint from {path}: {n / 1e6:.1f}M params")
    np_dtype = np.float32 if param_dtype is None else np.dtype(param_dtype)
    # transposed views (lm_head.weight.T) become contiguous arrays
    params = _tree_map(lambda x: np.ascontiguousarray(np.asarray(x, np_dtype)), params)
    return model, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
