"""Readers of torch-DeepSpeed checkpoints (counterpart of
``deepspeed_tpu/checkpoint/ds_import.py``).

A run migrating from the reference brings a directory of
`mp_rank_*_model_states.pt` (the module's weights and `param_shapes`)
and `zero_pp_rank_N_mp_rank_M_optim_states.pt` (each data rank's flat f32
master partitions). These functions read that layout:

- `load_model_states`: the module state dict (its bf16/fp16 training
  weights, as the file keeps them) and the rest of the file's metadata;
- `get_fp32_state_dict_from_zero_checkpoint`: the whole f32 masters
  merged from the ZeRO partitions (stage 1/2: the ranks' slices of each
  group's flat buffer concatenated; stage 3: each parameter's
  ceil(numel / world) partitions, the world padding trimmed);
- `load_reference_checkpoint`: the weights with the f32 masters in place
  of the module's where both exist.

Optimizer moments are not read: a migrated run restarts them, as the JAX
package's reader does. The files hold pickled Python objects beside the
tensors (`param_shapes`, versions, the run's arguments), so they load with
`weights_only=False`: read only checkpoints you trust.
`import_reference_checkpoint` needs the HF-family converters of the JAX
package's `module_inject/load_checkpoint.py`, which are not ported.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.checkpointing import read_latest
from deepspeed_tpu_torch.runtime.config_utils import unported

# the reference's checkpoint/constants.py key names
OPTIMIZER_STATE_DICT = "optimizer_state_dict"
FP32_FLAT_GROUPS = "fp32_flat_groups"
SINGLE_PARTITION_OF_FP32_GROUPS = "single_partition_of_fp32_groups"
ZERO_STAGE = "zero_stage"
PARAM_SHAPES = "param_shapes"
MODULE = "module"


def resolve_dir(ckpt_dir: str, tag: Optional[str] = None) -> str:
    tag = tag or read_latest(ckpt_dir)
    return os.path.join(ckpt_dir, tag) if tag else ckpt_dir


def _sorted_files(d: str, pattern: str) -> List[str]:
    return sorted(glob.glob(os.path.join(d, pattern)),
                  key=lambda p: [int(x) for x in re.findall(r"\d+", os.path.basename(p))])


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def load_model_states(ckpt_dir: str, tag: Optional[str] = None
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The module's weights and metadata from `mp_rank_*_model_states.pt`
    (or the stage-3 `zero_pp_rank_0_mp_rank_00_model_states.pt`): (state
    dict with `module.` prefixes stripped, the file's other entries)."""
    d = resolve_dir(ckpt_dir, tag)
    files = _sorted_files(d, "mp_rank_*_model_states.pt") or \
        _sorted_files(d, "zero_pp_rank_0_mp_rank_*_model_states.pt")
    if not files:
        raise FileNotFoundError(f"no *_model_states.pt under {d}")
    if len(files) > 1:
        raise NotImplementedError(
            f"{len(files)} model-parallel shards found: merge them with the "
            "reference's ds_to_universal first (mp_rank > 0 resharding)")
    blob = _load(files[0])
    module = blob.get(MODULE, blob)
    sd = {k[len("module."):] if k.startswith("module.") else k: v.detach()
          for k, v in module.items()}
    return sd, {k: v for k, v in blob.items() if k != MODULE}


def _param_shape_groups(meta: Dict[str, Any]) -> List[Dict[str, tuple]]:
    shapes = meta[PARAM_SHAPES]
    if isinstance(shapes, dict):
        shapes = [shapes]
    return [{name: tuple(int(x) for x in s) for name, s in group.items()} for group in shapes]


def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str, tag: Optional[str] = None
                                             ) -> Dict[str, torch.Tensor]:
    """The whole f32 masters merged from `zero_pp_rank_*_optim_states.pt`
    (module docstring)."""
    d = resolve_dir(ckpt_dir, tag)
    optim_files = _sorted_files(d, "*zero_pp_rank_*_optim_states.pt")
    if not optim_files:
        raise FileNotFoundError(f"no zero_pp_rank_*_optim_states.pt under {d}")
    _, meta = load_model_states(ckpt_dir, tag)
    shape_groups = _param_shape_groups(meta)
    blobs = [_load(f)[OPTIMIZER_STATE_DICT] for f in optim_files]
    stage, world = blobs[0].get(ZERO_STAGE, 2), len(blobs)
    key = SINGLE_PARTITION_OF_FP32_GROUPS \
        if SINGLE_PARTITION_OF_FP32_GROUPS in blobs[0] else FP32_FLAT_GROUPS
    flat = [[g.detach().float().reshape(-1) for g in b[key]] for b in blobs]   # [rank][group]
    out: Dict[str, torch.Tensor] = {}
    for gi, shapes in enumerate(shape_groups):
        offset = 0
        if stage <= 2:
            merged = torch.cat([flat[r][gi] for r in range(world)])
            for name, shape in shapes.items():
                n = int(torch.Size(shape).numel())
                out[name] = merged[offset:offset + n].reshape(shape).clone()
                offset += n
            if offset > merged.numel():
                raise ValueError(f"group {gi}: consumed {offset} of {merged.numel()} numels")
        else:
            for name, shape in shapes.items():
                n = int(torch.Size(shape).numel())
                part = -(-n // world)
                pieces = [flat[r][gi][offset:offset + part] for r in range(world)]
                out[name] = torch.cat(pieces)[:n].reshape(shape)
                offset += part
    return out


def load_reference_checkpoint(ckpt_dir: str, tag: Optional[str] = None,
                              prefer_fp32_weights: bool = True
                              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """One state dict: the module's weights, with the merged f32 masters in
    their place where ZeRO optimizer partitions are present."""
    sd, meta = load_model_states(ckpt_dir, tag)
    if prefer_fp32_weights:
        try:
            fp32 = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
        except FileNotFoundError:
            fp32 = {}
        sd = {**sd, **fp32}
    return sd, meta


def import_reference_checkpoint(ckpt_dir: str, config: Any = None, tag: Optional[str] = None,
                                model_type: Optional[str] = None, dtype: Any = None):
    """(model, params, meta) from a torch-DeepSpeed checkpoint through the
    HF-family converters, which the port does not have yet."""
    raise unported("import_reference_checkpoint (the HF-family converters of "
                   "module_inject/load_checkpoint.py)", "The rest")
