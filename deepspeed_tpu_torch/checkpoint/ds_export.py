"""Universal-checkpoint export (counterpart of ``deepspeed_tpu/checkpoint/ds_export.py``).

The reference's universal layout: one folder a parameter holding its
whole, unsharded torch tensors,

    <output>/zero/<param_name>/fp32.pt
    <output>/zero/<param_name>/exp_avg.pt
    <output>/zero/<param_name>/exp_avg_sq.pt
    <output>/zero/<param_name>/step.pt
    <output>/zero/optimizer_state.pt          (param_groups, step, ds_meta)
    <output>/latest_universal                 (the source's tag)

`ds_to_universal` writes it from a checkpoint of this package
(`runtime/checkpointing.py`), at any dp, one leaf at a time. The atoms
carry the module's own parameter names and torch layouts
(`layers.0.self_attn.q_proj.weight`, an `nn.Linear` weight (out, in)), so
torch tooling reads them as they are; the JAX package writes its flax
names and layouts (`layers.0.self_attn.q_proj.kernel`, (in, out)).
`load_universal` reads any such folder back, and
`restore_tree_from_universal` assembles a tree shaped like a given one,
by its dotted paths: a module's flat name -> tensor dict, or a JAX
parameter tree (nested dicts), whose scan-stacked `layers` leaves it
stacks from the per-layer atoms, so a folder the JAX package wrote loads
too. With `checkpoint.load_universal` set, the engine's `load_checkpoint`
reads a folder of this package's atoms.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.runtime.checkpointing import (
    LATEST_UNIVERSAL_FILE,
    CheckpointReader,
    read_latest,
)
from deepspeed_tpu_torch.utils.logging import logger


def _save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(obj, path)


def ds_to_universal(ckpt_dir: str, output_folder: str, tag: Optional[str] = None) -> str:
    """Convert the checkpoint `ckpt_dir/tag` (by default the `latest`
    tag) into universal atoms under `output_folder`: f32 weights (the
    master, or the parameters where the run kept none), both moments and
    the optimizer's step. Returns `output_folder`."""
    tag = tag or read_latest(ckpt_dir) or "global_step0"
    src = os.path.join(os.path.abspath(ckpt_dir), tag)
    if not os.path.isdir(src):
        raise FileNotFoundError(f"checkpoint {src} not found")
    reader = CheckpointReader(src)
    fp32 = "master" if reader.has_master else "params"
    zero_dir = os.path.join(os.path.abspath(output_folder), "zero")
    step = int(reader.count)
    for name in reader.names:
        base = os.path.join(zero_dir, name)
        _save(reader.leaf(fp32, name).to(torch.float32, copy=True), os.path.join(base, "fp32.pt"))
        for state in ("exp_avg", "exp_avg_sq"):
            _save(reader.leaf(state, name).to(torch.float32, copy=True),
                  os.path.join(base, f"{state}.pt"))
        _save(step, os.path.join(base, "step.pt"))
    _save({"param_groups": [{"params": sorted(reader.names)}], "step": step,
           "ds_meta": reader.meta}, os.path.join(zero_dir, "optimizer_state.pt"))
    with open(os.path.join(output_folder, LATEST_UNIVERSAL_FILE), "w") as f:
        f.write(tag)
    logger.info(f"ds_to_universal: wrote {len(reader.names)} parameter atoms to {zero_dir}")
    return output_folder


def load_universal(folder: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A universal folder's atoms: {state: {param_name: tensor}} for fp32,
    exp_avg and exp_avg_sq (mapped from their files, on the CPU)."""
    zero_dir = os.path.join(folder, "zero")
    if not os.path.isdir(zero_dir):
        raise FileNotFoundError(f"{zero_dir} is not a universal checkpoint")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for root, _dirs, files in os.walk(zero_dir):
        if root == zero_dir:
            continue
        name = os.path.relpath(root, zero_dir).replace(os.sep, ".")
        for fname in files:
            state = fname[:-3]
            if not fname.endswith(".pt") or state == "step":
                continue
            t = torch.load(os.path.join(root, fname), map_location="cpu", weights_only=True,
                           mmap=True)
            if isinstance(t, torch.Tensor):
                out.setdefault(state, {})[name] = t
    return out


def restore_tree_from_universal(folder: str, like_tree: Any, state: str = "fp32") -> Any:
    """A tree shaped like `like_tree` (nested mappings whose leaves have a
    `.shape`) from a universal folder's `state` atoms, each leaf the atom
    of its dotted path; a `layers.…` leaf with no atom of its own is
    stacked on its leading axis from the atoms `layers.{i}.…`."""
    atoms = load_universal(folder).get(state)
    if atoms is None:
        raise KeyError(f"universal checkpoint has no '{state}' atoms")

    def build(path, node):
        if isinstance(node, Mapping):
            return {k: build(path + (str(k),), v) for k, v in node.items()}
        name, shape = ".".join(path), tuple(node.shape)
        if name in atoms:
            return atoms[name].reshape(shape)
        if path[0] == "layers":
            rest = ".".join(path[1:])
            return torch.stack([atoms[f"layers.{i}.{rest}"] for i in range(shape[0])]
                               ).reshape(shape)
        raise KeyError(f"universal checkpoint missing atom for {name}")

    return build((), like_tree)
