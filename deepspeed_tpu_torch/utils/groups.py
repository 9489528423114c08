"""Process topology (counterpart of ``deepspeed_tpu/utils/groups.py``).

The JAX package lays one device mesh over every parallel domain, with
axes in the canonical order `MESH_AXES` (`model`, tensor parallelism,
innermost), and lets the partitioner insert the collectives. Here one
process drives one rank, and only the `model` axis may be nontrivial:
`MeshTopology` holds its size (`tp`), this rank's place on it and the
rank's device. Every rank of the world is on that axis, so its process
group is the default one. Any other axis > 1 (data, expert, sequence,
pipeline parallelism, MiCS replicas) raises (ROADMAP.md, Queue 1,
'Multi-GPU').
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.utils.logging import logger

MESH_AXES: Tuple[str, ...] = ("pipe", "repl", "data", "expert", "sequence", "model")
_MODEL_NAMES = ("model", "tp")
_OTHER_AXES = {"pp": "pipe", "repl": "repl", "dp": "data", "ep": "expert", "sp": "sequence"}


class MeshTopology:
    """`tp` ranks on the `model` axis, this rank's index on it and its
    device. `world_size` and `rank` default to the process group's (1 and 0
    in one process) and the world must be the `model` axis: the other axes
    (`pp`, `repl`, `dp`, `ep`, `sp`; `dp=-1` takes what the world leaves)
    may only be 1. `device` is the rank's device, when the topology serves
    one: a per-shard kernel call under a CUDA topology refuses CPU
    tensors."""

    def __init__(self, tp: int = 1, world_size: Optional[int] = None,
                 rank: Optional[int] = None, device=None, **other_axes: int):
        from deepspeed_tpu_torch import comm
        n = comm.get_world_size() if world_size is None else int(world_size)
        for name, size in other_axes.items():
            if name not in _OTHER_AXES:
                raise TypeError(f"MeshTopology: unknown axis {name!r}")
            if size > 1:
                raise unported(f"mesh axis {_OTHER_AXES[name]!r} of size {size}", "Multi-GPU")
        if n % tp:
            raise ValueError(f"world size {n} not divisible by tp={tp}")
        if n != tp:
            raise unported(f"mesh axis 'data' of size {n // tp}", "Multi-GPU")
        self.tp_size = int(tp)
        self.rank = comm.get_rank() if rank is None else int(rank)
        if not 0 <= self.rank < n:
            raise ValueError(f"rank {self.rank} outside a world of {n}")
        self.device = None if device is None else torch.device(device)

    @property
    def world_size(self) -> int:
        return self.tp_size

    @property
    def sizes(self) -> Dict[str, int]:
        """{axis: size} over `MESH_AXES`."""
        return {a: self.tp_size if a == "model" else 1 for a in MESH_AXES}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis of `MESH_AXES`."""
        return {a: self.rank if a == "model" else 0 for a in MESH_AXES}

    def axis_size(self, axis: str) -> int:
        return self.tp_size if _is_model(axis) else 1

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.rank if _is_model(axis) else 0

    def __repr__(self):
        return f"MeshTopology(model={self.tp_size}, rank {self.rank}, device {self.device})"


def _is_model(axis: str) -> bool:
    if axis in _MODEL_NAMES:
        return True
    if axis in MESH_AXES or axis in _OTHER_AXES:
        return False
    raise ValueError(f"unknown mesh axis {axis!r}; expected one of {MESH_AXES}")


_TOPOLOGY: Optional[MeshTopology] = None


def initialize(topology: Optional[MeshTopology] = None, **kwargs) -> MeshTopology:
    """Install the topology (`MeshTopology(**kwargs)` when none is given)."""
    global _TOPOLOGY
    _TOPOLOGY = topology if topology is not None else MeshTopology(**kwargs)
    logger.debug(f"groups initialized: {_TOPOLOGY!r}")
    return _TOPOLOGY


def get_topology(create_default: bool = True) -> MeshTopology:
    global _TOPOLOGY
    if _TOPOLOGY is None:
        if not create_default:
            raise RuntimeError("topology not initialized")
        _TOPOLOGY = MeshTopology()
    return _TOPOLOGY


def reset_topology() -> None:
    global _TOPOLOGY
    _TOPOLOGY = None


def get_tensor_model_parallel_world_size() -> int:
    return get_topology().tp_size
