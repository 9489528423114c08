"""Process topology (counterpart of ``deepspeed_tpu/utils/groups.py``).

The JAX package lays one device mesh over every parallel domain, with
axes in the canonical order `MESH_AXES` (`model`, tensor parallelism,
innermost), and lets the partitioner insert the collectives. Here one
process drives one rank, and one axis at most may be nontrivial: `model`
(tensor parallelism, `tp`) or `expert` (expert parallelism, `ep`).
`MeshTopology` holds the axes' sizes, this rank's place on the nontrivial
one and the rank's device. Every rank of the world is on that axis, so its
process group is the default one. Both `tp` and `ep` above 1, or any other
axis > 1 (data, sequence, pipeline parallelism, MiCS replicas), raises
(ROADMAP.md, Queue 1, 'Multi-GPU').
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.utils.logging import logger

MESH_AXES: Tuple[str, ...] = ("pipe", "repl", "data", "expert", "sequence", "model")
_ALIASES = {"tp": "model", "ep": "expert", "pp": "pipe", "dp": "data", "sp": "sequence"}
_OTHER_AXES = {"pp": "pipe", "repl": "repl", "dp": "data", "sp": "sequence"}


class MeshTopology:
    """`tp` ranks on the `model` axis or `ep` (alias `expert`) ranks on the
    `expert` axis, this rank's index on it and its device. `world_size`
    and `rank` default to the process group's (1 and 0 in one process) and
    the world must be that one axis: tp and ep may not both exceed 1, and
    the other axes (`pp`, `repl`, `dp`, `sp`; `dp=-1` takes what the world
    leaves) may only be 1. `device` is the rank's device, when the topology
    serves one: a per-shard kernel call under a CUDA topology refuses CPU
    tensors."""

    def __init__(self, tp: int = 1, world_size: Optional[int] = None,
                 rank: Optional[int] = None, device=None, ep: Optional[int] = None,
                 **other_axes: int):
        from deepspeed_tpu_torch import comm
        if "expert" in other_axes:
            if ep is not None:
                raise TypeError("MeshTopology: give ep or its alias expert, not both")
            ep = other_axes.pop("expert")
        tp, ep = int(tp), int(1 if ep is None else ep)
        n = comm.get_world_size() if world_size is None else int(world_size)
        for name, size in other_axes.items():
            if name not in _OTHER_AXES:
                raise TypeError(f"MeshTopology: unknown axis {name!r}")
            if size > 1:
                raise unported(f"mesh axis {_OTHER_AXES[name]!r} of size {size}", "Multi-GPU")
        if tp > 1 and ep > 1:
            raise unported(f"tensor and expert parallelism together (tp={tp} x ep={ep})",
                           "Multi-GPU")
        axis, size = ("expert", ep) if ep > 1 else ("model", tp)
        if size < 1 or n % size:
            raise ValueError(f"world size {n} not divisible by {axis}={size}")
        if n != size:
            raise unported(f"mesh axis 'data' of size {n // size}", "Multi-GPU")
        self.tp_size, self.ep_size = tp, ep
        self.rank = comm.get_rank() if rank is None else int(rank)
        if not 0 <= self.rank < n:
            raise ValueError(f"rank {self.rank} outside a world of {n}")
        self.device = None if device is None else torch.device(device)

    @property
    def world_size(self) -> int:
        return self.tp_size * self.ep_size

    @property
    def sizes(self) -> Dict[str, int]:
        """{axis: size} over `MESH_AXES`."""
        return {a: self.axis_size(a) for a in MESH_AXES}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis of `MESH_AXES`."""
        return {a: self.coord(a) for a in MESH_AXES}

    def axis_size(self, axis: str) -> int:
        axis = _canonical(axis)
        return self.tp_size if axis == "model" else self.ep_size if axis == "expert" else 1

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.rank if self.axis_size(axis) > 1 else 0

    def __repr__(self):
        return (f"MeshTopology(model={self.tp_size}, expert={self.ep_size}, rank {self.rank}, "
                f"device {self.device})")


def _canonical(axis: str) -> str:
    axis = _ALIASES.get(axis, axis)
    if axis not in MESH_AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; expected one of {MESH_AXES}")
    return axis


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


def get_expert_parallel_world_size() -> int:
    return get_topology().ep_size
