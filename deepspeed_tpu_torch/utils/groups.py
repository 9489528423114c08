"""Process topology (counterpart of ``deepspeed_tpu/utils/groups.py``).

The JAX package lays one device mesh over every parallel domain, with
axes in the canonical order `MESH_AXES` (`model`, tensor parallelism,
innermost), and lets the partitioner insert the collectives. Here one
process drives one rank, and one axis at most may be nontrivial: `data`
(data parallelism, `dp`, the axis ZeRO shards over), `model` (tensor
parallelism, `tp`) or `expert` (expert parallelism, `ep`).
`MeshTopology` holds the axes' sizes, this rank's place on the nontrivial
one and the rank's device. Every rank of the world is on that axis, so its
process group is the default one. Two of `dp`, `tp` and `ep` above 1, or
any other axis > 1 (sequence, pipeline parallelism, MiCS replicas), raises
(ROADMAP.md, Queue 1, 'Multi-GPU').
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.utils.logging import logger

MESH_AXES: Tuple[str, ...] = ("pipe", "repl", "data", "expert", "sequence", "model")
_ALIASES = {"tp": "model", "ep": "expert", "pp": "pipe", "dp": "data", "sp": "sequence"}
_OTHER_AXES = {"pp": "pipe", "repl": "repl", "sp": "sequence"}


class MeshTopology:
    """`dp` ranks on the `data` axis, `tp` on `model` or `ep` (alias
    `expert`) on `expert`, this rank's index on the nontrivial one and its
    device. `world_size` and `rank` default to the process group's (1 and
    0 in one process); `dp=-1` takes what the world leaves after tp and
    ep, as in the JAX package, and dp x tp x ep must be the world. At most
    one of the three may exceed 1; the other axes (`pp`, `repl`, `sp`) may
    only be 1. `device` is the rank's device, when the topology serves
    one: a per-shard kernel call under a CUDA topology refuses CPU
    tensors."""

    def __init__(self, tp: int = 1, world_size: Optional[int] = None,
                 rank: Optional[int] = None, device=None, ep: Optional[int] = None,
                 dp: int = -1, **other_axes: int):
        from deepspeed_tpu_torch import comm
        if "expert" in other_axes:
            if ep is not None:
                raise TypeError("MeshTopology: give ep or its alias expert, not both")
            ep = other_axes.pop("expert")
        tp, ep, dp = int(tp), int(1 if ep is None else ep), int(dp)
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
        if dp == -1:
            dp = n // size
        if dp < 1 or dp * size != n:
            raise ValueError(f"mesh size dp*{axis}={dp * size} != world size {n}")
        if dp > 1 and size > 1:
            raise unported(f"data parallelism with {axis} parallelism (dp={dp} x "
                           f"{axis}={size})", "Multi-GPU")
        self.tp_size, self.ep_size, self.dp_size = tp, ep, dp
        self.rank = comm.get_rank() if rank is None else int(rank)
        if not 0 <= self.rank < n:
            raise ValueError(f"rank {self.rank} outside a world of {n}")
        self.device = None if device is None else torch.device(device)

    @property
    def world_size(self) -> int:
        return self.tp_size * self.ep_size * self.dp_size

    @property
    def sizes(self) -> Dict[str, int]:
        """{axis: size} over `MESH_AXES`."""
        return {a: self.axis_size(a) for a in MESH_AXES}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis of `MESH_AXES`."""
        return {a: self.coord(a) for a in MESH_AXES}

    def axis_size(self, axis: str) -> int:
        return {"model": self.tp_size, "expert": self.ep_size,
                "data": self.dp_size}.get(_canonical(axis), 1)

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.rank if self.axis_size(axis) > 1 else 0

    def zero_axes(self, expert_param: bool = False) -> Tuple[str, ...]:
        """The axes ZeRO shards a leaf over: `data` for a per-expert
        leaf, (`data`, `expert`) for a dense one, as in the JAX package."""
        return ("data",) if expert_param else ("data", "expert")

    def __repr__(self):
        return (f"MeshTopology(data={self.dp_size}, expert={self.ep_size}, "
                f"model={self.tp_size}, rank {self.rank}, device {self.device})")


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

