"""Process topology (counterpart of ``deepspeed_tpu/utils/groups.py``).

The JAX package lays one device mesh over every parallel domain, with
axes in the canonical order `MESH_AXES` (`model`, tensor parallelism,
innermost), and lets the partitioner insert the collectives. Here one
process drives one rank, and rank r sits where the JAX mesh puts device r:
its coordinates are r written in mixed radix over `MESH_AXES` (`pipe`
outermost). The ported axes are `data` (data parallelism, `dp`, the axis
ZeRO shards over), `repl` (the MiCS/hpZ replicas: ZeRO state shards over
`data` inside a group of `mics_shard_size` ranks and repeats across
`repl`, so only the gradient mean crosses groups), `model` (tensor
parallelism, `tp`) and `expert` (expert parallelism, `ep`). `repl` x
`data` may both exceed 1; otherwise one axis at most may, and `repl`
with `model` or `expert`, or any other axis > 1 (sequence, pipeline
parallelism), raises (ROADMAP.md, Queue 1, 'Multi-GPU'). `MeshTopology`
holds the axes' sizes, this rank's place and the rank's device;
`initialize` installs it and, where an axis spans fewer ranks than the
world, has `comm` build that axis's process groups.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.utils.logging import logger

MESH_AXES: Tuple[str, ...] = ("pipe", "repl", "data", "expert", "sequence", "model")
_ALIASES = {"tp": "model", "ep": "expert", "pp": "pipe", "dp": "data", "sp": "sequence"}
_OTHER_AXES = {"pp": "pipe", "sp": "sequence"}
# the axes a global batch's rows are split over (the JAX `batch_spec`'s
# ("repl", "data", "expert") without the axis training does not port)
BATCH_AXES: Tuple[str, ...] = ("repl", "data")


class MeshTopology:
    """`dp` ranks on the `data` axis, `repl` replicas of them (or
    `mics_shard_size`, which splits the data-parallel ranks into groups of
    that size as the JAX `MeshTopology` does), `tp` on `model` or `ep`
    (alias `expert`) on `expert`, this rank's place and its device.
    `world_size` and `rank` default to the process group's (1 and 0 in one
    process); `dp=-1` takes what the world leaves after the other axes, as
    in the JAX package, and repl x dp x tp x ep must be the world. Only
    `repl` x `data` may both exceed 1; the other axes (`pp`, `sp`) may only
    be 1. `device` is the rank's device, when the topology serves one: a
    per-shard kernel call under a CUDA topology refuses CPU tensors."""

    def __init__(self, tp: int = 1, world_size: Optional[int] = None,
                 rank: Optional[int] = None, device=None, ep: Optional[int] = None,
                 dp: int = -1, repl: int = 1, mics_shard_size: int = 0, **other_axes: int):
        from deepspeed_tpu_torch import comm
        if "expert" in other_axes:
            if ep is not None:
                raise TypeError("MeshTopology: give ep or its alias expert, not both")
            ep = other_axes.pop("expert")
        tp, ep, dp, repl = int(tp), int(1 if ep is None else ep), int(dp), int(repl)
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
        if size < 1 or repl < 1 or n % (size * repl):
            raise ValueError(f"world size {n} not divisible by repl*{axis}={repl * size}")
        if dp == -1:
            dp = n // (size * repl)
        if mics_shard_size and mics_shard_size > 0:
            full = dp * repl
            if full % mics_shard_size:
                raise ValueError(f"data-parallel size {full} not divisible by "
                                 f"mics_shard_size={mics_shard_size}")
            dp, repl = int(mics_shard_size), full // int(mics_shard_size)
        if dp < 1 or repl * dp * size != n:
            raise ValueError(f"mesh size repl*dp*{axis}={repl * dp * size} != world size {n}")
        if (dp > 1 or repl > 1) and size > 1:
            raise unported(f"data parallelism with {axis} parallelism (repl={repl} x "
                           f"dp={dp} x {axis}={size})", "Multi-GPU")
        self.tp_size, self.ep_size, self.dp_size, self.repl_size = tp, ep, dp, repl
        self.rank = comm.get_rank() if rank is None else int(rank)
        if not 0 <= self.rank < n:
            raise ValueError(f"rank {self.rank} outside a world of {n}")
        self.device = None if device is None else torch.device(device)

    @property
    def world_size(self) -> int:
        return self.repl_size * self.tp_size * self.ep_size * self.dp_size

    @property
    def dense_dp_size(self) -> int:
        """The whole data-parallel degree for dense parameters (repl x
        data x expert), as in the JAX package."""
        return self.repl_size * self.dp_size * self.ep_size

    @property
    def sizes(self) -> Dict[str, int]:
        """{axis: size} over `MESH_AXES`."""
        return {a: self.axis_size(a) for a in MESH_AXES}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis of `MESH_AXES`."""
        return {a: self.coord(a) for a in MESH_AXES}

    def axis_size(self, axis) -> int:
        """The size of an axis, or the product over a tuple of axes."""
        if isinstance(axis, (tuple, list)):
            return math.prod(self.axis_size(a) for a in axis)
        return {"model": self.tp_size, "expert": self.ep_size, "data": self.dp_size,
                "repl": self.repl_size}.get(_canonical(axis), 1)

    def coord(self, axis) -> int:
        """This rank's index along `axis`, or its flat index over a tuple of
        axes (row-major in `MESH_AXES` order)."""
        return self.coord_of(self.rank, axis)

    def coord_of(self, rank: int, axis) -> int:
        """Rank `rank`'s index along `axis` (or a tuple of axes)."""
        if isinstance(axis, (tuple, list)):
            out = 0
            for a in sorted({_canonical(a) for a in axis}, key=MESH_AXES.index):
                out = out * self.axis_size(a) + self.coord_of(rank, a)
            return out
        axis = _canonical(axis)
        inner = math.prod(self.axis_size(a) for a in MESH_AXES[MESH_AXES.index(axis) + 1:])
        return (rank // inner) % self.axis_size(axis)

    def axis_groups(self, axis: str):
        """The ranks of each group along `axis`: every rank's peers that
        share its other coordinates, in axis order, one list a group."""
        out = {}
        for r in range(self.world_size):
            key = tuple(self.coord_of(r, a) for a in MESH_AXES if a != _canonical(axis))
            out.setdefault(key, []).append(r)
        return list(out.values())

    def zero_axes(self, expert_param: bool = False) -> Tuple[str, ...]:
        """The axes ZeRO shards a leaf over: `data` for a per-expert
        leaf, (`data`, `expert`) for a dense one, as in the JAX package
        (never `repl`: the state repeats across it)."""
        return ("data",) if expert_param else ("data", "expert")

    def __repr__(self):
        repl = f"repl={self.repl_size}, " if self.repl_size > 1 else ""
        return (f"MeshTopology({repl}data={self.dp_size}, expert={self.ep_size}, "
                f"model={self.tp_size}, rank {self.rank}, device {self.device})")


def _canonical(axis: str) -> str:
    axis = _ALIASES.get(axis, axis)
    if axis not in MESH_AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; expected one of {MESH_AXES}")
    return axis


_TOPOLOGY: Optional[MeshTopology] = None


def initialize(topology: Optional[MeshTopology] = None, **kwargs) -> MeshTopology:
    """Install the topology (`MeshTopology(**kwargs)` when none is given)
    and, with a process group up, the process groups of its axes
    (`comm.build_axis_groups`: every rank calls this, in one order)."""
    global _TOPOLOGY
    _TOPOLOGY = topology if topology is not None else MeshTopology(**kwargs)
    from deepspeed_tpu_torch import comm
    comm.build_axis_groups(_TOPOLOGY)
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

