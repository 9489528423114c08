"""Collectives over `torch.distributed` (counterpart of ``deepspeed_tpu/comm/comm.py``).

A group is named by its mesh axis (`"model"` or `"tp"`, `"expert"` or
`"ep"`, `"data"` or `"dp"`, `"repl"`), or by a tuple of axes, as in the
JAX package; its size and this rank's index on it come from the installed
topology (`utils/groups.py`). A group that spans every rank runs on the
default process group; an axis that spans fewer (`data` and `repl` under
MiCS, where both exceed 1) runs on a process group of its own, which
`build_axis_groups` makes when the topology is installed: every rank
calls `dist.new_group` for every group of every such axis, in one order,
and keeps its own. A trivial axis's collectives are the identity, and
None means every rank. Where the JAX package's collectives are traced
inside a `shard_map` region, these run eagerly, one call per collective,
on the rank's own tensors. In one process (no process group) every
collective is the identity.

The ops: `all_reduce` (`ReduceOp` SUM, AVG, MAX, MIN), `all_gather`
(concatenated along an axis), `all_gather_into` (a shard into one
preallocated tensor), `reduce_scatter` (tiled), `all_to_all_single`
(tiled), `broadcast`, `barrier`. Each calls the backend's own op on the
rank's tensor, CUDA or not: NCCL runs it on the card; gloo takes CUDA
tensors for every one of these ops, all-to-all included, and stages them
through the host itself (torch 2.11 on an H100; the `cuda` tests hold each
against the CPU), so there is one route per op and backend and no copy
here.

`init_distributed` brings the process group up from its arguments or from
the variables `torchrun` sets (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`/`MASTER_PORT`). The backend is `nccl` unless the caller asks
for `gloo`. NCCL rejects two ranks on one card, so `nccl` with more ranks on
a host than it has cards raises. `gloo` stages CUDA tensors through the
host: it lets two ranks share one card, at a collective cost no multi-card
deployment pays.

`comm_stats()` counts, by kind, the calls that moved data, their bytes
(the rank's input) and the host seconds spent inside them: on gloo the
whole collective, on NCCL only its launch. The quantized and compressed
collectives (`runtime/comm/`) count under their own kinds,
`quantized_reduce_scatter`, `quantized_all_gather` and
`compressed_allreduce` (`wire`): one call each, the bytes of the tensors
their collectives were handed (the int8 values and the f32 scales, as the
JAX package records them) and those collectives' seconds; the collectives
inside count nothing under their own kinds.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import logger

_LOCAL_RANK: Optional[int] = None  # set by init_distributed when no LOCAL_RANK is set
_STATS = defaultdict(lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})
_GROUP_STATS = defaultdict(lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})
_AXIS_GROUPS = {}       # axis -> this rank's process group along it
_WIRE: Optional[list] = None   # inside `wire`: [bytes, calls] its collectives were handed


class ReduceOp:
    """The reductions of `all_reduce`, by the JAX package's names."""
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"


_DIST_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "AVG", ReduceOp.MAX: "MAX",
             ReduceOp.MIN: "MIN"}

def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(dist_backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: int = -1, world_size: int = -1,
                     timeout: Optional[timedelta] = None,
                     verbose: bool = True) -> None:
    """Bring up the default process group. `rank`/`world_size` default to
    `RANK`/`WORLD_SIZE`, `init_method` to `env://` when `MASTER_ADDR` is
    set. One process, or a group already up, is a no-op. `dist_backend`
    None means `nccl`, which needs a card per rank on this host (raises
    otherwise, naming `dist_backend="gloo"`)."""
    global _LOCAL_RANK
    if is_initialized():
        return
    world_size = world_size if world_size > 0 else int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank >= 0 else int(os.environ.get("RANK", "0"))
    if world_size <= 1:
        return
    backend = dist_backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend must be 'nccl' or 'gloo', got {backend!r}")
    _LOCAL_RANK = rank
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"{local_world} ranks on this host share {cards} CUDA device(s): "
                "NCCL rejects two ranks on one device; pass dist_backend='gloo' "
                "to run them over the host")
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError("init_distributed: no rendezvous; pass init_method "
                             "('tcp://host:port' or 'file:///path') or set "
                             "MASTER_ADDR and MASTER_PORT")
        init_method = "env://"
    kwargs = {"timeout": timeout} if timeout is not None else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    if backend == "nccl":
        from deepspeed_tpu_torch.accelerator.cuda_accelerator import local_device_index
        torch.cuda.set_device(local_device_index())
    if verbose:
        logger.info(f"init_distributed: rank {rank} of {world_size} over {backend}")


def get_backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def build_axis_groups(topology) -> None:
    """The process groups of the topology's axes that span more than one
    rank and fewer than all: every rank calls `dist.new_group` for every
    group of each such axis, in `MESH_AXES` order, and keeps its own. A
    no-op without a process group."""
    from deepspeed_tpu_torch.utils.groups import MESH_AXES
    _AXIS_GROUPS.clear()
    if not is_initialized():
        return
    world = dist.get_world_size()
    for axis in MESH_AXES:
        if not 1 < topology.axis_size(axis) < world:
            continue
        for ranks in topology.axis_groups(axis):
            pg = dist.new_group(ranks)
            if topology.rank in ranks:
                _AXIS_GROUPS[axis] = pg


def _axes(group):
    return tuple(group) if isinstance(group, (tuple, list)) else (group,)


def _pg(group):
    """The process group of `group` (None: the default one)."""
    if group is None:
        return None
    from deepspeed_tpu_torch.utils import groups
    topo = groups.get_topology()
    axes = [a for a in _axes(group) if topo.axis_size(a) > 1]
    if math.prod(topo.axis_size(a) for a in axes) == dist.get_world_size():
        return None
    if len(axes) != 1:
        raise ValueError(f"no process group spans the axes {group!r} of {topo!r}")
    from deepspeed_tpu_torch.utils.groups import _canonical
    axis = _canonical(axes[0])
    if axis not in _AXIS_GROUPS:
        raise RuntimeError(f"no process group for axis {axis!r}: install the topology "
                           "with groups.initialize after init_distributed")
    return _AXIS_GROUPS[axis]


def get_rank(group: Optional[str] = None) -> int:
    """This rank's index in the world, or its coordinate along an axis."""
    if not is_initialized():
        return 0
    if group is not None:
        from deepspeed_tpu_torch.utils import groups
        return groups.get_topology().coord(group)
    return dist.get_rank()


def get_world_size(group: Optional[str] = None) -> int:
    """Ranks in the world, or the size of an axis."""
    if group is not None:
        from deepspeed_tpu_torch.utils import groups
        return groups.get_topology().axis_size(group)
    return dist.get_world_size() if is_initialized() else 1


def get_local_rank() -> int:
    """The rank's index on its host: `LOCAL_RANK`, else the rank
    `init_distributed` was given (one host), else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return _LOCAL_RANK if _LOCAL_RANK is not None else 0


def _trivial(group) -> bool:
    return not is_initialized() or get_world_size(group) == 1


def _group_name(group) -> str:
    """The stats' name of a group: its nontrivial axes joined by "+", or
    "world"."""
    if group is None:
        return "world"
    from deepspeed_tpu_torch.utils import groups
    topo = groups.get_topology()
    axes = [groups._canonical(a) for a in _axes(group) if topo.axis_size(a) > 1]
    return "+".join(a for a in groups.MESH_AXES if a in axes) or "world"


def _record(kind: str, nbytes: int, seconds: float, group) -> None:
    for entry in (_STATS[kind], _GROUP_STATS[(kind, _group_name(group))]):
        entry["calls"] += 1
        entry["bytes"] += int(nbytes)
        entry["seconds"] += seconds


def _timed(kind: str, tensor: torch.Tensor, fn, group=None):
    t0 = time.perf_counter()
    out = fn()
    nbytes = tensor.numel() * tensor.element_size()
    if _WIRE is None:
        _record(kind, nbytes, time.perf_counter() - t0, group)
    else:
        _WIRE[0] += nbytes
        _WIRE[1] += 1
    return out


@contextlib.contextmanager
def wire(kind: str, group=None):
    """Count the collectives inside as one call of `kind` over `group`:
    the bytes of the tensors they were handed and their seconds (nothing
    where none moved data); they count nothing under their own kinds."""
    global _WIRE
    outer, _WIRE = _WIRE, [0, 0]
    t0 = time.perf_counter()
    try:
        yield
    finally:
        (nbytes, calls), _WIRE = _WIRE, outer
        if outer is not None:
            outer[0] += nbytes
            outer[1] += calls
        elif calls:
            _record(kind, nbytes, time.perf_counter() - t0, group)


def comm_stats(by_group: bool = False) -> dict:
    """{kind: {"calls", "bytes", "seconds"}} since the last reset; with
    `by_group`, {kind: {group: {...}}}, a group named by its nontrivial
    axes ("data", "repl", "repl+data") or "world"."""
    if not by_group:
        return {k: dict(v) for k, v in _STATS.items()}
    out = {}
    for (kind, group), v in _GROUP_STATS.items():
        out.setdefault(kind, {})[group] = dict(v)
    return out


def reset_comm_stats() -> None:
    _STATS.clear()
    _GROUP_STATS.clear()


def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM,
               group: Optional[str] = "data") -> torch.Tensor:
    """Reduce `tensor` over the group with `op` (`ReduceOp`), in place;
    returns it."""
    if op not in _DIST_OPS:
        raise ValueError(f"unsupported reduce op {op!r}; expected one of {sorted(_DIST_OPS)}")
    if not _trivial(group):
        _timed("all_reduce", tensor,
               lambda: dist.all_reduce(tensor, op=getattr(dist.ReduceOp, _DIST_OPS[op]),
                                       group=_pg(group)), group)
    return tensor


def all_gather(tensor: torch.Tensor, group: Optional[str] = "data",
               axis: int = 0) -> torch.Tensor:
    """Every rank's `tensor` in rank order, concatenated along `axis`."""
    if _trivial(group):
        return tensor
    parts = [torch.empty_like(tensor) for _ in range(get_world_size(group))]
    _timed("all_gather", tensor,
           lambda: dist.all_gather(parts, tensor.contiguous(), group=_pg(group)), group)
    return torch.cat(parts, dim=axis)


def all_gather_into(out: torch.Tensor, shard: torch.Tensor,
                    group: Optional[str] = "data") -> torch.Tensor:
    """Every rank's `shard` in rank order, written along dim 0 of the
    preallocated `out` (n times the shard's rows); returns `out`."""
    if _trivial(group):
        return out.copy_(shard.reshape(out.shape))
    shard = shard.contiguous()
    # the backends take the output as the shards stacked along dim 0
    dst = out.view((-1,) + tuple(shard.shape[1:])) if shard.dim() else out.view(-1)
    _timed("all_gather", shard,
           lambda: dist.all_gather_into_tensor(dst, shard, group=_pg(group)), group)
    return out


def reduce_scatter(tensor: torch.Tensor, group: Optional[str] = "data",
                   scatter_dim: int = 0) -> torch.Tensor:
    """The sum over the group of `tensor`, cut into n tiles along
    `scatter_dim`: rank r gets tile r (`lax.psum_scatter(tiled=True)`)."""
    if _trivial(group):
        return tensor
    n = get_world_size(group)
    if tensor.shape[scatter_dim] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_dim} of {tuple(tensor.shape)} is "
                         f"not divisible by the group's {n} ranks")
    moved = tensor.movedim(scatter_dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    _timed("reduce_scatter", tensor,
           lambda: dist.reduce_scatter_tensor(out, moved, group=_pg(group)), group)
    return out.movedim(0, scatter_dim)


def all_to_all_single(tensor: torch.Tensor, group: Optional[str] = "data") -> torch.Tensor:
    """Dim 0 of `tensor` cut into n tiles: tile j goes to the group's rank
    j, and tile i of the result came from its rank i
    (`lax.all_to_all(split_axis=0, concat_axis=0)`)."""
    if _trivial(group):
        return tensor
    n = get_world_size(group)
    if tensor.shape[0] % n:
        raise ValueError(f"all_to_all_single: dim 0 of {tuple(tensor.shape)} is not "
                         f"divisible by the group's {n} ranks")
    src = tensor.contiguous()
    out = torch.empty_like(src)
    _timed("all_to_all", src,
           lambda: dist.all_to_all_single(out, src, group=_pg(group)), group)
    return out


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Optional[str] = None) -> torch.Tensor:
    """`tensor` from global rank `src` to every rank of the group, in place."""
    if not _trivial(group):
        _timed("broadcast", tensor,
               lambda: dist.broadcast(tensor, src=src, group=_pg(group)), group)
    return tensor


def barrier(group: Optional[str] = None) -> None:
    if not _trivial(group):
        dist.barrier(group=_pg(group))


def destroy_process_group() -> None:
    """Tear the default process group down (the end of a rank's run)."""
    global _LOCAL_RANK
    if is_initialized():
        dist.destroy_process_group()
    _LOCAL_RANK = None
    _AXIS_GROUPS.clear()
