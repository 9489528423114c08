"""Collectives over `torch.distributed` (counterpart of ``deepspeed_tpu/comm/comm.py``).

A group is named by its mesh axis (`"model"` or `"tp"`, `"expert"` or
`"ep"`, `"data"` or `"dp"`), as in the JAX package; its size and this
rank's index on it come from the installed topology (`utils/groups.py`),
whose only nontrivial axis spans every rank, so its process group is the
default one and a trivial axis's collectives are the identity. None means
every rank. Where the JAX package's collectives are traced inside a
`shard_map` region, these run eagerly, one call per collective, on the
rank's own tensors. In one process (no process group) every collective is
the identity.

The ops: `all_reduce` (`ReduceOp` SUM, AVG, MAX, MIN), `all_gather`
(concatenated along an axis), `all_gather_into` (a shard into one
preallocated tensor), `reduce_scatter` (tiled), `broadcast`, `barrier`.
Each calls the backend's own op on the rank's tensor, CUDA or not: NCCL
runs it on the card; gloo takes CUDA tensors for every one of these ops
and stages them through the host itself (torch 2.11 on an H100; the
`cuda` tests hold each against the CPU), so there is one route per op and
backend and no copy here.

`init_distributed` brings the process group up from its arguments or from
the variables `torchrun` sets (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`/`MASTER_PORT`). The backend is `nccl` unless the caller asks
for `gloo`. NCCL rejects two ranks on one card, so `nccl` with more ranks on
a host than it has cards raises. `gloo` stages CUDA tensors through the
host: it lets two ranks share one card, at a collective cost no multi-card
deployment pays.

`comm_stats()` counts, by kind, the calls that moved data, their bytes
(the rank's input) and the host seconds spent inside them: on gloo the
whole collective, on NCCL only its launch.
"""

from __future__ import annotations

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


def _timed(kind: str, tensor: torch.Tensor, fn):
    t0 = time.perf_counter()
    out = fn()
    entry = _STATS[kind]
    entry["calls"] += 1
    entry["bytes"] += tensor.numel() * tensor.element_size()
    entry["seconds"] += time.perf_counter() - t0
    return out


def comm_stats() -> dict:
    """{kind: {"calls", "bytes", "seconds"}} since the last reset."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_comm_stats() -> None:
    _STATS.clear()


def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM,
               group: Optional[str] = "data") -> torch.Tensor:
    """Reduce `tensor` over the group with `op` (`ReduceOp`), in place;
    returns it."""
    if op not in _DIST_OPS:
        raise ValueError(f"unsupported reduce op {op!r}; expected one of {sorted(_DIST_OPS)}")
    if not _trivial(group):
        _timed("all_reduce", tensor,
               lambda: dist.all_reduce(tensor, op=getattr(dist.ReduceOp, _DIST_OPS[op])))
    return tensor


def all_gather(tensor: torch.Tensor, group: Optional[str] = "data",
               axis: int = 0) -> torch.Tensor:
    """Every rank's `tensor` in rank order, concatenated along `axis`."""
    if _trivial(group):
        return tensor
    parts = [torch.empty_like(tensor) for _ in range(get_world_size(group))]
    _timed("all_gather", tensor, lambda: dist.all_gather(parts, tensor.contiguous()))
    return torch.cat(parts, dim=axis)


def all_gather_into(out: torch.Tensor, shard: torch.Tensor,
                    group: Optional[str] = "data") -> torch.Tensor:
    """Every rank's `shard` in rank order, written along dim 0 of the
    preallocated `out` (n times the shard's rows); returns `out`."""
    if _trivial(group):
        return out.copy_(shard.reshape(out.shape))
    _timed("all_gather", shard,
           lambda: dist.all_gather_into_tensor(out, shard.contiguous()))
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
    _timed("reduce_scatter", tensor, lambda: dist.reduce_scatter_tensor(out, moved))
    return out.movedim(0, scatter_dim)


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Optional[str] = None) -> torch.Tensor:
    """`tensor` from global rank `src` to every rank of the group, in place."""
    if not _trivial(group):
        _timed("broadcast", tensor, lambda: dist.broadcast(tensor, src=src))
    return tensor


def barrier(group: Optional[str] = None) -> None:
    if not _trivial(group):
        dist.barrier()


def destroy_process_group() -> None:
    """Tear the default process group down (the end of a rank's run)."""
    global _LOCAL_RANK
    if is_initialized():
        dist.destroy_process_group()
    _LOCAL_RANK = None
