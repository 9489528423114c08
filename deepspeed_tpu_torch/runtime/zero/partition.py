"""ZeRO stages 0-3 over the `data` axis (counterpart of
``deepspeed_tpu/runtime/zero/partition.py``).

Which leaves shard follows the JAX package's plan (`ZeroShardingPlan`):
- stage >= 1: the f32 master and the optimizer moments (`master_spec`),
  and the f32 gradient accumulation (`grad_accum_spec`);
- stage 3: the model-dtype parameters too (`param_spec`), except leaves
  of fewer than `param_persistence_threshold` elements;
- a leaf none of whose dimensions dp divides stays whole on every rank,
  with the JAX package's warning (`add_axes_to_spec`).
The decision is taken on the leaf's shape in the JAX parameter tree
(decoder layers stacked on a leading L axis, flax kernels (in, out)), so
both packages shard the same leaves.

The cut is the port's own, an FSDP-style flat slice: each sharded leaf is
flattened and cut into dp pieces of ceil(numel / dp) elements (the last
padded with zeros), rank r holding piece r, so a rank holds 1/dp of every
sharded leaf. The pieces of one unit (a decoder block, or the root: the
parameters outside the blocks) lie side by side in one flat buffer per
rank, so a unit's gradients take one reduce-scatter and its parameters
one all-gather.

Stage 3 runs the model through `gathered(module)`: the unit's parameter
pieces are all-gathered inside an autograd Function whose backward
reduce-scatters the gathered weights' gradient, in f32, back to this
rank's pieces. A model calls it inside each remat block (so the recompute
in backward gathers again, and the checkpoint keeps only the pieces) and
around its own forward for the root's leaves.

A checkpoint keeps the pieces as they lie (`runtime/checkpointing.py`).
Since a piece depends only on the leaf's size, dp and the rank, a leaf is
whole again from any dp's pieces (`whole_leaf`), and each rank of another
dp cuts its own (`flat_piece`); `layout_record` is what a checkpoint's
`ds_meta.json` keeps of the layout.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils.logging import logger

Tree = Dict[str, torch.Tensor]
_WARNED = set()


def jax_leaf_shape(module: nn.Module, name: str) -> Tuple[int, ...]:
    """The shape of parameter `name` as a leaf of the JAX tree: an
    `nn.Linear` weight (out, in) as the flax kernel (in, out), a leaf of
    decoder layer `layers.i` stacked on a leading L axis."""
    *owner_path, attr = name.split(".")
    owner = module.get_submodule(".".join(owner_path))
    shape = tuple(getattr(owner, attr).shape)
    if isinstance(owner, nn.Linear) and attr == "weight":
        shape = shape[::-1]
    if owner_path[:1] == ["layers"]:
        shape = (len(module.layers),) + shape
    return shape


class ZeroShardingPlan:
    """Which leaves shard over `dp` data ranks for a ZeRO config, as the
    JAX `ZeroShardingPlan.tree_specs` decides with no tensor-parallel
    base spec."""

    def __init__(self, dp: int, config: DeepSpeedZeroConfig):
        self.dp, self.stage = int(dp), int(config.stage)
        self.threshold = int(config.param_persistence_threshold)

    def shards(self, shape: Sequence[int], kind: str) -> bool:
        """Whether a leaf of JAX shape `shape` shards for `kind`: "param"
        (the model-dtype parameters), "master" (the master and the
        optimizer moments) or "grad" (the gradient accumulation)."""
        if kind not in ("param", "master", "grad"):
            raise ValueError(f"unknown kind {kind!r}")
        size = math.prod(shape)
        if self.dp == 1 or self.stage < (3 if kind == "param" else 1):
            return False
        if kind == "param" and size < self.threshold:
            return False
        if any(d % self.dp == 0 for d in shape):
            return True
        if size * self.dp > 1 << 20 and tuple(shape) not in _WARNED:
            _WARNED.add(tuple(shape))
            logger.warning(f"ZeRO: no dimension of shape {tuple(shape)} divisible by "
                           f"{self.dp} over axes ('data',); leaf stays replicated")
        return False


def flat_piece(whole: torch.Tensor, dp: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s piece of a whole leaf over `dp` data ranks: elements
    [rank * p, (rank + 1) * p) of the flattened leaf, p = ceil(numel /
    dp), zero-padded past its end."""
    flat = whole.reshape(-1)
    p = -(-flat.numel() // dp)
    lo, hi = min(rank * p, flat.numel()), min((rank + 1) * p, flat.numel())
    if hi - lo == p:
        return flat[lo:hi]
    return torch.cat([flat[lo:hi], flat.new_zeros(p - (hi - lo))])


def whole_leaf(pieces: Sequence[torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """A leaf of `shape` from every rank's piece, in rank order."""
    numel = math.prod(shape)
    return torch.cat([p.reshape(-1) for p in pieces])[:numel].view(tuple(shape))


class ZeroUnit:
    """Leaves laid out flat on each rank: leaf i's piece r (ceil(numel_i
    / dp) elements, zero-padded) at `offsets[i]` of rank r's `size`
    elements. `shard` is the rank's flat parameter pieces at stage 3;
    `master` its f32 pieces the optimizer updates (in f32 training, of a
    unit whose parameters stay whole, a copy made for each step);
    `grad_acc` its f32 gradient accumulation; `pending` one micro's
    reduced gradient where the engine checks it before accumulating."""

    def __init__(self, names: List[str], shapes: List[torch.Size], dp: int, rank: int,
                 local_names: Optional[List[str]] = None):
        self.names, self.shapes = list(names), [torch.Size(s) for s in shapes]
        self.local_names = list(local_names or names)
        self.dp, self.rank = dp, rank
        self.numels = [s.numel() for s in self.shapes]
        self.pieces = [-(-n // dp) for n in self.numels]
        self.offsets = [sum(self.pieces[:i]) for i in range(len(self.pieces))]
        self.size = sum(self.pieces)
        self.shard: Optional[nn.Parameter] = None
        self.master: Optional[torch.Tensor] = None
        self.grad_acc: Optional[torch.Tensor] = None
        self.pending: Optional[torch.Tensor] = None
        self.stash = False

    def views(self, flat: torch.Tensor) -> Tree:
        """Each leaf's piece, a view of the rank's flat buffer."""
        return {n: flat[o:o + p] for n, o, p in zip(self.names, self.offsets, self.pieces)}

    def piece_of(self, tensors: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
        """This rank's flat pieces of whole leaves."""
        first = tensors[0]
        out = torch.empty(self.size, dtype=dtype or first.dtype, device=first.device)
        for t, o, p in zip(tensors, self.offsets, self.pieces):
            out[o:o + p] = flat_piece(t, self.dp, self.rank)
        return out

    def pack(self, tensors: Sequence[Optional[torch.Tensor]], dtype: torch.dtype,
             device) -> torch.Tensor:
        """Whole leaves (None: zeros) as the (dp * size,) buffer whose tile
        r holds every leaf's piece r: the input of a reduce-scatter."""
        out = torch.zeros(self.dp, self.size, dtype=dtype, device=device)
        for t, n, o, p in zip(tensors, self.numels, self.offsets, self.pieces):
            if t is None:
                continue
            flat = t.reshape(-1)
            if n < p * self.dp:
                flat = torch.cat([flat, flat.new_zeros(p * self.dp - n)])
            out[:, o:o + p] = flat.view(self.dp, p)
        return out.view(-1)

    def unpack(self, gathered: torch.Tensor) -> List[torch.Tensor]:
        """The whole leaves of a gathered (dp * size,) buffer."""
        g = gathered.view(self.dp, self.size)
        return [g[:, o:o + p].reshape(-1)[:n].view(s)
                for s, n, o, p in zip(self.shapes, self.numels, self.offsets, self.pieces)]

    def reduce_scatter(self, tensors: Sequence[Optional[torch.Tensor]],
                       device) -> torch.Tensor:
        """The mean over the data ranks of whole-leaf gradients, in f32,
        as this rank's flat pieces: one reduce-scatter."""
        out = comm.reduce_scatter(self.pack(tensors, torch.float32, device), group="data")
        return out.mul_(1.0 / self.dp)

    def all_gather(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Whole leaves from every rank's flat pieces: one all-gather."""
        out = flat.new_empty(self.dp * self.size)
        return self.unpack(comm.all_gather_into(out, flat, group="data"))

    def deliver(self, grad: torch.Tensor) -> None:
        """Take one micro's reduced gradient: held in `pending` for the
        engine's overflow check, or added to `grad_acc`."""
        if self.stash:
            self.pending = grad
        elif self.grad_acc is None:
            self.grad_acc = grad
        else:
            self.grad_acc.add_(grad)


class _Gather(torch.autograd.Function):
    """Stage 3: a unit's whole parameters from the ranks' pieces; the
    backward reduce-scatters their gradient to the pieces, in f32, and
    hands it to the unit (`ZeroUnit.deliver`) instead of the piece's
    `.grad`, which keeps the model dtype."""

    @staticmethod
    def forward(ctx, shard, unit):
        ctx.unit = unit
        return tuple(unit.all_gather(shard))

    @staticmethod
    def backward(ctx, *grads):
        ctx.unit.deliver(ctx.unit.reduce_scatter(grads, grads[0].device))
        return None, None


def _owner(module: nn.Module, name: str):
    *path, attr = name.split(".")
    return module.get_submodule(".".join(path)), attr


@contextlib.contextmanager
def gathered(module: nn.Module):
    """Run `module` on its whole parameters: at stage 3 (a `zero_unit`
    attached by the engine) its sharded leaves are all-gathered and stand
    in for its placeholder parameters inside the block; otherwise nothing
    happens. The gathered tensors are not parameters: autograd carries
    their gradient back through the gather."""
    unit = getattr(module, "zero_unit", None)
    if unit is None:
        yield
        return
    whole = _Gather.apply(unit.shard, unit)
    whole = (whole,) if isinstance(whole, torch.Tensor) else whole
    saved = []
    for name, t in zip(unit.local_names, whole):
        owner, attr = _owner(module, name)
        saved.append((owner, attr, owner._parameters[attr]))
        owner._parameters[attr] = t
    try:
        yield
    finally:
        for owner, attr, p in reversed(saved):
            owner._parameters[attr] = p


class UnitLeaves:
    """One unit's leaves by what shards: `gathered` (stage 3: the
    parameters shard; a `ZeroUnit`), `sharded` (the parameters stay whole
    while the master, moments and accumulation shard; a `ZeroUnit`) and
    `whole` (nothing shards: names)."""

    def __init__(self, module: nn.Module, prefix: str, names: List[str],
                 plan: ZeroShardingPlan, rank: int, root: nn.Module):
        params = dict(root.named_parameters())
        local = lambda n: n[len(prefix) + 1:] if prefix else n

        def unit(kind_names):
            if not kind_names:
                return None
            return ZeroUnit(kind_names, [params[n].shape for n in kind_names], plan.dp, rank,
                            [local(n) for n in kind_names])

        shape = {n: jax_leaf_shape(root, n) for n in names}
        g = [n for n in names if plan.shards(shape[n], "param")]
        s = [n for n in names if n not in g and plan.shards(shape[n], "master")]
        self.module = module
        self.gathered, self.sharded = unit(g), unit(s)
        self.whole = [n for n in names if n not in g and n not in s]

    @property
    def flat(self) -> List[ZeroUnit]:
        return [u for u in (self.gathered, self.sharded) if u is not None]


def model_units(module: nn.Module, plan: ZeroShardingPlan, rank: int) -> List[UnitLeaves]:
    """The root (every parameter outside `module.layers`), then each
    decoder layer of `module.layers`, as units."""
    layers = getattr(module, "layers", None)
    blocks = list(layers) if isinstance(layers, nn.ModuleList) else []
    names = [n for n, _ in module.named_parameters()]
    inside = lambda n: blocks and n.startswith("layers.")
    units = [UnitLeaves(module, "", [n for n in names if not inside(n)], plan, rank, module)]
    for i, block in enumerate(blocks):
        prefix = f"layers.{i}"
        units.append(UnitLeaves(block, prefix,
                                [n for n in names if n.startswith(prefix + ".")], plan,
                                rank, module))
    return units


def layout_record(units: Optional[List[UnitLeaves]], shapes: Dict[str, torch.Size],
                  dp: int) -> dict:
    """What a checkpoint keeps of the layout, as JSON: `dp`, and per leaf
    (`shapes`: the whole leaves' shapes by name, in order) its shape and
    whether its parameters ("params") and its master and moments ("optim")
    are kept as the ranks' pieces. Over one rank (`units` None) every leaf
    is whole."""
    units = units or []
    gathered = {n for u in units if u.gathered is not None for n in u.gathered.names}
    pieces = gathered | {n for u in units if u.sharded is not None for n in u.sharded.names}
    return {"dp": int(dp),
            "leaves": {n: {"shape": list(shape), "params": n in gathered,
                           "optim": n in pieces} for n, shape in shapes.items()}}
