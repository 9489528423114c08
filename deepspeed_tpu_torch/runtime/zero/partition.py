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

The cut is the JAX plan's: a sharded leaf's piece r is its JAX chunk r
(`order`, a leaf's (perm, dim)): the leaf in flax layout (`perm` of its
torch dims: a Linear weight transposed to (in, out)), cut along the
dimension the JAX plan shards (`chunk_dim`, `add_axes_to_spec`'s rule on
the stacked leaf, less its layer axis), that dimension moved to the front
and flattened row-major, numel / dp elements, unpadded. So a rank holds
1/dp of every sharded leaf, and the same elements as the JAX device at its
place. The pieces of one unit (a decoder block, or the root: the
parameters outside the blocks) lie side by side in one flat buffer per
rank, so a unit's gradients take one reduce-scatter and its parameters
one all-gather.

Stage 3 runs the model through `gathered(module)`: the unit's parameter
pieces are all-gathered inside an autograd Function whose backward
reduce-scatters the gathered weights' gradient, in f32, back to this
rank's pieces. A model calls it inside each remat block (so the recompute
in backward gathers again, and the checkpoint keeps only the pieces) and
around its own forward for the root's leaves.

ZeRO++ (`zero_quantized_gradients`, `zero_quantized_weights`) quantizes
the reduce-scatter and stage 3's gathers (`runtime/comm/
coalesced_collectives.py`) in the JAX package's int8 blocks, since the
pieces are the JAX chunks: a gradient's chunk is quantized in chunk
order, a parameter shard in flax order, as the JAX functions do. A
stage-3 unit quantizes per layer, where the JAX package quantizes the
stacked leaf: the blocks agree where each layer's extent behind the
chunk dimension is a multiple of the block, as at every llama-1b width
(ROADMAP.md, Queue 3); the engine reduces the other sharded leaves
stacked across layers (`stacked_reduce_scatter`), whose blocks are JAX's
at any width.

MiCS and hpZ (a `repl` axis > 1 in the topology) shard over `data` only:
the pieces repeat across `repl`, a reduce-scatter over `data` is followed
by the mean across `repl`, and the gathers stay inside `data`.

A checkpoint keeps the pieces as they lie (`runtime/checkpointing.py`).
Since a piece depends only on the leaf's shape, its order, dp and the
rank, a leaf is whole again from any dp's pieces (`whole_leaf`; also the
flat pieces of a checkpoint written before the chunk layout, whose record
has no order), and each rank of another dp cuts its own (`flat_piece`);
`layout_record` is what a checkpoint's `ds_meta.json` keeps of the layout.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.config_utils import unported
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils.logging import logger

Tree = Dict[str, torch.Tensor]
Order = Tuple[Tuple[int, ...], int]    # (perm to flax layout, chunk dim)
_WARNED = set()
QUANT_BLOCK = 256
# the `nn.ModuleList` a model keeps its decoder blocks in, which the JAX
# model scans (its leaves stacked on a leading L axis): `h` is BLOOM's
BLOCK_LISTS = ("layers", "h")


def decoder_blocks(module: nn.Module) -> Tuple[str, List[nn.Module]]:
    """(the attribute, the blocks) of the module's decoder blocks, or ("", [])."""
    for attr in BLOCK_LISTS:
        blocks = getattr(module, attr, None)
        if isinstance(blocks, nn.ModuleList):
            return attr, list(blocks)
    return "", []


def jax_leaf_shape(module: nn.Module, name: str) -> Tuple[int, ...]:
    """The shape of parameter `name` as a leaf of the JAX tree: an
    `nn.Linear` weight (out, in) as the flax kernel (in, out), a leaf of
    decoder layer `layers.i` (`h.i`) stacked on a leading L axis."""
    *owner_path, attr = name.split(".")
    owner = module.get_submodule(".".join(owner_path))
    shape = tuple(getattr(owner, attr).shape)
    if isinstance(owner, nn.Linear) and attr == "weight":
        shape = shape[::-1]
    blocks_attr, blocks = decoder_blocks(module)
    if owner_path[:1] == [blocks_attr]:
        shape = (len(blocks),) + shape
    return shape


def jax_leaf_key(name: str) -> str:
    """The JAX leaf parameter `name` is part of: a decoder layer's
    `layers.<i>.<rest>` (`h.<i>.<rest>`) over every i stacked into
    `layers.*.<rest>` (the JAX models scan their layers), any other name
    itself."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in BLOCK_LISTS and parts[1].isdigit():
        return ".".join([parts[0], "*"] + parts[2:])
    return name


def jax_perm(module: nn.Module, name: str) -> Tuple[int, ...]:
    """The permutation of parameter `name`'s dims that gives its flax
    layout (one layer's, for a decoder-layer leaf)."""
    *owner_path, attr = name.split(".")
    owner = module.get_submodule(".".join(owner_path))
    ndim = getattr(owner, attr).dim()
    if isinstance(owner, nn.Linear) and attr == "weight":
        return (1, 0)
    return tuple(range(ndim))


class ZeroShardingPlan:
    """Which leaves shard over `dp` data ranks for a ZeRO config, as the
    JAX `ZeroShardingPlan.tree_specs` decides with no tensor-parallel
    base spec."""

    def __init__(self, dp: int, config: DeepSpeedZeroConfig):
        self.dp, self.stage = int(dp), int(config.stage)
        self.threshold = int(config.param_persistence_threshold)

    def order(self, root: nn.Module, name: str) -> Order:
        """Sharded leaf `name`'s (perm, chunk dim): the JAX chunk dim of its
        stacked leaf, less the layer axis."""
        shape = jax_leaf_shape(root, name)
        dim = self.chunk_dim(shape)
        if jax_leaf_key(name) != name:
            if dim == 0:
                raise unported(f"ZeRO on {name}, which the JAX plan shards along its "
                               f"layer axis {tuple(shape)}", "Multi-GPU")
            dim -= 1
        return jax_perm(root, name), dim

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
        if self.chunk_dim(shape) is not None:
            return True
        if size * self.dp > 1 << 20 and tuple(shape) not in _WARNED:
            _WARNED.add(tuple(shape))
            logger.warning(f"ZeRO: no dimension of shape {tuple(shape)} divisible by "
                           f"{self.dp} over axes ('data',); leaf stays replicated")
        return False


    def chunk_dim(self, shape: Sequence[int]) -> Optional[int]:
        """The dimension the JAX plan shards a leaf of JAX shape `shape`
        along: the largest one dp divides, the first of equals
        (`add_axes_to_spec`), or None."""
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[d] % self.dp == 0:
                return d
        return None


def moved(t: torch.Tensor, order: Order) -> torch.Tensor:
    """A leaf in its chunk order: flax layout, the chunk dim in front."""
    perm, dim = order
    return t.permute(perm).movedim(dim, 0)


def unmoved(m: torch.Tensor, order: Order) -> torch.Tensor:
    """`moved` undone: the leaf in torch layout (a view)."""
    perm, dim = order
    return m.movedim(0, dim).permute([perm.index(i) for i in range(len(perm))])


def moved_shape(shape: Sequence[int], order: Order) -> Tuple[int, ...]:
    perm, dim = order
    flax = [shape[i] for i in perm]
    return (flax[dim],) + tuple(flax[:dim] + flax[dim + 1:])


def flat_piece(whole: torch.Tensor, dp: int, rank: int, order: Order) -> torch.Tensor:
    """Rank `rank`'s piece of a whole leaf over `dp` data ranks: JAX chunk
    `rank`, in chunk order."""
    return moved(whole, order).reshape(dp, -1)[rank]


def whole_leaf(pieces: Sequence[torch.Tensor], shape: Sequence[int],
               order: Optional[Order]) -> torch.Tensor:
    """A leaf of `shape` from every rank's piece, in rank order; with no
    `order`, flat pieces (a checkpoint written before the chunk layout:
    elements [r * p, (r + 1) * p) of the flattened leaf, p = ceil(numel /
    dp), the last zero-padded)."""
    flat = torch.cat([p.reshape(-1) for p in pieces])
    if order is None:
        return flat[:math.prod(shape)].view(tuple(shape))
    return unmoved(flat.view(moved_shape(shape, order)), order).contiguous()


class ZeroUnit:
    """Leaves laid out on each rank: leaf i's piece r (JAX chunk r, in the
    order `orders[i]`, numel_i / dp elements) at `offsets[i]` of rank r's
    `size` elements.
    `shard` is the rank's flat parameter pieces at stage 3; `master` its
    f32 pieces the optimizer updates (in f32 training, of a unit whose
    parameters stay whole, a copy made for each step); `grad_acc` its f32
    gradient accumulation; `pending` one micro's reduced gradient where
    the engine checks it before accumulating. `zeropp` (set by the
    engine) holds the ZeRO++ switches: `grads` (qgZ), `weights` (qwZ),
    `reciprocal` (the scales' form); `repl` (MiCS) makes a reduce-scatter
    average across the `repl` axis too."""

    def __init__(self, names: List[str], shapes: List[torch.Size], dp: int, rank: int,
                 orders: List[Order], local_names: Optional[List[str]] = None):
        self.names, self.shapes = list(names), [torch.Size(s) for s in shapes]
        self.local_names = list(local_names or names)
        self.dp, self.rank = dp, rank
        self.orders = list(orders)
        self.pieces = [s.numel() // dp for s in self.shapes]
        self.offsets = [sum(self.pieces[:i]) for i in range(len(self.pieces))]
        self.size = sum(self.pieces)
        self.shard: Optional[nn.Parameter] = None
        self.master: Optional[torch.Tensor] = None
        self.grad_acc: Optional[torch.Tensor] = None
        self.pending: Optional[torch.Tensor] = None
        self.stash = False
        self.zeropp: Optional[dict] = None
        self.repl = False

    def views(self, flat: torch.Tensor) -> Tree:
        """Each leaf's piece, a view of the rank's flat buffer."""
        return {n: flat[o:o + p] for n, o, p in zip(self.names, self.offsets, self.pieces)}

    def piece_of(self, tensors: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
        """This rank's flat pieces of whole leaves."""
        first = tensors[0]
        out = torch.empty(self.size, dtype=dtype or first.dtype, device=first.device)
        for t, o, p, order in zip(tensors, self.offsets, self.pieces, self.orders):
            out[o:o + p] = flat_piece(t, self.dp, self.rank, order)
        return out

    def pack(self, tensors: Sequence[Optional[torch.Tensor]], dtype: torch.dtype,
             device) -> torch.Tensor:
        """Whole leaves (None: zeros) as the (dp * size,) buffer whose tile
        r holds every leaf's piece r: the input of a reduce-scatter."""
        out = torch.zeros(self.dp, self.size, dtype=dtype, device=device)
        for t, o, p, order in zip(tensors, self.offsets, self.pieces, self.orders):
            if t is not None:
                out[:, o:o + p] = moved(t, order).reshape(self.dp, p)
        return out.view(-1)

    def unpack(self, gathered: torch.Tensor) -> List[torch.Tensor]:
        """The whole leaves of a gathered (dp * size,) buffer, each
        contiguous in torch layout (the kernels take no strided operand):
        one copy a leaf, from its chunks into their places."""
        g = gathered.view(self.dp, self.size)
        out = []
        for s, o, p, order in zip(self.shapes, self.offsets, self.pieces, self.orders):
            leaf = g.new_empty(s)
            chunks = moved(leaf, order).unflatten(0, (self.dp, -1))
            chunks.copy_(g[:, o:o + p].view(chunks.shape))
            out.append(leaf)
        return out

    def reduce_scatter(self, tensors: Sequence[Optional[torch.Tensor]],
                       device) -> torch.Tensor:
        """The mean over the data ranks (and, under MiCS, the `repl`
        replicas) of whole-leaf gradients, in f32, as this rank's pieces:
        one reduce-scatter, or under qgZ one quantized exchange, each
        leaf's chunks quantized on their own."""
        packed = self.pack(tensors, torch.float32, device)
        if self.zeropp and self.zeropp["grads"]:
            from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import (
                reduce_scatter_segments)
            rows = packed.view(self.dp, self.size)
            out = torch.cat(reduce_scatter_segments(
                [rows[:, o:o + p] for o, p in zip(self.offsets, self.pieces)], "data",
                QUANT_BLOCK, self.zeropp["reciprocal"]))
        else:
            out = comm.reduce_scatter(packed, group="data").mul_(1.0 / self.dp)
        if self.repl:
            comm.all_reduce(out, op=comm.ReduceOp.AVG, group="repl")
        return out

    def all_gather(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Whole leaves from every rank's pieces: one all-gather over
        `data`."""
        out = flat.new_empty(self.dp * self.size)
        return self.unpack(comm.all_gather_into(out, flat, group="data"))

    def gather_for_compute(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """The whole leaves a forward computes with: `all_gather`, or under
        qwZ one quantized gather, each leaf's shard quantized in flax order
        and dequantized into the model dtype."""
        if not (self.zeropp and self.zeropp["weights"]):
            return self.all_gather(flat)
        from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import gather_segments
        shards = []
        for s, o, p, order in zip(self.shapes, self.offsets, self.pieces, self.orders):
            shards.append(_flax_order(flat[o:o + p], s, order, self.dp))
        got = gather_segments(shards, "data", QUANT_BLOCK, self.zeropp["reciprocal"])
        out = flat.new_empty(self.dp, self.size)
        for g, s, o, p, order in zip(got, self.shapes, self.offsets, self.pieces, self.orders):
            out[:, o:o + p] = _chunk_order(g, s, order, self.dp)
        return self.unpack(out.view(-1))

    def deliver(self, grad: torch.Tensor) -> None:
        """Take one micro's reduced gradient: held in `pending` for the
        engine's overflow check, or added to `grad_acc`."""
        if self.stash:
            self.pending = grad
        elif self.grad_acc is None:
            self.grad_acc = grad
        else:
            self.grad_acc.add_(grad)


def _shard_shape(shape, order: Order, dp: int) -> Tuple[int, ...]:
    """A chunk's shape in chunk order: the moved leaf's, its first dim / dp."""
    ms = moved_shape(shape, order)
    return (ms[0] // dp,) + ms[1:]


def _flax_order(piece: torch.Tensor, shape, order: Order, dp: int) -> torch.Tensor:
    """A piece (chunk order) flattened in flax order, as the JAX package
    quantizes a parameter shard."""
    return piece.view(_shard_shape(shape, order, dp)).movedim(0, order[1]).reshape(-1)


def _chunk_order(rows: torch.Tensor, shape, order: Order, dp: int) -> torch.Tensor:
    """`_flax_order` undone on each row of a (dp, p) tensor."""
    flax = torch.Size(_shard_shape(shape, order, dp))
    flax = flax[1:order[1] + 1] + flax[:1] + flax[order[1] + 1:]
    return rows.view((dp,) + tuple(flax)).movedim(order[1] + 1, 1).reshape(dp, -1)


class _Gather(torch.autograd.Function):
    """Stage 3: a unit's whole parameters from the ranks' pieces; the
    backward reduce-scatters their gradient to the pieces, in f32, and
    hands it to the unit (`ZeroUnit.deliver`) instead of the piece's
    `.grad`, which keeps the model dtype."""

    @staticmethod
    def forward(ctx, shard, unit):
        ctx.unit = unit
        return tuple(unit.gather_for_compute(shard))

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
                            [plan.order(root, n) for n in kind_names],
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
    """The root (every parameter outside the decoder blocks), then each
    decoder block (`decoder_blocks`), as units."""
    blocks_attr, blocks = decoder_blocks(module)
    names = [n for n, _ in module.named_parameters()]
    inside = lambda n: blocks and n.startswith(blocks_attr + ".")
    units = [UnitLeaves(module, "", [n for n in names if not inside(n)], plan, rank, module)]
    for i, block in enumerate(blocks):
        prefix = f"{blocks_attr}.{i}"
        units.append(UnitLeaves(block, prefix,
                                [n for n in names if n.startswith(prefix + ".")], plan,
                                rank, module))
    return units


def layout_record(units: Optional[List[UnitLeaves]], shapes: Dict[str, torch.Size],
                  dp: int) -> dict:
    """What a checkpoint keeps of the layout, as JSON: `dp`, and per leaf
    (`shapes`: the whole leaves' shapes by name, in order) its shape,
    whether its parameters ("params") and its master and moments ("optim")
    are kept as the ranks' pieces, and its pieces' order ("order": [perm,
    dim], None for a whole leaf). Over one rank (`units` None) every leaf
    is whole."""
    units = units or []
    gathered = {n for u in units if u.gathered is not None for n in u.gathered.names}
    orders = {n: o for u in units for f in u.flat for n, o in zip(f.names, f.orders)}
    return {"dp": int(dp),
            "leaves": {n: {"shape": list(shape), "params": n in gathered,
                           "optim": n in orders,
                           "order": [list(orders[n][0]), orders[n][1]] if n in orders
                           else None}
                       for n, shape in shapes.items()}}


def record_order(info: dict) -> Optional[Order]:
    """A leaf's piece order from its `layout_record` entry (None: whole, or
    the flat pieces of a record from before the chunk layout)."""
    order = info.get("order")
    return None if order is None else (tuple(order[0]), int(order[1]))


def stacked_reduce_scatter(units: List[ZeroUnit], grads: Dict[str, torch.Tensor],
                           block: int = QUANT_BLOCK, reciprocal: bool = False,
                           device=None) -> Dict[ZeroUnit, torch.Tensor]:
    """qgZ over the units of the parameters that stay whole
    (their gradients all present at once): each JAX leaf, a decoder leaf
    stacked over the layers, quantized as the JAX package quantizes it,
    chunk r of the stacked leaf (c, L, R) in one piece, then cut back into
    each layer's (c, R) piece; one quantized exchange a JAX leaf, so only
    one leaf's buffers live at a time. Returns each unit's mean pieces
    over `data` (then `repl`, under MiCS), f32."""
    from deepspeed_tpu_torch.runtime.comm.coalesced_collectives import (
        reduce_scatter_segments)
    groups: Dict[str, list] = {}
    for u in units:
        for n, s, o, p, order in zip(u.names, u.shapes, u.offsets, u.pieces, u.orders):
            groups.setdefault(jax_leaf_key(n), []).append((u, n, s, o, p, order))
    out = {u: torch.empty(u.size, dtype=torch.float32, device=device) for u in units}
    for leaves in groups.values():
        dp = leaves[0][0].dp
        rows = []
        for u, n, s, o, p, order in leaves:
            g = grads.get(n)
            c = _shard_shape(s, order, dp)[0]
            g = torch.zeros(s, dtype=torch.float32, device=device) if g is None else g.float()
            rows.append(moved(g, order).reshape(dp, c, p // c))
        c = rows[0].shape[1]
        segment = torch.stack(rows, dim=2).reshape(dp, -1)
        del rows
        red, = reduce_scatter_segments([segment], "data", block, reciprocal)
        del segment
        red = red.view(c, len(leaves), -1)
        for l, (u, n, s, o, p, order) in enumerate(leaves):
            out[u][o:o + p] = red[:, l].reshape(-1)
    for u, flat in out.items():
        if u.repl:
            comm.all_reduce(flat, op=comm.ReduceOp.AVG, group="repl")
    return out
