"""Checkpoint save and load (counterpart of ``deepspeed_tpu/runtime/checkpointing.py``).

The JAX package's directory conventions, in torch's file format (the JAX
files are orbax, which needs `jax`):

    save_dir/
      latest                       # the last tag saved
      global_step{N}/              # or the caller's tag
        ds_meta.json               # counters, config echo, client state, layout
        model_states/whole.pt      # {"params": leaves whole on every rank}, rank 0
        model_states/rankNNNNN.pt  # {"params": this rank's pieces} (stage 3)
        zero_optim_states/whole.pt # master, exp_avg, exp_avg_sq of the whole
                                   # leaves; count, scaler, global_step; rank 0
        zero_optim_states/rankNNNNN.pt  # this rank's pieces (stage >= 1)
        lr_scheduler.json

A leaf whole on every rank (stage 0, the leaves no dimension of which dp
divides, the parameters at stages 1-2, those under the persistence
threshold at stage 3) is written once, by rank 0; a sharded leaf's pieces
(`runtime/zero/partition.py`) by each rank into its own file, named by its
`data` coordinate, so no byte is written twice: under MiCS/hpZ the pieces
repeat across `repl`, and only the ranks at `repl` index 0 write them.
The 1-bit wire's optimizer state (`ops/optimizers.py`) is saved as it
lies: its shared fields and counters whole by rank 0 (`wire`), each
rank's own fields (`local_fields`) in its own file (`wire_local`, named by
its batch rank); it loads at the same number of ranks only.
`ds_meta.json` keeps the layout (`layout_record`): the saved dp, which
leaves are pieces and in what order. A load rebuilds each leaf whole from the
saved pieces (`whole_leaf`) and the engine cuts its own rank's (`adopt_state`),
so a save at dp = a loads at any dp = b. Files are read through
`torch.load(weights_only=True, mmap=True)`, one leaf at a time.

`zero_to_fp32` writes the f32 weights whole (the master, or the params
when there is none) to one `torch.save` file; `save_16bit_model` gathers
the model-dtype parameters unit by unit and keeps the whole tree on rank 0
only (`runtime/engine.py`). With `checkpoint.load_universal` the load
reads a universal folder (`checkpoint/ds_export.py`) instead.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from collections.abc import Mapping
from typing import Dict, Iterator, Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.checkpoint_engine import TorchCheckpointEngine
from deepspeed_tpu_torch.runtime.zero.partition import record_order, whole_leaf
from deepspeed_tpu_torch.utils.groups import BATCH_AXES
from deepspeed_tpu_torch.utils.logging import logger

LATEST_FILE = "latest"
LATEST_UNIVERSAL_FILE = "latest_universal"
MODEL_STATES = "model_states"
OPTIM_STATES = "zero_optim_states"
META_FILE = "ds_meta.json"
SCHEDULER_FILE = "lr_scheduler.json"
WHOLE_FILE = "whole.pt"
OPTIM_KINDS = ("master", "exp_avg", "exp_avg_sq")


def rank_file(rank: int) -> str:
    return f"rank{rank:05d}.pt"


def _tag_name(tag, global_step) -> str:
    return tag if tag is not None else f"global_step{global_step}"


def _read_file(directory: str, name: str) -> Optional[str]:
    path = os.path.join(directory, name)
    if os.path.exists(path):
        with open(path) as f:
            return f.read().strip()
    return None


def read_latest(load_dir: str) -> Optional[str]:
    return _read_file(load_dir, LATEST_FILE)


def _validate_tag(engine, tag: str) -> None:
    """The ranks save under one tag (`checkpoint.tag_validation`: Warn,
    Fail or Ignore), checked with two scalar all-reduces."""
    mode = engine.config.checkpoint_config.tag_validation.lower()
    if mode == "ignore" or engine.batch_dp == 1:
        return
    h = int(hashlib.sha256(tag.encode()).hexdigest()[:15], 16)
    lo = torch.tensor([h], dtype=torch.int64, device=engine.device)
    hi = lo.clone()
    comm.all_reduce(lo, op=comm.ReduceOp.MIN, group=BATCH_AXES)
    comm.all_reduce(hi, op=comm.ReduceOp.MAX, group=BATCH_AXES)
    if int(lo) != int(hi):
        msg = f"checkpoint tag {tag!r} is not the same on every data rank"
        if mode == "fail":
            raise ValueError(msg)
        logger.warning(msg)


def _detached(value):
    if isinstance(value, dict):
        return {k: v.detach() for k, v in value.items()}
    return value


def save_checkpoint(engine, save_dir, tag=None, client_state: Optional[Dict] = None,
                    save_latest: bool = True) -> str:
    """Every rank calls it (a collective over the data ranks). Returns the
    checkpoint's directory."""
    st = engine.state
    tag = _tag_name(tag, st.global_step)
    _validate_tag(engine, tag)
    ckpt_dir = os.path.abspath(os.path.join(save_dir, tag))
    topo = engine.topology
    rank, first = topo.coord("data"), topo.coord(BATCH_AXES) == 0
    writes_pieces = topo.coord("repl") == 0       # MiCS: the pieces repeat across repl
    layout = engine.checkpoint_layout()
    leaves = layout["leaves"]
    opt, wire = st.opt_state, engine._wire_opt
    trees = {"params": st.params, "master": st.master}
    if wire is None:
        trees.update(exp_avg=opt.exp_avg, exp_avg_sq=opt.exp_avg_sq)

    def split(pieces: bool) -> Dict[str, Dict[str, torch.Tensor]]:
        return {kind: {n: t.detach() for n, t in tree.items()
                       if leaves[n]["params" if kind == "params" else "optim"] == pieces}
                for kind, tree in trees.items() if tree is not None}

    whole, pieces = split(False), split(True)
    ce = TorchCheckpointEngine()
    model_dir, optim_dir = os.path.join(ckpt_dir, MODEL_STATES), os.path.join(ckpt_dir, OPTIM_STATES)
    if first:
        ce.save({"params": whole["params"]}, os.path.join(model_dir, WHOLE_FILE))
        extra = {} if wire is None else {"wire": {
            f: _detached(getattr(opt, f)) for f in opt._fields if f not in wire.local_fields}}
        ce.save({**{k: whole[k] for k in OPTIM_KINDS if k in whole}, "count": int(opt.count),
                 "scaler": dataclasses.asdict(st.scaler), "global_step": int(st.global_step),
                 **extra},
                os.path.join(optim_dir, WHOLE_FILE))
    if pieces["params"] and writes_pieces:
        ce.save({"params": pieces["params"]}, os.path.join(model_dir, rank_file(rank)))
    if any(pieces.get(k) for k in OPTIM_KINDS) and writes_pieces:
        ce.save({k: pieces[k] for k in OPTIM_KINDS if k in pieces},
                os.path.join(optim_dir, rank_file(rank)))
    if wire is not None:
        ce.save({"wire_local": {f: _detached(getattr(opt, f)) for f in wire.local_fields}},
                os.path.join(optim_dir, rank_file(topo.coord(BATCH_AXES))))
    comm.barrier(group=BATCH_AXES)   # every rank's files are down before `latest` names them
    if first:
        meta = {"global_steps": engine.global_steps, "global_samples": engine.global_samples,
                "micro_steps": engine.micro_steps, "skipped_steps": engine.skipped_steps,
                "zero_stage": engine.zero_optimization_stage(),
                "dtype": str(engine.model_dtype).split(".")[-1],
                "world_size": engine.topology.world_size, "mesh": engine.topology.sizes,
                "data_parallel_size": engine.dp, "batch_ranks": engine.batch_dp,
                "wire": None if wire is None else type(wire).__name__,
                "zero_layout": layout,
                "client_state": client_state or {}}
        with open(os.path.join(ckpt_dir, META_FILE), "w") as f:
            json.dump(meta, f, indent=1, default=str)
        with open(os.path.join(ckpt_dir, SCHEDULER_FILE), "w") as f:
            json.dump(engine.lr_scheduler.state_dict(), f)
        if save_latest:
            with open(os.path.join(save_dir, LATEST_FILE), "w") as f:
                f.write(tag)
    comm.barrier(group=BATCH_AXES)
    logger.info(f"saved checkpoint {tag} to {save_dir}")
    return ckpt_dir


class _Leaves(Mapping):
    """One kind of a checkpoint's leaves by name, each made whole when it
    is read."""

    def __init__(self, reader: "CheckpointReader", kind: str):
        self.reader, self.kind = reader, kind

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.reader.leaf(self.kind, name)

    def __iter__(self) -> Iterator[str]:
        return iter(self.reader.names)

    def __len__(self) -> int:
        return len(self.reader.names)


class CheckpointReader:
    """A saved checkpoint directory, read without the engine that wrote
    it: `meta` (`ds_meta.json`), the leaves' `names` in order, `leaf(kind,
    name)` whole (kind "params", "master", "exp_avg" or "exp_avg_sq"),
    `tree(kind)` a mapping that reads each leaf when it is used, and the
    optimizer's `count`, `scaler` and `global_step`. The files are mapped,
    not read, until a leaf is."""

    def __init__(self, ckpt_dir: str):
        ce = TorchCheckpointEngine()
        with open(os.path.join(ckpt_dir, META_FILE)) as f:
            self.meta = json.load(f)
        layout = self.meta["zero_layout"]
        self.dp, self.leaves = int(layout["dp"]), layout["leaves"]
        self.names = list(self.leaves)

        def load(folder, name):
            path = os.path.join(ckpt_dir, folder, name)
            return ce.load(path) if os.path.exists(path) else {}

        self._whole = {MODEL_STATES: load(MODEL_STATES, WHOLE_FILE),
                       OPTIM_STATES: load(OPTIM_STATES, WHOLE_FILE)}
        self._ranks = {folder: [load(folder, rank_file(r)) for r in range(self.dp)]
                       for folder in (MODEL_STATES, OPTIM_STATES)}
        optim = self._whole[OPTIM_STATES]
        self.count, self.global_step = optim.get("count", 0), optim.get("global_step", 0)
        self.scaler = optim.get("scaler")
        self.has_master = "master" in optim or any("master" in r for r in
                                                   self._ranks[OPTIM_STATES])

    def leaf(self, kind: str, name: str) -> torch.Tensor:
        info = self.leaves[name]
        folder = MODEL_STATES if kind == "params" else OPTIM_STATES
        if info["params" if kind == "params" else "optim"]:
            return whole_leaf([r[kind][name] for r in self._ranks[folder]], info["shape"],
                              record_order(info))
        return self._whole[folder][kind][name]

    def tree(self, kind: str) -> Mapping:
        return _Leaves(self, kind)


def load_checkpoint(engine, load_dir, tag=None, load_optimizer_states: bool = True,
                    load_module_only: bool = False, load_lr_scheduler_states: bool = True):
    """Every rank calls it. Returns (the checkpoint's directory, its client
    state), or (None, {}) with a warning where `load_dir` names no `latest`
    tag; an unknown tag raises `FileNotFoundError`. With
    `load_optimizer_states=False` or `load_module_only=True` only the
    parameters load: the master is made from them and the moments start
    afresh (`adopt_state`)."""
    from deepspeed_tpu_torch.ops.optimizers import AdamState
    from deepspeed_tpu_torch.runtime.engine import TrainState
    from deepspeed_tpu_torch.runtime.precision import LossScaleState
    if engine.config.load_universal_checkpoint:
        return _load_universal(engine, load_dir, tag, load_optimizer_states, load_module_only)
    tag = tag or read_latest(load_dir)
    if tag is None:
        logger.warning(f"no 'latest' file in {load_dir}; nothing loaded")
        return None, {}
    ckpt_dir = os.path.abspath(os.path.join(load_dir, tag))
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"checkpoint dir {ckpt_dir} not found")
    reader = CheckpointReader(ckpt_dir)
    optim = load_optimizer_states and not load_module_only
    wire = engine._wire_opt
    st = engine.state
    engine.adopt_state(TrainState(
        global_step=int(reader.global_step) if optim else st.global_step,
        params=reader.tree("params"),
        master=reader.tree("master") if optim and reader.has_master else None,
        opt_state=AdamState(int(reader.count), reader.tree("exp_avg"),
                            reader.tree("exp_avg_sq")) if optim and wire is None else None,
        grad_acc=None,
        scaler=LossScaleState(**reader.scaler) if optim else st.scaler))
    meta = reader.meta
    if optim and wire is not None:
        engine.state.opt_state = _load_wire_state(engine, ckpt_dir, reader)
    if not load_module_only:
        engine.global_steps = meta.get("global_steps", 0)
        engine.global_samples = meta.get("global_samples", 0)
        engine.micro_steps = meta.get("micro_steps", 0)
    sched = os.path.join(ckpt_dir, SCHEDULER_FILE)
    if optim and load_lr_scheduler_states and os.path.exists(sched):
        with open(sched) as f:
            engine.lr_scheduler.load_state_dict(json.load(f))
    logger.info(f"loaded checkpoint {tag} from {load_dir}")
    return ckpt_dir, meta.get("client_state", {})


def _load_wire_state(engine, ckpt_dir: str, reader: CheckpointReader):
    """The 1-bit wire's optimizer state as saved: its shared fields from
    rank 0's file, this rank's own from its file; the same optimizer and
    the same number of ranks as the save."""
    wire, topo = engine._wire_opt, engine.topology
    if reader.meta.get("wire") != type(wire).__name__ \
            or int(reader.meta.get("batch_ranks", 1)) != engine.batch_dp:
        raise ValueError(f"{ckpt_dir} holds the wire state of {reader.meta.get('wire')} over "
                         f"{reader.meta.get('batch_ranks')} ranks; this engine runs "
                         f"{type(wire).__name__} over {engine.batch_dp}")
    shared = reader._whole[OPTIM_STATES]["wire"]
    local = TorchCheckpointEngine().load(
        os.path.join(ckpt_dir, OPTIM_STATES, rank_file(topo.coord(BATCH_AXES))))["wire_local"]
    mine = engine.state.opt_state
    fields = {}
    for f in mine._fields:
        saved = local[f] if f in wire.local_fields else shared[f]
        if isinstance(saved, dict):
            for k, t in getattr(mine, f).items():
                t.copy_(saved[k])
            fields[f] = getattr(mine, f)
        else:
            fields[f] = saved
    return type(mine)(**fields)


def _load_universal(engine, load_dir, tag, load_optimizer_states, load_module_only):
    """`load_checkpoint` from a universal folder (`checkpoint/ds_export.py`):
    `load_dir` itself when it holds `zero/`, else its `tag` (by default the
    one `latest_universal` names). The f32 atoms are the master and the
    parameters; the moments and the step load with the optimizer states;
    the loss scaler keeps its state."""
    from deepspeed_tpu_torch.checkpoint.ds_export import load_universal
    from deepspeed_tpu_torch.ops.optimizers import AdamState
    from deepspeed_tpu_torch.runtime.engine import TrainState
    folder = load_dir
    if not os.path.isdir(os.path.join(folder, "zero")):
        tag = tag or _read_file(load_dir, LATEST_UNIVERSAL_FILE)
        if tag is None:
            logger.warning(f"no universal checkpoint in {load_dir}; nothing loaded")
            return None, {}
        folder = os.path.join(load_dir, tag)
    atoms = load_universal(folder)
    info = torch.load(os.path.join(folder, "zero", "optimizer_state.pt"), map_location="cpu",
                      weights_only=True)
    meta, step = info.get("ds_meta", {}), int(info.get("step", 0))
    optim = load_optimizer_states and not load_module_only
    st = engine.state
    engine.adopt_state(TrainState(
        global_step=step if optim else st.global_step, params=atoms["fp32"],
        master=atoms["fp32"] if optim else None,
        opt_state=AdamState(step, atoms["exp_avg"], atoms["exp_avg_sq"]) if optim else None,
        grad_acc=None, scaler=st.scaler))
    if not load_module_only:
        engine.global_steps = meta.get("global_steps", 0)
        engine.global_samples = meta.get("global_samples", 0)
        engine.micro_steps = meta.get("micro_steps", 0)
        if optim:
            engine.lr_scheduler.last_step = engine.global_steps
    logger.info(f"loaded universal checkpoint {folder}")
    return os.path.abspath(folder), meta.get("client_state", {})


def zero_to_fp32(checkpoint_dir, output_file, tag=None) -> str:
    """Offline consolidation: a checkpoint's f32 weights, whole, by the
    module's parameter names, in one `torch.save` file: the master, or the
    parameters where the run kept none (f32 training). Reads one leaf at a
    time; needs no engine and no device."""
    tag = tag or read_latest(checkpoint_dir)
    reader = CheckpointReader(os.path.join(os.path.abspath(checkpoint_dir), tag))
    kind = "master" if reader.has_master else "params"
    out = {n: reader.leaf(kind, n).to(torch.float32, copy=True) for n in reader.names}
    torch.save(out, output_file)
    return output_file


def zero_to_fp32_cli() -> int:
    """Console entry: `zero_to_fp32 <checkpoint_dir> <output_file> [--tag]`."""
    import argparse
    p = argparse.ArgumentParser(description="consolidate a ZeRO checkpoint to fp32")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    args = p.parse_args()
    out = zero_to_fp32(args.checkpoint_dir, args.output_file, tag=args.tag)
    print(f"wrote {out}")
    return 0


def save_16bit_model(engine, save_dir, save_filename="pytorch_model.bin") -> str:
    """The model-dtype parameters whole, by name, in one `torch.save` file
    written by rank 0. Every rank calls it (stage 3 gathers unit by unit);
    only rank 0 keeps the whole tree, in host memory."""
    keep = engine.topology.coord(BATCH_AXES) == 0
    params = {}
    for unit in engine.whole_param_units():
        if keep:
            params.update({n: t.detach().to("cpu", copy=True) for n, t in unit.items()})
    path = os.path.join(save_dir, save_filename)
    if keep:
        os.makedirs(save_dir, exist_ok=True)
        torch.save({n: params[n] for n in engine.param_shapes}, path)
    comm.barrier(group=BATCH_AXES)
    logger.info(f"saved 16bit model to {path}")
    return path
