"""DeepSpeedEngine, the training engine (counterpart of
``deepspeed_tpu/runtime/engine.py``): one process a rank, one device each,
over the `data` axis of the installed topology (`utils/groups.py`).

The JAX engine compiles a pure train step over an explicit `TrainState`;
this engine runs the same step eagerly on an `nn.Module` and keeps the same
state under the same field names (`engine.state`): `global_step`, `params`
(the module's parameters, in the model dtype), `master` (f32 copy when the
model dtype is not f32), `opt_state`, `grad_acc` (f32 accumulation, absent
between steps at GAS 1) and `scaler`. Tensor trees are name -> tensor dicts
in `named_parameters()` order.

Two user surfaces, as in the JAX package:
    loss = engine(batch); engine.backward(loss); engine.step()
and
    loss = engine.train_batch(data_iter)  # or batch=...

A loss function is `loss_fn(module, batch)` or, where it takes a third
argument, `loss_fn(module, batch, rng)`: the engine then hands it a
`torch.Generator` on its device seeded with `seed + micro_steps`, a fresh
stream for each micro-batch (the JAX engine's `_next_rng`; the draws are
not JAX's). The MoE loss functions route the noisy gate's draws from it.

Over dp > 1 data ranks each rank takes its own rows of the global batch
(`train_batch(batch=...)` gets the rank's micro x GAS rows; the rows split
over `repl` x `data`, `utils/groups.BATCH_AXES`), and ZeRO partitions the
state over `data` as `runtime/zero/partition.py` lays it out. At every
micro the gradients are reduced in f32 and averaged: stage 0 all-reduces
them whole over every rank; stage 1 and up reduce-scatter them over
`data` into this rank's pieces of `grad_acc` (stage 2 is stage 1, as in
the JAX package), then, under MiCS/hpZ, average the pieces across `repl`;
stage 3 reduce-scatters a gathered unit's gradient in its gather's
backward. ZeRO++ (the JAX `_zeropp_fwd_bwd`) quantizes those
reduce-scatters to int8 from stage 1 up (qgZ) and stage 3's gathers
(qwZ), with the JAX package's blocks and its compiled step's scale form
(`reciprocal`), and each rank's loss is the mean over its own labels, as
in the JAX manual region. The wire mode of the 1-bit optimizers (the JAX
`_wire_fwd_bwd`/`_wire_step`: OneBitAdam, ZeroOneAdam or OneBitLamb with
`comm_backend_name`, ZeRO stage 0) reduces nothing in backward: each rank
keeps its own gradients and its own-label loss, and the optimizer's
`update_local` makes the step's only exchange, compressed after its
warm-up; the pre-clip norm is that of the ranks' mean gradient (one
all-reduce, as the JAX step computes it). The JAX refusals hold: the wire
with ZeRO stage > 0, with MoE, with `gradient_clipping` or with ZeRO++.
The update runs on the rank's pieces of the master and the moments, the
pre-clip norm and the fp16 overflow flag are global (one
all-reduce each), and stages 1-2 all-gather the updated model-dtype
parameters. The state keeps the field names, with a sharded leaf's
tensors as the rank's flat pieces; `materialized_state()` gathers it
whole. The causal-LM loss is the global batch's token mean
(`models/common.cross_entropy_loss` counts the ranks' labels), and
`train_batch` returns it on every rank. Over one rank every stage is the
identity and the engine keeps whole tensors. The state is updated in
place; where the JAX step selects the old target and optimizer state on
an overflow, this one does not call the optimizer. The MoE families train
across data ranks with their gate over the global batch
(`moe/sharded_moe.py`), at every stage; stage 3 needs a model whose
forward gathers its units (`zero3_gathers`: Llama, the MoE families,
BLOOM, phi and GPT-NeoX), and tensor- or expert-parallel topologies do not train
(ROADMAP.md, Queue 1, 'Multi-GPU').

Checkpoints: `save_checkpoint`, `load_checkpoint` and `save_16bit_model`,
with the JAX engine's signatures (`runtime/checkpointing.py`). Each rank
writes its own pieces and rank 0 the leaves whole on every rank; a load
at any dp rebuilds each leaf and cuts this rank's pieces (`adopt_state`),
and restores the counters (`micro_steps` seeds the per-micro generator),
the loss scaler and the lr schedule, so a resumed run takes the steps of
one that never stopped. The files are written through
`runtime/checkpoint_engine.py`'s `TorchCheckpointEngine`, synced before
`latest` names them.
The telemetry `MetricsState`, the flops profiler, curriculum and offload
are not ported; their config keys raise (`runtime/config.py`).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.ops.optimizers import (
    GradientTransformation,
    build_optimizer,
    wire_optimizer,
)
from deepspeed_tpu_torch.runtime import checkpointing
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError, unported
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.lr_schedules import LRScheduler, build_lr_schedule
from deepspeed_tpu_torch.runtime.precision import (
    LossScaler,
    LossScaleState,
    cast_tree,
    clip_factor,
    global_grad_norm,
)
from deepspeed_tpu_torch.runtime.zero.partition import (
    ZeroShardingPlan,
    ZeroUnit,
    flat_piece,
    layout_record,
    model_units,
    record_order,
    stacked_reduce_scatter,
)
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.groups import BATCH_AXES
from deepspeed_tpu_torch.utils.logging import logger

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The whole training state, under the JAX `TrainState`'s field names.
    Over dp data ranks a sharded leaf's tensors are this rank's flat
    pieces (`runtime/zero/partition.py`)."""
    global_step: int                  # optimizer steps taken (not skipped ones)
    params: Tree                      # the module's parameters, model dtype
    master: Optional[Tree]            # f32 master copy (None when pure f32)
    opt_state: Any
    grad_acc: Optional[Tree]          # f32 accumulation buffers
    scaler: LossScaleState


def _has_moe(model) -> bool:
    from deepspeed_tpu_torch.moe.layer import MoE
    return any(isinstance(m, MoE) for m in model.modules())


def _split_loss(out):
    """A loss function's result as (loss, aux)."""
    if isinstance(out, tuple):
        return out[0], (out[1] if len(out) > 1 else {})
    return out, {}


class DeepSpeedEngine:
    def __init__(self, model: torch.nn.Module, loss_fn: Optional[Callable] = None,
                 config: Optional[DeepSpeedConfig] = None, model_parameters: Any = None,
                 training_data=None, collate_fn=None, lr_scheduler=None,
                 optimizer: Optional[GradientTransformation] = None, device=None):
        self.config = config if config is not None else DeepSpeedConfig(None)
        config = self.config
        self.accelerator = get_accelerator(device)
        self.device = self.accelerator.device
        self.module = model
        self.topology = groups.get_topology()
        self.dp = self.topology.dp_size                  # the `data` axis ZeRO shards over
        self.batch_dp = self.topology.axis_size(BATCH_AXES)   # the ranks a batch splits over
        self._check_data_parallel(model)
        self.model_dtype = config.model_dtype
        self.mixed_precision = self.model_dtype != torch.float32
        self.loss_scaler = LossScaler(config.fp16)

        if optimizer is not None:
            self.opt = optimizer
            self.base_lr = config.optimizer.params.get("lr", 1e-3) if config.optimizer else 1e-3
        else:
            opt_cfg = config.optimizer
            self.opt, self.base_lr = build_optimizer(opt_cfg.type if opt_cfg else "adam",
                                                     opt_cfg.params if opt_cfg else {})
        self._wire_opt = None
        if optimizer is None and config.optimizer is not None \
                and config.optimizer.params.get("comm_backend_name"):
            self._wire_opt = wire_optimizer(config.optimizer.type, config.optimizer.params)
            if self._wire_opt is not None:
                self._check_wire(model)
        if optimizer is None and self._wire_opt is None and config.optimizer is not None \
                and config.optimizer.type.lower() == "onebitadam" and self.batch_dp > 1 \
                and config.zero_config.stage >= 1:
            # its compression scale is a whole leaf's mean, and a rank holds pieces
            raise unported("OneBitAdam without comm_backend_name at ZeRO stage >= 1 across "
                           "data ranks", "Training: the rest")
        sched = config.scheduler
        self.lr_fn = build_lr_schedule(sched.type if sched else None,
                                       sched.params if sched else {}, self.base_lr)
        self.lr_scheduler = lr_scheduler or LRScheduler(self.lr_fn, self.base_lr)
        self.loss_fn = loss_fn or (lambda module, batch: module(**batch))
        self._loss_takes_rng = len(inspect.signature(self.loss_fn).parameters) >= 3

        self.micro_steps = 0
        self.global_steps = 0
        self.global_samples = 0
        self._grad_norm: Optional[torch.Tensor] = None
        # GAS 1: the f32 accumulation buffers live only inside a step
        self._elide_grad_acc = config.gradient_accumulation_steps == 1
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = DeepSpeedDataLoader(
                training_data, batch_size=config.train_micro_batch_size_per_gpu,
                collate_fn=collate_fn, drop_last=config.dataloader_drop_last,
                seed=config.seed, data_parallel_size=self.batch_dp,
                data_parallel_rank=self.topology.coord(BATCH_AXES))
        self.state: Optional[TrainState] = None
        self.units = None            # the ZeRO units over dp > 1 data ranks
        self.initialize_state(model_parameters)

    def _check_data_parallel(self, model) -> None:
        topo, cfg = self.topology, self.config
        if topo.tp_size > 1 or topo.ep_size > 1:
            raise unported(f"training under a {topo!r}", "Multi-GPU")
        if cfg.data_parallel_size != self.batch_dp:
            raise ValueError(f"the config's data-parallel size {cfg.data_parallel_size} "
                             f"(world size {cfg.world_size}) is not the topology's "
                             f"data={self.batch_dp}")
        if self.batch_dp > 1 and cfg.zero_config.stage == 3 \
                and not getattr(model, "zero3_gathers", False):
            raise unported(f"ZeRO stage 3 across data ranks with {type(model).__name__}",
                           "Multi-GPU")
        z = cfg.zero_config
        if (z.quantized or topo.repl_size > 1) and _has_moe(model):
            raise unported(f"ZeRO++/MiCS with the MoE family {type(model).__name__}",
                           "Multi-GPU")

    def _check_wire(self, model) -> None:
        """The JAX engine's refusals of the 1-bit wire, with its messages."""
        cfg = self.config
        if cfg.zero_config.stage > 0:
            raise DeepSpeedConfigError(
                "1-bit Adam wire compression requires ZeRO stage 0: the compressed momentum "
                "exchange keeps momenta replicated, so stage-1 sharding of optimizer state "
                "would silently degrade to stage-0 memory (the reference's own limit is "
                "stage <= 1, onebit/adam.py)")
        if _has_moe(model):
            raise DeepSpeedConfigError(
                "1-bit Adam wire compression is incompatible with pipeline parallelism / "
                "MoE expert params")
        if cfg.gradient_clipping > 0.0:
            raise DeepSpeedConfigError(
                "gradient_clipping needs globally-averaged gradients; 1-bit wire mode never "
                "materializes them — disable one")
        if cfg.zero_config.quantized:
            raise DeepSpeedConfigError(
                "zeropp quantized collectives and 1-bit wire mode are mutually exclusive "
                "gradient-sync paths")

    # ------------------------------------------------------------------ state
    @torch.no_grad()
    def initialize_state(self, model_parameters=None) -> TrainState:
        """Params to the model dtype on the device, then the master, the
        optimizer state and the accumulation buffers. The master is the
        model-dtype params upcast to f32, not the original f32 weights."""
        if model_parameters is not None:
            # the module owns the mapping from a JAX tree onto its weights
            if not hasattr(self.module, "load_jax_params"):
                raise TypeError(f"{type(self.module).__name__} has no load_jax_params(tree); "
                                "load its weights before initialize and pass "
                                "model_parameters=None")
            self.module.load_jax_params(model_parameters)
        self.module.to(device=self.device, dtype=self.model_dtype)
        params = dict(self.module.named_parameters())
        self.param_shapes = {n: p.shape for n, p in params.items()}
        self.total_params = sum(p.numel() for p in params.values())
        if self.batch_dp > 1 and self._wire_opt is None:
            return self._initialize_sharded(params)
        master = cast_tree({k: p.detach() for k, p in params.items()}, torch.float32) \
            if self.mixed_precision else None
        grad_acc = None if self._elide_grad_acc else \
            {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        opt = self._wire_opt or self.opt
        self.state = TrainState(global_step=0, params=params, master=master,
                                opt_state=opt.init(master if self.mixed_precision else params),
                                grad_acc=grad_acc, scaler=self.loss_scaler.init_state())
        self._log_initialized()
        return self.state

    def _log_initialized(self):
        logger.info(f"engine initialized: {self.total_params / 1e6:.1f}M params on "
                    f"{self.accelerator.device_name()}, {self.topology!r}, "
                    f"zero_stage={self.zero_optimization_stage()}, dtype={self.model_dtype}")

    def _flat_units(self):
        return [f for u in self.units for f in u.flat]

    def _whole_names(self):
        return [n for u in self.units for n in u.whole]

    def _initialize_sharded(self, params: Tree) -> TrainState:
        """The state over dp data ranks: this rank's pieces of each
        sharded leaf, whole tensors of the rest (module docstring)."""
        z = self.config.zero_config
        plan = ZeroShardingPlan(self.dp, z)
        self.units = model_units(self.module, plan, self.topology.coord("data"))
        zeropp = dict(grads=z.zero_quantized_gradients, weights=z.zero_quantized_weights,
                      reciprocal=True) if z.quantized else None
        for f in self._flat_units():
            f.zeropp, f.repl = zeropp, self.topology.repl_size > 1
        self._module_params = params
        mixed = self.mixed_precision
        state_params, master = {}, {}
        for u in self.units:
            g, s = u.gathered, u.sharded
            if g is not None:
                g.stash = self.loss_scaler.enabled
                g.shard = torch.nn.Parameter(g.piece_of([params[n] for n in g.names]))
                for n in g.names:       # the module keeps an empty placeholder
                    params[n].data = params[n].new_empty(0)
                u.module.zero_unit = g
                state_params.update(g.views(g.shard))
                if mixed:
                    g.master = g.shard.detach().float()
            if s is not None:
                state_params.update({n: params[n] for n in s.names})
                if mixed:
                    s.master = s.piece_of([params[n] for n in s.names], torch.float32)
            state_params.update({n: params[n] for n in u.whole})
            if mixed:
                master.update({n: params[n].detach().float() for n in u.whole})
        if mixed:
            for f in self._flat_units():
                master.update(f.views(f.master))
            master = {n: master[n] for n in state_params}
        for f in self._flat_units():
            f.grad_acc = None if self._elide_grad_acc else \
                torch.zeros(f.size, dtype=torch.float32, device=self.device)
        self._whole_acc = None if self._elide_grad_acc else \
            {n: torch.zeros_like(params[n], dtype=torch.float32) for n in self._whole_names()}
        self.state = TrainState(global_step=0, params=state_params,
                                master=master if mixed else None, opt_state=None,
                                grad_acc=self._grad_tree(), scaler=self.loss_scaler.init_state())
        self.state.opt_state = self.opt.init(self._update_target())
        self._log_initialized()
        return self.state

    def _update_target(self) -> Tree:
        """What the optimizer updates: the master, or in f32 the params,
        a `sharded` unit's pieces copied out of its whole params (into the
        unit's `master`, which the update's all-gather then reads)."""
        if self.mixed_precision:
            return self.state.master
        target = {}
        for u in self.units:
            if u.gathered is not None:
                target.update(u.gathered.views(u.gathered.shard.detach()))
            if u.sharded is not None:
                s = u.sharded
                s.master = s.piece_of([self._module_params[n] for n in s.names])
                target.update(s.views(s.master))
            target.update({n: self._module_params[n].detach() for n in u.whole})
        return target

    def _grad_tree(self) -> Optional[Tree]:
        """`grad_acc` by name: views of the units' flat pieces, and the
        whole leaves' buffers."""
        if self._whole_acc is None and all(f.grad_acc is None for f in self._flat_units()):
            return None
        tree = {}
        for f in self._flat_units():
            if f.grad_acc is not None:
                tree.update(f.views(f.grad_acc))
        tree.update(self._whole_acc or {})
        return tree

    @torch.no_grad()
    def whole_param_units(self):
        """The model-dtype parameters whole, unit by unit ({name: tensor}
        for each): stage 3's pieces all-gathered (a collective, so every
        rank runs the generator to its end), the module's own tensors
        otherwise."""
        if self.units is None:
            yield dict(self.state.params)
            return
        for u in self.units:
            part = {n: self._module_params[n].detach() for n in u.whole}
            if u.sharded is not None:
                part.update({n: self._module_params[n].detach() for n in u.sharded.names})
            if u.gathered is not None:
                g = u.gathered
                part.update(zip(g.names, g.all_gather(g.shard.detach())))
            yield part

    def gathered_params(self) -> Tree:
        """The model-dtype parameters whole, by name, on every rank (a
        collective: `whole_param_units`)."""
        params = {}
        for part in self.whole_param_units():
            params.update(part)
        return {n: params[n] for n in self.param_shapes}

    @torch.no_grad()
    def materialized_state(self) -> TrainState:
        """The state with every sharded leaf gathered whole on every rank
        (the JAX engine's `materialized_state`; a collective, so every rank
        calls it). Over one rank, the state itself."""
        st = self.state
        if self.units is None:
            return st

        def whole(tree):
            out = {n: tree[n] for n in self._whole_names()}
            for f in self._flat_units():
                flat = torch.cat([tree[n].reshape(-1) for n in f.names])
                out.update(zip(f.names, f.all_gather(flat)))
            return {n: out[n] for n in st.params}

        opt = st.opt_state
        opt = type(opt)(*[whole(x) if isinstance(x, dict) else x for x in opt])
        return TrainState(global_step=st.global_step, params=self.gathered_params(),
                          master=None if st.master is None else whole(st.master),
                          opt_state=opt,
                          grad_acc=None if st.grad_acc is None else whole(st.grad_acc),
                          scaler=st.scaler)

    # ------------------------------------------------------------ checkpoints
    def checkpoint_layout(self) -> dict:
        """The state's layout as a checkpoint's `ds_meta.json` keeps it
        (`runtime/zero/partition.layout_record`)."""
        return layout_record(self.units, self.param_shapes, self.dp)

    @torch.no_grad()
    def adopt_state(self, state: TrainState) -> None:
        """Install `state`, whose trees hold whole leaves by name (any
        mapping, read one leaf at a time, on any device and in any dtype):
        over dp data ranks this rank's pieces are cut from each leaf.
        `master` None makes the master from the model-dtype parameters, as
        `initialize_state` does; `opt_state` None starts the moments afresh
        (count 0). `global_step` and `scaler` are taken as they are, and the
        gradient accumulation is zeroed."""
        st, opt = self.state, self.state.opt_state
        leaves = self.checkpoint_layout()["leaves"]
        rank = self.topology.coord("data")

        def put(dst, whole, pieces, order):
            src = flat_piece(whole, self.dp, rank, order) if pieces else whole
            dst.copy_(src.reshape(dst.shape))

        fresh = state.opt_state is None
        for n in self.param_shapes:
            params, optim = leaves[n]["params"], leaves[n]["optim"]
            order = record_order(leaves[n])
            whole = state.params[n]
            put(st.params[n], whole, params, order)
            if st.master is not None:
                put(st.master[n], whole.to(self.model_dtype) if state.master is None
                    else state.master[n], optim, order)
            for mine, saved in ((opt.exp_avg, None if fresh else state.opt_state.exp_avg),
                                (opt.exp_avg_sq, None if fresh else state.opt_state.exp_avg_sq)):
                if saved is None:
                    mine[n].zero_()
                else:
                    put(mine[n], saved[n], optim, order)
        if fresh and self._wire_opt is not None:     # every field of the wire state afresh
            st.opt_state = self._wire_opt.init(st.master if st.master is not None
                                               else st.params)
        else:
            st.opt_state = opt._replace(count=0 if fresh else int(state.opt_state.count))
        st.global_step = int(state.global_step)
        st.scaler = dataclasses.replace(state.scaler)
        if st.grad_acc is not None:
            torch._foreach_zero_(list(st.grad_acc.values()))

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        """Save the state under `save_dir/tag` (by default
        `global_step{N}`); every rank calls it. `exclude_frozen_parameters`
        is accepted for the JAX signature: every parameter trains."""
        return checkpointing.save_checkpoint(self, save_dir, tag=tag, client_state=client_state,
                                             save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False, custom_load_fn=None):
        """Load `load_dir/tag` (by default the `latest` tag) at this
        engine's dp; every rank calls it. Returns (path, client_state).
        `load_module_strict` and `custom_load_fn` are accepted for the JAX
        signature, which does not use them either."""
        return checkpointing.load_checkpoint(
            self, load_dir, tag=tag, load_optimizer_states=load_optimizer_states,
            load_module_only=load_module_only,
            load_lr_scheduler_states=load_lr_scheduler_states)

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin",
                         exclude_frozen_parameters=False):
        """The model-dtype parameters whole in one file by rank 0 (a
        collective over the data ranks)."""
        return checkpointing.save_16bit_model(self, save_dir, save_filename)

    def _put_batch(self, batch):
        if isinstance(batch, dict):
            return {k: self._put_batch(v) for k, v in batch.items()}
        return torch.as_tensor(np.asarray(batch) if not torch.is_tensor(batch) else batch,
                               device=self.device)

    # ----------------------------------------------------- micro and boundary
    def _accumulate(self) -> bool:
        """Fold the module's gradients (of the scaled loss / GAS) into the
        f32 `grad_acc`; under fp16 an overflowing micro adds nothing and is
        recorded in the scaler. Returns the micro's overflow flag."""
        if self.units is not None:
            return self._accumulate_sharded()
        st = self.state
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in st.params.items()}
        ovf = False
        if self.loss_scaler.enabled:      # the wire's gradients are this rank's own
            ovf = self.loss_scaler.check_overflow(grads.values(), self._sync_group())
            st.scaler = self.loss_scaler.track_micro(st.scaler, ovf)
        with torch.no_grad():
            if st.grad_acc is None:
                st.grad_acc = {k: torch.zeros_like(g, dtype=torch.float32) if ovf
                               else g.float() for k, g in grads.items()}
            elif not ovf:
                for k, g in grads.items():
                    st.grad_acc[k].add_(g)
        for p in st.params.values():
            p.grad = None
        return ovf

    def _sync_group(self):
        """The ranks a micro's gradient flags are reduced over: every batch
        rank, or this rank alone (one rank)."""
        return BATCH_AXES if self.batch_dp > 1 else None

    @torch.no_grad()
    def _accumulate_sharded(self) -> bool:
        """`_accumulate` over dp data ranks: the micro's gradients reduced
        in f32 and averaged (stage 3's gathered units already reduced
        theirs in backward; under qgZ the sharded leaves in one stacked
        quantized exchange), checked for an overflow on every rank at once,
        then added to this rank's `grad_acc`."""
        st, params = self.state, self._module_params
        micro = []          # (ZeroUnit or leaf name, the micro's mean gradient)
        sharded = [u.sharded for u in self.units if u.sharded is not None]
        stacked = None
        if sharded and sharded[0].zeropp and sharded[0].zeropp["grads"]:
            stacked = stacked_reduce_scatter(
                sharded, {n: params[n].grad for s in sharded for n in s.names},
                reciprocal=sharded[0].zeropp["reciprocal"], device=self.device)
        for u in self.units:
            g, s = u.gathered, u.sharded
            if g is not None and g.stash:
                micro.append((g, g.pending if g.pending is not None else
                              torch.zeros(g.size, dtype=torch.float32, device=self.device)))
                g.pending = None
            elif g is not None and g.grad_acc is None:   # a unit the loss did not use
                g.grad_acc = torch.zeros(g.size, dtype=torch.float32, device=self.device)
            if s is not None:
                micro.append((s, stacked[s] if stacked is not None else s.reduce_scatter(
                    [params[n].grad for n in s.names], self.device)))
            if u.whole:
                flat = torch.cat([(params[n].grad if params[n].grad is not None
                                   else torch.zeros_like(params[n])).float().reshape(-1)
                                  for n in u.whole])
                comm.all_reduce(flat, group=BATCH_AXES).mul_(1.0 / self.batch_dp)
                micro += [(n, t.view_as(params[n])) for n, t in
                          zip(u.whole, flat.split([params[n].numel() for n in u.whole]))]
        ovf = False
        if self.loss_scaler.enabled:
            ovf = self.loss_scaler.check_overflow([t for _, t in micro], group=BATCH_AXES)
            st.scaler = self.loss_scaler.track_micro(st.scaler, ovf)
        if self._whole_acc is None:
            self._whole_acc = {}
        for key, grad in micro:
            if ovf:
                grad.zero_()
            if isinstance(key, ZeroUnit):
                key.grad_acc = grad if key.grad_acc is None else key.grad_acc.add_(grad)
            elif key in self._whole_acc:
                self._whole_acc[key].add_(grad)
            else:
                self._whole_acc[key] = grad
        for p in params.values():
            p.grad = None
        st.grad_acc = self._grad_tree()
        return ovf

    @torch.no_grad()
    def _sharded_update(self, lr) -> None:
        """The optimizer on this rank's pieces, then the model-dtype
        parameters from them: stage 3's pieces in place, a whole-parameter
        unit's by one all-gather."""
        st, dt = self.state, self.model_dtype
        target = self._update_target()
        _, st.opt_state = self.opt.update(st.grad_acc, st.opt_state, target, lr)
        for u in self.units:
            g, s = u.gathered, u.sharded
            if g is not None and self.mixed_precision:
                g.shard.copy_(g.master)
            if s is not None:
                for n, w in zip(s.names, s.all_gather(s.master.to(dt))):
                    self._module_params[n].copy_(w)
            if self.mixed_precision:
                for n in u.whole:
                    self._module_params[n].copy_(st.master[n])

    def _grad_lists(self):
        """The accumulated gradients as (whole on every rank, this rank's
        pieces)."""
        if self.units is None:
            return list(self.state.grad_acc.values()), []
        return (list((self._whole_acc or {}).values()),
                [f.grad_acc for f in self._flat_units()])

    @torch.no_grad()
    def _take_model_step(self) -> torch.Tensor:
        """Unscale, clip, optimizer update, loss-scale update. Returns the
        pre-clip global grad norm (a 0-d device tensor)."""
        cfg, st = self.config, self.state
        if st.grad_acc is None:
            raise RuntimeError("step() before any forward(): no accumulated gradients")
        whole, sharded = self._grad_lists()
        grads = whole + sharded
        group = self._sync_group()
        overflow = scale_overflow = False
        if self.loss_scaler.enabled:
            # bad micros were zeroed on arrival; the boundary check guards
            # the accumulation itself
            window_ovf = st.scaler.window_overflow > 0
            boundary_ovf = self.loss_scaler.check_overflow(grads, group)
            if cfg.fp16.per_micro_overflow_skip:
                good = st.scaler.good_micros
                overflow = boundary_ovf or good == 0
                scale_overflow = window_ovf or boundary_ovf
                renorm = cfg.gradient_accumulation_steps / max(good, 1)
            else:
                overflow = scale_overflow = window_ovf or boundary_ovf
                renorm = 1.0
            torch._foreach_mul_(grads, renorm / st.scaler.scale)
        grad_norm = self._wire_grad_norm() if self._wire_opt is not None else \
            global_grad_norm(whole, sharded)
        if cfg.gradient_clipping > 0.0:
            torch._foreach_mul_(grads, clip_factor(grad_norm, cfg.gradient_clipping))
        lr = self.lr_fn(st.global_step)
        if not overflow and self._wire_opt is not None:
            target = st.master if self.mixed_precision else st.params
            _, st.opt_state = self._wire_opt.update_local(st.grad_acc, st.opt_state, target,
                                                          lr, self._sync_group())
            if self.mixed_precision:
                for k, p in st.params.items():
                    p.copy_(st.master[k])
            st.global_step += 1
        elif not overflow and self.units is not None:
            self._sharded_update(lr)
            st.global_step += 1
        elif not overflow:
            target = st.master if self.mixed_precision else st.params
            _, st.opt_state = self.opt.update(st.grad_acc, st.opt_state, target, lr)
            if self.mixed_precision:
                for k, p in st.params.items():
                    p.copy_(st.master[k])
            st.global_step += 1
        if self._elide_grad_acc:
            st.grad_acc = None
            if self.units is not None:
                self._whole_acc = None
                for f in self._flat_units():
                    f.grad_acc = None
        else:
            torch._foreach_zero_(grads)
        if self.loss_scaler.enabled:
            st.scaler = self.loss_scaler.update(st.scaler, scale_overflow, skipped=overflow)
        self._grad_norm = grad_norm
        return grad_norm

    def _wire_grad_norm(self) -> torch.Tensor:
        """The norm of the ranks' mean gradient (the JAX step's norm of the
        worker mean): the gradients averaged a run of leaves at a time in
        one all-reduce each, then squared and summed."""
        from deepspeed_tpu_torch.ops.optimizers import _chunks
        grads, total = self.state.grad_acc, torch.zeros((), device=self.device)
        for names in _chunks(grads):
            flat = torch.cat([grads[k].reshape(-1) for k in names])
            if self.batch_dp > 1:
                comm.all_reduce(flat, op=comm.ReduceOp.AVG, group=BATCH_AXES)
            total += flat.square().sum()
        return total.sqrt()

    # ------------------------------------------------------------ user surface
    def __call__(self, batch):
        return self.forward(batch)

    def _next_rng(self) -> torch.Generator:
        """The micro-batch's generator: seeded with `seed + micro_steps`."""
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(self.config.seed + self.micro_steps)

    def _loss(self, batch):
        args = (self.module, self._put_batch(batch))
        if self._loss_takes_rng:
            args += (self._next_rng(),)
        if self._wire_opt is not None or self.config.zero_config.quantized:
            from deepspeed_tpu_torch.models.common import rank_local_loss
            with rank_local_loss():     # the JAX manual regions' loss
                return _split_loss(self.loss_fn(*args))
        return _split_loss(self.loss_fn(*args))

    def forward(self, batch) -> torch.Tensor:
        """The loss of one micro-batch, with its autograd graph."""
        return self._loss(batch)[0]

    def backward(self, loss: torch.Tensor, retain_graph: bool = False) -> torch.Tensor:
        """Gradients of loss / GAS (times the loss scale) into `grad_acc`."""
        self._backward(loss, retain_graph)
        return loss

    def _backward(self, loss: torch.Tensor, retain_graph: bool = False) -> bool:
        gas = self.config.gradient_accumulation_steps
        self.loss_scaler.scale_loss(loss / gas, self.state.scaler).backward(
            retain_graph=retain_graph)
        ovf = self._accumulate()
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu() * self.batch_dp
        return ovf

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.config.gradient_accumulation_steps == 0

    def step(self) -> None:
        """The optimizer step, at a GAS boundary only."""
        if not self.is_gradient_accumulation_boundary():
            return
        self._take_model_step()
        self.global_steps += 1
        self.lr_scheduler.step()

    def _micro_batches(self, data_iter=None, batch=None):
        """The GAS micro-batches of one step: drawn from `data_iter` (or the
        engine's dataloader), or cut from `batch` by the JAX fold rules."""
        gas = self.config.gradient_accumulation_steps
        if batch is None:
            it = data_iter if data_iter is not None else iter(self.training_dataloader)
            return [next(it) for _ in range(gas)]
        batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                 for k, v in batch.items()}
        leaf0 = next(iter(batch.values()))
        lead = leaf0.shape[0]
        local_rows = self.config.train_batch_size // self.batch_dp   # this rank's rows
        micro_rows = max(1, local_rows // gas)
        fold = True
        if lead == gas:
            # a flat batch of GAS rows or micros already stacked: flat iff it
            # has the configured rows and its second dim is not the micro size
            fold = lead == local_rows and not (leaf0.dim() >= 2
                                               and leaf0.shape[1] == micro_rows)
        elif lead % gas == 0:
            if lead != local_rows:
                logger.warning(f"train_batch got {lead} rows but the config "
                               f"triangulates to {local_rows}; training proceeds "
                               "with the given batch")
        else:
            raise ValueError(f"train_batch got leading dim {lead}, not divisible by "
                             f"gradient_accumulation_steps={gas}")
        if fold:
            batch = {k: v.reshape((gas, v.shape[0] // gas) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
        return [{k: v[i] for k, v in batch.items()} for i in range(gas)]

    def train_batch(self, data_iter=None, batch=None) -> torch.Tensor:
        """One full step: GAS micro-batches forward and backward, then the
        optimizer. Returns the mean micro loss (over the finite micros under
        fp16 per-micro overflow skip)."""
        losses, ovfs = [], []
        for micro in self._micro_batches(data_iter, batch):
            loss = self.forward(micro)
            ovfs.append(self._backward(loss))
            losses.append(loss.detach().float())
        self._take_model_step()
        self.global_steps += 1
        self.lr_scheduler.step()
        losses = torch.stack(losses)
        if self.batch_dp > 1:     # each rank's share of the global loss
            comm.all_reduce(losses, op=comm.ReduceOp.AVG, group=BATCH_AXES)
        if self.loss_scaler.enabled and self.config.fp16.per_micro_overflow_skip:
            good = torch.isfinite(losses) & ~torch.tensor(ovfs, device=losses.device)
            loss = torch.where(good, losses, 0.0).sum() / good.float().sum().clamp(min=1.0)
        else:
            loss = losses.mean()
        return loss

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """The loss of this rank's rows of one batch, over dp data ranks
        averaged into the global batch's."""
        loss = self._loss(batch)[0]
        if self.batch_dp > 1:
            comm.all_reduce(loss, op=comm.ReduceOp.AVG, group=BATCH_AXES)
        return loss

    # ---------------------------------------------------------------- accessors
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self) -> int:
        return self.config.zero_config.stage

    def zero_optimization(self) -> bool:
        return self.config.zero_enabled

    def get_lr(self):
        """The lr the next step takes: the schedule at `state.global_step`,
        which skipped steps do not advance."""
        return [float(self.lr_fn(self.state.global_step))]

    @property
    def skipped_steps(self) -> int:
        """Steps skipped for an fp16 overflow."""
        return self.state.scaler.overflows

    @property
    def cur_scale(self) -> float:
        return float(self.state.scaler.scale)

    def get_global_grad_norm(self) -> float:
        """The last step's pre-clip global grad norm."""
        if self._grad_norm is not None:
            return float(self._grad_norm)
        if self.state.grad_acc is None:
            return 0.0
        return float(global_grad_norm(*self._grad_lists()))
