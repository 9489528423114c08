"""Rank processes for the port's data-parallel tests on the CPU.

Started by `tests/torch_tp_ranks.py:spawn` (two processes, three or four,
a `gloo` group), each rank installs `MeshTopology()` (every rank on
`data`) and runs one of the scenarios below: the ZeRO stages, checkpoints
saved and resumed across data ranks, and the MoE and zoo families'
training; or,
through `zeropp_scenarios`, leaves the topology to `initialize` (MiCS and
hpZ build `repl` x `data` from the config) and runs ZeRO++, MiCS and the
1-bit wire. Like that
module, this one imports no JAX: the test process runs the JAX side and
hands the ranks numpy weights and batches.
"""

from __future__ import annotations

import numpy as np
import torch

DP = 2


def _install():
    from deepspeed_tpu_torch.utils import groups
    return groups.initialize(groups.MeshTopology())


def data_collectives(rank):
    """`comm`'s data-axis collectives on this rank's CPU tensors, f32 and
    bf16."""
    return _collectives(rank, "cpu")


def data_collectives_on_card(rank):
    """The same collectives on CUDA tensors of the one card (gloo)."""
    return _collectives(rank, "cuda")


def _collectives(rank, device):
    from deepspeed_tpu_torch import comm
    topo = _install()
    out = dict(dp=topo.dp_size, coord=topo.coord("data"), sizes=topo.sizes)
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1) - 5 * rank
    for dtype in (torch.float32, torch.bfloat16):
        t = x.to(device=device, dtype=dtype)
        key = str(dtype).split(".")[-1]
        for op in ("sum", "avg", "max", "min"):
            out[f"{op}_{key}"] = comm.all_reduce(t.clone(), op=op, group="dp").cpu()
        out[f"scatter0_{key}"] = comm.reduce_scatter(t, group="data").cpu()
        out[f"scatter1_{key}"] = comm.reduce_scatter(t, group="data", scatter_dim=1).cpu()
        into = torch.empty((8, 6), dtype=dtype, device=device)
        got = comm.all_gather_into(into, t, group="data")
        out[f"gather_into_{key}"] = (got.data_ptr() == into.data_ptr(), got.cpu())
    out["stats"] = comm.comm_stats()
    return out


def wire_collectives(rank):
    """The quantized reduce-scatter and all-gather (both scale forms) and
    the compressed all-reduce on this rank's CPU tensors."""
    return _wire(rank, "cpu")


def wire_collectives_on_card(rank):
    """The same on CUDA tensors of the one card (gloo)."""
    return _wire(rank, "cuda")


def _wire(rank, device):
    from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc
    from deepspeed_tpu_torch.runtime.comm import compressed as cp
    _install()
    gen = torch.Generator().manual_seed(11 + rank)
    x = torch.randn((6, 1000), generator=gen).to(device)
    e = 0.1 * torch.randn((6, 1000), generator=gen).to(device)
    out = {}
    for reciprocal in (False, True):
        out[f"rs_{reciprocal}"] = cc.quantized_reduce_scatter(x, "data", 0,
                                                              reciprocal=reciprocal).cpu()
        out[f"rs1_{reciprocal}"] = cc.quantized_reduce_scatter(x, "data", 1,
                                                               reciprocal=reciprocal).cpu()
        out[f"ag_{reciprocal}"] = cc.quantized_all_gather(x, "data", 0,
                                                          reciprocal=reciprocal).cpu()
    avg, err = cp.compressed_allreduce(x, e, "data")
    out.update(cr_avg=avg.cpu(), cr_err=err.cpu())
    return out


# ------------------------------------------------------------ the engine

def _engine(tree, config, dtype, remat, loss_fn=None, **overrides):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config, llama_loss_fn
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=dtype, attn_impl="pallas",
                                          remat=remat, **overrides))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=tree, config=config,
        loss_fn=loss_fn or llama_loss_fn(model), device="cpu")
    return engine


def rank_rows(x, rank, gas, dp=DP):
    """This rank's rows of a global batch of GAS micros, as the JAX engine's
    `data`-sharded batch gives them: of each global micro, rows
    [rank * micro, (rank + 1) * micro)."""
    x = np.asarray(x)
    micros = x.reshape((gas, dp, x.shape[0] // (gas * dp)) + x.shape[1:])
    return micros[:, rank].reshape((-1,) + x.shape[1:])


def _whole_tree(engine, tensors=None):
    """`materialized_state()`'s params (or `tensors`, whole leaves by name)
    as a JAX tree of numpy arrays."""
    from deepspeed_tpu_torch.models.llama import to_jax_params
    params = engine.materialized_state().params if tensors is None else tensors
    model = type(engine.module)(engine.module.cfg, device="meta")
    model.load_state_dict({k: v.detach().float().clone() for k, v in params.items()},
                          assign=True)
    return to_jax_params(model)


def _sizes(engine):
    """Per leaf: the elements this rank holds of its params, first moment,
    grad_acc and master (None where the state has none)."""
    st = engine.state
    moments = st.opt_state.exp_avg
    return {n: (st.params[n].numel(), moments[n].numel(),
                st.grad_acc[n].numel() if st.grad_acc is not None else None,
                None if st.master is None else st.master[n].numel())
            for n in st.params}


def train(rank, tree, config, batches, remat=True):
    """Three `train_batch` steps on this rank's rows: per-step (loss, grad
    norm), the final whole parameters, the state's sizes and whether the
    module's sharded leaves hold nothing (stage 3)."""
    engine = _engine(tree, config, torch.float32, remat)
    gas = engine.gradient_accumulation_steps()
    steps = []
    for batch in batches:
        loss = engine.train_batch(batch={k: rank_rows(v, rank, gas) for k, v in batch.items()})
        steps.append((float(loss), engine.get_global_grad_norm()))
    empty = sorted(n for n, p in engine.module.named_parameters() if p.numel() == 0)
    return dict(steps=steps, tree=_whole_tree(engine), sizes=_sizes(engine), empty=empty,
                global_samples=engine.global_samples)


def _poisoned(base):
    def fn(module, batch):
        loss, aux = base(module, {"input_ids": batch["input_ids"]})
        return loss * batch["poison"].max(), aux
    return fn


def train_fp16(rank, tree, config, batches):
    """fp16 steps with infs in one rank's rows: per step the skipped count,
    scale, global_step, next lr and loss."""
    from deepspeed_tpu_torch.models.llama import llama_loss_fn
    engine = _engine(tree, config, torch.float16, True, _poisoned(llama_loss_fn()))
    gas = engine.gradient_accumulation_steps()
    got = []
    for batch in batches:
        loss = engine.train_batch(batch={k: rank_rows(v, rank, gas) for k, v in batch.items()})
        got.append((engine.skipped_steps, engine.cur_scale, engine.state.global_step,
                    engine.get_lr()[0], float(loss)))
    return got


def _steps(engine, batches, rank):
    """`train_batch` on this rank's rows of each global batch: per step
    (loss, pre-clip grad norm, the next lr)."""
    from deepspeed_tpu_torch import comm
    gas, dp = engine.gradient_accumulation_steps(), comm.get_world_size("data")
    out = []
    for batch in batches:
        loss = engine.train_batch(batch={k: rank_rows(v, rank, gas, dp) for k, v in batch.items()})
        out.append((float(loss), engine.get_global_grad_norm(), engine.get_lr()[0]))
    return out


def resume(rank, trees, start, config, batches, load_dir=None, save_dir=None,
           dtype="float32", overrides=None):
    """The tiny Llama (with `overrides`) built from `trees[start]`, loaded
    from `load_dir` when given, trained on `batches`, then saved to
    `save_dir` when given: the steps, the whole parameters and master
    (`materialized_state()`), the counters, and the bytes this rank's
    files hold."""
    import os

    from deepspeed_tpu_torch.runtime.checkpointing import (
        MODEL_STATES, OPTIM_STATES, WHOLE_FILE, rank_file)
    engine = _engine(trees[start], config, getattr(torch, dtype), True, **(overrides or {}))
    if load_dir is not None:
        engine.load_checkpoint(load_dir)
    steps = _steps(engine, batches, rank)
    out = dict(steps=steps, tree=_whole_tree(engine), micro_steps=engine.micro_steps,
               global_samples=engine.global_samples, global_step=engine.state.global_step)
    master = engine.materialized_state().master
    out["master"] = None if master is None else {k: v.cpu() for k, v in master.items()}
    if save_dir is not None:
        path = engine.save_checkpoint(save_dir)
        mine = [os.path.join(path, d, rank_file(rank)) for d in (MODEL_STATES, OPTIM_STATES)]
        if rank == 0:
            mine += [os.path.join(path, d, WHOLE_FILE) for d in (MODEL_STATES, OPTIM_STATES)]
        out["bytes"] = sum(os.path.getsize(f) for f in mine if os.path.exists(f))
    return out


# The zoo's families at the widths of their kernels: family -> (preset,
# overrides, attn_impl), one config on both sides. phi's heads are 80 wide
# and GPT-NeoX's 256 (phi-2's and pythia-1b's), both on the flash path;
# BLOOM's alibi takes the masked path.
ZOO = {"phi": ("phi-tiny", dict(hidden_size=160, num_attention_heads=2,
                                num_key_value_heads=2), "pallas"),
       "neox": ("neox-tiny", dict(hidden_size=512, num_attention_heads=2), "pallas"),
       "bloom": ("bloom-tiny", {}, "auto")}


def zoo_model(family, device=None, remat=True, **overrides):
    """A zoo family's 2-layer model (`ZOO`) in f32, and its loss function."""
    from deepspeed_tpu_torch.models import bloom, gptneox, phi
    cls, config_fn, loss_fn = {
        "phi": (phi.PhiForCausalLM, phi.phi_config, phi.phi_loss_fn),
        "neox": (gptneox.GPTNeoXForCausalLM, gptneox.gptneox_config, gptneox.gptneox_loss_fn),
        "bloom": (bloom.BloomForCausalLM, bloom.bloom_config, bloom.bloom_loss_fn)}[family]
    preset, base, attn = ZOO[family]
    model = cls(config_fn(preset, dtype=torch.float32, remat=remat,
                          **{**base, "attn_impl": attn, **overrides}), device=device)
    return model, loss_fn(model)


def zoo_engine(family, tree, config, remat=True, **overrides):
    """The port's engine over a zoo family's 2-layer model (`zoo_model`),
    built from the JAX tree `tree`, remat on unless asked otherwise."""
    import deepspeed_tpu_torch
    model, loss_fn = zoo_model(family, remat=remat, **overrides)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=tree,
                                                config=config, loss_fn=loss_fn, device="cpu")
    return engine


def train_zoo(rank, trees, family, config, batches):
    """A zoo family (`ZOO`) at dp ranks on this rank's rows: per step
    (loss, pre-clip grad norm, the next lr), the final whole parameters and
    whether the module's sharded leaves hold nothing (stage 3)."""
    engine = zoo_engine(family, trees[family], config)
    steps = _steps(engine, batches, rank)
    empty = sorted(n for n, p in engine.module.named_parameters() if p.numel() == 0)
    return dict(steps=steps, tree=_whole_tree(engine), empty=empty)


def _moe_engine(family, tree, config, dispatch, overrides):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import mixtral, qwen2_moe
    if family == "qwen2moe":
        model = qwen2_moe.Qwen2MoeForCausalLM(qwen2_moe.qwen2_moe_config(
            "qwen2moe-tiny", dtype=torch.float32, dispatch_impl=dispatch, **overrides))
        loss_fn = qwen2_moe.qwen2_moe_loss_fn(model)
    else:
        model = mixtral.MixtralForCausalLM(mixtral.mixtral_config(
            "mixtral-tiny", dtype=torch.float32, dispatch_impl=dispatch, **overrides))
        loss_fn = mixtral.mixtral_loss_fn(model)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=tree,
                                                config=config, loss_fn=loss_fn, device="cpu")
    return engine


def train_moe(rank, trees, family, config, dispatch, batches, overrides):
    """An MoE family (its tiny preset with `overrides`) at dp ranks on this
    rank's rows: per step (loss, the micros' mean aux loss and router drop
    share, pre-clip grad norm), and the final whole parameters."""
    engine = _moe_engine(family, trees[family], config, dispatch, overrides)
    seen, loss_fn = [], engine.loss_fn

    def recording(module, batch, rng=None):
        loss, aux = loss_fn(module, batch, rng)
        seen.append((float(aux["moe_aux_loss"]), float(aux["router_drop"].mean())))
        return loss, aux

    engine.loss_fn = recording
    steps = []
    for batch in batches:
        seen.clear()
        loss = _steps(engine, [{"input_ids": batch}], rank)[0][0]
        aux, drop = np.mean(seen, axis=0)
        steps.append((loss, float(aux), float(drop), engine.get_global_grad_norm()))
    return dict(steps=steps, tree=_whole_tree(engine))


NOISE_SEED = 7


def gate_noise(rank, _tree):
    """The noisy gate's uniforms for 16 tokens of 4 experts from one seed,
    drawn twice."""
    from deepspeed_tpu_torch.moe.sharded_moe import gate_noise as draw
    first, again = (draw((16, 4), torch.Generator().manual_seed(NOISE_SEED)) for _ in range(2))
    return dict(first=first, again=again)


def scenarios(rank, tree, runs):
    """Every run of `runs` ({name: (kind, args)}) in turn, in one process."""
    _install()
    fns = {"train": train, "fp16": train_fp16, "resume": resume, "moe": train_moe,
           "noise": gate_noise, "zoo": train_zoo}
    return {name: fns[kind](rank, tree, *args) for name, (kind, args) in runs.items()}


# ------------------------------------------------- ZeRO++, MiCS, the 1-bit wire

def quantized_collectives(rank, _tree, cases):
    """The quantized reduce-scatter and all-gather (the reciprocal scale
    form) on this rank's part of each case ((p, *shape) numpy, scatter
    dim), with the bytes counted."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc
    _install()
    out = []
    for x, dim in cases:
        mine = torch.from_numpy(np.asarray(x[rank]))
        comm.reset_comm_stats()
        rs = cc.quantized_reduce_scatter(mine, "data", dim, reciprocal=True)
        ag = cc.quantized_all_gather(mine, "data", dim, reciprocal=True)
        out.append(dict(rs=rs, ag=ag, stats=comm.comm_stats()))
    return out


def compressed(rank, _tree, xs, errors):
    """`compressed_allreduce` and `compressed_allreduce_many` on this rank's
    tensors and errors."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.comm import compressed as cp
    _install()
    x = [torch.from_numpy(np.asarray(a[rank])) for a in xs]
    e = [torch.from_numpy(np.asarray(a[rank])) for a in errors]
    comm.reset_comm_stats()
    one = [cp.compressed_allreduce(a, b, "data") for a, b in zip(x, e)]
    stats = comm.comm_stats()
    many = cp.compressed_allreduce_many(x, e, "data")
    return dict(one=one, many=many, stats=stats)


def _wide_engine(tree, config, overrides, dtype=torch.float32):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config, llama_loss_fn
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=dtype, **overrides))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=tree,
                                                config=config, loss_fn=llama_loss_fn(model),
                                                device="cpu")
    return engine


def _pieces(engine):
    """This rank's tensors of each state field (pieces where sharded)."""
    st = engine.state
    out = {"params": {k: v.detach().clone() for k, v in st.params.items()}}
    if isinstance(getattr(st.opt_state, "exp_avg", None), dict):
        out["exp_avg"] = {k: v.clone() for k, v in st.opt_state.exp_avg.items()}
    return out


def zeropp_train(rank, tree, config, batches, overrides, save_dir=None, save_after=None,
                 first_grads=False):
    """`train_batch` on this rank's rows of each global batch (the ranks of
    `repl` x `data`): per step (loss, pre-clip norm), the whole parameters
    after the first step and at the end, this rank's pieces, the wire's
    bytes by kind over the run, the first step's accumulated gradient whole
    (`first_grads`), and a save after step `save_after` into `save_dir`."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils.groups import BATCH_AXES
    engine = _wide_engine(tree, config, overrides)
    topo = engine.topology
    gas, dp = engine.gradient_accumulation_steps(), engine.batch_dp
    where = topo.coord(BATCH_AXES)
    out = dict(coords=topo.coords, steps=[], grads=None)
    if first_grads:
        take = engine._take_model_step

        def snapshot():
            if out["grads"] is None:
                out["grads"] = _whole_tree(engine, engine.materialized_state().grad_acc)
            return take()
        engine._take_model_step = snapshot
    comm.reset_comm_stats()
    for i, batch in enumerate(batches):
        loss = engine.train_batch(batch={k: rank_rows(v, where, gas, dp)
                                         for k, v in batch.items()})
        out["steps"].append((float(loss), engine.get_global_grad_norm()))
        if i == 0:
            out["tree1"] = _whole_tree(engine)
        if save_dir is not None and i == save_after:
            engine.save_checkpoint(save_dir)
    out["stats"] = comm.comm_stats()
    out["tree"] = _whole_tree(engine)
    out["pieces"] = _pieces(engine)
    if engine._wire_opt is not None:
        st = engine.state.opt_state
        out["wire"] = {f: ({k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x)
                       for f, x in zip(st._fields, st)}
    return out


def zeropp_resume(rank, tree, config, batches, overrides, load_dir, wait_s=0.0):
    """A fresh engine (from `tree`) loads `load_dir` and trains on this
    rank's rows: its steps, whole parameters and the wire state. With
    `wait_s`, the save may still be under way in other processes: the load
    waits up to that long for its `latest` file."""
    import time

    from deepspeed_tpu_torch.runtime.checkpointing import read_latest
    from deepspeed_tpu_torch.utils.groups import BATCH_AXES
    deadline = time.monotonic() + wait_s
    while wait_s and not read_latest(load_dir):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint in {load_dir} after {wait_s} s")
        time.sleep(0.2)
    engine = _wide_engine(tree, config, overrides)
    engine.load_checkpoint(load_dir)
    gas, dp = engine.gradient_accumulation_steps(), engine.batch_dp
    where = engine.topology.coord(BATCH_AXES)
    steps = []
    for batch in batches:
        loss = engine.train_batch(batch={k: rank_rows(v, where, gas, dp)
                                         for k, v in batch.items()})
        steps.append((float(loss), engine.get_global_grad_norm()))
    out = dict(steps=steps, tree=_whole_tree(engine))
    if engine._wire_opt is not None:
        st = engine.state.opt_state
        out["wire"] = {f: ({k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x)
                       for f, x in zip(st._fields, st)}
    return out


def zeropp_scenarios(rank, tree, runs):
    """Every run of `runs` ({name: (kind, args)}) in turn, each under the
    topology `initialize` builds from its config (installed afresh), or
    the flat one (`kind` "collectives", "compressed")."""
    from deepspeed_tpu_torch.utils import groups
    fns = {"train": zeropp_train, "resume": zeropp_resume,
           "collectives": quantized_collectives, "compressed": compressed}
    out = {}
    for name, (kind, args) in runs.items():
        groups.reset_topology()
        out[name] = fns[kind](rank, tree, *args)
    return out
