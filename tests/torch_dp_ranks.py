"""Rank processes for the port's data-parallel tests on the CPU.

Started by `tests/torch_tp_ranks.py:spawn` (two processes, or three, a
`gloo` group), each rank installs `MeshTopology()` (every rank on `data`)
and runs one of the scenarios below: the ZeRO stages, checkpoints saved
and resumed across data ranks, and the MoE families' training. Like that
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


def _whole_tree(engine):
    """`materialized_state()`'s params as a JAX tree of numpy arrays."""
    from deepspeed_tpu_torch.models.llama import to_jax_params
    params = engine.materialized_state().params
    model = type(engine.module)(engine.module.cfg, device="meta")
    model.load_state_dict({k: v.float() for k, v in params.items()}, assign=True)
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
           "noise": gate_noise}
    return {name: fns[kind](rank, tree, *args) for name, (kind, args) in runs.items()}
