"""Rank processes for the port's data-parallel tests on the CPU.

Started by `tests/torch_tp_ranks.py:spawn` (two processes, a `gloo` group),
each rank installs `MeshTopology(dp=2)` and runs one of the scenarios
below. Like that module, this one imports no JAX: the test process runs
the JAX side and hands the ranks numpy weights and batches.
"""

from __future__ import annotations

import numpy as np
import torch

DP = 2


def _install():
    from deepspeed_tpu_torch.utils import groups
    return groups.initialize(groups.MeshTopology(dp=DP))


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

def _engine(tree, config, dtype, remat, loss_fn=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config, llama_loss_fn
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=dtype, attn_impl="pallas",
                                          remat=remat))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=tree, config=config,
        loss_fn=loss_fn or llama_loss_fn(model), device="cpu")
    return engine


def rank_rows(x, rank, gas):
    """This rank's rows of a global batch of GAS micros, as the JAX engine's
    `data`-sharded batch gives them: of each global micro, rows
    [rank * micro, (rank + 1) * micro)."""
    x = np.asarray(x)
    micros = x.reshape((gas, DP, x.shape[0] // (gas * DP)) + x.shape[1:])
    return micros[:, rank].reshape((-1,) + x.shape[1:])


def _whole_tree(engine):
    """`materialized_state()`'s params as a JAX tree of numpy arrays."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, to_jax_params
    params = engine.materialized_state().params
    model = LlamaForCausalLM(engine.module.cfg, device="meta")
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


def scenarios(rank, tree, runs):
    """Every run of `runs` ({name: (kind, args)}) in turn, in one process."""
    _install()
    fns = {"train": train, "fp16": train_fp16}
    return {name: fns[kind](rank, tree, *args) for name, (kind, args) in runs.items()}
