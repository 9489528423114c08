"""Rank processes for the port's tensor-parallel tests on the CPU.

`spawn(fn, *args, tmp_path=...)` starts two processes (`world`) with the
spawn context, joins them in a `gloo` process group through a `file://`
rendezvous under `tmp_path` (so parallel test workers never share a port),
runs `fn(rank, *args)` in each, and returns each rank's result in rank
order (results travel through `torch.save` files). A rank that raises
fails the call with its traceback. This module imports no JAX, so a rank
starts in about two seconds; `fn` must be a module-level function of an
importable module that imports none either. `start` takes the same
arguments and returns at once, with a function that waits for the
results.
"""

from __future__ import annotations

import pathlib
import traceback

import torch
import torch.multiprocessing as mp

TP = 2


def _entry(rank: int, world: int, root: str, fn, args) -> None:
    from deepspeed_tpu_torch import comm
    torch.set_num_threads(1)
    out = pathlib.Path(root) / f"rank{rank}.pt"
    try:
        comm.init_distributed(dist_backend="gloo", init_method=f"file://{root}/rendezvous",
                              rank=rank, world_size=world, verbose=False)
        result = fn(rank, *args)
        comm.barrier()
        torch.save({"ok": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        comm.destroy_process_group()


def spawn(fn, *args, tmp_path, world: int = TP) -> list:
    return start(fn, *args, tmp_path=tmp_path, world=world)()


def start(fn, *args, tmp_path, world: int = TP):
    """`spawn` without waiting: starts the ranks and returns a function that
    waits for them and returns their results, as `spawn` does."""
    root = pathlib.Path(tmp_path) / f"ranks_{fn.__name__}"
    root.mkdir(parents=True, exist_ok=True)
    context = mp.start_processes(_entry, args=(world, str(root), fn, args), nprocs=world,
                                 start_method="spawn", join=False)

    def wait() -> list:
        errors = None
        try:
            while not context.join():
                pass
        except Exception as e:  # a rank's own traceback is in its file
            errors = e
        return _results(root, world, errors)
    return wait


def _results(root: pathlib.Path, world: int, errors) -> list:
    results = []
    for rank in range(world):
        path = root / f"rank{rank}.pt"
        got = torch.load(path, weights_only=False) if path.exists() else {"error": str(errors)}
        if "error" in got:
            raise RuntimeError(f"rank {rank} failed:\n{got['error']}")
        results.append(got["ok"])
    return results


# ---------------------------------------------------------------- scenarios
# Each runs in every rank, on the tiny Llama of `tests/test_torch_llama.py`
# (its `TINY` heads passed in `overrides`) in f32 on the CPU, served at
# tp = 2 from the whole numpy `tree`.

def count_calls(module, name, calls):
    """Wrap `module.name` to count its calls in `calls[name]` (the CPU
    takes the plain versions, which count no launch)."""
    fn = getattr(module, name)
    calls[name] = 0

    def counted(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)


def tiny_model(overrides):
    """A whole (tp = 1) tiny Llama, for the engines to cut."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
    return LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **overrides))


def serve_v1(rank, tree, overrides, ids, new):
    """v1 at tp = 2: `forward` logits, greedy and sampled `generate`, and
    the rank's shapes."""
    import deepspeed_tpu_torch
    eng = deepspeed_tpu_torch.init_inference(tiny_model(overrides), params=tree, dtype="fp32",
                                             device="cpu", tensor_parallel={"tp_size": TP})
    attn = eng.module.layers[0].self_attn
    return dict(
        logits=eng.forward(ids).numpy(),
        greedy=eng.generate(ids, max_new_tokens=new).numpy(),
        sampled=eng.generate(ids, max_new_tokens=new, temperature=0.9, top_k=8, seed=5).numpy(),
        heads=attn.heads, q_rows=tuple(attn.q_proj.weight.shape),
        embed_rows=eng.module.embed_tokens.shape[0], model_rank=eng.module.tp_rank,
        topology=(eng.topology.tp_size, eng.topology.coord("model")))


def v2_script(eng, prompts, new):
    """The same calls on either package's v2 engine → plain results:
    greedy tokens over more prompts than rows (chunked prefills beside
    decode rows, a shared prefix), then a put/decode/fork cycle's logits."""
    out = {"greedy": [list(map(int, r)) for r in eng.generate(prompts, max_new_tokens=new)]}
    prompt = list(prompts[1][::-1][:13])          # two chunks of 8
    eng.put([100], [np_int32(prompt)])
    logits = eng.put([], [])[100]
    step = eng.put([100], [np_int32([int(logits.argmax())])])[100]
    eng.fork(100, 101)
    both = eng.put([100, 101], [np_int32([int(step.argmax())])] * 2)
    out["put_logits"] = [as_f32(x) for x in (logits, step, both[100], both[101])]
    eng.flush(100)
    eng.flush(101)
    return out


def np_int32(x):
    import numpy as np
    return np.asarray(x, np.int32)


def as_f32(x):
    import numpy as np
    return np.asarray(x, np.float32)


def serve_v2(rank, tree, overrides, prompts, new, engine_kw):
    """v2 at tp = 2 on the paged cache: `v2_script`, the rank's pool
    heads, and a digest of the block tables and live uids at every sync."""
    import hashlib

    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    eng = InferenceEngineV2(tiny_model(overrides),
                            config=DeepSpeedInferenceConfig(dtype="fp32",
                                                            tensor_parallel={"tp_size": TP}),
                            params=tree, device="cpu", **engine_kw)
    digests = []
    sync = eng._maybe_sync_tables

    def recorded():
        uids = sorted(eng.state_manager.tracked_sequences)
        digests.append(hashlib.sha1(eng._tables_np.tobytes() + repr(uids).encode()).hexdigest())
        return sync()

    eng._maybe_sync_tables = recorded
    from deepspeed_tpu_torch.ops import attention
    calls = {}
    for name in ("sharded_paged_decode_attention", "sharded_paged_prefill_attention"):
        count_calls(attention, name, calls)
    out = v2_script(eng, prompts, new)
    out.update(digests=digests, pool_heads=eng.cache.k_pool.shape[1], calls=calls)
    return out


def serve_int8(rank, tree, overrides, ids, new, group):
    """int8 weights through the layer scan at tp = 2 with the fused
    dequant-GEMM's per-shard calls (K5's plain version on the CPU): the
    rank's int8 tree, `forward` logits, the scan's prefill logits, greedy
    tokens, and the kernel_fallback warnings seen."""
    import logging

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.kv_cache import KVCache
    from deepspeed_tpu_torch.models.llama import to_jax_params
    from deepspeed_tpu_torch.utils.logging import logger
    from deepspeed_tpu_torch.inference import quantized_layer_scan
    flavors = []
    fn = quantized_layer_scan.sharded_quantized_matmul
    quantized_layer_scan.sharded_quantized_matmul = \
        lambda x, q, s, flavor: flavors.append(flavor) or fn(x, q, s, flavor)
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger.addHandler(handler)
    try:
        eng = deepspeed_tpu_torch.init_inference(
            tiny_model(overrides), params=tree, dtype="fp32", device="cpu",
            tensor_parallel={"tp_size": TP}, quant={"enabled": True, "group_size": group},
            serve_mode="layer_scan", fused_int8=True)
        # the layer scan over the whole prompt, every position's logits (the
        # engine's generate asks it for the last position only)
        cfg = eng.model_cfg
        scan = quantized_layer_scan.make_scan_apply(cfg, fused=True, mesh=eng.topology)
        cache = KVCache.create(cfg.num_hidden_layers, ids.shape[0], 128,
                               cfg.num_key_value_heads // TP, cfg.head_dim,
                               dtype=torch.float32)
        with torch.inference_mode():
            scan_logits, _ = scan(eng.params, torch.as_tensor(ids), cache)
        out = dict(serve_mode=eng.serve_mode, tree=to_jax_params(eng.params),
                   logits=eng.forward(ids).numpy(), scan_logits=scan_logits.numpy(),
                   greedy=eng.generate(ids, max_new_tokens=new).numpy())
    finally:
        logger.removeHandler(handler)
    out["fallbacks"] = [m for m in seen if "kernel_fallback" in m]
    out["flavors"] = {f: flavors.count(f) for f in ("n", "k")}
    return out


def collectives(rank):
    """`comm`'s collectives by axis name under a tp = 2 topology."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils import groups
    groups.initialize(groups.MeshTopology(tp=TP))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out = dict(rank=comm.get_rank(), model_rank=comm.get_rank("model"),
               world=comm.get_world_size(), model_world=comm.get_world_size("tp"),
               backend=comm.get_backend(), local_rank=comm.get_local_rank())
    out["sum"] = comm.all_reduce(x.clone(), group="model")
    out["bf16_sum"] = comm.all_reduce(x.to(torch.bfloat16), group="model")
    out["gather_last"] = comm.all_gather(x, group="model", axis=-1)
    out["gather_first"] = comm.all_gather(x, group="model", axis=0)
    out["broadcast"] = comm.broadcast(x.clone(), src=1, group="model")
    comm.barrier("model")
    return out


def serve_shard_built(rank, trees, overrides, ids, new, group):
    """The route of ranks that build their own shards: a
    `LlamaForCausalLM(cfg, tp_size=2, tp_rank=rank)` given the rank's cut
    of the whole tree and served with no `params` (it keeps its weights),
    through v1 (`trees[0]`, `ids[0]`) and, quantizing its own shard, the
    int8 layer scan (`trees[1]`, `ids[1]`). Then a shard built for the
    other rank, which must be refused."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config, to_jax_params
    from deepspeed_tpu_torch.utils.partitioning import shard_tree
    cfg = llama_config("llama-tiny", dtype=torch.float32, **overrides)

    def shard(tree, r=rank):
        model = LlamaForCausalLM(cfg, tp_size=TP, tp_rank=r)
        model.load_jax_params(shard_tree(tree, TP, r))
        return model

    tp = {"tp_size": TP}
    eng = deepspeed_tpu_torch.init_inference(shard(trees[0]), dtype="fp32", device="cpu",
                                             tensor_parallel=tp)
    out = dict(logits=eng.forward(ids[0]).numpy(),
               greedy=eng.generate(ids[0], max_new_tokens=new).numpy())
    eng = deepspeed_tpu_torch.init_inference(
        shard(trees[1]), dtype="fp32", device="cpu", tensor_parallel=tp,
        quant={"enabled": True, "group_size": group}, serve_mode="layer_scan",
        fused_int8=True)
    out.update(int8_serve_mode=eng.serve_mode, int8_tree=to_jax_params(eng.params),
               int8_logits=eng.forward(ids[1]).numpy(),
               int8_greedy=eng.generate(ids[1], max_new_tokens=new).numpy())
    try:
        deepspeed_tpu_torch.init_inference(shard(trees[0], 1 - rank), dtype="fp32",
                                           device="cpu", tensor_parallel=tp)
    except ValueError as e:
        out["wrong_rank"] = str(e)
    return out
