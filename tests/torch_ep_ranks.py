"""Rank processes for the port's expert-parallel tests on the CPU.

The scenarios run in each of the two `gloo` ranks that
`tests/torch_tp_ranks.py:spawn` starts, on the tiny Qwen2-MoE or Mixtral
(E = 4, k = 2) in f32 on the CPU, each rank holding experts [2·rank,
2·rank + 2) under `MeshTopology(ep=2)`. This module imports no JAX, so a
rank starts in about two seconds.
"""

from __future__ import annotations

import torch

EP = 2


def family(name):
    """(module class, config function, preset) of an MoE family."""
    if name == "qwen2_moe":
        from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM, qwen2_moe_config
        return Qwen2MoeForCausalLM, qwen2_moe_config, "qwen2moe-tiny"
    from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM, mixtral_config
    return MixtralForCausalLM, mixtral_config, "mixtral-tiny"


def _config(name, **overrides):
    _, config, preset = family(name)
    return config(preset, dtype=torch.float32, **overrides)


def _install():
    from deepspeed_tpu_torch.utils import groups
    groups.reset_topology()
    return groups.initialize(groups.MeshTopology(ep=EP, device="cpu"))


def _counted_routes():
    """Wrap the expert-parallel collectives and K8-e's wrapper (the CPU
    takes the plain versions, which count no launch) to count their calls."""
    import deepspeed_tpu_torch.comm as comm
    from deepspeed_tpu_torch.moe import layer
    calls = {}
    for owner, name in ((comm, "all_reduce"), (comm, "all_gather"),
                        (layer, "sharded_grouped_gemm")):
        fn = getattr(owner, name)
        calls[name] = 0

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        setattr(owner, name, counted)
    return calls


def serve_ep(rank, name, tree, ids, new):
    """v1 at ep = 2 from the whole numpy tree, with the dispatch left to
    `auto` and forced to `gmm` and `ragged`: for each, `forward` logits,
    greedy and sampled `generate`, the calls of each route; and the rank's
    expert shapes."""
    import deepspeed_tpu_torch
    topo = _install()
    cls = family(name)[0]
    calls = _counted_routes()
    out = dict(topology=(topo.ep_size, topo.coord("expert"), topo.tp_size))
    for impl in ("auto", "gmm", "ragged"):
        eng = deepspeed_tpu_torch.init_inference(cls(_config(name, dispatch_impl=impl)),
                                                 params=tree, dtype="fp32", device="cpu")
        experts = eng.module.layers[0].moe.experts
        calls.update(dict.fromkeys(calls, 0))
        logits = eng.forward(ids).numpy()
        forward_calls = dict(calls)
        calls.update(dict.fromkeys(calls, 0))
        greedy = eng.generate(ids, max_new_tokens=new).numpy()
        out[impl] = dict(
            logits=logits, greedy=greedy, forward_calls=forward_calls,
            generate_calls=dict(calls),
            sampled=eng.generate(ids, max_new_tokens=new, temperature=0.9, top_k=8,
                                 seed=5).numpy(),
            experts=(experts.num_experts, experts.first_expert, tuple(experts.up.shape)),
            module_rank=(eng.module.ep_size, eng.module.ep_rank))
    return out


def serve_shard_built(rank, name, cut_trees, ids, new):
    """The route of ranks that build their own shards: `cls(cfg, ep_size=2,
    ep_rank=rank)` given the rank's cut of the whole tree (`cut_trees[rank]`)
    and served with no `params` (it keeps its weights): `forward` logits,
    greedy tokens and the module's tree. Then a shard built for the other
    rank, and a call in grad mode (training), which must be refused."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import to_jax_params
    _install()
    cls = family(name)[0]

    def shard(r):
        return cls(_config(name), ep_size=EP, ep_rank=r).load_jax_params(cut_trees[r])

    model = shard(rank)
    eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu")
    out = dict(logits=eng.forward(ids).numpy(),
               greedy=eng.generate(ids, max_new_tokens=new).numpy(),
               tree=to_jax_params(eng.module))
    try:
        deepspeed_tpu_torch.init_inference(shard(1 - rank), dtype="fp32", device="cpu")
    except ValueError as e:
        out["wrong_rank"] = str(e)
    try:  # grad mode on weights that require grad: training under ep
        eng.module(torch.as_tensor(ids[:1, :8]))
    except NotImplementedError as e:
        out["train"] = str(e)
    return out


def reduce_orders(rank, x, sizes, stacks):
    """The grouped expert FFN on this rank's experts, all-reduced once
    after `down` (what `Experts` does) and after each product (what the
    JAX wrapper does), in f32 and bf16: both pairs of outputs."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda.grouped_gemm import sharded_grouped_gemm
    topo = _install()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        lhs = torch.from_numpy(x).to(dtype)
        group_sizes = torch.from_numpy(sizes)
        n = stacks["gate"].shape[0] // EP
        gate, up, down = (torch.from_numpy(stacks[k][rank * n:(rank + 1) * n]).to(dtype)
                          for k in ("gate", "up", "down"))

        def ffn(reduce_each):
            def gg(a, w, reduce):
                return sharded_grouped_gemm(a, w, group_sizes, topo, reduce=reduce)
            h = F.silu(gg(lhs, gate, reduce_each)) * gg(lhs, up, reduce_each)
            return gg(h, down, True)

        out[str(dtype)] = (ffn(False), ffn(True))
    return out
