"""The port's collectives and process topology on the CPU.

Two `gloo` ranks (`tests/torch_tp_ranks.py`, spawned once under a tp = 2
topology and once under dp = 2 by `tests/torch_dp_ranks.py`) run `comm`'s
collectives by axis name: sum all-reduce, gathers and broadcast over
`model`; every reduction of `all_reduce` (SUM, AVG, MAX, MIN), the tiled
`reduce_scatter` and `all_gather_into` over `data`, against numpy, in f32
and bf16. The topology's sizes and this rank's coordinates are held
against the JAX `MeshTopology` on the virtual CPU mesh, for the `model`
axis and the `data` axis (given, or taking what the world leaves).
Refusals: `nccl` with more ranks than cards on the host, two nontrivial
axes or any axis but `data`, `model` and `expert`, a tp that the world
does not hold, and tensor parallelism for BLOOM, the MoE families,
training, a sliding window and ring attention.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.utils.groups import MeshTopology as JaxTopology
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.groups import MESH_AXES, MeshTopology
from tests import torch_dp_ranks as dp_ranks
from tests import torch_tp_ranks as ranks

TP = ranks.TP


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.spawn(ranks.collectives, tmp_path=tmp_path_factory.mktemp("comm"))


@pytest.fixture(scope="module")
def data_results(tmp_path_factory):
    return ranks.spawn(dp_ranks.data_collectives, tmp_path=tmp_path_factory.mktemp("data"))


def test_collectives_by_axis_name(results):
    x = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r for r in range(TP)]
    for rank, got in enumerate(results):
        assert (got["rank"], got["model_rank"], got["local_rank"]) == (rank, rank, rank)
        assert (got["world"], got["model_world"], got["backend"]) == (TP, TP, "gloo")
        torch.testing.assert_close(got["sum"], x[0] + x[1], rtol=0, atol=0)
        assert got["bf16_sum"].dtype == torch.bfloat16
        torch.testing.assert_close(got["bf16_sum"], (x[0] + x[1]).to(torch.bfloat16))
        torch.testing.assert_close(got["gather_last"], torch.cat(x, dim=-1), rtol=0, atol=0)
        torch.testing.assert_close(got["gather_first"], torch.cat(x), rtol=0, atol=0)
        torch.testing.assert_close(got["broadcast"], x[1], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_data_collectives_match_numpy(data_results, dtype):
    """Each reduction of `all_reduce`, `reduce_scatter` along either dim
    and `all_gather_into` over `data`, against numpy on both ranks' inputs
    (the inputs are small integers and halves, exact in bf16 too)."""
    key = str(dtype).split(".")[-1]
    x = [(np.arange(24, dtype=np.float32).reshape(4, 6) * (r + 1) - 5 * r) for r in range(2)]
    want = {"sum": x[0] + x[1], "avg": (x[0] + x[1]) / 2, "max": np.maximum(*x),
            "min": np.minimum(*x)}
    for rank, got in enumerate(data_results):
        assert (got["dp"], got["coord"]) == (2, rank)
        assert got["sizes"] == {a: 2 if a == "data" else 1 for a in MESH_AXES}
        for op, w in want.items():
            assert got[f"{op}_{key}"].dtype == dtype
            np.testing.assert_array_equal(got[f"{op}_{key}"].float().numpy(), w, err_msg=op)
        np.testing.assert_array_equal(got[f"scatter0_{key}"].float().numpy(),
                                      want["sum"][2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(got[f"scatter1_{key}"].float().numpy(),
                                      want["sum"][:, 3 * rank:3 * rank + 3])
        same, gathered = got[f"gather_into_{key}"]
        assert same
        np.testing.assert_array_equal(gathered.float().numpy(), np.concatenate(x))
        stats = got["stats"]
        assert stats["all_reduce"]["calls"] == 8 and stats["reduce_scatter"]["calls"] == 4
        assert stats["all_gather"]["bytes"] == 24 * 4 + 24 * 2


def test_one_process_collectives_are_the_identity():
    x = torch.ones(3)
    assert not comm.is_initialized()
    assert comm.all_reduce(x, group="model") is x
    assert comm.all_gather(x, group="model", axis=0) is x
    assert comm.all_reduce(x, op=comm.ReduceOp.MAX) is x
    assert comm.reduce_scatter(x, group="data") is x
    out = torch.zeros(3)
    assert comm.all_gather_into(out, x) is out and torch.equal(out, x)
    with pytest.raises(ValueError, match="reduce op"):
        comm.all_reduce(x, op="prod")
    assert comm.get_rank("model") == 0 and comm.get_world_size() == 1
    comm.init_distributed(dist_backend="gloo")   # one process: a no-op
    assert not comm.is_initialized()


@pytest.mark.parametrize("kw,n", [(dict(tp=2), 2), (dict(tp=1), 1), (dict(tp=4), 4),
                                  (dict(dp=2), 2), (dict(tp=1), 2),
                                  (dict(mics_shard_size=2), 4), (dict(repl=2, dp=2), 4),
                                  (dict(mics_shard_size=4), 8)])
def test_topology_matches_jax(kw, n):
    jax_topo = JaxTopology(devices=jax.devices()[:n], **kw)
    devices = list(jax.devices()[:n])
    for rank in range(n):
        topo = MeshTopology(world_size=n, rank=rank, **kw)
        assert topo.sizes == {a: int(jax_topo.sizes[a]) for a in MESH_AXES}
        assert (topo.world_size, topo.tp_size, topo.dp_size) == \
            (jax_topo.world_size, jax_topo.tp_size, jax_topo.dp_size)
        assert topo.zero_axes() == jax_topo.zero_axes() and \
            topo.zero_axes(True) == jax_topo.zero_axes(True)
        where = np.argwhere(np.asarray(jax_topo.mesh.devices) == devices[rank])[0]
        assert tuple(topo.coords[a] for a in MESH_AXES) == tuple(int(c) for c in where)


@pytest.mark.parametrize("kw", [dict(tp=2, ep=2), dict(sp=2), dict(pp=2)])
def test_axes_other_than_model_raise(kw):
    # `expert` alone (tests/test_torch_ep_serving.py) and `data` alone
    # (test_topology_matches_jax) are ported; with `model` they are not
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        MeshTopology(world_size=2, rank=0, **kw)


def test_nccl_with_two_ranks_on_one_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="dist_backend='gloo'"):
        comm.init_distributed(dist_backend=None, init_method=f"file://{tmp_path}/r",
                              rank=0, world_size=2)
    assert not comm.is_initialized()
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        comm.init_distributed(dist_backend="mpi", init_method=f"file://{tmp_path}/r",
                              rank=0, world_size=2)


def _tiny_model(kind, **overrides):
    if kind == "llama":
        from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
        return LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **overrides))
    if kind == "bloom":
        from deepspeed_tpu_torch.models.bloom import BloomForCausalLM, bloom_config
        return BloomForCausalLM(bloom_config("bloom-tiny", dtype=torch.float32))
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM, qwen2_moe_config
    return Qwen2MoeForCausalLM(qwen2_moe_config("qwen2moe-tiny", dtype=torch.float32))


@pytest.mark.parametrize("kind", ["bloom", "qwen2_moe"])
def test_tp_for_other_families_raises(kind):
    groups.initialize(MeshTopology(tp=2, world_size=2, rank=0))
    try:
        with pytest.raises(NotImplementedError, match="Multi-GPU"):
            deepspeed_tpu_torch.init_inference(_tiny_model(kind), dtype="fp32", device="cpu",
                                               tensor_parallel={"tp_size": 2})
    finally:
        groups.reset_topology()


def test_tp_refusals():
    # one process cannot hold two ranks
    with pytest.raises(ValueError, match="torchrun"):
        deepspeed_tpu_torch.init_inference(_tiny_model("llama"), dtype="fp32", device="cpu",
                                           tensor_parallel={"tp_size": 2})
    groups.reset_topology()
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        LlamaForCausalLM(llama_config("llama-tiny", sliding_window=16), tp_size=2, tp_rank=0)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        LlamaForCausalLM(llama_config("llama-tiny", attn_impl="ring"), tp_size=2, tp_rank=0)
    with pytest.raises(ValueError, match="divide"):
        LlamaForCausalLM(llama_config("llama-tiny", num_key_value_heads=1), tp_size=2,
                         tp_rank=0)
    shard = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32), tp_size=2,
                             tp_rank=1)
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        shard(ids, labels=ids)
    # training over a tensor-parallel config still raises
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        deepspeed_tpu_torch.initialize(model=_tiny_model("llama"), device="cpu", config={
            "train_micro_batch_size_per_gpu": 1, "tensor_parallel": {"tp_size": 2}})


def test_serve_mode_accounts_the_topology(monkeypatch):
    """`auto` under a tp = 2 topology passes the JAX engine's mesh
    arguments (multi-device, tp-shardable, two devices' memory), and a
    module built as a shard is accounted by its whole tree, as a whole
    module is."""
    from deepspeed_tpu_torch.inference import serve_modes
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
    seen = []
    monkeypatch.setattr(serve_modes, "resolve_serve_mode",
                        lambda engine, shapes, real=serve_modes.resolve_serve_mode:
                        seen.append(shapes) or real(engine, shapes))
    monkeypatch.setattr(serve_modes, "choose_serve_mode", lambda **kw: seen.append(kw) or "dequant")
    cfg = llama_config("llama-tiny", dtype=torch.float32)
    groups.initialize(MeshTopology(tp=2, world_size=2, rank=1, device="cpu"))
    try:
        for tp_size in (1, 2):
            model = LlamaForCausalLM(cfg, tp_size=tp_size, tp_rank=tp_size - 1)
            deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu",
                                               quant={"enabled": True, "group_size": 16},
                                               serve_mode="auto")
    finally:
        groups.reset_topology()
    (whole, kw_whole), (shard, kw_shard) = seen[:2], seen[2:]
    assert [t.shape for t in whole["layers"]["mlp"]["up_proj"].values()] == \
        [t.shape for t in shard["layers"]["mlp"]["up_proj"].values()]
    for kw in (kw_whole, kw_shard):
        assert (kw["multi_device"], kw["tp_shardable"], kw["n_devices"]) == (True, True, 2)
    assert kw_whole == kw_shard


def test_shard_outside_its_model_group_raises():
    """A tp = 2 shard run in one process, where every collective is the
    identity and the row-parallel sums would stay partial, raises: with
    no topology, and under a tp = 2 topology with no process group."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
    shard = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32), tp_size=2,
                             tp_rank=0)
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="`model` group of 1 rank"):
        shard(ids)
    groups.initialize(MeshTopology(tp=2, world_size=2, rank=0, device="cpu"))
    try:
        with pytest.raises(RuntimeError, match="`model` group of 1 rank"):
            shard(ids)
    finally:
        groups.reset_topology()
