"""The port's data-parallel training (ZeRO stages 0-3 over dp = 2) held
against the JAX engine on `MeshTopology(dp=2)` on the CPU.

Two `gloo` ranks (`tests/torch_dp_ranks.py`, spawned once for the file)
each train the tiny Llama (2 layers, hidden 64) in f32 from the same numpy
weights on their own rows of the same global batches (micro-batch 2 a
rank, GAS 2), with FusedAdam, weight decay, WarmupLR and clipping 1.0; the
JAX engine trains on the whole batches over two devices of the virtual
CPU mesh, its flash kernels in Pallas interpret mode on 16-row tiles.
Per step the loss and the pre-clip grad norm agree to 1e-5 relative on
both ranks, and the final parameters (`materialized_state()`) to 1e-5
absolute, at every stage, with the ranks' labels partly ignored in
unequal numbers (stage 3), at GAS 1 (stage 3) and, under fp16, with infs
in one rank's rows (the skipped steps, the scale and the lr follow
JAX's). The persistence
threshold is 1000 elements, so that the RMSNorm weights (2 x 64) stay
whole at stage 3 while the kernels and embeddings shard. Without the
ranks: which leaves shard at each stage, against `ZeroShardingPlan.
tree_specs` (dp = 2 and 3, where most leaves do not divide); the batch
triangulation against the JAX config's; the dataloader's rows against the
JAX data shard; what still raises.
"""

import functools
import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.models.common import IGNORE_INDEX, shift_labels  # noqa: E402
from deepspeed_tpu.models.llama import (  # noqa: E402
    LlamaForCausalLM as JaxLlama,
    llama_config as jax_llama_config,
    llama_loss_fn as jax_llama_loss_fn,
)
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig  # noqa: E402
from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JaxLoader  # noqa: E402
from deepspeed_tpu.runtime.zero.partition import ZeroShardingPlan as JaxPlan  # noqa: E402
from deepspeed_tpu.utils.groups import MeshTopology as JaxTopology  # noqa: E402
from deepspeed_tpu_torch.models.llama import (  # noqa: E402
    LlamaForCausalLM,
    llama_config,
    tree_to_torch,
)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig  # noqa: E402
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError  # noqa: E402
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.partition import (  # noqa: E402
    ZeroShardingPlan,
    jax_leaf_shape,
)
from deepspeed_tpu_torch.utils import groups  # noqa: E402
from tests import torch_dp_ranks as dp_ranks  # noqa: E402
from tests import torch_tp_ranks as ranks  # noqa: E402
from tests.test_torch_train_engine import CONFIG, SEQ, _poisoned, numpy_tree  # noqa: E402

TOL = 1e-5
DP = dp_ranks.DP
STEPS = 3
THRESHOLD = 1000
STAGES = (0, 1, 2, 3)


def zero_config(stage, **extra):
    return dict(CONFIG, **extra, zero_optimization={
        "stage": stage, "stage3_param_persistence_threshold": THRESHOLD})


def global_batches(seed=1, steps=STEPS, ignore=False):
    """`steps` global batches of 8 rows (GAS 2 x micro 2 x dp 2). With
    `ignore`, labels ignored at the ends of rows (padding), more of them on
    rank 0 in micro 0 and on rank 1 in micro 1."""
    ids = np.random.default_rng(seed).integers(0, 256, (steps, 8, SEQ))
    if not ignore:
        return [{"input_ids": b} for b in ids]
    out = []
    for b in ids:
        labels = np.array(shift_labels(jnp.asarray(b)))
        labels[0, -12:] = IGNORE_INDEX    # micro 0, rank 0's rows
        labels[1, -5:] = IGNORE_INDEX
        labels[6, -20:] = IGNORE_INDEX    # micro 1, rank 1's first row
        out.append({"input_ids": b, "labels": labels})
    return out


def fp16_batches():
    """Six steps, infs and a nan in rank 0's rows or rank 1's only."""
    ids = np.random.default_rng(3).integers(0, 256, (6, 8, SEQ))
    poison = np.ones((6, 8), np.float32)
    poison[1, 1], poison[2, 6], poison[4, 0], poison[4, 5] = np.inf, np.inf, np.nan, np.inf
    return [{"input_ids": i, "poison": p} for i, p in zip(ids, poison)]


# GAS 1: no accumulation buffer lives between steps
GAS1 = zero_config(3, train_micro_batch_size_per_gpu=4, gradient_accumulation_steps=1)
FP16 = dict(fp16={"enabled": True, "initial_scale_power": 8, "hysteresis": 2,
                  "loss_scale_window": 3})


@pytest.fixture(scope="module")
def tree():
    return numpy_tree()


@pytest.fixture(scope="module")
def port(tree, tmp_path_factory):
    """Every rank scenario, in one spawn of two ranks."""
    runs = {f"stage{s}": ("train", (zero_config(s), global_batches())) for s in STAGES}
    runs["ignore"] = ("train", (zero_config(3), global_batches(seed=2, ignore=True)))
    runs["gas1"] = ("train", (GAS1, global_batches()))
    runs["fp16"] = ("fp16", (zero_config(3, **FP16), fp16_batches()))
    return ranks.spawn(dp_ranks.scenarios, tree, runs,
                       tmp_path=tmp_path_factory.mktemp("zero"))


def jax_engine(tree, config, dtype=jnp.float32, loss_fn=None, dp=DP):
    model = JaxLlama(jax_llama_config("llama-tiny", dtype=dtype, attn_impl="pallas"))
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=tree, config=config,
        loss_fn=loss_fn or jax_llama_loss_fn(model),
        topology=JaxTopology(dp=dp, devices=jax.devices()[:dp]))
    return engine


def jax_train(tree, config, batches, dp=DP):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
        mp.setenv("DS_TPU_FLASH_BLOCK_K", "16")
        engine = jax_engine(tree, config, dp=dp)
        steps = []
        for batch in batches:
            loss = engine.train_batch(batch=batch)
            steps.append((float(loss), engine.get_global_grad_norm()))
        return steps, jax.device_get(engine.state.params)


def assert_matches_jax(got, ref_steps, ref_params):
    for rank, r in enumerate(got):
        np.testing.assert_allclose(np.asarray(r["steps"]), np.asarray(ref_steps), rtol=TOL,
                                   atol=0, err_msg=f"rank {rank}")
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL),
            r["tree"], ref_params)
    # the ranks hold the same parameters, bit for bit
    jax.tree_util.tree_map(np.testing.assert_array_equal, got[0]["tree"], got[1]["tree"])


@pytest.mark.parametrize("stage", STAGES)
def test_stages_match_jax_engine(tree, port, stage):
    ref_steps, ref_params = jax_train(tree, zero_config(stage), global_batches())
    assert_matches_jax([r[f"stage{stage}"] for r in port], ref_steps, ref_params)
    assert all(r[f"stage{stage}"]["global_samples"] == 8 * STEPS for r in port)


def test_stage3_unequal_ignored_labels_match_jax(tree, port):
    """The ranks hold different numbers of labels: the loss is still the
    global batch's token mean, as in the JAX engine. The JAX engine on one
    device gives the same steps within the tolerance, so the reference
    itself does not depend on the mesh at this tolerance."""
    batches = global_batches(seed=2, ignore=True)
    counts = [(dp_ranks.rank_rows(batches[0]["labels"], r, 2) != IGNORE_INDEX).sum()
              for r in range(DP)]
    assert counts[0] != counts[1]
    ref_steps, ref_params = jax_train(tree, zero_config(3), batches)
    one_steps, one_params = jax_train(tree, dict(zero_config(3),
                                                 train_micro_batch_size_per_gpu=2 * DP),
                                      batches, dp=1)
    np.testing.assert_allclose(one_steps, ref_steps, rtol=TOL, atol=0)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=TOL),
                           one_params, ref_params)
    assert_matches_jax([r["ignore"] for r in port], ref_steps, ref_params)


def test_stage3_at_gas1_matches_jax(tree, port):
    """One micro a step: the reduced pieces are the step's gradient and
    no `grad_acc` outlives the step."""
    ref_steps, ref_params = jax_train(tree, GAS1, global_batches())
    got = [r["gas1"] for r in port]
    assert_matches_jax(got, ref_steps, ref_params)
    assert all(size[2] is None for r in got for size in r["sizes"].values())


def test_fp16_one_rank_overflowing_skips_on_both_like_jax(tree, port):
    batches = fp16_batches()
    config = zero_config(3, **FP16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
        mp.setenv("DS_TPU_FLASH_BLOCK_K", "16")
        model = JaxLlama(jax_llama_config("llama-tiny", dtype=jnp.float16, attn_impl="pallas"))
        engine = jax_engine(tree, config, jnp.float16,
                            _poisoned(jax_llama_loss_fn(model), True))
        ref = []
        for batch in batches:
            loss = engine.train_batch(batch=batch)
            ref.append((engine.skipped_steps, engine.cur_scale, int(engine.state.global_step),
                        engine.get_lr()[0], float(loss)))
    got0, got1 = (r["fp16"] for r in port)
    np.testing.assert_array_equal(np.asarray(got0), np.asarray(got1))
    assert [g[:3] for g in got0] == [r[:3] for r in ref]
    assert got0[-1][0] > 0 and got0[-1][1] < 256.0      # it skipped and dropped
    np.testing.assert_allclose([g[3] for g in got0], [r[3] for r in ref], rtol=1e-6)
    for g, r in zip(got0, ref):
        assert np.isfinite(g[4]) == np.isfinite(r[4])
        if np.isfinite(r[4]):
            np.testing.assert_allclose(g[4], r[4], rtol=1e-3)


@pytest.mark.parametrize("stage", STAGES)
def test_a_rank_holds_its_share_of_each_sharded_leaf(port, stage):
    """At stage >= 1 the master (here f32: none), the moments and grad_acc
    of a sharded leaf are 1/dp of it on a rank; at stage 3 its params
    too, and the module keeps an empty placeholder."""
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32), device="meta")
    plan = ZeroShardingPlan(DP, DeepSpeedZeroConfig.from_dict(
        zero_config(stage)["zero_optimization"]))
    for r in port:
        got = r[f"stage{stage}"]
        assert got["empty"] == sorted(
            n for n, _ in model.named_parameters()
            if plan.shards(jax_leaf_shape(model, n), "param"))
        for name, p in model.named_parameters():
            shape = jax_leaf_shape(model, name)
            share = lambda kind: p.numel() // DP if plan.shards(shape, kind) else p.numel()
            assert got["sizes"][name] == (share("param"), share("master"), share("grad"),
                                          None), name
    if stage >= 1:
        assert any(plan.shards(jax_leaf_shape(model, n), "master")
                   for n, _ in model.named_parameters())


@functools.lru_cache(maxsize=None)
def _jax_shapes(intermediate_size):
    from deepspeed_tpu.models.llama import materialize_params
    _, params = materialize_params(jax_llama_config("llama-tiny",
                                                    intermediate_size=intermediate_size))
    return jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)


def _names_to_specs(model, jax_plan, kind):
    """{module parameter name: whether the JAX plan shards its leaf} for
    the tiny Llama's tree, through the module's own name mapping."""
    params = _jax_shapes(model.cfg.intermediate_size)
    specs = jax_plan.tree_specs(params, None, kind)
    flags = jax.tree_util.tree_map(
        lambda x, s: np.full(x.shape, "data" in tuple(s), np.uint8), params, specs,
        is_leaf=lambda s: isinstance(s, P))
    state = model.module_state(tree_to_torch(flags))
    return {n: bool(t.reshape(-1)[0]) for n, t in state.items()}


@pytest.mark.parametrize("dp,overrides", [(2, {}), (3, dict(intermediate_size=96))])
@pytest.mark.parametrize("stage", STAGES)
def test_sharded_leaves_match_zero_sharding_plan(dp, overrides, stage):
    """At dp = 2 the RMSNorm weights fall under the threshold at stage 3;
    at dp = 3 only the MLP kernels (intermediate 96) have a dimension it
    divides, and the rest stay whole."""
    from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JaxZeroConfig
    block = zero_config(stage)["zero_optimization"]
    jax_plan = JaxPlan(JaxTopology(dp=dp, devices=jax.devices()[:dp]),
                       JaxZeroConfig(**block))
    plan = ZeroShardingPlan(dp, DeepSpeedZeroConfig.from_dict(block))
    model = LlamaForCausalLM(llama_config("llama-tiny", **overrides), device="meta")
    seen = set()
    for kind in ("param", "master", "grad"):
        want = _names_to_specs(model, jax_plan, kind)
        got = {n: plan.shards(jax_leaf_shape(model, n), kind) for n in want}
        assert got == want, kind
        seen |= {(kind, v) for v in got.values()}
    if stage == 3:
        assert ("param", True) in seen and ("param", False) in seen
    if dp == 3:
        assert ("master", False) in seen


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("batch", [dict(train_batch_size=16, train_micro_batch_size_per_gpu=2),
                                   dict(train_micro_batch_size_per_gpu=2,
                                        gradient_accumulation_steps=2),
                                   dict(train_batch_size=8, gradient_accumulation_steps=2),
                                   dict(train_batch_size=8),
                                   dict(train_batch_size=8, train_micro_batch_size_per_gpu=2,
                                        gradient_accumulation_steps=2),
                                   dict(train_batch_size=6, train_micro_batch_size_per_gpu=2)])
def test_batch_triangulation_matches_jax(world, batch):
    try:
        ref = JaxConfig(dict(batch), world_size=world)
    except Exception as e:  # the JAX config's refusal: the port refuses too
        with pytest.raises(DeepSpeedConfigError):
            DeepSpeedConfig(dict(batch), world_size=world)
        assert "DeepSpeedConfigError" in type(e).__name__
        return
    got = DeepSpeedConfig(dict(batch), world_size=world)
    assert (got.train_batch_size, got.train_micro_batch_size_per_gpu,
            got.gradient_accumulation_steps, got.data_parallel_size, got.world_size) == \
        (ref.train_batch_size, ref.train_micro_batch_size_per_gpu,
         ref.gradient_accumulation_steps, ref.data_parallel_size, ref.world_size)


@pytest.mark.parametrize("drop_last", [True, False])
def test_each_ranks_dataloader_rows_are_its_jax_data_shard(drop_last):
    """The JAX loader's global micro-batches, placed on the `data` axis,
    give each coordinate the rows the port's loader yields on that rank,
    the last (two-row) batch's too when it is kept."""
    data = {"input_ids": np.arange(14 * 4).reshape(14, 4)}
    mesh = JaxTopology(dp=DP, devices=jax.devices()[:DP]).mesh
    want = [[] for _ in range(DP)]
    for batch in JaxLoader(data, batch_size=2 * DP, drop_last=drop_last, seed=7):
        placed = jax.device_put(batch["input_ids"], NamedSharding(mesh, P("data")))
        for shard in placed.addressable_shards:
            want[list(mesh.devices.flat).index(shard.device)].append(np.asarray(shard.data))
    for rank in range(DP):
        loader = DeepSpeedDataLoader(data, batch_size=2, drop_last=drop_last, seed=7,
                                     data_parallel_size=DP, data_parallel_rank=rank)
        got = [b["input_ids"] for b in loader]
        assert len(loader) == len(JaxLoader(data, batch_size=2 * DP, drop_last=drop_last))
        for g, w in zip(got, want[rank]):
            np.testing.assert_array_equal(g, w)
        assert len(got) == len(want[rank]) == (3 if drop_last else 4)


def test_data_parallel_refusals():
    """What does not train across data ranks yet raises, naming its
    ROADMAP item: stage 3 with a module whose forward does not gather its
    units (every family of the port does: the MoE families in
    `tests/test_torch_moe_zero.py`, the zoo in
    `tests/test_torch_zoo_training.py`); a config whose world is not the
    topology's raises."""
    groups.initialize(groups.MeshTopology(dp=DP, world_size=DP, rank=0))
    try:
        cases = [(torch.nn.Linear(4, 4), 3, "ZeRO stage 3")]
        for model, stage, what in cases:
            with pytest.raises(NotImplementedError, match=f"{what}.*Multi-GPU"):
                deepspeed_tpu_torch.initialize(model=model, device="cpu",
                                               config=zero_config(stage))
        with pytest.raises(ValueError, match="not the topology's data=2"):
            deepspeed_tpu_torch.initialize(
                model=LlamaForCausalLM(llama_config("llama-tiny")), device="cpu",
                config=DeepSpeedConfig(zero_config(1), world_size=4))
    finally:
        groups.reset_topology()
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        groups.MeshTopology(dp=2, tp=2, world_size=4, rank=0)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        groups.MeshTopology(ep=2, world_size=4, rank=0)
