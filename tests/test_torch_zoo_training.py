"""Training the port's zoo families (phi, GPT-NeoX, BLOOM) held against the
JAX engine on the CPU, on one device and across data ranks.

Both packages get the same numpy weights of a 2-layer model of each family
(`tests/torch_dp_ranks.py:ZOO`): phi with two heads of 80 and GPT-NeoX with
two heads of 256 (the widths of phi-2 and pythia-1b, where the flash
kernels' backward runs on the card), and bloom-tiny (alibi: the masked
attention path in both packages). The config is
`tests/test_torch_train_engine.py`'s (FusedAdam with weight decay, WarmupLR,
clipping 1.0, GAS 2) with Adam's eps at 1e-6 instead of 1e-8: at 1e-8,
elements whose gradient sits five orders under their leaf's median (an
embedding row of a token seen once) move by Adam's division of their own
rounding, and the JAX engine's dp = 1 and dp = 2 runs then differ by
2.3e-3 on GPT-NeoX's embedding. Five global batches of 8 rows of 32 tokens.

The JAX engine trains on one device (the reference) and over two devices of
the virtual CPU mesh at ZeRO stage 2, phi's and GPT-NeoX's flash kernels in
Pallas interpret mode on 16-row tiles. The port trains with remat on, on the
CPU, where the flash wrappers take their plain versions: in one process on
the whole batches, and in two `gloo` ranks (spawned once for the file,
while the JAX engine runs) on their own rows at ZeRO stages 0-3, the
persistence threshold at 1000 elements so that stage 3 shards the kernels
and embeddings. Per step the loss, the pre-clip grad norm and the next lr
agree to 1e-5 relative with the JAX run of the same mesh, and the final
parameters to 1e-5 absolute plus, leaf by leaf, the JAX engine's own
largest distance between its dp = 1 and dp = 2 runs (held under
MESH_NOISE_CAP; `tests/test_torch_moe_zero.py` bounds its MoE runs so,
element by element). The
ranks' parameters are equal bit for bit. Remat on against off, and the
flash path against the masked path, hold the port to itself.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import deepspeed_tpu  # noqa: E402
from deepspeed_tpu.models import bloom as jax_bloom  # noqa: E402
from deepspeed_tpu.models import gptneox as jax_neox  # noqa: E402
from deepspeed_tpu.models import phi as jax_phi  # noqa: E402
from deepspeed_tpu.utils.groups import MeshTopology  # noqa: E402
from deepspeed_tpu_torch.models.llama import to_jax_params  # noqa: E402
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from tests import torch_dp_ranks as dp_ranks  # noqa: E402
from tests import torch_tp_ranks as ranks  # noqa: E402
from tests.test_torch_train_engine import CONFIG as LLAMA_CONFIG  # noqa: E402

TOL = 1e-5
MESH_NOISE_CAP = 2e-5   # the JAX dp = 1 / dp = 2 distance, at most (3.85e-6 read, GPT-NeoX)
SEED = 31
STEPS, ROWS, SEQ = 5, 8, 32
DP = dp_ranks.DP
GAS = LLAMA_CONFIG["gradient_accumulation_steps"]
CONFIG = dict(LLAMA_CONFIG, train_micro_batch_size_per_gpu=ROWS // GAS, optimizer={
    "type": "FusedAdam", "params": dict(LLAMA_CONFIG["optimizer"]["params"], eps=1e-6)})
STAGES = (0, 1, 2, 3)
# family -> (JAX module, JAX config, JAX init, JAX loss fn); the port's side
# and the config both sides share are `torch_dp_ranks.ZOO`
JAX = {"phi": (jax_phi.PhiForCausalLM, jax_phi.phi_config, jax_phi.init_phi,
               jax_phi.phi_loss_fn),
       "neox": (jax_neox.GPTNeoXForCausalLM, jax_neox.gptneox_config, jax_neox.init_gptneox,
                jax_neox.gptneox_loss_fn),
       "bloom": (jax_bloom.BloomForCausalLM, jax_bloom.bloom_config, jax_bloom.init_bloom,
                 jax_bloom.bloom_loss_fn)}
FAMILIES = list(dp_ranks.ZOO)


def zero_config(stage, dp=DP):
    return dict(CONFIG, train_micro_batch_size_per_gpu=ROWS // (GAS * dp),
                zero_optimization={"stage": stage,
                                   "stage3_param_persistence_threshold": 1000})


def global_batches(steps=STEPS):
    ids = np.random.default_rng(SEED + 1).integers(0, 256, (steps, ROWS, SEQ))
    return [{"input_ids": b} for b in ids]


def jax_model(family):
    cls, config, _, _ = JAX[family]
    preset, overrides, attn = dp_ranks.ZOO[family]
    return cls(config(preset, dtype=jnp.float32, attn_impl=attn, **overrides))


def numpy_tree(family, seed=SEED):
    """The family's JAX tree made with numpy: kernels, embeddings and biases
    normal(0.02), LayerNorm scales near 1."""
    _, params, _ = JAX[family][2](jax_model(family).cfg)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def jax_train(family, tree, dp):
    """The JAX engine's steps over `dp` devices on the whole global batches
    (ZeRO stage 2): per step (loss, pre-clip grad norm, the next lr), and
    the final parameters."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
        mp.setenv("DS_TPU_FLASH_BLOCK_K", "16")
        model = jax_model(family)
        engine, *_ = deepspeed_tpu.initialize(
            model=model, model_parameters=tree, config=zero_config(2, dp),
            loss_fn=JAX[family][3](model),
            topology=MeshTopology(dp=dp, devices=jax.devices()[:dp]))
        steps = []
        for batch in global_batches():
            loss = engine.train_batch(batch=batch)
            steps.append((float(loss), engine.get_global_grad_norm(), engine.get_lr()[0]))
        return steps, jax.device_get(engine.state.params)


def port_run(family, tree, steps=STEPS, **overrides):
    """The port's steps in one process on the whole global batches."""
    engine = dp_ranks.zoo_engine(family, tree, CONFIG, **overrides)
    return dp_ranks._steps(engine, global_batches(steps), 0), engine


def assert_within(got, ref, noise, what):
    """Each leaf of `got` within 1e-5 + the JAX mesh noise of `ref`: the
    largest distance between the JAX dp = 1 and dp = 2 runs in that leaf
    (an element's own distance can be near zero by chance where its
    neighbours' is not)."""
    for (path, want), n in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                               jax.tree_util.tree_leaves(noise)):
        mine = got
        for p in path:
            mine = mine[p.key]
        excess = np.abs(mine - np.asarray(want)) - (TOL + n.max())
        assert excess.max() <= 0, (f"{what} {jax.tree_util.keystr(path)}: "
                                   f"{int((excess > 0).sum())} elements beyond 1e-5 + the JAX "
                                   f"mesh noise, by up to {excess.max()}")


@pytest.fixture(scope="module")
def trees():
    return {family: numpy_tree(family) for family in FAMILIES}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """The ranks' runs (every family at every stage, one spawn), started
    first; while they run, per family the JAX engine at dp = 1 and dp = 2
    and its own distance between the two. Returns (the ranks' results,
    the JAX runs)."""
    wait = ranks.start(dp_ranks.scenarios, trees,
                       {f"{f}-{s}": ("zoo", (f, zero_config(s), global_batches()))
                        for f in FAMILIES for s in STAGES},
                       tmp_path=tmp_path_factory.mktemp("zoo_zero"))
    try:
        refs = {}
        for family in FAMILIES:
            one = jax_train(family, trees[family], 1)
            two = jax_train(family, trees[family], DP)
            noise = jax.tree_util.tree_map(lambda a, b: np.abs(np.asarray(a) - np.asarray(b)),
                                           one[1], two[1])
            refs[family] = dict(one=one, two=two, noise=noise)
    finally:
        got = wait()
    return got, refs


@pytest.mark.parametrize("family", FAMILIES)
def test_five_steps_match_jax_engine(trees, runs, family):
    ref = runs[1][family]
    worst = max(float(n.max()) for n in jax.tree_util.tree_leaves(ref["noise"]))
    assert worst <= MESH_NOISE_CAP, f"the JAX dp = 1 / dp = 2 distance grew to {worst}"
    flash = (fa.flash_attention_fwd_plain, fa.flash_attention_bwd_dq_plain)
    calls = {f.__name__: 0 for f in flash}

    def counted(fn):
        def wrapper(*args, **kwargs):
            calls[fn.__name__] += 1
            return fn(*args, **kwargs)
        return wrapper
    with pytest.MonkeyPatch.context() as mp:
        for fn in flash:
            mp.setattr(fa, fn.__name__, counted(fn))
        got, engine = port_run(family, trees[family])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref["one"][0]), rtol=TOL, atol=0)
    assert engine.state.global_step == STEPS and engine.module.cfg.remat
    assert_within(to_jax_params(engine.module), ref["one"][1], ref["noise"], family)
    # phi and GPT-NeoX on the flash path, its forward twice under remat;
    # BLOOM's alibi on the masked path
    want = 0 if family == "bloom" else STEPS * GAS * engine.module.cfg.num_hidden_layers
    assert calls == {"flash_attention_fwd_plain": 2 * want,
                     "flash_attention_bwd_dq_plain": want}, calls


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("family", FAMILIES)
def test_trains_across_data_ranks_like_jax(runs, family, stage):
    """Two ranks at each ZeRO stage against the JAX engine at dp = 2; at
    stage 3 the module's sharded leaves are empty placeholders (the forward
    gathers them: `zero3_gathers`)."""
    ref = runs[1][family]
    got = [r[f"{family}-{stage}"] for r in runs[0]]
    for rank, r in enumerate(got):
        np.testing.assert_allclose(np.asarray(r["steps"]), np.asarray(ref["two"][0]),
                                   rtol=TOL, atol=0, err_msg=f"rank {rank}")
        assert_within(r["tree"], ref["two"][1], ref["noise"], f"{family} rank {rank}")
        assert bool(r["empty"]) == (stage == 3), r["empty"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, got[0]["tree"], got[1]["tree"])


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_on_equals_remat_off(trees, family):
    """Recomputing each block in backward (its gathered parameters and, for
    phi and GPT-NeoX, the flash forward) changes nothing."""
    on, _ = port_run(family, trees[family], steps=2, remat=True)
    off, engine = port_run(family, trees[family], steps=2, remat=False)
    assert not engine.module.cfg.remat
    np.testing.assert_allclose(np.asarray(on), np.asarray(off), rtol=1e-6)


@pytest.mark.parametrize("family", ["phi", "neox"])
def test_flash_path_equals_masked_path(trees, family):
    """The flash wrappers' plain versions and the masked reference path
    train the same steps: the kernels' function is attention's."""
    flash, _ = port_run(family, trees[family], steps=2)
    masked, _ = port_run(family, trees[family], steps=2, attn_impl="reference")
    np.testing.assert_allclose(np.asarray(flash), np.asarray(masked), rtol=1e-5)


@pytest.mark.parametrize("kind", ["param", "master", "grad"])
@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_leaves_match_zero_sharding_plan(trees, family, kind):
    """Which leaves shard at stage 3 over dp = 2 equals the JAX plan's
    `tree_specs` on the family's stacked tree: the port reads BLOOM's `h`
    blocks, as phi's and GPT-NeoX's `layers`, as one stacked leaf each."""
    from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JaxZeroConfig
    from deepspeed_tpu.runtime.zero.partition import ZeroShardingPlan as JaxPlan
    from deepspeed_tpu_torch.models.llama import tree_to_torch
    from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
    from deepspeed_tpu_torch.runtime.zero.partition import ZeroShardingPlan, jax_leaf_shape
    from jax.sharding import PartitionSpec as P
    block = zero_config(3)["zero_optimization"]
    jax_plan = JaxPlan(MeshTopology(dp=DP, devices=jax.devices()[:DP]), JaxZeroConfig(**block))
    plan = ZeroShardingPlan(DP, DeepSpeedZeroConfig.from_dict(block))
    model, _ = dp_ranks.zoo_model(family, device="meta")
    shapes = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                                    trees[family])
    flags = jax.tree_util.tree_map(
        lambda x, spec: np.full(x.shape, "data" in tuple(spec), np.uint8), shapes,
        jax_plan.tree_specs(shapes, None, kind), is_leaf=lambda x: isinstance(x, P))
    want = {n: bool(t.reshape(-1)[0]) for n, t in model.module_state(tree_to_torch(flags)).items()}
    got = {n: plan.shards(jax_leaf_shape(model, n), kind) for n in want}
    assert got == want
    assert any(got.values()) and (kind != "param" or not all(got.values()))
