"""The port's MoE training across data ranks (ZeRO stages 0-3 over dp = 2)
held against the JAX engine on `MeshTopology(dp=2)` on the CPU.

Two `gloo` ranks (`tests/torch_dp_ranks.py`, spawned once for the file)
each train the tiny Qwen2-MoE and Mixtral in f32 from the same numpy
weights on their own rows of the same global batches (micro-batch 2 a
rank, GAS 2, FusedAdam with weight decay, WarmupLR, clipping 1.0;
capacity factor 1.0, so that both families drop tokens), at
every stage with `dispatch_impl="gmm"` (the grouped GEMM on the rank's
rows) and at stages 1 and 3 with `auto` (the ragged buffer in training).
The JAX engine trains on the whole batches over two devices of the
virtual CPU mesh, where its gate sees the global token axis. Per step the
loss, the micros' mean aux loss and router drop share and the pre-clip
grad norm agree to 1e-5 relative, and the final parameters
(`materialized_state()`) to 1e-5 absolute plus, element by element, the
JAX engine's own distance between its dp = 1 and dp = 2 runs (Adam's
first step is g / (|g| + eps): where a gradient is a small difference of
large terms, the reference's own reduction order moves it by up to 1.03e-5
here; the test holds that distance under MESH_NOISE_CAP, 2e-5), all but
k_proj's bias (its gradient is zero up to f32 rounding,
`tests/test_torch_moe_training.py`);
the JAX reference drops tokens at these batches, so the capacity, each
token's place and the telemetry come from the global counts. The JAX
reference runs `auto` (its ragged buffer); its `gmm` agrees with it to
1e-7 (the port's gmm and auto are held to both at dp = 1 in
`tests/test_torch_moe_training.py`). The ranks' parameters are equal bit
for bit. The noisy gate's uniforms differ between the ranks, each its
rows of the global draw. The persistence threshold is 1000 elements, so
that stage 3 shards the expert stacks and the attention kernels.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu  # noqa: E402
from deepspeed_tpu.models.mixtral import (  # noqa: E402
    init_mixtral,
    mixtral_config as jax_mixtral_config,
    mixtral_loss_fn as jax_mixtral_loss_fn,
)
from deepspeed_tpu.models.qwen2_moe import (  # noqa: E402
    init_qwen2_moe,
    qwen2_moe_config as jax_qwen2_moe_config,
    qwen2_moe_loss_fn as jax_qwen2_moe_loss_fn,
)
from deepspeed_tpu.utils import groups as jax_groups  # noqa: E402
from deepspeed_tpu.utils.groups import MeshTopology as JaxTopology  # noqa: E402
from tests import torch_dp_ranks as dp_ranks  # noqa: E402
from tests import torch_tp_ranks as ranks  # noqa: E402
from tests.test_torch_moe_training import CONFIG, numpy_tree  # noqa: E402

TOL = 1e-5
MESH_NOISE_CAP = 2e-5   # the JAX dp = 1 / dp = 2 distance, at most (measured 1.03e-5)
DP = dp_ranks.DP
STEPS = 2
SEQ = 32
MOE = dict(capacity_factor=1.0)
FAMILIES = {
    "qwen2moe": ("qwen2moe-tiny", init_qwen2_moe, jax_qwen2_moe_config, jax_qwen2_moe_loss_fn),
    "mixtral": ("mixtral-tiny", init_mixtral, jax_mixtral_config, jax_mixtral_loss_fn),
}
# (family, stage, dispatch): every stage under gmm, two under auto
CASES = [(f, s, "gmm") for f in FAMILIES for s in (0, 1, 2, 3)] + \
    [("qwen2moe", 3, "auto"), ("mixtral", 1, "auto")]


def zero_config(stage):
    return dict(CONFIG, zero_optimization={"stage": stage,
                                           "stage3_param_persistence_threshold": 1000})


def global_batches():
    """STEPS global batches of 8 rows (GAS 2 x micro 2 x dp 2)."""
    return np.random.default_rng(11).integers(0, 256, (STEPS, 8, SEQ))


def jax_config(family):
    preset, init, config, _ = FAMILIES[family]
    return config(preset, dtype=jnp.float32, dispatch_impl="auto", **MOE)


@pytest.fixture(scope="module")
def trees():
    return {f: numpy_tree(FAMILIES[f][1], jax_config(f), 5) for f in FAMILIES}


@pytest.fixture(scope="module")
def port(trees, tmp_path_factory):
    """Every case, and the noisy gate's draws, in one spawn of two ranks."""
    runs = {f"{f}-{s}-{d}": ("moe", (f, zero_config(s), d, global_batches(), MOE))
            for f, s, d in CASES}
    runs["noise"] = ("noise", ())
    return ranks.spawn(dp_ranks.scenarios, trees, runs,
                       tmp_path=tmp_path_factory.mktemp("moe_zero"))


def jax_train(family, tree, dp):
    """The JAX engine's STEPS over `dp` devices: per step (loss, mean aux
    loss, mean router drop, pre-clip grad norm), and the final parameters.
    The aux figures come from the loss function on the engine's parameters
    before each step, micro by micro (the gate has no noise)."""
    preset, init, _, jax_loss_fn = FAMILIES[family]
    jcfg = jax_config(family)
    model = type(init(jcfg)[0])(jcfg)
    topology = JaxTopology(dp=dp, devices=jax.devices()[:dp])
    jax_groups.initialize(topology)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=tree, loss_fn=jax_loss_fn(model), topology=topology,
        config=dict(zero_config(2), train_micro_batch_size_per_gpu=2 * DP // dp))
    aux_fn = jax.jit(lambda p, ids: jax_loss_fn(model)(p, {"input_ids": ids}, None)[1])
    steps = []
    for batch in global_batches():
        params = engine.state.params
        aux = [aux_fn(params, jnp.asarray(m)) for m in batch.reshape(2, -1, SEQ)] \
            if dp == DP else [{"moe_aux_loss": np.nan, "router_drop": np.nan}]
        loss = float(engine.train_batch(batch={"input_ids": batch}))
        steps.append((loss, float(np.mean([a["moe_aux_loss"] for a in aux])),
                      float(np.mean([np.mean(a["router_drop"]) for a in aux])),
                      engine.get_global_grad_norm()))
    params = jax.device_get(engine.state.params)
    jax_groups.reset_topology()
    return steps, params


@pytest.fixture(scope="module")
def jax_runs(trees):
    """Per family: the dp = 2 run's steps and parameters, and the JAX
    engine's own distance between its dp = 1 and dp = 2 parameters (module
    docstring)."""
    out = {}
    for family in FAMILIES:
        steps, params = jax_train(family, trees[family], DP)
        _, one = jax_train(family, trees[family], 1)
        noise = jax.tree_util.tree_map(lambda a, b: np.abs(np.asarray(a) - np.asarray(b)),
                                       params, one)
        out[family] = steps, params, noise
    return out


def is_k_proj_bias(path) -> bool:
    key = jax.tree_util.keystr(path)
    return "k_proj" in key and "bias" in key


@pytest.mark.parametrize("family,stage,dispatch", CASES)
def test_moe_trains_across_data_ranks_like_jax(port, jax_runs, family, stage, dispatch):
    ref_steps, ref_params, noise = jax_runs[family]
    assert min(s[2] for s in ref_steps) > 0        # the capacity drops tokens
    worst = max(float(n.max()) for path, n in jax.tree_util.tree_flatten_with_path(noise)[0]
                if not is_k_proj_bias(path))
    assert worst <= MESH_NOISE_CAP, f"the JAX dp = 1 / dp = 2 distance grew to {worst}"
    bound = jax.tree_util.tree_map(lambda n: TOL + n, noise)
    got = [r[f"{family}-{stage}-{dispatch}"] for r in port]
    for rank, r in enumerate(got):
        np.testing.assert_allclose(np.asarray(r["steps"]), np.asarray(ref_steps), rtol=TOL,
                                   atol=0, err_msg=f"rank {rank}")
        for (path, want), (_, limit) in zip(jax.tree_util.tree_flatten_with_path(ref_params)[0],
                                            jax.tree_util.tree_flatten_with_path(bound)[0]):
            if is_k_proj_bias(path):
                continue
            key = jax.tree_util.keystr(path)
            mine = r["tree"]
            for p in path:
                mine = mine[p.key]
            excess = np.abs(mine - np.asarray(want)) - limit
            assert excess.max() <= 0, (f"rank {rank} {key}: {int((excess > 0).sum())} "
                                       f"elements beyond 1e-5 + the JAX mesh noise, by up to "
                                       f"{excess.max()}")
    jax.tree_util.tree_map(np.testing.assert_array_equal, got[0]["tree"], got[1]["tree"])


def test_noisy_gate_draws_differ_between_ranks(port):
    """Each rank's uniforms are its rows of the global draw from the
    generator all ranks hold alike: the ranks' differ, each is the same on
    a second draw, and dp = 1 draws their concatenation."""
    from deepspeed_tpu_torch.moe.sharded_moe import gate_noise
    r0, r1 = (r["noise"] for r in port)
    assert not torch.equal(r0["first"], r1["first"])
    for r in (r0, r1):
        torch.testing.assert_close(r["first"], r["again"], rtol=0, atol=0)
    whole = gate_noise((2 * r0["first"].shape[0], r0["first"].shape[1]),
                       torch.Generator().manual_seed(dp_ranks.NOISE_SEED))
    torch.testing.assert_close(torch.cat([r0["first"], r1["first"]]), whole, rtol=0, atol=0)


def test_what_still_raises_across_data_ranks():
    """Stage 3 with a module whose forward gathers no units (every family
    of the port gathers its own, BLOOM's since it trains across data ranks:
    `tests/test_torch_zoo_training.py`), dp x tp and dp x ep: each names its
    ROADMAP item."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils import groups
    groups.initialize(groups.MeshTopology(dp=DP, world_size=DP, rank=0))
    try:
        with pytest.raises(NotImplementedError, match="ZeRO stage 3.*Multi-GPU"):
            deepspeed_tpu_torch.initialize(model=torch.nn.Linear(4, 4), device="cpu",
                                           config=zero_config(3))
    finally:
        groups.reset_topology()
    for axes in (dict(tp=2), dict(ep=2)):
        with pytest.raises(NotImplementedError, match="data parallelism with .*Multi-GPU"):
            groups.MeshTopology(dp=2, world_size=4, rank=0, **axes)
