"""The port's expert-parallel MoE serving held against the JAX package's on the CPU.

The tiny Qwen2-MoE and Mixtral (E = 4, k = 2; numpy weights, f32) served
at ep = 2 by both packages: the port in two `gloo` ranks, each a process of
its own holding experts [2·rank, 2·rank + 2) (`tests/torch_ep_ranks.py`,
spawned by `tests/torch_tp_ranks.py:spawn` once per module-scoped fixture);
the JAX package on two devices of the virtual CPU mesh
(`MeshTopology(ep=2)`), where its MoE layer runs `sharded_grouped_gemm`
(megablox in interpret mode, with `jax.shard_map(..., check_vma=False)` as
in `tests/test_torch_sharded.py`) or the partitioned ragged buffer. The
prompts are 8 × 64 tokens: b·s·k = 1024 rows, so `auto` takes the grouped
route in the prefill on both sides and the ragged buffer at decode.
Checked with `auto`, and with `gmm` and `ragged` forced: v1 `forward`
logits (1e-4), greedy tokens (equal), the calls of each route (K8-e and
its all-reduce, the buffer's all-gather), both ranks' logits and sampled
tokens equal. Then ranks that build their own shards (`ep_size=2,
ep_rank=rank`), a shard built for the other rank refused, training under
expert parallelism refused, and the single all-reduce after `down` against
the JAX order (one after each product), bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu.models.mixtral import init_mixtral
from deepspeed_tpu.models.mixtral import mixtral_config as jax_mixtral_config
from deepspeed_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as JaxQwen2Moe
from deepspeed_tpu.models.qwen2_moe import init_qwen2_moe
from deepspeed_tpu.models.qwen2_moe import qwen2_moe_config as jax_qwen_config
from deepspeed_tpu.ops.pallas import grouped_gemm as jax_grouped_gemm
from deepspeed_tpu.utils import groups
from deepspeed_tpu.utils.groups import MeshTopology
from deepspeed_tpu_torch.utils.partitioning import shard_tree
from tests import torch_ep_ranks as ranks
from tests import torch_tp_ranks
from tests.test_torch_qwen2_moe import numpy_tree

TOL = 1e-4
EP = ranks.EP
NEW = 6
IMPLS = ("auto", "gmm", "ragged")
JAX = {"qwen2_moe": (JaxQwen2Moe, init_qwen2_moe, jax_qwen_config),
       "mixtral": (JaxMixtral, init_mixtral, jax_mixtral_config)}


def _jax_engine_refs(name, tree, ids):
    """The JAX engine at ep = 2 under each dispatch: `forward` logits,
    greedy tokens, and the calls of the JAX `sharded_grouped_gemm`."""
    cls, _, config = JAX[name]
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "shard_map", functools.partial(jax.shard_map, check_vma=False))
        calls = []
        real = jax_grouped_gemm.sharded_grouped_gemm
        mp.setattr(jax_grouped_gemm, "sharded_grouped_gemm",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        for impl in IMPLS:
            groups.reset_topology()
            groups.initialize(MeshTopology(ep=EP, devices=jax.devices()[:EP]))
            cfg = config(ranks.family(name)[2], dtype=jnp.float32, dispatch_impl=impl)
            eng = deepspeed_tpu.init_inference(cls(cfg), params=tree, dtype="fp32")
            calls.clear()
            refs[impl] = dict(logits=np.asarray(eng.forward(ids)),
                              greedy=np.asarray(eng.generate(ids, max_new_tokens=NEW)),
                              sharded_gemm_traced=len(calls))
    groups.reset_topology()
    return refs


@pytest.fixture(scope="module", params=sorted(JAX))
def served(request, tmp_path_factory):
    name = request.param
    _, init, config = JAX[name]
    tree = numpy_tree(init, config(ranks.family(name)[2], dtype=jnp.float32), 31)
    ids = np.random.default_rng(32).integers(0, 256, (8, 64))
    got = torch_tp_ranks.spawn(ranks.serve_ep, name, tree, ids, NEW,
                               tmp_path=tmp_path_factory.mktemp(f"ep_{name}"))
    return name, tree, ids, got, _jax_engine_refs(name, tree, ids)


@pytest.mark.parametrize("impl", IMPLS)
def test_v1_matches_jax_at_ep2(served, impl):
    _, _, _, got, ref = served
    for rank in range(EP):
        np.testing.assert_allclose(got[rank][impl]["logits"], ref[impl]["logits"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got[rank][impl]["greedy"], ref[impl]["greedy"])
    # the JAX side took its expert-parallel grouped GEMM where the port did
    assert (ref[impl]["sharded_gemm_traced"] > 0) == (impl != "ragged")


def test_routes_at_ep2(served):
    """K8-e three times a layer in each grouped call with one all-reduce
    (after `down`), one all-gather a layer in each buffer call."""
    name, _, _, got, _ = served
    L = ranks._config(name).num_hidden_layers
    grouped = dict(sharded_grouped_gemm=3 * L, all_reduce=L, all_gather=0)
    buffer = dict(sharded_grouped_gemm=0, all_reduce=0, all_gather=L)

    def times(route, n):
        return {k: v * n for k, v in route.items()}

    want = {  # forward runs the training semantics: `auto` is ragged there
        "auto": (buffer, {k: grouped[k] + buffer[k] * (NEW - 1) for k in grouped}),
        "gmm": (grouped, times(grouped, NEW)),
        "ragged": (buffer, times(buffer, NEW)),
    }
    for rank in range(EP):
        for impl, (forward, generate) in want.items():
            assert got[rank][impl]["forward_calls"] == forward, (rank, impl)
            assert got[rank][impl]["generate_calls"] == generate, (rank, impl)


def test_ranks_hold_their_experts_and_agree(served):
    _, _, _, got, _ = served
    for rank in range(EP):
        assert got[rank]["topology"] == (EP, rank, 1)
        for impl in IMPLS:
            r = got[rank][impl]
            assert r["module_rank"] == (EP, rank)
            assert r["experts"][:2] == (4, 2 * rank) and r["experts"][2][0] == 2
    for impl in IMPLS:
        # the reduced and gathered outputs are the same bits on both ranks,
        # so are the logits and the draws from identically seeded generators
        np.testing.assert_array_equal(got[0][impl]["logits"], got[1][impl]["logits"])
        np.testing.assert_array_equal(got[0][impl]["sampled"], got[1][impl]["sampled"])
        assert got[0][impl]["sampled"].shape == got[0][impl]["greedy"].shape
    assert not np.array_equal(got[0]["auto"]["sampled"], got[0]["auto"]["greedy"])


@pytest.fixture(scope="module")
def shard_built(served, tmp_path_factory):
    name, tree, ids, _, ref = served
    cuts = [shard_tree(tree, EP, r, "expert") for r in range(EP)]
    got = torch_tp_ranks.spawn(ranks.serve_shard_built, name, cuts, ids, NEW,
                               tmp_path=tmp_path_factory.mktemp(f"shard_built_{name}"))
    return cuts, got, ref["auto"]


def test_shard_built_ranks_match_jax_at_ep2(shard_built):
    cuts, got, ref = shard_built
    for rank in range(EP):
        r = got[rank]
        np.testing.assert_allclose(r["logits"], ref["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["greedy"], ref["greedy"])
        flat = dict(jax.tree_util.tree_leaves_with_path(r["tree"]))
        for path, leaf in jax.tree_util.tree_leaves_with_path(cuts[rank]):
            np.testing.assert_array_equal(flat[path], leaf, err_msg=str(path))
        assert f"rank {1 - rank}'s shard of ep={EP}" in r.get("wrong_rank", "")
        assert "training under expert parallelism" in r.get("train", "")


@pytest.fixture(scope="module")
def orders(tmp_path_factory):
    """An FFN over 4 experts with an empty expert at the edge of rank 1's
    span and rows past the sizes, in both reduction orders."""
    rng = np.random.default_rng(33)
    sizes = np.asarray([13, 20, 0, 15], np.int32)
    x = rng.standard_normal((52, 16)).astype(np.float32)
    stacks = {k: (0.3 * rng.standard_normal(shape)).astype(np.float32)
              for k, shape in (("gate", (4, 16, 24)), ("up", (4, 16, 24)),
                               ("down", (4, 24, 16)))}
    return torch_tp_ranks.spawn(ranks.reduce_orders, x, sizes, stacks,
                                tmp_path=tmp_path_factory.mktemp("ep_orders"))


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_one_all_reduce_equals_the_jax_order(orders, dtype):
    for rank in range(EP):
        once, each = orders[rank][dtype]
        assert torch.equal(once, each)
        assert torch.equal(once, orders[0][dtype][0])
        assert once[48:].abs().sum() == 0 and once[:48].abs().min() > 0
