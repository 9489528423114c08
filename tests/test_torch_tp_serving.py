"""The port's tensor-parallel serving held against the JAX package's on the CPU.

The tiny Llama of `test_torch_llama` (H = 8, Hkv = 2; numpy weights, f32)
served at tp = 2 by both packages: the port in two `gloo` ranks, each a
process of its own holding its shard (`tests/torch_tp_ranks.py`, spawned
once per scenario in a module-scoped fixture); the JAX package on two
devices of the virtual CPU mesh (`MeshTopology(tp=2)`), where the
partitioner splits the same tree. Checked: v1 `forward` logits (1e-4) and
greedy tokens (equal), v2 greedy tokens and put logits over the paged cache
(the port's K3/K4 per-shard plain versions) with equal block tables on both
ranks, int8 weights through the layer scan (the rank's int8 bytes and scales
equal the matching cut of the JAX engine's tree, logits within 1e-4, greedy
tokens equal, no kernel fallback), sampled tokens equal across ranks, and
every rank's shard shapes; then v1 and the int8 layer scan again from
shards the ranks build themselves (`LlamaForCausalLM(cfg, tp_size=2,
tp_rank=rank)`, the route of `chip_smoke.py`), and a shard built for the
other rank refused. The JAX layer scan at tp = 2 runs its naive
dequant matmul: its sharded fused kernel does not run in interpret mode on
this JAX (ROADMAP.md's reference caveats), and both compute the same
products.
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngineV2
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.utils import groups
from deepspeed_tpu.utils.groups import MeshTopology
from deepspeed_tpu_torch.utils.partitioning import shard_tree
from tests import torch_tp_ranks as ranks
from tests.test_torch_llama import TINY, numpy_tree

TOL = 1e-4
TP = ranks.TP
NEW = 6
V2_ENGINE = dict(max_batch=2, max_seq_len=64, cache_block_size=8, split_fuse_chunk=8,
                 num_cache_blocks=16)
GROUP = 16  # per-row scale groups that divide every shard's rows


def _jax_tp():
    groups.reset_topology()
    return groups.initialize(MeshTopology(tp=TP, devices=jax.devices()[:TP]))


def _ids(cfg, seed, shape=(3, 9)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _prompts(vocab):
    rng = np.random.default_rng(23)
    shared = list(map(int, rng.integers(0, vocab, 16)))
    tail = [list(map(int, rng.integers(0, vocab, n))) for n in (5, 19, 3, 12)]
    return [tail[0], tail[1], shared + tail[2], shared + tail[3]]


@pytest.fixture(scope="module")
def v1(tmp_path_factory):
    cfg, tree = numpy_tree(61)
    ids = _ids(cfg, 62)
    got = ranks.spawn(ranks.serve_v1, tree, TINY, ids, NEW,
                      tmp_path=tmp_path_factory.mktemp("v1"))
    _jax_tp()
    eng = deepspeed_tpu.init_inference(JaxLlama(cfg), params=tree, dtype="fp32",
                                       tensor_parallel={"tp_size": TP})
    ref = dict(logits=np.asarray(eng.forward(ids)),
               greedy=np.asarray(eng.generate(ids, max_new_tokens=NEW)), inputs=(tree, ids))
    groups.reset_topology()
    return cfg, got, ref


def test_v1_forward_and_greedy_match_jax_at_tp2(v1):
    cfg, got, ref = v1
    for rank in range(TP):
        np.testing.assert_allclose(got[rank]["logits"], ref["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got[rank]["greedy"], ref["greedy"])


def test_v1_ranks_hold_their_shards_and_agree_on_samples(v1):
    cfg, got, _ = v1
    for rank in range(TP):
        r = got[rank]
        assert r["topology"] == (TP, rank) and r["model_rank"] == rank
        assert r["heads"] == (cfg.num_attention_heads // TP, cfg.num_key_value_heads // TP)
        assert r["q_rows"] == (cfg.num_attention_heads // TP * cfg.head_dim, cfg.hidden_size)
        assert r["embed_rows"] == cfg.vocab_size // TP
    # the gathered logits are the same bits on both ranks, so are the draws
    np.testing.assert_array_equal(got[0]["logits"], got[1]["logits"])
    np.testing.assert_array_equal(got[0]["sampled"], got[1]["sampled"])
    assert got[0]["sampled"].shape == got[0]["greedy"].shape
    assert not np.array_equal(got[0]["sampled"], got[0]["greedy"])


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    cfg, tree = numpy_tree(63)
    prompts = _prompts(cfg.vocab_size)
    got = ranks.spawn(ranks.serve_v2, tree, TINY, prompts, NEW, V2_ENGINE,
                      tmp_path=tmp_path_factory.mktemp("v2"))
    _jax_tp()
    eng = JaxEngineV2(JaxLlama(cfg), config=JaxConfig(dtype="fp32",
                                                      tensor_parallel={"tp_size": TP}),
                      params=tree, **V2_ENGINE)
    ref = ranks.v2_script(eng, prompts, NEW)
    groups.reset_topology()
    return cfg, prompts, got, ref


def test_v2_rows_match_jax_at_tp2(v2):
    cfg, prompts, got, ref = v2
    for rank in range(TP):
        assert got[rank]["greedy"] == ref["greedy"]
        assert [len(r) for r in got[rank]["greedy"]] == [len(p) + NEW for p in prompts]
        for a, b in zip(got[rank]["put_logits"], ref["put_logits"]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        assert got[rank]["pool_heads"] == cfg.num_key_value_heads // TP
        # every paged call went through the per-shard wrappers
        assert got[rank]["calls"]["sharded_paged_decode_attention"] > 0
        assert got[rank]["calls"]["sharded_paged_prefill_attention"] > 0


def test_v2_ranks_schedule_the_same_tables(v2):
    _, _, got, _ = v2
    assert len(got[0]["digests"]) > 10
    assert got[0]["digests"] == got[1]["digests"]


@pytest.fixture(scope="module")
def int8(tmp_path_factory):
    cfg, tree = numpy_tree(65)
    ids = _ids(cfg, 66, (2, 7))
    got = ranks.spawn(ranks.serve_int8, tree, TINY, ids, NEW, GROUP,
                      tmp_path=tmp_path_factory.mktemp("int8"))
    _jax_tp()
    eng = deepspeed_tpu.init_inference(
        JaxLlama(cfg), params=tree, dtype="fp32", tensor_parallel={"tp_size": TP},
        quant={"enabled": True, "group_size": GROUP}, serve_mode="layer_scan",
        fused_int8=False)
    ref = dict(serve_mode=eng.serve_mode,
               tree=jax.tree_util.tree_map(np.asarray, eng.params),
               logits=np.asarray(eng.forward(ids)),
               greedy=np.asarray(eng.generate(ids, max_new_tokens=NEW)), inputs=(tree, ids))
    groups.reset_topology()
    return got, ref


def _assert_jax_tree_cut(got_tree, jax_tree, rank):
    want = shard_tree(jax_tree, TP, rank)
    flat_got = jax.tree_util.tree_leaves_with_path(got_tree)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        assert leaf.dtype == flat_want[path].dtype, path
        np.testing.assert_array_equal(leaf, flat_want[path])


def test_int8_layer_scan_shards_are_the_jax_tree_cut(int8):
    got, ref = int8
    for rank in range(TP):
        assert got[rank]["serve_mode"] == ref["serve_mode"] == "layer_scan"
        _assert_jax_tree_cut(got[rank]["tree"], ref["tree"], rank)


def test_int8_layer_scan_matches_jax_at_tp2(int8):
    got, ref = int8
    for rank in range(TP):
        r = got[rank]
        np.testing.assert_allclose(r["logits"], ref["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["scan_logits"], ref["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["greedy"], ref["greedy"])
        assert r["fallbacks"] == []
        # q/gate/up per column shard, o/down per row shard, in every layer;
        # k/v (64 x 32) stay f32, under the quantizer's 4096-element minimum
        assert 2 * r["flavors"]["n"] == 3 * r["flavors"]["k"] > 0


@pytest.fixture(scope="module")
def shard_built(tmp_path_factory, v1, int8):
    """Ranks that build their own shards (`LlamaForCausalLM(cfg,
    tp_size=2, tp_rank=rank)`, the route of `chip_smoke.py`'s ranks), on
    the inputs of the `v1` and `int8` scenarios, against the same JAX
    engines."""
    (_, _, ref_v1), (_, ref_int8) = v1, int8
    trees, ids = zip(ref_v1["inputs"], ref_int8["inputs"])
    got = ranks.spawn(ranks.serve_shard_built, trees, TINY, ids, NEW, GROUP,
                      tmp_path=tmp_path_factory.mktemp("shard_built"))
    return got, ref_v1, ref_int8


def test_shard_built_ranks_match_jax_at_tp2(shard_built):
    got, ref_v1, ref_int8 = shard_built
    for rank in range(TP):
        r = got[rank]
        np.testing.assert_allclose(r["logits"], ref_v1["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["greedy"], ref_v1["greedy"])
        # each rank quantizes its own shard: the cut of the JAX engine's tree
        assert r["int8_serve_mode"] == "layer_scan"
        _assert_jax_tree_cut(r["int8_tree"], ref_int8["tree"], rank)
        np.testing.assert_allclose(r["int8_logits"], ref_int8["logits"], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["int8_greedy"], ref_int8["greedy"])


def test_shard_built_for_another_rank_is_refused(shard_built):
    got, _, _ = shard_built
    for rank in range(TP):
        assert f"rank {1 - rank}'s shard of tp={TP}" in got[rank].get("wrong_rank", "")
