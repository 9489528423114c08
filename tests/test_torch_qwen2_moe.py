"""The port's Qwen2-MoE held against the JAX package's on the CPU.

The tiny preset (E = 4, k = 2, a shared expert, qkv biases) in fp32, with
weights made from a seed with numpy and handed to both packages. The
uncached forward (the training semantics: capacity 1.25, tokens over it
dropped) and a cached prefill with decode steps (no drops) agree with
`model.apply` to 1e-4, with the dispatch left to `auto` and forced to the
grouped GEMM (megablox in interpret mode on the JAX side). A prefill of
b·s·k = 1024 rows takes the grouped GEMM under `auto` on both sides.
Greedy `generate` through `init_inference` gives the JAX engine's tokens.
`init_inference` places the model from a tree and from its own weights;
`quant` on it raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.kv_cache import KVCache as JaxKVCache
from deepspeed_tpu.models.qwen2_moe import (
    Qwen2MoeForCausalLM as JaxQwen2Moe,
    init_qwen2_moe,
    qwen2_moe_config as jax_qwen2_moe_config,
)
from deepspeed_tpu.utils import groups
from deepspeed_tpu.utils.groups import MeshTopology
from deepspeed_tpu_torch.inference.kv_cache import KVCache
from deepspeed_tpu_torch.models.qwen2_moe import (
    Qwen2MoeForCausalLM,
    qwen2_moe_config,
    to_jax_params,
)

TOL = 1e-4


def numpy_tree(init, cfg, seed):
    """A JAX parameter tree of `cfg` made with numpy: normal(0.02) kernels,
    embeddings, routers and experts (0.2 for biases), RMSNorm weights near 1."""
    _, params, _ = init(cfg)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        key = jax.tree_util.keystr(path)
        if "norm" in key:
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        std = 0.2 if "bias" in key else 0.02
        return (std * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def jax_cfg(**overrides):
    return jax_qwen2_moe_config("qwen2moe-tiny", dtype=jnp.float32, **overrides)


def port_model(tree, **overrides):
    model = Qwen2MoeForCausalLM(qwen2_moe_config("qwen2moe-tiny", dtype=torch.float32,
                                                 **overrides))
    return model.load_jax_params(tree)


def cached_both(jmodel, tree, model, cfg, ids, max_len, steps):
    """A cached prefill of `ids` and `steps` greedy decode steps through a
    dense cache in both packages: lists of (JAX logits, port logits)."""
    jcache = JaxKVCache.create(cfg.num_hidden_layers, ids.shape[0], max_len,
                               cfg.num_key_value_heads, cfg.head_dim, dtype=jnp.float32)
    cache = KVCache.create(cfg.num_hidden_layers, ids.shape[0], max_len,
                           cfg.num_key_value_heads, cfg.head_dim, dtype=torch.float32)
    pairs, jids, tids = [], jnp.asarray(ids, jnp.int32), torch.from_numpy(ids)
    with torch.no_grad():
        for _ in range(steps + 1):
            ref, jcache = jmodel.apply({"params": tree}, jids, cache=jcache)
            got, cache = model(tids, cache=cache)
            pairs.append((np.asarray(ref), got.numpy()))
            nxt = np.asarray(ref)[:, -1].argmax(-1)
            jids, tids = jnp.asarray(nxt[:, None], jnp.int32), torch.from_numpy(nxt[:, None])
    np.testing.assert_array_equal(cache.index.numpy(), np.asarray(jcache.index))
    return pairs


@pytest.fixture(scope="module")
def tree():
    return numpy_tree(init_qwen2_moe, jax_cfg(), 0)


def test_load_jax_params_round_trip(tree):
    """Every JAX leaf lands in the module and reads back unchanged."""
    back = to_jax_params(port_model(tree))
    flat, ref = jax.tree_util.tree_leaves_with_path(back), \
        jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat] == [p for p, _ in ref]
    for (path, got), (_, want) in zip(flat, ref):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(path))


def test_load_jax_params_refuses_a_tree_of_another_model(tree):
    bad = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "shared_expert"})
    with pytest.raises(KeyError, match="missing"):
        port_model(bad)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_forward_with_drops_matches_jax(tree, capacity_factor):
    """The uncached forward routes with the capacity limit, as `model.apply`
    does; at 0.5 most experts drop tokens. A cached prefill of the same
    tokens (no drops) differs."""
    cfg = jax_cfg(capacity_factor=capacity_factor)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 10))
    ref = np.asarray(JaxQwen2Moe(cfg).apply({"params": tree}, jnp.asarray(ids, jnp.int32)))
    model = port_model(tree, capacity_factor=capacity_factor)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    if capacity_factor < 1:
        prefill = cached_both(JaxQwen2Moe(cfg), tree, model, cfg, ids, 16, 0)[0][1]
        assert np.abs(prefill - got).max() > 1e-3


@pytest.mark.parametrize("dispatch_impl", ["auto", "gmm"])
def test_cached_prefill_and_decode_match_jax(tree, dispatch_impl):
    """No drops in the cached path; `gmm` forces the grouped GEMM on both
    sides (the plain version here, megablox in interpret mode there)."""
    cfg = jax_cfg(dispatch_impl=dispatch_impl)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    model = port_model(tree, dispatch_impl=dispatch_impl)
    for ref, got in cached_both(JaxQwen2Moe(cfg), tree, model, cfg, ids, 16, 2):
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_auto_takes_the_grouped_gemm_at_1024_rows(tree, monkeypatch):
    """B = 2, S = 256, k = 2: b·s·k = 1024 rows, so `auto` runs the grouped
    GEMM on a one-device JAX mesh and in the port (3 calls a layer)."""
    from deepspeed_tpu_torch.ops.cuda import grouped_gemm as gg
    groups.initialize(MeshTopology(devices=jax.devices()[:1]))
    cfg = jax_cfg()
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 256))
    model = port_model(tree)
    rows, plain = [], gg.grouped_gemm_plain
    monkeypatch.setattr(gg, "grouped_gemm_plain",
                        lambda lhs, *a: rows.append(lhs.shape[0]) or plain(lhs, *a))
    (ref, got), = cached_both(JaxQwen2Moe(cfg), tree, model, cfg, ids, 256, 0)
    assert rows == [2 * 256 * 2] * (3 * cfg.num_hidden_layers)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_greedy_generate_matches_jax_engine(tree):
    ids = np.random.default_rng(4).integers(0, 256, (3, 6))
    jax_engine = deepspeed_tpu.init_inference(JaxQwen2Moe(jax_cfg()), params=tree,
                                              dtype="fp32")
    ref = np.asarray(jax_engine.generate(ids, max_new_tokens=6))
    model = Qwen2MoeForCausalLM(qwen2_moe_config("qwen2moe-tiny", dtype=torch.float32))
    engine = deepspeed_tpu_torch.init_inference(model, params=tree, dtype="fp32",
                                                device="cpu")
    assert engine.serve_mode == "dequant" and engine.params is None
    np.testing.assert_array_equal(engine.generate(ids, max_new_tokens=6).numpy(), ref)
    np.testing.assert_allclose(engine.forward(ids).numpy(),
                               np.asarray(jax_engine.forward(ids)), rtol=TOL, atol=TOL)


def test_init_inference_places_the_modules_own_weights():
    """With no tree the module keeps its own weights, cast and placed by the
    engine (the placement reaches them through the module's `param_tree`)."""
    model = Qwen2MoeForCausalLM(qwen2_moe_config("qwen2moe-tiny", dtype=torch.float32))
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 5)))
    with torch.no_grad():
        ref = model(ids)
    engine = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu")
    assert engine.module is model and engine.serve_mode == "dequant"
    torch.testing.assert_close(engine.forward(ids), ref, rtol=0, atol=0)
    assert engine.generate(ids, max_new_tokens=3).shape == (2, 8)


@pytest.mark.parametrize("serve_mode", ["dequant", "layer_scan"])
def test_quant_on_an_moe_model_raises(tree, serve_mode):
    model = Qwen2MoeForCausalLM(qwen2_moe_config("qwen2moe-tiny", dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="Weight quantization and serve modes"):
        deepspeed_tpu_torch.init_inference(model, params=tree, dtype="fp32", device="cpu",
                                           quant={"enabled": True}, serve_mode=serve_mode)


def test_moe_training_and_paged_caches_raise():
    """Training runs with `labels=` (remat "nothing" only: other policies
    raise); a paged cache raises."""
    from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache
    with pytest.raises(NotImplementedError, match="Training: the rest"):
        Qwen2MoeForCausalLM(qwen2_moe_config("qwen2moe-tiny", dtype=torch.float32, remat=True,
                                             remat_policy="checkpoint_dots"))
    model = Qwen2MoeForCausalLM(qwen2_moe_config("qwen2moe-tiny", dtype=torch.float32))
    ids = torch.zeros((1, 4), dtype=torch.long)
    loss, aux = model(ids, labels=ids)
    assert torch.isfinite(loss) and set(aux) == {"moe_aux_loss", "router_load", "router_drop"}
    paged = PagedKVCache.__new__(PagedKVCache)
    with pytest.raises(NotImplementedError, match="MoE: the rest"):
        model(ids, cache=paged)
