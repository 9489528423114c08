"""The port's Llama held against the JAX package's on the CPU.

A tiny config with H=8 and Hkv=2 (n_rep = 4, as in Llama-3), in fp32.
Weights and inputs are made from a seed with numpy and handed to both
sides; logits must agree to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.kv_cache import KVCache as JaxKVCache
from deepspeed_tpu.models.llama import (
    LlamaForCausalLM as JaxLlama,
    llama_config as jax_llama_config,
    materialize_params,
)
from deepspeed_tpu_torch.inference.kv_cache import KVCache
from deepspeed_tpu_torch.models.llama import (
    LlamaForCausalLM,
    llama_config,
    load_jax_params,
)

TOL = 1e-4
TINY = dict(num_attention_heads=8, num_key_value_heads=2)


def numpy_tree(seed: int = 0, **overrides):
    """A JAX Llama parameter tree of the tiny config, made with numpy:
    normal(0.02) kernels and embeddings, RMSNorm weights near 1."""
    cfg = jax_llama_config("llama-tiny", dtype=jnp.float32, **TINY, **overrides)
    _, params = materialize_params(cfg)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if "norm" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(x.shape)).astype(np.float32)

    return cfg, jax.tree_util.tree_map_with_path(leaf, params)


def port_model(tree, **overrides):
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **TINY,
                                          **overrides))
    return load_jax_params(model, tree)


def prefill_both(tree, cfg, ids, max_len, **overrides):
    """Prefill `ids` through a fresh dense cache in both packages: (JAX
    model, JAX logits, JAX cache, port model, port logits, port cache)."""
    jmodel = JaxLlama(cfg)
    jcache = JaxKVCache.create(cfg.num_hidden_layers, ids.shape[0], max_len,
                               cfg.num_key_value_heads, cfg.head_dim,
                               dtype=jnp.float32)
    ref, jcache = jmodel.apply({"params": tree}, jnp.asarray(ids, jnp.int32),
                               cache=jcache)
    model = port_model(tree, **overrides)
    cache = KVCache.create(cfg.num_hidden_layers, ids.shape[0], max_len,
                           cfg.num_key_value_heads, cfg.head_dim,
                           dtype=torch.float32)
    with torch.no_grad():
        got, cache = model(torch.from_numpy(ids), cache=cache)
    return jmodel, ref, jcache, model, got, cache


def assert_caches_match(cache, jcache):
    np.testing.assert_array_equal(cache.index.numpy(), np.asarray(jcache.index))
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), rtol=TOL, atol=TOL)


def test_load_jax_params_round_trip():
    """Every JAX leaf lands in the port's module, and reading the module
    back into the JAX layout gives the tree unchanged."""
    _, tree = numpy_tree(1)
    model = port_model(tree)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = {"embed_tokens": sd["embed_tokens"], "norm": {"weight": sd["norm.weight"]},
            "lm_head": sd["lm_head.weight"].T, "layers": {}}
    n = model.cfg.num_hidden_layers
    for key in tree["layers"]:
        back["layers"][key] = {}
        for sub, leaves in tree["layers"][key].items():
            if sub == "weight":
                back["layers"][key]["weight"] = np.stack(
                    [sd[f"layers.{i}.{key}.weight"] for i in range(n)])
                continue
            back["layers"][key][sub] = {"kernel": np.stack(
                [sd[f"layers.{i}.{key}.{sub}.weight"].T for i in range(n)])}
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    # nothing else in the module: 3 unstacked leaves, the rest one per layer
    assert len(sd) == 3 + (len(jax.tree_util.tree_leaves(tree)) - 3) * n


def test_logits_without_cache_match_jax():
    cfg, tree = numpy_tree(2)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    ref = JaxLlama(cfg).apply({"params": tree}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = port_model(tree)(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("max_len,window", [(32, None), (14, None), (32, 4)])
def test_prefill_and_one_step_match_jax_cached_path(max_len, window):
    """Prefill through the dense cache, then one single-token step: logits,
    cache contents and cursors against the JAX cached path. max_len 14 puts
    the step's slot at the last column; window 4 bands the decode mask."""
    cfg, tree = numpy_tree(4, sliding_window=window)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.vocab_size, (2, 13))
    step = rng.integers(0, cfg.vocab_size, (2, 1))
    jmodel, ref1, jcache, model, got1, cache = prefill_both(
        tree, cfg, ids, max_len, sliding_window=window)
    ref2, jcache = jmodel.apply({"params": tree}, jnp.asarray(step, jnp.int32),
                                cache=jcache)
    with torch.no_grad():
        got2, cache = model(torch.from_numpy(step), cache=cache)
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref2), rtol=TOL, atol=TOL)
    assert_caches_match(cache, jcache)


def test_truncate_then_step_matches_jax():
    """Rolling the cursors back and stepping again overwrites the abandoned
    slot and never attends past the cursor, as in the JAX cache."""
    cfg, tree = numpy_tree(14)
    rng = np.random.default_rng(15)
    ids = rng.integers(0, cfg.vocab_size, (2, 9))
    step = rng.integers(0, cfg.vocab_size, (2, 1))
    back = np.asarray([5, 8], np.int32)
    jmodel, _, jcache, model, _, cache = prefill_both(tree, cfg, ids, 16)
    ref, jcache = jmodel.apply({"params": tree}, jnp.asarray(step, jnp.int32),
                               cache=jcache.truncate(jnp.asarray(back)))
    with torch.no_grad():
        got, cache = model(torch.from_numpy(step), cache=cache.truncate(back))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert_caches_match(cache, jcache)


def test_cache_write_drops_columns_past_max_len():
    """update_layer keeps JAX's mode='drop': a write that runs past the end
    of the cache lands its in-range columns and drops the rest."""
    from deepspeed_tpu.inference.kv_cache import update_layer as jax_update
    from deepspeed_tpu_torch.inference.kv_cache import update_layer

    rng = np.random.default_rng(6)
    k = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    index = np.asarray([2, 6, 9], np.int32)  # fits, straddles, all past
    ref, _ = jax_update(jnp.asarray(k), jnp.asarray(k), jnp.asarray(new),
                        jnp.asarray(new), jnp.asarray(index))
    got = torch.from_numpy(k.copy())
    update_layer(got, got.clone(), torch.from_numpy(new), torch.from_numpy(new),
                 torch.from_numpy(index))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
