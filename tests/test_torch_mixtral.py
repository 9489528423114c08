"""The port's Mixtral held against the JAX package's on the CPU.

The second MoE family through the same modules: no shared expert, no qkv
bias, top-k weights renormalized over the kept experts
(`norm_topk_prob=True`), a capacity factor of 1.0 in the cached path and
1.25 with drops in the uncached one. The tiny preset in fp32 with numpy
weights from a seed; logits to 1e-4, greedy tokens equal to the JAX
engine's. The helpers are the Qwen2-MoE file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.mixtral import (
    MixtralForCausalLM as JaxMixtral,
    init_mixtral,
    mixtral_config as jax_mixtral_config,
)
from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM, mixtral_config, to_jax_params
from tests.test_torch_qwen2_moe import TOL, cached_both, numpy_tree


def jax_cfg(**overrides):
    return jax_mixtral_config("mixtral-tiny", dtype=jnp.float32, **overrides)


def port_model(tree, **overrides):
    return MixtralForCausalLM(mixtral_config("mixtral-tiny", dtype=torch.float32,
                                             **overrides)).load_jax_params(tree)


@pytest.fixture(scope="module")
def tree():
    return numpy_tree(init_mixtral, jax_cfg(), 10)


def test_load_jax_params_round_trip(tree):
    back = to_jax_params(port_model(tree))
    flat, ref = jax.tree_util.tree_leaves_with_path(back), \
        jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat] == [p for p, _ in ref]
    for (path, got), (_, want) in zip(flat, ref):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(path))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_forward_with_drops_matches_jax(tree, capacity_factor):
    cfg = jax_cfg(capacity_factor=capacity_factor)
    ids = np.random.default_rng(11).integers(0, cfg.vocab_size, (3, 10))
    ref = np.asarray(JaxMixtral(cfg).apply({"params": tree}, jnp.asarray(ids, jnp.int32)))
    with torch.inference_mode():
        got = port_model(tree, capacity_factor=capacity_factor)(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dispatch_impl", ["auto", "gmm"])
def test_cached_prefill_and_decode_match_jax(tree, dispatch_impl):
    cfg = jax_cfg(dispatch_impl=dispatch_impl)
    ids = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 7))
    model = port_model(tree, dispatch_impl=dispatch_impl)
    for ref, got in cached_both(JaxMixtral(cfg), tree, model, cfg, ids, 16, 2):
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_greedy_generate_matches_jax_engine(tree):
    ids = np.random.default_rng(13).integers(0, 256, (3, 6))
    jax_engine = deepspeed_tpu.init_inference(JaxMixtral(jax_cfg()), params=tree,
                                              dtype="fp32")
    ref = np.asarray(jax_engine.generate(ids, max_new_tokens=6))
    model = MixtralForCausalLM(mixtral_config("mixtral-tiny", dtype=torch.float32))
    engine = deepspeed_tpu_torch.init_inference(model, params=tree, dtype="fp32",
                                                device="cpu")
    np.testing.assert_array_equal(engine.generate(ids, max_new_tokens=6).numpy(), ref)


def test_quant_on_mixtral_raises(tree):
    model = MixtralForCausalLM(mixtral_config("mixtral-tiny", dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="Weight quantization and serve modes"):
        deepspeed_tpu_torch.init_inference(model, params=tree, dtype="fp32", device="cpu",
                                           quant={"enabled": True})
