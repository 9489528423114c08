"""The port's BLOOM held against the JAX package's on the CPU.

`bloom-tiny` (4 heads of 16, 2 layers, vocab 256) in fp32; one parameter
tree made with numpy from a seed (kernels, embedding and biases normal,
LayerNorm scales near 1) is loaded into both packages. Logits and the loss
must agree to 1e-4, a cached prefill plus 10 decode steps must give full
`forward`'s logits to 1e-4 (the JAX `test_bloom_cached_decode_matches_full`
holds its own to 2e-4), the tree must come back bit for bit, and the v1
engines' greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.bloom import (
    BloomForCausalLM as JaxBloom,
    bloom_config as jax_bloom_config,
    init_bloom as jax_init_bloom,
)
from deepspeed_tpu_torch.inference.kv_cache import KVCache
from deepspeed_tpu_torch.models import BloomForCausalLM, bloom_config, init_bloom
from deepspeed_tpu_torch.models.bloom import bloom_loss_fn, to_jax_params

TOL = 1e-4
SEED = 11


def numpy_tree(seed: int = SEED):
    """A JAX BLOOM tree of bloom-tiny, made with numpy."""
    cfg = jax_bloom_config("bloom-tiny", dtype=jnp.float32)
    _, params, _ = jax_init_bloom(cfg)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(x.shape)).astype(np.float32)

    return cfg, jax.tree_util.tree_map_with_path(leaf, params)


def port_model(tree=None):
    model = BloomForCausalLM(bloom_config("bloom-tiny", dtype=torch.float32))
    return model if tree is None else model.load_jax_params(tree)


@pytest.fixture(scope="module")
def reference():
    cfg, tree = numpy_tree()
    ids = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (2, 16))
    return cfg, tree, ids


def test_forward_logits_and_loss_match_jax(reference):
    cfg, tree, ids = reference
    jmodel = JaxBloom(cfg)
    ref = jmodel.apply({"params": tree}, jnp.asarray(ids, jnp.int32))
    ref_loss, _ = jmodel.apply({"params": tree}, jnp.asarray(ids, jnp.int32),
                               labels=jnp.asarray(ids, jnp.int32))
    model = port_model(tree)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
        loss, aux = bloom_loss_fn(model)(model, {"input_ids": torch.from_numpy(ids),
                                                 "labels": torch.from_numpy(ids)})
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=TOL, atol=TOL)


# tier-1 on purpose: bloom-tiny's 10 eager port steps and one JAX forward take ~1.2 s
def test_cached_decode_matches_full_forward(reference):  # tpulint: disable=slow-mark-discipline
    """A 6-token prefill into a dense cache, then 10 single-token steps:
    every position's logits equal full `forward`'s, the port's and JAX's."""
    cfg, tree, ids = reference
    full_jax = np.asarray(JaxBloom(cfg).apply({"params": tree}, jnp.asarray(ids, jnp.int32)))
    model = port_model(tree)
    cache = KVCache.create(cfg.num_hidden_layers, ids.shape[0], 32, cfg.num_attention_heads,
                           cfg.head_dim, dtype=torch.float32)
    t = torch.from_numpy(ids)
    with torch.no_grad():
        full = model(t)
        logits, cache = model(t[:, :6], cache=cache)
        outs = [logits]
        for i in range(6, 16):
            logits, cache = model(t[:, i:i + 1], cache=cache)
            outs.append(logits)
    got = torch.cat(outs, dim=1)
    assert cache.index.tolist() == [16, 16]
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), full_jax, rtol=TOL, atol=TOL)


def test_logits_at_picks_one_row_each(reference):
    """`logits_at` runs the tied head on one position per row only."""
    cfg, tree, ids = reference
    model = port_model(tree)
    at = torch.tensor([3, 15])
    def make():
        return KVCache.create(cfg.num_hidden_layers, 2, 32, cfg.num_attention_heads,
                              cfg.head_dim, dtype=torch.float32)

    with torch.no_grad():
        every, _ = model(torch.from_numpy(ids), cache=make())
        picked, _ = model(torch.from_numpy(ids), cache=make(), logits_at=at)
    assert picked.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(picked.numpy(), every[torch.arange(2), at].numpy(),
                               rtol=TOL, atol=TOL)


def test_to_jax_params_round_trip(reference):
    """Every JAX leaf lands in the module and comes back bit for bit, in the
    JAX tree's structure; the tied head stays the embedding."""
    _, tree, _ = reference
    model = port_model(tree)
    back = to_jax_params(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    assert not any("lm_head" in name for name, _ in model.named_parameters())


def test_init_bloom_follows_the_generator():
    """Random weights as the JAX package draws them in kind (normal kernels
    and embedding, zero biases, unit scales), repeatable from the seed."""
    cfg = bloom_config("bloom-tiny", dtype=torch.float32)
    a = init_bloom(cfg, torch.Generator().manual_seed(4))
    b = init_bloom(cfg, torch.Generator().manual_seed(4))
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
        if name.endswith(".scale"):
            assert torch.all(p == 1.0)
        elif name.endswith(".bias"):
            assert torch.all(p == 0.0)
        else:
            assert 0.015 < p.std().item() < 0.025, name


def test_v1_greedy_generate_matches_jax_engine(reference):
    """`init_inference(...).generate` on the masked alibi path: greedy tokens
    equal to the JAX v1 engine's, and `forward` within 1e-4."""
    cfg, tree, ids = reference
    jax_engine = deepspeed_tpu.init_inference(JaxBloom(cfg), params=tree, dtype="fp32")
    engine = deepspeed_tpu_torch.init_inference(port_model(), params=tree, dtype="fp32",
                                                device="cpu")
    prompts = ids[:, :7]
    ref = np.asarray(jax_engine.generate(prompts, max_new_tokens=8))
    got = engine.generate(prompts, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(engine.forward(ids).numpy(),
                               np.asarray(jax_engine.forward(ids)), rtol=TOL, atol=TOL)


def test_quant_on_bloom_raises(reference):
    """int8 weights outside the llama layer-scan layout are not ported."""
    _, tree, _ = reference
    with pytest.raises(NotImplementedError, match="Weight quantization and serve modes"):
        deepspeed_tpu_torch.init_inference(port_model(), params=tree, dtype="fp32",
                                           device="cpu", quant={"enabled": True})
