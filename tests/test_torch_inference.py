"""The port's serving path held against the JAX package's on the CPU.

`init_inference(..., device="cpu")` → `forward` and greedy `generate`
against the JAX `InferenceEngine` on the same numpy weights, in fp32:
tokens equal and logits within 1e-4. Also the sampling cuts, the device and
config rules, and that the port imports neither JAX nor the JAX package.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.ops.sampling import top_p_mask as jax_top_p_mask
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
from deepspeed_tpu_torch.ops.sampling import sample_logits, top_k_mask, top_p_mask
from tests.test_torch_llama import TINY, numpy_tree

TOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]


def engines(seed: int):
    cfg, tree = numpy_tree(seed)
    jax_engine = deepspeed_tpu.init_inference(JaxLlama(cfg), params=tree, dtype="fp32")
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **TINY))
    engine = deepspeed_tpu_torch.init_inference(model, params=tree, dtype="fp32",
                                                device="cpu")
    return cfg, jax_engine, engine


def test_forward_matches_jax_engine():
    cfg, jax_engine, engine = engines(7)
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 10))
    np.testing.assert_allclose(engine.forward(ids).numpy(),
                               np.asarray(jax_engine.forward(ids)),
                               rtol=TOL, atol=TOL)


def test_greedy_generate_matches_jax_engine():
    """Greedy tokens equal with and without eos; with eos, a row that emits
    it pads every later token."""
    cfg, jax_engine, engine = engines(9)
    ids = np.random.default_rng(10).integers(0, cfg.vocab_size, (3, 6))
    ref = np.asarray(jax_engine.generate(ids, max_new_tokens=7))
    got = engine.generate(ids, max_new_tokens=7).numpy()
    np.testing.assert_array_equal(got, ref)
    assert engine.last_decode_tok_s > 0

    eos = int(ref[0, 6 + 2])  # row 0 emits it as its third new token
    ref_eos = np.asarray(jax_engine.generate(ids, max_new_tokens=7,
                                             eos_token_id=eos, pad_token_id=1))
    got_eos = engine.generate(ids, max_new_tokens=7, eos_token_id=eos,
                              pad_token_id=1).numpy()
    np.testing.assert_array_equal(got_eos, ref_eos)
    assert (got_eos[0, 6 + 3:] == 1).all()


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9])
def test_top_p_mask_matches_jax(p):
    logits = np.random.default_rng(11).standard_normal((4, 64)).astype(np.float32)
    ref = np.asarray(jax_top_p_mask(jnp.asarray(logits), p))
    np.testing.assert_array_equal(top_p_mask(torch.from_numpy(logits), p).numpy(), ref)


def test_top_k_cut_matches_jax():
    logits = np.random.default_rng(12).standard_normal((4, 64)).astype(np.float32)
    kth = jax.lax.top_k(jnp.asarray(logits), 5)[0][..., -1:]
    ref = np.asarray(jnp.where(jnp.asarray(logits) < kth, -jnp.inf, logits))
    np.testing.assert_array_equal(top_k_mask(torch.from_numpy(logits), 5).numpy(), ref)


def test_sampling_draws_only_inside_the_cuts():
    logits = torch.from_numpy(
        np.random.default_rng(13).standard_normal((64, 32)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    toks = sample_logits(logits, gen, temperature=0.8, top_k=4, top_p=0.9)
    top4 = torch.topk(logits, 4, dim=-1).indices
    assert (toks[:, None] == top4).any(dim=-1).all()
    assert torch.equal(sample_logits(logits), logits.argmax(dim=-1))


def test_init_inference_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for one without")
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.init_inference(model)


@pytest.mark.parametrize("config", [
    {"serve_mode": "layer_scan"}, {"serve_mode": "capacity"},
    {"quant": {"enabled": True}}, {"kv_cache_dtype": "int8"},
    {"speculative": {"enabled": True, "k": 4}}, {"capacity": {}},
    {"tensor_parallel": {"tp_size": 2}}, {"dtype": "int8"},
])
def test_unported_config_values_raise(config):
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        deepspeed_tpu_torch.init_inference(model, config=config, device="cpu")


@pytest.mark.parametrize("impl", ["pallas", "decode_pallas"])
def test_window_on_a_kernel_path_raises(impl):
    from deepspeed_tpu_torch.ops.attention import attention, cached_attention
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if impl == "pallas":
            attention(x, x, x, impl=impl, window=2)
        else:
            cached_attention(x[:, :1], x, x, torch.zeros(1, dtype=torch.int32),
                             None, impl=impl, window=2)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "deepspeed_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.relative_to(REPO).as_posix(), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "flax", "deepspeed_tpu")]
    assert bad == []
