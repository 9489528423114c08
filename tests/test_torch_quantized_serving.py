"""The port's quantized serving held against the JAX package's on the CPU.

The tiny Llama of `test_torch_llama` (numpy weights, fp32) served by both
packages' engines in the same configuration:
(a) v1 with `quant` (int8 weights) in the `dequant` and `layer_scan` serve
    modes, the latter with the fused dequant-GEMM (`fused_int8=True`: the
    JAX kernel in Pallas interpret mode, the port's K5 plain version) and
    with the naive dequant matmul (`False`): the placed int8 trees equal
    byte for byte, `forward` logits within 1e-4, greedy tokens equal; a
    JAX int8 tree handed to the port keeps its bytes;
(b) `kv_cache_dtype="int8"`: the model over a quantized dense cache (prefill
    and a decode step, logits within 1e-4), v1 greedy tokens equal, and v2
    over int8 pools: prefill and staged decode logits within 1e-4 and
    greedy tokens equal to the JAX model over a quantized `PagedKVCache`
    (the JAX v2 engine's int8 path drops the scales a prefill writes, see
    ROADMAP.md Queue 3, so its model-level path is the oracle); the v2
    script of `test_torch_engine_v2` (chunked prefill, prefix sharing,
    put/flush, fork) over int8 pools gives the same greedy tokens as that
    oracle, and a copy-on-write copy moves the scales with the values;
(c) v2 with `quant` (the `dequant` write-through): put logits within 1e-4
    of the JAX v1 engine's `forward` with the same int8 tree.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.inference.kv_cache import KVCache as JaxKVCache  # noqa: E402
from deepspeed_tpu.inference.kv_cache import PagedKVCache as JaxPagedKVCache  # noqa: E402
from deepspeed_tpu.inference.quantized_layer_scan import (  # noqa: E402
    quantize_layer_stacks as jax_quantize_layer_stacks,
)
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig  # noqa: E402
from deepspeed_tpu_torch.inference.kv_cache import KVCache  # noqa: E402
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2  # noqa: E402
from deepspeed_tpu_torch.models.llama import (  # noqa: E402
    LlamaForCausalLM,
    llama_config,
    to_jax_params,
)
from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul  # noqa: E402
from tests.test_torch_engine_v2 import ENGINE, NEW, SEED, _prompts, _script  # noqa: E402
from tests.test_torch_llama import TINY, numpy_tree, port_model  # noqa: E402

TOL = 1e-4


def _model():
    return LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **TINY))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _engines(seed, **config):
    cfg, tree = numpy_tree(seed)
    jax_engine = deepspeed_tpu.init_inference(JaxLlama(cfg), params=tree, dtype="fp32",
                                              **config)
    engine = deepspeed_tpu_torch.init_inference(_model(), params=tree, dtype="fp32",
                                                device="cpu", **config)
    return cfg, tree, jax_engine, engine


QUANT_MODES = [
    ("dequant", None, 256),
    ("layer_scan", True, 256),    # blocks spanning rows
    ("layer_scan", True, 32),     # per-row groups
    ("layer_scan", False, 32),
]


# ------------------------------------------------------ (a) int8 weights
@pytest.mark.parametrize("mode,fused,group", QUANT_MODES)
def test_v1_quantized_serving_matches_jax(mode, fused, group):
    cfg, _, jax_engine, engine = _engines(
        40 + group, quant={"enabled": True, "group_size": group}, serve_mode=mode,
        fused_int8=fused)
    assert engine.serve_mode == jax_engine.serve_mode == mode
    assert engine._use_fused_int8() == bool(fused)
    # the placed int8 trees are the same bytes
    assert jax.tree_util.tree_structure(_np_tree(jax_engine.params)) == \
        jax.tree_util.tree_structure(to_jax_params(engine.params))
    for got, ref in zip(jax.tree_util.tree_leaves(to_jax_params(engine.params)),
                        jax.tree_util.tree_leaves(_np_tree(jax_engine.params))):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    ids = np.random.default_rng(41).integers(0, cfg.vocab_size, (3, 9))
    np.testing.assert_allclose(engine.forward(ids).numpy(),
                               np.asarray(jax_engine.forward(ids)), rtol=TOL, atol=TOL)
    launches = quantized_matmul.launches
    got = engine.generate(ids, max_new_tokens=6).numpy()
    assert quantized_matmul.launches == launches      # the CPU takes the plain version
    np.testing.assert_array_equal(got, np.asarray(jax_engine.generate(ids, max_new_tokens=6)))


def test_v1_layer_scan_untiled_scales_take_the_naive_path_on_the_cpu():
    """intermediate_size 96 with blocks of 256: the gate/up scale blocks
    straddle rows misaligned (`scale_group_width` is None). On the CPU both
    packages take the naive dequant matmul for those products (on the card
    the port raises instead, `tests/test_torch_cuda.py`)."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import scale_group_width
    cfg, tree = numpy_tree(44, intermediate_size=96)
    config = dict(quant={"enabled": True, "group_size": 256}, serve_mode="layer_scan",
                  fused_int8=True)
    jax_engine = deepspeed_tpu.init_inference(JaxLlama(cfg), params=tree, dtype="fp32",
                                              **config)
    engine = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, intermediate_size=96,
                                      **TINY)),
        params=tree, dtype="fp32", device="cpu", **config)
    gate = engine.params["layers"]["mlp"]["gate_proj"]["kernel"]
    assert scale_group_width(64, 96, gate["scales"].shape[1]) is None
    ids = np.random.default_rng(45).integers(0, cfg.vocab_size, (2, 7))
    np.testing.assert_array_equal(engine.generate(ids, max_new_tokens=5).numpy(),
                                  np.asarray(jax_engine.generate(ids, max_new_tokens=5)))


def test_v1_layer_scan_eos_and_prequantized_tree():
    """A JAX layer-stacked int8 tree handed to the port lands as the same
    bytes; eos pads a row's later tokens as the JAX layer scan does."""
    cfg, tree = numpy_tree(45)
    qtree = _np_tree(jax_quantize_layer_stacks(jax.tree_util.tree_map(jnp.asarray, tree),
                                               group_size=32))
    config = dict(quant={"enabled": True, "group_size": 32}, serve_mode="layer_scan",
                  fused_int8=True)
    jax_engine = deepspeed_tpu.init_inference(JaxLlama(cfg), params=qtree, dtype="fp32",
                                              **config)
    engine = deepspeed_tpu_torch.init_inference(_model(), params=qtree, dtype="fp32",
                                                device="cpu", **config)
    q = engine.params["layers"]["mlp"]["gate_proj"]["kernel"]
    np.testing.assert_array_equal(q["__q8__"].numpy(),
                                  qtree["layers"]["mlp"]["gate_proj"]["kernel"]["__q8__"])
    np.testing.assert_array_equal(q["scales"].numpy(),
                                  qtree["layers"]["mlp"]["gate_proj"]["kernel"]["scales"])
    assert next(engine.module.parameters()).device.type == "meta"
    ids = np.random.default_rng(46).integers(0, cfg.vocab_size, (3, 5))
    ref = np.asarray(jax_engine.generate(ids, max_new_tokens=6))
    eos = int(ref[0, 5 + 1])
    ref_eos = np.asarray(jax_engine.generate(ids, max_new_tokens=6, eos_token_id=eos,
                                             pad_token_id=1))
    got_eos = engine.generate(ids, max_new_tokens=6, eos_token_id=eos, pad_token_id=1)
    np.testing.assert_array_equal(got_eos.numpy(), ref_eos)
    assert (got_eos[0, 5 + 2:] == 1).all()


def test_serve_mode_auto_and_refusals():
    """On the CPU the card's memory is unknown, so `auto` serves dequant, as
    the JAX package does with no memory size; layer_scan without quant
    serves dequant; int8 KV outside dequant keeps a dense cache."""
    _, tree = numpy_tree(47)
    eng = deepspeed_tpu_torch.init_inference(_model(), params=tree, dtype="fp32",
                                             device="cpu", quant={"enabled": True})
    assert eng.serve_mode == "dequant" and eng.accelerator.total_memory() == 0
    eng = deepspeed_tpu_torch.init_inference(_model(), params=tree, dtype="fp32",
                                             device="cpu", serve_mode="layer_scan")
    assert eng.serve_mode == "dequant" and eng.params is None
    eng = deepspeed_tpu_torch.init_inference(
        _model(), params=tree, dtype="fp32", device="cpu", quant={"enabled": True},
        serve_mode="layer_scan", kv_cache_dtype="int8")
    assert eng.serve_mode == "layer_scan"
    assert eng.generate(np.zeros((1, 3), np.int64), max_new_tokens=2).shape == (1, 5)
    with pytest.raises(ValueError, match="unknown serve_mode"):
        deepspeed_tpu_torch.init_inference(_model(), params=tree, device="cpu",
                                           serve_mode="streaming")


# ------------------------------------------------------ (b) int8 KV cache
def test_model_over_a_quantized_dense_cache_matches_jax():
    cfg, tree = numpy_tree(50)
    ids = np.random.default_rng(51).integers(0, cfg.vocab_size, (2, 7))
    jmodel = JaxLlama(cfg)
    jcache = JaxKVCache.create(cfg.num_hidden_layers, 2, 16, cfg.num_key_value_heads,
                               cfg.head_dim, dtype=jnp.float32, quantized=True)
    ref, jcache = jmodel.apply({"params": tree}, jnp.asarray(ids, jnp.int32), cache=jcache)
    model = port_model(tree)
    cache = KVCache.create(cfg.num_hidden_layers, 2, 16, cfg.num_key_value_heads,
                           cfg.head_dim, dtype=torch.float32, quantized=True)
    with torch.inference_mode():
        got, cache = model(torch.from_numpy(ids), cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
        tok = np.asarray(ref)[:, -1].argmax(-1)[:, None]
        ref, jcache = jmodel.apply({"params": tree}, jnp.asarray(tok, jnp.int32),
                                   cache=jcache)
        got, cache = model(torch.from_numpy(tok), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert cache.k.data.dtype == torch.int8 and cache.index.tolist() == [8, 8]
    np.testing.assert_array_equal(cache.k.data.numpy(), np.asarray(jcache.k.data))


def test_v1_int8_kv_generate_matches_jax():
    cfg, _, jax_engine, engine = _engines(52, kv_cache_dtype="int8")
    ids = np.random.default_rng(53).integers(0, cfg.vocab_size, (3, 6))
    np.testing.assert_array_equal(engine.generate(ids, max_new_tokens=7).numpy(),
                                  np.asarray(jax_engine.generate(ids, max_new_tokens=7)))


def _jax_paged_int8_greedy(cfg, tree, prompt, new):
    """The JAX model over a staged int8 `PagedKVCache`, as the v2 engine
    drives it: the prompt written to the pool, then each decode token staged
    and landed by `apply_stage`. Returns each step's logits and the greedy
    tokens."""
    bs = ENGINE["cache_block_size"]
    t = ENGINE["max_seq_len"] // bs
    cache = JaxPagedKVCache.create(
        cfg.num_hidden_layers, 1, ENGINE["max_seq_len"], cfg.num_key_value_heads,
        cfg.head_dim, num_blocks=t, block_size=bs, dtype=jnp.float32, staged=True,
        quantized=True).with_tables(jnp.arange(t, dtype=jnp.int32)[None])
    model = JaxLlama(cfg)
    ids = jnp.asarray([prompt], jnp.int32)
    logits, toks = [], []
    for step in range(new):
        out, cache = model.apply({"params": tree}, ids, cache=cache)
        if step:                      # a decode step; the prefill wrote the pool
            cache = cache.apply_stage()
        logits.append(np.asarray(out[0, -1]))
        toks.append(int(np.argmax(logits[-1])))
        ids = jnp.asarray([[toks[-1]]], jnp.int32)
    return logits, toks


def _port_v2(tree, **kw):
    return InferenceEngineV2(_model(), config=DeepSpeedInferenceConfig(dtype="fp32"),
                             params=tree, device="cpu", **{**ENGINE, **kw})


def test_v2_int8_kv_matches_the_jax_model_over_int8_pools():
    """One prompt put and decoded by `put`: every step's logits within 1e-4
    of the JAX model over a staged int8 `PagedKVCache`, greedy tokens equal."""
    cfg, tree = numpy_tree(SEED)
    prompt = _prompts(cfg.vocab_size)[0]
    ref_logits, ref_toks = _jax_paged_int8_greedy(cfg, tree, prompt, NEW)
    eng = _port_v2(tree, kv_cache_dtype="int8")
    assert eng.cache.quantized and eng.kv_cache_dtype == "int8"
    got = [eng.put([0], [np.asarray(prompt, np.int32)])[0]]
    for tok in ref_toks[:-1]:
        got.append(eng.put([0], [np.asarray([tok], np.int32)])[0])
    for a, b in zip(got, ref_logits):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert [int(np.argmax(x)) for x in got] == ref_toks


def test_v2_int8_kv_script_gives_the_oracle_tokens():
    """The full v2 script over int8 pools (several rows, chunked prefill,
    prefix sharing, eos, put/flush, fork): each prompt's greedy tokens are
    the JAX model's over int8 pools, and a fork's logits equal its parent's."""
    cfg, tree = numpy_tree(SEED)
    prompts = _prompts(cfg.vocab_size)
    got = _script(_port_v2(tree, kv_cache_dtype="int8"), prompts)
    for row, prompt in zip(got["greedy"], prompts):
        assert row[len(prompt):] == _jax_paged_int8_greedy(cfg, tree, prompt, NEW)[1]
    np.testing.assert_array_equal(got["put_logits"][2], got["put_logits"][3])
    parent, child = got["fork_tables"]
    assert parent[0] == child[0] and parent[1] != child[1]
    hits, _, cow = got["counters"][0]
    assert hits > 0 and cow > 0


def test_v2_int8_fork_copies_scales():
    """After a fork, the parent's first write into the shared partial block
    copies it: the fresh block holds the source block's int8 rows and
    scales in every layer and head, before the new token lands."""
    _, tree = numpy_tree(SEED)
    eng = _port_v2(tree, kv_cache_dtype="int8")
    prompt = np.random.default_rng(54).integers(0, 256, 13).astype(np.int32)
    eng.put([1], [prompt])
    while eng.state_manager.get_sequence(1).pending:
        eng.put([], [])
    eng.fork(1, 2)
    src = eng.state_manager.get_sequence(1).blocks[1]
    k_scales = eng.cache._pool(eng.cache.k_scale_blocks)[:, :, src].clone()
    k_vals = eng.cache.k_pool[:, :, src].clone()
    both = eng.put([1, 2], [np.asarray([3], np.int32)] * 2)
    dst = eng.state_manager.get_sequence(1).blocks[1]
    assert dst != src and eng.block_manager.cow_copies == 1
    assert eng.state_manager.get_sequence(2).blocks[1] == src
    copied = eng.cache._pool(eng.cache.k_scale_blocks)[:, :, dst]
    torch.testing.assert_close(copied[..., :5], k_scales[..., :5], rtol=0, atol=0)
    assert torch.equal(eng.cache.k_pool[:, :, dst, :5], k_vals[:, :, :5])
    np.testing.assert_array_equal(both[1], both[2])


# ------------------------------------------ (c) v2 with int8 weights
def test_v2_quant_write_through_matches_jax():
    cfg, tree = numpy_tree(55)
    prompts = _prompts(cfg.vocab_size)[:2]
    quant = {"enabled": True, "group_size": 32}
    jax_v1 = deepspeed_tpu.init_inference(JaxLlama(cfg), params=tree, dtype="fp32",
                                          quant=quant)
    eng = _port_v2(tree, quant=quant)
    assert eng.serve_mode == jax_v1.serve_mode == "dequant" and eng.params is not None
    got = eng.put([0, 1], [np.asarray(p, np.int32) for p in prompts])
    while len(got) < 2:                      # the longer prompt prefills in chunks
        got.update(eng.put([], []))
    for uid, prompt in enumerate(prompts):
        ref = np.asarray(jax_v1.forward(np.asarray([prompt])))[0, -1]
        np.testing.assert_allclose(got[uid], ref, rtol=TOL, atol=TOL)
