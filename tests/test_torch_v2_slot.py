"""The port's v2 slot layout and its automatic layout rule against the JAX engine.

(a) `kv_layout=None` resolves as the JAX `InferenceEngineV2` resolves it:
    `slot` for an alibi model whose head dim or cache block is under 128,
    else `paged`.
(b) Greedy tokens of `generate` equal the JAX engine's for bloom-tiny on
    `slot` and on forced `paged` (alibi through the plain versions of
    K3-alibi and K4-alibi; the JAX CPU path is its gather fallback), and for
    the tiny Llama on `slot` (as JAX `test_paged_vs_slot_parity_bloom_mistral`
    does for its own two layouts). The slot prompts are longer than a chunk
    and outnumber the rows, so rows are reused and chunks run beside
    decoding rows.
(c) A put / flush script on the Llama's slot rows: put logits within 1e-4
    of the JAX engine's, the scheduler's answers and counters equal.
(d) The refusals the JAX engine makes: int8 KV with slot rows, `fork` off
    the paged layout.
Every model is fp32, loaded from the same numpy tree on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngineV2
from deepspeed_tpu.models.bloom import BloomForCausalLM as JaxBloom
from deepspeed_tpu.models.bloom import bloom_config as jax_bloom_config
from deepspeed_tpu.models.bloom import init_bloom as jax_init_bloom
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models.bloom import BloomForCausalLM, bloom_config
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
from tests.test_torch_bloom import numpy_tree as bloom_tree
from tests.test_torch_llama import TINY
from tests.test_torch_llama import numpy_tree as llama_tree

TOL = 1e-4
SEED = 31
ENGINE = dict(max_batch=2, max_seq_len=64, cache_block_size=8, split_fuse_chunk=8)
NEW = 6


def _prompts(vocab):
    rng = np.random.default_rng(SEED)
    return [list(map(int, rng.integers(0, vocab, n))) for n in (7, 19, 3, 12)]


def _port(family, tree, **kw):
    model = (BloomForCausalLM(bloom_config("bloom-tiny", dtype=torch.float32))
             if family == "bloom" else
             LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **TINY)))
    return InferenceEngineV2(model, config=DeepSpeedInferenceConfig(dtype="fp32"),
                             params=tree, device="cpu", **{**ENGINE, **kw})


def _jax(family, cfg, tree, **kw):
    model = JaxBloom(cfg) if family == "bloom" else JaxLlama(cfg)
    return JaxEngineV2(model, config=JaxConfig(dtype="fp32"), params=tree, **{**ENGINE, **kw})


def _slot_script(eng, prompts):
    """put / flush on slot rows → plain Python results: a 13-token prompt
    prefills in two chunks, decodes one token beside a second prompt's
    chunk, both rows flush."""
    out = {}
    prompt = np.asarray(prompts[1][:13], np.int32)
    out["put_chunk1"] = sorted(eng.put([100], [prompt]))
    logits = eng.put([], [])[100]
    step = eng.put([100, 101], [np.asarray([int(np.argmax(logits))], np.int32),
                                np.asarray(prompts[3][:5], np.int32)])
    out["put_logits"] = [np.asarray(x, np.float32) for x in (logits, step[100], step[101])]
    out["kv_util"] = eng.kv_utilization()
    out["can_schedule"] = (eng.can_schedule([1], [8]), eng.can_schedule([1], [65]))
    eng.flush(100)
    eng.flush(101)
    out["can_schedule_after"] = eng.can_schedule([1, 2], [8, 8])
    out["counters"] = eng.serving_counters["flushed_sequences"]
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's results, computed once for the file."""
    bcfg, btree = bloom_tree(SEED)
    lcfg, ltree = llama_tree(SEED)
    prompts = _prompts(bcfg.vocab_size)
    ref = {}
    for family, cfg, tree, layout in (("bloom", bcfg, btree, "slot"),
                                      ("bloom", bcfg, btree, "paged"),
                                      ("llama", lcfg, ltree, "slot")):
        eng = _jax(family, cfg, tree, kv_layout=layout)
        assert eng.kv_layout == layout
        ref[family, layout] = [list(map(int, r)) for r in
                               eng.generate(prompts, max_new_tokens=NEW)]
    ref["script"] = _slot_script(_jax("llama", lcfg, ltree, kv_layout="slot"), prompts)
    return {"bloom": btree, "llama": ltree}, prompts, ref


@pytest.mark.parametrize("family,overrides,block", [
    ("bloom", {}, 8),                                     # head dim 16
    ("bloom", {}, 256),
    ("bloom", dict(hidden_size=512), 128),                # head dim 128, block 128
    ("bloom", dict(hidden_size=512), 64),                 # head dim 128, block 64
    ("llama", {}, 8),
])
def test_auto_layout_matches_jax_engine(family, overrides, block):
    if family == "bloom":
        jcfg = jax_bloom_config("bloom-tiny", dtype=jnp.float32, **overrides)
        jmodel, tree = JaxBloom(jcfg), jax_init_bloom(jcfg)[1]
        model = BloomForCausalLM(bloom_config("bloom-tiny", dtype=torch.float32, **overrides))
    else:
        jcfg, tree = llama_tree(SEED)
        jmodel = JaxLlama(jcfg)
        model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **TINY))
    kw = dict(max_batch=2, max_seq_len=256, cache_block_size=block)
    want = JaxEngineV2(jmodel, config=JaxConfig(dtype="fp32"), params=tree, **kw).kv_layout
    got = InferenceEngineV2(model, config=DeepSpeedInferenceConfig(dtype="fp32"),
                            params=tree, device="cpu", **kw)
    assert got.kv_layout == want
    assert isinstance(got.cache.index, torch.Tensor)
    assert bool((got.cache.index == got.cache.max_len).all())   # every row parked


@pytest.mark.parametrize("family,layout", [("bloom", "slot"), ("bloom", "paged"),
                                           ("llama", "slot")])
def test_v2_greedy_tokens_match_jax_engine(reference, family, layout):
    trees, prompts, ref = reference
    eng = _port(family, trees[family], kv_layout=layout)
    assert eng.kv_layout == layout
    got = eng.generate(prompts, max_new_tokens=NEW)
    assert got == ref[family, layout]
    assert eng.serving_counters["generated_tokens"] == NEW * len(prompts)


def test_bloom_slot_and_paged_agree(reference):
    """The two layouts of one model give the same tokens, and the automatic
    layout of bloom-tiny (head dim 16) is slot."""
    trees, prompts, _ = reference
    auto = _port("bloom", trees["bloom"])
    assert auto.kv_layout == "slot"
    assert auto.generate(prompts, max_new_tokens=NEW) == \
        _port("bloom", trees["bloom"], kv_layout="paged").generate(prompts, max_new_tokens=NEW)


def test_slot_put_script_matches_jax_engine(reference):
    trees, prompts, ref = reference
    got = _slot_script(_port("llama", trees["llama"], kv_layout="slot"), prompts)
    want = ref["script"]
    assert got["put_chunk1"] == want["put_chunk1"] == []
    for a, b in zip(got["put_logits"], want["put_logits"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for key in ("kv_util", "can_schedule", "can_schedule_after", "counters"):
        assert got[key] == want[key], key


def test_slot_refusals(reference):
    trees, _, _ = reference
    with pytest.raises(ValueError, match="paged layout"):
        _port("llama", trees["llama"], kv_layout="slot", kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="paged layout"):
        _port("bloom", trees["bloom"], kv_cache_dtype="int8")   # auto resolves to slot
    eng = _port("bloom", trees["bloom"])
    eng.put([1], [np.asarray([3, 4, 5], np.int32)])
    with pytest.raises(ValueError, match="fork"):
        eng.fork(1, 2)
    with pytest.raises(ValueError, match="paged"):     # the streamed modes serve slot rows
        _port("llama", trees["llama"], kv_layout="paged", serve_mode="layer_scan",
              quant={"enabled": True})
