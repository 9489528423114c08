"""The port's FastGen v2 engine held against the JAX package's on the CPU.

`InferenceEngineV2(..., device="cpu")` and the JAX `InferenceEngineV2` get
the same tiny Llama (numpy weights, fp32), the same paged cache (blocks of
8 tokens, 2 sequence rows, split-fuse chunks of 8) and the same script:
more prompts than rows, prompts long enough to prefill in chunks while other
rows decode, two prompts sharing a 16-token prefix, eos, a put/flush cycle,
fork with copy-on-write, and the capacity errors. The JAX engine's CPU path
is the gather fallback; the port's is the plain versions of its paged
kernels. Greedy tokens must be equal, put logits within 1e-4, and the
prefix and copy-on-write counters equal. Sampled generation is checked on
the port alone: draws fall inside the cuts, repeat for a seed and do not
depend on the row a sequence was given.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngineV2
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
from deepspeed_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from tests.test_torch_llama import TINY, numpy_tree

TOL = 1e-4
SEED = 21
ENGINE = dict(max_batch=2, max_seq_len=64, cache_block_size=8, split_fuse_chunk=8,
              num_cache_blocks=16)
NEW = 6
COUNTERS = ("flushed_sequences", "generated_tokens", "decode_waves", "mixed_rounds")


def _prompts(vocab):
    rng = np.random.default_rng(SEED)
    shared = list(rng.integers(0, vocab, 16))            # two full blocks
    tail = [list(rng.integers(0, vocab, n)) for n in (5, 19, 3, 12, 6)]
    return [tail[0], tail[1], shared + tail[2], tail[3], shared + tail[4]]


def port_engine(tree, config=None, **kw):
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **TINY))
    return InferenceEngineV2(model, config=config or DeepSpeedInferenceConfig(dtype="fp32"),
                             params=tree, device="cpu", **{**ENGINE, **kw})


def _script(eng, prompts):
    """The same calls on either package's engine → plain Python results."""
    out = {"greedy": [list(map(int, r)) for r in eng.generate(prompts, max_new_tokens=NEW)]}
    eos = out["greedy"][0][len(prompts[0]) + 2]
    out["eos"] = [list(map(int, r)) for r in
                  eng.generate(prompts, max_new_tokens=NEW, eos_token_id=eos)]
    # put / flush: a 13-token prompt prefills in two chunks, then decodes
    prompt = prompts[1][::-1][:13]     # matches no committed block
    out["put_chunk1"] = sorted(eng.put([100], [np.asarray(prompt, np.int32)]))
    logits = eng.put([], [])[100]
    tok = int(np.argmax(logits))
    step = eng.put([100], [np.asarray([tok], np.int32)])[100]
    # fork the 14-token sequence (a partial tail block shared), then feed
    # parent and child the same token: the parent's write copies the tail
    eng.fork(100, 101)
    t2 = int(np.argmax(step))
    both = eng.put([100, 101], [np.asarray([t2], np.int32)] * 2)
    cont = eng.put([101], [np.asarray(prompts[1][:3], np.int32)])
    out["put_logits"] = [np.asarray(x, np.float32) for x in
                         (logits, step, both[100], both[101], cont[101])]
    out["fork_tables"] = (eng.state_manager.get_sequence(100).blocks,
                          eng.state_manager.get_sequence(101).blocks)
    eng.flush(100)
    eng.flush(101)
    out["can_schedule"] = (eng.can_schedule([1, 2], [8, 8]),
                           eng.can_schedule([1, 2, 3], [8, 8, 8]),
                           eng.can_schedule([1], [65]))
    bm = eng.block_manager
    out["counters"] = ((bm.prefix_hits, bm.prefix_tokens_reused, bm.cow_copies)
                       if bm is not None else None,
                       {k: eng.serving_counters[k] for k in COUNTERS})
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's results, computed once for the file."""
    cfg, tree = numpy_tree(SEED)
    prompts = _prompts(cfg.vocab_size)
    eng = JaxEngineV2(JaxLlama(cfg), config=JaxConfig(dtype="fp32"), params=tree, **ENGINE)
    return tree, prompts, _script(eng, prompts)


def test_v2_script_matches_jax_engine(reference):
    tree, prompts, ref = reference
    launches = (paged_decode_attention.launches, paged_prefill_attention.launches)
    got = _script(port_engine(tree), prompts)
    assert got["greedy"] == ref["greedy"]
    assert [len(r) for r in got["greedy"]] == [len(p) + NEW for p in prompts]
    assert got["eos"] == ref["eos"]
    assert any(len(r) < len(p) + NEW for r, p in zip(got["eos"], prompts))
    assert got["put_chunk1"] == ref["put_chunk1"] == []
    for a, b in zip(got["put_logits"], ref["put_logits"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    # parent and child fed the same token after the fork: equal logits, and
    # the copy gave them different tail blocks over a shared first block
    np.testing.assert_array_equal(got["put_logits"][2], got["put_logits"][3])
    parent, child = got["fork_tables"]
    assert parent[0] == child[0] and parent[1] != child[1]
    assert got["fork_tables"] == ref["fork_tables"]
    assert got["can_schedule"] == ref["can_schedule"] == (True, False, False)
    assert got["counters"] == ref["counters"]
    hits, _, cow = got["counters"][0]
    assert hits > 0 and cow > 0
    # the CPU takes the plain versions: no kernel launched
    assert (paged_decode_attention.launches, paged_prefill_attention.launches) == launches


def test_v2_prefix_sharing_off_gives_the_same_tokens(reference):
    """Sharing committed blocks is exact: with it off, every prompt prefills
    in full and the greedy tokens are the JAX engine's (sharing on)."""
    tree, prompts, ref = reference
    eng = port_engine(tree, prefix_sharing=False)
    got = [list(map(int, r)) for r in eng.generate(prompts, max_new_tokens=NEW)]
    assert got == ref["greedy"]
    assert eng.block_manager is None
    with pytest.raises(ValueError, match="prefix_sharing"):
        eng.fork(0, 1)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_v2_capacity_errors(reference, package):
    """The serving boundary refuses what would run past a row's capacity
    or the pool, before touching any state, in both packages alike."""
    tree, prompts, _ = reference
    if package == "port":
        eng = port_engine(tree)
    else:
        cfg, _ = numpy_tree(SEED)
        eng = JaxEngineV2(JaxLlama(cfg), config=JaxConfig(dtype="fp32"), params=tree,
                          **ENGINE)
    with pytest.raises(ValueError, match="leaves no room"):
        eng.generate([list(range(64))], max_new_tokens=2)
    with pytest.raises(ValueError, match="blocks worst-case"):
        _small_pool(tree, package).generate([list(range(40))], max_new_tokens=8)
    with pytest.raises(ValueError, match="would reach 65 tokens"):
        eng.put([7], [np.arange(65, dtype=np.int32)])
    assert eng.state_manager.n_tracked_sequences == 0
    eng.put([7], [np.arange(60, dtype=np.int32)])
    while eng.state_manager.get_sequence(7).pending:
        eng.put([], [])
    with pytest.raises(ValueError, match="would reach 65 tokens"):
        eng.put([7], [np.arange(5, dtype=np.int32)])
    with pytest.raises(ValueError, match="empty token list"):
        eng.put([7], [np.zeros((0,), np.int32)])


def _small_pool(tree, package):
    """An engine whose pool (4 blocks of 8) cannot hold one 48-token row."""
    if package == "port":
        return port_engine(tree, num_cache_blocks=4)
    cfg, _ = numpy_tree(SEED)
    return JaxEngineV2(JaxLlama(cfg), config=JaxConfig(dtype="fp32"), params=tree,
                       **{**ENGINE, "num_cache_blocks": 4})


def test_v2_sampled_generate(reference):
    """Temperature / top-k sampling: every draw is among the top 3 logits
    of the model at its position, one seed repeats, another differs, and
    an engine with more rows (so other slots and batches) draws the same
    tokens, since each sequence draws from its own (seed, uid) stream."""
    tree, prompts, _ = reference
    kw = dict(max_new_tokens=NEW, temperature=0.8, top_k=3)
    eng = port_engine(tree)
    a = eng.generate(prompts, seed=5, **kw)
    assert eng.generate(prompts, seed=5, **kw) == a
    assert port_engine(tree, max_batch=3).generate(prompts, seed=5, **kw) == a
    assert eng.generate(prompts, seed=6, **kw) != a
    with torch.inference_mode():
        for seq, prompt in zip(a, prompts):
            logits = eng.module(torch.tensor([seq[:-1]]))[0]
            top3 = logits.topk(3, dim=-1).indices
            for i in range(len(prompt), len(seq)):
                assert seq[i] in top3[i - 1].tolist()
    assert eng._sample_cfg is None        # the config does not leak into put


def test_v2_unported_options_raise(reference):
    tree, _, _ = reference
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_engine(tree, serve_mode="capacity",
                    config=DeepSpeedInferenceConfig(dtype="fp32", capacity={"stage_retries": 3}))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_engine(tree, speculative={"enabled": True, "k": 4})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_engine(tree).warmup()


def test_v2_without_cuda_raises(reference):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for one without")
    tree, _, _ = reference
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngineV2(model, params=tree)
