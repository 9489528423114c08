"""The port's capacity serve mode (ZeRO-Inference) held against the JAX package's on the CPU.

The tiny Llama of `test_torch_llama` (numpy weights, fp32), served by both
packages from the same tree:
(a) v1 `serve_mode="capacity"`: greedy `generate` tokens equal to the JAX
    resident engine's and to the JAX capacity engine's; `forward` logits
    within 1e-5 of both; a sampled `generate` equal to the port's resident
    engine's (the same torch generator); the RAM tier on the host between
    calls; a module's own weights (on the CPU) give the tree's host tier bit
    for bit;
(b) int8 (`quant`): tokens equal to the JAX capacity int8 engine's and to
    the port's `layer_scan` engine's, and the host tier's bytes equal to
    `quantize_layer_stacks`'s (both packages') bit for bit;
(c) `double_buffer: False` gives the double-buffered logits bit for bit;
    the recorded order of the primitives: layer l+1's copy is issued before
    layer l's block waits for its copy and before its end is recorded, and
    the synchronous mode issues no copy ahead;
(d) the accounting: `CapacityPlan`'s integers equal the JAX plan's (bf16
    path, int8, an NVMe layer), `plan_for`, the bytes a step streams, and
    `auto` resolving to capacity when the card's memory is faked small;
(e) the NVMe tier with `nvme_layers=1`: a swap file written, the RAM tier
    one layer shorter, two `generate` calls giving the JAX tokens; the aio
    engine's swapper round trip, its short-read refusal and `nvme.sweep`;
(f) the refusals: a tree without the llama layout serves dequant with a
    warning; capacity over two ranks goes through `kernel_fallback` (warns on
    the CPU, raises on CUDA); the resilience keys raise;
(g) v2 `layer_scan` and `capacity` on slot rows: greedy tokens equal to the
    JAX v2 engine's in the same mode; an explicit paged layout raises, a
    paged default takes slot rows, an int8 KV cache raises.
Tolerances: tokens equal; logits 1e-5 against JAX (both packages' f32 paths
differ by rounding only); bit for bit where the two runs are the same
arithmetic.
"""

import dataclasses
import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.quantized_layer_scan import (
    quantize_layer_stacks as jax_quantize_layer_stacks,
)
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngineV2
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CudaAccelerator
from deepspeed_tpu_torch.inference import capacity_scan
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.quantized_layer_scan import quantize_layer_stacks
from deepspeed_tpu_torch.inference.serve_modes import resolve_serve_mode
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models.llama import (
    LlamaForCausalLM,
    llama_config,
    load_jax_params,
    tree_to_torch,
)
from deepspeed_tpu_torch.runtime.swap_tensor import AsyncTensorSwapper, SwapIOError
from deepspeed_tpu_torch.utils.logging import logger
from tests.test_torch_llama import TINY, numpy_tree

TOL = 1e-5
MB = 1 << 20
QUANT = {"enabled": True, "group_size": 32}
SEED = 61
NEW = 6


def _port_model(**overrides):
    return LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **TINY, **overrides))


def _port(tree, overrides=None, **config):
    return deepspeed_tpu_torch.init_inference(_port_model(**(overrides or {})), params=tree,
                                              dtype="fp32", device="cpu", **config)


def _jax(cfg, tree, **config):
    return deepspeed_tpu.init_inference(JaxLlama(cfg), params=tree, dtype="fp32", **config)


def _ids(cfg, seed, shape=(2, 8)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.fixture(scope="module")
def tiny():
    return numpy_tree(SEED)


@pytest.fixture(scope="module")
def engines(tiny):
    """Both packages' resident and capacity engines (bf16 path) and their
    greedy tokens and `forward` logits on one prompt batch."""
    cfg, tree = tiny
    ids = _ids(cfg, SEED + 1)
    out = {"ids": ids}
    for name, eng in (("jax_resident", _jax(cfg, tree)),
                      ("jax_capacity", _jax(cfg, tree, serve_mode="capacity")),
                      ("capacity", _port(tree, serve_mode="capacity"))):
        out[name] = eng
        tokens = eng.generate(ids, max_new_tokens=NEW)
        logits = eng.forward(ids)
        out[name + "_tokens"] = np.asarray(tokens)
        out[name + "_logits"] = np.asarray(logits)
    return out


# ------------------------------------------------------------ (a) bf16 path
def test_capacity_generate_matches_jax_resident_and_capacity(engines):
    eng = engines["capacity"]
    assert eng.serve_mode == "capacity" and engines["jax_capacity"].serve_mode == "capacity"
    np.testing.assert_array_equal(engines["capacity_tokens"], engines["jax_resident_tokens"])
    np.testing.assert_array_equal(engines["capacity_tokens"], engines["jax_capacity_tokens"])


@pytest.mark.parametrize("reference", ["jax_resident", "jax_capacity"])
def test_capacity_forward_matches_jax(engines, reference):
    np.testing.assert_allclose(engines["capacity_logits"], engines[reference + "_logits"],
                               rtol=TOL, atol=TOL)


def test_capacity_sampled_generate_matches_the_resident_port(tiny, engines):
    """Sampling draws from the same torch generator in both serve modes."""
    cfg, tree = tiny
    resident = _port(tree)
    ids = engines["ids"]
    kw = dict(max_new_tokens=4, temperature=0.7, top_k=8, seed=3)
    np.testing.assert_array_equal(engines["capacity"].generate(ids, **kw).numpy(),
                                  resident.generate(ids, **kw).numpy())


def test_capacity_layers_stay_on_the_host(engines):
    eng = engines["capacity"]
    runner = eng._capacity
    for _ in range(2):
        assert runner.host_resident()
        for layer in eng.params["layers"]:
            for _, leaf in capacity_scan._flatten(layer):
                assert leaf.device.type == "cpu"
        eng.generate(engines["ids"], max_new_tokens=2)
    assert next(eng.module.parameters()).device.type == "meta"
    stats = eng.serving_stats()
    assert stats["serve_mode"] == "capacity" and stats["prefetch_stall_ms"] == 0.0
    assert stats["h2d_bytes_step"] == runner.h2d_bytes_pass() == sum(
        leaf.numel() * leaf.element_size() for layer in eng.params["layers"]
        for _, leaf in capacity_scan._flatten(layer))


def test_capacity_from_a_module_equals_the_tree(tiny, engines):
    """A module's own weights (on the CPU) build the same host tier and
    resident tier as its tree, and the caller's module is left whole."""
    cfg, tree = tiny
    model = load_jax_params(LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32,
                                                          **TINY)), tree)
    eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu",
                                             serve_mode="capacity")
    assert next(model.parameters()).device.type == "cpu"
    ref = engines["capacity"]
    for got, want in zip(eng.params["layers"], ref.params["layers"]):
        for (path, a), (_, b) in zip(capacity_scan._flatten(got), capacity_scan._flatten(want)):
            assert torch.equal(a, b), path
    for key in ("embed_tokens", "lm_head"):
        assert torch.equal(eng.params[key], ref.params[key])
    np.testing.assert_array_equal(eng.generate(engines["ids"], max_new_tokens=NEW).numpy(),
                                  engines["capacity_tokens"])


# ------------------------------------------------------------------ (b) int8
@pytest.fixture(scope="module")
def int8_engines(tiny):
    cfg, tree = tiny
    return {"jax_capacity": _jax(cfg, tree, quant=QUANT, serve_mode="capacity"),
            "layer_scan": _port(tree, quant=QUANT, serve_mode="layer_scan"),
            "capacity": _port(tree, quant=QUANT, serve_mode="capacity")}


def test_int8_capacity_tokens_match(tiny, int8_engines):
    cfg, _ = tiny
    ids = _ids(cfg, SEED + 2)
    got = int8_engines["capacity"].generate(ids, max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(int8_engines["jax_capacity"].generate(ids, max_new_tokens=NEW)))
    np.testing.assert_array_equal(
        got, int8_engines["layer_scan"].generate(ids, max_new_tokens=NEW).numpy())


def test_int8_host_tier_is_quantize_layer_stacks_bytes(tiny, int8_engines):
    """Layer l of every host-tier leaf equals the per-layer-quantized stack:
    the port's `quantize_layer_stacks` (the layer scan's placed tree) and the
    JAX package's."""
    _, tree = tiny
    port = quantize_layer_stacks(tree_to_torch(tree, dtype=torch.float32),
                                 group_size=QUANT["group_size"])
    jax_tree = jax.tree_util.tree_map(
        np.asarray, jax_quantize_layer_stacks(jax.tree_util.tree_map(jnp.asarray, tree),
                                              group_size=QUANT["group_size"]))
    placed = int8_engines["layer_scan"].params["layers"]
    layers = int8_engines["capacity"].params["layers"]
    n_int8 = 0
    for l, layer in enumerate(layers):
        for path, leaf in capacity_scan._flatten(layer):
            for stack in (port["layers"], placed, jax_tree["layers"]):
                node = stack
                for key in path:
                    node = node[key]
                want = node[l]
                want = want if isinstance(want, torch.Tensor) else torch.from_numpy(np.array(want))
                assert leaf.dtype == want.dtype and torch.equal(leaf, want), (l, path)
            n_int8 += leaf.dtype == torch.int8
    from deepspeed_tpu_torch.inference.quantization import is_quantized_leaf, tree_leaves
    per_layer = sum(is_quantized_leaf(x) for x in tree_leaves(port["layers"]))
    assert per_layer >= 5 and n_int8 == per_layer * len(layers)


# -------------------------------------------------- (c) staging and its order
def test_synchronous_mode_gives_the_same_bits(tiny, engines):
    _, tree = tiny
    sync = _port(tree, serve_mode="capacity", capacity={"double_buffer": False})
    assert not sync._capacity.double_buffer and len(sync._capacity._slabs) == 1
    ids = engines["ids"]
    assert torch.equal(sync.forward(ids), engines["capacity"].forward(ids))
    np.testing.assert_array_equal(sync.generate(ids, max_new_tokens=NEW).numpy(),
                                  engines["capacity_tokens"])


def _record(monkeypatch):
    """Record the primitives' calls: ("copy", layer), ("wait", layer) and
    ("end", layer) for the block's end."""
    events = []
    transfer_layer = capacity_scan.CapacityRunner._transfer_layer
    run_block = capacity_scan.CapacityRunner._run_block
    current = {}

    def recording_transfer_layer(self, l):
        events.append(("copy", l))
        return transfer_layer(self, l)

    def recording_run_block(self, staged, *args):
        current["layer"] = staged.layer
        return run_block(self, staged, *args)

    real_await_transfer, real_await_result = (capacity_scan._await_transfer,
                                              capacity_scan._await_result)
    monkeypatch.setattr(capacity_scan.CapacityRunner, "_transfer_layer",
                        recording_transfer_layer)
    monkeypatch.setattr(capacity_scan.CapacityRunner, "_run_block", recording_run_block)
    monkeypatch.setattr(capacity_scan, "_await_transfer", lambda *a: (
        events.append(("wait", current["layer"])), real_await_transfer(*a))[1])
    monkeypatch.setattr(capacity_scan, "_await_result", lambda *a: (
        events.append(("end", current["layer"])), real_await_result(*a))[1])
    return events


@pytest.mark.parametrize("double_buffer", [True, False])
def test_copy_order(monkeypatch, double_buffer):
    """Double-buffered: layer l+1's copy is issued before layer l's block
    waits for its copy and before its end is recorded. Synchronous: layer
    l+1's copy comes after layer l's end."""
    L = 4
    _, tree = numpy_tree(SEED + 3, num_hidden_layers=L)
    eng = _port(tree, dict(num_hidden_layers=L), serve_mode="capacity",
                capacity={"double_buffer": double_buffer})
    events = _record(monkeypatch)
    eng.generate(np.zeros((2, 6), np.int64), max_new_tokens=1)     # one pass
    first = {}
    for i, ev in enumerate(events):
        first.setdefault(ev, i)
    assert [ev for ev in events if ev[0] == "wait"] == [("wait", l) for l in range(L)]
    for l in range(L - 1):
        if double_buffer:
            assert first[("copy", l + 1)] < first[("wait", l)] < first[("end", l)], events
        else:
            assert first[("end", l)] < first[("copy", l + 1)], events
    # the next pass's layer 0 is queued at the end of a double-buffered pass
    assert (events[-1] == ("copy", 0)) == double_buffer, events


# ------------------------------------------------------------ (d) accounting
@pytest.mark.parametrize("kind", ["bf16_path", "int8", "nvme"])
def test_plan_matches_jax(tiny, tmp_path, kind):
    cfg, tree = tiny
    config = dict(serve_mode="capacity", max_batch_size=2, max_out_tokens=40)
    if kind == "int8":
        config["quant"] = QUANT
    if kind == "nvme":
        config["capacity"] = {"nvme_dir": str(tmp_path / "jax"), "nvme_layers": 1}
    jax_runner = _jax(cfg, tree, **config)._capacity
    if kind == "nvme":
        config["capacity"] = {"nvme_dir": str(tmp_path / "port"), "nvme_layers": 1}
    runner = _port(tree, **config)._capacity
    assert dataclasses.asdict(runner.plan) == dataclasses.asdict(jax_runner.plan)
    assert runner.plan.peak_hbm_bytes == jax_runner.plan.peak_hbm_bytes
    assert dataclasses.asdict(runner.plan_for(3, 17, 9)) == \
        dataclasses.asdict(jax_runner.plan_for(3, 17, 9))
    assert runner.h2d_bytes_pass() == jax_runner.h2d_bytes_pass()
    assert runner.weight_bytes_step_pair() == jax_runner.weight_bytes_step_pair()


def test_auto_resolves_to_capacity_when_nothing_fits(tiny, monkeypatch):
    """As the JAX test at `test_capacity_serving.py:347`: a card of 2 MB
    holds neither the resident tree nor the int8 layer scan beside the KV
    cache and workspace; 16 GB holds the resident tree."""
    _, tree = tiny
    monkeypatch.setattr(CudaAccelerator, "total_memory", lambda self: 2 * MB)
    assert _port(tree, serve_mode="auto").serve_mode == "capacity"
    assert _port(tree, serve_mode="auto", quant=QUANT).serve_mode == "capacity"
    monkeypatch.setattr(CudaAccelerator, "total_memory", lambda self: 16 << 30)
    assert _port(tree, serve_mode="auto").serve_mode == "dequant"


# -------------------------------------------------------------- (e) NVMe tier
def test_nvme_tier(tiny, engines, tmp_path):
    _, tree = tiny
    eng = _port(tree, serve_mode="capacity",
                capacity={"nvme_dir": str(tmp_path), "nvme_layers": 1})
    runner = eng._capacity
    assert runner.plan.nvme_layers == 1 and runner.plan.nvme_bytes == runner.slice_bytes()
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".swp")) == ["cap_l1.swp"]
    assert len(runner._ram) == runner.num_layers - 1
    assert all(isinstance(leaf, capacity_scan._NVMeLeaf)
               for _, leaf in capacity_scan._flatten(eng.params["layers"][1]))
    ids = engines["ids"]
    for _ in range(2):       # the second call reads the disk layer again
        np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=NEW).numpy(),
                                      engines["jax_resident_tokens"])
    assert runner._nvme.counters["reads"] >= 2 * NEW


def test_swapper_round_trip_and_refusals(tmp_path):
    swapper = AsyncTensorSwapper(str(tmp_path))
    tree = {"a": torch.randn(33, 7).to(torch.bfloat16), "b": {"c": torch.arange(10)}}
    swapper.swap_out_tree("t", tree)
    swapper.synchronize()
    back = swapper.swap_in_tree("t", tree)
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"]["c"], tree["b"]["c"])
    with pytest.raises(SwapIOError, match="missing"):
        swapper.swap_in("nothing", (4,), torch.float32)
    with pytest.raises(SwapIOError, match="short"):
        swapper.swap_in("t_1", (11,), torch.int64)
    assert swapper.counters["backend"] in ("io_uring", "threads")


def test_nvme_sweep_and_tune_file(tmp_path):
    from deepspeed_tpu_torch import nvme
    result = nvme.sweep(str(tmp_path), mb=2, block_mb=1, stripe_mb=1)
    assert result["read_GBps"] > 0 and result["write_GBps"] > 0
    assert not os.path.exists(tmp_path / "ds_aio_perf.bin")
    (tmp_path / nvme.TUNE_FILE).write_text('{"threads": 2, "stripe_mb": 4}')
    assert nvme.tuned_defaults(str(tmp_path)) == (2, 32, 4 << 20)
    assert AsyncTensorSwapper(str(tmp_path)).counters["stripe_bytes"] == 4 << 20


# -------------------------------------------------------------- (f) refusals
@pytest.fixture
def port_log(caplog):
    """The port's logger does not propagate: attach pytest's handler."""
    logger.addHandler(caplog.handler)
    yield caplog
    logger.removeHandler(caplog.handler)


def test_non_llama_tree_serves_dequant_with_a_warning(port_log):
    from deepspeed_tpu_torch.models.bloom import BloomForCausalLM, bloom_config
    model = BloomForCausalLM(bloom_config("bloom-tiny", dtype=torch.float32))
    with port_log.at_level(logging.WARNING):
        eng = deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu",
                                                 serve_mode="capacity")
    assert eng.serve_mode == "dequant" and eng._capacity is None
    assert "llama-layout" in port_log.text
    assert eng.generate(np.zeros((1, 4), np.int64), max_new_tokens=2).shape == (1, 6)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_capacity_over_two_ranks_goes_through_kernel_fallback(tiny, port_log, device):
    _, tree = tiny
    engine = types.SimpleNamespace(
        _config=DeepSpeedInferenceConfig(dtype="fp32", serve_mode="capacity"),
        topology=types.SimpleNamespace(sizes={"model": 2}, world_size=2),
        device=torch.device(device), _quantized=False,
        model_cfg=_port_model().cfg, accelerator=None)
    if device == "cuda":
        with pytest.raises(NotImplementedError, match="kernel_fallback: capacity_scan"):
            resolve_serve_mode(engine, tree)
        return
    with port_log.at_level(logging.WARNING):
        assert resolve_serve_mode(engine, tree) == "dequant"
    assert "kernel_fallback: capacity_scan" in port_log.text


@pytest.mark.parametrize("config", [
    {"capacity": {"prefetch_watchdog_s": 5.0}}, {"capacity": {"dispatch_deadline_s": 1.0}},
    {"capacity": {"stage_retries": 2}}, {"resilience": {"stage_retries": 2}},
])
def test_resilience_keys_raise(tiny, config):
    _, tree = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _port(tree, serve_mode="capacity", **config)


# -------------------------------------------------------- (g) v2 streamed modes
V2 = dict(max_batch=2, max_seq_len=64, split_fuse_chunk=8)


def _v2_prompts(vocab):
    rng = np.random.default_rng(SEED + 4)
    return [list(map(int, rng.integers(0, vocab, n))) for n in (7, 19, 3, 12)]


def _port_v2(tree, **kw):
    return InferenceEngineV2(_port_model(), config=DeepSpeedInferenceConfig(dtype="fp32"),
                             params=tree, device="cpu", **{**V2, **kw})


@pytest.mark.parametrize("mode,quant", [("layer_scan", QUANT), ("capacity", None),
                                        ("capacity", QUANT)],
                         ids=["layer_scan", "capacity", "capacity_int8"])
def test_v2_streamed_modes_match_jax(tiny, mode, quant):
    cfg, tree = tiny
    prompts = _v2_prompts(cfg.vocab_size)
    ref = JaxEngineV2(JaxLlama(cfg), config=JaxConfig(dtype="fp32"), params=tree,
                      serve_mode=mode, quant=quant, **V2)
    eng = _port_v2(tree, serve_mode=mode, quant=quant)
    assert eng.serve_mode == ref.serve_mode == mode
    assert eng.kv_layout == ref.kv_layout == "slot"
    want = [list(map(int, r)) for r in ref.generate(prompts, max_new_tokens=NEW)]
    assert [list(map(int, r)) for r in eng.generate(prompts, max_new_tokens=NEW)] == want


def test_v2_streamed_mode_layouts(tiny):
    _, tree = tiny
    with pytest.raises(ValueError, match="paged"):
        _port_v2(tree, serve_mode="capacity", kv_layout="paged")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        _port_v2(tree, serve_mode="capacity", kv_cache_dtype="int8")
    assert _port_v2(tree, serve_mode="capacity", kv_layout="slot").kv_layout == "slot"
