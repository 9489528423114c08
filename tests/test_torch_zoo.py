"""The port's zoo families, phi and GPT-NeoX, held against the JAX package's
on the CPU.

phi-tiny and neox-tiny (parallel and sequential residual) in fp32, plus one
model of each at the real head widths (phi at 80, GPT-NeoX at 256); one
parameter tree made with numpy from a seed (kernels, embeddings and biases
normal, LayerNorm scales near 1) is loaded into both packages
(`load_jax_params`). Logits and the loss must agree to 1e-4, a cached
prefill plus decode steps must give full `forward`'s logits to 1e-4, the
tree must come back bit for bit, and the v1 engines' greedy tokens and the
v2 engines' greedy tokens on the paged cache (the layout both engines pick
for a model without alibi) must be equal. `load_hf_checkpoint` reads a
`pytorch_model.bin` that the test writes from a tiny `transformers` Phi and
GPTNeoX built from a config: its tree equals the JAX loader's bit for bit,
and the port's logits are held to 1e-4 against the HF model's own. The
refusals (remat policies other than "nothing", the int8 and layer-streamed
serve modes, other checkpoint families) name their ROADMAP items; training
is held to the JAX engine in `tests/test_torch_zoo_training.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngineV2
from deepspeed_tpu.models import gptneox as jax_neox
from deepspeed_tpu.models import phi as jax_phi
from deepspeed_tpu.module_inject.load_checkpoint import load_hf_checkpoint as jax_load_hf
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.kv_cache import KVCache
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import gptneox, phi
from deepspeed_tpu_torch.models.llama import to_jax_params
from deepspeed_tpu_torch.module_inject import from_hf_config, load_hf_checkpoint

TOL = 1e-4
SEED = 23
FAMILIES = {
    "phi": (jax_phi.PhiForCausalLM, jax_phi.phi_config, jax_phi.init_phi,
            phi.PhiForCausalLM, phi.phi_config, "phi-tiny"),
    "neox": (jax_neox.GPTNeoXForCausalLM, jax_neox.gptneox_config, jax_neox.init_gptneox,
             gptneox.GPTNeoXForCausalLM, gptneox.gptneox_config, "neox-tiny"),
}
# (family, overrides): the tiny presets (head dim 16), NeoX's sequential
# residual, and the zoo's widths at two heads
CASES = {
    "phi-tiny": ("phi", {}),
    "neox-tiny": ("neox", {}),
    "neox-tiny-sequential": ("neox", dict(use_parallel_residual=False)),
    "phi-d80": ("phi", dict(hidden_size=160, num_attention_heads=2, num_key_value_heads=2)),
    "neox-d256": ("neox", dict(hidden_size=512, num_attention_heads=2)),
}
TINY = ["phi-tiny", "neox-tiny", "neox-tiny-sequential"]


def numpy_tree(case: str, seed: int = SEED):
    """(JAX config, JAX module, port module, a JAX tree made with numpy)."""
    family, overrides = CASES[case]
    jcls, jconfig, jinit, cls, config, preset = FAMILIES[family]
    jcfg = jconfig(preset, dtype=jnp.float32, **overrides)
    _, params, _ = jinit(jcfg)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(x.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, params)
    model = cls(config(preset, dtype=torch.float32, **overrides))
    return jcfg, jcls(jcfg), model, tree


@pytest.fixture(scope="module")
def cases():
    return {case: numpy_tree(case) for case in CASES}


def _ids(cfg, shape, seed=SEED + 1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_and_loss_match_jax(cases, case):
    jcfg, jmodel, model, tree = cases[case]
    ids = _ids(jcfg, (2, 16))
    ref = jmodel.apply({"params": tree}, jnp.asarray(ids, jnp.int32))
    ref_loss, _ = jmodel.apply({"params": tree}, jnp.asarray(ids, jnp.int32),
                               labels=jnp.asarray(ids, jnp.int32))
    model.load_jax_params(tree)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
        loss, aux = model(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=TOL, atol=TOL)


# tier-1 on purpose: each case's 11 eager port calls and one JAX forward take ~2-3 s
@pytest.mark.parametrize("case", ["phi-tiny", "neox-tiny-sequential", "neox-d256"])
def test_cached_decode_matches_full_forward(cases, case):  # tpulint: disable=slow-mark-discipline
    """A 6-token prefill into a dense cache, then 10 single-token steps:
    every position's logits equal full `forward`'s, the port's and JAX's;
    `logits_at` picks one row each."""
    jcfg, jmodel, model, tree = cases[case]
    ids = _ids(jcfg, (2, 16))
    full_jax = np.asarray(jmodel.apply({"params": tree}, jnp.asarray(ids, jnp.int32)))
    model.load_jax_params(tree)
    cfg = model.cfg

    def cache():
        return KVCache.create(cfg.num_hidden_layers, 2, 32, cfg.num_attention_heads,
                              cfg.head_dim, dtype=torch.float32)

    t = torch.from_numpy(ids)
    with torch.no_grad():
        logits, c = model(t[:, :6], cache=cache())
        outs = [logits]
        for i in range(6, 16):
            logits, c = model(t[:, i:i + 1], cache=c)
            outs.append(logits)
        at = torch.tensor([3, 15])
        picked, _ = model(t, cache=cache(), logits_at=at)
    got = torch.cat(outs, dim=1)
    assert c.index.tolist() == [16, 16]
    np.testing.assert_allclose(got.numpy(), full_jax, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(picked.numpy(), full_jax[[0, 1], [3, 15]], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["phi-tiny", "neox-tiny"])
def test_to_jax_params_round_trip(cases, case):
    _, _, model, tree = cases[case]
    model.load_jax_params(tree)
    back = to_jax_params(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("family", ["phi", "neox"])
def test_init_follows_the_generator(family):
    """Random weights drawn as the JAX zoo's in kind (normal kernels and
    embeddings, zero biases, unit scales), repeatable from the seed."""
    init = phi.init_phi if family == "phi" else gptneox.init_gptneox
    cfg = FAMILIES[family][4](FAMILIES[family][5], dtype=torch.float32)
    a, b = init(cfg, torch.Generator().manual_seed(4)), init(cfg, torch.Generator().manual_seed(4))
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
        if name.endswith(".scale"):
            assert torch.all(p == 1.0)
        elif name.endswith(".bias"):
            assert torch.all(p == 0.0)
        else:
            assert 0.015 < p.std().item() < 0.025, name


@pytest.mark.parametrize("case", TINY)
def test_v1_greedy_generate_matches_jax_engine(cases, case):
    jcfg, jmodel, model, tree = cases[case]
    ids = _ids(jcfg, (2, 7))
    jax_engine = deepspeed_tpu.init_inference(jmodel, params=tree, dtype="fp32")
    engine = deepspeed_tpu_torch.init_inference(type(model)(model.cfg), params=tree,
                                                dtype="fp32", device="cpu")
    ref = np.asarray(jax_engine.generate(ids, max_new_tokens=8))
    got = engine.generate(ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["phi-tiny", "neox-tiny"])
def test_v2_paged_greedy_tokens_match_jax_engine(cases, case):
    """Four prompts through two rows of blocks of 8 (chunks of 8, so the
    19-token prompt prefills in three): both engines take the paged layout
    and give the same greedy tokens."""
    jcfg, jmodel, model, tree = cases[case]
    rng = np.random.default_rng(SEED + 2)
    prompts = [list(map(int, rng.integers(0, jcfg.vocab_size, n))) for n in (7, 19, 3, 12)]
    kw = dict(max_batch=2, max_seq_len=64, cache_block_size=8, split_fuse_chunk=8)
    jax_engine = JaxEngineV2(jmodel, config=JaxConfig(dtype="fp32"), params=tree, **kw)
    engine = InferenceEngineV2(type(model)(model.cfg),
                               config=DeepSpeedInferenceConfig(dtype="fp32"), params=tree,
                               device="cpu", **kw)
    assert engine.kv_layout == jax_engine.kv_layout == "paged"
    ref = [list(map(int, r)) for r in jax_engine.generate(prompts, max_new_tokens=6)]
    assert engine.generate(prompts, max_new_tokens=6) == ref


def _hf_checkpoint(family, path):
    """A tiny transformers model built from a config, its weights redrawn
    with numpy (biases non-zero), saved as `pytorch_model.bin` and
    config.json under `path`; returns the model."""
    import transformers
    common = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, max_position_embeddings=128)
    if family == "phi":
        cfg = transformers.PhiConfig(partial_rotary_factor=0.5, **common)
        model = transformers.PhiForCausalLM(cfg)
    else:
        cfg = transformers.GPTNeoXConfig(rotary_pct=0.25, **common)
        model = transformers.GPTNeoXForCausalLM(cfg)
    rng = np.random.default_rng(SEED + 3)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            noise = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            is_norm = "layernorm" in name or "layer_norm" in name
            p.copy_(1.0 + 0.1 * noise if is_norm and name.endswith("weight") else 0.02 * noise)
    model.eval()
    model.save_pretrained(path, safe_serialization=False)
    return model


@pytest.mark.parametrize("family", ["phi", "neox"])
def test_load_hf_checkpoint_matches_jax_and_hf(family, tmp_path):
    hf = _hf_checkpoint(family, tmp_path)
    assert (tmp_path / "pytorch_model.bin").exists()
    model, params = load_hf_checkpoint(str(tmp_path), dtype=torch.float32)
    assert isinstance(model, FAMILIES[family][3]) and next(model.parameters()).is_meta
    jmodel, jparams = jax_load_hf(str(tmp_path), dtype=jnp.float32)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    ids = _ids(model.cfg, (2, 12))
    engine = deepspeed_tpu_torch.init_inference((model, params), dtype="fp32", device="cpu")
    got = engine.forward(ids)
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits
    ref = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_refusals_name_their_roadmap_items(cases):
    _, _, model, tree = cases["phi-tiny"]
    for cls, config, preset in ((phi.PhiForCausalLM, phi.phi_config, "phi-tiny"),
                                (gptneox.GPTNeoXForCausalLM, gptneox.gptneox_config,
                                 "neox-tiny")):
        with pytest.raises(NotImplementedError, match="Training: the rest"):
            cls(config(preset, remat=True, remat_policy="dots"))
    for kw in (dict(serve_mode="layer_scan", quant={"enabled": True}),
               dict(serve_mode="capacity"), dict(quant={"enabled": True})):
        with pytest.raises(NotImplementedError, match="Weight quantization and serve modes"):
            deepspeed_tpu_torch.init_inference(type(model)(model.cfg), params=tree,
                                               dtype="fp32", device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="The rest"):
        from_hf_config({"model_type": "gptj", "n_embd": 64})
    with pytest.raises(NotImplementedError, match="hidden_act"):
        from_hf_config({"model_type": "gpt_neox", "hidden_act": "relu"})
