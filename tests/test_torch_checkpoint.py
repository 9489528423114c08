"""The port's checkpoints held against themselves and against the JAX
package's on the CPU.

* Resume, on one rank: the tiny Llama (f32, the config of
  `tests/test_torch_train_engine.py`) trains 2 steps, saves, and a fresh
  engine built from other weights loads and trains 2 more: losses, grad
  norms, lr and the final parameters equal a run that never stopped, bit
  for bit, and the JAX engine's own save-and-resume to 1e-5 (steps
  relative, parameters absolute). The same bitwise with fp16 and infs in
  one batch (the scaler's state carries over), and on the tiny Qwen2-MoE
  with the noisy gate (the per-micro generator is `seed + micro_steps`).
* The 16-bit model file against the JAX file (`flax` msgpack), 1e-5;
  `zero_to_fp32` against the JAX `zero_to_fp32`, 1e-5; universal atoms of
  the port's checkpoint against the JAX package's `ds_to_universal` of
  its own, 1e-5, after the name mapping; the port's
  `restore_tree_from_universal` of the JAX folder resumes as the JAX
  engine does (1e-5); `checkpoint.load_universal` resumes bitwise.
* Resharding: ZeRO stages 0-3 at dp = 2 (two `gloo` ranks,
  `tests/torch_dp_ranks.py`) save after 2 steps; each save resumes at dp =
  2, at dp = 1 and (stage 3) at dp = 3, and a dp = 1 save resumes at dp = 2,
  on 12-row global batches and the tiny Llama with an intermediate width
  of 96 (at dp = 3 only the MLP kernels shard). Each resumed run's 2 steps
  and final parameters agree with the uninterrupted JAX run on
  `MeshTopology(dp=2)` to 1e-5. No byte is written twice: the ranks' files
  of a dp = 2 save hold what a dp = 1 save holds, within 5%.
  `zero_to_fp32` of a bf16 dp = 2 save equals `materialized_state()`'s
  master bit for bit, and of the f32 save the JAX `zero_to_fp32` of the
  JAX save to 1e-5.
* Tags (`latest`, an explicit tag, a missing `latest` warns and returns
  (None, {}), an unknown tag raises), weights-only loads (fresh moments; in
  f32 the JAX engine's steps, 1e-5; in bf16 the port makes its master from
  the loaded weights where the JAX engine keeps its own, ROADMAP.md Queue
  3), the async engine's snapshot, the readers of reference torch-DeepSpeed
  checkpoints against the JAX readers (equal), and what the config
  refuses.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from flax import serialization  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.models.llama import (  # noqa: E402
    LlamaForCausalLM as JaxLlama,
    llama_config as jax_llama_config,
    llama_loss_fn as jax_llama_loss_fn,
    materialize_params,
)
from deepspeed_tpu.utils.groups import MeshTopology as JaxTopology  # noqa: E402
from deepspeed_tpu_torch.models.llama import (  # noqa: E402
    LlamaForCausalLM,
    llama_config,
    llama_loss_fn,
    to_jax_params,
)
from deepspeed_tpu_torch.checkpoint import ds_to_universal  # noqa: E402
from deepspeed_tpu_torch.runtime.checkpoint_engine import AsyncCheckpointEngine  # noqa: E402
from deepspeed_tpu_torch.runtime.checkpointing import zero_to_fp32  # noqa: E402
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError  # noqa: E402
from tests import torch_dp_ranks as dp_ranks  # noqa: E402
from tests import torch_tp_ranks as ranks  # noqa: E402
from tests.test_torch_train_engine import (  # noqa: E402
    CONFIG,
    SEQ,
    _poisoned,
    jax_engine,
    numpy_tree,
    port_engine,
    token_batches,
)

TOL = 1e-5
STEPS, SAVE_AT = 4, 2


@pytest.fixture(autouse=True)
def small_flash_tiles(monkeypatch):
    """The JAX flash kernels in interpret mode on 16-row tiles."""
    monkeypatch.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
    monkeypatch.setenv("DS_TPU_FLASH_BLOCK_K", "16")


def steps_of(engine, batches):
    out = []
    for batch in batches:
        loss = engine.train_batch(batch=batch)
        out.append((float(loss), engine.get_global_grad_norm(), engine.get_lr()[0]))
    return out


def as_jax_tree(state, **overrides):
    """A module-named state dict as the tiny Llama's JAX tree (numpy)."""
    model = LlamaForCausalLM(llama_config("llama-tiny", **overrides), device="meta")
    model.load_state_dict({k: v.float() for k, v in state.items()}, assign=True)
    return to_jax_params(model)


def assert_trees(got, want, atol=TOL):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=atol),
        got, want)


def msgpack(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


# ----------------------------------------------------------- one rank

@pytest.fixture(scope="module")
def tree():
    return numpy_tree()


@pytest.fixture(scope="module")
def other():
    """The weights a resuming engine is built from before it loads."""
    return numpy_tree(seed=9)


@pytest.fixture(scope="module")
def batches():
    return [{"input_ids": b} for b in token_batches(steps=STEPS)]


@pytest.fixture(scope="module")
def one_rank(tree, other, batches, tmp_path_factory):
    """The port: a run that never stops, and one that saves after SAVE_AT
    steps and resumes in a fresh engine; its 16-bit file, zero_to_fp32
    and universal atoms."""
    root = tmp_path_factory.mktemp("one_rank")
    straight = port_engine(tree)
    out = dict(straight=steps_of(straight, batches),
               straight_params={k: v.clone() for k, v in straight.state.params.items()})
    first = port_engine(tree)
    steps_of(first, batches[:SAVE_AT])
    first.save_checkpoint(root / "ckpt")
    resumed = port_engine(other)
    path, client = resumed.load_checkpoint(root / "ckpt")
    out.update(path=path, client=client, resumed=steps_of(resumed, batches[SAVE_AT:]),
               resumed_params=dict(resumed.state.params), root=root,
               micro_steps=resumed.micro_steps)
    resumed.save_16bit_model(root / "16bit")
    zero_to_fp32(root / "ckpt", root / "fp32.pt")
    ds_to_universal(str(root / "ckpt"), str(root / "universal"))
    return out


@pytest.fixture(scope="module")
def jax_one_rank(tree, other, batches, tmp_path_factory):
    """The JAX engine's save-and-resume, with its 16-bit file,
    zero_to_fp32 and universal folder."""
    from deepspeed_tpu.checkpoint.ds_export import ds_to_universal
    from deepspeed_tpu.runtime.checkpointing import zero_to_fp32 as jax_zero_to_fp32
    root = tmp_path_factory.mktemp("jax_one_rank")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
        mp.setenv("DS_TPU_FLASH_BLOCK_K", "16")
        first = jax_engine(tree, CONFIG)
        steps_of(first, batches[:SAVE_AT])
        first.save_checkpoint(str(root / "ckpt"))
        resumed = jax_engine(other, CONFIG)
        resumed.load_checkpoint(str(root / "ckpt"))
        out = dict(resumed=steps_of(resumed, batches[SAVE_AT:]),
                   params=jax.device_get(resumed.state.params), root=root)
        resumed.save_16bit_model(str(root / "16bit"), "model.msgpack")
    jax_zero_to_fp32(str(root / "ckpt"), str(root / "fp32.msgpack"))
    ds_to_universal(str(root / "ckpt"), str(root / "universal"))
    return out


def test_resume_is_bitwise_and_matches_the_jax_resume(one_rank, jax_one_rank):
    got = one_rank
    assert got["resumed"] == got["straight"][SAVE_AT:]
    for k, v in got["straight_params"].items():
        torch.testing.assert_close(got["resumed_params"][k], v, rtol=0, atol=0)
    assert got["path"].endswith(f"global_step{SAVE_AT}") and got["client"] == {}
    assert got["micro_steps"] == STEPS * CONFIG["gradient_accumulation_steps"]
    np.testing.assert_allclose(np.asarray(got["resumed"]), np.asarray(jax_one_rank["resumed"]),
                               rtol=TOL, atol=0)
    assert_trees(as_jax_tree(got["resumed_params"]), jax_one_rank["params"])


def test_16bit_model_and_zero_to_fp32_match_jax(one_rank, jax_one_rank):
    root, jroot = one_rank["root"], jax_one_rank["root"]
    assert_trees(as_jax_tree(torch.load(root / "16bit" / "pytorch_model.bin")),
                 msgpack(jroot / "16bit" / "model.msgpack"))
    assert_trees(as_jax_tree(torch.load(root / "fp32.pt")), msgpack(jroot / "fp32.msgpack"))


def test_universal_atoms_match_jax_and_resume(one_rank, jax_one_rank, tree, other, batches):
    from deepspeed_tpu.checkpoint.ds_export import (
        restore_tree_from_universal as jax_restore)
    from deepspeed_tpu_torch.checkpoint import load_universal, restore_tree_from_universal
    mine, theirs = one_rank["root"] / "universal", str(jax_one_rank["root"] / "universal")
    atoms = load_universal(str(mine))
    assert set(atoms) == {"fp32", "exp_avg", "exp_avg_sq"}
    assert set(atoms["fp32"]) == set(dict(LlamaForCausalLM(
        llama_config("llama-tiny"), device="meta").named_parameters()))
    for state in atoms:
        assert_trees(as_jax_tree(atoms[state]), jax_restore(theirs, tree, state))
    # the port reads the JAX folder back into a JAX-shaped tree, and an
    # engine started from it steps as the JAX engine started from the same
    restored = restore_tree_from_universal(theirs, tree)
    ref = jax_restore(theirs, tree)
    jax.tree_util.tree_map(lambda g, w: np.testing.assert_array_equal(g.numpy(), w),
                           restored, ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
        mp.setenv("DS_TPU_FLASH_BLOCK_K", "16")
        want = steps_of(jax_engine(ref, CONFIG), batches[SAVE_AT:])
    got = steps_of(port_engine(jax.tree_util.tree_map(lambda t: t.numpy(), restored)),
                   batches[SAVE_AT:])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=0)
    # `checkpoint.load_universal`: the port's own atoms resume bitwise
    engine = port_engine(other, dict(CONFIG, checkpoint={"load_universal": True}))
    engine.load_checkpoint(str(mine))
    assert steps_of(engine, batches[SAVE_AT:]) == one_rank["straight"][SAVE_AT:]


def test_resume_with_fp16_overflows_is_bitwise(tree, other, tmp_path):
    """A step that overflows before the save and one after it: the
    skipped count, the scale, its hysteresis and window, and the steps
    equal the run that never stopped."""
    config = dict(CONFIG, fp16={"enabled": True, "initial_scale_power": 8, "hysteresis": 2,
                                "loss_scale_window": 3})
    ids = token_batches(seed=3, steps=5)
    poison = np.ones((5, 4), np.float32)
    poison[1, 3], poison[3, 0] = np.inf, np.inf
    feed = [{"input_ids": i, "poison": p} for i, p in zip(ids, poison)]

    def engine(weights):
        e = port_engine(weights, config, dtype=torch.float16)
        e.loss_fn = _poisoned(e.loss_fn, False)
        return e

    def trace(e, feed):
        return [(float(e.train_batch(batch=b)), e.skipped_steps, e.cur_scale,
                 e.state.global_step, e.get_lr()[0]) for b in feed]

    straight = engine(tree)
    want = trace(straight, feed)
    first = engine(tree)
    trace(first, feed[:3])
    first.save_checkpoint(tmp_path)
    resumed = engine(other)
    resumed.load_checkpoint(tmp_path)
    assert resumed.state.scaler == first.state.scaler and resumed.skipped_steps == 1
    got = trace(resumed, feed[3:])
    assert got == want[3:] and got[0][1] == 2
    for k, v in straight.state.params.items():
        torch.testing.assert_close(resumed.state.params[k], v, rtol=0, atol=0)


def test_resume_with_the_noisy_gate_is_bitwise(tmp_path):
    """The tiny Qwen2-MoE with RSample: the gate's draws come from the
    generator `seed + micro_steps`, which the load restores."""
    from deepspeed_tpu.models.qwen2_moe import init_qwen2_moe, qwen2_moe_config as jax_cfg
    from deepspeed_tpu_torch.models.qwen2_moe import (
        Qwen2MoeForCausalLM, qwen2_moe_config, qwen2_moe_loss_fn)
    from tests.test_torch_moe_training import numpy_tree as moe_tree
    weights = moe_tree(init_qwen2_moe, jax_cfg("qwen2moe-tiny", dtype=jnp.float32), 5)
    feed = [{"input_ids": b} for b in token_batches(seed=4, steps=3)]

    def engine(weights):
        model = Qwen2MoeForCausalLM(qwen2_moe_config("qwen2moe-tiny", dtype=torch.float32,
                                                     dispatch_impl="gmm"))
        for layer in model.layers:
            layer.mlp.gate.noisy_gate_policy = "RSample"
        e, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=weights,
                                               config=CONFIG, loss_fn=qwen2_moe_loss_fn(model),
                                               device="cpu")
        return e

    straight = engine(weights)
    want = steps_of(straight, feed)
    first = engine(weights)
    steps_of(first, feed[:1])
    first.save_checkpoint(tmp_path)
    resumed = engine(None)             # the module's own random weights until the load
    resumed.load_checkpoint(tmp_path)
    assert steps_of(resumed, feed[1:]) == want[1:]
    # with its micro count wound back the gate draws other noise
    blind = engine(None)
    blind.load_checkpoint(tmp_path)
    blind.micro_steps = 0
    assert steps_of(blind, feed[1:2])[0][0] != want[1][0]


def test_latest_and_tags(tree, other, batches, tmp_path, caplog):
    """As the JAX package's `test_checkpoint_edge.py:61,75`: `latest`
    names the last save; an explicit tag loads that save; a directory
    without `latest` warns and loads nothing; an unknown tag raises."""
    e = port_engine(tree)
    steps_of(e, batches[:1])
    e.save_checkpoint(tmp_path, tag="step1", client_state={"epoch": 3})
    after1 = {k: v.clone() for k, v in e.state.params.items()}
    steps_of(e, batches[1:2])
    e.save_checkpoint(tmp_path, tag="step2")
    assert (tmp_path / "latest").read_text() == "step2"
    e2 = port_engine(other)
    before = {k: v.clone() for k, v in e2.state.params.items()}
    from deepspeed_tpu_torch.utils.logging import logger
    logger.addHandler(caplog.handler)          # the port's logger does not propagate
    try:
        assert e2.load_checkpoint(tmp_path / "nope") == (None, {})
    finally:
        logger.removeHandler(caplog.handler)
    assert "no 'latest' file" in caplog.text
    for k, v in before.items():
        torch.testing.assert_close(e2.state.params[k], v, rtol=0, atol=0)
    path, client = e2.load_checkpoint(tmp_path, tag="step1")
    assert path.endswith("step1") and client == {"epoch": 3} and e2.global_steps == 1
    for k, v in after1.items():
        torch.testing.assert_close(e2.state.params[k], v, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        e2.load_checkpoint(tmp_path, tag="does-not-exist")
    path, _ = e2.load_checkpoint(tmp_path)
    assert path.endswith("step2") and e2.state.global_step == 2


def test_weights_only_load_in_f32_matches_jax(one_rank, jax_one_rank, tree, other, batches):
    """`load_optimizer_states=False`: the parameters load, the moments start
    afresh (count 0); the next steps equal the JAX engine's after its own
    weights-only load (1e-5)."""
    root, jroot = one_rank["root"], jax_one_rank["root"]
    e = port_engine(other)
    e.load_checkpoint(root / "ckpt", load_optimizer_states=False)
    assert e.state.opt_state.count == 0 and e.state.global_step == 0
    assert all(float(t.abs().max()) == 0 for t in e.state.opt_state.exp_avg.values())
    got = steps_of(e, batches[SAVE_AT:])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
        mp.setenv("DS_TPU_FLASH_BLOCK_K", "16")
        j = jax_engine(other, CONFIG)
        j.load_checkpoint(str(jroot / "ckpt"), load_optimizer_states=False)
        want = steps_of(j, batches[SAVE_AT:])
        params = jax.device_get(j.state.params)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=0)
    assert_trees(as_jax_tree(e.state.params), params)


def test_weights_only_load_in_bf16_makes_the_master_from_the_weights(tree, other, tmp_path):
    """In bf16 the port's master is the loaded weights upcast; the JAX
    engine keeps its own master, which its next step writes back over the
    loaded weights (ROADMAP.md Queue 3, a reference defect)."""
    bf16 = dict(CONFIG, bf16={"enabled": True})
    port_engine(tree, bf16).save_checkpoint(tmp_path / "port")
    e = port_engine(other, bf16)
    e.load_checkpoint(tmp_path / "port", load_optimizer_states=False)
    saved = port_engine(tree, bf16).state.params
    for k, p in e.state.params.items():
        torch.testing.assert_close(p, saved[k], rtol=0, atol=0)
        torch.testing.assert_close(e.state.master[k], p.float(), rtol=0, atol=0)
    jax_engine(tree, bf16).save_checkpoint(str(tmp_path / "jax"))
    j = jax_engine(other, bf16)
    fresh_master = jax.device_get(j.state.master)
    j.load_checkpoint(str(tmp_path / "jax"), load_optimizer_states=False)
    loaded = jax.device_get(j.state.params)
    master = jax.device_get(j.state.master)
    jax.tree_util.tree_map(np.testing.assert_array_equal, master, fresh_master)
    differs = jax.tree_util.tree_map(
        lambda m, p: not np.array_equal(np.asarray(m), np.asarray(p, np.float32)), master, loaded)
    assert all(jax.tree_util.tree_leaves(differs))


def test_async_engine_snapshots_at_save(tree, batches, tmp_path):
    """The async save copies the state to host memory before it returns:
    the steps after it, which update the state in place, leave the file as
    it was."""
    e = port_engine(tree)
    steps_of(e, batches[:1])
    want = {k: v.clone() for k, v in e.state.params.items()}
    ce = AsyncCheckpointEngine()
    ce.save({"params": e.state.params, "count": e.state.opt_state.count}, str(tmp_path / "a.pt"))
    steps_of(e, batches[1:3])
    assert ce.commit("tag")
    got = ce.load(str(tmp_path / "a.pt"))
    assert got["count"] == 1
    for k, v in want.items():
        torch.testing.assert_close(got["params"][k], v, rtol=0, atol=0)
        assert not torch.equal(e.state.params[k], v)


def _reference_dir(root, stage, world=2, delta=0.0):
    """A reference-layout checkpoint as the JAX package's
    `test_ds_import.py` writes one, from a random HF-shaped state dict."""
    g = torch.Generator().manual_seed(stage)
    shapes = {"model.embed_tokens.weight": (32, 16), "model.layers.0.mlp.up_proj.weight": (24, 16),
              "model.layers.0.input_layernorm.weight": (16,), "lm_head.weight": (32, 16),
              "model.norm.weight": (15,)}
    sd = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    tag = "global_step3"
    d = os.path.join(root, tag)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(root, "latest"), "w") as f:
        f.write(tag)
    torch.save({"module": {f"module.{k}": v.bfloat16() for k, v in sd.items()},
                "param_shapes": [{n: torch.Size(s) for n, s in shapes.items()}],
                "global_steps": 3, "ds_version": "0.16.3"},
               os.path.join(d, "mp_rank_00_model_states.pt"))
    fp32 = {n: sd[n] + delta for n in sd}
    if stage <= 2:
        flat = torch.cat([fp32[n].reshape(-1) for n in sd])
        flat = torch.cat([flat, torch.zeros((-flat.numel()) % (2 * world))])
        per = flat.numel() // world
        shards = [flat[r * per:(r + 1) * per] for r in range(world)]
    else:
        parts = [[] for _ in range(world)]
        for n in sd:
            v = fp32[n].reshape(-1)
            part = -(-v.numel() // world)
            v = torch.cat([v, torch.zeros(part * world - v.numel())])
            for r in range(world):
                parts[r].append(v[r * part:(r + 1) * part])
        shards = [torch.cat(p) for p in parts]
    for r in range(world):
        torch.save({"optimizer_state_dict": {"zero_stage": stage, "partition_count": world,
                                             "fp32_flat_groups": [shards[r]]}},
                   os.path.join(d, f"zero_pp_rank_{r}_mp_rank_00_optim_states.pt"))


@pytest.mark.parametrize("stage,world", [(2, 2), (3, 2), (3, 3)])
def test_reference_checkpoint_readers_match_jax(tmp_path, stage, world):
    from deepspeed_tpu import checkpoint as jax_ck
    from deepspeed_tpu_torch import checkpoint as ck
    _reference_dir(str(tmp_path), stage, world, delta=1.0)
    got, ref = ck.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path)), \
        jax_ck.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    assert set(got) == set(ref) and len(got) == 5
    for n in ref:
        np.testing.assert_array_equal(got[n].numpy(), ref[n])
    (sd, meta), (rsd, rmeta) = ck.load_model_states(str(tmp_path)), \
        jax_ck.load_model_states(str(tmp_path))
    assert meta == rmeta and meta["global_steps"] == 3
    for n in rsd:
        np.testing.assert_array_equal(sd[n].float().numpy(), rsd[n])
    merged, _ = ck.load_reference_checkpoint(str(tmp_path))
    rmerged, _ = jax_ck.load_reference_checkpoint(str(tmp_path))
    for n in rmerged:
        np.testing.assert_array_equal(merged[n].float().numpy(), rmerged[n])
    with pytest.raises(NotImplementedError, match="The rest"):
        ck.import_reference_checkpoint(str(tmp_path), config={})


def test_checkpoint_config_block():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    block = {"checkpoint": {"tag_validation": "Fail", "load_universal": True}}
    got = DeepSpeedConfig(dict(CONFIG, **block), world_size=1)
    ref = JaxConfig(dict(CONFIG, **block), world_size=1)
    assert got.load_universal_checkpoint is ref.load_universal_checkpoint is True
    assert got.checkpoint_config.tag_validation == ref.checkpoint_config.tag_validation
    assert DeepSpeedConfig(dict(CONFIG), world_size=1).load_universal_checkpoint is False
    with pytest.raises(DeepSpeedConfigError, match="tag_validation"):
        DeepSpeedConfig(dict(CONFIG, checkpoint={"tag_validation": "Sometimes"}), world_size=1)


# ------------------------------------------------------- across data ranks

WIDE = dict(intermediate_size=96)      # at dp = 3 the MLP kernels shard
ROWS = 12                              # a global batch: GAS 2 x 6 rows
RESHARD_STAGES = (0, 1, 2, 3)


def wide_tree(seed):
    """The tiny Llama of width 96 as a numpy JAX tree (`numpy_tree`'s
    distributions)."""
    _, params = materialize_params(jax_llama_config("llama-tiny", dtype=jnp.float32, **WIDE))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if "norm" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def wide_config(dp, stage=0, **extra):
    return dict(CONFIG, **extra, train_micro_batch_size_per_gpu=ROWS // (2 * dp),
                zero_optimization={"stage": stage, "stage3_param_persistence_threshold": 1000})


@pytest.fixture(scope="module")
def wide():
    feed = np.random.default_rng(21).integers(0, 256, (STEPS, ROWS, SEQ))
    return dict(tree=wide_tree(0), other=wide_tree(9), batches=[{"input_ids": b} for b in feed])


def wide_engine(weights, config, dtype=torch.float32):
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=dtype, attn_impl="pallas", **WIDE))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=weights,
                                                config=config, loss_fn=llama_loss_fn(model),
                                                device="cpu")
    return engine


@pytest.fixture(scope="module")
def reshard(wide, tmp_path_factory):
    """A dp = 1 save (this process); the dp = 2 ranks' saves at each stage
    and their resumes from those and from the dp = 1 save, and a bf16
    stage-3 save (one spawn); a dp = 3 spawn resuming the stage-3 save; this
    process resuming each dp = 2 save at dp = 1."""
    root = tmp_path_factory.mktemp("reshard")
    one = wide_engine(wide["tree"], wide_config(1))
    steps_of(one, wide["batches"][:SAVE_AT])
    one.save_checkpoint(root / "dp1")
    tree, other, feed = wide["tree"], wide["other"], wide["batches"]
    runs = {}
    for s in RESHARD_STAGES:
        cfg, at = wide_config(2, s), str(root / f"dp2_s{s}")
        runs[f"save{s}"] = ("resume", ("tree", cfg, feed[:SAVE_AT], None, at, "float32", WIDE))
        runs[f"resume{s}"] = ("resume", ("other", cfg, feed[SAVE_AT:], at, None, "float32",
                                         WIDE))
        runs[f"from1_{s}"] = ("resume", ("other", cfg, feed[SAVE_AT:], str(root / "dp1"), None,
                                         "float32", WIDE))
    runs["bf16"] = ("resume", ("tree", wide_config(2, 3, bf16={"enabled": True}), feed[:1],
                               None, str(root / "bf16"), "bfloat16", WIDE))
    trees = dict(tree=tree, other=other)
    two = ranks.spawn(dp_ranks.scenarios, trees, runs, tmp_path=root)
    three = ranks.spawn(dp_ranks.scenarios, trees, {"from2": (
        "resume", ("other", wide_config(3, 3), feed[SAVE_AT:], str(root / "dp2_s3"), None,
                   "float32", WIDE))}, tmp_path=root / "three", world=3)
    at_one = {}
    for s in RESHARD_STAGES:
        e = wide_engine(other, wide_config(1))
        e.load_checkpoint(root / f"dp2_s{s}")
        at_one[s] = (steps_of(e, feed[SAVE_AT:]), as_jax_tree(e.state.params, **WIDE))
    return dict(root=root, two=two, three=three, at_one=at_one)


@pytest.fixture(scope="module")
def jax_wide(wide, tmp_path_factory):
    """The uninterrupted JAX run over dp = 2: its steps after the save
    point, final parameters, and the zero_to_fp32 of its save there."""
    from deepspeed_tpu.runtime.checkpointing import zero_to_fp32 as jax_zero_to_fp32
    root = tmp_path_factory.mktemp("jax_wide")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
        mp.setenv("DS_TPU_FLASH_BLOCK_K", "16")
        model = JaxLlama(jax_llama_config("llama-tiny", dtype=jnp.float32, attn_impl="pallas",
                                          **WIDE))
        engine, *_ = deepspeed_tpu.initialize(
            model=model, model_parameters=wide["tree"], config=wide_config(2, 2),
            loss_fn=jax_llama_loss_fn(model), topology=JaxTopology(dp=2,
                                                                   devices=jax.devices()[:2]))
        steps_of(engine, wide["batches"][:SAVE_AT])
        engine.save_checkpoint(str(root / "ckpt"))
        steps = steps_of(engine, wide["batches"][SAVE_AT:])
        params = jax.device_get(engine.state.params)
    jax_zero_to_fp32(str(root / "ckpt"), str(root / "fp32.msgpack"))
    return dict(steps=steps, params=params, fp32=msgpack(root / "fp32.msgpack"))


def _resumed(got, jax_wide, what):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(jax_wide["steps"]), rtol=TOL,
                               atol=0, err_msg=what)
    assert_trees(got[1], jax_wide["params"])


@pytest.mark.parametrize("stage", RESHARD_STAGES)
def test_a_dp2_save_resumes_at_dp2_and_dp1_like_the_uninterrupted_jax_run(reshard, jax_wide,
                                                                          stage):
    for rank, r in enumerate(reshard["two"]):
        got = r[f"resume{stage}"]
        _resumed((got["steps"], got["tree"]), jax_wide, f"dp 2 -> 2, rank {rank}")
        assert got["micro_steps"] == 2 * STEPS and got["global_step"] == STEPS
        assert got["global_samples"] == ROWS * STEPS
    _resumed(reshard["at_one"][stage], jax_wide, "dp 2 -> 1")


@pytest.mark.parametrize("stage", RESHARD_STAGES)
def test_a_dp1_save_resumes_at_dp2(reshard, jax_wide, stage):
    for rank, r in enumerate(reshard["two"]):
        got = r[f"from1_{stage}"]
        _resumed((got["steps"], got["tree"]), jax_wide, f"dp 1 -> 2, rank {rank}")


def test_a_dp2_save_resumes_at_dp3(reshard, jax_wide):
    """dp = 3 divides only the MLP kernels' width: the rest stay whole."""
    for rank, r in enumerate(reshard["three"]):
        got = r["from2"]
        _resumed((got["steps"], got["tree"]), jax_wide, f"dp 2 -> 3, rank {rank}")
    trees = [r["from2"]["tree"] for r in reshard["three"]]
    jax.tree_util.tree_map(np.testing.assert_array_equal, trees[0], trees[1])


@pytest.mark.parametrize("stage", RESHARD_STAGES)
def test_ranks_write_each_byte_once(reshard, stage):
    """The dp = 2 ranks' files hold what one rank's save holds (pieces
    padded, one file's framing more), never a leaf twice; at stage 0 rank
    1 writes nothing."""
    from deepspeed_tpu_torch.runtime.checkpointing import MODEL_STATES, OPTIM_STATES
    step_dir = reshard["root"] / "dp1" / f"global_step{SAVE_AT}"
    one = sum(os.path.getsize(step_dir / d / f) for d in (MODEL_STATES, OPTIM_STATES)
              for f in os.listdir(step_dir / d))
    written = [r[f"save{stage}"]["bytes"] for r in reshard["two"]]
    assert abs(sum(written) - one) <= 0.05 * one, (written, one)
    if stage == 0:
        assert written[1] == 0
    else:
        assert written[1] > 0.25 * one


def test_zero_to_fp32_of_a_dp2_save(reshard, jax_wide):
    """bf16: the master whole, as `materialized_state()` gathers it, bit for
    bit; f32 (no master: the parameters): the JAX `zero_to_fp32` of the
    JAX engine's save at the same step, 1e-5."""
    root = reshard["root"]
    zero_to_fp32(root / "bf16", root / "bf16.pt")
    got = torch.load(root / "bf16.pt")
    want = reshard["two"][0]["bf16"]["master"]
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    zero_to_fp32(root / "dp2_s3", root / "f32.pt")
    assert_trees(as_jax_tree(torch.load(root / "f32.pt"), **WIDE), jax_wide["fp32"])
