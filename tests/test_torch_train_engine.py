"""The port's training engine held against the JAX package's on the CPU.

Both packages get a tiny Llama (2 layers, hidden 64, 4 heads, 2 KV heads)
from the same numpy weights, the same config (FusedAdam with weight decay,
WarmupLR, clipping 1.0, GAS 2, micro-batch 2) and the same five batches of
32 tokens. The JAX engine runs on one device with the flash kernels in
Pallas interpret mode on 16-row tiles; the port's runs with
`device="cpu"`, where the flash wrappers take their plain versions. In
fp32, the per-step loss and grad norm agree to 1e-5 relative and the final
parameters to 1e-5 absolute. Under fp16 with a dynamic loss scale and
injected infs, the skipped steps, the scale, `global_step` and the lr that
follows must be equal. The rest holds the port to itself: the imperative
surface against `train_batch`, remat on against off, the batch fold rules,
and the refusals of what is not ported.
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
from deepspeed_tpu.models.llama import (  # noqa: E402
    LlamaForCausalLM as JaxLlama,
    llama_config as jax_llama_config,
    llama_loss_fn as jax_llama_loss_fn,
    materialize_params,
)
from deepspeed_tpu.utils.groups import MeshTopology  # noqa: E402
from deepspeed_tpu_torch.models.llama import (  # noqa: E402
    LlamaForCausalLM,
    llama_config,
    llama_loss_fn,
    to_jax_params,
)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError  # noqa: E402

TOL = 1e-5
STEPS = 5
SEQ = 32
CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-2, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-3,
                                                       "warmup_max_lr": 1e-2,
                                                       "warmup_num_steps": 4}},
          "gradient_clipping": 1.0}


def numpy_tree(seed: int = 0):
    """The tiny JAX Llama's parameter tree made with numpy: normal(0.02)
    kernels and embeddings, RMSNorm weights near 1."""
    _, params = materialize_params(jax_llama_config("llama-tiny", dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if "norm" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def token_batches(seed: int = 1, steps: int = STEPS):
    return np.random.default_rng(seed).integers(0, 256, (steps, 4, SEQ))


def jax_engine(tree, config, dtype=jnp.float32, loss_fn=None):
    cfg = jax_llama_config("llama-tiny", dtype=dtype, attn_impl="pallas")
    model = JaxLlama(cfg)
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=tree, config=config,
        loss_fn=loss_fn or jax_llama_loss_fn(model),
        topology=MeshTopology(devices=jax.devices()[:1]))
    return engine


def port_engine(tree, config=CONFIG, dtype=torch.float32, loss_fn=None, **overrides):
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=dtype, attn_impl="pallas",
                                          **overrides))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=tree, config=config,
        loss_fn=loss_fn or llama_loss_fn(model), device="cpu")
    return engine


@pytest.fixture(scope="module")
def tree():
    return numpy_tree()


@pytest.fixture(scope="module")
def jax_run(tree):
    """Five train_batch steps of the JAX engine: per-step (loss, grad norm,
    lr after the step) and the final parameters."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
        mp.setenv("DS_TPU_FLASH_BLOCK_K", "16")
        engine = jax_engine(tree, CONFIG)
        steps = []
        for ids in token_batches():
            loss = engine.train_batch(batch={"input_ids": ids})
            steps.append((float(loss), engine.get_global_grad_norm(), engine.get_lr()[0]))
        return steps, jax.device_get(engine.state.params)


def run_port(engine, steps=STEPS):
    out = []
    for ids in token_batches(steps=steps):
        loss = engine.train_batch(batch={"input_ids": ids})
        out.append((float(loss), engine.get_global_grad_norm(), engine.get_lr()[0]))
    return out


def test_five_steps_match_jax_engine(tree, jax_run):
    ref_steps, ref_params = jax_run
    engine = port_engine(tree)
    got = run_port(engine)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref_steps), rtol=TOL, atol=0)
    assert engine.state.global_step == STEPS and engine.global_steps == STEPS
    assert engine.state.opt_state.count == STEPS and engine.state.master is None
    jax.tree_util.tree_map(
        lambda g, r: np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=TOL),
        to_jax_params(engine.module), ref_params)


def test_imperative_surface_equals_train_batch(tree):
    """forward/backward/step over the same micro-batches gives the same
    losses, grad norms and weights as train_batch."""
    fused, manual = port_engine(tree), port_engine(tree)
    want = run_port(fused, steps=3)
    got = []
    for ids in token_batches(steps=3):
        losses = []
        for i, micro in enumerate((ids[:2], ids[2:])):
            loss = manual(dict(input_ids=micro))
            manual.backward(loss)
            assert manual.is_gradient_accumulation_boundary() == (i == 1)
            manual.step()   # acts at the boundary only
            losses.append(float(loss.detach()))
        got.append((float(np.mean(np.float32(losses))), manual.get_global_grad_norm(),
                    manual.get_lr()[0]))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
    for (name, a), b in zip(fused.module.state_dict().items(),
                            manual.module.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert manual.micro_steps == 6 and manual.global_steps == 3


def test_remat_on_equals_remat_off(tree):
    """Recomputing each block in backward changes nothing: the flash
    forward runs again inside the checkpointed block."""
    on, off = port_engine(tree, remat=True), port_engine(tree, remat=False)
    assert on.module.cfg.remat and not off.module.cfg.remat
    np.testing.assert_allclose(np.asarray(run_port(on, steps=2)),
                               np.asarray(run_port(off, steps=2)), rtol=1e-6)


def _poisoned(base, jax_side):
    """A loss function that multiplies the model's loss by the batch's
    `poison` (1, or inf/nan to force an overflow)."""
    if jax_side:
        def fn(params, batch, rng):
            loss, aux = base(params, {"input_ids": batch["input_ids"]}, rng)
            return loss * jnp.max(batch["poison"]), aux
    else:
        def fn(module, batch):
            loss, aux = base(module, {"input_ids": batch["input_ids"]})
            return loss * batch["poison"].max(), aux
    return fn


@pytest.mark.parametrize("per_micro", [False, True])
def test_fp16_overflow_skips_and_scale_match_jax(tree, per_micro):
    """Dynamic loss scale, hysteresis 2, window 3; infs and a nan injected
    into chosen micros: every step's skipped count, scale, global_step
    and the next lr equal the JAX engine's, and finite losses agree."""
    config = dict(CONFIG, fp16={"enabled": True, "initial_scale_power": 8, "hysteresis": 2,
                                "loss_scale_window": 3,
                                "per_micro_overflow_skip": per_micro})
    ids = token_batches(seed=3, steps=6)
    poison = np.ones((6, 4), np.float32)
    poison[1, 3], poison[2, 0], poison[4] = np.inf, np.inf, np.nan   # step 4: both micros
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_FLASH_BLOCK_Q", "16")
        mp.setenv("DS_TPU_FLASH_BLOCK_K", "16")
        ref_engine = jax_engine(tree, config, dtype=jnp.float16,
                                loss_fn=_poisoned(jax_llama_loss_fn(JaxLlama(
                                    jax_llama_config("llama-tiny", dtype=jnp.float16,
                                                     attn_impl="pallas"))), True))
        ref = []
        for i in range(6):
            loss = ref_engine.train_batch(batch={"input_ids": ids[i], "poison": poison[i]})
            ref.append((ref_engine.skipped_steps, ref_engine.cur_scale,
                        int(ref_engine.state.global_step), ref_engine.get_lr()[0], float(loss)))
    engine = port_engine(tree, config, dtype=torch.float16)
    engine.loss_fn = _poisoned(engine.loss_fn, False)
    got = []
    for i in range(6):
        loss = engine.train_batch(batch={"input_ids": ids[i], "poison": poison[i]})
        got.append((engine.skipped_steps, engine.cur_scale, engine.state.global_step,
                    engine.get_lr()[0], float(loss)))
    assert [g[:3] for g in got] == [r[:3] for r in ref]
    assert sum(g[0] > 0 for g in got) and got[-1][1] < 256.0   # it did skip and drop
    np.testing.assert_allclose([g[3] for g in got], [r[3] for r in ref], rtol=1e-6)
    for g, r in zip(got, ref):
        assert np.isfinite(g[4]) == np.isfinite(r[4])
        if np.isfinite(r[4]):
            np.testing.assert_allclose(g[4], r[4], rtol=1e-3)
    assert engine.state.opt_state.count == engine.state.global_step


def test_bf16_master_is_rounded_params_like_jax(tree):
    """Under bf16 the params are the bf16 weights and the f32 master is
    those weights upcast, not the original f32 ones, as in the JAX engine;
    at GAS 1 no accumulation buffer lives between steps."""
    config = dict(CONFIG, bf16={"enabled": True}, gradient_accumulation_steps=1)
    ref = jax.device_get(jax_engine(tree, config).state)
    engine = port_engine(tree, config)
    st = engine.state
    assert st.grad_acc is None and ref.grad_acc is None
    assert all(p.dtype == torch.bfloat16 for p in st.params.values())
    master = {k: v.float() for k, v in st.master.items()}
    for k, p in st.params.items():
        torch.testing.assert_close(master[k], p.float(), rtol=0, atol=0)
    engine.module.load_state_dict({k: v for k, v in master.items()})
    jax.tree_util.tree_map(
        lambda g, r: np.testing.assert_array_equal(g, np.asarray(r, np.float32)),
        to_jax_params(engine.module), ref.master)
    engine.train_batch(batch={"input_ids": token_batches()[0][:2]})
    assert engine.state.grad_acc is None and engine.state.global_step == 1


def test_train_batch_fold_rules_and_dataloader(tree):
    """A flat batch, the same rows stacked as (GAS, micro, S), and the
    engine's own dataloader over a dataset give the same step; a leading
    dim GAS does not divide raises."""
    ids = token_batches()[0]
    flat, stacked = port_engine(tree), port_engine(tree)
    a = flat.train_batch(batch={"input_ids": ids})
    b = stacked.train_batch(batch={"input_ids": ids.reshape(2, 2, SEQ)})
    assert float(a) == float(b)
    with pytest.raises(ValueError, match="not divisible"):
        flat.train_batch(batch={"input_ids": ids[:3]})
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32,
                                          attn_impl="pallas"))
    engine, _, loader, sched = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=tree, config=dict(CONFIG, dataloader_drop_last=True),
        loss_fn=llama_loss_fn(model), training_data={"input_ids": token_batches()[:2]
                                                     .reshape(8, SEQ)}, device="cpu")
    rows = list(iter(loader))
    assert len(rows) == 4 and all(r["input_ids"].shape == (2, SEQ) for r in rows)
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    it = RepeatingLoader(loader)
    direct = port_engine(tree)
    for _ in range(2):
        micros = [next(it) for _ in range(2)]
        want = direct.train_batch(batch={"input_ids": np.concatenate(
            [m["input_ids"] for m in micros])})
        got = engine.train_batch(data_iter=iter(micros))
        assert float(got) == float(want)
    assert sched.get_lr() == [engine.lr_fn(2)] and engine.global_samples == 8
    assert float(engine.eval_batch({"input_ids": ids})) == \
        float(llama_loss_fn()(engine.module, {"input_ids": torch.from_numpy(ids)})[0])


@pytest.mark.parametrize("key,value,item", [
    ("zero_optimization", {"stage": 2, "offload_optimizer": {"device": "cpu"}},
     "Training: the rest"),
    ("zero_optimization", {"stage": 3, "zero_quantized_gradients": True,
                           "zeropp_loco_param": {"err_beta": 0.8}}, "Multi-GPU"),
    ("tensor_parallel", {"tp_size": 2}, "Multi-GPU"),
    ("pipeline", {"pipeline_parallel_size": 2}, "Multi-GPU"),
    ("sequence_parallel_size", 2, "Multi-GPU"),
    ("telemetry", {"enabled": True}, "Training: the rest"),
    ("curriculum_learning", {"enabled": True}, "Training: the rest"),
    ("flops_profiler", {"enabled": True}, "The rest"),
    ("tensorboard", {"enabled": True}, "The rest"),
    ("optimizer", {"type": "OneBitLamb"}, "Training: the rest"),
    ("optimizer", {"type": "Lamb"}, "Training: the rest"),
])
def test_unported_config_raises(tree, key, value, item):
    with pytest.raises(NotImplementedError, match=item):
        port_engine(tree, dict(CONFIG, **{key: value}))


def test_config_errors_and_zero_stages(tree):
    with pytest.raises(DeepSpeedConfigError):
        port_engine(tree, dict(CONFIG, zero_optimization={"stage": 4}))
    for stage in (1, 3):   # one rank: every stage computes the same step
        engine = port_engine(tree, dict(CONFIG, zero_optimization={"stage": stage}))
        assert engine.zero_optimization_stage() == stage
    assert (engine.train_batch_size(), engine.train_micro_batch_size_per_gpu(),
            engine.gradient_accumulation_steps()) == (4, 2, 2)


@pytest.mark.parametrize("knob", [dict(remat=True, remat_policy="dots"),
                                  dict(remat=True, remat_policy="host_offload"),
                                  dict(loss_chunk_size=8), dict(mlp_chunk_size=8),
                                  dict(domino=True)])
def test_unported_model_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="Training: the rest"):
        LlamaForCausalLM(llama_config("llama-tiny", **knob))


def test_initialize_runs_on_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    model = LlamaForCausalLM(llama_config("llama-tiny"))
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=model, config=CONFIG)


def test_engine_takes_any_module_and_its_own_loader(tree):
    """The engine knows no model: a JAX tree goes through the module's own
    `load_jax_params`, and a module without one trains on its own weights."""
    engine = port_engine(tree)
    np.testing.assert_array_equal(to_jax_params(engine.module)["embed_tokens"],
                                  tree["embed_tokens"])
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)

    def loss_fn(module, batch):
        return ((module(batch["x"]) - batch["y"]) ** 2).mean()
    config = {"train_batch_size": 4, "optimizer": {"type": "Adam", "params": {"lr": 1e-1}}}
    with pytest.raises(TypeError, match="load_jax_params"):
        deepspeed_tpu_torch.initialize(model=model, model_parameters={"weight": 0},
                                       config=config, loss_fn=loss_fn, device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, loss_fn=loss_fn,
                                                device="cpu")
    batch = {"x": np.ones((4, 4), np.float32), "y": np.zeros((4, 1), np.float32)}
    losses = [float(engine.train_batch(batch=batch)) for _ in range(3)]
    assert losses[-1] < losses[0]
