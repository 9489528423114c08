"""The port's MoE training held against the JAX package's on the CPU.

Weights, tokens and cotangents are made with numpy from a seed and handed
to both packages, in f32; the JAX grouped GEMM (megablox `gmm` and its VJP,
`gmm` on rhs^T and `tgmm`) runs in Pallas interpret mode, the port's on its
plain versions through the `GroupedGemm` autograd Function.

* The `MoE` layer under `gmm`, `ragged` and `einsum` (top-2 of 6 at
  capacity factor 1.0, so slots are dropped): output, `l_aux`,
  `router_load`, `router_drop` and the gradients of x, the router `wg` and
  the expert stacks of sum(out * g) + 0.1 * l_aux, against `jax.grad` of
  the JAX `MoE` on a one-device mesh: 1e-5.
* The tiny Qwen2-MoE and Mixtral loss functions (`qwen2_moe_loss_fn`,
  `mixtral_loss_fn`) from the same numpy tree, under `auto` (the ragged
  buffer in training) and `gmm`: the loss, the aux dict and every
  parameter's gradient: 1e-5.
* Five `train_batch` steps of the port's engine against the JAX engine on
  `qwen2moe-tiny` under `gmm` and `auto` (FusedAdam with weight decay,
  WarmupLR, clipping 1.0, GAS 2): loss and grad norm per step at 1e-5
  relative, the final parameters at 1e-5 (all but k_proj's bias, whose
  gradient is zero up to f32 rounding, so Adam's steps on it are noise).
* The port against itself: remat on equals remat off with and without a
  noisy gate (RSample), since the gate's uniforms are drawn before each
  checkpointed block; the noisy gate's draws follow their generator's seed
  (same seed, same routing; the engine's seed changes them) and never
  reach the gate weights or the aux loss. Random draws are not JAX's, so
  they are held by these cuts, not by value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.mixtral import (
    init_mixtral,
    mixtral_config as jax_mixtral_config,
    mixtral_loss_fn as jax_mixtral_loss_fn,
)
from deepspeed_tpu.models.qwen2_moe import (
    init_qwen2_moe,
    qwen2_moe_config as jax_qwen2_moe_config,
    qwen2_moe_loss_fn as jax_qwen2_moe_loss_fn,
)
from deepspeed_tpu.moe import layer as jax_layer
from deepspeed_tpu.utils import groups
from deepspeed_tpu.utils.groups import MeshTopology
from deepspeed_tpu_torch.models.llama import tree_to_torch
from deepspeed_tpu_torch.models.mixtral import (
    MixtralForCausalLM,
    mixtral_config,
    mixtral_loss_fn,
)
from deepspeed_tpu_torch.models.qwen2_moe import (
    Qwen2MoeForCausalLM,
    qwen2_moe_config,
    qwen2_moe_loss_fn,
    to_jax_params,
)
from deepspeed_tpu_torch.moe.layer import MoE

TOL = 1e-5
T, D, F_, E, K = 48, 16, 24, 6, 2
AUX_COEF = 0.1
STEPS = 5
CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-2, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-3,
                                                       "warmup_max_lr": 1e-2,
                                                       "warmup_num_steps": 4}},
          "gradient_clipping": 1.0}


@pytest.fixture(autouse=True)
def one_device_mesh():
    """The JAX `MoE` runs the bare grouped GEMM only off-mesh."""
    groups.initialize(MeshTopology(devices=jax.devices()[:1]))


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    w = {"wg": 0.5 * rng.standard_normal((D, E)),
         "gate": 0.2 * rng.standard_normal((E, D, F_)),
         "up": 0.2 * rng.standard_normal((E, D, F_)),
         "down": 0.2 * rng.standard_normal((E, F_, D))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    g = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    return w, x, g


@pytest.mark.parametrize("impl", ["gmm", "ragged", "einsum"])
def test_moe_layer_output_aux_and_grads_match_jax(impl):
    w, x, g = _layer_inputs(1)
    jmoe = jax_layer.MoE(hidden_size=D, num_experts=E, k=K, intermediate_size=F_,
                         capacity_factor=1.0, dispatch_impl=impl, dtype=jnp.float32)
    params = {"gate": {"wg": jnp.asarray(w["wg"])},
              "experts": {n: jnp.asarray(w[n]) for n in ("gate", "up", "down")}}

    def jax_loss(params, x):
        out, mut = jmoe.apply({"params": params}, x, train=True,
                              mutable=["aux_loss", "metrics"])
        l_aux = mut["aux_loss"]["moe_l_aux"]
        return jnp.sum(out * jnp.asarray(g)) + AUX_COEF * l_aux, (out, l_aux, mut["metrics"])

    (grads, dx), (out, l_aux, metrics) = jax.grad(jax_loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    moe = MoE(hidden_size=D, num_experts=E, k=K, intermediate_size=F_, capacity_factor=1.0,
              dispatch_impl=impl, dtype=torch.float32)
    with torch.no_grad():
        moe.gate.wg.copy_(torch.from_numpy(w["wg"]))
        for n in ("gate", "up", "down"):
            getattr(moe.experts, n).copy_(torch.from_numpy(w[n]))
    tx = torch.from_numpy(x).requires_grad_()
    got = moe(tx, train=True)
    (got * torch.from_numpy(g)).sum().add(AUX_COEF * moe.l_aux).backward()

    def close(a, b):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=TOL, atol=TOL)
    close(got, out)
    close(moe.l_aux, l_aux)
    close(moe.router_load, metrics["router_load"])
    close(moe.router_drop, metrics["router_drop"])
    assert float(moe.router_drop) > 0          # the capacity limit dropped slots
    close(tx.grad, dx)
    close(moe.gate.wg.grad, grads["gate"]["wg"])
    for n in ("gate", "up", "down"):
        close(getattr(moe.experts, n).grad, grads["experts"][n])


def numpy_tree(init, cfg, seed):
    """A JAX parameter tree of `cfg` made with numpy: normal(0.02) kernels,
    embeddings and experts, normal(0.5) routers (so the routing is not a
    near-tie), 0.2 for biases, RMSNorm weights near 1."""
    _, params, _ = init(cfg)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        key = jax.tree_util.keystr(path)
        if "norm" in key:
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        std = 0.2 if "bias" in key else 0.5 if "wg" in key else 0.02
        return (std * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


FAMILIES = {
    "qwen2moe": ("qwen2moe-tiny", init_qwen2_moe, jax_qwen2_moe_config, jax_qwen2_moe_loss_fn,
                 Qwen2MoeForCausalLM, qwen2_moe_config, qwen2_moe_loss_fn),
    "mixtral": ("mixtral-tiny", init_mixtral, jax_mixtral_config, jax_mixtral_loss_fn,
                MixtralForCausalLM, mixtral_config, mixtral_loss_fn),
}


@pytest.mark.parametrize("dispatch", ["auto", "gmm"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_fn_aux_and_grads_match_jax(family, dispatch):
    preset, init, jax_config, jax_loss_fn, cls, config, loss_fn = FAMILIES[family]
    jcfg = jax_config(preset, dtype=jnp.float32, dispatch_impl=dispatch)
    tree = numpy_tree(init, jcfg, 3)
    jmodel = type(init(jcfg)[0])(jcfg)
    ids = np.random.default_rng(4).integers(0, 256, (2, 32))
    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(jax_loss_fn(jmodel), has_aux=True)(
        tree, {"input_ids": jnp.asarray(ids, jnp.int32)}, None)

    model = cls(config(preset, dtype=torch.float32, dispatch_impl=dispatch)).load_jax_params(tree)
    loss, aux = loss_fn(model)(model, {"input_ids": torch.from_numpy(ids)})
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
    assert set(aux) == set(ref_aux) == {"lm_loss", "moe_aux_loss", "router_load", "router_drop"}
    for key in aux:
        np.testing.assert_allclose(aux[key].detach().numpy(), np.asarray(ref_aux[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    want = model.module_state(tree_to_torch(ref_grads, dtype=torch.float32))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


def token_batches(seed=1, steps=STEPS):
    return np.random.default_rng(seed).integers(0, 256, (steps, 4, 32))


def port_engine(tree, dispatch, config=CONFIG, **overrides):
    model = Qwen2MoeForCausalLM(qwen2_moe_config("qwen2moe-tiny", dtype=torch.float32,
                                                 dispatch_impl=dispatch, **overrides))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=tree, config=config,
                                                loss_fn=qwen2_moe_loss_fn(model), device="cpu")
    return engine


def run(engine, steps=STEPS):
    out = []
    for ids in token_batches(steps=steps):
        loss = engine.train_batch(batch={"input_ids": ids})
        out.append((float(loss), engine.get_global_grad_norm(), engine.get_lr()[0]))
    return out


@pytest.fixture(scope="module")
def qwen_tree():
    return numpy_tree(init_qwen2_moe, jax_qwen2_moe_config("qwen2moe-tiny", dtype=jnp.float32), 5)


@pytest.mark.parametrize("dispatch", ["gmm", "auto"])
def test_five_steps_match_jax_engine(qwen_tree, dispatch):
    groups.reset_topology()
    jcfg = jax_qwen2_moe_config("qwen2moe-tiny", dtype=jnp.float32, dispatch_impl=dispatch)
    jmodel = type(init_qwen2_moe(jcfg)[0])(jcfg)
    topology = MeshTopology(devices=jax.devices()[:1])
    groups.initialize(topology)
    jengine, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=qwen_tree,
                                           config=CONFIG, loss_fn=jax_qwen2_moe_loss_fn(jmodel),
                                           topology=topology)
    ref = run(jengine)
    engine = port_engine(qwen_tree, dispatch)
    got = run(engine)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=TOL, atol=0)
    assert engine.state.global_step == STEPS
    # k_proj's bias adds one constant to every logit of a query's row, which
    # softmax ignores: its gradient is 0 up to f32 rounding, and Adam turns
    # that rounding into full-size steps of either sign in both packages,
    # so its value is noise and is left out of the comparison
    for path, ref in jax.tree_util.tree_flatten_with_path(
            jax.device_get(jengine.state.params))[0]:
        key = jax.tree_util.keystr(path)
        if "k_proj" not in key or "bias" not in key:
            got = to_jax_params(engine.module)
            for p in path:
                got = got[p.key]
            np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL, err_msg=key)


def _noisy(engine):
    for layer in engine.module.layers:
        layer.mlp.gate.noisy_gate_policy = "RSample"
    return engine


@pytest.mark.parametrize("noisy", [False, True])
def test_remat_on_equals_remat_off(qwen_tree, noisy):
    """Remat recomputes each block in backward; the noisy gate's uniforms
    are drawn before the block, so its recompute routes as its forward did
    and the steps are equal. The noise does change the steps."""
    engines = [port_engine(qwen_tree, "gmm", remat=remat) for remat in (True, False)]
    if noisy:
        engines = [_noisy(e) for e in engines]
    on, off = (run(e, steps=2) for e in engines)
    np.testing.assert_allclose(np.asarray(on), np.asarray(off), rtol=1e-6)
    for a, b in zip(engines[0].module.parameters(), engines[1].module.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    if noisy:
        plain = run(port_engine(qwen_tree, "gmm"), steps=2)
        assert not np.allclose(np.asarray(on)[:, :2], np.asarray(plain)[:, :2], rtol=1e-6)


def test_noisy_gate_follows_its_generator(qwen_tree):
    """RSample draws from the generator it is given: the same seed routes
    the same, the engine's seed routes otherwise; the uniforms drawn
    beforehand (`draw_gate_noise`) are what the call would draw; the gate
    weights and the aux loss stay noiseless; eval (`train=False`) takes
    no noise."""
    w, x, _ = _layer_inputs(7)
    moe = MoE(hidden_size=D, num_experts=E, k=K, intermediate_size=F_, capacity_factor=2.0,
              noisy_gate_policy="RSample", dispatch_impl="gmm", dtype=torch.float32)
    with torch.no_grad():
        moe.gate.wg.copy_(torch.from_numpy(w["wg"]))
    tx = torch.from_numpy(x)

    def call(seed=None, **kw):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            out = moe(tx, noise_rng=gen, **kw)
        return out, moe.l_aux, moe.router_load

    noiseless, l_aux, _ = call()
    a, a_aux, a_load = call(0)
    b, _, _ = call(0)
    c, _, c_load = call(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c) and not torch.equal(a_load, c_load)
    assert not torch.allclose(a, noiseless)
    torch.testing.assert_close(a_aux.new_tensor(float(a_aux)), a_aux)
    pre = moe.draw_gate_noise(T, torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(moe(tx, gate_noise=pre), a, rtol=0, atol=0)
    assert moe.draw_gate_noise(T, None) is None
    eval_a, _, _ = call(0, train=False)
    eval_b, _, _ = call(1, train=False)
    torch.testing.assert_close(eval_a, eval_b, rtol=0, atol=0)
    # the gate probabilities behind l_aux are the noiseless softmax: the
    # top-1 counts differ between draws, the router's mean probabilities not
    logits = tx.reshape(T, D) @ moe.gate.wg.detach()
    me = torch.softmax(logits, -1).mean(0)
    ce = a_load * 0 + torch.zeros(E).scatter_add_(
        0, (logits - torch.log(-torch.log(pre.clamp_min(1e-20)))).argmax(-1),
        torch.ones(T)) / T
    torch.testing.assert_close(a_aux, (me * ce).sum() * E, rtol=1e-6, atol=1e-7)

    seeded = [run(_noisy(port_engine(qwen_tree, "gmm", config={**CONFIG, "seed": s})), steps=1)
              for s in (3, 3, 4)]
    assert seeded[0] == seeded[1] and seeded[0] != seeded[2]
