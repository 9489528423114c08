"""The port's 1-bit wire (1-bit Adam, 0/1 Adam, 1-bit LAMB with
`comm_backend_name`) held against the JAX wire engine on the CPU.

Two gloo ranks (`tests/torch_dp_ranks.py`, one spawn for the file) train
the tiny Llama in f32 at dp = 2, ZeRO stage 0, no clipping, micro-batch 2
a rank and GAS 2, rows of 64 tokens that hold every token of the vocab
(`global_batches`), attention on its reference path, from the same numpy
weights as the JAX engine on `MeshTopology(dp=2)`: 1-bit Adam and 1-bit
LAMB with `freeze_step` 2 over four steps (two exact, two compressed), 0/1
Adam with `var_freeze_step` 4, `var_update_scaler` 1, `local_step_scaler`
1 and `local_step_clipper` 2 over seven steps (exact variance steps, a
compressed one before the freeze, exchanges, and a local step that moves
no byte). Per step the loss and the pre-clip norm (of the ranks' mean
gradient) agree to 1e-5 relative, and the final weights to 1e-5 but for a
share of at most 1e-3 of them (printed): the compressed exchange sends
the sign of each element, and an element within rounding of zero may take
+1 in one package and -1 in the other. Each rank's compression error, fed
back into the next exchange, agrees with the JAX state's row for that
rank, differs between the ranks, and is zero during the warm-up. The
warm-up steps equal FusedAdam's (the same ranks, the same rows) to 1e-6.
A 1-bit Adam run saved after its third step and resumed by a fresh engine
takes its fourth step bit for bit, the wire state with it. The compressed
all-reduce itself agrees with the JAX function inside `shard_map`, and the
four JAX refusals hold with the JAX messages.
"""

import functools

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.models.llama import (  # noqa: E402
    LlamaForCausalLM as JaxLlama,
    llama_config as jax_llama_config,
    llama_loss_fn as jax_llama_loss_fn,
)
from deepspeed_tpu.runtime.comm.compressed import compressed_allreduce  # noqa: E402
from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JaxConfigError  # noqa: E402
from deepspeed_tpu.utils.groups import MeshTopology as JaxTopology  # noqa: E402
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config  # noqa: E402
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError  # noqa: E402
from deepspeed_tpu_torch.utils import groups  # noqa: E402
from tests import torch_dp_ranks as dp_ranks  # noqa: E402
from tests import torch_tp_ranks as ranks  # noqa: E402
from tests.test_torch_train_engine import SEQ, numpy_tree  # noqa: E402

TOL = 1e-5
FLIP_SHARE = 1e-3
LR = 1e-2
BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-3,
                                                     "warmup_max_lr": LR,
                                                     "warmup_num_steps": 4}}}
WIRES = {
    "adam": ("OneBitAdam", dict(freeze_step=2, weight_decay=0.01), 4),
    "lamb": ("OneBitLamb", dict(freeze_step=2, weight_decay=0.01), 4),
    "zeroone": ("ZeroOneAdam", dict(var_freeze_step=4, var_update_scaler=1,
                                    local_step_scaler=1, local_step_clipper=2,
                                    weight_decay=0.01, lr=1e-3), 7),
}
FREEZE = 2


def wire_config(name, **extra):
    """0/1 Adam at lr 1e-3: its sign-compressed local steps at 1e-2 after
    a four-step warm-up send this tiny model's loss from 5.6 to 12."""
    kind, params, _ = WIRES[name]
    params = dict(dict(lr=LR, comm_backend_name="gloo"), **params)
    sched = {"type": "WarmupLR", "params": {"warmup_min_lr": params["lr"] / 10,
                                            "warmup_max_lr": params["lr"],
                                            "warmup_num_steps": 4}}
    return dict(BASE, optimizer={"type": kind, "params": params}, scheduler=sched, **extra)


def fused_config():
    return dict(BASE, optimizer={"type": "FusedAdam", "params": {"lr": LR,
                                                                 "weight_decay": 0.01}})


def global_batches(steps, seed=1):
    """Each step's 8 rows of 2 * SEQ tokens hold every token of the vocab
    twice, once at least where it has a label: every embedding row has a
    gradient, so no variance stays 0 (where 0/1 Adam's compressed steps
    before the freeze move a weight by lr * m / eps)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        while True:
            ids = np.concatenate([rng.permutation(256), rng.permutation(256)]).reshape(8, 2 * SEQ)
            if set(ids[:, :-1].reshape(-1)) == set(range(256)):
                break
        out.append({"input_ids": ids})
    return out


@pytest.fixture(scope="module", autouse=True)
def _manual_region_constraints():
    """The JAX models' `shard_along` inside a `shard_map` manual region:
    the identity. The JAX package's check for manual axes compares
    `str(axis_type)` with "Manual", which JAX 0.9 spells
    "AxisType.Manual", so the constraint names a manual axis and JAX
    refuses it; a sharding constraint moves no value, so the engine's
    numbers are the same without it."""
    from jax.sharding import AxisType

    import deepspeed_tpu.models.llama as jax_llama
    original = jax_llama.shard_along

    def shard_along(x, *axes, **kwargs):
        mesh = jax.sharding.get_abstract_mesh()
        if mesh is not None and not mesh.empty and AxisType.Manual in mesh.axis_types:
            return x
        return original(x, *axes, **kwargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_llama, "shard_along", shard_along)
        yield


@pytest.fixture(scope="module")
def tree():
    return numpy_tree()


@pytest.fixture(scope="module")
def port(tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("onebit")
    save = str(tmp / "save")
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((2,) + s).astype(np.float32) for s in ((300,), (16, 24))]
    errors = [0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in xs]
    runs = {"compressed": ("compressed", (xs, errors))}
    for name, (_, _, steps) in WIRES.items():
        runs[name] = ("train", (wire_config(name), global_batches(steps), {},
                                save if name == "adam" else None, 2))
    runs["fused"] = ("train", (fused_config(), global_batches(FREEZE), {}))
    runs["resumed"] = ("resume", (wire_config("adam"), global_batches(4)[3:], {}, save))
    out = ranks.spawn(dp_ranks.zeropp_scenarios, tree, runs, tmp_path=tmp)
    return dict(ranks=out, xs=xs, errors=errors)


@functools.lru_cache(maxsize=None)
def jax_run(name):
    model = JaxLlama(jax_llama_config("llama-tiny", dtype=jnp.float32))
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=numpy_tree(), config=wire_config(name),
        loss_fn=jax_llama_loss_fn(model), topology=JaxTopology(dp=2, devices=jax.devices()[:2]))
    steps = []
    for batch in global_batches(WIRES[name][2]):
        loss = engine.train_batch(batch=batch)
        steps.append((float(loss), engine.get_global_grad_norm()))
    state = jax.device_get(engine.state)
    return steps, state.params, state.opt_state


def _beyond(got, want):
    bad = [int((np.abs(np.asarray(g) - np.asarray(w)) > TOL).sum())
           for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want))]
    total = sum(np.asarray(w).size for w in jax.tree_util.tree_leaves(want))
    return sum(bad), total


@pytest.mark.parametrize("name", list(WIRES))
def test_wire_matches_jax(port, name):
    steps, params, _ = jax_run(name)
    for rank, r in enumerate(port["ranks"]):
        np.testing.assert_allclose(np.asarray(r[name]["steps"]), np.asarray(steps),
                                   rtol=TOL, atol=0)
        n, total = _beyond(r[name]["tree"], params)
        print(f"{name} rank {rank}: {n} of {total} weights beyond {TOL} (share "
              f"{n / total:.2e})")
        assert n <= FLIP_SHARE * total
    jax.tree_util.tree_map(np.testing.assert_array_equal, port["ranks"][0][name]["tree"],
                           port["ranks"][1][name]["tree"])


@pytest.mark.parametrize("name", list(WIRES))
def test_error_feedback_matches_jax(port, name):
    """Each rank's error buffer after the run: its row of the JAX state's
    (a leading rank axis), different on the two ranks."""
    _, _, opt = jax_run(name)
    errs = []
    for rank, r in enumerate(port["ranks"]):
        mine = dp_ranks_tree(r[name]["wire"]["error"])
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, np.asarray(w)[rank], rtol=0,
                                                    atol=1e-4),
            mine, opt.error)
        errs.append(mine)
    assert any(not np.array_equal(a, b) for a, b in
               zip(jax.tree_util.tree_leaves(errs[0]), jax.tree_util.tree_leaves(errs[1])))


def dp_ranks_tree(tensors):
    """A name -> tensor dict of the tiny Llama's leaves as its JAX tree."""
    from deepspeed_tpu_torch.models.llama import to_jax_params
    model = LlamaForCausalLM(llama_config("llama-tiny"), device="meta")
    model.load_state_dict({k: v.float() for k, v in tensors.items()}, assign=True)
    return to_jax_params(model)


def test_warmup_is_fused_adam(port):
    """Up to the freeze the 1-bit Adam wire is Adam over the ranks' mean
    gradient: its steps and first-step weights are FusedAdam's, and its
    error stays zero."""
    for r in port["ranks"]:
        np.testing.assert_allclose(np.asarray(r["adam"]["steps"][:FREEZE]),
                                   np.asarray(r["fused"]["steps"]), rtol=1e-6, atol=0)
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=1e-6),
            r["adam"]["tree1"], r["fused"]["tree1"])
        stats = r["fused"]["stats"]
        assert "compressed_allreduce" not in stats
        assert r["adam"]["stats"]["compressed_allreduce"]["calls"] > 0


def test_wire_state_resumes_bit_for_bit(port):
    for r in port["ranks"]:
        got, want = r["resumed"], r["adam"]
        assert got["steps"] == want["steps"][3:]
        jax.tree_util.tree_map(np.testing.assert_array_equal, got["tree"], want["tree"])
        for field, value in want["wire"].items():
            if isinstance(value, dict):
                for k, t in value.items():
                    torch.testing.assert_close(got["wire"][field][k], t, rtol=0, atol=0)
            else:
                assert got["wire"][field] == value, field


def test_compressed_allreduce_matches_jax(port):
    """Against the JAX function in `shard_map`: the mean to 1e-6 and each
    rank's new error to 1e-6; `compressed_allreduce_many` is the single
    call on each tensor; the bytes are the signs plus 4 a tensor."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    for i, (x, e) in enumerate(zip(port["xs"], port["errors"])):
        def region(xl, el):
            avg, err = compressed_allreduce(xl[0], el[0], "data")
            return avg[None], err[None]
        avg, err = jax.shard_map(region, mesh=mesh, in_specs=(P("data"), P("data")),
                                 out_specs=(P("data"), P("data")), check_vma=False)(
            jnp.asarray(x), jnp.asarray(e))
        for rank, r in enumerate(port["ranks"]):
            got = r["compressed"]
            np.testing.assert_allclose(got["one"][i][0].numpy(), np.asarray(avg[rank]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got["one"][i][1].numpy(), np.asarray(err[rank]),
                                       rtol=0, atol=1e-6)
            torch.testing.assert_close(got["many"][0][i], got["one"][i][0], rtol=0, atol=1e-7)
            torch.testing.assert_close(got["many"][1][i], got["one"][i][1], rtol=0, atol=0)
    stats = port["ranks"][0]["compressed"]["stats"]["compressed_allreduce"]
    assert stats == dict(stats, calls=2, bytes=sum(x[0].size + 4 for x in port["xs"]))


@pytest.mark.parametrize("extra,match", [
    (dict(zero_optimization={"stage": 1}), "requires ZeRO stage 0"),
    (dict(gradient_clipping=1.0), "gradient_clipping needs globally-averaged"),
    (dict(zero_optimization={"stage": 0, "zero_quantized_gradients": True}),
     "mutually exclusive"),
])
def test_jax_refusals(tree, extra, match):
    model = LlamaForCausalLM(llama_config("llama-tiny"))
    with pytest.raises(DeepSpeedConfigError, match=match):
        deepspeed_tpu_torch.initialize(model=model, model_parameters=tree, device="cpu",
                                       config=wire_config("adam", **extra))
    jax_model = JaxLlama(jax_llama_config("llama-tiny", dtype=jnp.float32))
    with pytest.raises(JaxConfigError, match=match):
        deepspeed_tpu.initialize(model=jax_model, model_parameters=tree,
                                 config=wire_config("adam", **extra),
                                 loss_fn=jax_llama_loss_fn(jax_model),
                                 topology=JaxTopology(dp=1, devices=jax.devices()[:1]))


def test_moe_refusal():
    from deepspeed_tpu_torch.models import qwen2_moe
    model = qwen2_moe.Qwen2MoeForCausalLM(qwen2_moe.qwen2_moe_config("qwen2moe-tiny",
                                                                     dtype=torch.float32))
    groups.reset_topology()
    with pytest.raises(DeepSpeedConfigError, match="MoE expert params"):
        deepspeed_tpu_torch.initialize(model=model, device="cpu", config=wire_config("adam"),
                                       loss_fn=qwen2_moe.qwen2_moe_loss_fn(model))


def test_plain_onebit_adam_matches_jax():
    """`onebit_adam` (OneBitAdam without `comm_backend_name`: gradients
    arrive averaged) against the JAX transform over five steps through its
    freeze at 2, one leaf 2-D and one 1-D: parameters and error to 1e-6
    (the sign of a near-zero element may flip: none does here)."""
    from deepspeed_tpu.ops import optimizers as jax_opt
    from deepspeed_tpu_torch.ops import optimizers
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}
    mine = optimizers.onebit_adam(weight_decay=0.01, freeze_step=2)
    ref = jax_opt.onebit_adam(weight_decay=0.01, freeze_step=2)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st, jst = mine.init(p), ref.init(jp)
    for _ in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        p, st = mine.update({k: torch.from_numpy(v) for k, v in g.items()}, st, p, LR)
        jp, jst = ref.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp, LR)
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(st.error[k].numpy(), np.asarray(jst.error[k]), rtol=0,
                                   atol=1e-6)


def test_plain_onebit_adam_refused_on_zero_pieces():
    """Without `comm_backend_name`, 1-bit Adam's scale is a whole leaf's
    mean, which a rank's ZeRO pieces do not hold."""
    groups.initialize(groups.MeshTopology(dp=2, world_size=2, rank=0))
    try:
        config = dict(BASE, optimizer={"type": "OneBitAdam", "params": {"lr": LR}},
                      zero_optimization={"stage": 1})
        with pytest.raises(NotImplementedError, match="Training: the rest"):
            deepspeed_tpu_torch.initialize(model=LlamaForCausalLM(llama_config("llama-tiny")),
                                           device="cpu", config=config)
    finally:
        groups.reset_topology()
