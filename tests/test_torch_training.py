"""The port's training units held against the JAX package's on the CPU.

Losses, lr schedules, the fused Adam update, the loss scaler, gradient
norms and clipping, the dataloader and the config's batch triangulation get
the same numpy inputs in both packages and must agree to 1e-6 (the JAX side
computes in f32; the port's schedules and scaler run in Python floats).
The ZeRO pieces in one process: the norm over whole leaves and a rank's
pieces (every collective the identity) against the JAX norm of the whole
tree, the flat layout of `ZeroUnit` (pieces, padding, the reduce-scatter
input and the gather's output) at dp = 2 and 3, and the ZeRO config keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import common as jax_common
from deepspeed_tpu.ops import optimizers as jax_opt
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import precision as jax_precision
from deepspeed_tpu.runtime.config import (
    DeepSpeedConfig as JaxConfig,
    DeepSpeedConfigError as JaxConfigError,
)
from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JaxLoader
from deepspeed_tpu_torch.models import common
from deepspeed_tpu_torch.ops import optimizers
from deepspeed_tpu_torch.runtime import lr_schedules, precision
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError, FP16Config
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader

TOL = 1e-6


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_and_shift_labels_match_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 11))).astype(np.float32)
    ids = rng.integers(0, 11, (2, 7))
    labels = common.shift_labels(torch.from_numpy(ids))
    np.testing.assert_array_equal(labels.numpy(),
                                  np.asarray(jax_common.shift_labels(jnp.asarray(ids))))
    labels[0, 2] = common.IGNORE_INDEX  # an ignored position inside the row
    got = common.cross_entropy_loss(torch.from_numpy(logits), labels, z_loss=z_loss)
    ref = jax_common.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels.numpy()),
                                        z_loss=z_loss)
    np.testing.assert_allclose(float(got), float(ref), rtol=TOL)
    np.testing.assert_allclose(
        float(common.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(ids))),
        float(jax_common.causal_lm_loss(jnp.asarray(logits), jnp.asarray(ids))), rtol=TOL)


SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2, warmup_num_steps=7)),
    ("WarmupLR", dict(warmup_max_lr=1e-2, warmup_num_steps=7, warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=20, warmup_max_lr=1e-2, warmup_num_steps=5)),
    ("WarmupCosineLR", dict(total_num_steps=20, warmup_num_steps=5, warmup_min_ratio=0.1)),
    ("LRRangeTest", dict(lr_range_test_step_size=4, lr_range_test_staircase=True)),
    ("LRRangeTest", dict(lr_range_test_step_size=4, lr_range_test_step_rate=0.5)),
    ("OneCycle", dict(cycle_first_step_size=5, cycle_second_step_size=4,
                      decay_step_size=3, decay_lr_rate=0.1)),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedules_match_jax(name, params):
    port = lr_schedules.build_lr_schedule(name, params, 3e-3)
    ref = jax_lr.build_lr_schedule(name, params, 3e-3)
    got = [port(s) for s in range(25)]
    want = [float(ref(s)) for s in range(25)]
    # the JAX schedules run in f32: near the end of the cosine the f32
    # rounding is 1e-6 of the peak lr rather than of the value
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(want))
    sched = lr_schedules.LRScheduler(port, 3e-3)
    sched.step(3)
    assert sched.get_lr() == [port(3)] and sched.state_dict() == {"last_step": 3}
    assert lr_schedules.build_lr_schedule(None, {}, 3e-3)(9) == 3e-3
    with pytest.raises(ValueError):
        lr_schedules.build_lr_schedule("Cyclic", {}, 1e-3)


@pytest.mark.parametrize("adam_w_mode,weight_decay,bias_correction",
                         [(True, 0.0, True), (True, 0.1, True), (False, 0.1, True),
                          (True, 0.1, False)])
def test_fused_adam_matches_jax(adam_w_mode, weight_decay, bias_correction):
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    kw = dict(betas=(0.9, 0.95), eps=1e-6, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    jt, pt = jax_opt.fused_adam(**kw), optimizers.fused_adam(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jt.init(jp), pt.init(tp)
    for step, g in enumerate(grads):
        lr = 1e-2 * (step + 1)
        jp, js = jt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr)
        tp, ts = pt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, lr)
    assert ts.count == int(js.count) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ts.exp_avg[k].numpy(), np.asarray(js.exp_avg[k]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ts.exp_avg_sq[k].numpy(), np.asarray(js.exp_avg_sq[k]),
                                   rtol=TOL, atol=TOL)


def test_build_optimizer_names_match_jax():
    for name in ("adam", "FusedAdam", "adamw", "cpuadam"):
        _, lr = optimizers.build_optimizer(name, {"lr": 3e-4})
        assert lr == jax_opt.build_optimizer(name, {"lr": 3e-4})[1] == 3e-4
    for name, params in (("onebitadam", {}), ("zerooneadam", {"comm_backend_name": "gloo"}),
                         ("onebitlamb", {"comm_backend_name": "gloo"})):
        _, lr = optimizers.build_optimizer(name, dict(params, lr=3e-4))
        assert lr == jax_opt.build_optimizer(name, dict(params, lr=3e-4))[1] == 3e-4
    for name in ("zerooneadam",):   # 0/1 Adam is its wire: both packages refuse it without
        with pytest.raises(ValueError, match="comm_backend_name"):
            optimizers.build_optimizer(name, {})
        with pytest.raises(ValueError, match="comm_backend_name"):
            jax_opt.build_optimizer(name, {})
    # plain OneBitLamb is LAMB in the JAX package, which the port has not
    for name in ("lamb", "lion", "adagrad", "sgd", "onebitlamb"):
        with pytest.raises(NotImplementedError, match="Training: the rest"):
            optimizers.build_optimizer(name, {})
    with pytest.raises(ValueError):
        optimizers.build_optimizer("nosuch", {})


def _scalers(**fp16):
    cfg = dict(enabled=True, **fp16)
    from deepspeed_tpu.runtime.config import FP16Config as JaxFP16
    return precision.LossScaler(FP16Config(**cfg)), jax_precision.LossScaler(JaxFP16(**cfg))


def _same_state(port, jax_state):
    assert (port.scale, port.good_steps, port.hysteresis, port.overflows,
            port.window_overflow, port.good_micros) == \
        (float(jax_state.scale), int(jax_state.good_steps), int(jax_state.hysteresis),
         int(jax_state.overflows), int(jax_state.window_overflow),
         int(jax_state.good_micros))


@pytest.mark.parametrize("fp16", [
    dict(initial_scale_power=4, loss_scale_window=3, hysteresis=2),
    dict(initial_scale_power=4, loss_scale_window=2, hysteresis=3,
         consecutive_hysteresis=True, min_loss_scale=4.0),
    dict(loss_scale=128.0),
])
def test_loss_scaler_sequences_match_jax(fp16):
    """A sequence of micro overflows and step updates, with hysteresis,
    growth windows, the minimum scale and a static scale."""
    port, ref = _scalers(**fp16)
    ps, js = port.init_state(), ref.init_state()
    _same_state(ps, js)
    pattern = [0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0]
    for i, ovf in enumerate(pattern):
        ps = port.track_micro(ps, bool(ovf))
        js = ref.track_micro(js, jnp.asarray(bool(ovf)))
        _same_state(ps, js)
        skipped = bool(ovf) and i % 3 != 0   # 'skipped' differs from 'overflow' at times
        ps = port.update(ps, bool(ovf), skipped=skipped)
        js = ref.update(js, jnp.asarray(bool(ovf)), skipped=jnp.asarray(skipped))
        _same_state(ps, js)
    loss = torch.tensor(2.5)
    assert float(port.scale_loss(loss, ps)) == float(ref.scale_loss(jnp.asarray(2.5), js))
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert port.check_overflow(grads) and not port.check_overflow(grads[:1])


def test_grad_norm_and_clipping_match_jax():
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32)}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    norm = precision.global_grad_norm(tg.values())
    np.testing.assert_allclose(float(norm), float(jax_precision.global_grad_norm(jg)), rtol=TOL)
    for max_norm in (0.5, 100.0):   # clipped, and left alone
        got, gn = precision.clip_grads_by_global_norm(tg, max_norm)
        ref, rn = jax_precision.clip_grads_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(gn), float(rn), rtol=TOL)
        for k in grads:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=TOL, atol=TOL)
    cast = precision.cast_tree({"w": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)},
                               torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32


TRIANGULATION = [
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=4),
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=2),
    dict(train_batch_size=8, gradient_accumulation_steps=2),
    dict(train_batch_size=6),
    dict(train_micro_batch_size_per_gpu=3, gradient_accumulation_steps=2),
    dict(train_micro_batch_size_per_gpu=3, train_batch_size="auto"),
]
TRIANGULATION_ERRORS = [
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=3),
    dict(train_batch_size=7, train_micro_batch_size_per_gpu=2),
    dict(train_batch_size=7, gradient_accumulation_steps=2),
    dict(gradient_accumulation_steps=2),
    dict(train_batch_size=4, fp16={"enabled": True}, bf16={"enabled": True}),
    dict(train_batch_size=4, fp16={"enabled": True, "loss_scale": 8.0,
                                   "per_micro_overflow_skip": True}),
]


@pytest.mark.parametrize("cfg", TRIANGULATION)
def test_config_triangulation_matches_jax(cfg):
    port, ref = DeepSpeedConfig(cfg), JaxConfig(cfg, world_size=1)
    assert (port.train_batch_size, port.train_micro_batch_size_per_gpu,
            port.gradient_accumulation_steps) == \
        (ref.train_batch_size, ref.train_micro_batch_size_per_gpu,
         ref.gradient_accumulation_steps)


@pytest.mark.parametrize("cfg", TRIANGULATION_ERRORS)
def test_config_errors_match_jax(cfg):
    with pytest.raises(JaxConfigError):
        JaxConfig(cfg, world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(cfg)


def test_config_fields_match_jax():
    cfg = {"train_batch_size": 4, "bf16": {"enabled": True}, "gradient_clipping": 0.5,
           "seed": 7, "zero_optimization": {"stage": 3, "overlap_comm": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 2e-4}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3}}}
    port, ref = DeepSpeedConfig(cfg), JaxConfig(cfg, world_size=1)
    assert port.model_dtype == torch.bfloat16 and ref.model_dtype == jnp.bfloat16
    assert (port.gradient_clipping, port.seed, port.zero_optimization_stage,
            port.optimizer.type, port.optimizer.params, port.scheduler.type) == \
        (ref.gradient_clipping, ref.seed, ref.zero_optimization_stage,
         ref.optimizer.type, ref.optimizer.params, ref.scheduler.type)
    assert DeepSpeedConfig({"train_batch_size": 2, "fp16": {"enabled": True}}).model_dtype \
        == torch.float16
    assert DeepSpeedConfig({"train_batch_size": 2}).model_dtype == torch.float32


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_matches_jax(drop_last):
    data = {"input_ids": np.arange(70).reshape(10, 7), "labels": np.arange(10)}
    port = DeepSpeedDataLoader(data, batch_size=4, drop_last=drop_last, seed=3)
    ref = JaxLoader(data, batch_size=4, drop_last=drop_last, seed=3)
    assert len(port) == len(ref)
    for _ in range(2):   # two epochs, reshuffled
        for a, b in zip(port, ref):
            for k in data:
                np.testing.assert_array_equal(a[k], b[k])
    rows = [np.full(3, i) for i in range(5)]
    it = RepeatingLoader(DeepSpeedDataLoader(rows, batch_size=2, shuffle=False))
    got = [next(it) for _ in range(3)]
    np.testing.assert_array_equal(got[2], got[0])


def test_grad_norm_over_pieces_matches_jax():
    """In one process the pieces' all-reduce is the identity: whole leaves
    and every piece of the sharded ones give the whole tree's norm."""
    rng = np.random.default_rng(4)
    grads = {"a": rng.standard_normal((4, 6)).astype(np.float32),
             "b": rng.standard_normal(9).astype(np.float32)}
    pieces = list(torch.from_numpy(grads["a"]).reshape(-1).chunk(3))
    norm = precision.global_grad_norm([torch.from_numpy(grads["b"])], pieces)
    ref = jax_precision.global_grad_norm({k: jnp.asarray(v) for k, v in grads.items()})
    np.testing.assert_allclose(float(norm), float(ref), rtol=TOL)
    grads_inf = [torch.ones(2), torch.tensor([float("inf")])]
    assert precision.LossScaler.check_overflow(grads_inf, group="data")
    assert not precision.LossScaler.check_overflow(grads_inf[:1], group="data")


@pytest.mark.parametrize("dp", [2, 3])
def test_zero_unit_flat_layout(dp):
    """Leaf i's piece r is its JAX chunk r: the leaf cut along the dim the
    JAX plan shards (`add_axes_to_spec`), that dim moved to the front and
    flattened row-major. Each rank's `piece_of` is tile r of `pack`, its
    `views` are its chunks, `unpack` of the tiles in rank order gives the
    leaves back, and `whole_leaf` rebuilds a leaf from the flat,
    zero-padded pieces of a checkpoint written before the chunk layout."""
    from deepspeed_tpu.runtime.zero.partition import add_axes_to_spec
    from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
    from deepspeed_tpu_torch.runtime.zero.partition import (ZeroShardingPlan, ZeroUnit,
                                                             whole_leaf)
    rng = np.random.default_rng(5)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((4, 6), (6,), (3, 12, 5), (2, 3))]
    plan = ZeroShardingPlan(dp, DeepSpeedZeroConfig.from_dict({"stage": 1}))
    orders = [(tuple(range(t.dim())), plan.chunk_dim(t.shape)) for t in leaves]
    units = [ZeroUnit(["a", "b", "c", "d"], [t.shape for t in leaves], dp, r, orders)
             for r in range(dp)]
    u = units[0]
    assert u.pieces == [t.numel() // dp for t in leaves] and u.size == sum(u.pieces)
    packed = u.pack(leaves, torch.float32, "cpu").view(dp, u.size)
    tiles = [units[r].piece_of(leaves) for r in range(dp)]
    for r in range(dp):
        torch.testing.assert_close(tiles[r], packed[r], rtol=0, atol=0)
        views = units[r].views(tiles[r])
        for name, t in zip("abcd", leaves):
            spec = add_axes_to_spec(None, tuple(t.shape), ("data",), {"data": dp})
            d = next(i for i, e in enumerate(spec) if e is not None)
            np.testing.assert_array_equal(views[name].numpy(),
                                          np.moveaxis(t.numpy(), d, 0).reshape(dp, -1)[r])
    for got, t in zip(u.unpack(torch.cat(tiles)), leaves):
        torch.testing.assert_close(got, t, rtol=0, atol=0)
        assert got.is_contiguous()          # the card's kernels take no strided operand
    assert u.pack([None] * 4, torch.bfloat16, "cpu").abs().sum() == 0
    for t in leaves + [torch.arange(7.0), torch.ones(1)]:
        p = -(-t.numel() // dp)
        flat = torch.cat([t.reshape(-1), t.new_zeros(p * dp - t.numel())])
        torch.testing.assert_close(whole_leaf(list(flat.view(dp, p)), t.shape, None), t,
                                   rtol=0, atol=0)


def test_zero_config_keys_match_jax():
    from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JaxZeroConfig
    from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
    for block in ({"stage": 3}, {"stage": 3, "stage3_param_persistence_threshold": 500},
                  {"stage": 1, "stage3_param_persistence_threshold": 0}):
        got, ref = DeepSpeedZeroConfig.from_dict(block), JaxZeroConfig(**block)
        assert (got.stage, got.param_persistence_threshold) == \
            (ref.stage, ref.param_persistence_threshold)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedZeroConfig.from_dict({"stage": 3, "stage3_param_persistence_threshold": -1})
