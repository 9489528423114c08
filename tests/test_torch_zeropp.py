"""The port's ZeRO++ (qgZ, qwZ) and MiCS/hpZ held against the JAX package
on the CPU.

The quantized collectives run on two gloo ranks (`tests/torch_dp_ranks.py`,
spawned through `tests/torch_tp_ranks.py:spawn`) and on the JAX side inside
`jax.shard_map` over two devices of the virtual CPU mesh, as
`tests/unit/runtime/zero/test_zeropp.py` runs them: the int8 values and
scales are equal bit for bit (the division form of the scale, which the
JAX quantizer takes when it runs eagerly, in `shard_map` or not; under
`jit` XLA takes amax times f32(1/127), the port's `reciprocal=True`, which
the engine passes because the JAX train step is compiled), and the reduced
and gathered values agree to 1e-6 (both sides compiled or reciprocal), on 1-D, 2-D and 3-D inputs, with blocks of
256 and smaller ones where 256 does not divide a chunk.

The engine: a tiny Llama widened so that every stage-3 leaf's extent
behind its chunk dim is a multiple of the 256-element block (hidden 256,
four heads of 64 and four KV heads, intermediate 512, vocab 512, two
layers), in f32 with FusedAdam, weight decay, WarmupLR and clipping 1.0,
micro-batch 2 a rank and GAS 2, persistence threshold 1000, attention on
its reference path on both sides. At dp = 2 it trains with qgZ at stages
1, 2 and 3 and with qgZ and qwZ at stage 3 against the JAX engine under
the same ZeRO++ config on `MeshTopology(dp=2)`, whose region is made to
quantize each rank's own gradient (`_rank_local_grad`: as it stands under
JAX 0.9 it quantizes the ranks' summed gradient and returns dp times the
mean, which `test_jax_zeropp_region_sums_the_ranks_gradients` shows; the
port runs the documented algorithm). After the first step every
weight agrees to 1e-5 but for a share of at most 1e-3 of the elements
(printed): an element whose gradient lies within an int8 step of a
rounding boundary in one package and across it in the other gets a
different int8 value, and Adam turns that into a different first update
only where the gradient is near zero, where the update's sign can flip;
each such element's gradient (the port's, accumulated before the step) is
held within two int8 steps of its block of zero and its weight within
2 lr of JAX's. Over three steps the losses agree to LOSS_RTOL = 1e-4
relative: the differing first-step weights (a share of at most 1e-3, each
at most 2 lr = 2e-2 away) move the loss by far less, and the later steps'
gradients differ by more than 1e-7, so later flips are more frequent but
stay as small. MiCS at `mics_shard_size = 2` on four ranks (`repl` 2 x
`data` 2), stage 3 without quantization, agrees with the JAX engine on
`MeshTopology(mics_shard_size=2)` to 1e-5 (the final weights to 1e-5 plus
the JAX engine's own distance between its MiCS and flat meshes), its
`repl` peers hold equal
pieces bit for bit, and hpZ (`zero_hpz_partition_size = 2`) gives the
same run bit for bit. A MiCS save loads at dp = 1 (this process) and at
flat dp = 2 and takes the next step as the MiCS run does. Refusals:
`mics_shard_size = 3` on four ranks, the MoE families under ZeRO++ or
MiCS, and other axes beside `repl`.
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
    materialize_params,
)
from deepspeed_tpu.ops.quantization import quantize_int8_blockwise as jax_quantize  # noqa: E402
from deepspeed_tpu.runtime.comm import coalesced_collectives as jax_cc  # noqa: E402
from deepspeed_tpu.runtime.zero.partition import add_axes_to_spec  # noqa: E402
from deepspeed_tpu.utils.groups import MeshTopology as JaxTopology  # noqa: E402
from deepspeed_tpu_torch.models.llama import (  # noqa: E402
    LlamaForCausalLM,
    llama_config,
    llama_loss_fn,
)
from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc  # noqa: E402
from deepspeed_tpu_torch.utils import groups  # noqa: E402
from tests import torch_dp_ranks as dp_ranks  # noqa: E402
from tests import torch_tp_ranks as ranks  # noqa: E402

TOL = 1e-5
FLIP_SHARE = 1e-3
LOSS_RTOL = 1e-4
SEQ = 32
STEPS = 3
LR = 1e-2
WIDE = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_attention_heads=4,
            num_key_value_heads=4)
CONFIG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "FusedAdam", "params": {"lr": LR, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-3,
                                                       "warmup_max_lr": LR,
                                                       "warmup_num_steps": 4}},
          "gradient_clipping": 1.0}
# (stage, qgZ, qwZ)
ZEROPP = {"qg1": (1, True, False), "qg2": (2, True, False), "qg3": (3, True, False),
          "qgqw3": (3, True, True)}
# (x's shape, scatter dim): chunks in blocks of 256, and of 240, 126 and 200
# elements (256 divides none of those chunks)
CASES = [((1024,), 0), ((64, 300), 1), ((4, 7, 9), 0), ((6, 20, 10), 2)]


def zero_config(stage, **zero):
    return dict(CONFIG, zero_optimization=dict(
        {"stage": stage, "stage3_param_persistence_threshold": 1000}, **zero))


def zeropp_config(name):
    stage, qg, qw = ZEROPP[name]
    return zero_config(stage, zero_quantized_gradients=qg, zero_quantized_weights=qw)


def mics_config(**zero):
    return dict(zero_config(3, **zero), train_micro_batch_size_per_gpu=1)


def wide_tree(seed=0):
    _, params = materialize_params(jax_llama_config("llama-tiny", dtype=jnp.float32, **WIDE))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if "norm" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def global_batches(rows=8, seed=1, steps=STEPS):
    ids = np.random.default_rng(seed).integers(0, WIDE["vocab_size"], (steps, rows, SEQ))
    return [{"input_ids": b} for b in ids]


def case_inputs(seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2,) + shape).astype(np.float32), dim) for shape, dim in CASES]


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
    return wide_tree()


@pytest.fixture(scope="module")
def rank_runs(tree, tmp_path_factory, _manual_region_constraints):
    """Both spawns, started at once, then the JAX references computed
    while the ranks run: four ranks with the MiCS and hpZ runs (stage 3,
    `repl` 2 x `data` 2), the MiCS run saving after its second step; two
    ranks with the collectives, the ZeRO++ runs, and the MiCS save loaded
    at flat dp = 2 for its third step (once the four ranks have written
    it). Returns the save's path and each spawn's wait."""
    tmp = tmp_path_factory.mktemp("zeropp")
    save = str(tmp / "save")
    mics_runs = {"mics": ("train", (mics_config(mics_shard_size=2), global_batches(),
                                    {**WIDE}, save, 1)),
                 "hpz": ("train", (mics_config(zero_hpz_partition_size=2), global_batches(),
                                   {**WIDE}))}
    port_runs = {"collectives": ("collectives", (case_inputs(),))}
    for name in ZEROPP:
        port_runs[name] = ("train", (zeropp_config(name), global_batches(), {**WIDE}, None,
                                     None, True))
    port_runs["mics_at_dp2"] = ("resume", (zero_config(3, train_micro_batch_size_per_gpu=2),
                                           global_batches()[2:], {**WIDE}, save, 300.0))
    waits = dict(save=save,
                 mics=ranks.start(dp_ranks.zeropp_scenarios, tree, mics_runs,
                                  tmp_path=tmp / "mics", world=4),
                 port=ranks.start(dp_ranks.zeropp_scenarios, tree, port_runs,
                                  tmp_path=tmp / "port"))

    def join():                     # no rank outlives the module
        for wait in (waits["mics"], waits["port"]):
            try:
                wait()
            except RuntimeError:
                pass
    try:
        jax_chunks(False), jax_chunks(True), jax_collectives()
        for name in list(ZEROPP) + ["stage3", "mics"]:
            jax_run(name)
        jax_run("qg1", 1, False)
    except BaseException:
        join()
        raise
    yield waits
    join()


@pytest.fixture(scope="module")
def mics(rank_runs):
    return dict(ranks=rank_runs["mics"](), save=rank_runs["save"])


@pytest.fixture(scope="module")
def port(rank_runs):
    return rank_runs["port"]()


def jax_engine(tree, config, topology):
    model = JaxLlama(jax_llama_config("llama-tiny", dtype=jnp.float32, **WIDE))
    engine, *_ = deepspeed_tpu.initialize(model=model, model_parameters=tree, config=config,
                                          loss_fn=jax_llama_loss_fn(model), topology=topology)
    return engine


def _rank_local_grad(grad):
    """`jax.grad` whose argument is marked varying over the manual axes
    inside a `shard_map` region, as the JAX engine's 1-bit wire region
    marks its parameters. Its ZeRO++ region does not: JAX 0.9 then sums the
    ranks' gradients of the replicated parameters in the transpose, so the
    quantized reduce-scatter quantizes that sum (the same on every rank)
    and its mean is dp times the gradient
    (`test_jax_zeropp_region_sums_the_ranks_gradients`). With the mark the
    region runs its documented algorithm: each rank quantizes its own
    gradient, and the reduce-scatter takes their mean."""
    from jax.sharding import AxisType

    def wrapped(fn, *args, **kwargs):
        g = grad(fn, *args, **kwargs)

        def run(params, *rest):
            mesh = jax.sharding.get_abstract_mesh()
            if mesh is not None and not mesh.empty and AxisType.Manual in mesh.axis_types:
                manual = [a for a, t in zip(mesh.axis_names, mesh.axis_types)
                          if t == AxisType.Manual]

                def vary(x):
                    axes = tuple(a for a in manual if a not in jax.typeof(x).vma)
                    return jax.lax.pcast(x, axes, to="varying") if axes else x
                params = jax.tree_util.tree_map(vary, params)
            return g(params, *rest)
        return run
    return wrapped


@functools.lru_cache(maxsize=None)
def jax_run(name, steps=STEPS, rank_local=True):
    """The JAX engine's steps and its parameters after the first step and
    at the end, under a ZeRO++ config at dp = 2 (with each rank's own
    gradient quantized, `_rank_local_grad`, unless `rank_local` is off),
    without it ("stage3"), or MiCS on four devices."""
    if name == "mics":
        config, topo = mics_config(mics_shard_size=2), JaxTopology(
            mics_shard_size=2, devices=jax.devices()[:4])
    else:
        config = zero_config(3) if name == "stage3" else zeropp_config(name)
        topo = JaxTopology(dp=2, devices=jax.devices()[:2])
    with pytest.MonkeyPatch.context() as mp:
        if rank_local:
            mp.setattr(jax, "grad", _rank_local_grad(jax.grad))
        engine = jax_engine(wide_tree(), config, topo)
        out, first = [], None
        for batch in global_batches()[:steps]:
            loss = engine.train_batch(batch=batch)
            out.append((float(loss), engine.get_global_grad_norm()))
            if first is None:
                first = jax.device_get(engine.state.params)
    return out, first, jax.device_get(engine.state.params), topo


# ---------------------------------------------------------------- collectives

def _jax_region(fn, xs):
    """`fn` over every case's input at once in one `shard_map` (one trace
    for all the cases), each input split over two devices along dim 0."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    specs = tuple(P("data") for _ in xs)
    return jax.shard_map(fn, mesh=mesh, in_specs=specs, out_specs=P("data"))(
        *[jnp.asarray(x) for x in xs])


@functools.lru_cache(maxsize=None)
def jax_chunks(compiled):
    """Each case's two ranks' chunks quantized by the JAX quantizer, as its
    reduce-scatter chunks them: [(q, scales) a case]. Compiled: inside a
    jitted `shard_map` (amax · f32(1/127)); eager: the same quantizer op by
    op, the division form, which `shard_map` run eagerly also takes."""
    cases = case_inputs()

    def chunks(x, dim):
        moved = jnp.moveaxis(x, dim, 0)
        xr = moved.reshape(2, moved.shape[0] // 2, *moved.shape[1:])
        qs = [jax_quantize(xr[i], 256) for i in range(2)]
        return jnp.stack([q.reshape(-1) for q, _ in qs]), jnp.stack([s for _, s in qs])
    if not compiled:
        return [tuple(np.stack(t) for t in zip(*(chunks(jnp.asarray(x[r]), dim)
                                                   for r in range(2))))
                for x, dim in cases]

    def region(*xs):
        return [tuple(t[None] for t in chunks(xl[0], dim)) for xl, (_, dim) in zip(xs, cases)]
    return jax.jit(functools.partial(_jax_region, region))([x for x, _ in cases])


@functools.lru_cache(maxsize=None)
def jax_collectives():
    """Each case's reduce-scatter and all-gather by the JAX functions in
    one jitted `shard_map` (so the reciprocal scale form, which the ranks
    take too), with the bytes they record: [(rs, ag, {kind: bytes})]."""
    import deepspeed_tpu.comm.comms_logging as logging_mod
    cases, recorded = case_inputs(), []

    class Logger:
        def record(self, op, nbytes):
            recorded.append((op, nbytes))

    def region(*xs):
        return [(jax_cc.quantized_reduce_scatter(xl[0], "data", dim)[None],
                 jax_cc.quantized_all_gather(xl[0], "data", dim)[None])
                for xl, (_, dim) in zip(xs, cases)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logging_mod, "get_comms_logger", lambda: Logger())
        out = jax.jit(functools.partial(_jax_region, region))([x for x, _ in cases])
    return [(rs, ag, dict(recorded[2 * i:2 * i + 2])) for i, (rs, ag) in enumerate(out)]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("compiled", [False, True])
def test_quantized_chunks_are_jax_bit_for_bit(case, compiled):
    """Each rank's p chunks quantized as the JAX reduce-scatter quantizes
    them: the int8 values and scales bit for bit, in the division form
    beside an eager `shard_map` and in the reciprocal form beside a
    compiled one."""
    x, dim = case_inputs()[case]
    q, s = jax_chunks(compiled)[case]
    for r in range(2):
        moved = torch.from_numpy(x[r]).movedim(dim, 0)
        got_q, got_s = cc.quantize_rows(moved.reshape(2, -1), 256, reciprocal=compiled)
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(q[r]))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(s[r]))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_quantized_collectives_match_jax(port, case):
    """The reduce-scatter and the all-gather on two ranks against the JAX
    functions in a compiled `shard_map`, in the reciprocal form on both
    sides: values to 1e-6, and the bytes counted as the JAX package records
    them (`_record_quantized_wire`)."""
    x, dim = case_inputs()[case]
    rs, ag, want_bytes = jax_collectives()[case]
    for r, got in enumerate(port):
        got = got["collectives"][case]
        np.testing.assert_allclose(got["rs"].numpy(), np.asarray(rs[r]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["ag"].numpy(), np.asarray(ag[r]), rtol=0, atol=1e-6)
        stats = got["stats"]
        assert set(stats) == {"quantized_reduce_scatter", "quantized_all_gather"}
        for kind, want in want_bytes.items():
            assert stats[kind]["bytes"] == want and stats[kind]["calls"] == 1, (kind, stats)
    n = x[0].size
    b = cc.block_size(n // 2)
    assert want_bytes["quantized_reduce_scatter"] == n + 4 * 2 * (n // 2 // b)


def test_segments_are_the_collectives_one_by_one():
    """One process: `reduce_scatter_segments` and `gather_segments` give
    each segment what the single collectives give it."""
    rng = np.random.default_rng(9)
    segs = [torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32))
            for n in (256, 100, 1000)]
    for seg, got in zip(segs, cc.reduce_scatter_segments(segs)):
        torch.testing.assert_close(got, cc.quantized_reduce_scatter(seg[0]), rtol=0, atol=0)
    for seg, got in zip(segs, cc.gather_segments([s[0] for s in segs])):
        torch.testing.assert_close(got[0], cc.quantized_all_gather(seg[0]), rtol=0, atol=0)
    # the reference's list forms, over one rank
    for seg, got in zip(segs, cc.all_to_all_quant_reduce([s[0] for s in segs])):
        torch.testing.assert_close(got, cc.quantized_reduce_scatter(seg[0]), rtol=0, atol=0)
    for seg, got in zip(segs, cc.reduce_scatter_coalesced([s[0] for s in segs])):
        torch.testing.assert_close(got, seg[0], rtol=0, atol=0)


# ------------------------------------------------------------------ the engine

def _block_steps(tree, dp=2):
    """Each element's int8 step in the JAX package's blocks: its chunk's
    block amax / 127, the chunk cut along `add_axes_to_spec`'s dimension of
    the (stacked) leaf."""
    def leaf(g):
        g = np.abs(np.asarray(g))
        spec = add_axes_to_spec(None, g.shape, ("data",), {"data": dp})
        dim = next(i for i, e in enumerate(spec) if e is not None)
        moved = np.moveaxis(g, dim, 0)
        rows = moved.reshape(dp, -1)
        b = cc.block_size(rows.shape[1])
        amax = rows.reshape(dp, -1, b).max(-1, keepdims=True) / 127.0
        return np.moveaxis(np.broadcast_to(amax, (dp, rows.shape[1] // b, b))
                           .reshape(moved.shape), 0, dim)
    return jax.tree_util.tree_map(leaf, tree)


def _flips(got, want, grads):
    """The elements further than TOL from JAX's, each explained by one int8
    step: (count, total, [(|gradient| / its step, |difference| / lr)])."""
    steps = _block_steps(grads)
    diffs, total, explained = [], 0, []
    for g, w, grad, step in zip(*(jax.tree_util.tree_leaves(t) for t in
                                  (got, want, grads, steps))):
        d = np.abs(np.asarray(g) - np.asarray(w))
        total += d.size
        bad = d > TOL
        diffs.append(int(bad.sum()))
        explained += list(zip(np.abs(np.asarray(grad))[bad] / step[bad], d[bad] / LR))
    return sum(diffs), total, explained


@pytest.mark.parametrize("name", list(ZEROPP))
def test_zeropp_first_step_matches_jax_but_for_flips(port, name):
    _, first, _, _ = jax_run(name)
    for rank, r in enumerate(port):
        n, total, explained = _flips(r[name]["tree1"], first, r[name]["grads"])
        print(f"{name} rank {rank}: {n} of {total} weights beyond {TOL} after one step "
              f"(share {n / total:.2e})")
        assert n <= FLIP_SHARE * total
        for grad_steps, moved in explained:
            assert grad_steps <= 2.0 and moved <= 2.0 * (1 + 1e-3), (grad_steps, moved)
    jax.tree_util.tree_map(np.testing.assert_array_equal, port[0][name]["tree"],
                           port[1][name]["tree"])


@pytest.mark.parametrize("name", list(ZEROPP))
def test_zeropp_three_steps_match_jax(port, name):
    steps, _, final, _ = jax_run(name)
    for r in port:
        np.testing.assert_allclose(np.asarray(r[name]["steps"])[:, 0], np.asarray(steps)[:, 0],
                                   rtol=LOSS_RTOL, atol=0)
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=4 * LR),
            r[name]["tree"], final)


@pytest.mark.parametrize("name", list(ZEROPP))
def test_zeropp_wire_bytes(port, name):
    """qgZ replaces the f32 reduce-scatter by int8 plus a scale a block;
    qwZ stage 3's gathers likewise (the port gathers a block again in its
    recompute only under remat, off here)."""
    stats = port[0][name]["stats"]
    assert "reduce_scatter" not in stats and stats["quantized_reduce_scatter"]["bytes"] > 0
    assert ("quantized_all_gather" in stats) == ZEROPP[name][2]


def test_jax_zeropp_region_sums_the_ranks_gradients(port):
    """The JAX engine's ZeRO++ region as it stands under JAX 0.9: its
    first-step norm is dp = 2 times the plain engine's (stage 3, without
    ZeRO++), and with each rank's own gradient (`_rank_local_grad`) it is
    the plain one's, as is the port's."""
    plain = jax_run("stage3")[0][0][1]
    as_is = jax_run("qg1", 1, False)[0][0][1]
    mine = jax_run("qg1")[0][0][1]
    np.testing.assert_allclose(as_is, 2 * plain, rtol=1e-4)
    np.testing.assert_allclose([mine, port[0]["qg1"]["steps"][0][1]], [plain, plain],
                               rtol=1e-4)


def test_mics_matches_jax(mics):
    """Losses and norms to 1e-5; the weights after the first step and at
    the end to 1e-5 plus the JAX engine's own distance there, per leaf,
    between its MiCS mesh and its flat dp = 2 mesh (up to 1.8e-4 on the
    embedding after three steps: Adam's first steps amplify the reduction
    order's rounding where a gradient nearly cancels)."""
    steps, first, final, topo = jax_run("mics")
    _, flat_first, flat, _ = jax_run("stage3")
    gap = lambda a, b: float(np.abs(a - b).max())
    noise = jax.tree_util.tree_map(gap, final, flat)
    noise1 = jax.tree_util.tree_map(gap, first, flat_first)
    devices = list(jax.devices()[:4])
    got = mics["ranks"]
    for rank, r in enumerate(got):
        where = np.argwhere(np.asarray(topo.mesh.devices) == devices[rank])[0]
        assert tuple(r["mics"]["coords"][a] for a in groups.MESH_AXES) == \
            tuple(int(c) for c in where)
        np.testing.assert_allclose(np.asarray(r["mics"]["steps"]), np.asarray(steps),
                                   rtol=TOL, atol=0)
        jax.tree_util.tree_map(
            lambda g, w, n: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL + n),
            r["mics"]["tree1"], first, noise1)
        jax.tree_util.tree_map(
            lambda g, w, n: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL + n),
            r["mics"]["tree"], final, noise)
    # repl peers (ranks r and r + 2) hold the same pieces; data peers other ones
    for a, b in ((0, 2), (1, 3)):
        for field, tensors in got[a]["mics"]["pieces"].items():
            for k, t in tensors.items():
                torch.testing.assert_close(t, got[b]["mics"]["pieces"][field][k], rtol=0, atol=0)
    assert any(not torch.equal(t, got[1]["mics"]["pieces"]["params"][k])
               for k, t in got[0]["mics"]["pieces"]["params"].items())
    stats = got[0]["mics"]["stats"]
    assert stats["all_gather"]["calls"] > 0 and "quantized_all_gather" not in stats


def test_hpz_is_mics(mics):
    for r in mics["ranks"]:
        assert r["hpz"]["steps"] == r["mics"]["steps"] and r["hpz"]["coords"] == \
            r["mics"]["coords"]
        jax.tree_util.tree_map(np.testing.assert_array_equal, r["hpz"]["tree"],
                               r["mics"]["tree"])


def test_mics_save_loads_at_dp1_and_flat_dp2(tree, mics, port):
    """The MiCS run's save after its second step: a fresh engine at dp = 1
    here and the two flat ranks each take the third step as the MiCS run
    did (1e-5: another reduction order)."""
    want = mics["ranks"][0]["mics"]
    groups.reset_topology()
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **WIDE))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=tree, device="cpu", loss_fn=llama_loss_fn(model),
        config=zero_config(3, train_micro_batch_size_per_gpu=4))
    engine.load_checkpoint(mics["save"])
    loss = float(engine.train_batch(batch=global_batches()[2]))
    np.testing.assert_allclose([loss, engine.get_global_grad_norm()], want["steps"][2],
                               rtol=TOL, atol=0)
    for r in port:
        np.testing.assert_allclose(np.asarray(r["mics_at_dp2"]["steps"][0]), want["steps"][2],
                                   rtol=TOL, atol=0)
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=TOL),
            r["mics_at_dp2"]["tree"], want["tree"])


def test_zeropp_refusals():
    with pytest.raises(ValueError, match="not divisible by mics_shard_size=3"):
        groups.MeshTopology(mics_shard_size=3, world_size=4, rank=0)
    with pytest.raises(ValueError, match="not divisible by mics_shard_size=3"):
        JaxTopology(mics_shard_size=3, devices=jax.devices()[:4])
    for kw in (dict(tp=2, repl=2), dict(ep=2, mics_shard_size=1)):
        with pytest.raises(NotImplementedError, match="Multi-GPU"):
            groups.MeshTopology(world_size=4, rank=0, **kw)
    from deepspeed_tpu_torch.models import mixtral, qwen2_moe
    families = [lambda: qwen2_moe.Qwen2MoeForCausalLM(qwen2_moe.qwen2_moe_config(
        "qwen2moe-tiny", dtype=torch.float32)),
        lambda: mixtral.MixtralForCausalLM(mixtral.mixtral_config("mixtral-tiny",
                                                                  dtype=torch.float32))]
    for topo, zero in ((dict(dp=2, world_size=2), dict(zero_quantized_gradients=True)),
                       (dict(mics_shard_size=2, world_size=4), {})):
        groups.initialize(groups.MeshTopology(rank=0, **topo))
        try:
            for family in families:
                with pytest.raises(NotImplementedError, match="ZeRO\\+\\+/MiCS.*Multi-GPU"):
                    deepspeed_tpu_torch.initialize(
                        model=family(), device="cpu",
                        config=dict(CONFIG, zero_optimization=dict(stage=2, **zero)))
        finally:
            groups.reset_topology()


@pytest.mark.parametrize("dp", [2, 4])
def test_zero_unit_chunk_layout(dp):
    """A sharded leaf's piece r is the JAX chunk r of its layer's flax
    leaf (the chunk dim in front, flattened row-major): each
    rank's `piece_of` is tile r of `pack`, `unpack` gives the leaves back,
    `flat_piece` and `whole_leaf` cut and rebuild a leaf in that order,
    and the layout record carries it."""
    from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
    from deepspeed_tpu_torch.runtime.zero.partition import (
        ZeroShardingPlan, ZeroUnit, flat_piece, jax_leaf_shape, layout_record, model_units,
        record_order, whole_leaf)
    from deepspeed_tpu_torch.models.llama import to_jax_params
    model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32, **WIDE))
    tree = to_jax_params(model)
    plan = ZeroShardingPlan(dp, DeepSpeedZeroConfig.from_dict(
        {"stage": 3, "zero_quantized_gradients": True,
         "stage3_param_persistence_threshold": 1000}))
    params = dict(model.named_parameters())
    names = [n for n in params if plan.shards(jax_leaf_shape(model, n), "master")]
    orders = [plan.order(model, n) for n in names]
    leaves = [params[n].detach() for n in names]
    units = [ZeroUnit(names, [t.shape for t in leaves], dp, r, orders=orders)
             for r in range(dp)]
    tiles = [u.piece_of(leaves) for u in units]
    packed = units[0].pack(leaves, torch.float32, "cpu").view(dp, -1)
    for r in range(dp):
        torch.testing.assert_close(tiles[r], packed[r], rtol=0, atol=0)
    for got, t in zip(units[0].unpack(torch.cat(tiles)), leaves):
        torch.testing.assert_close(got, t, rtol=0, atol=0)
        assert got.is_contiguous()
    flat_jax = {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    for n, t, order in zip(names, leaves, orders):
        pieces = [flat_piece(t, dp, r, order) for r in range(dp)]
        torch.testing.assert_close(whole_leaf(pieces, t.shape, order), t, rtol=0, atol=0)
        assert sum(p.numel() for p in pieces) == t.numel()      # no padding
        shape = jax_leaf_shape(model, n)
        d = order[1] + (1 if n.startswith("layers.") else 0)
        spec = add_axes_to_spec(None, shape, ("data",), {"data": dp})
        assert spec[d] == "data", (n, spec, d)
        if n.startswith("layers."):                 # this layer of the stacked JAX leaf
            continue
        key = next(k for k in flat_jax if np.asarray(flat_jax[k]).shape == tuple(shape)
                   and np.array_equal(flat_jax[k].reshape(-1)[:4],
                                      np.asarray(t.permute(order[0])).reshape(-1)[:4]))
        chunks = np.moveaxis(flat_jax[key], d, 0).reshape(dp, -1)
        for r in range(dp):
            np.testing.assert_array_equal(pieces[r].numpy(), chunks[r])
    plan1 = ZeroShardingPlan(dp, DeepSpeedZeroConfig.from_dict(
        {"stage": 1, "zero_quantized_gradients": True}))
    record = layout_record(model_units(model, plan1, 0), {n: p.shape for n, p in params.items()},
                           dp)
    for n, info in record["leaves"].items():
        assert record_order(info) == (plan1.order(model, n) if info["optim"] else None)
