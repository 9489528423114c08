"""The port's per-shard serving kernels (K8) held against the JAX package's on the CPU.

Each rank of a tp = 2 `model` axis holds its heads' slice of q, the caches
and the pools; the port's `sharded_*` wrappers run the plain versions of
K2/K3/K4 on that slice (a CPU tensor), and every rank's output must match
the same heads of the JAX `sharded_*` wrapper on the virtual CPU mesh
(Pallas interpret mode) and of the unsharded JAX kernel, to 1e-5, with
int8 caches and the staged token included. On this JAX a `pallas_call` in
interpret mode inside `shard_map` fails the region's varying-axes check,
so the JAX wrappers run here with `jax.shard_map(..., check_vma=False)`
(the `jax_shard_map` fixture; the package itself is unchanged). K5 per
shard: 'n' on a column slice and 'k' (the sum of the two ranks' partial
products; one process, so the all-reduce is the identity here) against the
unsharded JAX `quantized_matmul` in interpret mode (ROADMAP.md's reference
caveats: the JAX sharded K5 is no oracle). The
predicates (`decode_heads_shardable`, `tp_shard_flavor`), the logical
axes of every Llama leaf, `shard_tree`'s cut of int8 scales, and
`init_params` on a shard are checked exactly.
"""

import functools
import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.models.llama import init_params_and_specs  # noqa: E402
from deepspeed_tpu.models.llama import llama_config as jax_llama_config  # noqa: E402
from deepspeed_tpu.ops.pallas import sharded as jax_sharded  # noqa: E402
from deepspeed_tpu.ops.pallas.decode_attention import (  # noqa: E402
    decode_attention as jax_decode_attention,
)
from deepspeed_tpu.ops.pallas.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill,
)
from deepspeed_tpu.ops.pallas.quantized_matmul import (  # noqa: E402
    quantized_matmul as jax_quantized_matmul,
    scale_group_width as jax_scale_group_width,
    tp_shard_flavor as jax_tp_shard_flavor,
)
from deepspeed_tpu.ops.quantization import (  # noqa: E402
    dequantize_int8_blockwise as jax_dequantize,
    quantize_int8_blockwise as jax_quantize,
)
from deepspeed_tpu.utils import groups as jax_groups  # noqa: E402
from deepspeed_tpu.utils.groups import MeshTopology as JaxTopology  # noqa: E402
from deepspeed_tpu_torch.models.llama import (  # noqa: E402
    LlamaForCausalLM,
    init_params,
    llama_config,
    module_model_dim,
)
from deepspeed_tpu_torch.ops.cuda import sharded  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.quantized_matmul import (  # noqa: E402
    sharded_quantized_matmul,
    tp_shard_flavor,
)
from deepspeed_tpu_torch.ops.quantization import quantize_int8_blockwise  # noqa: E402
from deepspeed_tpu_torch.utils.groups import MeshTopology  # noqa: E402
from deepspeed_tpu_torch.utils.partitioning import (  # noqa: E402
    model_dim,
    shard_leaf,
    shard_tree,
)

TOL = 1e-5
TP = 2
B, H, HKV, D = 2, 8, 4, 32
NB, BS, T = 8, 8, 4


@pytest.fixture
def jax_shard_map(monkeypatch):
    monkeypatch.setattr(jax, "shard_map", functools.partial(jax.shard_map, check_vma=False))


def _jax_mesh():
    jax_groups.reset_topology()
    return jax_groups.initialize(JaxTopology(tp=TP, devices=jax.devices()[:TP])).mesh


def _t(x):
    return torch.from_numpy(np.array(x, copy=True, order="C"))


def _heads(x, axis, rank):
    """Rank `rank`'s slice of a head axis, contiguous, as a torch tensor."""
    n = x.shape[axis] // TP
    return _t(np.take(np.asarray(x), np.arange(rank * n, (rank + 1) * n), axis=axis))


def _meshes():
    return [MeshTopology(tp=TP, world_size=TP, rank=r, device="cpu") for r in range(TP)]


def _int8(x, axis=-1):
    """int8 values and per-(token, head) f32 scales of x over its last axis."""
    amax = np.abs(x).max(axis=axis)
    scales = np.maximum(amax, 1e-6).astype(np.float32) / 127.0
    return (np.clip(np.round(x / scales[..., None]), -127, 127).astype(np.int8), scales)


def _check(got_per_rank, sharded_ref, ref, axis=2):
    for rank, got in enumerate(got_per_rank):
        for want in (sharded_ref, ref):
            np.testing.assert_allclose(got.numpy(), _heads(want, axis, rank).numpy(),
                                       rtol=TOL, atol=TOL)


# ------------------------------------------------------------ K8-a: K2
@pytest.mark.parametrize("int8", [False, True])
def test_sharded_decode_attention_matches_jax(int8, jax_shard_map):
    rng = np.random.default_rng(1)
    m = 64
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, m, HKV, D)).astype(np.float32)
    vc = rng.standard_normal((B, m, HKV, D)).astype(np.float32)
    lengths = np.asarray([33, 64], np.int32)
    kw_j, scales = {}, None
    if int8:
        (kc, ks), (vc, vs) = _int8(kc), _int8(vc)
        kw_j = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        scales = (ks, vs)
    mesh = _jax_mesh()
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths))
    ref_sharded = jax_sharded.sharded_decode_attention(*args, mesh, block_k=32, **kw_j)
    ref = jax_decode_attention(*args, block_k=32, **kw_j)
    got = []
    for r, topo in enumerate(_meshes()):
        kw = {} if scales is None else dict(k_scales=_heads(scales[0], 2, r),
                                            v_scales=_heads(scales[1], 2, r))
        got.append(sharded.sharded_decode_attention(
            _heads(q, 2, r), _heads(kc, 2, r), _heads(vc, 2, r), _t(lengths), topo,
            heads=(H, HKV), **kw))
    _check(got, ref_sharded, ref)


# ------------------------------------------------------- K8-b/c: K3, K4
def _paged(rng, int8):
    kp = rng.standard_normal((HKV, NB, BS, D)).astype(np.float32)
    vp = rng.standard_normal((HKV, NB, BS, D)).astype(np.float32)
    tables = rng.permutation(NB)[: B * T].reshape(B, T).astype(np.int32)
    if not int8:
        return kp, vp, tables, None
    (kp, ks), (vp, vs) = _int8(kp), _int8(vp)
    return kp, vp, tables, (ks, vs)


@pytest.mark.parametrize("staged,int8", [(False, False), (True, False), (True, True)])
def test_sharded_paged_decode_attention_matches_jax(staged, int8, jax_shard_map):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kp, vp, tables, scales = _paged(rng, int8)
    lengths = np.asarray([17, 32], np.int32)
    kn = rng.standard_normal((B, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((B, HKV, D)).astype(np.float32)
    kw_j = dict(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn)) if staged else {}
    if int8:
        kw_j.update(k_scales=jnp.asarray(scales[0]), v_scales=jnp.asarray(scales[1]))
    mesh = _jax_mesh()
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
            jnp.asarray(lengths))
    ref_sharded = jax_sharded.sharded_paged_decode_attention(*args, mesh, **kw_j)
    ref = jax_paged_decode(*args, **kw_j)
    got = []
    for r, topo in enumerate(_meshes()):
        kw = dict(k_new=_heads(kn, 1, r), v_new=_heads(vn, 1, r)) if staged else {}
        if int8:
            kw.update(k_scales=_heads(scales[0], 0, r), v_scales=_heads(scales[1], 0, r))
        got.append(sharded.sharded_paged_decode_attention(
            _heads(q, 2, r), _heads(kp, 0, r), _heads(vp, 0, r), _t(tables), _t(lengths),
            topo, heads=(H, HKV), **kw))
    _check(got, ref_sharded, ref)


@pytest.mark.parametrize("int8", [False, True])
def test_sharded_paged_prefill_attention_matches_jax(int8, jax_shard_map):
    rng = np.random.default_rng(3)
    s = 8
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    kp, vp, tables, scales = _paged(rng, int8)
    starts = np.asarray([9, 24], np.int32)
    kw_j = {} if not int8 else dict(k_scales=jnp.asarray(scales[0]),
                                    v_scales=jnp.asarray(scales[1]))
    mesh = _jax_mesh()
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
            jnp.asarray(starts))
    ref_sharded = jax_sharded.sharded_paged_prefill_attention(*args, mesh, block_q=8, **kw_j)
    ref = jax_paged_prefill(*args, block_q=8, **kw_j)
    got = []
    for r, topo in enumerate(_meshes()):
        kw = {} if not int8 else dict(k_scales=_heads(scales[0], 0, r),
                                      v_scales=_heads(scales[1], 0, r))
        got.append(sharded.sharded_paged_prefill_attention(
            _heads(q, 2, r), _heads(kp, 0, r), _heads(vp, 0, r), _t(tables), _t(starts),
            topo, heads=(H, HKV), **kw))
    _check(got, ref_sharded, ref)


def test_sharded_attention_rejects_a_wrong_share():
    topo = _meshes()[0]
    q = torch.zeros(B, 1, H // TP, D)
    cache = torch.zeros(B, 16, HKV // TP, D)
    lengths = torch.tensor([3, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="share"):      # the whole heads given
        sharded.sharded_decode_attention(torch.zeros(B, 1, H, D), torch.zeros(B, 16, HKV, D),
                                         torch.zeros(B, 16, HKV, D), lengths, topo,
                                         heads=(H, HKV))
    with pytest.raises(ValueError, match="do not shard"):
        sharded.sharded_decode_attention(q, cache, cache, lengths, topo, heads=(H, 3))
    # a CPU tensor under a topology that serves a card is refused, not run plain
    cuda_topo = MeshTopology(tp=TP, world_size=TP, rank=0, device="cuda")
    with pytest.raises(ValueError, match="card"):
        sharded.sharded_decode_attention(q, cache, cache, lengths, cuda_topo)


# ------------------------------------------------------------ K8-d: K5
@pytest.mark.parametrize("m,k,n,group", [(3, 64, 128, 32), (5, 128, 64, 16),
                                         (4, 64, 96, 16)])
def test_sharded_quantized_matmul_matches_unsharded_jax(m, k, n, group):
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    q, s = jax_quantize(jnp.asarray(w), group)
    ref = np.asarray(jax_quantized_matmul(jnp.asarray(x), q, s))
    q, s = np.asarray(q), np.asarray(s)
    cols = [sharded_quantized_matmul(_t(x), *map(_t, _leaf(q, s, 1, r)), "n")
            for r in range(TP)]
    np.testing.assert_allclose(torch.cat(cols, dim=-1).numpy(), ref, rtol=TOL, atol=TOL)
    rows = [sharded_quantized_matmul(_heads(x, 1, r), *map(_t, _leaf(q, s, 0, r)), "k")
            for r in range(TP)]
    np.testing.assert_allclose((rows[0] + rows[1]).numpy(), ref, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="flavor"):
        sharded_quantized_matmul(_t(x), _t(q), _t(s), "m")


def _leaf(q, s, dim, rank):
    cut = shard_leaf({"__q8__": q, "scales": s}, dim, TP, rank)
    return cut["__q8__"], cut["scales"]


# ------------------------------------------------------------- predicates
def test_predicates_match_jax():
    for h, hkv, tp in [(8, 2, 2), (8, 2, 4), (32, 8, 2), (6, 3, 2), (8, 8, 1), (12, 4, 3)]:
        assert sharded.decode_heads_shardable(h, hkv, tp) == \
            jax_sharded.decode_heads_shardable(h, hkv, tp)
    for k, n, group in [(4096, 4096, 256), (4096, 1024, 256), (4096, 14336, 256),
                        (14336, 4096, 256), (64, 128, 256), (128, 384, 64), (64, 32, 32),
                        (64, 96, 16), (96, 64, 512), (10, 30, 7)]:
        nb = k * n // group if (k * n) % group == 0 else 0
        for tp in (1, 2, 4, 8):
            for prefer in ("n", "k"):
                assert tp_shard_flavor(k, n, nb, tp, prefer) == \
                    jax_tp_shard_flavor(k, n, nb, tp, prefer), (k, n, group, tp, prefer)


def test_logical_axes_match_the_jax_llama_specs():
    cfg = jax_llama_config("llama-tiny", attention_qkv_bias=True, attention_o_bias=True)
    _, specs = init_params_and_specs(cfg)
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        keys = tuple(p.key for p in path)
        want = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        assert model_dim(keys) == (want[0] if want else None), keys


@pytest.mark.parametrize("k,n,group,dim", [
    (64, 128, 32, 1), (64, 128, 32, 0),      # per-row groups: 'n' and 'k'
    (128, 64, 256, 0),                        # a block spans 4 rows: 'k'
    (128, 64, 256, 1),                        # ... cut along its columns
    (4096, 1024, 256, 1)])                   # Llama-3-8B's k_proj
def test_shard_tree_cuts_int8_scales_as_the_jax_wrapper_does(k, n, group, dim):
    rng = np.random.default_rng(k + n + dim)
    w = jnp.asarray((0.05 * rng.standard_normal((k, n))).astype(np.float32))
    q, s = jax_quantize(w, group)
    q, s = np.asarray(q), np.asarray(s)
    whole = np.asarray(jax_dequantize(jnp.asarray(q), jnp.asarray(s)))
    g = jax_scale_group_width(k, n, s.shape[0])
    for r in range(TP):
        q_loc, s_loc = _leaf(q, s, dim, r)
        # what the JAX wrapper's shard_map hands a shard: the (K, N/g) grid's
        # columns for 'n', a flat span for 'k' (whole blocks either way)
        if dim == 1 and group <= n:
            want = np.split(s.reshape(k, n // g), TP, axis=1)[r].reshape(-1)
        elif dim == 1:
            want = s                              # each block keeps its scale
        else:
            want = np.split(s, TP)[r]
        np.testing.assert_array_equal(s_loc, want)
        np.testing.assert_array_equal(
            np.asarray(jax_dequantize(jnp.asarray(q_loc), jnp.asarray(s_loc))),
            np.split(whole, TP, axis=dim)[r])


def test_shard_tree_per_layer_scales_and_quantize_then_cut():
    """Stacked layer leaves with (L, nblocks) scales cut per layer, and a
    shard quantized alone equals the cut of the quantized whole when the
    groups tile the shard's rows."""
    from deepspeed_tpu_torch.inference.quantized_layer_scan import quantize_layer_stacks
    rng = np.random.default_rng(7)
    stack = torch.from_numpy((0.05 * rng.standard_normal((3, 64, 128))).astype(np.float32))
    path = ("layers", "mlp", "gate_proj", "kernel")
    whole = quantize_layer_stacks({"layers": {"mlp": {"gate_proj": {"kernel": stack}}}},
                                  group_size=32)
    for r in range(TP):
        cut = shard_tree(whole, TP, r)["layers"]["mlp"]["gate_proj"]["kernel"]
        alone = quantize_layer_stacks(
            {"layers": {"mlp": {"gate_proj": {"kernel": shard_leaf(stack, 2, TP, r)}}}},
            group_size=32)["layers"]["mlp"]["gate_proj"]["kernel"]
        assert model_dim(path) == 2
        for key in ("__q8__", "scales"):
            torch.testing.assert_close(cut[key], alone[key], rtol=0, atol=0)
        # one layer's flat scales through the grid, as the JAX wrapper cuts them
        q, s = quantize_int8_blockwise(stack[1], 32, reciprocal=True)
        torch.testing.assert_close(cut["scales"][1], s.reshape(64, 4)[:, 2 * r:2 * r + 2]
                                   .reshape(-1), rtol=0, atol=0)


def test_sharded_init_params_are_slices_of_the_whole():
    cfg = llama_config("llama-tiny", dtype=torch.float32, num_attention_heads=8,
                       num_key_value_heads=2)
    whole = init_params(LlamaForCausalLM(cfg), torch.Generator().manual_seed(3))
    full = dict(whole.named_parameters())
    for r in range(TP):
        shard = init_params(LlamaForCausalLM(cfg, tp_size=TP, tp_rank=r),
                            torch.Generator().manual_seed(3))
        for name, p in shard.named_parameters():
            dim = module_model_dim(name)
            want = full[name] if dim is None else full[name].chunk(TP, dim=dim)[r]
            torch.testing.assert_close(p, want, rtol=0, atol=0, msg=name)


def test_layer_scan_refuses_a_cut_the_jax_rule_shards_otherwise():
    """Scale blocks of 128 span two rows of the tiny q_proj (64 x 64): the
    JAX rule shards it row-wise ('k'), against its column cut ('n'), so the
    fused layer scan at tp = 2 refuses the whole tree before cutting it."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils import groups
    assert tp_shard_flavor(64, 64, 32, TP, "n") == jax_tp_shard_flavor(64, 64, 32, TP, "n") \
        == "k"
    cfg = llama_config("llama-tiny", dtype=torch.float32, num_attention_heads=8,
                       num_key_value_heads=2)
    groups.initialize(MeshTopology(tp=TP, world_size=TP, rank=0, device="cpu"))
    try:
        with pytest.raises(ValueError, match="q_proj.* as 'k', not as its 'n' cut"):
            deepspeed_tpu_torch.init_inference(
                LlamaForCausalLM(cfg), dtype="fp32", device="cpu",
                quant={"enabled": True, "group_size": 128}, serve_mode="layer_scan",
                fused_int8=True)
    finally:
        groups.reset_topology()
