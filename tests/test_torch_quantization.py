"""The port's weight quantization held against the JAX package's on the CPU.

(a) `quantize_int8_blockwise`: int8 values and f32 scales equal to the JAX
    package's bit for bit, the shrinking block and all-zero blocks
    included; `quantize_param_tree`, `quantize_layer_stacks` and
    `dequantize_param_tree` trees equal leaf for leaf, and the byte
    accounting equal.
(b) `scale_group_width`, `choose_serve_mode` and the serving byte formulas
    equal to the JAX package's over a grid of inputs.
(c) `quantized_matmul_plain` (what the K5 wrapper takes on the CPU) against
    the JAX `quantized_matmul` Pallas kernel in interpret mode on the JAX
    package's own six cases: f32 to 1e-5 relative to max |ref|, the bf16
    activation case to one bf16 rounding (2^-8).
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import itertools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.inference import capacity_scan as jax_cap  # noqa: E402
from deepspeed_tpu.inference import quantization as jax_q  # noqa: E402
from deepspeed_tpu.inference import quantized_layer_scan as jax_qls  # noqa: E402
from deepspeed_tpu.inference.config import choose_serve_mode as jax_choose  # noqa: E402
from deepspeed_tpu.ops.pallas import quantized_matmul as jax_qmm  # noqa: E402
from deepspeed_tpu.ops.quantization import (  # noqa: E402
    dequantize_int8_blockwise as jax_dequant,
    quantize_int8_blockwise as jax_quant,
)
from deepspeed_tpu_torch.inference import capacity_scan  # noqa: E402
from deepspeed_tpu_torch.inference import quantization as port_q  # noqa: E402
from deepspeed_tpu_torch.inference import quantized_layer_scan as port_qls  # noqa: E402
from deepspeed_tpu_torch.inference.config import choose_serve_mode  # noqa: E402
from deepspeed_tpu_torch.models.llama import llama_config, tree_to_torch  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.quantized_matmul import (  # noqa: E402
    quantized_matmul,
    quantized_matmul_plain,
    scale_group_width,
)
from deepspeed_tpu_torch.ops.quantization import (  # noqa: E402
    dequantize_int8_blockwise,
    quantize_int8_blockwise,
)
from tests.test_torch_llama import TINY, numpy_tree  # noqa: E402


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 and back: the values a bf16 engine quantizes."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# --------------------------------------------------- (a) blockwise int8
@pytest.mark.parametrize("shape,block,zero_blocks,bf16", [
    ((64, 256), 256, False, False),     # whole blocks along rows
    ((16, 64), 256, False, True),       # a block spans four rows; bf16 values
    ((7, 33), 256, False, False),       # 231 elements: the block shrinks to 231
    ((10, 30), 64, False, False),       # 300 elements: the block shrinks to 60
    ((8, 128), 32, True, False),        # all-zero blocks take scale 1.0
    ((3, 4, 96), 48, True, True),
])
def test_quantize_int8_blockwise_bitwise(shape, block, zero_blocks, bf16):
    rng = np.random.default_rng(sum(shape) + block)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    if zero_blocks:
        flat = x.reshape(-1)
        flat[:block] = 0.0
        flat[3 * block:5 * block] = 0.0
    if bf16:
        x = _bf16_values(x)
    jq, js = jax_quant(jnp.asarray(x), block)
    q, s = quantize_int8_blockwise(torch.from_numpy(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if zero_blocks:
        assert (s.numpy()[[0, 3, 4]] == 1.0).all()
    np.testing.assert_array_equal(dequantize_int8_blockwise(q, s).numpy(),
                                  np.asarray(jax_dequant(jq, js)))


def _tree_np(tree):
    """Either package's tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_trees_equal(got, ref):
    got, ref = _tree_np(got), _tree_np(ref)
    assert sorted(got) == sorted(ref) if isinstance(got, dict) else True
    for (pg, g), (pr, r) in zip(
            sorted(jax.tree_util.tree_flatten_with_path(got)[0], key=lambda x: str(x[0])),
            sorted(jax.tree_util.tree_flatten_with_path(ref)[0], key=lambda x: str(x[0]))):
        assert pg == pr
        assert g.dtype == r.dtype and g.shape == r.shape, (pg, g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r, err_msg=str(pg))


@pytest.mark.parametrize("group", [256, 32])
def test_quantize_param_tree_matches_jax(group):
    _, tree = numpy_tree(31)
    ref, _ = jax_q.quantize_param_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                                       group_size=group)
    got, meta = port_q.quantize_param_tree(tree_to_torch(tree), group_size=group)
    assert meta is None
    _assert_trees_equal(got, ref)
    assert port_q.quantized_memory_bytes(got) == jax_q.quantized_memory_bytes(ref)
    _assert_trees_equal(port_q.dequantize_param_tree(got, torch.float32),
                        jax_q.dequantize_param_tree(ref, jnp.float32))
    # idempotent: quantized leaves pass through
    again, _ = port_q.quantize_param_tree(got, group_size=group)
    _assert_trees_equal(again, ref)


@pytest.mark.parametrize("group", [256, 32])
def test_quantize_layer_stacks_matches_jax(group):
    """Per-layer scales with a leading L; embed/head stay float; the
    dequantized tree (the per-layer 2-D scales branch) and the layer-scan
    byte accounting equal too."""
    _, tree = numpy_tree(32)
    ref = jax_qls.quantize_layer_stacks(jax.tree_util.tree_map(jnp.asarray, tree),
                                        group_size=group)
    got = port_qls.quantize_layer_stacks(tree_to_torch(tree), group_size=group)
    _assert_trees_equal(got, ref)
    q_leaf = got["layers"]["mlp"]["gate_proj"]["kernel"]
    assert port_q.is_quantized_leaf(q_leaf) and q_leaf["scales"].dim() == 2
    assert not port_q.is_quantized_leaf(got["embed_tokens"])
    _assert_trees_equal(port_q.dequantize_param_tree(got), jax_q.dequantize_param_tree(ref))
    assert port_qls.weight_bytes_per_step(got) == jax_qls.weight_bytes_per_step(ref)
    assert port_qls.at_rest_bytes(got) == jax_qls.at_rest_bytes(ref)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        assert port_qls.dense_bytes_per_step(got, dt) == jax_qls.dense_bytes_per_step(ref, jdt)


def test_quantize_layer_stacks_normalizes_prequantized_leaves():
    """A flat-quantized tree (the whole-tree form): stacked leaves keep their
    int8 values with the scales reshaped per layer, norms and the
    embedding come back dequantized."""
    _, tree = numpy_tree(33)
    jflat, _ = jax_q.quantize_param_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                                         group_size=64, min_size=64)
    ref = jax_qls.quantize_layer_stacks(jflat, group_size=64)
    got = port_qls.quantize_layer_stacks(tree_to_torch(_tree_np(jflat)), group_size=64)
    _assert_trees_equal(got, ref)
    assert got["layers"]["mlp"]["up_proj"]["kernel"]["scales"].dim() == 2
    assert not port_q.is_quantized_leaf(got["layers"]["input_layernorm"]["weight"])


def test_layer_scan_supported_matches_jax():
    _, tree = numpy_tree(34)
    assert port_qls.layer_scan_supported(tree) and jax_qls.layer_scan_supported(tree)
    broken = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "mlp"})
    assert not port_qls.layer_scan_supported(broken)
    assert not jax_qls.layer_scan_supported(broken)


# ------------------------------------------ (b) layout and mode decisions
def test_scale_group_width_matches_jax_over_a_grid():
    for k, n, nblocks in itertools.product((3, 64, 200), (5, 128, 384),
                                           (1, 3, 5, 64, 96, 128, 400, 800)):
        assert scale_group_width(k, n, nblocks) == jax_qmm.scale_group_width(k, n, nblocks), \
            (k, n, nblocks)


def test_choose_serve_mode_matches_jax_over_a_grid():
    gb = 1 << 30
    for quantized, layout_ok, multi, tp_ok, dense, hbm, kv, n_dev, spec in itertools.product(
            (False, True), (False, True), (False, True), (False, True),
            (2 * gb, 16 * gb, 60 * gb, 140 * gb), (0, 16 * gb, 80 * gb),
            (0, 4 * gb), (1, 4), (0, 8 * gb)):
        kw = dict(quantized=quantized, layout_ok=layout_ok, multi_device=multi,
                  dense_bytes=dense, int8_bytes=dense // 2 + dense // 128,
                  layer_bytes=dense // 32, kv_bytes=kv, workspace_bytes=gb // 4,
                  hbm_bytes=hbm, n_devices=n_dev, tp_shardable=tp_ok, spec_bytes=spec)
        assert choose_serve_mode(**kw) == jax_choose(**kw), kw


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_serving_byte_formulas_match_jax(kv_dtype):
    from deepspeed_tpu.models.llama import llama_config as jax_llama_config
    for name in ("llama3-8b", "llama-tiny"):
        cfg, jcfg = llama_config(name), jax_llama_config(name)
        for b, n in ((1, 1), (4, 576), (64, 1024)):
            assert capacity_scan.round_up_len(n) == jax_cap.round_up_len(n)
            assert capacity_scan.kv_cache_bytes(cfg, b, n, torch.bfloat16, kv_dtype) == \
                jax_cap.kv_cache_bytes(jcfg, b, n, jnp.bfloat16, kv_dtype=kv_dtype)
            assert capacity_scan.decode_workspace_bytes(cfg, b, n, torch.bfloat16) == \
                jax_cap.decode_workspace_bytes(jcfg, b, n, jnp.bfloat16)


# ------------------------------------------------- (c) the K5 plain version
def _case(m, k, n, block, seed=0, lead=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*(lead or (m,)), k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    q, s = jax_quant(jnp.asarray(w), block)
    return x, np.array(q), np.array(s)


@pytest.mark.parametrize("name,m,k,n,block,tiling,lead", [
    ("per_row_groups", 8, 128, 256, 64, None, None),
    ("block_spans_rows", 4, 64, 128, 256, None, None),
    ("k_remainder", 16, 200, 384, 96, (16, 128, 192), None),
    ("m_and_n_remainders", 5, 128, 384, 64, (8, 64, 256), None),
    ("leading_batch_dims", None, 128, 256, 64, None, (2, 3)),
    ("bf16_activation", 8, 128, 256, 64, None, None),
    # the CUDA kernel's shapes: either side of its decode/prefill boundary
    # (M = 16, 17) and K = 7168, whose split-K count differs from 4096's
    ("decode_m16", 16, 256, 256, 64, None, None),
    ("prefill_m17", 17, 256, 256, 64, None, None),
    ("k_7168", 4, 7168, 128, 256, (8, 1024, 128), None),
])
def test_quantized_matmul_plain_matches_jax_kernel(name, m, k, n, block, tiling, lead):
    x, q, s = _case(m, k, n, block, seed=len(name), lead=lead)
    bf16 = name == "bf16_activation"
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    ref = np.asarray(jax_qmm.quantized_matmul(jx, jnp.asarray(q), jnp.asarray(s),
                                              tiling=tiling, interpret=True), np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    launches = quantized_matmul.launches
    got = quantized_matmul(tx, torch.from_numpy(q), torch.from_numpy(s))
    assert quantized_matmul.launches == launches      # the CPU takes the plain version
    assert got.dtype == tx.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(
        got.float().numpy(), quantized_matmul_plain(tx, torch.from_numpy(q),
                                                    torch.from_numpy(s)).float().numpy())
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= (2.0 ** -8 if bf16 else 1e-5), err


def test_quantized_matmul_refuses_misaligned_scales():
    with pytest.raises(ValueError, match="row-aligned"):
        quantized_matmul(torch.zeros(2, 3), torch.zeros(3, 5, dtype=torch.int8),
                         torch.ones(5))
    with pytest.raises(ValueError):
        jax_qmm.quantized_matmul(jnp.zeros((2, 3)), jnp.zeros((3, 5), jnp.int8),
                                 jnp.ones((5,)))


def test_tiny_config_shapes_quantize_like_llama():
    """The tiny test model's projections take the kernel's layouts: a
    block spanning rows (q/o at group 256) and per-row groups (gate/up at
    group 32)."""
    cfg = llama_config("llama-tiny", **TINY)
    d, i = cfg.hidden_size, cfg.intermediate_size
    assert scale_group_width(d, d, d * d // 256) == d
    assert scale_group_width(d, i, d * i // 32) == 32
