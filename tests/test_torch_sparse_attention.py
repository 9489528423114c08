"""The port's block-sparse attention held against the JAX package's on the CPU.

* Layouts: every sparsity config of `ops/sparse_attention/sparsity_config.py`
  (the port's own numpy copy) gives the JAX config's layout bit for bit,
  BigBird's and Variable's random blocks included (both draw from
  `np.random.default_rng(seed)`), and `padded_layout_indices` gives the
  same (idx, nlive).
* K7: `block_sparse_attention_plain` (what the wrapper runs on a CPU
  tensor) against the JAX Pallas kernel in interpret mode on random
  layouts, causal and not, with a causal row whose only live block lies
  above it (zeros): 1e-5 in f32.
* The module: `sparse_attention` (`impl="auto"`: K7's plain version
  forward, the gather path's gradient; `impl="reference"`: the gather path)
  and `SparseSelfAttention`, outputs and q/k/v gradients against
  `jax.vjp` of the JAX `sparse_attention(impl="reference")`: 1e-5 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jax_sa
from deepspeed_tpu.ops.pallas.block_sparse_attention import (
    block_sparse_attention as jax_block_sparse_attention,
    padded_layout_indices as jax_padded_layout_indices,
)
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
    block_sparse_attention,
    block_sparse_attention_plain,
    padded_layout_indices,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import layout_tensors

TOL = 1e-5

CONFIGS = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16)),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=3,
                                 num_global_blocks=1)),
    ("FixedSparsityConfig", dict(num_heads=3, block=32, attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16, num_sliding_window_blocks=5,
                                        global_block_indices=(0, 7))),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16, num_random_blocks=2, seed=3)),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=64, attention="unidirectional")),
    ("VariableSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=1,
                                    local_window_blocks=(2, 3), global_block_indices=(0, 5),
                                    global_block_end_indices=(2, 7),
                                    horizontal_global_attention=True, seed=9)),
    ("VariableSparsityConfig", dict(num_heads=2, block=16, attention="unidirectional")),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16)),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16,
                                              attention="bidirectional")),
]


@pytest.mark.parametrize("name,kw", CONFIGS)
def test_layouts_and_indices_equal_jax(name, kw):
    seq = 16 * kw["block"]
    ref = getattr(jax_sa, name)(**kw).make_layout(seq)
    got = getattr(sa, name)(**kw).make_layout(seq)
    assert got.dtype == ref.dtype == bool
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(padded_layout_indices(got), jax_padded_layout_indices(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_setup_layout_refuses_a_ragged_sequence():
    with pytest.raises(ValueError, match="block"):
        sa.FixedSparsityConfig(num_heads=1, block=16).make_layout(40)


def _layout(rng, h, n, causal):
    layout = rng.random((h, n, n)) < 0.4
    layout[:, :, 0] = True
    if causal:   # head 0's first query block sees only the last key block
        layout[0, 0, :] = False
        layout[0, 0, n - 1] = True
    return layout


def _qkv(rng, b, s, h, d):
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block,d", [(16, 32), (32, 16)])
def test_kernel_plain_version_matches_jax_kernel(causal, block, d):
    rng = np.random.default_rng(block + causal)
    b, s, h = 2, 4 * block, 2
    layout = _layout(rng, h, s // block, causal)
    q, k, v = _qkv(rng, b, s, h, d)
    idx, nlive = padded_layout_indices(layout)
    ref = np.asarray(jax_block_sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                idx, nlive, block, causal=causal))
    launches = block_sparse_attention.launches
    got = block_sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 torch.from_numpy(idx), torch.from_numpy(nlive), block, causal)
    assert block_sparse_attention.launches == launches   # the plain version is no launch
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    if causal:
        assert (got[:, :block, 0] == 0).all()
    plain = block_sparse_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), idx, nlive,
                                         block, causal, softmax_scale=0.3)
    ref = jax_block_sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), idx, nlive,
                                     block, causal=causal, softmax_scale=0.3)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _jax_reference(q, k, v, g, layout, block, causal):
    def f(q, k, v):
        return jax_sa.sparse_attention(q, k, v, layout, block=block, causal=causal,
                                       impl="reference")
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("impl", ["auto", "reference"])
@pytest.mark.parametrize("causal", [False, True])
def test_sparse_attention_and_grads_match_jax(impl, causal):
    rng = np.random.default_rng(20 + causal)
    b, s, h, d, block = 2, 64, 2, 16, 16
    layout = _layout(rng, h, s // block, causal)
    q, k, v = _qkv(rng, b, s, h, d)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ref, ref_grads = _jax_reference(q, k, v, g, layout, block, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = sa.sparse_attention(tq, tk, tv, layout, block=block, causal=causal, impl=impl)
    assert type(out.grad_fn).__name__ == ("BlockSparseAttentionBackward" if impl == "auto"
                                          else "TransposeBackward0")
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=TOL, atol=TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_sparse_self_attention_module_matches_jax():
    """`SparseSelfAttention` over a causal BigBird layout (one layout a
    sequence length, cached), output and gradients against JAX's."""
    rng = np.random.default_rng(30)
    b, s, h, d = 1, 128, 2, 16
    kw = dict(num_heads=h, block=16, num_random_blocks=1, attention="unidirectional", seed=2)
    q, k, v = _qkv(rng, b, s, h, d)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    layout = jax_sa.BigBirdSparsityConfig(**kw).make_layout(s)
    ref, ref_grads = _jax_reference(q, k, v, g, layout, 16, True)
    attn = sa.SparseSelfAttention(sa.BigBirdSparsityConfig(**kw))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attn(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=TOL, atol=TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert list(attn._layouts) == [s]
    with torch.no_grad():
        np.testing.assert_allclose(attn(tq, tk, tv, causal=True).numpy(), ref, rtol=TOL,
                                   atol=TOL)


def test_layout_tensors_are_uploaded_once_per_layout():
    """The padded indices of one layout are one cached set of tensors: a
    second call (and an equal layout built anew) returns the same objects."""
    layout = sa.FixedSparsityConfig(num_heads=2, block=16).make_layout(128)
    first = layout_tensors(layout, "cpu")
    assert all(a is b for a, b in zip(first, layout_tensors(layout.copy(), "cpu")))
    idx, nlive, valid = first
    assert idx.dtype == nlive.dtype == torch.int32 and valid.dtype == torch.bool
    assert tuple(valid.shape) == tuple(idx.shape)


def test_sparse_attention_refuses_bad_arguments():
    q = torch.zeros(1, 64, 2, 16)
    layout = np.ones((2, 4, 4), bool)
    with pytest.raises(ValueError, match="impl"):
        sa.sparse_attention(q, q, q, layout, block=16, impl="pallas")
    with pytest.raises(ValueError, match="multiple of block"):
        sa.sparse_attention(q, q, q, layout, block=24)
    with pytest.raises(ValueError, match="layout"):
        sa.sparse_attention(q, q, q, np.ones((2, 2, 2), bool), block=16)
