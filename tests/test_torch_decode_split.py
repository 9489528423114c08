"""The decode kernels' function at the lengths their split of the KV axis turns on, on the CPU.

On the card, K2 and K3 cut each row's cache positions into chunks of 128
(`csrc/decode_split.cuh`), one thread block each, and merge the chunks'
partials; the card tests hold them to their plain versions at these
lengths. Here the plain versions, which the wrappers take for CPU tensors,
are held against the JAX kernels in Pallas interpret mode to 1e-5 at the
same lengths: rows of 0 and 1 keys, of one chunk and one past it
("edges"), and rows of many chunks beside a short one and, for K3, a
parked row ("long"); K2 over bf16-free f32 and int8 caches, K3 over f32
and int8 pools and with alibi, staged and not, with and without a window.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode  # noqa: E402
from deepspeed_tpu.ops.pallas.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged_decode,
)
from deepspeed_tpu_torch.ops.attention import alibi_slopes  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.decode_attention import decode_attention  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.paged_attention import paged_decode_attention  # noqa: E402
from deepspeed_tpu_torch.ops.quantization import quantize_kv_tokens  # noqa: E402

TOL = 1e-5
CHUNK = 128  # positions a block of the card's split takes
# K2: cache capacity M and row lengths
DENSE = {"edges": (300, [0, 1, CHUNK, CHUNK + 1]), "long": (1024, [1024, 700, 257, 1])}
# K3: BS, T, NB, blocks per row and pool lengths (the keys in the pool; a
# staged row's length is one more); None is a parked row (cursor at the
# capacity, table all -1)
PAGED = {"edges": (16, 16, 24, [0, 1, 8, 9], [0, 1, CHUNK, CHUNK + 1]),
         "long": (64, 16, 40, [16, 11, 5, 0], [1024, 700, 257, None])}


def _cache(rng, shape, int8):
    """f32 K and V of `shape`, or int8 ones with their scales (None for f32)."""
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if not int8:
        return k, v, None, None
    (kq, ks), (vq, vs) = (quantize_kv_tokens(torch.from_numpy(x)) for x in (k, v))
    return kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hkv", [2, 1])
@pytest.mark.parametrize("case", ["edges", "long"])
def test_decode_plain_matches_jax_kernel_at_chunk_edges(case, hkv, int8):
    b, h, d = 4, 4, 32
    m, lens = DENSE[case]
    rng = np.random.default_rng([m, hkv, int8])
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k, v, ks, vs = _cache(rng, (b, m, hkv, d), int8)
    lengths = np.asarray(lens, np.int32)
    ref = jax_decode(_j(q), _j(k), _j(v), _j(lengths), block_k=128, k_scales=_j(ks),
                     v_scales=_j(vs))
    got = decode_attention(_t(q), _t(k), _t(v), _t(lengths), k_scales=_t(ks), v_scales=_t(vs))
    assert got.shape == (b, 1, h, d) and not got[lengths == 0].any()  # an empty row: zeros
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("variant", ["f32", "int8", "alibi"])
@pytest.mark.parametrize("case", ["edges", "long"])
def test_paged_decode_plain_matches_jax_kernel_at_chunk_edges(case, variant, staged, window):
    b, hkv, n_rep, d = 4, 2, 4, 32
    h = hkv * n_rep
    bs, t, nb, blocks, pool = PAGED[case]
    rng = np.random.default_rng([bs, staged, window or 0, len(variant)])
    k_pool, v_pool, ks, vs = _cache(rng, (hkv, nb, bs, d), variant == "int8")
    perm = rng.permutation(nb)
    tables = np.full((b, t), -1, np.int32)
    for row, n in enumerate(blocks):
        tables[row, :n] = perm[sum(blocks[:row]):sum(blocks[:row]) + n]
    lengths = np.asarray([t * bs + 1 if n is None else n + staged for n in pool], np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k_new, v_new = ((rng.standard_normal((b, hkv, d)).astype(np.float32) for _ in range(2))
                    if staged else (None, None))
    slopes = alibi_slopes(h) if variant == "alibi" else None
    ref = jax_paged_decode(_j(q), _j(k_pool), _j(v_pool), _j(tables), _j(lengths),
                           k_new=_j(k_new), v_new=_j(v_new), window=window,
                           alibi=None if slopes is None else _j(slopes.numpy()),
                           k_scales=_j(ks), v_scales=_j(vs))
    got = paged_decode_attention(_t(q), _t(k_pool), _t(v_pool), _t(tables), _t(lengths),
                                 k_new=_t(k_new), v_new=_t(v_new), window=window,
                                 k_scales=_t(ks), v_scales=_t(vs), alibi=slopes)
    assert got.shape == (b, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
