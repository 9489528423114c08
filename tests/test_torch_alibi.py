"""Alibi in the port's paged attention held against the JAX package's.

(a) `alibi_slopes` against the JAX slopes, power-of-two head counts and
    not (the interleaved extra slopes), to 1e-7.
(b) The plain version of K3-alibi (`paged_decode_attention_plain` with
    slopes) against the JAX `paged_decode_attention` in Pallas interpret
    mode, staged and unstaged, at the JAX test's shape (b, h, hkv, d, bs, t,
    nb) = (3, 4, 4, 64, 16, 4, 12) and at a GQA shape, bf16-free f32, to
    1e-5; the same over int8 pools with their scales.
(c) The plain version of K4-alibi against the JAX `paged_prefill_attention`
    (`block_q=8`, so several query tiles) in interpret mode, to 1e-5, over
    f32 and int8 pools.
(d) The port's `cached_attention` on a `PagedLayer` with alibi (prefill and
    staged decode) against the JAX `cached_attention` on the same layer, to
    1e-5.
On the CPU the wrappers take their plain versions and count no launch.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.inference import kv_cache as jax_kv  # noqa: E402
from deepspeed_tpu.ops.attention import (  # noqa: E402
    alibi_slopes as jax_alibi_slopes,
    cached_attention as jax_cached_attention,
)
from deepspeed_tpu.ops.pallas.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill,
)
from deepspeed_tpu_torch.inference import kv_cache as port_kv  # noqa: E402
from deepspeed_tpu_torch.ops.attention import alibi_slopes, cached_attention  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.paged_attention import (  # noqa: E402
    paged_decode_attention,
    paged_prefill_attention,
)
from deepspeed_tpu_torch.ops.quantization import quantize_kv_tokens  # noqa: E402

TOL = 1e-5
SLOPES_TOL = 1e-7
# (b, h, hkv, d, bs, t, nb): the JAX test's shape, and a GQA one
DECODE_SHAPES = [(3, 4, 4, 64, 16, 4, 12), (4, 8, 2, 32, 8, 4, 16)]


@pytest.mark.parametrize("n_heads", [4, 8, 12, 16, 32])
def test_alibi_slopes_match_jax(n_heads):
    got = alibi_slopes(n_heads)
    assert got.dtype == torch.float32 and got.shape == (n_heads,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_alibi_slopes(n_heads)),
                               rtol=SLOPES_TOL, atol=SLOPES_TOL)


def _pools(rng, hkv, nb, bs, d, int8):
    """f32 pools, or int8 pools with their (Hkv, NB, BS) scales; and the
    (k_scales, v_scales) pair for each package (None for f32)."""
    pools = [rng.standard_normal((hkv, nb, bs, d)).astype(np.float32) for _ in range(2)]
    if not int8:
        return pools, (None, None)
    quant = [quantize_kv_tokens(torch.from_numpy(p)) for p in pools]
    return [q.numpy() for q, _ in quant], tuple(s.numpy() for _, s in quant)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_paged_decode_plain_alibi_matches_jax_kernel(shape, staged, int8):
    """Ragged lengths up to the row's whole capacity, random (shared)
    table entries; the staged column sits at lengths − 1."""
    b, h, hkv, d, bs, t, nb = shape
    rng = np.random.default_rng(sum(shape) + 2 * staged + int8)
    (k_pool, v_pool), (ks, vs) = _pools(rng, hkv, nb, bs, d, int8)
    tables = rng.integers(0, nb, (b, t)).astype(np.int32)
    lengths = np.asarray([5, 30, t * bs, 17][:b], np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k_new, v_new = ((rng.standard_normal((b, hkv, d)).astype(np.float32) for _ in range(2))
                    if staged else (None, None))
    slopes = alibi_slopes(h)
    ref = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(tables),
        jnp.asarray(lengths), k_new=_j(k_new), v_new=_j(v_new),
        alibi=jnp.asarray(slopes.numpy()), k_scales=_j(ks), v_scales=_j(vs))
    counts = (paged_decode_attention.launches, paged_decode_attention.launches_alibi)
    got = paged_decode_attention(_t(q), _t(k_pool), _t(v_pool), _t(tables), _t(lengths),
                                 k_new=_t(k_new), v_new=_t(v_new), k_scales=_t(ks),
                                 v_scales=_t(vs), alibi=slopes)
    assert (paged_decode_attention.launches, paged_decode_attention.launches_alibi) == counts
    assert got.shape == (b, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_rep", [1, 2])
def test_paged_prefill_plain_alibi_matches_jax_kernel(n_rep, int8):
    """Chunks of S = 16 at starts 0, 16 (aligned) and 23 (unaligned), two
    query tiles of 8 on the JAX side."""
    hkv, d, bs, t, nb, b, s = 2, 64, 16, 4, 9, 3, 16
    h = hkv * n_rep
    rng = np.random.default_rng(14 + n_rep + 2 * int8)
    (k_pool, v_pool), (ks, vs) = _pools(rng, hkv, nb, bs, d, int8)
    tables = rng.integers(0, nb, (b, t)).astype(np.int32)
    starts = np.asarray([0, 16, 23], np.int32)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    slopes = alibi_slopes(h)
    ref = jax_paged_prefill(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                            jnp.asarray(tables), jnp.asarray(starts), block_q=8,
                            alibi=jnp.asarray(slopes.numpy()), k_scales=_j(ks),
                            v_scales=_j(vs))
    counts = (paged_prefill_attention.launches, paged_prefill_attention.launches_alibi)
    got = paged_prefill_attention(_t(q), _t(k_pool), _t(v_pool), _t(tables), _t(starts),
                                  k_scales=_t(ks), v_scales=_t(vs), alibi=slopes)
    assert (paged_prefill_attention.launches,
            paged_prefill_attention.launches_alibi) == counts
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_alibi_bias_changes_the_plain_outputs():
    """The slopes reach the logits: zero slopes give the output without
    alibi, real slopes another (the gate above would pass a dropped bias
    only if the bias did nothing)."""
    b, h, hkv, d, bs, t, nb = DECODE_SHAPES[0]
    rng = np.random.default_rng(3)
    (k_pool, v_pool), _ = _pools(rng, hkv, nb, bs, d, False)
    tables = _t(rng.integers(0, nb, (b, t)).astype(np.int32))
    lengths = _t(np.asarray([5, 30, 64], np.int32))
    q = _t(rng.standard_normal((b, 1, h, d)).astype(np.float32))
    args = (q, _t(k_pool), _t(v_pool), tables, lengths)
    plain = paged_decode_attention(*args)
    assert torch.equal(paged_decode_attention(*args, alibi=torch.zeros(h)), plain)
    assert (paged_decode_attention(*args, alibi=alibi_slopes(h)) - plain).abs().max() > 1e-2


def test_cached_attention_paged_alibi_matches_jax():
    """A 2-layer paged cache, one layer's view: a 12-token prefill at cursors
    (0, 9), then one staged decode step, through both packages'
    `cached_attention` with the slopes (the JAX CPU path is its gather
    fallback, which reads the decode mask; the port's paged branch evaluates
    its mask from the cursors)."""
    L, b, hkv, d, bs, t, nb, s = 2, 2, 4, 16, 8, 4, 12, 12
    h = hkv
    rng = np.random.default_rng(7)
    tables = np.asarray([[3, 7, 1, -1], [0, 5, 9, 2]], np.int32)
    pools = [rng.standard_normal((L, hkv, nb, bs, d)).astype(np.float32) for _ in range(2)]
    index = np.asarray([0, 9], np.int32)
    slopes = alibi_slopes(h)
    jt = jnp.broadcast_to(jnp.asarray(tables)[None], (L,) + tables.shape)

    def jax_layer(pool, stage=None):
        return jax_kv.PagedLayer(pool=jnp.asarray(pool[0]), tables=jt[0],
                                 stage=_j(stage))

    pcache = port_kv.PagedKVCache.create(L, b, t * bs, hkv, d, num_blocks=nb, block_size=bs,
                                         dtype=torch.float32, device="cpu")
    pcache.k_pool.copy_(torch.from_numpy(pools[0]))
    pcache.v_pool.copy_(torch.from_numpy(pools[1]))
    pcache.with_tables(tables)
    k, v = pcache.layer(0)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    def mask(cursor, n):
        return jax_kv.decode_mask(jnp.asarray(cursor)[:, None] + jnp.arange(n)[None], t * bs)

    ref = jax_cached_attention(jnp.asarray(q), jax_layer(pools[0]), jax_layer(pools[1]),
                               jnp.asarray(index), mask(index, s),
                               alibi=jnp.asarray(slopes.numpy()))
    got = cached_attention(_t(q), k, v, _t(index), None, alibi=slopes)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)

    # staged decode: the new token rides the stage at cursor index + s
    stage = [rng.standard_normal((b, hkv, d)).astype(np.float32) for _ in range(2)]
    q1 = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    cursor = index + s
    ref = jax_cached_attention(jnp.asarray(q1), jax_layer(pools[0], stage[0]),
                               jax_layer(pools[1], stage[1]), jnp.asarray(cursor),
                               mask(cursor, 1), alibi=jnp.asarray(slopes.numpy()))
    k = port_kv.PagedLayer(pool=k.pool, tables=k.tables, stage=_t(stage[0]))
    v = port_kv.PagedLayer(pool=v.pool, tables=v.tables, stage=_t(stage[1]))
    got = cached_attention(_t(q1), k, v, _t(cursor), None, alibi=slopes)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
