"""The port's block-paged KV cache and paged attention held against the JAX package's.

(a) The paged writes (token and block scatters, parked rows, unowned -1
    entries), `apply_stage` and `gather_paged_layer` must give exactly the
    JAX package's pools and views.
(b) The plain version of the paged decode kernel (K3) against the JAX
    `paged_decode_attention` in Pallas interpret mode, and
(c) the plain version of the paged prefill kernel (K4) against the JAX
    `paged_prefill_attention` in interpret mode, both in fp32 on the same
    numpy inputs, to 1e-5.
On the CPU the wrappers take their plain versions and count no launch.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.inference import kv_cache as jax_kv  # noqa: E402
from deepspeed_tpu.ops.pallas.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill,
)
from deepspeed_tpu_torch.inference import kv_cache as port_kv  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.paged_attention import (  # noqa: E402
    paged_decode_attention,
    paged_prefill_attention,
)

TOL = 1e-5
L, B, T, BS, NB, HKV, D = 2, 4, 4, 8, 16, 2, 16
MAX_LEN = T * BS


def _tables(rng, blocks_per_row, nb=NB, t=T):
    """A seeded permutation of the pool handed out row by row, -1 tails."""
    perm = rng.permutation(nb)
    tables = np.full((len(blocks_per_row), t), -1, np.int32)
    used = 0
    for row, n in enumerate(blocks_per_row):
        tables[row, :n] = perm[used:used + n]
        used += n
    return tables


def _caches(rng, tables, staged=False):
    """The same pools, tables and stage in both packages: (JAX cache, port cache)."""
    k_pool = rng.standard_normal((L, HKV, NB, BS, D)).astype(np.float32)
    v_pool = rng.standard_normal((L, HKV, NB, BS, D)).astype(np.float32)
    stage = [rng.standard_normal((L, B, HKV, D)).astype(np.float32) for _ in range(2)]
    jt = jnp.broadcast_to(jnp.asarray(tables)[None], (L,) + tables.shape)
    jcache = jax_kv.PagedKVCache(
        k=jax_kv.PagedLayer(pool=jnp.asarray(k_pool), tables=jt,
                            stage=jnp.asarray(stage[0]) if staged else None),
        v=jax_kv.PagedLayer(pool=jnp.asarray(v_pool), tables=jt,
                            stage=jnp.asarray(stage[1]) if staged else None),
        index=jnp.zeros((B,), jnp.int32))
    pcache = port_kv.PagedKVCache.create(L, B, MAX_LEN, HKV, D, num_blocks=NB,
                                         block_size=BS, dtype=torch.float32,
                                         device="cpu", staged=staged)
    pcache.k_pool.copy_(torch.from_numpy(k_pool))
    pcache.v_pool.copy_(torch.from_numpy(v_pool))
    pcache.with_tables(tables)
    if staged:
        pcache.k_stage.copy_(torch.from_numpy(stage[0]))
        pcache.v_stage.copy_(torch.from_numpy(stage[1]))
    return jcache, pcache


def _jax_layer(jcache, i):
    def one(layer):
        return jax_kv.PagedLayer(pool=layer.pool[i], tables=layer.tables[i],
                                 stage=None if layer.stage is None else layer.stage[i])
    return one(jcache.k), one(jcache.v)


def _assert_pools_equal(pcache, k_pools, v_pools):
    np.testing.assert_array_equal(pcache.k_pool.numpy(), np.stack(k_pools))
    np.testing.assert_array_equal(pcache.v_pool.numpy(), np.stack(v_pools))


# ----------------------------------------------------------- (a) the cache
@pytest.mark.parametrize("s,index,blocks", [
    # token scatter: a write crossing a block edge, one running into a -1
    # entry past the row's blocks, a parked row at the capacity
    (5, [0, 13, 5, MAX_LEN], [1, 2, 2, 0]),
    # block scatter: S == BS with every cursor aligned; row 2's target
    # entry is -1 and drops, row 3 is parked
    (BS, [0, 8, 16, MAX_LEN], [1, 2, 2, 0]),
    # S == BS but one cursor unaligned: the token scatter
    (BS, [0, 3, 8, MAX_LEN], [1, 2, 2, 0]),
])
def test_paged_writes_match_jax(s, index, blocks):
    rng = np.random.default_rng(s + sum(index))
    tables = _tables(rng, blocks)
    jcache, pcache = _caches(rng, tables)
    new_k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    new_v = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    jidx = jnp.asarray(index, jnp.int32)
    k_pools, v_pools = [], []
    for i in range(L):
        jk, jv = jax_kv.update_layer(*_jax_layer(jcache, i), jnp.asarray(new_k),
                                     jnp.asarray(new_v), jidx)
        k_pools.append(np.asarray(jk.pool))
        v_pools.append(np.asarray(jv.pool))
        pk, pv = port_kv.update_layer(*pcache.layer(i), torch.from_numpy(new_k),
                                      torch.from_numpy(new_v),
                                      torch.tensor(index, dtype=torch.int32))
        np.testing.assert_array_equal(port_kv.gather_paged_layer(pk).numpy(),
                                      np.asarray(jax_kv.gather_paged_layer(jk)))
        np.testing.assert_array_equal(port_kv.gather_paged_layer(pv).numpy(),
                                      np.asarray(jax_kv.gather_paged_layer(jv)))
    _assert_pools_equal(pcache, k_pools, v_pools)


def test_staged_write_and_apply_stage_match_jax():
    """A single token into a staged layer goes to the stage only; then
    `apply_stage` lands every layer's staged token at index − 1, dropping a
    parked row and a position whose table entry is -1."""
    rng = np.random.default_rng(3)
    tables = _tables(rng, [1, 2, 1, 0])
    jcache, pcache = _caches(rng, tables, staged=True)
    before = pcache.k_pool.clone()
    index = [0, 9, 8, MAX_LEN]    # row 2 writes into its -1 entry, row 3 is parked
    tok_k = rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
    tok_v = rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
    jk_stage, jv_stage = [], []
    for i in range(L):
        jk, jv = jax_kv.update_layer(*_jax_layer(jcache, i), jnp.asarray(tok_k),
                                     jnp.asarray(tok_v), jnp.asarray(index, jnp.int32))
        jk_stage.append(jk.stage)
        jv_stage.append(jv.stage)
        port_kv.update_layer(*pcache.layer(i), torch.from_numpy(tok_k),
                             torch.from_numpy(tok_v), torch.tensor(index, dtype=torch.int32))
    assert torch.equal(pcache.k_pool, before)          # the pool is untouched
    np.testing.assert_array_equal(pcache.k_stage.numpy(), np.stack(jk_stage))
    np.testing.assert_array_equal(pcache.v_stage.numpy(), np.stack(jv_stage))

    advanced = [i + 1 for i in index]
    jcache = jcache.replace(
        k=jcache.k.replace(stage=jnp.stack(jk_stage)),
        v=jcache.v.replace(stage=jnp.stack(jv_stage)),
        index=jnp.asarray(advanced, jnp.int32)).apply_stage()
    pcache.replace(index=torch.tensor(advanced, dtype=torch.int32)).apply_stage()
    _assert_pools_equal(pcache, list(np.asarray(jcache.k.pool)),
                        list(np.asarray(jcache.v.pool)))
    assert not torch.equal(pcache.k_pool, before)


# ------------------------------------------------------ (b) and (c) kernels
def _pools(rng, nb, bs, hkv, d):
    return (rng.standard_normal((hkv, nb, bs, d)).astype(np.float32),
            rng.standard_normal((hkv, nb, bs, d)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_paged_decode_plain_matches_jax_kernel(n_rep, staged, window):
    """Ragged lengths (one row whose only key is the staged one when
    staged), a parked row (cursor at the capacity, table all -1), GQA
    groups, with and without a sliding window."""
    b, hkv, d, bs, t, nb = 4, 2, 32, 8, 4, 12
    h = hkv * n_rep
    rng = np.random.default_rng(10 * n_rep + 2 * staged + (window or 0))
    k_pool, v_pool = _pools(rng, nb, bs, hkv, d)
    tables = _tables(rng, [1, 2, 3, 0], nb=nb, t=t)
    lengths = np.asarray([1, 9, 20, t * bs + 1], np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k_new = rng.standard_normal((b, hkv, d)).astype(np.float32) if staged else None
    v_new = rng.standard_normal((b, hkv, d)).astype(np.float32) if staged else None
    ref = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(tables),
        jnp.asarray(lengths), k_new=None if k_new is None else jnp.asarray(k_new),
        v_new=None if v_new is None else jnp.asarray(v_new), window=window)
    launches = paged_decode_attention.launches
    t_ = torch.from_numpy
    got = paged_decode_attention(
        t_(q), t_(k_pool), t_(v_pool), t_(tables), t_(lengths),
        k_new=None if k_new is None else t_(k_new),
        v_new=None if v_new is None else t_(v_new), window=window)
    assert paged_decode_attention.launches == launches
    assert got.shape == (b, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_paged_prefill_plain_matches_jax_kernel(n_rep, window):
    """Chunks of S = 12 (no multiple of the block) at an aligned start, an
    unaligned one and 0, several query tiles on the JAX side, and a parked
    row when there is no window (with a window a parked row's queries see
    no key, where the two compute different garbage that nobody reads)."""
    b, s, hkv, d, bs, t, nb = 4, 12, 2, 32, 8, 4, 14
    h = hkv * n_rep
    rng = np.random.default_rng(20 * n_rep + (window or 0))
    k_pool, v_pool = _pools(rng, nb, bs, hkv, d)
    tables = _tables(rng, [2, 3, 3, 0], nb=nb, t=t)
    starts = np.asarray([0, 8, 5, t * bs], np.int32)
    rows = slice(None) if window is None else slice(0, 3)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ref = jax_paged_prefill(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                            jnp.asarray(tables), jnp.asarray(starts), block_q=4,
                            window=window)
    launches = paged_prefill_attention.launches
    got = paged_prefill_attention(torch.from_numpy(q), torch.from_numpy(k_pool),
                                  torch.from_numpy(v_pool), torch.from_numpy(tables),
                                  torch.from_numpy(starts), window=window)
    assert paged_prefill_attention.launches == launches
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_paged_prefill_plain_matches_jax_kernel_ragged_tiles(n_rep, window):
    """The CUDA kernel's ragged shapes: chunks of S = 300 (its 128-row tiles
    end ragged at every group size) over blocks of BS = 16 (a 128-key tile
    spans eight pool blocks), at starts 0, 16 and 37, and a parked row
    compared when there is no window (as above)."""
    b, s, hkv, d, bs, t, nb = 4, 300, 2, 16, 16, 24, 64
    h = hkv * n_rep
    rng = np.random.default_rng(30 * n_rep + (window or 0))
    k_pool, v_pool = _pools(rng, nb, bs, hkv, d)
    tables = _tables(rng, [19, 20, 22, 0], nb=nb, t=t)
    starts = np.asarray([0, 16, 37, t * bs], np.int32)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ref = jax_paged_prefill(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                            jnp.asarray(tables), jnp.asarray(starts), window=window)
    got = paged_prefill_attention(torch.from_numpy(q), torch.from_numpy(k_pool),
                                  torch.from_numpy(v_pool), torch.from_numpy(tables),
                                  torch.from_numpy(starts), window=window)
    rows = slice(None) if window is None else slice(0, 3)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows], rtol=TOL, atol=TOL)


def test_paged_attention_through_cached_attention_rejects_alibi():
    """The paged branch of `cached_attention` takes alibi slopes of shape
    (H,) and rejects any other shape (one slope would broadcast over every
    head without a word)."""
    from deepspeed_tpu_torch.ops.attention import cached_attention
    cache = port_kv.PagedKVCache.create(1, 1, 16, 1, 8, num_blocks=2, block_size=8,
                                        dtype=torch.float32, device="cpu")
    k, v = cache.layer(0)
    q, index = torch.zeros(1, 1, 2, 8), torch.zeros(1, dtype=torch.int32)
    for bad in (torch.ones(1), torch.ones(3), torch.ones(2, dtype=torch.float64)):
        with pytest.raises(ValueError, match="alibi"):
            cached_attention(q, k, v, index, None, alibi=bad)
    assert cached_attention(q, k, v, index, None, alibi=torch.ones(2)).shape == q.shape
