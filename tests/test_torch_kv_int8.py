"""The port's int8-at-rest KV cache held against the JAX package's on the CPU.

(a) `quantize_kv_tokens` equal to the JAX package's bit for bit (zero rows
    included); the dense quantized writes, the paged token and block
    scatters and `apply_stage` give exactly the JAX package's int8 pools
    and f32 scales; `truncate` rolls a quantized dense cache back.
(b) The plain int8 versions of K2, K3 and K4 (what the wrappers take on the
    CPU) against the JAX Pallas kernels with scales in interpret mode, f32
    to 1e-5 (staged token, window, parked row); with unit scales each plain
    int8 version equals its unquantized plain version bit for bit.
(c) `KVBudget` equal to the JAX package's.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.inference import kv_block_manager as jax_kbm  # noqa: E402
from deepspeed_tpu.inference import kv_cache as jax_kv  # noqa: E402
from deepspeed_tpu.models.llama import llama_config as jax_llama_config  # noqa: E402
from deepspeed_tpu.ops.pallas.decode_attention import (  # noqa: E402
    decode_attention as jax_decode,
)
from deepspeed_tpu.ops.pallas.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill,
)
from deepspeed_tpu_torch.inference import kv_block_manager as kbm  # noqa: E402
from deepspeed_tpu_torch.inference import kv_cache as port_kv  # noqa: E402
from deepspeed_tpu_torch.models.llama import llama_config  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_plain,
)
from deepspeed_tpu_torch.ops.cuda.paged_attention import (  # noqa: E402
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from tests.test_torch_paged_kv import _tables  # noqa: E402

TOL = 1e-5
L, B, T, BS, NB, HKV, D = 2, 4, 4, 8, 16, 2, 16
MAX_LEN = T * BS


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# ----------------------------------------------------------- (a) the cache
def test_quantize_kv_tokens_bitwise():
    rng = np.random.default_rng(0)
    x = (2.0 * rng.standard_normal((4, 8, 2, 16))).astype(np.float32)
    x[1, 3, 0] = 0.0                                   # an all-zero row: scale 1
    jq, js = jax_kv.quantize_kv_tokens(jnp.asarray(x))
    q, s = port_kv.quantize_kv_tokens(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[1, 3, 0] == 1.0
    np.testing.assert_array_equal(port_kv.dequantize_kv(q, s).numpy(),
                                  np.asarray(jax_kv.dequantize_kv(jq, js)))


def _quantized_pools(rng):
    """int8 pools and scales in both packages' shapes: (JAX cache, port cache)."""
    k_pool = rng.integers(-127, 128, (L, HKV, NB, BS, D)).astype(np.int8)
    v_pool = rng.integers(-127, 128, (L, HKV, NB, BS, D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (L, HKV, NB, BS)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (L, HKV, NB, BS)).astype(np.float32)
    return k_pool, v_pool, ks, vs


def _caches(rng, tables, staged=False):
    k_pool, v_pool, ks, vs = _quantized_pools(rng)
    stage = [rng.standard_normal((L, B, HKV, D)).astype(np.float32) for _ in range(2)]
    jt = jnp.broadcast_to(jnp.asarray(tables)[None], (L,) + tables.shape)
    jcache = jax_kv.PagedKVCache(
        k=jax_kv.PagedLayer(pool=_j(k_pool), tables=jt, scales=_j(ks),
                            stage=_j(stage[0]) if staged else None),
        v=jax_kv.PagedLayer(pool=_j(v_pool), tables=jt, scales=_j(vs),
                            stage=_j(stage[1]) if staged else None),
        index=jnp.zeros((B,), jnp.int32))
    pcache = port_kv.PagedKVCache.create(L, B, MAX_LEN, HKV, D, num_blocks=NB,
                                         block_size=BS, dtype=torch.float32,
                                         device="cpu", staged=staged, quantized=True)
    assert pcache.quantized and pcache.k_blocks.dtype == torch.int8
    pcache.k_pool.copy_(_t(k_pool))
    pcache.v_pool.copy_(_t(v_pool))
    pcache._pool(pcache.k_scale_blocks).copy_(_t(ks))
    pcache._pool(pcache.v_scale_blocks).copy_(_t(vs))
    pcache.with_tables(tables)
    if staged:
        pcache.k_stage.copy_(_t(stage[0]))
        pcache.v_stage.copy_(_t(stage[1]))
    return jcache, pcache


def _jax_layer(jcache, i):
    return tuple(jax.tree_util.tree_map(lambda x: x[i], side) for side in (jcache.k, jcache.v))


def _assert_cache_equal(pcache, k_pools, v_pools, k_scales, v_scales):
    np.testing.assert_array_equal(pcache.k_pool.numpy(), np.stack(k_pools))
    np.testing.assert_array_equal(pcache.v_pool.numpy(), np.stack(v_pools))
    np.testing.assert_array_equal(pcache._pool(pcache.k_scale_blocks).numpy(),
                                  np.stack(k_scales))
    np.testing.assert_array_equal(pcache._pool(pcache.v_scale_blocks).numpy(),
                                  np.stack(v_scales))


@pytest.mark.parametrize("s,index,blocks", [
    (5, [0, 13, 5, MAX_LEN], [1, 2, 2, 0]),        # token scatter, -1 entry, parked row
    (BS, [0, 8, 16, MAX_LEN], [1, 2, 2, 0]),       # block scatter
])
def test_quantized_paged_writes_match_jax(s, index, blocks):
    rng = np.random.default_rng(s + sum(index))
    tables = _tables(rng, blocks)
    jcache, pcache = _caches(rng, tables)
    new_k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    new_v = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    out = [[], [], [], []]
    for i in range(L):
        jk, jv = jax_kv.update_layer(*_jax_layer(jcache, i), _j(new_k), _j(new_v),
                                     jnp.asarray(index, jnp.int32))
        for lst, x in zip(out, (jk.pool, jv.pool, jk.scales, jv.scales)):
            lst.append(np.asarray(x))
        pk, pv = port_kv.update_layer(*pcache.layer(i), _t(new_k), _t(new_v),
                                      torch.tensor(index, dtype=torch.int32))
        np.testing.assert_array_equal(port_kv.gather_paged_layer(pk).numpy(),
                                      np.asarray(jax_kv.gather_paged_layer(jk)))
    _assert_cache_equal(pcache, *out)


def test_quantized_apply_stage_matches_jax():
    """The staged f32 tokens quantize when `apply_stage` lands them: pools
    and scales exactly the JAX package's, parked row and -1 entry dropped."""
    rng = np.random.default_rng(7)
    tables = _tables(rng, [1, 2, 1, 0])
    jcache, pcache = _caches(rng, tables, staged=True)
    advanced = [1, 10, 9, MAX_LEN + 1]
    japplied = jcache.replace(index=jnp.asarray(advanced, jnp.int32)).apply_stage()
    pcache.replace(index=torch.tensor(advanced, dtype=torch.int32)).apply_stage()
    _assert_cache_equal(pcache, list(np.asarray(japplied.k.pool)),
                        list(np.asarray(japplied.v.pool)),
                        list(np.asarray(japplied.k.scales)),
                        list(np.asarray(japplied.v.scales)))
    assert pcache.k_stage.dtype == torch.float32       # the stage keeps its dtype


def test_quantized_dense_writes_and_truncate_match_jax():
    """Dense `QuantizedKVLayer` writes (one crossing the capacity, which
    drops), then a truncate rollback and an overwrite at the cursor."""
    rng = np.random.default_rng(8)
    m, b, s = 12, 3, 4
    jcache = jax_kv.KVCache.create(L, b, m, HKV, D, dtype=jnp.float32, quantized=True)
    pcache = port_kv.KVCache.create(L, b, m, HKV, D, dtype=torch.float32, quantized=True)
    assert pcache.quantized and pcache.max_len == m

    def write(jcache, pcache, index, seed):
        r = np.random.default_rng(seed)
        kn = r.standard_normal((b, s, HKV, D)).astype(np.float32)
        vn = r.standard_normal((b, s, HKV, D)).astype(np.float32)
        for i in range(L):
            jk, jv = jax_kv.update_layer(*_jax_layer(jcache, i), _j(kn), _j(vn),
                                         jnp.asarray(index, jnp.int32))
            jcache = jcache.replace(
                k=jax.tree_util.tree_map(lambda full, one: full.at[i].set(one), jcache.k, jk),
                v=jax.tree_util.tree_map(lambda full, one: full.at[i].set(one), jcache.v, jv))
            port_kv.update_layer(pcache.k[i], pcache.v[i], _t(kn), _t(vn),
                                 torch.tensor(index, dtype=torch.int32))
        for side_j, side_p in ((jcache.k, pcache.k), (jcache.v, pcache.v)):
            np.testing.assert_array_equal(side_p.data.numpy(), np.asarray(side_j.data))
            np.testing.assert_array_equal(side_p.scales.numpy(), np.asarray(side_j.scales))
        return jcache

    jcache = write(jcache, pcache, [0, 5, 10], 1)      # row 2 runs past the capacity
    rolled = [2, 3, 6]
    jcache = jcache.truncate(jnp.asarray(rolled, jnp.int32))
    pcache = pcache.truncate(rolled)
    assert pcache.index.tolist() == rolled == np.asarray(jcache.index).tolist()
    write(jcache, pcache, rolled, 2)


# --------------------------------------------------------- (b) the kernels
def _scaled(rng, shape):
    """Real int8 values with their scales, from quantizing normal values."""
    return jax_kv.quantize_kv_tokens(jnp.asarray(rng.standard_normal(shape), jnp.float32))


def test_decode_plain_int8_matches_jax_kernel():
    rng = np.random.default_rng(9)
    b, m, h, hkv, d = 3, 40, 8, 2, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    (kq, ks), (vq, vs) = _scaled(rng, (b, m, hkv, d)), _scaled(rng, (b, m, hkv, d))
    lengths = np.asarray([1, 17, 40], np.int32)
    ref = jax_decode(_j(q), kq, vq, _j(lengths), k_scales=ks, v_scales=vs)
    launches = decode_attention.launches_int8
    got = decode_attention(_t(q), _t(kq), _t(vq), _t(lengths), k_scales=_t(ks),
                           v_scales=_t(vs))
    assert decode_attention.launches_int8 == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("staged", [False, True])
def test_paged_decode_plain_int8_matches_jax_kernel(staged, window):
    b, hkv, n_rep, d, bs, t, nb = 4, 2, 4, 32, 8, 4, 12
    h = hkv * n_rep
    rng = np.random.default_rng(10 + 2 * staged + (window or 0))
    (kq, ks), (vq, vs) = _scaled(rng, (hkv, nb, bs, d)), _scaled(rng, (hkv, nb, bs, d))
    tables = _tables(rng, [1, 2, 3, 0], nb=nb, t=t)
    lengths = np.asarray([1, 9, 20, t * bs + 1], np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, d)).astype(np.float32) if staged else None
    vn = rng.standard_normal((b, hkv, d)).astype(np.float32) if staged else None
    ref = jax_paged_decode(_j(q), kq, vq, _j(tables), _j(lengths), k_new=_j(kn),
                           v_new=_j(vn), window=window, k_scales=ks, v_scales=vs)
    launches = paged_decode_attention.launches_int8
    got = paged_decode_attention(_t(q), _t(kq), _t(vq), _t(tables), _t(lengths),
                                 k_new=_t(kn), v_new=_t(vn), window=window,
                                 k_scales=_t(ks), v_scales=_t(vs))
    assert paged_decode_attention.launches_int8 == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_paged_prefill_plain_int8_matches_jax_kernel(window):
    b, s, hkv, n_rep, d, bs, t, nb = 4, 12, 2, 2, 32, 8, 4, 14
    h = hkv * n_rep
    rng = np.random.default_rng(20 + (window or 0))
    (kq, ks), (vq, vs) = _scaled(rng, (hkv, nb, bs, d)), _scaled(rng, (hkv, nb, bs, d))
    tables = _tables(rng, [2, 3, 3, 0], nb=nb, t=t)
    starts = np.asarray([0, 8, 5, t * bs], np.int32)
    rows = slice(None) if window is None else slice(0, 3)   # see test_torch_paged_kv
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ref = jax_paged_prefill(_j(q), kq, vq, _j(tables), _j(starts), block_q=4,
                            window=window, k_scales=ks, v_scales=vs)
    got = paged_prefill_attention(_t(q), _t(kq), _t(vq), _t(tables), _t(starts),
                                  window=window, k_scales=_t(ks), v_scales=_t(vs))
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unit_scales_equal_the_unquantized_plain_versions(dtype):
    """Integer-valued caches: int8 with unit scales against the same values
    in q's dtype, bit for bit, for K2, K3 (staged) and K4."""
    rng = np.random.default_rng(30)
    b, hkv, n_rep, d, bs, t, nb = 3, 2, 4, 16, 8, 3, 10
    h = hkv * n_rep
    ints = lambda shape: torch.from_numpy(rng.integers(-30, 30, shape).astype(np.int8))
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32)).to(dtype)

    kc, vc = ints((b, 24, hkv, d)), ints((b, 24, hkv, d))
    ones = torch.ones(kc.shape[:3])
    lengths = torch.tensor([3, 11, 24], dtype=torch.int32)
    assert torch.equal(decode_attention_plain(q, kc, vc, lengths, k_scales=ones, v_scales=ones),
                       decode_attention_plain(q, kc.to(dtype), vc.to(dtype), lengths))

    kp, vp = ints((hkv, nb, bs, d)), ints((hkv, nb, bs, d))
    ones = torch.ones(kp.shape[:3])
    tables = torch.from_numpy(_tables(rng, [1, 2, 3], nb=nb, t=t))
    kn = torch.from_numpy(rng.standard_normal((b, hkv, d)).astype(np.float32)).to(dtype)
    vn = torch.from_numpy(rng.standard_normal((b, hkv, d)).astype(np.float32)).to(dtype)
    got = paged_decode_attention_plain(q, kp, vp, tables, lengths.clamp(max=t * bs),
                                       k_new=kn, v_new=vn, k_scales=ones, v_scales=ones)
    ref = paged_decode_attention_plain(q, kp.to(dtype), vp.to(dtype), tables,
                                       lengths.clamp(max=t * bs), k_new=kn, v_new=vn)
    assert torch.equal(got, ref)

    qs = torch.from_numpy(rng.standard_normal((b, 5, h, d)).astype(np.float32)).to(dtype)
    starts = torch.tensor([0, 3, 9], dtype=torch.int32)
    assert torch.equal(
        paged_prefill_attention_plain(qs, kp, vp, tables, starts, window=4,
                                      k_scales=ones, v_scales=ones),
        paged_prefill_attention_plain(qs, kp.to(dtype), vp.to(dtype), tables, starts,
                                      window=4))


def test_cached_attention_int8_paths_on_the_cpu():
    """`cached_attention` over a quantized dense cache and a quantized paged
    layer takes the masked path and the plain versions on the dequantized
    values."""
    from deepspeed_tpu_torch.ops.attention import cached_attention, reference_attention
    rng = np.random.default_rng(31)
    cache = port_kv.KVCache.create(1, 2, 16, HKV, D, dtype=torch.float32, quantized=True)
    kn = torch.from_numpy(rng.standard_normal((2, 5, HKV, D)).astype(np.float32))
    index = torch.zeros(2, dtype=torch.int32)
    k, v = port_kv.update_layer(cache.k[0], cache.v[0], kn, kn * 0.5, index)
    q = torch.from_numpy(rng.standard_normal((2, 5, 4, D)).astype(np.float32))
    mask = port_kv.decode_mask(torch.arange(5)[None].expand(2, 5), 16)
    got = cached_attention(q, k, v, index, mask)
    ref = reference_attention(q, port_kv.dequantize_kv(k.data, k.scales),
                              port_kv.dequantize_kv(v.data, v.scales), causal=False,
                              segment_mask=mask)
    assert torch.equal(got, ref)


# ------------------------------------------------------------ (c) budget
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_kv_budget_matches_jax(kv_dtype):
    cfg, jcfg = llama_config("llama3-8b"), jax_llama_config("llama3-8b")
    for hbm, resident, max_len in ((80 << 30, 17 << 30, 4096), (16 << 30, 9 << 30, 1024),
                                   (8 << 30, 9 << 30, 512)):
        got = kbm.model_kv_budget(cfg, hbm_bytes=hbm, resident_bytes=resident,
                                  max_len=max_len, dtype=torch.bfloat16, kv_dtype=kv_dtype)
        ref = jax_kbm.model_kv_budget(jcfg, hbm_bytes=hbm, resident_bytes=resident,
                                      max_len=max_len, dtype=jnp.bfloat16, kv_dtype=kv_dtype)
        assert (got.max_batch, got.per_seq_kv_bytes, got.kv_dtype, got.available_bytes) == \
            (ref.max_batch, ref.per_seq_kv_bytes, ref.kv_dtype, ref.available_bytes)
    plain = kbm.kv_budget(hbm_bytes=100, resident_bytes=40, per_seq_kv_bytes=7)
    assert plain == kbm.KVBudget(100, 40, 7, "bf16", 8)
    int8 = kbm.model_kv_budget(cfg, hbm_bytes=80 << 30, resident_bytes=17 << 30,
                               max_len=4096, dtype=torch.bfloat16, kv_dtype="int8")
    dense = kbm.model_kv_budget(cfg, hbm_bytes=80 << 30, resident_bytes=17 << 30,
                                max_len=4096, dtype=torch.bfloat16)
    assert int8.max_batch >= int(1.9 * dense.max_batch)   # (D + 4) / 2D = 0.516
