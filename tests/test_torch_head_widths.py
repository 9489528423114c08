"""The attention kernels' plain versions at the zoo's head widths, 80 (phi-2)
and 256 (pythia-1b), held against the JAX Pallas kernels in interpret mode.

On the CPU each wrapper takes its plain version; the CUDA kernels at these
widths are held to the plain versions on the card (`tests/test_torch_cuda.py`).
Inputs come from numpy with a seed, in f32, and must agree to 1e-5 (the JAX
package's own interpret tolerance): K1-fwd (out and base-2 lse), K2 and
K2-int8, K3 and K3-int8 (staged and unstaged, with a window, a parked row)
and K4 and K4-int8 (with a window), each at a GQA group of one, the zoo's.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.inference import kv_cache as jax_kv  # noqa: E402
from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode  # noqa: E402
from deepspeed_tpu.ops.pallas.flash_attention import (  # noqa: E402
    LOG2E,
    _fwd as jax_flash_fwd,
    flash_attention as jax_flash,
)
from deepspeed_tpu.ops.pallas.paged_attention import (  # noqa: E402
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill,
)
from deepspeed_tpu_torch.ops.cuda.decode_attention import decode_attention  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.paged_attention import (  # noqa: E402
    paged_decode_attention,
    paged_prefill_attention,
)
from tests.test_torch_paged_kv import _tables  # noqa: E402

TOL = 1e-5
WIDTHS = [80, 256]


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cache(rng, shape, int8):
    """(values, k_scales or None): f32 normal values, or their int8
    quantization with per-row scales as the int8 caches store them."""
    x = _normal(rng, shape)
    if not int8:
        return x, None
    q, s = jax_kv.quantize_kv_tokens(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("causal,sq,sk", [(True, 32, 32), (True, 16, 40), (False, 24, 32)])
@pytest.mark.parametrize("d", WIDTHS)
def test_flash_fwd_plain_matches_jax_kernel_at_zoo_widths(d, causal, sq, sk):
    b, h, blk = 2, 2, 8
    rng = np.random.default_rng([d, sq, sk])
    q, k, v = _normal(rng, (b, sq, h, d)), _normal(rng, (b, sk, h, d)), _normal(rng, (b, sk, h, d))
    ref_out = jax_flash(_j(q), _j(k), _j(v), causal=causal, block_q=blk, block_k=blk)
    qs = jnp.swapaxes(_j(q), 1, 2) * (LOG2E / d ** 0.5)
    _, ref_lse = jax_flash_fwd(qs, jnp.swapaxes(_j(k), 1, 2), jnp.swapaxes(_j(v), 1, 2),
                               causal, blk, blk)
    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_decode_plain_matches_jax_kernel_at_zoo_widths(d, int8):
    b, m, h = 4, 48, 2
    rng = np.random.default_rng(10 + d + int8)
    q = _normal(rng, (b, 1, h, d))
    (k, ks), (v, vs) = _cache(rng, (b, m, h, d), int8), _cache(rng, (b, m, h, d), int8)
    lengths = np.asarray([0, 5, 17, 48], np.int32)
    ref = jax_decode(_j(q), _j(k), _j(v), _j(lengths), block_k=16, k_scales=_j(ks),
                     v_scales=_j(vs))
    counts = (decode_attention.launches, decode_attention.launches_int8)
    got = decode_attention(_t(q), _t(k), _t(v), _t(lengths), k_scales=_t(ks), v_scales=_t(vs))
    assert (decode_attention.launches, decode_attention.launches_int8) == counts
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_paged_decode_plain_matches_jax_kernel_at_zoo_widths(d, int8, staged, window):
    """Ragged lengths, a parked row (cursor at the capacity, table all -1),
    the staged token, a sliding window."""
    b, h, bs, t, nb = 4, 2, 8, 4, 12
    rng = np.random.default_rng(20 + d + 4 * int8 + 2 * staged + (window or 0))
    (k, ks), (v, vs) = _cache(rng, (h, nb, bs, d), int8), _cache(rng, (h, nb, bs, d), int8)
    tables = _tables(rng, [1, 2, 3, 0], nb=nb, t=t)
    lengths = np.asarray([1, 9, 20, t * bs + 1], np.int32)
    q = _normal(rng, (b, 1, h, d))
    kn = _normal(rng, (b, h, d)) if staged else None
    vn = _normal(rng, (b, h, d)) if staged else None
    ref = jax_paged_decode(_j(q), _j(k), _j(v), _j(tables), _j(lengths), k_new=_j(kn),
                           v_new=_j(vn), window=window, k_scales=_j(ks), v_scales=_j(vs))
    got = paged_decode_attention(_t(q), _t(k), _t(v), _t(tables), _t(lengths), k_new=_t(kn),
                                 v_new=_t(vn), window=window, k_scales=_t(ks),
                                 v_scales=_t(vs))
    assert got.shape == (b, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_paged_prefill_plain_matches_jax_kernel_at_zoo_widths(d, int8, window):
    """Chunks of S = 12 at starts 0, 8 (aligned) and 5 (unaligned) and a
    parked row, compared when there is no window (with one, a parked row's
    queries see no key and nobody reads them)."""
    b, s, h, bs, t, nb = 4, 12, 2, 8, 4, 14
    rng = np.random.default_rng(40 + d + 2 * int8 + (window or 0))
    (k, ks), (v, vs) = _cache(rng, (h, nb, bs, d), int8), _cache(rng, (h, nb, bs, d), int8)
    tables = _tables(rng, [2, 3, 3, 0], nb=nb, t=t)
    starts = np.asarray([0, 8, 5, t * bs], np.int32)
    q = _normal(rng, (b, s, h, d))
    ref = jax_paged_prefill(_j(q), _j(k), _j(v), _j(tables), _j(starts), block_q=4,
                            window=window, k_scales=_j(ks), v_scales=_j(vs))
    got = paged_prefill_attention(_t(q), _t(k), _t(v), _t(tables), _t(starts), window=window,
                                  k_scales=_t(ks), v_scales=_t(vs))
    rows = slice(None) if window is None else slice(0, 3)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows], rtol=TOL, atol=TOL)
