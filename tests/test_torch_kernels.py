"""The port's attention kernels and attention ops held against the JAX package's.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode. Both get the same numpy inputs, in
fp32, and must agree to 1e-5 (the JAX package's own interpret tolerance).
The masked attention paths, RMSNorm and RoPE are held to the same.
"""

import os

os.environ.setdefault("DS_TPU_PALLAS_INTERPRET", "1")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deepspeed_tpu.ops import attention as jax_attention  # noqa: E402
from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode  # noqa: E402
from deepspeed_tpu.ops.pallas.flash_attention import (  # noqa: E402
    LOG2E,
    _fwd as jax_flash_fwd,
    flash_attention as jax_flash,
)
from deepspeed_tpu_torch.ops import attention as port_attention  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.decode_attention import decode_attention  # noqa: E402
from deepspeed_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd  # noqa: E402

TOL = 1e-5

# (causal, sq, sk): the tri grid (sq == sk), the rect grid with an offset
# (sq < sk), and no mask
FLASH_CASES = [(True, 64, 64), (True, 32, 64), (False, 32, 48)]


def _qkv(rng, b, sq, sk, h, hkv, d):
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("causal,sq,sk", FLASH_CASES)
def test_flash_fwd_plain_matches_jax_kernel(causal, sq, sk, n_rep):
    b, h, d, blk = 2, 4, 32, 16
    q, k, v = _qkv(np.random.default_rng(sq + sk + n_rep), b, sq, sk, h, h // n_rep, d)
    scale = 1.0 / d ** 0.5
    ref_out = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, block_q=blk, block_k=blk)
    qs = (jnp.swapaxes(jnp.asarray(q), 1, 2) * (scale * LOG2E)).astype(jnp.float32)
    _, ref_lse = jax_flash_fwd(qs, jnp.swapaxes(jnp.asarray(k), 1, 2),
                               jnp.swapaxes(jnp.asarray(v), 1, 2), causal, blk, blk)
    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
    assert out.shape == (b, sq, h, d) and lse.shape == (b, h, sq, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_decode_plain_matches_jax_kernel(hkv):
    b, m, h, d = 4, 256, 4, 32
    rng = np.random.default_rng(hkv)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, m, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, m, hkv, d)).astype(np.float32)
    lengths = np.asarray([0, 7, 130, 256], np.int32)
    for row, n in enumerate(lengths):  # poison every slot past the length
        k[row, n:] = 1e4
        v[row, n:] = -1e4
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(lengths), block_k=64)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lengths))
    assert out.shape == (b, 1, h, d)
    assert not out[0].any()  # an empty row gives zeros
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["reference", "blockwise"])
@pytest.mark.parametrize("causal,window,alibi", [(True, None, False), (True, 5, False),
                                                 (True, None, True), (False, None, False)])
def test_masked_attention_paths_match_jax(impl, causal, window, alibi):
    """The masked paths a window, alibi or the CPU take: GQA, Sq < Sk, and
    for blockwise, tiles smaller than the sequences."""
    q, k, v = _qkv(np.random.default_rng(3), 2, 12, 20, 4, 2, 16)
    slopes = np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32) if alibi else None
    kw = dict(causal=causal, window=window)
    if impl == "blockwise":
        kw.update(block_q=4, block_k=8)
    jax_fn = getattr(jax_attention, f"{impl}_attention")
    port_fn = getattr(port_attention, f"{impl}_attention")
    ref = jax_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 alibi=None if slopes is None else jnp.asarray(slopes), **kw)
    got = port_fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  alibi=None if slopes is None else torch.from_numpy(slopes), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        port_attention.rms_norm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_attention.rms_norm_ref(jnp.asarray(x), jnp.asarray(w))),
        rtol=TOL, atol=TOL)
    pos = np.asarray([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]])
    for positions in (pos, pos[0]):  # per-row (B, S) and shared (S,)
        cos, sin = port_attention.rope_cos_sin(torch.from_numpy(positions), 16, 5e5)
        jcos, jsin = jax_attention.rope_cos_sin(jnp.asarray(positions), 16, 5e5)
        np.testing.assert_allclose(
            port_attention.apply_rotary_emb(torch.from_numpy(x), cos, sin).numpy(),
            np.asarray(jax_attention.apply_rotary_emb(jnp.asarray(x), jcos, jsin)),
            rtol=TOL, atol=TOL)


def test_cpu_wrappers_launch_nothing():
    """On the CPU the wrappers take the plain versions and count no launch."""
    f0, d0 = flash_attention_fwd.launches, decode_attention.launches
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(np.random.default_rng(0), 1, 8, 8, 2, 1, 16))
    flash_attention_fwd(q, k, v)
    decode_attention(q[:, :1], k, v, torch.tensor([5], dtype=torch.int32))
    assert (flash_attention_fwd.launches, decode_attention.launches) == (f0, d0)
