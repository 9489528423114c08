"""The port's CUDA kernels held against their plain PyTorch versions on the card.

Marked `cuda`: they skip without a CUDA device. This file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Shapes are ragged on purpose (tiles cut by the sequence end, Sq < Sk, both
head widths, every GQA group size; for the paged kernels, block tables with
-1 tails, a parked row, staged tokens and a sliding window); inputs are
bf16, and outputs must agree to 2e-2 (p and the output round at 2^-8 and
the outputs are O(1)).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from deepspeed_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)

BF16_TOL = 2e-2


def _qkv(rng, b, sq, sk, h, hkv, d):
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _bf16(x, device):
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,sq,sk", [(True, 200, 200), (True, 77, 300),
                                          (False, 130, 90)])
def test_flash_kernel_matches_plain_on_card(cuda_device, causal, sq, sk, d):
    q, k, v = (_bf16(x, cuda_device) for x in
               _qkv(np.random.default_rng(sq), 2, sq, sk, 8, 2, d))
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


def _paged(rng, device, blocks_per_row, hkv, d, nb=20, bs=16, t=4):
    """Pools (Hkv, NB, BS, D) and tables (B, T): a seeded permutation of the
    pool handed out row by row, with -1 tails."""
    k = _bf16(rng.standard_normal((hkv, nb, bs, d)).astype(np.float32), device)
    v = _bf16(rng.standard_normal((hkv, nb, bs, d)).astype(np.float32), device)
    perm, used = rng.permutation(nb), 0
    tables = np.full((len(blocks_per_row), t), -1, np.int32)
    for row, n in enumerate(blocks_per_row):
        tables[row, :n] = perm[used:used + n]
        used += n
    return k, v, torch.from_numpy(tables).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_paged_decode_kernel_matches_plain_on_card(cuda_device, n_rep, d, staged, window):
    """K3: ragged lengths over several blocks, a row whose only key may be
    the staged one, and a parked row (cursor at the capacity, table -1)."""
    b, hkv, bs, t = 4, 2, 16, 4
    rng = np.random.default_rng(n_rep + d + staged)
    k, v, tables = _paged(rng, cuda_device, [1, 2, 3, 0], hkv, d, bs=bs, t=t)
    q = _bf16(rng.standard_normal((b, 1, hkv * n_rep, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor([1, 17, 40, t * bs + 1], dtype=torch.int32, device=cuda_device)
    new = [_bf16(rng.standard_normal((b, hkv, d)).astype(np.float32), cuda_device)
           for _ in range(2)] if staged else [None, None]
    launches = paged_decode_attention.launches
    out = paged_decode_attention(q, k, v, tables, lengths, k_new=new[0], v_new=new[1],
                                 window=window)
    ref = paged_decode_attention_plain(q, k, v, tables, lengths, k_new=new[0],
                                       v_new=new[1], window=window)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == launches + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_paged_prefill_kernel_matches_plain_on_card(cuda_device, n_rep, d, window):
    """K4: chunks of S = 37 (ragged tiles) at a start of 0, an aligned one,
    an unaligned one and a parked row; the causal stop and the window floor
    fall inside KV tiles."""
    b, s, hkv, bs, t = 4, 37, 2, 16, 4
    rng = np.random.default_rng(10 * n_rep + d)
    k, v, tables = _paged(rng, cuda_device, [3, 4, 4, 0], hkv, d, bs=bs, t=t)
    q = _bf16(rng.standard_normal((b, s, hkv * n_rep, d)).astype(np.float32), cuda_device)
    starts = torch.tensor([0, 16, 21, t * bs], dtype=torch.int32, device=cuda_device)
    launches = paged_prefill_attention.launches
    out = paged_prefill_attention(q, k, v, tables, starts, window=window)
    ref = paged_prefill_attention_plain(q, k, v, tables, starts, window=window)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == launches + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["head_dim", "group", "dtype"])
def test_paged_kernels_refuse_other_shapes_on_card(cuda_device, bad):
    """A CUDA call outside the kernels' variants raises; it never falls back
    to the plain version."""
    d, n_rep, dtype = {"head_dim": (96, 4, torch.bfloat16), "group": (64, 3, torch.bfloat16),
                       "dtype": (64, 4, torch.float32)}[bad]
    rng = np.random.default_rng(0)
    k, v, tables = _paged(rng, cuda_device, [1, 1], 2, d)
    k, v = k.to(dtype), v.to(dtype)
    q = torch.zeros((2, 1, 2 * n_rep, d), dtype=dtype, device=cuda_device)
    lengths = torch.tensor([3, 5], dtype=torch.int32, device=cuda_device)
    launches = (paged_decode_attention.launches, paged_prefill_attention.launches)
    with pytest.raises((ValueError, TypeError)):
        paged_decode_attention(q, k, v, tables, lengths)
    with pytest.raises((ValueError, TypeError)):
        paged_prefill_attention(q.expand(2, 4, -1, -1).contiguous(), k, v, tables, lengths)
    assert (paged_decode_attention.launches, paged_prefill_attention.launches) == launches


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_decode_kernel_matches_plain_on_card(cuda_device, n_rep, d):
    b, m, hkv = 4, 300, 2
    rng = np.random.default_rng(n_rep)
    q = _bf16(rng.standard_normal((b, 1, hkv * n_rep, d)).astype(np.float32), cuda_device)
    k = _bf16(rng.standard_normal((b, m, hkv, d)).astype(np.float32), cuda_device)
    v = _bf16(rng.standard_normal((b, m, hkv, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor([0, 1, 129, 300], dtype=torch.int32, device=cuda_device)
    out = decode_attention(q, k, v, lengths)
    ref = decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
