"""The port's CUDA kernels held against their plain PyTorch versions on the card.

Marked `cuda`: they skip without a CUDA device. This file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Shapes are ragged on purpose (tiles cut by the sequence end, Sq < Sk, both
head widths, every GQA group size); inputs are bf16, and outputs must agree
to 2e-2 (p and the output round at 2^-8 and the outputs are O(1)).
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
