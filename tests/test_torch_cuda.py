"""The port's CUDA kernels held against their plain PyTorch versions on the card.

Marked `cuda`: they skip without a CUDA device. This file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Shapes are ragged on purpose (tiles cut by the sequence end, Sq < Sk, both
head widths, every GQA group size; for the paged kernels, block tables with
-1 tails, a parked row, staged tokens and a sliding window); inputs are
bf16, and outputs must agree to 2e-2 (p and the output round at 2^-8 and
the outputs are O(1)); the backward's gradients are held to 2e-2 of their
largest magnitude. A tiny `train_batch` in bf16 on the card is held against
the same steps in f32 on the CPU.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    FlashAttention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("causal,sq,sk", [(True, 200, 200), (True, 77, 300),
                                          (False, 130, 90)])
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, causal, sq, sk, n_rep, d):
    """K1-bwd: dq and dk/dv against the plain backward, each launching once;
    dk/dv sum the GQA group inside the kernel."""
    hkv = 2
    rng = np.random.default_rng(sq + n_rep + d)
    q, k, v = (_bf16(x, cuda_device) for x in _qkv(rng, 2, sq, sk, hkv * n_rep, hkv, d))
    do = _bf16(rng.standard_normal(q.shape).astype(np.float32), cuda_device)
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    launches = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == \
        (launches[0] + 1, launches[1] + 1)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape and g.dtype == torch.bfloat16, name
        err = ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
        assert err <= BF16_TOL, (name, err)


@pytest.mark.cuda
def test_flash_function_grads_match_plain_on_card(cuda_device):
    """Autograd through `FlashAttention` on the card: the kernels' gradients
    against autograd through the plain forward."""
    rng = np.random.default_rng(7)
    q, k, v = (_bf16(x, cuda_device) for x in _qkv(rng, 2, 96, 96, 8, 2, 64))
    do = _bf16(rng.standard_normal(q.shape).astype(np.float32), cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(FlashAttention.apply(*leaves, True, None), leaves, do)
    ref = flash_attention_bwd_plain(q, k, v, *flash_attention_fwd_plain(q, k, v), do)
    for g, r in zip(got, ref):
        err = ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
        assert err <= BF16_TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["head_dim", "dtype"])
def test_flash_bwd_refuses_other_shapes_on_card(cuda_device, bad):
    """A CUDA backward outside the kernels' variants raises, with no launch."""
    d, dtype = {"head_dim": (96, torch.bfloat16), "dtype": (64, torch.float16)}[bad]
    q = torch.zeros((1, 16, 4, d), dtype=dtype, device=cuda_device)
    k = torch.zeros((1, 16, 2, d), dtype=dtype, device=cuda_device)
    lse = torch.zeros((1, 4, 16, 1), dtype=torch.float32, device=cuda_device)
    launches = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_bwd(q, k, k, q, lse, q)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_bwd_dq(q, k, k, q, lse, lse)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_bwd_dkv(q, k, k, q, lse, lse)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == launches


@pytest.mark.cuda
def test_train_batch_on_card_matches_cpu_f32(cuda_device):
    """Two `train_batch` steps of a 2-layer Llama with head dim 64 (the
    kernels' width): the card in bf16 (flash forward and backward kernels,
    remat on) against the CPU in f32 (plain versions) from the same
    weights. bf16 rounds at 2^-8 per op, so the loss is held to 1e-2 and
    the grad norm to 5e-2 relative."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import (
        LlamaForCausalLM, init_params, llama_config, llama_loss_fn)
    shape = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                 num_key_value_heads=2, remat=True)
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "gradient_clipping": 1.0}
    cpu_model = init_params(LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.float32,
                                                          **shape)),
                            torch.Generator().manual_seed(0))
    card_model = LlamaForCausalLM(llama_config("llama-tiny", dtype=torch.bfloat16, **shape))
    card_model.load_state_dict(cpu_model.state_dict())
    ids = np.random.default_rng(1).integers(0, 256, (2, 4, 128))
    results = []
    for model, cfg, device in ((card_model, dict(config, bf16={"enabled": True}), None),
                               (cpu_model, config, "cpu")):
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    loss_fn=llama_loss_fn(model), device=device)
        launches = (flash_attention_fwd.launches, flash_attention_bwd_dq.launches,
                    flash_attention_bwd_dkv.launches)
        steps = [(float(engine.train_batch(batch={"input_ids": b})),
                  engine.get_global_grad_norm()) for b in ids]
        results.append(steps)
        if device is None:   # 2 layers x 2 micros x 2 steps; remat runs the forward twice
            assert (flash_attention_fwd.launches - launches[0],
                    flash_attention_bwd_dq.launches - launches[1],
                    flash_attention_bwd_dkv.launches - launches[2]) == (16, 8, 8)
    for (card_loss, card_norm), (cpu_loss, cpu_norm) in zip(*results):
        assert abs(card_loss - cpu_loss) <= 1e-2 * abs(cpu_loss)
        assert abs(card_norm - cpu_norm) <= 5e-2 * abs(cpu_norm)
