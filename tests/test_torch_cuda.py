"""The port's CUDA kernels held against their plain PyTorch versions on the card.

Marked `cuda`: they skip without a CUDA device. This file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Shapes are ragged on purpose (tiles cut by the sequence end, Sq < Sk, both
head widths, every GQA group size; for K1, sequences of one row, tiles
cut one short of and one past their edges and a grid of several waves,
its backward bitwise equal from call to call; for the paged kernels,
block tables with -1 tails, a parked row, staged tokens and a sliding
window; for the decode kernels K2 and K3, which split the KV axis into
chunks, lengths on and one past a chunk's edge and rows of 8,192 positions,
two calls bitwise equal); inputs are
bf16, and outputs must agree to 2e-2 (p and the output round at 2^-8 and
the outputs are O(1)); the backward's gradients are held to 2e-2 of their
largest magnitude. A tiny `train_batch` in bf16 on the card is held against
the same steps in f32 on the CPU. The fused dequant-GEMM (K5) is held to
2e-2 of its largest output at the Llama-3-8B projection shapes, on either
side of its decode/prefill boundary (M = 16, 17), at K = 7168 and at the odd
layouts, and two calls give the same bits; the paged prefill kernel (K4)
also at S = 300 over blocks of 16 (ragged 128-row tiles, a 128-key tile
over eight blocks), bf16 and int8, two calls bitwise equal; the int8
attention kernels to 2e-2 against their plain versions, and with unit
scales to their bf16 kernels bit for bit. The grouped expert
GEMM (K6) is held to 2e-2 of its largest output on ragged group layouts
(empty groups first, in the middle and last, one group holding every row,
decode-sized groups, M, K and N tails), and so are its backward kernels,
dlhs and drhs (an empty group's drhs slab must be exact zeros); in grad
mode K6's gradients equal plain autograd's to the same 2e-2, while the
kernels without a backward (K2-K5, K7 alone) refuse grad mode. The
block-sparse attention kernel (K7) is held to 2e-2 against its plain
version on causal and non-causal layouts, every block and head width, and
a causal row with no visible key (zeros); on rows whose lists cross the
diagonal mid-list, on a query block that walks every key block, on block
32's paired query blocks (different lists, a masked row beside a live
one, a tile past the sequence end), with its bits the same from call to
call and in either tile order; its autograd path's gradients
are held to 2e-2 of their largest magnitude against autograd of the gather
path. The paged kernels' alibi forms (K3-alibi, K4-alibi) are held to 2e-2
against their plain versions over bf16 and int8 pools at both head widths,
beside a control (the kernels without the slopes) that must miss; bad
slopes raise before a launch. The per-shard calls of tensor parallelism
(K8, tp = 2): each rank's slice of K2, K3 and K4 (bf16 and int8, staged
and not) equals the same heads of the unsharded kernel bit for bit, K5 'n'
on a column shard the unsharded columns (at M = 4, 100 and 2048: both of
its paths), and K5 'k''s partial products sum
to within 2e-2 of the unsharded product; a per-shard call on CPU tensors
under a topology that serves the card raises. The grouped GEMM's
expert-parallel flavour (K8-e, ep = 2 and 4): each rank's output equals the
unsharded K6's rows of its experts bit for bit and is zero elsewhere, the
ranks' sum equals K6's output bit for bit, and each is held to 2e-2 of its
largest output against its plain version. The data axis's collectives
(`reduce_scatter`, `all_gather_into`, `all_reduce` with SUM, AVG, MAX and
MIN) on CUDA tensors, from two gloo ranks sharing the card, equal the same
calls on CPU tensors, and so do ZeRO++'s quantized reduce-scatter and
all-gather and the 1-bit wire's compressed all-reduce. At the zoo's head
widths, 80 (phi-2) and 256 (pythia-1b): K1-fwd over every K1 shape at GQA
groups 1 and 4, K2, K3 (staged, windowed, long rows) and K4 (ragged tiles)
in bf16 and int8 at a group of one (K4 also at 4), each to 2e-2 and two
calls bitwise equal, the int8 forms with unit scales bitwise the bf16
kernels; K1-bwd over every K1 shape and group, two calls bitwise equal;
what is not built at those widths raises (groups above one on K2 and K3,
alibi); a 2-layer phi and GPT-NeoX serve through v1 and v2 with every
kernel launch counted, against the CPU in f32; and a 2-layer phi,
GPT-NeoX and BLOOM train two `train_batch` steps on the card, K1's
launches counted, against the CPU in f32.
"""

from dataclasses import replace as dataclasses_replace

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda.decode_attention import (
    decode_attention,
    decode_attention_plain,
    split_plan,
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
from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
    block_sparse_attention,
    block_sparse_attention_plain,
    padded_layout_indices,
)
from deepspeed_tpu_torch.ops.cuda.grouped_gemm import (
    grouped_gemm,
    grouped_gemm_dlhs,
    grouped_gemm_dlhs_plain,
    grouped_gemm_drhs,
    grouped_gemm_drhs_plain,
    grouped_gemm_plain,
)
from deepspeed_tpu_torch.ops.cuda.paged_attention import (
    decode_split_plan,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from deepspeed_tpu_torch.ops.cuda.quantized_matmul import (
    quantized_matmul,
    quantized_matmul_plain,
)
from deepspeed_tpu_torch.ops.quantization import quantize_int8_blockwise

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


# K1's shapes (B, causal, Sq, Sk): sequences of one row and key, tiles cut
# one short of and one past the 64-key tile and the 128-row block, a causal
# offset (Sk > Sq), Sq > Sk without a mask, and one shape whose grids run
# several waves of blocks on a 132-SM card
FLASH_SHAPES = [(2, True, 1, 1), (2, True, 1, 63), (2, True, 63, 63), (2, True, 65, 65),
                (2, True, 129, 129), (2, True, 200, 200), (2, True, 77, 300),
                (2, True, 65, 200), (2, False, 1, 1), (2, False, 130, 90),
                (2, False, 129, 65), (2, False, 63, 200), (2, False, 200, 1),
                (32, True, 700, 700)]


def _grad_err(g, r):
    """Largest error relative to the largest reference magnitude; where the
    gradient is zero up to rounding (a single key: ds = p*(dP - delta) with
    dP = delta), relative to the tolerance itself."""
    return ((g.float() - r.float()).abs().max()
            / r.float().abs().max().clamp_min(BF16_TOL)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("b,causal,sq,sk", FLASH_SHAPES)
def test_flash_kernel_matches_plain_on_card(cuda_device, b, causal, sq, sk, n_rep, d):
    hkv = 2
    rng = np.random.default_rng([b, sq, sk, n_rep, d])
    q, k, v = (_bf16(x, cuda_device) for x in _qkv(rng, b, sq, sk, hkv * n_rep, hkv, d))
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


# K3's block tables (B, T) over blocks of BS and their row lengths: "ragged"
# (a row whose only key may be the staged one, a parked row: cursor at the
# capacity, table -1), "chunk_edges" (pool lengths 0, 1, one chunk and one
# past it, staged or not) and "long" (T*BS = 8192: rows that split into many
# chunks, one whole and the parked row)
def _paged_case(case, staged):
    if case == "ragged":
        return 16, 4, 20, [1, 2, 3, 0], [1, 17, 40, 65]
    if case == "chunk_edges":
        chunk = decode_split_plan(4, 8, 2, 128, 16, 32)[0]
        pool = [0, 1, chunk, chunk + 1]
        return 16, 32, 64, [-(-n // 16) for n in pool], [n + int(staged) for n in pool]
    return 256, 32, 56, [32, 20, 1, 0], [8192, 5000, 200, 32 * 256 + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "chunk_edges", "long"])
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_paged_decode_kernel_matches_plain_on_card(cuda_device, n_rep, d, staged, window, case):
    """K3 over the tables of `_paged_case`; two calls give the same bits."""
    b, hkv = 4, 2
    bs, t, nb, blocks, lens = _paged_case(case, staged)
    rng = np.random.default_rng(n_rep + d + staged)
    k, v, tables = _paged(rng, cuda_device, blocks, hkv, d, nb=nb, bs=bs, t=t)
    q = _bf16(rng.standard_normal((b, 1, hkv * n_rep, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    new = [_bf16(rng.standard_normal((b, hkv, d)).astype(np.float32), cuda_device)
           for _ in range(2)] if staged else [None, None]
    launches = paged_decode_attention.launches
    out = paged_decode_attention(q, k, v, tables, lengths, k_new=new[0], v_new=new[1],
                                 window=window)
    again = paged_decode_attention(q, k, v, tables, lengths, k_new=new[0], v_new=new[1],
                                   window=window)
    ref = paged_decode_attention_plain(q, k, v, tables, lengths, k_new=new[0],
                                       v_new=new[1], window=window)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == launches + 2
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_kernel_long_rows_on_card(cuda_device, int8, alibi, window):
    """K3, K3-int8 and K3-alibi over T*BS = 8192 (`_paged_case`'s "long"
    tables, staged): rows that split into many chunks, with and without a
    window; two calls give the same bits."""
    from deepspeed_tpu_torch.ops.attention import alibi_slopes
    b, hkv, n_rep, d = 4, 2, 4, 128
    bs, t, nb, blocks, lens = _paged_case("long", True)
    rng = np.random.default_rng(100 + 2 * int8 + alibi)
    k, v, tables = _paged(rng, cuda_device, blocks, hkv, d, nb=nb, bs=bs, t=t)
    scales = {}
    if int8:
        k, ks, v, vs = _int8_pools(rng, cuda_device, hkv, nb, bs, d)
        scales = dict(k_scales=ks, v_scales=vs)
    q = _bf16(rng.standard_normal((b, 1, hkv * n_rep, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    kw = dict(k_new=_bf16(rng.standard_normal((b, hkv, d)).astype(np.float32), cuda_device),
              v_new=_bf16(rng.standard_normal((b, hkv, d)).astype(np.float32), cuda_device),
              window=window, alibi=alibi_slopes(hkv * n_rep, cuda_device) if alibi else None,
              **scales)
    out = paged_decode_attention(q, k, v, tables, lengths, **kw)
    again = paged_decode_attention(q, k, v, tables, lengths, **kw)
    ref = paged_decode_attention_plain(q, k, v, tables, lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert torch.equal(out, again)


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


def _prefill_ragged_inputs(rng, device, n_rep, d, int8):
    """K4 where its tiles end inside the data: chunks of S = 300 (a 128-row
    tile is ragged at every group size) over blocks of BS = 16 (a 128-key
    tile spans eight pool blocks), at starts 0, 16 and 37 and a parked row.
    Returns q, the pools, tables, starts and the int8 scales (or {})."""
    b, s, hkv, bs, t, nb = 4, 300, 2, 16, 24, 64
    k, v, tables = _paged(rng, device, [19, 20, 22, 0], hkv, d, nb=nb, bs=bs, t=t)
    scales = {}
    if int8:
        k, ks, v, vs = _int8_pools(rng, device, hkv, nb, bs, d)
        scales = dict(k_scales=ks, v_scales=vs)
    q = _bf16(rng.standard_normal((b, s, hkv * n_rep, d)).astype(np.float32), device)
    starts = torch.tensor([0, 16, 37, t * bs], dtype=torch.int32, device=device)
    return q, k, v, tables, starts, scales


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_paged_prefill_kernel_ragged_tiles_on_card(cuda_device, n_rep, d, int8, window):
    """K4 and K4-int8 at S = 300 and BS = 16 (`_prefill_ragged_inputs`)."""
    rng = np.random.default_rng(100 + 10 * n_rep + d + int8)
    q, k, v, tables, starts, scales = _prefill_ragged_inputs(rng, cuda_device, n_rep, d, int8)
    out = paged_prefill_attention(q, k, v, tables, starts, window=window, **scales)
    ref = paged_prefill_attention_plain(q, k, v, tables, starts, window=window, **scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_paged_prefill_kernel_is_deterministic_on_card(cuda_device, int8):
    """Two K4 (or K4-int8) calls on the same inputs give the same bits."""
    rng = np.random.default_rng(130 + int8)
    q, k, v, tables, starts, scales = _prefill_ragged_inputs(rng, cuda_device, 4, 128, int8)
    assert torch.equal(paged_prefill_attention(q, k, v, tables, starts, **scales),
                       paged_prefill_attention(q, k, v, tables, starts, **scales))


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


# K2's cache capacity M and row lengths: "ragged", "chunk_edges" (0, 1, one
# chunk and one past it) and "long" (M = 8192: rows that split many times)
def _dense_case(case):
    if case == "ragged":
        return 300, [0, 1, 129, 300]
    if case == "chunk_edges":
        chunk = split_plan(4, 300, 8, 2, 128)[0]
        return 300, [0, 1, chunk, chunk + 1]
    return 8192, [8192, 5000, 257, 1]


# (kernel, B, H, Hkv, D, BS, T): K2 (BS = 1, T = M) and K3 at the shapes
# they serve: Llama-3-8B v1, a long row, Llama-3-8B v2 traffic A,
# bloom-7b1 and bloom-560m v2
SERVING_SPLITS = [("k2", 4, 32, 8, 128, 1, 640), ("k2", 4, 64, 8, 128, 1, 8192),
                  ("k3", 64, 32, 8, 128, 256, 4), ("k3", 64, 32, 32, 128, 256, 4),
                  ("k3", 64, 16, 16, 64, 256, 4)]


def _split_plan(kernel, b, h, hkv, d, bs, t):
    return split_plan(b, bs * t, h, hkv, d) if kernel == "k2" else \
        decode_split_plan(b, h, hkv, d, bs, t)


@pytest.mark.cuda
@pytest.mark.parametrize("split", SERVING_SPLITS + [
    ("k2", 4, 8, 2, 64, 1, 0), ("k2", 4, 8, 2, 64, 1, 127), ("k2", 4, 8, 2, 64, 1, 128),
    ("k2", 4, 8, 2, 64, 1, 129), ("k3", 4, 8, 2, 64, 1, 1), ("k3", 4, 8, 2, 64, 16, 9)])
def test_decode_split_plan_on_card(cuda_device, split):
    """K2's and K3's split of the KV axis, from `ds_*_workspace`: its
    chunks cover every position once, it is the same for a tp = 2 shard
    (which needs half the workspace), and its workspace, at most 32 MiB at
    the serving shapes, is none at one chunk."""
    kernel, b, h, hkv, d, bs, t = split
    capacity = bs * t
    chunk, chunks, floats, counts = _split_plan(*split)
    assert chunks == max(1, -(-capacity // chunk))
    assert (chunks - 1) * chunk < max(capacity, 1) <= chunks * chunk
    half = _split_plan(kernel, b, h // 2, hkv // 2, d, bs, t)
    assert half == (chunk, chunks, floats // 2, counts // 2) and half[2] * 2 == floats
    assert (floats == 0 and counts == 0) == (chunks == 1)
    assert floats * 4 <= 32 << 20
    if split in SERVING_SPLITS:
        assert chunks > 1 and counts == b * hkv and floats >= b * hkv * chunks * h // hkv * d


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "chunk_edges", "long"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_decode_kernel_matches_plain_on_card(cuda_device, n_rep, d, case):
    """K2 over `_dense_case`'s rows; two calls give the same bits."""
    b, hkv = 4, 2
    m, lens = _dense_case(case)
    rng = np.random.default_rng(n_rep)
    q = _bf16(rng.standard_normal((b, 1, hkv * n_rep, d)).astype(np.float32), cuda_device)
    k = _bf16(rng.standard_normal((b, m, hkv, d)).astype(np.float32), cuda_device)
    v = _bf16(rng.standard_normal((b, m, hkv, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = decode_attention(q, k, v, lengths)
    again = decode_attention(q, k, v, lengths)
    ref = decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("b,causal,sq,sk", FLASH_SHAPES)
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, b, causal, sq, sk, n_rep, d):
    """K1-bwd: dq and dk/dv against the plain backward, each launching once;
    dk/dv sum the GQA group inside the kernel. At D = 80 the tiles are
    padded to 128 columns; at D = 256 dq takes one warpgroup a block and
    dk/dv's columns split over two warpgroups that share the keys."""
    hkv = 2
    rng = np.random.default_rng([b, sq, sk, n_rep, d, 1])
    q, k, v = (_bf16(x, cuda_device) for x in _qkv(rng, b, sq, sk, hkv * n_rep, hkv, d))
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
        err = _grad_err(g, r)
        assert err <= BF16_TOL, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_is_deterministic_on_card(cuda_device, causal, d):
    """K1-bwd gives the same bits on every call: dq and dk/dv each own their
    outputs and sum in a fixed order, with no atomics (remat re-runs the
    forward and must match a run without it)."""
    rng = np.random.default_rng(d + causal)
    q, k, v = (_bf16(x, cuda_device) for x in _qkv(rng, 4, 1000, 1000, 16, 2, d))
    do = _bf16(rng.standard_normal(q.shape).astype(np.float32), cuda_device)
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    first = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    for _ in range(3):
        again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        for name, a, g in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, g), name
    assert torch.equal(flash_attention_fwd(q, k, v, causal=causal)[0], out)


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
    """A CUDA backward outside the kernels' variants (D = 96 is not built)
    raises, with no launch."""
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


def _rel_max_err(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,block", [
    # the Llama-3-8B projections at decode (M = 4) and prefill (M = 2048)
    (4, 4096, 4096, 256), (4, 4096, 1024, 256), (4, 4096, 14336, 256),
    (4, 14336, 4096, 256), (2048, 4096, 14336, 256), (2048, 14336, 4096, 256),
    # either side of the decode/prefill boundary (M <= 16 splits K across
    # blocks), and K = 7168, whose split-K count differs from 4096's
    (16, 4096, 4096, 256), (17, 4096, 4096, 256), (4, 7168, 4096, 256),
    # blocks spanning rows; K, M and N remainders; groups of 64 and 96
    (4, 64, 128, 256), (16, 200, 384, 96), (5, 128, 384, 64), (40, 200, 384, 96),
    (77, 256, 200, 256 * 200 // 8),
])
def test_quantized_matmul_matches_plain_on_card(cuda_device, m, k, n, block):
    rng = np.random.default_rng(m + k + n)
    x = _bf16(rng.standard_normal((m, k)).astype(np.float32), cuda_device)
    w = torch.from_numpy(0.02 * rng.standard_normal((k, n)).astype(np.float32)).to(cuda_device)
    q, s = quantize_int8_blockwise(w, block)
    launches = quantized_matmul.launches
    out = quantized_matmul(x, q, s)
    ref = quantized_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert quantized_matmul.launches == launches + 1
    assert out.shape == (m, n) and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert _rel_max_err(out, ref) <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 14336, 4096), (16, 7168, 1024), (2048, 4096, 1024)])
def test_quantized_matmul_is_deterministic_on_card(cuda_device, m, k, n):
    """Two calls on the same inputs give the same bits: the decode path's
    K slices are summed in slice order, with no atomics."""
    rng = np.random.default_rng(m + k + n + 1)
    x = _bf16(rng.standard_normal((m, k)).astype(np.float32), cuda_device)
    w = torch.from_numpy(0.02 * rng.standard_normal((k, n)).astype(np.float32)).to(cuda_device)
    q, s = quantize_int8_blockwise(w, 256)
    assert torch.equal(quantized_matmul(x, q, s), quantized_matmul(x, q, s))


@pytest.mark.cuda
def test_quantized_matmul_prefill_tiles_keep_column_bits_on_card(cuda_device):
    """At M = 2048 a (1024, 4096) weight takes 256-row tiles and each half
    of its columns 128-row ones (fewer tiles than SMs); every column's bits
    are the same either way."""
    rng = np.random.default_rng(90)
    x = _bf16(rng.standard_normal((2048, 1024)).astype(np.float32), cuda_device)
    w = torch.from_numpy(0.02 * rng.standard_normal((1024, 4096)).astype(np.float32))
    q, s = quantize_int8_blockwise(w.to(cuda_device), 256)
    whole = quantized_matmul(x, q, s)
    for half in range(2):
        cols = slice(2048 * half, 2048 * (half + 1))
        qh, sh = quantize_int8_blockwise(w[:, cols].contiguous().to(cuda_device), 256)
        assert torch.equal(qh, q[:, cols])
        assert torch.equal(quantized_matmul(x, qh, sh), whole[:, cols])


@pytest.mark.cuda
def test_quantized_matmul_refuses_other_layouts_on_card(cuda_device):
    """A scale layout `scale_group_width` rejects, groups narrower than the
    kernel's 32-column tile, and a non-bf16 activation raise, with no launch."""
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=cuda_device)
    q = torch.zeros((64, 128), dtype=torch.int8, device=cuda_device)
    launches = quantized_matmul.launches
    with pytest.raises(ValueError, match="row-aligned"):
        quantized_matmul(torch.zeros((2, 3), dtype=torch.bfloat16, device=cuda_device),
                         torch.zeros((3, 5), dtype=torch.int8, device=cuda_device),
                         torch.ones(5, device=cuda_device))
    with pytest.raises(ValueError, match="multiple of 32"):
        quantized_matmul(x, q, torch.ones(64 * 128 // 16, device=cuda_device))
    with pytest.raises(TypeError):
        quantized_matmul(x.float(), q, torch.ones(64 * 128 // 256, device=cuda_device))
    assert quantized_matmul.launches == launches


@pytest.mark.cuda
def test_layer_scan_refuses_untiled_scales_on_card(cuda_device):
    """`group_size=4096` over a (256, 768) gate/up kernel gives scale blocks
    that straddle rows misaligned: the layer scan's fused products raise on
    the card instead of dequantizing in plain PyTorch."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama_config
    model = init_params(LlamaForCausalLM(llama_config(
        "llama-tiny", dtype=torch.bfloat16, hidden_size=256, intermediate_size=768)),
        torch.Generator().manual_seed(0))
    engine = deepspeed_tpu_torch.init_inference(
        model, dtype="bf16", quant={"enabled": True, "group_size": 4096},
        serve_mode="layer_scan")
    assert engine.serve_mode == "layer_scan" and engine._use_fused_int8()
    with pytest.raises(ValueError, match="row-aligned"):
        engine.generate(torch.zeros((1, 8), dtype=torch.long), max_new_tokens=2)


def _int8_pools(rng, device, hkv, nb, bs, d, unit=False):
    """int8 pools with (Hkv, NB, BS) scales: real ones from quantizing normal
    values, or unit scales over integer values."""
    from deepspeed_tpu_torch.ops.quantization import quantize_kv_tokens
    out = []
    for _ in range(2):
        if unit:
            vals = torch.from_numpy(rng.integers(-30, 30, (hkv, nb, bs, d)).astype(np.int8))
            out += [vals.to(device), torch.ones((hkv, nb, bs), device=device)]
        else:
            vals, sc = quantize_kv_tokens(torch.from_numpy(
                rng.standard_normal((hkv, nb, bs, d)).astype(np.float32)))
            out += [vals.to(device), sc.to(device)]
    return out          # k, k_scales, v, v_scales


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "chunk_edges", "long"])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_decode_int8_kernel_matches_plain_on_card(cuda_device, n_rep, case):
    """K2-int8 over `_dense_case`'s rows; two calls give the same bits."""
    b, hkv, d = 4, 2, 128
    m, lens = _dense_case(case)
    rng = np.random.default_rng(40 + n_rep)
    q = _bf16(rng.standard_normal((b, 1, hkv * n_rep, d)).astype(np.float32), cuda_device)
    k, ks, v, vs = _int8_pools(rng, cuda_device, b, m, hkv, d)   # (B, M, Hkv, D)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    launches = decode_attention.launches_int8
    out = decode_attention(q, k, v, lengths, k_scales=ks, v_scales=vs)
    again = decode_attention(q, k, v, lengths, k_scales=ks, v_scales=vs)
    ref = decode_attention_plain(q, k, v, lengths, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert decode_attention.launches_int8 == launches + 2
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_paged_int8_kernels_match_plain_on_card(cuda_device, n_rep, staged, window):
    """K3-int8 (staged, window, a parked row) and K4-int8 (window)."""
    b, hkv, bs, t, nb, d = 4, 2, 16, 4, 20, 128
    rng = np.random.default_rng(50 + n_rep + staged)
    k, ks, v, vs = _int8_pools(rng, cuda_device, hkv, nb, bs, d)
    _, _, tables = _paged(rng, cuda_device, [3, 4, 4, 0], hkv, d, nb=nb, bs=bs, t=t)
    scales = dict(k_scales=ks, v_scales=vs)
    q = _bf16(rng.standard_normal((b, 1, hkv * n_rep, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor([1, 17, 40, t * bs + 1], dtype=torch.int32, device=cuda_device)
    new = [_bf16(rng.standard_normal((b, hkv, d)).astype(np.float32), cuda_device)
           for _ in range(2)] if staged else [None, None]
    launches = (paged_decode_attention.launches_int8, paged_prefill_attention.launches_int8)
    out = paged_decode_attention(q, k, v, tables, lengths, k_new=new[0], v_new=new[1],
                                 window=window, **scales)
    ref = paged_decode_attention_plain(q, k, v, tables, lengths, k_new=new[0],
                                       v_new=new[1], window=window, **scales)
    qs = _bf16(rng.standard_normal((b, 37, hkv * n_rep, d)).astype(np.float32), cuda_device)
    starts = torch.tensor([0, 16, 21, t * bs], dtype=torch.int32, device=cuda_device)
    out_p = paged_prefill_attention(qs, k, v, tables, starts, window=window, **scales)
    ref_p = paged_prefill_attention_plain(qs, k, v, tables, starts, window=window, **scales)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches_int8, paged_prefill_attention.launches_int8) == \
        (launches[0] + 1, launches[1] + 1)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    rows = slice(None) if window is None else slice(0, 3)   # a windowed parked row sees no key
    torch.testing.assert_close(out_p[rows].float(), ref_p[rows].float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_int8_kernels_with_unit_scales_equal_bf16_kernels_on_card(cuda_device, n_rep):
    """Integer-valued caches: each int8 kernel with unit scales gives the
    bf16 kernel's output on the same values, bit for bit."""
    b, hkv, bs, t, nb, d = 4, 2, 16, 4, 20, 128
    rng = np.random.default_rng(60 + n_rep)
    k, ks, v, vs = _int8_pools(rng, cuda_device, hkv, nb, bs, d, unit=True)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    _, _, tables = _paged(rng, cuda_device, [3, 4, 4, 0], hkv, d, nb=nb, bs=bs, t=t)
    q = _bf16(rng.standard_normal((b, 1, hkv * n_rep, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor([1, 17, 40, t * bs + 1], dtype=torch.int32, device=cuda_device)
    kn, vn = (_bf16(rng.standard_normal((b, hkv, d)).astype(np.float32), cuda_device)
              for _ in range(2))
    for window in (None, 20):
        assert torch.equal(
            paged_decode_attention(q, k, v, tables, lengths, k_new=kn, v_new=vn,
                                   window=window, k_scales=ks, v_scales=vs),
            paged_decode_attention(q, kb, vb, tables, lengths, k_new=kn, v_new=vn,
                                   window=window))
        qs = _bf16(rng.standard_normal((b, 37, hkv * n_rep, d)).astype(np.float32),
                   cuda_device)
        starts = torch.tensor([0, 16, 21, t * bs], dtype=torch.int32, device=cuda_device)
        assert torch.equal(
            paged_prefill_attention(qs, k, v, tables, starts, window=window,
                                    k_scales=ks, v_scales=vs),
            paged_prefill_attention(qs, kb, vb, tables, starts, window=window))
    # K2 over dense (B, M, Hkv, D) integer caches
    kd, sd, vd, _ = _int8_pools(rng, cuda_device, b, 300, hkv, d, unit=True)
    lengths = torch.tensor([0, 1, 129, 300], dtype=torch.int32, device=cuda_device)
    assert torch.equal(decode_attention(q, kd, vd, lengths, k_scales=sd, v_scales=sd),
                       decode_attention(q, kd.to(torch.bfloat16), vd.to(torch.bfloat16),
                                        lengths))


@pytest.mark.cuda
def test_flash_and_decode_kernels_at_group_one_on_card(cuda_device):
    """K1-fwd and K2 at H = Hkv = 16, head dim 128: Qwen1.5-MoE's attention."""
    rng = np.random.default_rng(70)
    q, k, v = (_bf16(x, cuda_device) for x in _qkv(rng, 2, 200, 200, 16, 16, 128))
    out, _ = flash_attention_fwd(q, k, v, causal=True)
    ref, _ = flash_attention_fwd_plain(q, k, v, causal=True)
    lengths = torch.tensor([1, 200], dtype=torch.int32, device=cuda_device)
    q1 = q[:, :1].contiguous()
    dec = decode_attention(q1, k, v, lengths)
    dec_ref = decode_attention_plain(q1, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    torch.testing.assert_close(dec.float(), dec_ref.float(), rtol=BF16_TOL, atol=BF16_TOL)


def _sizes(rng, m, g):
    """Group sizes of m rows over g groups from a top-1 routing draw."""
    return np.bincount(rng.integers(0, g, m), minlength=g).astype(np.int32)


def _skewed(rng):
    """8,192 rows over 60 groups, the eighth holding 2,048 of them: more
    than 4x the mean group, so drhs splits its rows over several blocks."""
    return np.insert(_sizes(rng, 6144, 59), 7, 2048).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "empty_first_middle_last", "one_group_all_rows", "m5_scalar_path",
    "decode_60_groups", "prefill_8_groups", "rows_past_the_sizes", "skewed_60_groups",
    "group_over_256_rows", "k_not_multiple_of_64"])
def test_grouped_gemm_matches_plain_on_card(cuda_device, case):
    """K6 against its plain version relative to max |ref|; one launch a call.
    Rows past the sum of the sizes are zero in both."""
    rng = np.random.default_rng(len(case))
    sizes, k, n = {
        "empty_first_middle_last": ([0, 37, 0, 100, 0], 128, 200),
        "one_group_all_rows": ([0, 0, 300, 0], 64, 64),
        "m5_scalar_path": ([2, 0, 3], 20, 36),
        "decode_60_groups": (_sizes(rng, 16, 60), 2048, 1408),
        "prefill_8_groups": (_sizes(rng, 2048, 8), 512, 1408),
        "rows_past_the_sizes": ([10, 0, 20], 96, 72),
        "skewed_60_groups": (_skewed(rng), 256, 192),
        "group_over_256_rows": ([300, 600, 37], 128, 136),
        "k_not_multiple_of_64": ([40, 0, 90, 33], 200, 72),
    }[case]
    m = 50 if case == "rows_past_the_sizes" else int(np.sum(sizes))
    lhs = _bf16(rng.standard_normal((m, k)).astype(np.float32), cuda_device)
    rhs = _bf16(rng.standard_normal((len(sizes), k, n)).astype(np.float32), cuda_device)
    gs = torch.tensor(np.asarray(sizes, np.int32), device=cuda_device)
    launches = grouped_gemm.launches
    out = grouped_gemm(lhs, rhs, gs)
    ref = grouped_gemm_plain(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert grouped_gemm.launches == launches + 1
    assert out.shape == (m, n) and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert _rel_max_err(out, ref) <= BF16_TOL
    if case == "rows_past_the_sizes":
        assert (out[30:] == 0).all()


@pytest.mark.cuda
def test_grouped_gemm_refuses_other_operands_on_card(cuda_device):
    """A non-bf16 or non-contiguous operand, or int64 sizes, raise with no
    launch."""
    lhs = torch.zeros((8, 32), dtype=torch.bfloat16, device=cuda_device)
    rhs = torch.zeros((2, 32, 16), dtype=torch.bfloat16, device=cuda_device)
    gs = torch.tensor([3, 5], dtype=torch.int32, device=cuda_device)
    launches = grouped_gemm.launches
    with pytest.raises(TypeError):
        grouped_gemm(lhs.float(), rhs, gs)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_gemm(lhs, rhs.transpose(1, 2).contiguous().transpose(1, 2), gs)
    with pytest.raises(ValueError, match="int32"):
        grouped_gemm(lhs, rhs, gs.long())
    assert grouped_gemm.launches == launches


BWD_CASES = {   # group sizes, K, N
    "empty_first_middle_last": ([0, 37, 0, 100, 0], 128, 200),
    "one_group_all_rows": ([0, 0, 300, 0], 64, 64),
    "m5_scalar_path": ([2, 0, 3], 20, 36),
    "m_not_multiple_of_16": ([7, 19, 0, 11], 1408, 96),
    "decode_60_groups": (None, 2048, 1408),
    "prefill_8_groups": (None, 512, 1408),
    "skewed_60_groups": (None, 256, 192),   # drhs splits the hot group's rows
    "group_over_256_rows": ([300, 600, 37], 128, 136),
    "one_group_split_in_two": ([0, 0, 0, 700, 0, 0, 0, 0], 200, 136),
    "k_not_multiple_of_64": ([40, 0, 90, 33], 200, 72),
}


def _bwd_case(case, device):
    rng = np.random.default_rng(len(case) + 7)
    sizes, k, n = BWD_CASES[case]
    if sizes is None:
        sizes = {"decode_60_groups": lambda: _sizes(rng, 16, 60),
                 "prefill_8_groups": lambda: _sizes(rng, 2048, 8),
                 "skewed_60_groups": lambda: _skewed(rng)}[case]()
    m = int(np.sum(sizes))
    lhs = _bf16(rng.standard_normal((m, k)).astype(np.float32), device)
    rhs = _bf16(rng.standard_normal((len(sizes), k, n)).astype(np.float32), device)
    grad = _bf16(rng.standard_normal((m, n)).astype(np.float32), device)
    return lhs, rhs, grad, torch.tensor(np.asarray(sizes, np.int32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_grouped_gemm_bwd_matches_plain_on_card(cuda_device, case):
    """K6-bwd dlhs (M, K) and drhs (G, K, N) against their plain versions,
    relative to max |ref|; one launch each; empty groups' drhs slabs are
    exact zeros (the kernel writes them, `torch.empty` is not zeroed)."""
    lhs, rhs, grad, gs = _bwd_case(case, cuda_device)
    launches = (grouped_gemm_dlhs.launches, grouped_gemm_drhs.launches)
    dlhs = grouped_gemm_dlhs(grad, rhs, gs)
    drhs = grouped_gemm_drhs(lhs, grad, gs)
    ref_dlhs = grouped_gemm_dlhs_plain(grad, rhs, gs)
    ref_drhs = grouped_gemm_drhs_plain(lhs, grad, gs)
    torch.cuda.synchronize()
    assert (grouped_gemm_dlhs.launches, grouped_gemm_drhs.launches) == \
        (launches[0] + 1, launches[1] + 1)
    assert dlhs.shape == lhs.shape and drhs.shape == rhs.shape
    assert torch.isfinite(dlhs).all() and torch.isfinite(drhs).all()
    assert _rel_max_err(dlhs, ref_dlhs) <= BF16_TOL
    assert _rel_max_err(drhs, ref_drhs) <= BF16_TOL
    empty = (gs == 0).nonzero().flatten().tolist()
    assert all((drhs[g] == 0).all() for g in empty)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["skewed_60_groups", "one_group_split_in_two",
                                  "prefill_8_groups", "m5_scalar_path"])
def test_grouped_gemm_bwd_is_deterministic_on_card(cuda_device, case):
    """Two dlhs calls and two drhs calls on the same inputs give the same
    bits: every output element has one owner, and drhs sums a split group's
    ranges in a fixed order, with no atomics."""
    lhs, rhs, grad, gs = _bwd_case(case, cuda_device)
    dlhs = [grouped_gemm_dlhs(grad, rhs, gs) for _ in range(2)]
    drhs = [grouped_gemm_drhs(lhs, grad, gs) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(dlhs[0], dlhs[1])
    assert torch.equal(drhs[0], drhs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty_first_middle_last", "m_not_multiple_of_16"])
def test_grouped_gemm_grad_mode_matches_plain_autograd_on_card(cuda_device, case):
    """K6 in grad mode goes through `GroupedGemm`: its lhs and rhs
    gradients equal plain autograd through the f32 per-group products."""
    lhs, rhs, grad, gs = _bwd_case(case, cuda_device)
    a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    launches = (grouped_gemm.launches, grouped_gemm_dlhs.launches, grouped_gemm_drhs.launches)
    out = grouped_gemm(a, b, gs)
    out.backward(grad)
    assert (grouped_gemm.launches - launches[0], grouped_gemm_dlhs.launches - launches[1],
            grouped_gemm_drhs.launches - launches[2]) == (1, 1, 1)
    ra, rb = lhs.float().requires_grad_(), rhs.float().requires_grad_()
    rows, start = [], 0
    for g, size in enumerate(gs.tolist()):
        rows.append(ra[start:start + size] @ rb[g])
        start += size
    torch.cat(rows).backward(grad.float())
    torch.cuda.synchronize()
    assert _rel_max_err(a.grad, ra.grad) <= BF16_TOL
    assert _rel_max_err(b.grad, rb.grad) <= BF16_TOL


@pytest.mark.cuda
def test_kernels_without_backward_refuse_grad_mode_on_card(cuda_device):
    """K2, K3, K4, K5 (and K7 called alone) write through ctypes into a
    fresh tensor with no grad_fn; in grad mode with an input that requires
    grad they raise, with no launch. Under no_grad the same calls run."""
    from deepspeed_tpu_torch.ops.cuda.decode_attention import decode_attention as k2
    dev = cuda_device
    q1 = torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16, device=dev, requires_grad=True)
    cache = torch.zeros((1, 32, 2, 64), dtype=torch.bfloat16, device=dev)
    lengths = torch.tensor([5], dtype=torch.int32, device=dev)
    pool = torch.zeros((2, 4, 16, 64), dtype=torch.bfloat16, device=dev)
    tables = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    qs = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16, device=dev, requires_grad=True)
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=dev, requires_grad=True)
    wq, ws = quantize_int8_blockwise(torch.zeros((64, 128), device=dev), 64)
    s = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16, device=dev, requires_grad=True)
    idx, nlive = (torch.from_numpy(a).to(dev)
                  for a in padded_layout_indices(np.ones((4, 1, 1), bool)))
    calls = {
        "decode_attention": (k2, lambda: k2(q1, cache, cache, lengths)),
        "paged_decode_attention": (paged_decode_attention, lambda: paged_decode_attention(
            q1, pool, pool, tables, lengths)),
        "paged_prefill_attention": (paged_prefill_attention, lambda: paged_prefill_attention(
            qs, pool, pool, tables, torch.tensor([0], dtype=torch.int32, device=dev))),
        "quantized_matmul": (quantized_matmul, lambda: quantized_matmul(x, wq, ws)),
        "block_sparse_attention": (block_sparse_attention, lambda: block_sparse_attention(
            s, s, s, idx, nlive, 64)),
    }
    for name, (fn, call) in calls.items():
        launches = fn.launches
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no backward"):
            call()
        assert fn.launches == launches, name
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        assert fn.launches == launches + 1, name


def _sparse_layout(rng, h, n, causal, masked_row):
    layout = rng.random((h, n, n)) < 0.4
    layout[:, :, 0] = True
    if masked_row:   # head 0's first query block sees only the last key block
        layout[0, 0, :] = False
        layout[0, 0, n - 1] = True
    return layout


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_block_sparse_attention_matches_plain_on_card(cuda_device, causal, block, d):
    """K7 against its plain version on a random layout; with causal, a row
    whose only live block lies above it outputs exact zeros."""
    rng = np.random.default_rng(block + d + causal)
    b, s, h = 2, 4 * block, 3
    layout = _sparse_layout(rng, h, s // block, causal, masked_row=causal)
    idx, nlive = (torch.from_numpy(a).to(cuda_device) for a in padded_layout_indices(layout))
    q, k, v = (_bf16(rng.standard_normal((b, s, h, d)).astype(np.float32), cuda_device)
               for _ in range(3))
    launches = block_sparse_attention.launches
    out = block_sparse_attention(q, k, v, idx, nlive, block, causal)
    ref = block_sparse_attention_plain(q, k, v, idx, nlive, block, causal)
    torch.cuda.synchronize()
    assert block_sparse_attention.launches == launches + 1
    assert out.shape == q.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    if causal:
        assert (out[:, :block, 0] == 0).all()


def _sparse_run(layout, block, d, causal, device, seed, b=2):
    """K7 with and without the layout's tile order, and its plain version,
    on seeded bf16 inputs; the launches counted."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import tile_order
    rng = np.random.default_rng(seed)
    h, n = layout.shape[:2]
    idx, nlive = (torch.from_numpy(a).to(device) for a in padded_layout_indices(layout))
    order = torch.from_numpy(tile_order(layout, block)).to(device)
    q, k, v = (_bf16(rng.standard_normal((b, n * block, h, d)).astype(np.float32), device)
               for _ in range(3))
    launches = block_sparse_attention.launches
    outs = [block_sparse_attention(q, k, v, idx, nlive, block, causal, order=order),
            block_sparse_attention(q, k, v, idx, nlive, block, causal, order=order),
            block_sparse_attention(q, k, v, idx, nlive, block, causal)]
    ref = block_sparse_attention_plain(q, k, v, idx, nlive, block, causal)
    torch.cuda.synchronize()
    assert block_sparse_attention.launches == launches + 3
    for out in outs:
        assert out.shape == q.shape and torch.isfinite(out).all()
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block", [32, 64, 128])
def test_block_sparse_attention_is_deterministic_on_card(cuda_device, block, d):
    """Each tile walks its live blocks in order in one thread block: two
    calls give the same bits, and so does the natural tile order."""
    rng = np.random.default_rng(40 + block + d)
    outs = _sparse_run(_sparse_layout(rng, 3, 6, True, masked_row=True), block, d, True,
                       cuda_device, 41)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block", [32, 64, 128])
def test_block_sparse_attention_crosses_the_diagonal_mid_list_on_card(cuda_device, block, d):
    """Causal rows whose live lists run past their own block: entries below,
    the diagonal (masked inside), then entries above it, which the walk
    stops at; and a row whose list starts above it (zeros)."""
    n = 8
    layout = np.zeros((2, n, n), bool)
    for qi in range(n):
        layout[:, qi, [0, max(qi - 2, 0), qi, min(qi + 1, n - 1), n - 1]] = True
    layout[1, 3, :] = False
    layout[1, 3, [5, 6]] = True   # head 1's block 3 sees nothing
    outs = _sparse_run(layout, block, d, True, cuda_device, 50 + block + d)
    assert (outs[0][:, 3 * block:4 * block, 1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block,d", [(32, 64), (64, 128), (128, 128), (128, 64)])
def test_block_sparse_attention_long_row_on_card(cuda_device, block, d, causal):
    """A skewed layout: one query block a head holds every key block (the
    ring wraps many times in one tile, which runs first), the rest one or
    two."""
    n = 24 if block < 128 else 16
    layout = np.eye(n, dtype=bool)[None].repeat(2, 0)
    layout[:, :, 0] = True
    layout[0, n - 1, :] = True
    layout[1, n // 2, :] = True
    outs = _sparse_run(layout, block, d, causal, cuda_device, 60 + block + d, b=1)
    assert torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 7])
@pytest.mark.parametrize("d", [64, 128])
def test_block_sparse_attention_block32_pairs_on_card(cuda_device, d, n):
    """Block 32 tiles two query blocks: adjacent blocks with different live
    lists, one of them the fully masked row (exact zeros) beside a row that
    sees keys, one pair with disjoint lists; with n = 7 the last tile runs
    past the sequence."""
    layout = np.zeros((2, n, n), bool)
    layout[:, :, 0] = True
    layout[0, 0, :] = False
    layout[0, 0, n - 1] = True            # block 0 sees only a block above it
    layout[0, 1, [0, 1]] = True
    layout[0, 2, :] = False
    layout[0, 2, [1, 2]] = True           # blocks 2 and 3: disjoint lists
    layout[0, 3, [0, 3]] = True
    layout[1] |= np.tril(np.ones((n, n), bool))
    for causal in (True, False):
        outs = _sparse_run(layout, 32, d, causal, cuda_device, 70 + d + n)
        if causal:
            assert (outs[0][:, :32, 0] == 0).all()
            assert (outs[0][:, 32:64, 0] != 0).any()


@pytest.mark.cuda
def test_sparse_attention_grads_match_gather_path_on_card(cuda_device):
    """`SparseSelfAttention` on the card: the forward launches K7 once and
    its q/k/v gradients (the gather path's, recomputed) equal autograd of
    the gather path, relative to max |ref|."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, SparseSelfAttention, sparse_attention)
    rng = np.random.default_rng(11)
    cfg = BigBirdSparsityConfig(num_heads=4, block=64, attention="unidirectional")
    attn = SparseSelfAttention(cfg)
    q, k, v = (_bf16(rng.standard_normal((1, 512, 4, 128)).astype(np.float32),
                     cuda_device).requires_grad_() for _ in range(3))
    g = _bf16(rng.standard_normal((1, 512, 4, 128)).astype(np.float32), cuda_device)
    launches = block_sparse_attention.launches
    out = attn(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert block_sparse_attention.launches == launches + 1
    ref = sparse_attention(q, k, v, cfg.make_layout(512), block=64, causal=True,
                           impl="reference")
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    for got, want in zip(grads, ref_grads):
        assert _rel_max_err(got, want) <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["block_16", "head_dim_96", "float32"])
def test_sparse_attention_refuses_unsupported_shapes_on_card(cuda_device, bad):
    """`impl="auto"` on the card takes K7 or raises: no fallback to the
    gather path."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention
    block, d, dtype = {"block_16": (16, 64, torch.bfloat16),
                       "head_dim_96": (64, 96, torch.bfloat16),
                       "float32": (64, 64, torch.float32)}[bad]
    q = torch.zeros((1, 4 * block, 2, d), dtype=dtype, device=cuda_device)
    launches = block_sparse_attention.launches
    with pytest.raises((ValueError, TypeError)):
        sparse_attention(q, q, q, np.ones((2, 4, 4), bool), block=block)
    assert block_sparse_attention.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_paged_alibi_kernels_match_plain_on_card(cuda_device, n_rep, d, staged, int8):
    """K3-alibi (staged, a parked row) and K4-alibi over bf16 and int8
    pools, slopes of 16 heads at positions up to 63 (the bias stays in f32);
    alibi launches count in `.launches_alibi` only. The kernel run without
    the slopes must fail the same gate."""
    from deepspeed_tpu_torch.ops.attention import alibi_slopes
    b, hkv, bs, t, nb = 4, 16 // n_rep, 16, 4, 20
    h = hkv * n_rep
    rng = np.random.default_rng(70 + n_rep + d + staged + 2 * int8)
    k, v, tables = _paged(rng, cuda_device, [3, 4, 4, 0], hkv, d, nb=nb, bs=bs, t=t)
    scales = {}
    if int8:
        k, ks, v, vs = _int8_pools(rng, cuda_device, hkv, nb, bs, d)
        scales = dict(k_scales=ks, v_scales=vs)
    slopes = alibi_slopes(h, cuda_device)
    q = _bf16(rng.standard_normal((b, 1, h, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor([1, 17, 64, t * bs + 1], dtype=torch.int32, device=cuda_device)
    new = [_bf16(rng.standard_normal((b, hkv, d)).astype(np.float32), cuda_device)
           for _ in range(2)] if staged else [None, None]
    qs = _bf16(rng.standard_normal((b, 37, h, d)).astype(np.float32), cuda_device)
    starts = torch.tensor([0, 16, 21, t * bs], dtype=torch.int32, device=cuda_device)
    before = [(fn.launches, fn.launches_int8, fn.launches_alibi)
              for fn in (paged_decode_attention, paged_prefill_attention)]
    out = paged_decode_attention(q, k, v, tables, lengths, k_new=new[0], v_new=new[1],
                                 alibi=slopes, **scales)
    out_p = paged_prefill_attention(qs, k, v, tables, starts, alibi=slopes, **scales)
    after = [(fn.launches, fn.launches_int8, fn.launches_alibi)
             for fn in (paged_decode_attention, paged_prefill_attention)]
    assert after == [(n, n8, na + 1) for n, n8, na in before]
    ref = paged_decode_attention_plain(q, k, v, tables, lengths, k_new=new[0], v_new=new[1],
                                       alibi=slopes, **scales)
    ref_p = paged_prefill_attention_plain(qs, k, v, tables, starts, alibi=slopes, **scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    torch.testing.assert_close(out_p.float(), ref_p.float(), rtol=BF16_TOL, atol=BF16_TOL)
    # control: without the slopes the kernels miss the bias by far more
    no_bias = paged_decode_attention(q, k, v, tables, lengths, k_new=new[0], v_new=new[1],
                                     **scales)
    no_bias_p = paged_prefill_attention(qs, k, v, tables, starts, **scales)
    assert (no_bias.float() - ref.float()).abs().max() > BF16_TOL
    assert (no_bias_p.float() - ref_p.float()).abs().max() > BF16_TOL


@pytest.mark.cuda
def test_cached_attention_paged_alibi_launches_the_kernels_on_card(cuda_device):
    """A CUDA `cached_attention` on a paged layer with alibi: a prefill
    chunk and a staged decode step launch K4-alibi and K3-alibi."""
    from deepspeed_tpu_torch.inference.kv_cache import PagedKVCache, update_layer
    from deepspeed_tpu_torch.ops.attention import alibi_slopes, cached_attention
    h, d, bs = 8, 128, 16
    cache = PagedKVCache.create(1, 2, 64, h, d, num_blocks=8, block_size=bs,
                                device=cuda_device, staged=True)
    cache.with_tables(np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32))
    rng = np.random.default_rng(90)
    slopes = alibi_slopes(h, cuda_device)
    index = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    x = [_bf16(rng.standard_normal((2, 20, h, d)).astype(np.float32), cuda_device)
         for _ in range(3)]
    before = (paged_decode_attention.launches_alibi, paged_prefill_attention.launches_alibi)
    k, v = cache.replace(k_stage=None, v_stage=None).layer(0)
    k, v = update_layer(k, v, x[1], x[2], index)
    out = cached_attention(x[0], k, v, index, None, alibi=slopes)
    k, v = cache.layer(0)
    k, v = update_layer(k, v, x[1][:, :1], x[2][:, :1], index + 20)
    step = cached_attention(x[0][:, :1].contiguous(), k, v, index + 20, None, alibi=slopes)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches_alibi,
            paged_prefill_attention.launches_alibi) == (before[0] + 1, before[1] + 1)
    assert out.shape == x[0].shape and step.shape == (2, 1, h, d)
    assert torch.isfinite(out.float()).all() and torch.isfinite(step.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["shape", "float64", "bf16", "cpu", "strided"])
def test_paged_kernels_refuse_bad_slopes_on_card(cuda_device, bad):
    """Slopes must be a contiguous f32 (H,) tensor on q's device: anything
    else raises before a launch."""
    from deepspeed_tpu_torch.ops.attention import alibi_slopes
    h, d = 4, 64
    rng = np.random.default_rng(91)
    k, v, tables = _paged(rng, cuda_device, [1, 1], 2, d)
    q = _bf16(rng.standard_normal((2, 1, h, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor([3, 9], dtype=torch.int32, device=cuda_device)
    slopes = {"shape": alibi_slopes(h + 1, cuda_device),
              "float64": alibi_slopes(h, cuda_device).double(),
              "bf16": alibi_slopes(h, cuda_device).bfloat16(),
              "cpu": alibi_slopes(h),
              "strided": alibi_slopes(2 * h, cuda_device)[::2]}[bad]
    launches = (paged_decode_attention.launches_alibi, paged_prefill_attention.launches_alibi)
    with pytest.raises(ValueError, match="alibi"):
        paged_decode_attention(q, k, v, tables, lengths, alibi=slopes)
    with pytest.raises(ValueError, match="alibi"):
        paged_prefill_attention(q, k, v, tables, lengths - 1, alibi=slopes)
    assert (paged_decode_attention.launches_alibi,
            paged_prefill_attention.launches_alibi) == launches


# ------------------------------------------------- K8: per-shard calls, tp = 2
def _shard(x, axis, rank, tp=2):
    n = x.shape[axis] // tp
    return x.narrow(axis, rank * n, n).contiguous()


def _topologies(tp=2):
    from deepspeed_tpu_torch.utils.groups import MeshTopology
    return [MeshTopology(tp=tp, world_size=tp, rank=r, device="cuda") for r in range(tp)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_sharded_decode_attention_is_the_unsharded_heads_on_card(cuda_device, int8):
    """K8-a: each rank's head slice of K2 (H 32, Hkv 8 over tp = 2) equals
    the same heads of the unsharded kernel bit for bit, and its launches
    count on the per-shard wrapper."""
    from deepspeed_tpu_torch.ops.cuda.sharded import sharded_decode_attention
    from deepspeed_tpu_torch.ops.quantization import quantize_kv_tokens
    rng = np.random.default_rng(80)
    q = _bf16(rng.standard_normal((3, 1, 32, 128)).astype(np.float32), cuda_device)
    k = _bf16(rng.standard_normal((3, 300, 8, 128)).astype(np.float32), cuda_device)
    v = _bf16(rng.standard_normal((3, 300, 8, 128)).astype(np.float32), cuda_device)
    lengths = torch.tensor([1, 177, 300], dtype=torch.int32, device=cuda_device)
    kw = {}
    if int8:
        (k, ks), (v, vs) = quantize_kv_tokens(k), quantize_kv_tokens(v)
        kw = dict(k_scales=ks, v_scales=vs)
    whole = decode_attention(q, k, v, lengths, **kw)
    before = sharded_decode_attention.launches
    for r, topo in enumerate(_topologies()):
        local = {n: _shard(t, 2, r) for n, t in kw.items()}
        got = sharded_decode_attention(_shard(q, 2, r), _shard(k, 2, r), _shard(v, 2, r),
                                       lengths, topo, heads=(32, 8), **local)
        assert torch.equal(got, _shard(whole, 2, r))
    assert sharded_decode_attention.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 32])
@pytest.mark.parametrize("staged", [False, True])
def test_sharded_paged_kernels_are_the_unsharded_heads_on_card(cuda_device, staged, t):
    """K8-b/c: each rank's KV-head slice of the pools through K3 (staged or
    not) and K4 equals the same heads of the unsharded kernels bit for bit;
    at T = 32 (T*BS = 512) K3's rows split into several chunks."""
    from deepspeed_tpu_torch.ops.cuda.sharded import (
        sharded_paged_decode_attention, sharded_paged_prefill_attention)
    rng = np.random.default_rng(81)
    h, hkv, d = 32, 8, 128
    blocks, lens, nb = ([3, 1, 4, 0], [40, 9, 64, 65], 20) if t == 4 else \
        ([20, 3, 32, 0], [300, 40, 512, 513], 64)
    k_pool, v_pool, tables = _paged(rng, cuda_device, blocks, hkv, d, nb=nb, t=t)
    q1 = _bf16(rng.standard_normal((4, 1, h, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    stage = {}
    if staged:
        stage = {n: _bf16(rng.standard_normal((4, hkv, d)).astype(np.float32), cuda_device)
                 for n in ("k_new", "v_new")}
    whole = paged_decode_attention(q1, k_pool, v_pool, tables, lengths, **stage)
    q8 = _bf16(rng.standard_normal((4, 8, h, d)).astype(np.float32), cuda_device)
    starts = torch.tensor([30, 0, 50, 64] if t == 4 else [280, 30, 500, 512],
                          dtype=torch.int32, device=cuda_device)
    whole_prefill = paged_prefill_attention(q8, k_pool, v_pool, tables, starts)
    for r, topo in enumerate(_topologies()):
        kp, vp = _shard(k_pool, 0, r), _shard(v_pool, 0, r)
        local = {n: _shard(t, 1, r) for n, t in stage.items()}
        got = sharded_paged_decode_attention(_shard(q1, 2, r), kp, vp, tables, lengths, topo,
                                             **local)
        assert torch.equal(got, _shard(whole, 2, r))
        got = sharded_paged_prefill_attention(_shard(q8, 2, r), kp, vp, tables, starts, topo)
        assert torch.equal(got, _shard(whole_prefill, 2, r))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 100, 2048])
def test_sharded_quantized_matmul_flavours_on_card(cuda_device, m):
    """K8-d: 'n' on a column shard equals the unsharded columns bit for bit;
    'k' partial products on row shards sum to within 2e-2 of the unsharded
    product (one process: the all-reduce is the identity)."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import (
        quantized_matmul, sharded_quantized_matmul)
    from deepspeed_tpu_torch.ops.quantization import quantize_int8_blockwise
    from deepspeed_tpu_torch.utils.partitioning import shard_leaf
    rng = np.random.default_rng(82 + m)
    x = _bf16(rng.standard_normal((m, 1024)).astype(np.float32), cuda_device)
    w = torch.from_numpy((0.02 * rng.standard_normal((1024, 2048))).astype(np.float32))
    q, s = quantize_int8_blockwise(w.to(cuda_device), 256)
    leaf = {"__q8__": q, "scales": s}
    whole = quantized_matmul(x, q, s)
    launches = (sharded_quantized_matmul.launches_n, sharded_quantized_matmul.launches_k)
    parts = []
    for r in range(2):
        col = shard_leaf(leaf, 1, 2, r)
        got = sharded_quantized_matmul(x, col["__q8__"], col["scales"], "n")
        assert torch.equal(got, _shard(whole, 1, r))
        row = shard_leaf(leaf, 0, 2, r)
        parts.append(sharded_quantized_matmul(_shard(x, 1, r), row["__q8__"], row["scales"],
                                              "k"))
    assert _rel_max_err(parts[0] + parts[1], whole) <= BF16_TOL
    assert (sharded_quantized_matmul.launches_n, sharded_quantized_matmul.launches_k) == \
        (launches[0] + 2, launches[1] + 2)


@pytest.mark.cuda
def test_sharded_call_on_a_cpu_tensor_under_a_cuda_topology_raises(cuda_device):
    """A per-shard call under a topology that serves the card refuses CPU
    tensors instead of running their plain version."""
    from deepspeed_tpu_torch.ops.cuda.sharded import (
        sharded_decode_attention, sharded_paged_decode_attention)
    topo = _topologies()[0]
    q, cache = torch.zeros((1, 1, 16, 128)), torch.zeros((1, 64, 4, 128))
    lengths = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(ValueError, match="card"):
        sharded_decode_attention(q, cache, cache, lengths, topo)
    pool, tables = torch.zeros((4, 2, 16, 128)), torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="card"):
        sharded_paged_decode_attention(q, pool, pool, tables, lengths, topo)


@pytest.mark.cuda
@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("case", [
    "empty_at_the_span_edges", "decode_60_groups", "prefill_60_groups", "m5_scalar_path",
    "rows_past_the_sizes"])
def test_sharded_grouped_gemm_is_the_unsharded_rows_on_card(cuda_device, case, ep):
    """K8-e: each expert rank's output is K6's rows of its span, bit for
    bit, and zeros elsewhere; the ranks' sum is K6's output; each rank's
    output within 2e-2 of its plain version; one launch a call."""
    from deepspeed_tpu_torch.ops.cuda.grouped_gemm import (
        sharded_grouped_gemm,
        sharded_grouped_gemm_plain,
    )
    from deepspeed_tpu_torch.utils.groups import MeshTopology
    rng = np.random.default_rng(len(case) + ep)
    sizes, k, n = {
        "empty_at_the_span_edges": ([0, 37, 0, 0, 100, 0, 0, 41], 128, 200),
        "decode_60_groups": (_sizes(rng, 16, 60), 2048, 1408),
        "prefill_60_groups": (_sizes(rng, 2048, 60), 1408, 2048),
        "m5_scalar_path": ([2, 0, 0, 3], 20, 36),
        "rows_past_the_sizes": ([10, 0, 20, 4], 96, 72),
    }[case]
    m = 50 if case == "rows_past_the_sizes" else int(np.sum(sizes))
    e = len(sizes)
    el = e // ep
    lhs = _bf16(rng.standard_normal((m, k)).astype(np.float32), cuda_device)
    rhs = _bf16(rng.standard_normal((e, k, n)).astype(np.float32), cuda_device)
    gs = torch.tensor(np.asarray(sizes, np.int32), device=cuda_device)
    whole = grouped_gemm(lhs, rhs, gs)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    parts = []
    for r in range(ep):
        topo = MeshTopology(ep=ep, world_size=ep, rank=r, device="cuda")
        local = rhs[r * el:(r + 1) * el].contiguous()
        launches = sharded_grouped_gemm.launches
        out = sharded_grouped_gemm(lhs, local, gs, topo, reduce=False)
        torch.cuda.synchronize()
        assert sharded_grouped_gemm.launches == launches + 1
        lo, hi = int(starts[r * el]), int(starts[(r + 1) * el])
        assert torch.equal(out[lo:hi], whole[lo:hi]), r
        assert not out[:lo].any() and not out[hi:].any(), r
        ref = sharded_grouped_gemm_plain(lhs, local, gs, r * el)
        if hi > lo:
            assert _rel_max_err(out, ref) <= BF16_TOL
        parts.append(out)
    assert torch.equal(torch.stack(parts).sum(0), whole)


@pytest.mark.cuda
def test_sharded_grouped_gemm_refuses_cpu_tensors_under_a_card_topology(cuda_device):
    from deepspeed_tpu_torch.ops.cuda.grouped_gemm import sharded_grouped_gemm
    from deepspeed_tpu_torch.utils.groups import MeshTopology
    topo = MeshTopology(ep=2, world_size=2, rank=0, device="cuda")
    lhs = torch.zeros((8, 32), dtype=torch.bfloat16)
    rhs = torch.zeros((2, 32, 16), dtype=torch.bfloat16)
    gs = torch.tensor([3, 5, 0, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="rank's card"):
        sharded_grouped_gemm(lhs, rhs, gs, topo)


@pytest.mark.cuda
def test_data_collectives_on_card_match_the_cpu(cuda_device, tmp_path):
    """Two gloo ranks on the one card: each data-axis collective on CUDA
    tensors gives the bits the same call gives on CPU tensors."""
    from tests import torch_dp_ranks, torch_tp_ranks
    card = torch_tp_ranks.spawn(torch_dp_ranks.data_collectives_on_card,
                                tmp_path=tmp_path / "card")
    cpu = torch_tp_ranks.spawn(torch_dp_ranks.data_collectives, tmp_path=tmp_path / "cpu")
    for got, want in zip(card, cpu):
        assert got.keys() == want.keys()
        for key, value in want.items():
            if key.startswith("gather_into"):
                assert got[key][0] and value[0]
                torch.testing.assert_close(got[key][1], value[1], rtol=0, atol=0)
            elif isinstance(value, torch.Tensor):
                assert got[key].dtype == value.dtype, key
                torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)
            elif key != "stats":
                assert got[key] == value, key


@pytest.mark.cuda
def test_wire_collectives_on_card_match_the_cpu(cuda_device, tmp_path):
    """Two gloo ranks on the one card: ZeRO++'s quantized reduce-scatter
    (over either dim, both scale forms) and all-gather, and the 1-bit
    wire's compressed all-reduce, on CUDA tensors give the bits the same
    calls give on CPU tensors (gloo takes CUDA tensors for its all-to-all
    too)."""
    from tests import torch_dp_ranks, torch_tp_ranks
    card = torch_tp_ranks.spawn(torch_dp_ranks.wire_collectives_on_card,
                                tmp_path=tmp_path / "card")
    cpu = torch_tp_ranks.spawn(torch_dp_ranks.wire_collectives, tmp_path=tmp_path / "cpu")
    for got, want in zip(card, cpu):
        assert got.keys() == want.keys()
        for key, value in want.items():
            torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)


# The capacity serve mode (ZeRO-Inference): a Llama with every layer's
# leaves in page-locked host memory, streamed through two device slabs each
# pass. Hidden 1024, 8 heads of 128 over 2 KV heads, intermediate 2048, 4
# layers, vocab 32,000: rows of every int8 kernel are whole blocks of 256.
CAPACITY_SHAPE = dict(hidden_size=1024, num_attention_heads=8, num_key_value_heads=2,
                      intermediate_size=2048, num_hidden_layers=4, vocab_size=32000)


def _capacity_tree(seed=0):
    """(config, a JAX-layout Llama tree of numpy arrays in f32 with
    normal(0.02) kernels and embeddings)."""
    from deepspeed_tpu_torch.models.llama import (
        LlamaForCausalLM, init_params, llama_config, to_jax_params)
    cfg = llama_config("llama-tiny", dtype=torch.bfloat16, **CAPACITY_SHAPE)
    model = init_params(LlamaForCausalLM(cfg), torch.Generator().manual_seed(seed))
    return cfg, to_jax_params(model)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_capacity_generate_on_card(cuda_device, quant):
    """A meta module served from a numpy tree: the peak memory of a
    `generate` within 1.10x the plan, no layer leaf on the card between
    calls, K2 launched once a layer a decode step and (int8) K5 seven times
    a layer a model call, the synchronous mode's tokens and logits equal to
    the double-buffered mode's, and the tokens equal to the layer scan's
    (int8) or the module's own greedy tokens (bf16)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import capacity_scan
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, load_jax_params
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul
    cfg, tree = _capacity_tree()
    L, b, s, new = cfg.num_hidden_layers, 2, 100, 6
    kw = dict(dtype="bf16", quant={"enabled": True, "group_size": 256} if quant else None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = deepspeed_tpu_torch.init_inference(LlamaForCausalLM(cfg, device="meta"),
                                                params=tree, serve_mode="capacity", **kw)
    runner = engine._capacity
    assert engine.serve_mode == "capacity" and runner.host_resident()
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(1))
    k2, k5 = decode_attention.launches, quantized_matmul.launches
    out = engine.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    plan = runner.plan_for(b, s, new)
    assert peak <= 1.10 * plan.peak_hbm_bytes, (peak, plan)
    assert decode_attention.launches - k2 == L * (new - 1)
    assert quantized_matmul.launches - k5 == (7 * L * new if quant else 0)
    held = torch.cuda.memory_allocated() - base
    assert held <= plan.resident_bytes + 2 * runner._buf_bytes + (8 << 20), held
    assert runner.host_resident()
    for layer in engine.params["layers"]:
        for _, leaf in capacity_scan._flatten(layer):
            assert leaf.device.type == "cpu" and leaf.is_pinned()
    assert engine.serving_stats()["prefetch_stall_ms"] >= 0.0
    logits = engine.forward(out[:, :-1])
    sync = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(cfg, device="meta"), params=tree, serve_mode="capacity",
        capacity={"double_buffer": False}, **kw)
    assert torch.equal(sync.generate(ids, max_new_tokens=new), out)
    assert torch.equal(sync.forward(out[:, :-1]), logits)
    if quant:
        scan = deepspeed_tpu_torch.init_inference(LlamaForCausalLM(cfg, device="meta"),
                                                  params=tree, serve_mode="layer_scan", **kw)
        ref = scan.generate(ids, max_new_tokens=new)
    else:
        model = load_jax_params(LlamaForCausalLM(cfg), tree)
        ref = deepspeed_tpu_torch.init_inference(model, dtype="bf16").generate(
            ids, max_new_tokens=new)
        # two bf16 paths (cuBLAS on transposed weights, the layer scan's on
        # its kernels) may part at a near tie: the first tokens agree
        ref, out = ref[:, :s + 2], out[:, :s + 2]
    assert torch.equal(out.cpu(), ref.cpu())


@pytest.mark.cuda
def test_capacity_nvme_and_v2_on_card(cuda_device, tmp_path):
    """Two layers on NVMe give the RAM tier's tokens; v2 `capacity` on slot
    rows gives v2 `layer_scan`'s tokens over the same int8 tree, with K2 a
    layer a decode step and K5 seven times a layer a model call."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul
    cfg, tree = _capacity_tree(3)
    L = cfg.num_hidden_layers
    ids = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(4))
    ram = deepspeed_tpu_torch.init_inference(LlamaForCausalLM(cfg, device="meta"), params=tree,
                                             dtype="bf16", serve_mode="capacity")
    disk = deepspeed_tpu_torch.init_inference(
        LlamaForCausalLM(cfg, device="meta"), params=tree, dtype="bf16", serve_mode="capacity",
        capacity={"nvme_dir": str(tmp_path), "nvme_layers": 2})
    assert disk._capacity.plan.nvme_layers == 2 and len(disk._capacity._ram) == L - 2
    want = ram.generate(ids, max_new_tokens=5)
    for _ in range(2):
        assert torch.equal(disk.generate(ids, max_new_tokens=5), want)
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in (37, 20, 9)]
    quant = {"enabled": True, "group_size": 256}
    got = {}
    for mode in ("layer_scan", "capacity"):
        eng = InferenceEngineV2(LlamaForCausalLM(cfg, device="meta"), params=tree,
                                serve_mode=mode, quant=quant, max_batch=2, max_seq_len=128,
                                split_fuse_chunk=16)
        assert eng.kv_layout == "slot"
        k2, k5 = decode_attention.launches, quantized_matmul.launches
        got[mode] = eng.generate(prompts, max_new_tokens=6)
        assert decode_attention.launches > k2 and (quantized_matmul.launches - k5) % (7 * L) == 0
    assert got["capacity"] == got["layer_scan"]


# The zoo's head widths: 80 (phi-2) and 256 (pythia-1b), each served at a
# GQA group of one; K1-fwd and K4 also take larger groups there
ZOO_WIDTHS = [80, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("d", ZOO_WIDTHS)
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("b,causal,sq,sk", FLASH_SHAPES)
def test_flash_kernel_at_zoo_widths_matches_plain_on_card(cuda_device, b, causal, sq, sk,
                                                          n_rep, d):
    """K1-fwd at D = 80 (tiles padded to 128 columns) and D = 256 (one
    warpgroup a block) over `FLASH_SHAPES`; two calls give the same bits."""
    hkv = 2
    rng = np.random.default_rng([b, sq, sk, n_rep, d])
    q, k, v = (_bf16(x, cuda_device) for x in _qkv(rng, b, sq, sk, hkv * n_rep, hkv, d))
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    again, _ = flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "chunk_edges", "long"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", ZOO_WIDTHS)
def test_decode_kernel_at_zoo_widths_matches_plain_on_card(cuda_device, d, int8, case):
    """K2 and K2-int8 at H = Hkv over `_dense_case`'s rows; two calls give
    the same bits."""
    b, h = 4, 2
    m, lens = _dense_case(case)
    rng = np.random.default_rng(200 + d + int8)
    q = _bf16(rng.standard_normal((b, 1, h, d)).astype(np.float32), cuda_device)
    if int8:
        k, ks, v, vs = _int8_pools(rng, cuda_device, b, m, h, d)
        kw = dict(k_scales=ks, v_scales=vs)
    else:
        k, v = (_bf16(rng.standard_normal((b, m, h, d)).astype(np.float32), cuda_device)
                for _ in range(2))
        kw = {}
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out = decode_attention(q, k, v, lengths, **kw)
    again = decode_attention(q, k, v, lengths, **kw)
    ref = decode_attention_plain(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "chunk_edges", "long"])
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", ZOO_WIDTHS)
def test_paged_decode_kernel_at_zoo_widths_matches_plain_on_card(cuda_device, d, int8, staged,
                                                                 window, case):
    """K3 and K3-int8 at H = Hkv over `_paged_case`'s tables, staged and
    not, with and without a window; two calls give the same bits."""
    b, h = 4, 2
    bs, t, nb, blocks, lens = _paged_case(case, staged)
    rng = np.random.default_rng(300 + d + 2 * int8 + staged)
    k, v, tables = _paged(rng, cuda_device, blocks, h, d, nb=nb, bs=bs, t=t)
    kw = {}
    if int8:
        k, ks, v, vs = _int8_pools(rng, cuda_device, h, nb, bs, d)
        kw = dict(k_scales=ks, v_scales=vs)
    q = _bf16(rng.standard_normal((b, 1, h, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    if staged:
        kw.update(k_new=_bf16(rng.standard_normal((b, h, d)).astype(np.float32), cuda_device),
                  v_new=_bf16(rng.standard_normal((b, h, d)).astype(np.float32), cuda_device))
    out = paged_decode_attention(q, k, v, tables, lengths, window=window, **kw)
    again = paged_decode_attention(q, k, v, tables, lengths, window=window, **kw)
    ref = paged_decode_attention_plain(q, k, v, tables, lengths, window=window, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", ZOO_WIDTHS)
@pytest.mark.parametrize("n_rep", [1, 4])
def test_paged_prefill_kernel_at_zoo_widths_matches_plain_on_card(cuda_device, n_rep, d, int8,
                                                                  window):
    """K4 and K4-int8 at D = 80 and 256 over `_prefill_ragged_inputs` (S =
    300 over blocks of 16: 128-key tiles at 80, 32-key tiles at 256); two
    calls give the same bits."""
    rng = np.random.default_rng(400 + 10 * n_rep + d + int8)
    q, k, v, tables, starts, scales = _prefill_ragged_inputs(rng, cuda_device, n_rep, d, int8)
    out = paged_prefill_attention(q, k, v, tables, starts, window=window, **scales)
    again = paged_prefill_attention(q, k, v, tables, starts, window=window, **scales)
    ref = paged_prefill_attention_plain(q, k, v, tables, starts, window=window, **scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", ZOO_WIDTHS)
def test_int8_kernels_at_zoo_widths_with_unit_scales_equal_bf16_on_card(cuda_device, d):
    """Integer-valued caches at D = 80 and 256: K2-int8, K3-int8 (staged)
    and K4-int8 with unit scales give their bf16 kernels' outputs bit for
    bit."""
    b, h, bs, t, nb = 4, 2, 16, 4, 20
    rng = np.random.default_rng(500 + d)
    k, ks, v, vs = _int8_pools(rng, cuda_device, h, nb, bs, d, unit=True)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    _, _, tables = _paged(rng, cuda_device, [3, 4, 4, 0], h, d, nb=nb, bs=bs, t=t)
    q = _bf16(rng.standard_normal((b, 1, h, d)).astype(np.float32), cuda_device)
    lengths = torch.tensor([1, 17, 40, t * bs + 1], dtype=torch.int32, device=cuda_device)
    kn, vn = (_bf16(rng.standard_normal((b, h, d)).astype(np.float32), cuda_device)
              for _ in range(2))
    for window in (None, 20):
        assert torch.equal(
            paged_decode_attention(q, k, v, tables, lengths, k_new=kn, v_new=vn,
                                   window=window, k_scales=ks, v_scales=vs),
            paged_decode_attention(q, kb, vb, tables, lengths, k_new=kn, v_new=vn,
                                   window=window))
        qs = _bf16(rng.standard_normal((b, 37, h, d)).astype(np.float32), cuda_device)
        starts = torch.tensor([0, 16, 21, t * bs], dtype=torch.int32, device=cuda_device)
        assert torch.equal(
            paged_prefill_attention(qs, k, v, tables, starts, window=window,
                                    k_scales=ks, v_scales=vs),
            paged_prefill_attention(qs, kb, vb, tables, starts, window=window))
    kd, sd, vd, _ = _int8_pools(rng, cuda_device, b, 300, h, d, unit=True)
    lengths = torch.tensor([0, 1, 129, 300], dtype=torch.int32, device=cuda_device)
    assert torch.equal(decode_attention(q, kd, vd, lengths, k_scales=sd, v_scales=sd),
                       decode_attention(q, kd.to(torch.bfloat16), vd.to(torch.bfloat16),
                                        lengths))


@pytest.mark.cuda
@pytest.mark.parametrize("d", ZOO_WIDTHS)
def test_zoo_widths_refuse_what_is_not_built_on_card(cuda_device, d):
    """At D = 80 and 256: K2 and K3 at a GQA group of 4, and alibi on K3
    and K4, raise before a launch; nothing falls back. (The flash backward
    is built at both widths: `test_flash_bwd_kernels_match_plain_on_card`.)"""
    from deepspeed_tpu_torch.ops.attention import alibi_slopes
    rng = np.random.default_rng(600 + d)
    k, v, tables = _paged(rng, cuda_device, [1, 1], 2, d)
    lengths = torch.tensor([3, 5], dtype=torch.int32, device=cuda_device)
    q4 = torch.zeros((2, 1, 8, d), dtype=torch.bfloat16, device=cuda_device)
    q1 = torch.zeros((2, 1, 2, d), dtype=torch.bfloat16, device=cuda_device)
    counts = lambda: (decode_attention.launches, paged_decode_attention.launches,  # noqa: E731
                      paged_prefill_attention.launches, paged_decode_attention.launches_alibi,
                      paged_prefill_attention.launches_alibi)
    before = counts()
    dense = torch.zeros((2, 16, 2, d), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="group sizes"):
        decode_attention(q4, dense, dense, lengths)
    with pytest.raises(ValueError, match="group sizes"):
        paged_decode_attention(q4, k, v, tables, lengths)
    slopes = alibi_slopes(2, cuda_device)
    with pytest.raises(ValueError, match="alibi"):
        paged_decode_attention(q1, k, v, tables, lengths, alibi=slopes)
    with pytest.raises(ValueError, match="alibi"):
        paged_prefill_attention(q1.expand(2, 4, -1, -1).contiguous(), k, v, tables, lengths,
                                alibi=slopes)
    assert counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["phi", "gptneox"])
def test_zoo_model_serves_through_the_kernels_on_card(cuda_device, family):
    """A 2-layer phi (heads of 80) and GPT-NeoX (heads of 256) in bf16 on
    the card: v1 `forward` (K1-fwd) and greedy `generate` (K2) and v2 paged
    traffic (K4, K3), each launch counted, against the same weights in f32 on the CPU
    (relative RMS error of the logits <= 0.04, as `chip_smoke.py`'s
    `reference`)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    if family == "phi":
        from deepspeed_tpu_torch.models.phi import init_phi as init, phi_config as config
        cfg = config("phi-2", num_hidden_layers=2, hidden_size=320, intermediate_size=1280,
                     num_attention_heads=4, num_key_value_heads=4, vocab_size=512)
    else:
        from deepspeed_tpu_torch.models.gptneox import gptneox_config as config
        from deepspeed_tpu_torch.models.gptneox import init_gptneox as init
        cfg = config("pythia-1b", num_hidden_layers=2, hidden_size=512,
                     intermediate_size=2048, num_attention_heads=2, vocab_size=512)
    gpu_model = init(cfg, torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device,
                     dtype=torch.bfloat16)
    cpu_model = init(dataclasses_replace(cfg, dtype=torch.float32), torch.Generator(),
                     device="cpu")
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in gpu_model.state_dict().items()})
    gpu = deepspeed_tpu_torch.init_inference(gpu_model, dtype="bf16")
    cpu = deepspeed_tpu_torch.init_inference(cpu_model, dtype="fp32", device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    counts = lambda: (flash_attention_fwd.launches, decode_attention.launches,  # noqa: E731
                      paged_prefill_attention.launches, paged_decode_attention.launches)
    before = counts()
    out = gpu.generate(ids, max_new_tokens=6)
    torch.cuda.synchronize()
    # the cached prefill takes the masked path; each of the 5 decode steps K2
    assert counts() == (before[0], before[1] + 2 * 5, before[2], before[3])
    assert gpu.forward(ids).shape == (2, 40, cfg.vocab_size)
    assert flash_attention_fwd.launches == before[0] + 2
    ref = cpu.forward(out[:, :-1].cpu())
    err = ((gpu.forward(out[:, :-1]).float().cpu() - ref).norm() / ref.norm()).item()
    assert err <= 0.04, err
    v2 = InferenceEngineV2(gpu_model, max_batch=4, max_seq_len=128, cache_block_size=16,
                           num_cache_blocks=32)
    assert v2.kv_layout == "paged"
    before = counts()
    got = v2.generate([ids[0].tolist(), ids[1, :25].tolist()], max_new_tokens=4)
    torch.cuda.synchronize()
    after = counts()
    assert after[0] == before[0] and after[1] == before[1]
    assert after[2] > before[2] and after[3] > before[3]
    assert [len(g) for g in got] == [44, 29]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["phi", "gptneox", "bloom"])
def test_zoo_model_trains_through_the_kernels_on_card(cuda_device, family):
    """Two `train_batch` steps of a 2-layer phi (heads of 80), GPT-NeoX
    (heads of 256) and BLOOM in bf16 on the card, remat on: K1-fwd twice
    and K1-bwd dq and dk/dv once a layer and micro at the zoo's widths
    (none for BLOOM, whose alibi takes the masked path), against the same
    weights in f32 on the CPU (loss 1e-2, grad norm 5e-2 relative, as
    `test_train_batch_on_card_matches_cpu_f32`)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bloom, gptneox, phi
    cls, config_fn, init, loss_fn, preset, shape = {
        "phi": (phi.PhiForCausalLM, phi.phi_config, phi.init_phi, phi.phi_loss_fn, "phi-2",
                dict(hidden_size=320, intermediate_size=1280, num_attention_heads=4,
                     num_key_value_heads=4)),
        "gptneox": (gptneox.GPTNeoXForCausalLM, gptneox.gptneox_config,
                    gptneox.init_gptneox, gptneox.gptneox_loss_fn, "pythia-1b",
                    dict(hidden_size=512, intermediate_size=2048, num_attention_heads=2)),
        "bloom": (bloom.BloomForCausalLM, bloom.bloom_config, bloom.init_bloom,
                  bloom.bloom_loss_fn, "bloom-560m", dict(hidden_size=256,
                                                          num_attention_heads=4)),
    }[family]
    shape = dict(shape, num_hidden_layers=2, vocab_size=512, remat=True)
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "gradient_clipping": 1.0}
    cpu_model = init(config_fn(preset, dtype=torch.float32, **shape),
                     torch.Generator().manual_seed(0))
    card_model = cls(config_fn(preset, dtype=torch.bfloat16, **shape))
    card_model.load_state_dict(cpu_model.state_dict())
    ids = np.random.default_rng(1).integers(0, 512, (2, 4, 128))
    results = []
    for model, cfg, device in ((card_model, dict(config, bf16={"enabled": True}), None),
                               (cpu_model, config, "cpu")):
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    loss_fn=loss_fn(model), device=device)
        launches = (flash_attention_fwd.launches, flash_attention_bwd_dq.launches,
                    flash_attention_bwd_dkv.launches)
        steps = [(float(engine.train_batch(batch={"input_ids": b})),
                  engine.get_global_grad_norm()) for b in ids]
        results.append(steps)
        if device is None:   # 2 layers x 2 micros x 2 steps; remat runs the forward twice
            want = (0, 0, 0) if family == "bloom" else (16, 8, 8)
            assert (flash_attention_fwd.launches - launches[0],
                    flash_attention_bwd_dq.launches - launches[1],
                    flash_attention_bwd_dkv.launches - launches[2]) == want
    for (card_loss, card_norm), (cpu_loss, cpu_norm) in zip(*results):
        assert np.isfinite(card_loss) and abs(card_loss - cpu_loss) <= 1e-2 * abs(cpu_loss)
        assert abs(card_norm - cpu_norm) <= 5e-2 * abs(cpu_norm)
