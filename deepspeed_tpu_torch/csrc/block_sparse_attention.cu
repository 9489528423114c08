// Block-sparse attention forward for Hopper (sm_90a), bf16 in, f32
// accumulation.
//
// Replaces the TPU kernel `deepspeed_tpu/ops/pallas/block_sparse_attention.py`
// `block_sparse_attention` (:110, its `pallas_call` at :147, body
// `_bs_kernel` :53). It computes what that kernel computes:
//   * q/k/v (B,S,H,D) bf16 and a block layout given as its padded indices:
//     idx (H, S/blk, Kmax) int32, the live KV blocks of each (head, query
//     block) in ascending order, and nlive (H, S/blk) int32 their counts
//     (`padded_layout_indices`) -> out (B,S,H,D) bf16;
//   * online softmax over exactly the live KV blocks of each query block;
//     entries kk >= nlive are never read;
//   * causal: blocks above the diagonal (idx > query block) are skipped and
//     the diagonal block is masked inside (key j seen by query i when j <=
//     i). Masked logits are the finite sentinel NEG_INF and their p is set
//     to 0, so a row whose every live key is masked keeps l == 0 and
//     outputs zeros, as the TPU kernel's `_finalize` does;
//   * q is scaled by softmax_scale*log2(e) in f32 and rounded to bf16 (the
//     softmax runs in the base-2 domain), p is rounded to bf16 before P.V,
//     the running sum l takes the f32 p.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s, 989 TFLOP/s bf16, at the
// full 700 W power limit): the work is 4*blk^2*D operations per live
// (query block, key block) pair against reading q, the live K and V blocks
// once each and writing out. With few live blocks a row the bytes bound it:
// at B=1, S=4096, H=8, D=128, block 64, causal BigBird (1,730 live pairs,
// ~3.4 a query block) q and out are 16.8 MB and the live K/V blocks 16.8 MB,
// 0.010 ms at 3.35 TB/s, against 3.6 GFLOP of products, 0.0037 ms at 989
// TFLOP/s.
//
// Design: the TPU kernel's sequential grid axis over the Kmax live blocks
// becomes a loop inside one thread block; the TPU's scalar prefetch of the
// indices becomes the block reading its own idx row. One thread block per
// (tile of T query rows, head, batch), T = min(blk, 64): a 128-row layout
// block is split into two 64-row tiles, which keeps the shared memory of
// one block within the card's limit. T/16 warps, each owning 16 query rows.
// For each live KV block the block walks it in T-key chunks (a causal chunk
// wholly above the tile's last row is skipped): the K and V chunk is staged
// in shared memory, S = Q.K^T and O += P.V run on the tensor cores through
// WMMA bf16 16x16x16 fragments with f32 accumulation, and the running max,
// running sum and output accumulator stay in shared memory (the fragment
// layout is opaque, so the per-row rescale happens there), as the port's
// flash forward (K1-fwd) does. Supported: blk in {32, 64, 128}, D in
// {64, 128}; S a multiple of blk. cp.async/TMA double buffering of the live
// chunks and wgmma are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout for T rows and keys a tile; leading dimensions are
// padded against bank conflicts and keep every 16-row fragment 32-byte
// aligned, as WMMA requires.
template <int T, int D>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 rows of Q, K and V
  static constexpr int LDS = T + 4;   // f32 logits
  static constexpr int LDP = T + 8;   // bf16 probabilities
  static constexpr int LDO = D + 4;   // f32 output accumulator
  static constexpr int q = 0;
  static constexpr int k = q + T * LDQ * 2;
  static constexpr int v = k + T * LDQ * 2;
  static constexpr int s = v + T * LDQ * 2;
  static constexpr int p = s + T * LDS * 4;
  static constexpr int o = p + T * LDP * 2;
  static constexpr int m = o + T * LDO * 4;
  static constexpr int l = m + T * 4;
  static constexpr int bytes = l + T * 4;
};

// Copy rows [r0, r0+T) of a (rows, stride) bf16 matrix into shared memory
// with 16-byte loads (D is a multiple of 8; every row lies below S).
template <int T, int D, int LD, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int stride) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < T * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + c * 8);
  }
}

template <int T, int D>
__global__ void __launch_bounds__(T * 2)
block_sparse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ idx,
                    const int* __restrict__ nlive, bf16* __restrict__ out, int S,
                    int H, int blk, int kmax, int causal, float qscale) {
  using L = Layout<T, D>;
  constexpr int NTHREADS = T * 2;   // T / 16 warps
  constexpr int CPL = T / 32;       // logit columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);

  const int q0 = blockIdx.x * T;   // first query row of this tile
  const int qb = q0 / blk;         // its layout block
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = S / blk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int stride = H * D;
  const size_t base = ((size_t)b * S * H + h) * D;

  // Q tile, pre-scaled by softmax_scale*log2(e) and rounded to bf16
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < T * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * stride + c * 8);
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
    *reinterpret_cast<uint4*>(sQ + r * L::LDQ + c * 8) = val;
  }
  for (int i = threadIdx.x; i < T * L::LDO; i += NTHREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < T; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  __syncthreads();

  const int* live = idx + ((size_t)h * nq + qb) * kmax;
  const int n_live = nlive[h * nq + qb];
  for (int kk = 0; kk < n_live; ++kk) {
    const int kb = live[kk];
    if (causal && kb > qb) continue;   // above the diagonal: nothing seen
    for (int sub = 0; sub < blk; sub += T) {
      const int k0 = kb * blk + sub;
      if (causal && k0 > q0 + T - 1) break;   // every key above every row
      load_tile<T, D, L::LDQ, NTHREADS>(sK, k + base, k0, stride);
      load_tile<T, D, L::LDQ, NTHREADS>(sV, v + base, k0, stride);
      __syncthreads();

      // S = Qs . K^T for this warp's 16 rows
      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T / 16];
#pragma unroll
        for (int n = 0; n < T / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
        for (int d = 0; d < D; d += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, sQ + r0 * L::LDQ + d, L::LDQ);
#pragma unroll
          for (int n = 0; n < T / 16; ++n) {
            // K stored [key][d] is K^T in column-major order
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
            wmma::load_matrix_sync(bk, sK + n * 16 * L::LDQ + d, L::LDQ);
            wmma::mma_sync(acc[n], a, bk, acc[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < T / 16; ++n)
          wmma::store_matrix_sync(sS + r0 * L::LDS + n * 16, acc[n], L::LDS,
                                  wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax in base 2 over this chunk, one row at a time
      for (int rr = 0; rr < 16; ++rr) {
        const int r = r0 + rr;
        const int row = q0 + r;
        float s[CPL];
        bool masked[CPL];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          masked[j] = causal && (k0 + c > row);
          s[j] = masked[j] ? NEG_INF : sS[r * L::LDS + c];
          mx = fmaxf(mx, s[j]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float m_prev = sM[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          // NEG_INF is finite: a row masked so far has m_new == NEG_INF, and
          // exp2(s - m_new) would be 1 on its masked columns
          const float p = masked[j] ? 0.f : exp2f(s[j] - m_new);
          sum += p;
          sP[r * L::LDP + lane + 32 * j] = __float2bfloat16(p);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
        const float alpha = exp2f(m_prev - m_new);
        for (int c = lane; c < D; c += 32) sO[r * L::LDO + c] *= alpha;
        __syncwarp();
        if (lane == 0) {
          sL[r] = sL[r] * alpha + sum;
          sM[r] = m_new;
        }
      }
      __syncwarp();

      // O += P . V for this warp's 16 rows
      {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[T / 16];
#pragma unroll
        for (int j = 0; j < T / 16; ++j)
          wmma::load_matrix_sync(pa[j], sP + r0 * L::LDP + j * 16, L::LDP);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::load_matrix_sync(acc, sO + r0 * L::LDO + n * 16, L::LDO,
                                 wmma::mem_row_major);
#pragma unroll
          for (int j = 0; j < T / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
            wmma::load_matrix_sync(bv, sV + j * 16 * L::LDQ + n * 16, L::LDQ);
            wmma::mma_sync(acc, pa[j], bv, acc);
          }
          wmma::store_matrix_sync(sO + r0 * L::LDO + n * 16, acc, L::LDO,
                                  wmma::mem_row_major);
        }
      }
      __syncthreads();  // K/V chunks are overwritten by the next iteration
    }
  }

  // out = O / l; l == 0 (no live unmasked key) gives zeros
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const float l = sL[r];
    const float inv = (l == 0.f) ? 0.f : 1.f / l;
    bf16* orow = out + base + (size_t)(q0 + r) * stride;
    for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(sO[r * L::LDO + c] * inv);
  }
}

template <int T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* idx,
                   const void* nlive, void* out, int B, int S, int H, int blk,
                   int kmax, int causal, float qscale, cudaStream_t stream) {
  constexpr int bytes = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_sparse_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(S / T, H, B);
  block_sparse_kernel<T, D><<<grid, T * 2, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(nlive), static_cast<bf16*>(out), S, H, blk, kmax,
      causal, qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ds_block_sparse_attention(const void* q, const void* k, const void* v,
                                         const void* idx, const void* nlive, void* out,
                                         int B, int S, int H, int D, int blk, int kmax,
                                         int causal, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if ((blk != 32 && blk != 64 && blk != 128) || S % blk != 0 || kmax < 1)
    return cudaErrorInvalidValue;
  if (blk == 32) {
    if (D == 64) return launch<32, 64>(q, k, v, idx, nlive, out, B, S, H, blk, kmax, causal, qscale, s);
    if (D == 128) return launch<32, 128>(q, k, v, idx, nlive, out, B, S, H, blk, kmax, causal, qscale, s);
  } else {
    if (D == 64) return launch<64, 64>(q, k, v, idx, nlive, out, B, S, H, blk, kmax, causal, qscale, s);
    if (D == 128) return launch<64, 128>(q, k, v, idx, nlive, out, B, S, H, blk, kmax, causal, qscale, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
