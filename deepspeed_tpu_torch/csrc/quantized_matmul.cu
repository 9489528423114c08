// Fused int8 dequant-GEMM (weight-only quantized matmul) for Hopper
// (sm_90a): out = x @ dequant(q, scales), bf16 in, f32 accumulation.
//
// Replaces the TPU kernel `deepspeed_tpu/ops/pallas/quantized_matmul.py`
// `quantized_matmul` (:146) with `_qmm_kernel` (:116). It computes what that
// kernel computes:
//   * x (M,K) bf16, q (K,N) int8 row-major (the flax kernel's (in, out)
//     layout), st (G,K) f32: the flat blockwise scales seen through the
//     wrapper's `_scales_t` view, st[j*sj + k*sk] scaling row k of column
//     group j, each group g = N / G columns wide (G = 1 when a scale block
//     spans rows) -> out (M,N) bf16. The view is read through its strides,
//     so the common layout needs no relayout copy;
//   * the scale is folded into the dequantized WEIGHT tile: w = bf16(q * s),
//     the f32 product rounded once, exactly the values
//     `dequantize_int8_blockwise(q, s, bf16)` gives; x is read as it is, and
//     the tensor cores accumulate x * w in f32. So the products are those of
//     the naive dequantize-then-matmul path and of the `dequant` serve mode,
//     and only the summation order differs. The TPU kernel folds the scale
//     into the activation instead (x * s rounds, the weight stays exact);
//     here that multiply ran once per activation element and N tile, and an
//     H100 measured the gate projection at prefill 7.82 ms that way against
//     4.20 ms with the weight fold (`chip_smoke.py`). The bf16 output is the
//     other rounding;
//   * the dequantized weight is never written to global memory: each K x N
//     tile of q is converted in shared memory and consumed there;
//   * loads past M, N or K are guarded, never read and then masked (the TPU
//     kernel masks its K remainder after the scale multiply because an
//     out-of-bounds f32 scale may be NaN, and NaN * 0 survives a pre-mask):
//     a guarded element is zero in both tiles.
//
// Bound on an H100: at decode (M = 4) the kernel reads K*N int8 bytes of
// weight for 2*M*K*N operations, ~8 operations a byte against the card's
// ~295, so the weight read bounds it (3.35 TB/s); at prefill (M = 2048) it
// does ~4000 operations a byte and the bf16 tensor cores bound it
// (989 TFLOP/s).
//
// Design: one block of four warps per (BN columns, BM rows) output tile;
// a tile's BN columns lie inside one scale group (BN divides g, or G = 1), so
// one scale per weight row, st[j, k], scales the whole tile row. Per K step
// the block stages x (bf16) and the dequantized q tile (bf16) in shared
// memory, with 16-byte loads of q where the row allows, and the warps run
// WMMA bf16 16x16x16 products with f32 fragments kept in registers across K.
// Two shapes: for M <= 16 (decode) BM = 16, BN = 32, BK = 256, and the four
// warps split each K step four ways (an in-block split-K, summed in a fixed
// order in the epilogue) so that a block keeps 8 KB of weight in flight;
// otherwise BM = 64 with a warp per 16 rows. The epilogue goes through
// shared memory so that the M and N edges are written under guard. At
// decode the grid is N / 32 blocks (32 for N = 1024 on 132 SMs): split-K
// across blocks, cp.async/TMA pipelining and wgmma are left for a later
// change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 128;

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(NTHREADS)
qmm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ st, bf16* __restrict__ out, int M, int K,
           int N, int G, int g, int sj, int sk) {
  constexpr int WARPS_M = BM / 16;
  constexpr int WARPS_K = 4 / WARPS_M;
  constexpr int KS = BK / WARPS_K;  // K columns per warp per step
  constexpr int LDA = BK + 8;
  constexpr int LDB = BN + 8;
  constexpr int LDC = BN + 4;
  static_assert(WARPS_M * WARPS_K == 4 && KS % 16 == 0 && BN % 16 == 0, "tile");
  __shared__ __align__(32) bf16 sA[BM * LDA];
  __shared__ __align__(32) bf16 sB[BK * LDB];
  __shared__ __align__(32) float sC[WARPS_K * BM * LDC];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % WARPS_M;
  const int wk = warp / WARPS_M;
  const float* srow = st + (size_t)(G > 1 ? n0 / g : 0) * sj;
  const bool vec = (N % 16 == 0) && ((reinterpret_cast<uintptr_t>(q) & 15) == 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile; zero past M and K
    for (int i = tid; i < BM * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      sA[r * LDA + c] = (m < M && k < K) ? x[(size_t)m * K + k] : __float2bfloat16(0.f);
    }
    // weight tile, dequantized: bf16(q * s) with row k's scale; zero past K
    // and N
    constexpr int CH = BN / 16;  // 16-byte chunks per tile row
    for (int i = tid; i < BK * CH; i += NTHREADS) {
      const int r = i / CH, c = (i % CH) * 16;
      const int k = k0 + r, n = n0 + c;
      __align__(16) bf16 w[16];
      const float sc = k < K ? srow[(size_t)k * sk] : 0.f;
      if (vec && k < K && n + 16 <= N) {
        const uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)k * N + n);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) w[e] = __float2bfloat16((float)b[e] * sc);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const bool in = k < K && n + e < N;
          w[e] = __float2bfloat16(in ? (float)q[(size_t)k * N + n + e] * sc : 0.f);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(sB + r * LDB + c);
      dst[0] = reinterpret_cast<const uint4*>(w)[0];
      dst[1] = reinterpret_cast<const uint4*>(w)[1];
    }
    __syncthreads();

#pragma unroll
    for (int kk = wk * KS; kk < (wk + 1) * KS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sA + wm * 16 * LDA + kk, LDA);
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sB + kk * LDB + n * 16, LDB);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
    __syncthreads();  // the tiles are overwritten by the next step
  }

  // epilogue: the K-split partials summed in a fixed order, guarded store
#pragma unroll
  for (int n = 0; n < BN / 16; ++n)
    wmma::store_matrix_sync(sC + (wk * BM + wm * 16) * LDC + n * 16, acc[n], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += NTHREADS) {
    const int r = i / BN, c = i % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS_K; ++w) sum += sC[(w * BM + r) * LDC + c];
    out[(size_t)m * N + n] = __float2bfloat16(sum);
  }
}

template <int BM, int BN, int BK>
cudaError_t launch(const void* x, const void* q, const void* st, void* out,
                   int M, int K, int N, int G, int g, int sj, int sk,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<BM, BN, BK><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(st), static_cast<bf16*>(out), M, K, N, G, g, sj, sk);
  return cudaGetLastError();
}

}  // namespace

// Tile shape per call: M <= 16 takes the decode tile (BN = 32); otherwise
// BN = 64 where the group allows it, else 32. With G > 1 the group width must
// be a multiple of the tile's BN (the wrapper checks 32; 64 is chosen here).
extern "C" int ds_quantized_matmul(const void* x, const void* q, const void* st,
                                   void* out, int M, int K, int N, int G, int g,
                                   int sj, int sk, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (K <= 0 || G <= 0 || g <= 0 || (G > 1 && (g % 32 || G * g != N)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch<16, 32, 256>(x, q, st, out, M, K, N, G, g, sj, sk, s);
  if (G == 1 || g % 64 == 0)
    return launch<64, 64, 32>(x, q, st, out, M, K, N, G, g, sj, sk, s);
  return launch<64, 32, 32>(x, q, st, out, M, K, N, G, g, sj, sk, s);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
