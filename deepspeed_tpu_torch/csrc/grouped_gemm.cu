// Grouped (ragged) expert GEMM for Hopper (sm_90a) and its backward: for
// every group g, out[rows of g] = lhs[rows of g] @ rhs[g], bf16 in, f32
// accumulation, and the two products of its gradient.
//
// Replaces the TPU kernel `deepspeed_tpu/ops/pallas/grouped_gemm.py`
// `grouped_gemm` (:52), which runs megablox `gmm` (:83), and the two
// kernels of megablox `gmm`'s custom VJP that its backward reaches. It
// computes what those kernels compute:
//   * forward (`ds_grouped_gemm`, K6): lhs (M,K) bf16 with its rows sorted
//     by group; rhs (G,K,N) bf16 row-major, the (E, D, F) / (E, F, D)
//     expert stacks as the parameter tree holds them, read with no
//     transpose; sizes (G,) int32 on the device -> out (M,N) bf16. Group g
//     owns rows [start_g, start_g + s_g), start_g the exclusive prefix sum
//     of the sizes;
//   * dlhs (`ds_grouped_gemm_dlhs`, megablox `gmm(grad, rhs,
//     transpose_rhs=True)`): grad (M,N) and the same rhs (G,K,N) -> dlhs
//     (M,K) = per-group grad @ rhs[g]^T. The (K,N) row-major stack is read
//     N-major, a col_major WMMA B fragment; no transposed copy is made;
//   * drhs (`ds_grouped_gemm_drhs`, megablox `tgmm`): lhs (M,K) and grad
//     (M,N) -> drhs (G,K,N) = per-group lhs[rows of g]^T @ grad[rows of g],
//     bf16 out of an f32 sum. An empty group's slab is written as zeros, as
//     `tgmm` zero-fills it;
//   * the expert-parallel flavour (`ds_grouped_gemm` with a group offset,
//     K8-e), which replaces `grouped_gemm.py` `sharded_grouped_gemm` (:88):
//     megablox `gmm` with `group_offset` over a shard's own experts. rhs
//     holds the shard's GL experts [off, off + GL) of the G; the sizes are
//     all G. The shard's rows are computed by the same tiles as K6's call
//     over the whole stack, so they are K6's rows bit for bit, and every
//     other row is written as zeros: the output is the operand of the
//     all-reduce over `expert` that sums the shards (the wrapper's);
//   * megablox pads M up to a tile multiple and hands the pad rows to the
//     last group; here the ragged M edge of every tile is masked instead, so
//     nothing is padded and the outputs are the same (pad rows are zeros, so
//     they add nothing to drhs). A negative size counts as 0; rows past M
//     are never read or written; rows past the sum of the sizes (which the
//     callers never leave) are written as zeros by the forward and dlhs and
//     add nothing to drhs.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s, 989 TFLOP/s bf16, at the
// full 700 W power limit): at Qwen1.5-MoE prefill (M = 8192 rows over 60
// experts, 2048 x 1408) a forward call reads 346 MB of expert weights plus
// lhs and out, 0.120 ms, against 0.048 ms of operations: the bytes bound it.
// dlhs reads the same weights and drhs writes them, so both are bound by
// bytes there too. At ~137 rows an expert a 64-row M tile reads each weight
// tile three times (once per M tile of the group; consecutive blocks share
// it through L2 when they run together, which the grid order below makes
// likely, but nothing guarantees it). Mixtral-8x7B (M = 4096 over 8 experts,
// 4096 x 14336) is bound by operations: 0.486 ms against 0.326 ms of bytes,
// for each of the three products. At decode (M = 16 over 60) only the
// experts a row routes to are read. K8-e at Qwen's prefill on one of two
// expert ranks reads its 30 experts' weights (173 MB), the ~half of lhs
// its experts own and writes all of out (23 MB of it, zeros outside the
// span): ~0.064 ms of bytes against ~0.024 ms of operations.
//
// Design. The forward and dlhs share one kernel (`gmm_kernel`, TB selects
// the transposed read of rhs) and one schedule, which stays on the device:
// no host sync, no scratch.
// Each block's warp 0 scans the group sizes (32 at a time, warp shuffles)
// into each group's first row and its count of M tiles, ceil(s_g / BM),
// and finds the (group, M tile) of its own blockIdx.x in that prefix; empty
// groups get no tile; K8-e scans all G sizes and tiles only its local
// groups, then zeroes the rows outside them. The grid is (ceil(M/BM) + G +
// 1) x ceil(N/BN), G the local groups, an upper bound on the tiles that the
// host knows without reading the sizes; blocks past the last tile exit.
// blockIdx.x walks the tiles, so the M tiles of one group and one N tile
// sit next to each other in launch order and share their weight tiles in
// L2. A block computes rows [row0, row1) x BN
// columns: per K step it stages the lhs and rhs tiles in shared memory
// (16-byte loads where the rows are multiples of 8 and the bases aligned,
// guarded scalar loads otherwise: K = 1408 = 22 x 64 is Qwen's `down` depth
// and N of its gate/up), runs WMMA bf16 16x16x16 products with the f32
// fragments kept in registers across K, and stores only its own rows and
// columns through shared memory. Two shapes: BM = 64, BN = 128, BK = 32 with
// eight warps (2 x 4, 32 x 32 each) when groups average 32 rows or more;
// otherwise (decode, groups of 0-2 rows) BM = 16, BN = 64, BK = 64 with four
// warps of 16 x 16.
// drhs (`tgmm_kernel`) is a reduction over each group's ragged row span.
// One block owns one (group, 64-row K tile, 128-column N tile) of the
// output and walks its group's rows 32 at a time, so no two blocks add into
// one element: no atomics, and the result is the same bits on every run.
// lhs's tile is staged row by row as it lies ([row][k]) and read as a
// col_major A fragment, which is lhs^T. Its grid is ceil(K/64) x
// ceil(N/128) x G; warp 0 of each block sums the sizes before its group.
// Skewed routing gives the blocks of a large group more rows to walk than
// the rest: the slowest block sets the time, and nothing here rebalances.
// cp.async/TMA pipelining, wgmma and a persistent schedule that reads each
// weight tile once per group are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// Warp 0: this block's tile. info = {local group (-1: rows outside the
// local groups, to be zeroed), first row, end row}; end <= first means no
// tile (exit). The local groups are [off, off + GL) of the G groups: the
// scan runs over all G sizes, so each local group's rows start where they
// do in the whole call, and only the local groups get M tiles, cut at the
// same rows as when off = 0 and GL = G (K6). The tiles after them zero the
// rows before the local span, then the rows from its end to M.
template <int BM>
__device__ void locate_tile(const int* __restrict__ sizes, int G, int off, int GL, int M,
                            int t, int* info) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) { info[0] = -1; info[1] = 0; info[2] = 0; }
  __syncwarp();
  int row_base = 0, tile_base = 0, lo = 0, hi = 0;  // lo, hi: the local span
  for (int c = 0; c < G; c += 32) {
    const int g = c + lane;
    const int s = g < G ? max(sizes[g], 0) : 0;
    const bool local = g >= off && g < off + GL;
    const int n = local ? (s + BM - 1) / BM : 0;
    lo += g < off ? s : 0;
    hi += g < off + GL ? s : 0;
    int rows = s, tiles = n;  // inclusive scans over the 32 lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int r = __shfl_up_sync(0xffffffffu, rows, o);
      const int q = __shfl_up_sync(0xffffffffu, tiles, o);
      if (lane >= o) { rows += r; tiles += q; }
    }
    const int first_tile = tile_base + tiles - n;
    const int first_row = row_base + rows - s;
    if (t >= first_tile && t < first_tile + n) {  // at most one lane of all
      const int r0 = first_row + (t - first_tile) * BM;
      info[0] = g - off;
      info[1] = r0;
      info[2] = min(min(r0 + BM, first_row + s), M);
    }
    row_base += __shfl_sync(0xffffffffu, rows, 31);
    tile_base += __shfl_sync(0xffffffffu, tiles, 31);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, o);
    hi += __shfl_xor_sync(0xffffffffu, hi, o);
  }
  __syncwarp();
  if (lane == 0 && info[2] <= info[1] && info[0] < 0 && t >= tile_base) {
    // tiles past the local groups zero rows [0, lo), then [hi, M)
    lo = min(lo, M);
    hi = min(hi, M);
    const int front = (lo + BM - 1) / BM, u = t - tile_base;
    const int r0 = u < front ? u * BM : hi + (u - front) * BM;
    const int end = u < front ? lo : M;
    if (r0 < end) {
      info[1] = r0;
      info[2] = min(r0 + BM, end);
    }
  }
}

// K is the reduction depth and N the output width. TB = false: rhs[g] is
// (K, N) row-major (the forward). TB = true: rhs[g] is (N, K) row-major and
// read as its transpose (dlhs: the (K_fwd, N_fwd) stack with K = N_fwd).
template <int BM, int BN, int BK, int WM, int WN, bool TB>
__global__ void __launch_bounds__(WM * WN * 32)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const int* __restrict__ sizes, bf16* __restrict__ out, int M, int K,
           int N, int G, int off, int GL, int vec) {
  constexpr int NT = WM * WN * 32;
  constexpr int TM = BM / WM, TN = BN / WN;  // one warp's tile
  constexpr int FM = TM / 16, FN = TN / 16;
  // sB is [k][n] (BK x BN) for the forward, [n][k] (BN x BK) for TB
  constexpr int LDA = BK + 8, LDB = TB ? BK + 8 : BN + 8, LDC = BN + 4;
  constexpr int AB_BYTES = (BM * LDA + (TB ? BN : BK) * LDB) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  using BLayout = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  static_assert(TM % 16 == 0 && TN % 16 == 0 && BK % 16 == 0, "tile");
  __shared__ __align__(128) unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES];
  __shared__ int info[3];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BM * LDA;
  float* sC = reinterpret_cast<float*>(smem);  // the epilogue reuses the tiles' space

  const int tid = threadIdx.x;
  if (tid < 32) locate_tile<BM>(sizes, G, off, GL, M, blockIdx.x, info);
  __syncthreads();
  const int group = info[0], row0 = info[1], row1 = info[2];
  if (row1 <= row0) return;
  const int n0 = blockIdx.y * BN;

  if (group < 0) {  // rows outside the local groups
    for (int i = tid; i < BM * BN; i += NT) {
      const int m = row0 + i / BN, n = n0 + i % BN;
      if (m < row1 && n < N) out[(size_t)m * N + n] = __float2bfloat16(0.f);
    }
    return;
  }

  const int warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const bf16* w = rhs + (size_t)group * K * N;  // rhs holds the GL local groups
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (vec) {
      // 8 bf16 (16 bytes) a chunk along each operand's contiguous axis,
      // which is a multiple of 8, so a chunk is wholly inside or outside
      for (int i = tid; i < BM * BK / 8; i += NT) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const int m = row0 + r, k = k0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m < row1 && k < K) v = *reinterpret_cast<const uint4*>(lhs + (size_t)m * K + k);
        *reinterpret_cast<uint4*>(sA + r * LDA + c) = v;
      }
      if constexpr (TB) {
        for (int i = tid; i < BN * BK / 8; i += NT) {
          const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
          const int n = n0 + r, k = k0 + c;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (n < N && k < K) v = *reinterpret_cast<const uint4*>(w + (size_t)n * K + k);
          *reinterpret_cast<uint4*>(sB + r * LDB + c) = v;
        }
      } else {
        for (int i = tid; i < BK * BN / 8; i += NT) {
          const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
          const int k = k0 + r, n = n0 + c;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (k < K && n < N) v = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
          *reinterpret_cast<uint4*>(sB + r * LDB + c) = v;
        }
      }
    } else {
      for (int i = tid; i < BM * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        const int m = row0 + r, k = k0 + c;
        sA[r * LDA + c] = (m < row1 && k < K) ? lhs[(size_t)m * K + k] : zero;
      }
      if constexpr (TB) {
        for (int i = tid; i < BN * BK; i += NT) {
          const int r = i / BK, c = i % BK;
          const int n = n0 + r, k = k0 + c;
          sB[r * LDB + c] = (n < N && k < K) ? w[(size_t)n * K + k] : zero;
        }
      } else {
        for (int i = tid; i < BK * BN; i += NT) {
          const int r = i / BN, c = i % BN;
          const int k = k0 + r, n = n0 + c;
          sB[r * LDB + c] = (k < K && n < N) ? w[(size_t)k * N + n] : zero;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm * TM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        // col_major: element (k, n) of the fragment at sB[n * LDB + k]
        const bf16* src = TB ? sB + (wn * TN + j * 16) * LDB + kk
                             : sB + kk * LDB + wn * TN + j * 16;
        wmma::load_matrix_sync(b[j], src, LDB);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are overwritten by the next step (or by sC)
  }

  // epilogue: through shared memory, so the ragged M edge and the N tail are
  // written under guard
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(sC + (wm * TM + i * 16) * LDC + wn * TN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    const int m = row0 + r, n = n0 + c;
    if (m < row1 && n < N) out[(size_t)m * N + n] = __float2bfloat16(sC[r * LDC + c]);
  }
}

// drhs: out[g] (K, N) = lhs[rows of g]^T @ grad[rows of g]. blockIdx.z is
// the group, blockIdx.x the K tile (BM output rows), blockIdx.y the N tile;
// the block walks the group's rows BR at a time.
template <int BM, int BN, int BR, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
tgmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ grad,
            const int* __restrict__ sizes, bf16* __restrict__ out, int M, int K,
            int N, int vec) {
  constexpr int NT = WM * WN * 32;
  constexpr int TM = BM / WM, TN = BN / WN;
  constexpr int FM = TM / 16, FN = TN / 16;
  constexpr int LDA = BM + 8, LDB = BN + 8, LDC = BN + 4;  // sA is [row][k]
  constexpr int AB_BYTES = (BR * LDA + BR * LDB) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  static_assert(TM % 16 == 0 && TN % 16 == 0 && BR % 16 == 0, "tile");
  __shared__ __align__(128) unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES];
  __shared__ int span[2];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BR * LDA;
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int g = blockIdx.z;
  if (tid < 32) {  // the group's rows: the sizes before it, summed by warp 0
    int before = 0;
    for (int j = tid; j < g; j += 32) before += max(sizes[j], 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
    if (tid == 0) {
      span[0] = min(before, M);
      span[1] = min(before + max(sizes[g], 0), M);
    }
  }
  __syncthreads();
  const int first = span[0], last = span[1];
  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int r0 = first; r0 < last; r0 += BR) {  // no step at all for an empty group
    if (vec) {
      for (int i = tid; i < BR * BM / 8; i += NT) {
        const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
        const int m = r0 + r, k = k0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m < last && k < K) v = *reinterpret_cast<const uint4*>(lhs + (size_t)m * K + k);
        *reinterpret_cast<uint4*>(sA + r * LDA + c) = v;
      }
      for (int i = tid; i < BR * BN / 8; i += NT) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int m = r0 + r, n = n0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m < last && n < N) v = *reinterpret_cast<const uint4*>(grad + (size_t)m * N + n);
        *reinterpret_cast<uint4*>(sB + r * LDB + c) = v;
      }
    } else {
      for (int i = tid; i < BR * BM; i += NT) {
        const int r = i / BM, c = i % BM;
        const int m = r0 + r, k = k0 + c;
        sA[r * LDA + c] = (m < last && k < K) ? lhs[(size_t)m * K + k] : zero;
      }
      for (int i = tid; i < BR * BN; i += NT) {
        const int r = i / BN, c = i % BN;
        const int m = r0 + r, n = n0 + c;
        sB[r * LDB + c] = (m < last && n < N) ? grad[(size_t)m * N + n] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < BR; rr += 16) {
      // col_major A: element (k, row) at sA[row * LDA + k], i.e. lhs^T
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], sA + rr * LDA + wm * TM + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], sB + rr * LDB + wn * TN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(sC + (wm * TM + i * 16) * LDC + wn * TN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  bf16* o = out + (size_t)g * K * N;
  for (int i = tid; i < BM * BN; i += NT) {
    const int r = i / BN, c = i % BN;
    const int k = k0 + r, n = n0 + c;
    if (k < K && n < N) o[(size_t)k * N + n] = __float2bfloat16(sC[r * LDC + c]);
  }
}

// The M tiles of the local groups number at most ceil(M/BM) + GL - 1 and
// the zero tiles before and after the local span at most 2 more, so
// ceil(M/BM) + GL + 1 blocks cover them; blocks past the last tile exit.
template <int BM, int BN, int BK, int WM, int WN, bool TB>
cudaError_t launch(const void* lhs, const void* rhs, const void* sizes, void* out,
                   int M, int K, int N, int G, int off, int GL, int vec,
                   cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM + GL + 1, (N + BN - 1) / BN);
  gmm_kernel<BM, BN, BK, WM, WN, TB><<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
      static_cast<const int*>(sizes), static_cast<bf16*>(out), M, K, N, G, off, GL, vec);
  return cudaGetLastError();
}

// The large tile when groups average 32 rows or more, else the decode tile.
// The choice reads all G groups, whatever the local span, so an expert
// shard's rows are computed with K6's tiles.
template <bool TB>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const void* sizes, void* out,
                       int M, int K, int N, int G, int off, int GL, int vec,
                       cudaStream_t s) {
  if ((long long)M >= 32LL * (G > 0 ? G : 1))
    return launch<64, 128, 32, 2, 4, TB>(lhs, rhs, sizes, out, M, K, N, G, off, GL, vec, s);
  return launch<16, 64, 64, 1, 4, TB>(lhs, rhs, sizes, out, M, K, N, G, off, GL, vec, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// out (M,N) = per-group lhs (M,K) @ rhs[g - group_offset] for the local
// groups [group_offset, group_offset + local_groups) of the G groups, and
// zeros in every other row. rhs (local_groups,K,N); sizes (G,). K6 is
// group_offset = 0, local_groups = G; an expert shard's call (K8-e) is its
// span of the experts, and its rows are K6's rows for those experts.
extern "C" int ds_grouped_gemm(const void* lhs, const void* rhs, const void* sizes,
                               void* out, int M, int K, int N, int G, int group_offset,
                               int local_groups, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (M < 0 || N < 0 || K < 0 || G < 0 || group_offset < 0 || local_groups < 0 ||
      group_offset + local_groups > G)
    return cudaErrorInvalidValue;
  const int vec = (K % 8 == 0) && (N % 8 == 0) && aligned16(lhs) && aligned16(rhs);
  return launch_gmm<false>(lhs, rhs, sizes, out, M, K, N, G, group_offset, local_groups,
                           vec, static_cast<cudaStream_t>(stream));
}

// dlhs (M,K) = per-group grad (M,N) @ rhs[g]^T, rhs (G,K,N): the forward's
// kernel with N as its depth and K as its width, rhs read transposed.
extern "C" int ds_grouped_gemm_dlhs(const void* grad, const void* rhs, const void* sizes,
                                    void* out, int M, int K, int N, int G, void* stream) {
  if (M == 0 || K == 0) return cudaSuccess;
  if (M < 0 || N < 0 || K < 0 || G < 0) return cudaErrorInvalidValue;
  const int vec = (N % 8 == 0) && aligned16(grad) && aligned16(rhs);
  return launch_gmm<true>(grad, rhs, sizes, out, M, N, K, G, 0, G, vec,
                          static_cast<cudaStream_t>(stream));
}

// drhs (G,K,N) = per-group lhs (M,K)^T @ grad (M,N); empty groups are zeros.
extern "C" int ds_grouped_gemm_drhs(const void* lhs, const void* grad, const void* sizes,
                                    void* out, int M, int K, int N, int G, void* stream) {
  if (K == 0 || N == 0 || G == 0) return cudaSuccess;
  if (M < 0 || N < 0 || K < 0 || G < 0) return cudaErrorInvalidValue;
  constexpr int BM = 64, BN = 128, BR = 32;
  const int vec = (K % 8 == 0) && (N % 8 == 0) && aligned16(lhs) && aligned16(grad);
  dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN, G);
  tgmm_kernel<BM, BN, BR, 2, 4><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(grad),
      static_cast<const int*>(sizes), static_cast<bf16*>(out), M, K, N, vec);
  return cudaGetLastError();
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
