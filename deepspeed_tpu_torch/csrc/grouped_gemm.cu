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
//     (M,K) = per-group grad @ rhs[g]^T. The (K,N) row-major stack is the
//     product's K-major B as it lies; no transposed copy is made;
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
// bytes there too. Mixtral-8x7B (M = 4096 over 8 experts, 4096 x 14336) is
// bound by operations: 0.486 ms against 0.326 ms of bytes, for each of the
// three products. At decode (M = 16 over 60) only the experts a row routes
// to are read. K8-e at Qwen's prefill on one of two expert ranks reads its
// 30 experts' weights (173 MB), the ~half of lhs its experts own and writes
// all of out (23 MB of it, zeros outside the span): ~0.064 ms of bytes
// against ~0.024 ms of operations.
//
// Design. Every product runs on wgmma (m64nNk16, bf16 in, f32 accumulators
// in registers) with both operands in shared memory, in the swizzled
// layout of `hopper_common.cuh`: stages (64 deep in the forward and dlhs,
// one 128-byte swizzle row of bf16; 32 rows in drhs) arrive by cp.async
// (16 bytes a thread, zero-filled past K, N or the group's rows) into a
// ring of S stages. A step waits for its stage,
// crosses one barrier, issues its products and the copy S - 2 stages ahead
// (the forward issues the products first, so the tensor cores run while
// the threads compute the copies' addresses; drhs, one stage ahead, the
// copy first), and leaves the products in flight (wgmma.wait_group 1): a
// stage is rewritten only after the products that read it are done. No branch surrounds a wgmma (one
// serialises the products: ptxas C7520). The accumulators leave as bf16
// pairs through a padded tile over the ring, stored 16 bytes a thread with
// a warp's stores covering whole rows. Dynamic shared memory above 48 KB is
// opted into once per device.
//   * forward and dlhs (`gmm_kernel`; TB: dlhs) share one kernel and one
//     schedule, on the device: no host sync. Warp 0 of each block scans the
//     sizes (32 at a time, warp shuffles) into each group's first row and
//     its count of row tiles, ceil(s_g / BM), and finds the (group, row
//     tile) of its own block; K8-e scans all G sizes and tiles only its
//     local groups, then zeroes the rows outside them. When groups average
//     32 rows or more a block computes up to BM = 192 rows of one group by
//     BN = 192 columns (three warpgroups of m64n192, a four-stage ring of
//     48 KB stages), so a group of up to 192 rows (Qwen's top-4 of 60 at
//     2,048 tokens: ~137, rarely above 170) streams its weight strip once,
//     and each weight tile crosses HBM once per group; the N tiles of one
//     row tile are neighbours in launch order, so they share the lhs rows
//     in L2, whose reads (A re-read once per N tile) are what the wider N
//     tile cuts. Only the group's rows are copied; every m64 tile is
//     multiplied, and rows past the group hold stale bits that reach no
//     stored row. Otherwise (decode, groups of 0-2 rows) BM = 64 and BN =
//     64 with one warpgroup and three blocks an SM, which spreads the
//     routed experts' weight strips over every SM; wgmma's unused rows cost
//     nothing where bytes bind. The forward's B (rhs[g], K x N row-major)
//     is MN-major (tnspB), dlhs's (the same stack read N-deep) K-major.
//   * drhs (`tgmm_kernel`) is a reduction over each group's ragged rows:
//     an output tile of 128 x 128 (two warpgroups of m64n128) walks the
//     rows 32 at a time through a ring of six 16 KB stages, four chunks
//     ahead (its steps wait on the copies' latency: 64-row chunks three
//     stages deep read 9% slower, 16-row chunks 4%), A = lhs^T read
//     MN-major (tnspA) and B = grad rows MN-major (tnspB). Blocks are
//     persistent (two an SM, a grid of at most twice the SMs), each walking
//     (item, K tile, N tile) units with a cursor over the sizes; an item is a group, or one range of T rows of
//     a group with more than T rows (T = 4x the mean group, at least 256),
//     so a skewed expert is spread over many blocks. An unsplit group's
//     tile goes out as bf16 (empty groups as zeros); a split group's ranges
//     each write an f32 partial into the scratch the wrapper allocates, and
//     `drhs_reduce_kernel` sums them in range order and writes bf16. No two
//     blocks add into one element and nothing uses atomics: the result is
//     the same bits on every run.
//   * odd layouts (K or N not a multiple of 8, unaligned bases) take
//     guarded scalar loads into the same tiles and scalar stores.
// What holds it (PERF.md, measured on an H100 80GB HBM3 at 700 W): at
// Qwen's gate/up call the forward takes 1.65x its bytes bound and drhs
// 2.35x; Mixtral's calls reach about a third of the bf16 peak. The copies
// are issued 16 bytes at a time by the threads that run the products, with
// one barrier a stage, and each tile re-reads its operands from L2 (lhs
// rows once per N tile). Left for later: TMA loads from a producer warp
// (warp specialisation) with deeper rings, a persistent forward whose next
// tile's loads overlap this one's epilogue, wider drhs and Mixtral tiles
// that reuse each loaded row for more of the output, and fp8 experts.

#include <limits.h>

#include <algorithm>

#include "hopper_common.cuh"

namespace {

constexpr int BK = 64;          // depth of a stage: one 128-byte swizzle row of bf16
constexpr int CBLK = 64 * 128;  // one column block of a 64-row tile

// Copy rows [0, nrows) of the tile whose element (r, c) is src[(r0 + r) *
// stride + c0 + c], 64·CB columns wide, into CB column blocks of [ROWS][128
// bytes] at dst. Elements at or past row rlim or column clim are zeros.
// vec: cp.async, 16 bytes a thread (stride and c0 multiples of 8 and src
// 16-byte aligned, so a chunk lies wholly inside or outside); otherwise
// guarded scalar loads and a 16-byte shared store.
template <int ROWS, int CB, int NT>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* __restrict__ src,
                                          int r0, int nrows, int rlim, int c0, int clim,
                                          int stride, int vec) {
  constexpr int CH = CB * 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < nrows * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int row = r0 + r, col = c0 + c * 8;
    unsigned char* d = dst + (c / 8) * (ROWS * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
    if (vec) {
      const bool ok = row < rlim && col < clim;
      cp_async16(d, src + (ok ? (size_t)row * stride + col : 0), ok);
    } else {
      __align__(16) bf16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = (row < rlim && col + j < clim) ? src[(size_t)row * stride + col + j]
                                              : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(e);
    }
  }
}

// This warpgroup's accumulator (64 x N f32, wgmma's layout: a thread holds
// two rows of its warp's 16, two adjacent columns of every 8) as bf16 pairs
// into rows [r0, r0 + 64) of a row-major tile of LD elements a row.
template <int N, int LD>
__device__ __forceinline__ void stage_acc(bf16* tile, int r0, const float (&acc)[N / 2]) {
  const int lane = threadIdx.x % 32;
  const int r = r0 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + (r + 8 * h) * LD + j * 8 + (lane % 4) * 2) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// Rows [0, rows) x columns [0, cols) of a staged tile (or zeros, `tile`
// null) to dst, `stride` elements a row: 16 bytes a thread, a warp's
// stores covering whole rows, where vec (stride and cols multiples of 8),
// else element by element.
template <int COLS, int LD, int NT>
__device__ __forceinline__ void store_tile(bf16* dst, int stride, const bf16* tile, int rows,
                                           int cols, int vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * (COLS / 8); i += NT) {
      const int r = i / (COLS / 8), c = (i % (COLS / 8)) * 8;
      if (c < cols)
        *reinterpret_cast<uint4*>(dst + (size_t)r * stride + c) =
            tile ? *reinterpret_cast<const uint4*>(tile + r * LD + c) : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      if (c < cols) dst[(size_t)r * stride + c] = tile ? tile[r * LD + c] : __float2bfloat16(0.f);
    }
  }
}

// The same accumulator as f32 pairs straight from the registers (8 bytes a
// thread where vec, else element by element).
template <int N>
__device__ __forceinline__ void store_acc_f32(float* dst, int stride, const float (&acc)[N / 2],
                                              int rows, int cols, int vec) {
  const int lane = threadIdx.x % 32;
  const int r0 = ((threadIdx.x / 32) % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = j * 8 + (lane % 4) * 2;
      if (r >= rows || c >= cols) continue;
      float* d = dst + (size_t)r * stride + c;
      if (vec) {
        *reinterpret_cast<float2*>(d) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        d[0] = acc[4 * j + 2 * h];
        if (c + 1 < cols) d[1] = acc[4 * j + 2 * h + 1];
      }
    }
}

// Warp 0: this block's tile. info = {local group (-1: rows outside the
// local groups, to be zeroed), first row, end row}; end <= first means no
// tile (exit). The local groups are [off, off + GL) of the G groups: the
// scan runs over all G sizes, so each local group's rows start where they
// do in the whole call, and only the local groups get row tiles, cut at the
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

// The forward/dlhs tiles: NWG warpgroups, each holding one m64 x BN
// accumulator (BM = 64·NWG rows a block), a ring of four stages of BM x 64
// lhs rows and 64 x BN (or BN x 64) weights, MINB blocks an SM.
template <int NWG_, int BN_, int MINB_>
struct GmmTile {
  static constexpr int NWG = NWG_, BN = BN_, MINB = MINB_, S = 4;
  static constexpr int NT = NWG * 128;
  static constexpr int BM = NWG * 64;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE = A_BYTES + BN * 128;
  static constexpr int LDC = BN + 8;  // the epilogue's bf16 tile, padded
  static constexpr int RING = S * STAGE, OUT = BM * LDC * 2;
  static constexpr int bytes = (RING > OUT ? RING : OUT) + 1024;  // + alignment slack
  static_assert(BN % 64 == 0, "tile");
};
using PrefillTile = GmmTile<3, 192, 1>;  // 192 x 192, 193 KB
using DecodeTile = GmmTile<1, 64, 3>;    // 64 x 64, 65 KB

// K is the reduction depth and N the output width. TB = false: rhs[g] is
// (K, N) row-major (the forward). TB = true: rhs[g] is (N, K) row-major and
// read as its transpose (dlhs: the (K_fwd, N_fwd) stack with K = N_fwd).
template <class T, bool TB>
__global__ void __launch_bounds__(T::NT, T::MINB)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const int* __restrict__ sizes, bf16* __restrict__ out, int M, int K, int N, int G,
           int off, int GL, int vec) {
  constexpr int NT = T::NT, BN = T::BN, S = T::S;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  __shared__ int info[3];
  const int n_tiles = (N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  if (threadIdx.x < 32) locate_tile<T::BM>(sizes, G, off, GL, M, blockIdx.x / n_tiles, info);
  __syncthreads();
  const int group = info[0], row0 = info[1], rows = info[2] - info[1];
  if (rows <= 0) return;
  const int cols = min(BN, N - n0);
  bf16* o = out + (size_t)row0 * N + n0;
  if (group < 0) {  // rows outside the local groups
    store_tile<BN, T::LDC, NT>(o, N, nullptr, rows, cols, vec);
    return;
  }

  const int wg = threadIdx.x / 128;
  const bf16* w = rhs + (size_t)group * K * N;  // rhs holds the GL local groups
  const int nk = (K + BK - 1) / BK;
  auto issue = [&](int s) {  // stage s's copies, or an empty group past the last
    if (s < nk) {
      unsigned char* a = smem + (s % S) * T::STAGE;
      const int k0 = s * BK;
      load_tile<T::BM, 1, NT>(a, lhs, row0, rows, row0 + rows, k0, K, K, vec);
      if constexpr (TB)
        load_tile<BN, 1, NT>(a + T::A_BYTES, w, n0, BN, N, k0, K, K, vec);
      else
        load_tile<64, BN / 64, NT>(a + T::A_BYTES, w, k0, 64, K, n0, N, N, vec);
    }
    cp_async_commit();
  };

  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 2; ++s) issue(s);
  for (int s = 0; s < nk; ++s) {
    // stage s has landed, and every warpgroup's products of stage s - 2 are
    // done, so its slot takes stage s + S - 2, copied while the tensor cores
    // run stage s
    cp_async_wait<S - 3>();
    fence_async_smem();
    __syncthreads();
    const unsigned char* a = smem + (s % S) * T::STAGE;
    const unsigned char* b = a + T::A_BYTES;
    // every warpgroup, live rows or not: a branch around wgmma would
    // serialise the products (ptxas C7520), and a dead tile's rows reach no
    // stored row
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<BN, 0, TB ? 0 : 1>(
          acc, make_desc(a + wg * CBLK + kk * 32, 16, 1024),
          TB ? make_desc(b + kk * 32, 16, 1024) : make_desc(b + kk * 2048, CBLK, 1024), 1);
    wg_commit();
    issue(s + S - 2);
    wg_wait<1>();
  }
  wg_wait_all();
  __syncthreads();  // every product is done: the ring becomes the output tile
  bf16* tile = reinterpret_cast<bf16*>(smem);
  stage_acc<BN, T::LDC>(tile, wg * 64, acc);
  __syncthreads();
  store_tile<BN, T::LDC, NT>(o, N, tile, rows, cols, vec);
}

// drhs: a 128 (K) x 128 (N) output tile a unit, two warpgroups of m64n128,
// a ring of six stages of CR = 32 rows of lhs (128 of K) and grad (128 of
// N), four chunks ahead, two blocks an SM.
struct TgmmTile {
  static constexpr int NT = 256, BMK = 128, BN = 128, CR = 32, S = 6, MINB = 2;
  static constexpr int BLK = CR * 128;  // one column block of a chunk
  static constexpr int A_BYTES = 2 * BLK;
  static constexpr int STAGE = A_BYTES + 2 * BLK;
  static constexpr int LDC = BN + 8;
  static constexpr int RING = S * STAGE, OUT = BMK * LDC * 2;
  static constexpr int bytes = (RING > OUT ? RING : OUT) + 1024;  // + alignment slack
};

// Items of a group of `rows` rows: its ranges of T rows when it has more
// than T, else the group whole.
__device__ __forceinline__ int split_items(int rows, int T) {
  return rows > T ? (rows + T - 1) / T : 1;
}

// A walk over a block's drhs units (item, K tile, N tile), item-major, u =
// blockIdx.x + i·gridDim.x, with a cursor over the sizes: group g holds rows
// [first, last), its items end at item_end, and the split groups' slots up
// to and including g end at slot_end. The current unit: rows [lo, hi) in
// nch chunks of CR, its f32 partial's slot (-1: bf16 to out), its tile.
struct Units {
  int u = 0, g = -1, first = 0, last = 0, items = 0, item_end = 0, slot_end = 0;
  int lo = 0, hi = 0, slot = -1, k0 = 0, n0 = 0, nch = 0;

  // Move to unit u (not before the current one); false past the last.
  __device__ __forceinline__ bool seek(int v, const int* __restrict__ sizes, int M, int G, int T,
                                       int tiles, int nnt) {
    const int it = v / tiles;
    while (it >= item_end) {
      if (++g >= G) return false;
      first = last;
      last += min(max(sizes[g], 0), M - last);
      items = split_items(last - first, T);
      item_end += items;
      if (items > 1) slot_end += items;
    }
    const int r = it - (item_end - items);
    u = v;
    lo = items > 1 ? first + r * T : first;
    hi = items > 1 ? min(lo + T, last) : last;
    slot = items > 1 ? slot_end - items + r : -1;
    k0 = ((v % tiles) / nnt) * TgmmTile::BMK;
    n0 = ((v % tiles) % nnt) * TgmmTile::BN;
    nch = (hi - lo + TgmmTile::CR - 1) / TgmmTile::CR;  // none for an empty group: zeros
    return true;
  }
};

// drhs: out[g] (K, N) = lhs[rows of g]^T @ grad[rows of g]. A split group's
// ranges write f32 partials to part[slot] (K, N), its slots consecutive
// from the sum of the split groups' items before it.
__global__ void __launch_bounds__(TgmmTile::NT, TgmmTile::MINB)
tgmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ grad,
            const int* __restrict__ sizes, bf16* __restrict__ out, float* __restrict__ part,
            int M, int K, int N, int G, int T, int vec) {
  using C = TgmmTile;
  constexpr int NT = C::NT, S = C::S;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int nnt = (N + C::BN - 1) / C::BN;
  const int tiles = ((K + C::BMK - 1) / C::BMK) * nnt;
  const int wg = threadIdx.x / 128;
  Units unit;
  for (bool more = unit.seek(blockIdx.x, sizes, M, G, T, tiles, nnt); more;
       more = unit.seek(unit.u + gridDim.x, sizes, M, G, T, tiles, nnt)) {
    auto issue = [&](int c) {  // chunk c's copies, or an empty group past the last
      if (c < unit.nch) {
        unsigned char* a = smem + (c % S) * C::STAGE;
        const int row = unit.lo + c * C::CR;
        load_tile<C::CR, 2, NT>(a, lhs, row, C::CR, unit.hi, unit.k0, K, K, vec);
        load_tile<C::CR, 2, NT>(a + C::A_BYTES, grad, row, C::CR, unit.hi, unit.n0, N, N, vec);
      }
      cp_async_commit();
    };
    float acc[C::BN / 2];
#pragma unroll
    for (int j = 0; j < C::BN / 2; ++j) acc[j] = 0.f;
#pragma unroll
    for (int c = 0; c < S - 2; ++c) issue(c);
    for (int c = 0; c < unit.nch; ++c) {
      // the copy's latency is what a step waits for: issue it first
      cp_async_wait<S - 3>();
      fence_async_smem();
      __syncthreads();
      issue(c + S - 2);
      const unsigned char* a = smem + (c % S) * C::STAGE;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < C::CR / 16; ++kk)  // A = lhs^T and B = grad rows, both MN-major
        wgmma_ss<C::BN, 1, 1>(acc, make_desc(a + wg * C::BLK + kk * 2048, C::BLK, 1024),
                              make_desc(a + C::A_BYTES + kk * 2048, C::BLK, 1024), 1);
      wg_commit();
      wg_wait<1>();
    }
    wg_wait_all();
    cp_async_wait_all();  // the empty groups committed past the last chunk
    __syncthreads();      // every product is done: the ring may become the output tile

    const int cols = min(C::BN, N - unit.n0);
    if (unit.slot < 0) {  // bf16 through the staged tile
      bf16* t = reinterpret_cast<bf16*>(smem);
      stage_acc<C::BN, C::LDC>(t, wg * 64, acc);
      __syncthreads();
      store_tile<C::BN, C::LDC, NT>(out + ((size_t)unit.g * K + unit.k0) * N + unit.n0, N, t,
                                    min(C::BMK, K - unit.k0), cols, vec);
    } else {  // f32 pairs straight from the accumulator
      const int k = unit.k0 + wg * 64;
      store_acc_f32<C::BN>(part + ((size_t)unit.slot * K + k) * N + unit.n0, N, acc,
                           min(64, K - k), cols, vec);
    }
    __syncthreads();  // the next unit's copies overwrite the ring
  }
}

// drhs's second pass: every split group's slab = its ranges' f32 partials
// summed in range order, as bf16. Each thread owns 8 elements of (K, N) at
// a time, the blocks striding over them; every block walks the sizes.
__global__ void __launch_bounds__(256)
drhs_reduce_kernel(const float* __restrict__ part, const int* __restrict__ sizes,
                   bf16* __restrict__ out, int M, int K, int N, int G, int T, int vec) {
  const size_t kn = (size_t)K * N;
  const size_t step = (size_t)gridDim.x * blockDim.x * 8;
  int next = 0, slot = 0;
  for (int g = 0; g < G; ++g) {
    const int rows = min(max(sizes[g], 0), M - next);
    next += rows;
    const int items = split_items(rows, T);
    if (items == 1) continue;
    const float* p = part + (size_t)slot * kn;
    bf16* o = out + (size_t)g * kn;
    for (size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8; e < kn; e += step) {
      if (vec) {  // kn is a multiple of 8
        float4 s0 = *reinterpret_cast<const float4*>(p + e);
        float4 s1 = *reinterpret_cast<const float4*>(p + e + 4);
        for (int i = 1; i < items; ++i) {
          const float4 t0 = *reinterpret_cast<const float4*>(p + i * kn + e);
          const float4 t1 = *reinterpret_cast<const float4*>(p + i * kn + e + 4);
          s0.x += t0.x; s0.y += t0.y; s0.z += t0.z; s0.w += t0.w;
          s1.x += t1.x; s1.y += t1.y; s1.z += t1.z; s1.w += t1.w;
        }
        *reinterpret_cast<uint4*>(o + e) = make_uint4(pack_bf16(s0.x, s0.y), pack_bf16(s0.z, s0.w),
                                                      pack_bf16(s1.x, s1.y), pack_bf16(s1.z, s1.w));
      } else {
        for (size_t j = e; j < e + 8 && j < kn; ++j) {
          float s = p[j];
          for (int i = 1; i < items; ++i) s += p[i * kn + j];
          o[j] = __float2bfloat16(s);
        }
      }
    }
    slot += items;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

cudaError_t sm_count(int* n) {
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached[dev]) {
    *n = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) cached[dev] = *n;
  return err;
}

// The row tiles of the local groups number at most ceil(M/BM) + GL - 1 and
// the zero tiles before and after the local span at most 2 more, so
// ceil(M/BM) + GL + 1 row tiles cover them; blocks past the last tile exit.
// The N tile varies fastest.
template <class T, bool TB>
cudaError_t launch(const void* lhs, const void* rhs, const void* sizes, void* out, int M, int K,
                   int N, int G, int off, int GL, int vec, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(gmm_kernel<T, TB>, T::bytes, done);
  if (err != cudaSuccess) return err;
  const long long blocks =
      ((long long)(M + T::BM - 1) / T::BM + GL + 1) * ((N + T::BN - 1) / T::BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  gmm_kernel<T, TB><<<(unsigned)blocks, T::NT, T::bytes, stream>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
      static_cast<const int*>(sizes), static_cast<bf16*>(out), M, K, N, G, off, GL, vec);
  return cudaGetLastError();
}

// The prefill tile when groups average 32 rows or more, else the decode
// tile. The choice reads all G groups, whatever the local span, so an
// expert shard's rows are computed with K6's tiles.
template <bool TB>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const void* sizes, void* out, int M,
                       int K, int N, int G, int off, int GL, int vec, cudaStream_t s) {
  if ((long long)M >= 32LL * (G > 0 ? G : 1))
    return launch<PrefillTile, TB>(lhs, rhs, sizes, out, M, K, N, G, off, GL, vec, s);
  return launch<DecodeTile, TB>(lhs, rhs, sizes, out, M, K, N, G, off, GL, vec, s);
}

// drhs's range T: 4x the mean group, at least 256 rows, in 64-row steps. A
// split group has more than T rows, so the split groups' items number
// fewer than 2M/T (the scratch's slots) and their extra items fewer than M/T.
int split_rows(int M, int G) {
  const long long mean = ((long long)M + G - 1) / G;
  const long long t = (std::max(256LL, 4 * mean) + 63) / 64 * 64;
  return (int)std::min(t, (long long)INT_MAX / 2);
}

long long drhs_slots(int M, int G) {
  const int T = split_rows(M, G);
  return M > T ? 2LL * M / T : 0;
}

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
  const int vec = (K % 8 == 0) && (N % 8 == 0) && aligned16(lhs) && aligned16(rhs) &&
                  aligned16(out);
  return launch_gmm<false>(lhs, rhs, sizes, out, M, K, N, G, group_offset, local_groups,
                           vec, static_cast<cudaStream_t>(stream));
}

// dlhs (M,K) = per-group grad (M,N) @ rhs[g]^T, rhs (G,K,N): the forward's
// kernel with N as its depth and K as its width, rhs read transposed.
extern "C" int ds_grouped_gemm_dlhs(const void* grad, const void* rhs, const void* sizes,
                                    void* out, int M, int K, int N, int G, void* stream) {
  if (M == 0 || K == 0) return cudaSuccess;
  if (M < 0 || N < 0 || K < 0 || G < 0) return cudaErrorInvalidValue;
  const int vec = (N % 8 == 0) && (K % 8 == 0) && aligned16(grad) && aligned16(rhs) &&
                  aligned16(out);
  return launch_gmm<true>(grad, rhs, sizes, out, M, N, K, G, 0, G, vec,
                          static_cast<cudaStream_t>(stream));
}

// The f32 scratch drhs needs for M rows over G groups into (G,K,N), in
// floats: room for every split group's partials, 0 when no group can be
// split.
extern "C" int ds_grouped_gemm_drhs_scratch(int M, int K, int N, int G, long long* floats) {
  *floats = (M > 0 && K > 0 && N > 0 && G > 0) ? drhs_slots(M, G) * K * N : 0;
  return cudaSuccess;
}

// drhs (G,K,N) = per-group lhs (M,K)^T @ grad (M,N); empty groups are zeros.
// scratch: ds_grouped_gemm_drhs_scratch's floats (null when that is 0).
extern "C" int ds_grouped_gemm_drhs(const void* lhs, const void* grad, const void* sizes,
                                    void* out, void* scratch, int M, int K, int N, int G,
                                    void* stream) {
  if (K == 0 || N == 0 || G == 0) return cudaSuccess;
  if (M < 0 || N < 0 || K < 0 || G < 0) return cudaErrorInvalidValue;
  const int T = split_rows(M, G);
  const bool split = drhs_slots(M, G) > 0;
  if (split && scratch == nullptr) return cudaErrorInvalidValue;
  const int vec = (K % 8 == 0) && (N % 8 == 0) && aligned16(lhs) && aligned16(grad) &&
                  aligned16(out) && (!split || aligned16(scratch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(tgmm_kernel, TgmmTile::bytes, done);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long units = ((long long)G + M / T) * ((K + TgmmTile::BMK - 1) / TgmmTile::BMK) *
                          ((N + TgmmTile::BN - 1) / TgmmTile::BN);
  tgmm_kernel<<<(int)std::min(units, (long long)TgmmTile::MINB * sms), TgmmTile::NT,
                TgmmTile::bytes, s>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(grad),
      static_cast<const int*>(sizes), static_cast<bf16*>(out), static_cast<float*>(scratch), M,
      K, N, G, T, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const long long chunks = ((long long)K * N + 2047) / 2048;
  drhs_reduce_kernel<<<(int)std::min(chunks, 4LL * sms), 256, 0, s>>>(
      static_cast<const float*>(scratch), static_cast<const int*>(sizes), static_cast<bf16*>(out),
      M, K, N, G, T, vec);
  return cudaGetLastError();
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
