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
//   * the scale is folded into the dequantized WEIGHT: w = bf16(f32(q) * s),
//     the f32 product rounded once, exactly the values
//     `dequantize_int8_blockwise(q, s, bf16)` gives; x is read as it is, and
//     the tensor cores accumulate x * w in f32. So the products are those of
//     the naive dequantize-then-matmul path and of the `dequant` serve mode,
//     and only the summation order differs. (The TPU kernel folds the scale
//     into the activation instead; an H100 measured the gate projection at
//     prefill 7.82 ms that way against 4.20 ms with the weight fold in the
//     earlier WMMA design.) The bf16 output is the other rounding;
//   * the dequantized weight never reaches global memory: each tile of q is
//     converted in shared memory or in registers and consumed there;
//   * loads past M, N or K are guarded and never read (the TPU kernel masks
//     its K remainder after the scale multiply because an out-of-bounds f32
//     scale may be NaN): a guarded element is zero in both operands.
//   * A column's K products are summed in an order fixed by M, K and the
//     kernel's constants, never by N or by where the column lies, so a
//     column shard of q (tensor parallelism's flavour 'n') gives the
//     unsharded call's columns bit for bit, and two calls the same bits.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at decode (M = 4) the
// kernel reads K*N int8 bytes of weight for 2*M*K*N operations, ~8 a byte
// against the card's ~295, so the weight read bounds it; at prefill
// (M = 2048) it does ~4000 operations a byte and the bf16 tensor cores
// bound it.
//
// Design: two kernels, chosen by M alone.
//   * Decode, M <= 16 (`qmm_decode_kernel`, bound by the weight bytes). K is
//     cut into slices of KS = 512 rows, a count fixed by K alone, and every
//     (128-column tile, K slice) is one block of four warps: 64 blocks for
//     k/v (N = 1024), 896 for gate/up and for down (K = 14,336). The block
//     stages its x slice (M rows) and, when the tile lies in one scale
//     group, the slice's row scales in shared memory once. Each warp takes
//     128 rows of the slice in eight k16 steps through a four-deep ring of
//     cp.async copies that only its own lane reads back (no barrier guards
//     it): four 16-byte weight rows a step and lane (and their scales when
//     the tile spans groups), refilled as soon as the step's products are
//     issued. The products run on mma.sync.m16n8k16: x is A (M padded to
//     16, rows past M zero), B the weight converted in registers without a
//     transpose: lane (g, t) holds rows 2t, 2t+1, 2t+8, 2t+9 of columns
//     16g..16g+15, so byte j of its four rows is column g of n8 tile j, and
//     the tiles' logical columns map back in the epilogue (lane (g', t')
//     holds 32 consecutive columns of rows g' and g' + 8). int8 -> f32 by
//     the exponent trick (prmt into 2^23 + u, one fadd), then the f32 scale
//     multiply and one bf16 rounding. The warps' sums meet in shared memory
//     in warp order; a slice writes its f32 partial into the wrapper's
//     workspace, and the tile's last slice to arrive (an integer count per
//     column tile, which it resets) sums every slice's partial in slice
//     order, one column a thread: no float atomics, the same bits on every
//     run and in either order of arrival. One slice writes bf16 directly.
//   * Prefill, M > 16 (`qmm_prefill_kernel`, bound by the tensor cores). A
//     block of four warpgroups computes a 256 x 128 tile, each warpgroup
//     m64n128 with f32 accumulators in registers, 64 rows of K a step: each
//     weight element is converted M / 256 times. Where 256-row tiles would
//     leave SMs idle (k/v at M = 2048: 64 tiles), two warpgroups compute
//     128 x 128 tiles; each 64-row slab runs the same products either way. x arrives K-major by TMA
//     (a 2D tensor map whose 128-byte swizzle is the tile's; rows past M
//     and columns past K zero-filled; completion on one mbarrier a stage)
//     into a ring of four stages, one 128-byte swizzle row of bf16 a stage;
//     the int8 weight tile arrives beside it by TMA too, the f32 scales by
//     cp.async (a strided gather: one a row when the tile lies in one scale
//     group, else one a thread).
//     Every thread converts one int8 chunk into one of two
//     alternating bf16 B tiles in the swizzled layout, read MN-major (tnspB)
//     by the descriptor, so step s + 1's conversion runs while the tensor
//     cores run step s, and step s + 3's copy is in flight meanwhile; two
//     barriers a step. The first product of a tile takes scale_d 0 and the
//     accumulators are fenced around each product (zeroed accumulators
//     serialised the products: ptxas C7515). The epilogue writes bf16
//     pairs from the registers under guard.
//   * Odd layouts (N not a multiple of 16, K not a multiple of 8, unaligned
//     bases) take guarded scalar loads into the same slots and guarded
//     scalar stores.
// What holds them (PERF.md, H100 80GB HBM3 at 700 W): decode reads its
// weights at ~1.0 TB/s, bound by its loads (128-byte row pieces, four rows
// a warp and step), not its arithmetic. Prefill runs at ~43% of the bf16
// peak at gate/up: the int8 conversion and the two barriers a step around
// it hold the products back. What is left: weight loads in longer row
// pieces (TMA boxes per warp) at decode, a producer split with enough
// converting warps to keep up (one warpgroup converting for two
// multiplying is too few), clusters that multicast the x tile, and fp8.

#include <cuda.h>  // CUtensorMap; the encoder itself is looked up at run time

#include "hopper_common.cuh"

namespace {

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Byte `sel` (0-3) of w ^ 0x80808080 as the int8 value it held, in f32:
// 0x4B0000uu is 2^23 + uu, and uu = b + 128.
__device__ __forceinline__ float s8f(uint32_t wx, uint32_t sel) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440u | sel)) - 8388736.f;
}

// 16 int8 weights (one 16-byte chunk of a row) times their row's f32
// scale, each product rounded once to bf16, as 8 packed pairs.
__device__ __forceinline__ void convert16(const uint4& raw, float s, uint32_t (&w)[8]) {
  const uint32_t r[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = pack_bf16(s8f(r[i], 0) * s, s8f(r[i], 1) * s);
    w[2 * i + 1] = pack_bf16(s8f(r[i], 2) * s, s8f(r[i], 3) * s);
  }
}

// Up to 16 guarded bytes of row k of q from column `col` into a 16-byte
// shared slot (the scalar path for odd N or an unaligned base).
__device__ __forceinline__ void load_q_scalar(unsigned char* dst, const int8_t* q, int k, int col,
                                              int K, int N) {
  __align__(16) int8_t b[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) b[e] = (k < K && col + e < N) ? q[(size_t)k * N + col + e] : 0;
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(b);
}

// ---------------------------------------------------------------- decode

namespace dec {
constexpr int WARPS = 4, NT = WARPS * 32;
constexpr int BN = NT;                      // columns a block (every warp's)
constexpr int STEPS = 8;                    // k16 steps a warp
constexpr int RING = 4;                     // of them in flight
constexpr int KS = WARPS * STEPS * 16;      // 512 rows: the K slice of a block
constexpr int W_BYTES = 4 * 32 * 16;        // a lane's four 16-byte weight chunks
constexpr int S_BYTES = 4 * 32 * 4;         // their four scales
constexpr int STAGE = W_BYTES + S_BYTES;
constexpr int XLD = KS + 8;                 // a row of the x slice: +16 bytes, no bank conflicts
constexpr int X = WARPS * RING * STAGE;     // the x slice, MT rows
constexpr int SC = X + 16 * XLD * 2;        // the slice's row scales (one group a tile)
constexpr int bytes = SC + KS * 4;          // 58.3 KB
static_assert((WARPS - 1) * 16 * 4 * 32 * 4 <= X, "the reduction reuses the rings");
}  // namespace dec

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: rows [kb, kb + KS) of K by columns [n0, n0 + 128). M16: M > 8,
// so A's rows 8-15 are live. part: the f32 partials (slices, M, N), and
// counters one zeroed int a column tile; both null when K fits one slice
// and the block writes bf16 to out.
template <bool M16>
__global__ void __launch_bounds__(dec::NT, 4)
qmm_decode_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ st, bf16* __restrict__ out, float* __restrict__ part,
                  int* __restrict__ counters, int M, int K, int N, int G, int g, int sj, int sk,
                  int qvec, int xvec, int ovec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MT = M16 ? 16 : 8;  // A's live rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int n0 = blockIdx.x * dec::BN, kb = blockIdx.y * dec::KS;
  const int k0 = kb + warp * dec::STEPS * 16;  // this warp's rows
  const int col = n0 + 16 * gq;                // this lane's 16 weight columns
  // one scale group over the tile: its row scales are staged once
  const bool uniform = G == 1 || n0 / g == (min(n0 + dec::BN, N) - 1) / g;
  const float* srow = st + (size_t)(G > 1 && col < N ? col / g : 0) * sj;
  unsigned char* ring = smem + warp * dec::RING * dec::STAGE;
  bf16* xs = reinterpret_cast<bf16*>(smem + dec::X);
  float* scs = reinterpret_cast<float*>(smem + dec::SC);

  // the block's x slice (rows past M and columns past K zero) and, for one
  // scale group, the slice's row scales: one group
  for (int i = threadIdx.x; i < MT * (dec::KS / 8); i += dec::NT) {
    const int m = i / (dec::KS / 8), c = (i % (dec::KS / 8)) * 8, k = kb + c;
    unsigned char* d = smem + dec::X + (m * dec::XLD + c) * 2;
    if (xvec) {
      const bool ok = m < M && k < K;  // K a multiple of 8: the chunk is whole
      cp_async16(d, ok ? x + (size_t)m * K + k : x, ok);
    } else {
      __align__(16) bf16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = (m < M && k + j < K) ? x[(size_t)m * K + k + j] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(e);
    }
  }
  if (uniform) {
    const float* s0 = st + (size_t)(G > 1 ? n0 / g : 0) * sj;
    for (int r = threadIdx.x; r < dec::KS; r += dec::NT) {
      const bool ok = kb + r < K;
      cp_async4(scs + r, ok ? s0 + (size_t)(kb + r) * sk : st, ok);
    }
  }
  cp_async_commit();

  // step s's weight copies into ring slot s % RING, one group a step (an
  // empty group past the last): a lane's four rows 2t, 2t+1, 2t+8, 2t+9
  // (and their scales, for several groups), read back by this lane only
  auto issue = [&](int s) {
    if (s < dec::STEPS) {
      unsigned char* stage = ring + (s % dec::RING) * dec::STAGE;
      const int kr = k0 + s * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kr + 2 * tq + (i & 1) + (i >> 1) * 8;
        const bool ok = k < K && col < N;
        unsigned char* d = stage + i * 512 + lane * 16;
        if (qvec)
          cp_async16(d, ok ? q + (size_t)k * N + col : q, ok);
        else
          load_q_scalar(d, q, k, col, K, N);
        if (!uniform)
          cp_async4(stage + dec::W_BYTES + i * 128 + lane * 4, ok ? srow + (size_t)k * sk : st,
                    ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < dec::RING; ++s) issue(s);

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll 2
  for (int s = 0; s < dec::STEPS; ++s) {
    // step s's copies have landed; before the first, every thread's x slice
    cp_async_wait<dec::RING - 1>();
    if (s == 0) __syncthreads();
    const unsigned char* stage = ring + (s % dec::RING) * dec::STAGE;
    const int kl = (warp * dec::STEPS + s) * 16 + 2 * tq;  // the lane's row 2t in the slice
    uint4 w[4];
    float sc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = *reinterpret_cast<const uint4*>(stage + i * 512 + lane * 16);
      sc[i] = uniform ? scs[kl + (i & 1) + (i >> 1) * 8]
                      : *reinterpret_cast<const float*>(stage + dec::W_BYTES + i * 128 + lane * 4);
    }
    const bf16* xr = xs + gq * dec::XLD + kl;
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(xr),
                           M16 ? *reinterpret_cast<const uint32_t*>(xr + 8 * dec::XLD) : 0u,
                           *reinterpret_cast<const uint32_t*>(xr + 8),
                           M16 ? *reinterpret_cast<const uint32_t*>(xr + 8 * dec::XLD + 8) : 0u};
    const uint32_t* wr[4] = {reinterpret_cast<const uint32_t*>(&w[0]),
                             reinterpret_cast<const uint32_t*>(&w[1]),
                             reinterpret_cast<const uint32_t*>(&w[2]),
                             reinterpret_cast<const uint32_t*>(&w[3])};
#pragma unroll
    for (int word = 0; word < 4; ++word) {
      const uint32_t r0 = wr[0][word] ^ 0x80808080u, r1 = wr[1][word] ^ 0x80808080u;
      const uint32_t r2 = wr[2][word] ^ 0x80808080u, r3 = wr[3][word] ^ 0x80808080u;
#pragma unroll
      for (int byte = 0; byte < 4; ++byte) {
        const uint32_t b0 = pack_bf16(s8f(r0, byte) * sc[0], s8f(r1, byte) * sc[1]);
        const uint32_t b1 = pack_bf16(s8f(r2, byte) * sc[2], s8f(r3, byte) * sc[3]);
        mma_16816(acc[word * 4 + byte], a, b0, b1);
      }
    }
    // the products consumed the slot: refill it, RING steps ahead
    issue(s + dec::RING);
  }
  cp_async_wait_all();

  // the four warps' sums, in warp order, in warp 0
  constexpr int E = M16 ? 4 : 2;
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with its ring
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) red[(((warp - 1) * 16 + j) * 4 + e) * 32 + lane] = acc[j][e];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int w2 = 0; w2 < dec::WARPS - 1; ++w2)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] += red[((w2 * 16 + j) * 4 + e) * 32 + lane];

    // lane (g', t') holds rows g' (e 0, 1) and g' + 8 (e 2, 3), columns
    // n0 + 32t' + j (e even) and n0 + 32t' + 16 + j (e odd) of tile j
    const int c0 = n0 + 32 * tq;
#pragma unroll
    for (int h = 0; h < E / 2; ++h) {
      const int m = gq + 8 * h;
      if (m >= M) continue;
      float v[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[j] = acc[j][2 * h];
        v[16 + j] = acc[j][2 * h + 1];
      }
      if (part != nullptr) {  // this slice's f32 partial
        float* d = part + ((size_t)blockIdx.y * M + m) * N;
        if (N % 4 == 0) {
#pragma unroll
          for (int c = 0; c < 32; c += 4)
            if (c0 + c < N)
              __stcg(reinterpret_cast<float4*>(d + c0 + c),
                     make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]));
        } else {
#pragma unroll
          for (int c = 0; c < 32; ++c)
            if (c0 + c < N) __stcg(d + c0 + c, v[c]);
        }
      } else {  // the one slice: bf16 out
        bf16* d = out + (size_t)m * N;
        if (N % 8 == 0 && ovec) {
#pragma unroll
          for (int c = 0; c < 32; c += 8)
            if (c0 + c < N)
              *reinterpret_cast<uint4*>(d + c0 + c) =
                  make_uint4(pack_bf16(v[c], v[c + 1]), pack_bf16(v[c + 2], v[c + 3]),
                             pack_bf16(v[c + 4], v[c + 5]), pack_bf16(v[c + 6], v[c + 7]));
        } else {
#pragma unroll
          for (int c = 0; c < 32; ++c)
            if (c0 + c < N) d[c0 + c] = __float2bfloat16(v[c]);
        }
      }
    }
  }
  if (part == nullptr) return;

  // Split K: the tile's last slice to arrive (an integer count per column
  // tile, left at 0 for the next call) sums every slice's partial in slice
  // order, one column a thread, so the bits do not depend on the order of
  // arrival.
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(smem + dec::SC);  // the scales are read
  if (threadIdx.x == 0) *last = atomicAdd(counters + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const int oc = n0 + threadIdx.x;  // BN == NT
  if (oc < N) {
    constexpr int MT = M16 ? 16 : 8, U = 4;
    const int slices = gridDim.y;
    float sum[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) sum[m] = 0.f;
    int p = 0;
    for (; p + U <= slices; p += U) {
      float v[U][MT];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          v[u][m] = m < M ? __ldcg(part + ((size_t)(p + u) * M + m) * N + oc) : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m) sum[m] += v[u][m];
    }
    for (; p < slices; ++p)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < M) sum[m] += __ldcg(part + ((size_t)p * M + m) * N + oc);
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < M) out[(size_t)m * N + oc] = __float2bfloat16(sum[m]);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

int dec_slices(int K) { return (K + dec::KS - 1) / dec::KS; }

// ---------------------------------------------------------------- prefill

// The prefill tile: NWG warpgroups of 64 rows each by 128 columns, 64 rows
// of K a stage, four stages.
template <int NWG>
struct Pre {
  static constexpr int NT = NWG * 128;
  static constexpr int BM = NWG * 64, BN = 128, BK = 64, R = 4;
  static constexpr int X_BYTES = BM * 128;       // x: BM rows of one 128-byte swizzle row
  static constexpr int Q_BYTES = BK * BN;        // the int8 weight tile: 64 rows of 128
  static constexpr int CH = Q_BYTES / 16 / NT;   // its 16-byte chunks a thread
  static constexpr int S_BYTES = Q_BYTES / 16 * 4;  // the scales: one a chunk, or one a row
  static constexpr int STAGE = X_BYTES + Q_BYTES + S_BYTES;
  static constexpr int CBLK = BK * 128;          // one 64-column block of the bf16 B tile
  static constexpr int B_BYTES = (BN / 64) * CBLK;
  static constexpr int XCH = BM * 8 / NT;        // x chunks a thread a stage (scalar path)
  static constexpr int BARS = 2 * B_BYTES + R * STAGE;  // one mbarrier a stage (TMA)
  static constexpr int bytes = BARS + R * 8 + 1024;      // + alignment slack
  static_assert(STAGE % 1024 == 0 && B_BYTES % 1024 == 0 && CH >= 1 && NT >= BK, "tiles");
};

__device__ __forceinline__ void mbar_init(void* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect(void* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(void* bar, int phase) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}
// the (c0, c1) box of a 2D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            void* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// A block of NWG warpgroups computes a (64 NWG) x 128 tile of out, each
// warpgroup 64 rows (m64n128, f32 accumulators in registers). TMA: x and
// the int8 tile arrive by TMA through `xmap` (whose 128-byte swizzle is the
// x tile's) and `qmap`, completing on the stage's mbarrier; else (an odd K
// or N, an unaligned base) by guarded scalar loads. The scales arrive by
// cp.async: one a row when the tile lies in one scale group, else one a
// thread for its chunk's group.
template <int NWG, bool TMA>
__global__ void __launch_bounds__(Pre<NWG>::NT, 1)
qmm_prefill_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
                   const bf16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ st, bf16* __restrict__ out, int M, int K, int N,
                   int G, int g, int sj, int sk, int ovec) {
  using pre = Pre<NWG>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* bbuf = smem;                     // two bf16 B tiles
  unsigned char* ring = smem + 2 * pre::B_BYTES;  // R stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + pre::BARS);
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * pre::BM, n0 = blockIdx.y * pre::BN;
  const int nk = (K + pre::BK - 1) / pre::BK;
  const bool uniform = G == 1 || n0 / g == (min(n0 + pre::BN, N) - 1) / g;

  // This thread's int8 chunks: chunk u = tid + NT*j is row u / 8 of the
  // tile and 16-byte chunk u % 8 (eight neighbouring threads read one row,
  // every bank once), the same every step; column 16 * (tid % 8) of the
  // tile. One group a tile: threads below 64 copy its 64 row scales; else
  // each chunk's own.
  const int qc = tid % 8, col = n0 + 16 * qc;
  const float* srow = uniform ? st + (size_t)(G > 1 ? n0 / g : 0) * sj
                              : st + (size_t)(col < N ? col / g : 0) * sj;

  auto issue = [&](int s) {  // stage s's copies (an empty group past the last)
    if (s < nk) {
      unsigned char* stage = ring + (s % pre::R) * pre::STAGE;
      const int k0 = s * pre::BK;
      if constexpr (TMA) {  // past M, N or K the boxes are zero-filled
        if (tid == 0) {
          mbar_expect(bars + s % pre::R, pre::X_BYTES + pre::Q_BYTES);
          tma_load_2d(stage, &xmap, k0, m0, bars + s % pre::R);
          tma_load_2d(stage + pre::X_BYTES, &qmap, n0, k0, bars + s % pre::R);
        }
      } else {
        const int xc = tid % 8;
#pragma unroll
        for (int i = 0; i < pre::XCH; ++i) {
          const int r = (tid + pre::NT * i) / 8, m = m0 + r, k = k0 + 8 * xc;
          __align__(16) bf16 e[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = (m < M && k + j < K) ? x[(size_t)m * K + k + j] : __float2bfloat16(0.f);
          *reinterpret_cast<uint4*>(stage + r * 128 + ((xc ^ (r % 8)) << 4)) =
              *reinterpret_cast<const uint4*>(e);
        }
#pragma unroll
        for (int j = 0; j < pre::CH; ++j) {
          const int qr = (tid + pre::NT * j) / 8;
          load_q_scalar(stage + pre::X_BYTES + qr * pre::BN + qc * 16, q, k0 + qr, col, K, N);
        }
      }
      float* sdst = reinterpret_cast<float*>(stage + pre::X_BYTES + pre::Q_BYTES);
      if (uniform) {
        if (tid < pre::BK) {
          const bool ok = k0 + tid < K;
          cp_async4(sdst + tid, ok ? srow + (size_t)(k0 + tid) * sk : st, ok);
        }
      } else {
#pragma unroll
        for (int j = 0; j < pre::CH; ++j) {
          const int u = tid + pre::NT * j, k = k0 + u / 8;
          const bool ok = k < K && col < N;
          cp_async4(sdst + u, ok ? srow + (size_t)k * sk : st, ok);
        }
      }
    }
    cp_async_commit();
  };
  // stage s's int8 chunks, each times its row's scale, into B tile s % 2
  // (swizzled, n along the 128-byte rows: read MN-major): bf16 chunks 2qc
  // and 2qc + 1 of row qr, in column block qc / 4
  auto convert = [&](int s) {
    const unsigned char* stage = ring + (s % pre::R) * pre::STAGE;
    const float* sc = reinterpret_cast<const float*>(stage + pre::X_BYTES + pre::Q_BYTES);
#pragma unroll
    for (int j = 0; j < pre::CH; ++j) {
      const int u = tid + pre::NT * j, qr = u / 8;
      uint32_t w[8];
      convert16(*reinterpret_cast<const uint4*>(stage + pre::X_BYTES + qr * pre::BN + qc * 16),
                uniform ? sc[qr] : sc[u], w);
      unsigned char* row = bbuf + (s % 2) * pre::B_BYTES + (qc / 4) * pre::CBLK + qr * 128;
      const int ch = 2 * (qc % 4);
      *reinterpret_cast<uint4*>(row + ((ch ^ (qr % 8)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(row + (((ch + 1) ^ (qr % 8)) << 4)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
  };

  float acc[pre::BN / 2];  // set by the first product (scale_d 0)
  if (TMA && tid == 0) {
#pragma unroll
    for (int i = 0; i < pre::R; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < pre::R - 1; ++s) issue(s);
  cp_async_wait<pre::R - 2>();
  __syncthreads();
  if constexpr (TMA) mbar_wait(bars, 0);
  convert(0);
  fence_async_smem();
  __syncthreads();

  for (int s = 0; s < nk; ++s) {
    const unsigned char* a = ring + (s % pre::R) * pre::STAGE + wg * 64 * 128;
    const unsigned char* b = bbuf + (s % 2) * pre::B_BYTES;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < pre::BK / 16; ++kk)
      wgmma_ss<pre::BN, 0, 1>(acc, make_desc(a + kk * 32, 16, 1024),
                              make_desc(b + kk * 2048, pre::CBLK, 1024), s > 0 || kk > 0);
    wg_commit();
    fence_acc(acc);
    // while step s's products run: step s - 1's are done (every warpgroup,
    // after the barrier), so B tile (s + 1) % 2 and stage (s - 1) % R are
    // free; once stage s + 1 has landed, convert it and start stage s + R - 1
    wg_wait<1>();
    cp_async_wait<pre::R - 3>();
    __syncthreads();
    issue(s + pre::R - 1);
    if (s + 1 < nk) {
      if constexpr (TMA) mbar_wait(bars + (s + 1) % pre::R, ((s + 1) / pre::R) & 1);
      convert(s + 1);
    }
    fence_async_smem();
    __syncthreads();
  }
  wg_wait_all();
  fence_acc(acc);
  cp_async_wait_all();

  // bf16 pairs from the registers: a thread holds rows r and r + 8 of its
  // warp's 16, two adjacent columns of every 8
  const int lane = tid % 32;
  const int r = m0 + wg * 64 + ((tid / 32) % 4) * 16 + lane / 4;
  const bool pairs = (N % 2 == 0) && ovec;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r + 8 * h;
    if (m >= M) continue;
    bf16* d = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < pre::BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs) {
        if (c < N) *reinterpret_cast<uint32_t*>(d + c) = pack_bf16(v0, v1);
      } else {
        if (c < N) d[c] = __float2bfloat16(v0);
        if (c + 1 < N) d[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// A 2D tensor map over `base` (outer rows of `inner` elements, `stride`
// bytes apart) in boxes of box_inner x box_outer; the driver's encoder is
// looked up once.
cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                          long long inner, long long outer, long long stride, int box_inner,
                          int box_outer, CUtensorMapSwizzle swizzle) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NWG>
cudaError_t launch_prefill(const bf16* x, const int8_t* q, const float* st, bf16* out, int M,
                           int K, int N, int G, int g, int sj, int sk, int qvec, int ovec,
                           cudaStream_t s) {
  using pre = Pre<NWG>;
  const dim3 grid((M + pre::BM - 1) / pre::BM, (N + pre::BN - 1) / pre::BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  static bool done[2][MAX_DEVICES] = {};
  CUtensorMap xmap = {}, qmap = {};
  if ((K % 8 == 0) && aligned(x, 16) && qvec) {  // TMA: 16-byte rows and bases
    cudaError_t err = allow_smem(qmm_prefill_kernel<NWG, true>, pre::bytes, done[1]);
    if (err == cudaSuccess)
      err = tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, 64, pre::BM,
                          CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = tensor_map_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N, pre::BN, pre::BK,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
    qmm_prefill_kernel<NWG, true><<<grid, pre::NT, pre::bytes, s>>>(
        xmap, qmap, x, q, st, out, M, K, N, G, g, sj, sk, ovec);
  } else {
    cudaError_t err = allow_smem(qmm_prefill_kernel<NWG, false>, pre::bytes, done[0]);
    if (err != cudaSuccess) return err;
    qmm_prefill_kernel<NWG, false><<<grid, pre::NT, pre::bytes, s>>>(
        xmap, qmap, x, q, st, out, M, K, N, G, g, sj, sk, ovec);
  }
  return cudaGetLastError();
}

int sm_count() {
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < MAX_DEVICES && cached[dev]) return cached[dev];
  int n = 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 1;
  if (dev < MAX_DEVICES) cached[dev] = n;
  return n;
}

}  // namespace

// The workspace a call needs: the decode path's f32 partials (one M x N
// slab a K slice) and its count per column tile, zeroed once (the kernel
// leaves them at 0), when K spans more than one slice; else 0 and 0.
extern "C" int ds_quantized_matmul_workspace(int M, int K, int N, long long* floats,
                                             int* counters) {
  const bool split = M > 0 && M <= 16 && N > 0 && dec_slices(K) > 1;
  *floats = split ? (long long)dec_slices(K) * M * N : 0;
  *counters = split ? (N + dec::BN - 1) / dec::BN : 0;
  return cudaSuccess;
}

// x (M,K) bf16, q (K,N) int8, st (G,K) f32 through strides (sj, sk), g = N/G
// -> out (M,N) bf16. scratch, counters: ds_quantized_matmul_workspace's
// (null when it gives 0).
extern "C" int ds_quantized_matmul(const void* x, const void* q, const void* st, void* out,
                                   void* scratch, void* counters, int M, int K, int N, int G,
                                   int g, int sj, int sk, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (M < 0 || N < 0 || K <= 0 || G <= 0 || g <= 0 || (G > 1 && (g % 32 || G * g != N)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sb = static_cast<const float*>(st);
  bf16* ob = static_cast<bf16*>(out);
  const int qvec = (N % 16 == 0) && aligned(q, 16);
  const int ovec = aligned(out, 16);
  if (M <= 16) {
    const int slices = dec_slices(K);
    if (slices > 65535) return cudaErrorInvalidValue;
    float* part = slices > 1 ? static_cast<float*>(scratch) : nullptr;
    int* count = slices > 1 ? static_cast<int*>(counters) : nullptr;
    if (slices > 1 && (part == nullptr || count == nullptr || !aligned(part, 16)))
      return cudaErrorInvalidValue;
    const int xvec = (K % 8 == 0) && aligned(x, 16);
    const dim3 grid((N + dec::BN - 1) / dec::BN, slices);
    static bool done[2][MAX_DEVICES] = {};
    cudaError_t err = M > 8 ? allow_smem(qmm_decode_kernel<true>, dec::bytes, done[1])
                            : allow_smem(qmm_decode_kernel<false>, dec::bytes, done[0]);
    if (err != cudaSuccess) return err;
    if (M > 8)
      qmm_decode_kernel<true><<<grid, dec::NT, dec::bytes, s>>>(
          xb, qb, sb, ob, part, count, M, K, N, G, g, sj, sk, qvec, xvec, ovec);
    else
      qmm_decode_kernel<false><<<grid, dec::NT, dec::bytes, s>>>(
          xb, qb, sb, ob, part, count, M, K, N, G, g, sj, sk, qvec, xvec, ovec);
    return cudaGetLastError();
  }
  // 256-row tiles, unless they would leave SMs idle: 128-row tiles then.
  // Each 64-row slab of a tile runs the same products in the same order
  // either way, so the choice changes no bit.
  const long long tiles = (long long)((M + 255) / 256) * ((N + 127) / 128);
  if (tiles < sm_count()) return launch_prefill<2>(xb, qb, sb, ob, M, K, N, G, g, sj, sk, qvec, ovec, s);
  return launch_prefill<4>(xb, qb, sb, ob, M, K, N, G, g, sj, sk, qvec, ovec, s);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
