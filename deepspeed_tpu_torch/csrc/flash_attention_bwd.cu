// Flash attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bf16 in, f32 accumulation.
//
// Replaces the TPU kernels of `deepspeed_tpu/ops/pallas/flash_attention.py`
// `_bwd` (:425): `_dq_kernel` (:204) / `_dq_kernel_tri` (:235) with
// `_dq_update` (:184), and `_dkv_kernel` (:279) / `_dkv_kernel_tri` (:315)
// with `_dkv_update` (:257) and the GQA group sum (:553). The triangular and
// rectangular TPU grids compute the same function; here one kernel of each
// kind covers both. It computes what those kernels compute:
//   * q, dO (B,Sq,H,D) and k, v (B,Sk,Hkv,D) bf16; the forward's base-2
//     lse and delta = rowsum(dO*O) (B,H,Sq) f32, delta taken outside, as
//     `_bwd` takes it (:434);
//   * qs = q*(softmax_scale*log2 e) rounded to bf16, the forward's operand;
//   * p = exp2(qs.k^T - lse), with bottom-right aligned causal masking
//     (key j seen by query i when j <= i + Sk - Sq); masked entries, keys
//     past Sk and queries past Sq get p = 0 exactly;
//   * ds = p*(dO.v^T - delta);
//   * dq = softmax_scale * sum_j ds.k, with ds rounded to bf16 (:199, :232);
//   * dk = ln2 * sum_i ds^T.qs with ds rounded to bf16 (:274, :311);
//   * dv = sum_i p^T.dO. The TPU kernel keeps p in f32 for this product
//     (:267); here p is rounded to bf16 for the tensor cores, which moves dv
//     by about 2^-9 relative, well inside the 2e-2 bf16 tolerance against
//     the plain version.
//
// Bound on an H100: five products of 2*D operations each per live
// (query, key) pair and head, 10*D in all (S and dP are computed in both
// kernels, so the kernels do 14*D), against reading q, k, v, o, dO, lse and
// delta and writing dq, dk and dv once. At B=4, S=2048, H=32, Hkv=4, D=64
// causal that is 1.72e11 operations (0.174 ms at 989 TFLOP/s bf16) against
// ~0.2 GB (0.06 ms at 3.35 TB/s): the tensor cores bound it.
//
// Design. Nothing is carried between blocks, so each kernel owns its
// outputs outright: there is no (B,H,Sk,D) f32 intermediate and no atomic,
// and the result is deterministic (remat re-runs the forward, and a run with
// remat must match one without).
//   * dq: one block per (q tile of 64 rows, head, batch), four warps of 16
//     rows each. The block walks the KV tiles of 64 keys up to the causal
//     stop (`hi` of :497); S = qs.K^T and dP = dO.V^T run on the tensor cores
//     through WMMA bf16 16x16x16 fragments, p and ds are formed in shared
//     memory, and dq accumulates in registers (f32 fragments) across tiles.
//   * dk/dv: one block per (kv tile of 64 keys, KV head, batch), four warps
//     of 16 keys each. The block loops over the n_rep query heads of its GQA
//     group and, for each, over the q tiles from the causal start (`lo` of
//     :523); it forms S^T = K.qs^T and dP^T = V.dO^T, then dV += P^T.dO and
//     dK += dS^T.qs into f32 accumulators in shared memory, for the whole
//     group, and writes dk and dv once.
// The causal mask is evaluated only on tiles that cross the diagonal or the
// sequence ends. mma.sync/wgmma with the accumulators in registers, TMA
// loads and a deeper pipeline are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NWARPS = 4;    // each warp owns 16 rows of the block's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float LN2 = 0.6931471805599453f;

// Leading dimensions are padded against bank conflicts and keep every
// 16-row fragment 32-byte aligned, as WMMA requires.
template <int D>
struct Pad {
  static constexpr int LDQ = D + 8;   // bf16 tiles of q, dO, k and v
  static constexpr int LDS = 64 + 4;  // f32 S and dP tiles
  static constexpr int LDP = 64 + 8;  // bf16 p and ds tiles
  static constexpr int LDA = D + 4;   // f32 dk/dv accumulators
  static constexpr int TILE = 64 * LDQ * 2;
};

template <int D>
struct DqLayout : Pad<D> {
  using P = Pad<D>;
  static constexpr int q = 0;
  static constexpr int dout = q + P::TILE;
  static constexpr int k = dout + P::TILE;
  static constexpr int v = k + P::TILE;
  static constexpr int s = v + P::TILE;
  static constexpr int dp = s + 64 * P::LDS * 4;
  static constexpr int ds = dp + 64 * P::LDS * 4;
  static constexpr int lse = ds + 64 * P::LDP * 2;
  static constexpr int delta = lse + 64 * 4;
  static constexpr int bytes = delta + 64 * 4;
};

template <int D>
struct DkvLayout : Pad<D> {
  using P = Pad<D>;
  static constexpr int k = 0;
  static constexpr int v = k + P::TILE;
  static constexpr int q = v + P::TILE;
  static constexpr int dout = q + P::TILE;
  static constexpr int s = dout + P::TILE;
  static constexpr int dp = s + 64 * P::LDS * 4;
  static constexpr int p = dp + 64 * P::LDS * 4;
  static constexpr int ds = p + 64 * P::LDP * 2;
  static constexpr int dk = ds + 64 * P::LDP * 2;
  static constexpr int dv = dk + 64 * P::LDA * 4;
  static constexpr int lse = dv + 64 * P::LDA * 4;
  static constexpr int delta = lse + 64 * 4;
  static constexpr int bytes = delta + 64 * 4;
};

// Copy rows [r0, r0+64) of a (rows, stride) bf16 matrix into shared memory
// with 16-byte loads; rows at or past `nrows` are zero. With `scale` != 0
// every element is multiplied by it in f32 and rounded back to bf16 (qs).
template <int D, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int nrows, int stride, float scale) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + c * 8);
      if (scale != 0.f) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// Rows [r0, r0+64) of one head's (B,H,Sq) f32 row vector; zero past `n`.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < 64; i += NTHREADS) dst[i] = (r0 + i < n) ? src[r0 + i] : 0.f;
}

// acc[n] (16 x 16 f32) = A (16 x D, row-major bf16) . B^T, for the 64 rows
// of B (64 x D, row-major bf16) taken as four column fragments.
template <int D, int LD>
__device__ __forceinline__ void rows_times_tile_t(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[4],
    const bf16* a, const bf16* b) {
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, LD);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      // B stored [row][d] is B^T in column-major order
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + n * 16 * LD + kk, LD);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Sk, int H, int Hkv,
                    int causal, float qscale, float scale) {
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int offset = Sk - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  const size_t row = (size_t)b * Sq * H + h;
  load_rows<D, L::LDQ>(sQ, q + row * D, q0, Sq, H * D, qscale);
  load_rows<D, L::LDQ>(sDO, dout + row * D, q0, Sq, H * D, 0.f);
  load_vec(sLse, lse + ((size_t)b * H + h) * Sq, q0, Sq);
  load_vec(sDelta, delta + ((size_t)b * H + h) * Sq, q0, Sq);
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * D;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    // the last key any row of this tile may see decides where it stops
    const int last_key = min(q0 + BQ, Sq) - 1 + offset;
    n_tiles = min(n_tiles, last_key / BK + 1);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_rows<D, L::LDQ>(sK, kb, k0, Sk, Hkv * D, 0.f);
    load_rows<D, L::LDQ>(sV, vb, k0, Sk, Hkv * D, 0.f);
    __syncthreads();

    // S = qs.K^T and dP = dO.V^T for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[4];
      rows_times_tile_t<D, L::LDQ>(f, sQ + r0 * L::LDQ, sK);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(sS + r0 * L::LDS + n * 16, f[n], L::LDS, wmma::mem_row_major);
      rows_times_tile_t<D, L::LDQ>(f, sDO + r0 * L::LDQ, sV);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(sDP + r0 * L::LDS + n * 16, f[n], L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // p and ds, one row at a time; the mask only where the tile crosses the
    // diagonal or the end of the keys
    const bool masked = (causal && k0 + BK - 1 > q0 + offset) || k0 + BK > Sk;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int last = q0 + r + offset;  // last key this row may see
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const int kc = k0 + c;
        float p = 0.f;
        if (!masked || (kc < Sk && !(causal && kc > last)))
          p = exp2f(sS[r * L::LDS + c] - sLse[r]);
        sDS[r * L::LDP + c] = __float2bfloat16(p * (sDP[r * L::LDS + c] - sDelta[r]));
      }
    }
    __syncwarp();

    // dq += ds.K for this warp's 16 rows
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(fa[kk], sDS + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sK + kk * 16 * L::LDQ + n * 16, L::LDQ);
          wmma::mma_sync(acc[n], fa[kk], fb, acc[n]);
        }
      }
    }
  }

  // dq = acc * scale, staged 64 columns at a time through this warp's rows
  // of the S tile
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 64) {
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(sS + r0 * L::LDS + n * 16, acc[c0 / 16 + n], L::LDS,
                              wmma::mem_row_major);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int qi = q0 + r0 + rr;
      if (qi >= Sq) break;
      bf16* out = dq + (((size_t)b * Sq + qi) * H + h) * D + c0;
      for (int c = lane; c < 64; c += 32)
        out[c] = __float2bfloat16(sS[(r0 + rr) * L::LDS + c] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                     int H, int Hkv, int causal, float qscale) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::dout);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sDK = reinterpret_cast<float*>(smem + L::dk);
  float* sDV = reinterpret_cast<float*>(smem + L::dv);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = H / Hkv;
  const int offset = Sk - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_rows<D, L::LDQ>(sK, k + ((size_t)b * Sk * Hkv + hk) * D, k0, Sk, Hkv * D, 0.f);
  load_rows<D, L::LDQ>(sV, v + ((size_t)b * Sk * Hkv + hk) * D, k0, Sk, Hkv * D, 0.f);
  for (int i = threadIdx.x; i < 64 * L::LDA; i += NTHREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }

  // the first q tile with a row that sees key k0 (`lo` of the TPU kernel)
  int lo = 0;
  if (causal && k0 - offset > 0) lo = (k0 - offset) / BQ;
  const int nq = (Sq + BQ - 1) / BQ;

  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
    const bf16* dob = dout + ((size_t)b * Sq * H + h) * D;
    const float* lseb = lse + ((size_t)b * H + h) * Sq;
    const float* deltab = delta + ((size_t)b * H + h) * Sq;
    for (int i = lo; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // the previous tile's q and dO are no longer read
      load_rows<D, L::LDQ>(sQ, qb, q0, Sq, H * D, qscale);
      load_rows<D, L::LDQ>(sDO, dob, q0, Sq, H * D, 0.f);
      load_vec(sLse, lseb, q0, Sq);
      load_vec(sDelta, deltab, q0, Sq);
      __syncthreads();

      // S^T = K.qs^T and dP^T = V.dO^T for this warp's 16 keys
      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[4];
        rows_times_tile_t<D, L::LDQ>(f, sK + r0 * L::LDQ, sQ);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::store_matrix_sync(sS + r0 * L::LDS + n * 16, f[n], L::LDS, wmma::mem_row_major);
        rows_times_tile_t<D, L::LDQ>(f, sV + r0 * L::LDQ, sDO);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::store_matrix_sync(sDP + r0 * L::LDS + n * 16, f[n], L::LDS, wmma::mem_row_major);
      }
      __syncwarp();

      // p^T and ds^T, one key at a time; the mask only where the tile
      // crosses the diagonal or the end of the keys or queries
      const bool masked = (causal && k0 + BK - 1 > q0 + offset) || k0 + BK > Sk ||
                          q0 + BQ > Sq;
      for (int rr = 0; rr < 16; ++rr) {
        const int j = r0 + rr;
        const int kj = k0 + j;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const int qi = q0 + c;
          float p = 0.f;
          if (!masked || (kj < Sk && qi < Sq && !(causal && kj > qi + offset)))
            p = exp2f(sS[j * L::LDS + c] - sLse[c]);
          sP[j * L::LDP + c] = __float2bfloat16(p);
          sDS[j * L::LDP + c] = __float2bfloat16(p * (sDP[j * L::LDS + c] - sDelta[c]));
        }
      }
      __syncwarp();

      // dV += p^T.dO and dK += ds^T.qs for this warp's 16 keys
      {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp[BQ / 16], fd[BQ / 16];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wmma::load_matrix_sync(fp[kk], sP + r0 * L::LDP + kk * 16, L::LDP);
          wmma::load_matrix_sync(fd[kk], sDS + r0 * L::LDP + kk * 16, L::LDP);
        }
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> av, ak;
          wmma::load_matrix_sync(av, sDV + r0 * L::LDA + n * 16, L::LDA, wmma::mem_row_major);
          wmma::load_matrix_sync(ak, sDK + r0 * L::LDA + n * 16, L::LDA, wmma::mem_row_major);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, sDO + kk * 16 * L::LDQ + n * 16, L::LDQ);
            wmma::mma_sync(av, fp[kk], fb, av);
            wmma::load_matrix_sync(fb, sQ + kk * 16 * L::LDQ + n * 16, L::LDQ);
            wmma::mma_sync(ak, fd[kk], fb, ak);
          }
          wmma::store_matrix_sync(sDV + r0 * L::LDA + n * 16, av, L::LDA, wmma::mem_row_major);
          wmma::store_matrix_sync(sDK + r0 * L::LDA + n * 16, ak, L::LDA, wmma::mem_row_major);
        }
      }
    }
  }
  __syncwarp();

  // dk = ln2 * acc, dv = acc, this warp's 16 keys, once
  for (int rr = 0; rr < 16; ++rr) {
    const int j = r0 + rr;
    const int kj = k0 + j;
    if (kj >= Sk) break;
    const size_t o = (((size_t)b * Sk + kj) * Hkv + hk) * D;
    for (int c = lane; c < D; c += 32) {
      dk[o + c] = __float2bfloat16(sDK[j * L::LDA + c] * LN2);
      dv[o + c] = __float2bfloat16(sDV[j * L::LDA + c]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int Sq,
                      int Sk, int H, int Hkv, int causal, float qscale, float scale,
                      cudaStream_t stream) {
  constexpr int bytes = DqLayout<D>::bytes;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Sq, Sk, H, Hkv, causal, qscale, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B,
                       int Sq, int Sk, int H, int Hkv, int causal, float qscale,
                       cudaStream_t stream) {
  constexpr int bytes = DkvLayout<D>::bytes;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BK - 1) / BK, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, Hkv, causal, qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ds_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, void* dq, int B, int Sq,
                                         int Sk, int H, int Hkv, int D, int causal,
                                         float qscale, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal,
                           qscale, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal,
                            qscale, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ds_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, int B,
                                          int Sq, int Sk, int H, int Hkv, int D,
                                          int causal, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal,
                            qscale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal,
                             qscale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
