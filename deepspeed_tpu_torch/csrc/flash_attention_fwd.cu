// Flash attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces the TPU kernel `deepspeed_tpu/ops/pallas/flash_attention.py`
// `_fwd` (:353) with `_fwd_kernel` (:124), `_fwd_kernel_tri` (:157),
// `_fwd_update` (:95) and `_fwd_finalize` (:115), reached from
// `flash_attention` (:593). It computes what that kernel computes:
//   * q (B,Sq,H,D), k/v (B,Sk,Hkv,D) bf16 -> out (B,Sq,H,D) bf16 and a base-2
//     log-sum-exp lse (B,H,Sq) f32;
//   * q is pre-scaled by softmax_scale*log2(e) and rounded to bf16 (:564), so
//     the softmax runs in the base-2 domain: p = exp2(s - m);
//   * p is rounded to bf16 before P.V, the running sum l takes the f32 p;
//   * causal masking is bottom-right aligned (key j is seen by query i when
//     j <= i + Sk - Sq), masked logits are NEG_INF = -1e30, l == 0 is guarded;
//   * GQA reads KV head h / (H/Hkv) directly, with no repeat_kv copy.
//
// Bound on an H100: the work is 4*Sq*Sk*D operations per head (about half
// of that when causal) against reading q, k, v and writing out and lse once.
// At B=4, S=512, H=32, Hkv=8, D=128 causal that is ~8.6 GFLOP (8.7 us at
// 989 TFLOP/s bf16) against ~42 MB (12.6 us at 3.35 TB/s): bytes bound it
// there, and from about S=1k up the tensor cores do.
//
// Design: one thread block per (q tile of 64 rows, head, batch), four warps,
// each warp owning 16 query rows from start to end. The block walks the KV
// tiles of 64 keys in order; K and V tiles are staged in shared memory and
// both products (Q.K^T and P.V) run on the tensor cores through WMMA bf16
// 16x16x16 fragments with f32 accumulation. The running max, running sum and
// the f32 output accumulator stay in shared memory (the accumulator fragment
// layout is opaque, so the per-row rescale happens there). A causal q tile
// stops at the tile that holds its last row's diagonal key: that is the GPU
// form of the TPU kernel's triangular grid and clamped KV index map, and it
// means a causal call reads and multiplies only the live half of the tiles.
// wgmma, TMA and warp specialisation are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per KV tile
constexpr int NWARPS = 4;    // each warp owns BQ / NWARPS = 16 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout; leading dimensions are padded against bank conflicts
// and keep every 16-row fragment 32-byte aligned, as WMMA requires.
template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 rows of Q, K and V
  static constexpr int LDS = BK + 4;  // f32 logits
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // f32 output accumulator
  static constexpr int q = 0;
  static constexpr int k = q + BQ * LDQ * 2;
  static constexpr int v = k + BK * LDQ * 2;
  static constexpr int s = v + BK * LDQ * 2;
  static constexpr int p = s + BQ * LDS * 4;
  static constexpr int o = p + BQ * LDP * 2;
  static constexpr int m = o + BQ * LDO * 4;
  static constexpr int l = m + BQ * 4;
  static constexpr int bytes = l + BQ * 4;
};

// Copy rows [r0, r0+BK) of a (rows, stride) bf16 matrix into shared memory
// with 16-byte loads; rows at or past `nrows` are zero.
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int nrows, int stride) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 int causal, float qscale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int offset = Sk - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * D;

  // Q tile, pre-scaled by softmax_scale*log2(e) and rounded to bf16
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BQ * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq) {
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * H * D + c * 8);
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
    }
    *reinterpret_cast<uint4*>(sQ + r * L::LDQ + c * 8) = val;
  }
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    // the last key any row of this tile may see decides where it stops
    const int last_key = min(q0 + BQ, Sq) - 1 + offset;
    n_tiles = min(n_tiles, last_key / BK + 1);
  }
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    load_tile<D, L::LDQ>(sK, kb, k0, Sk, Hkv * D);
    load_tile<D, L::LDQ>(sV, vb, k0, Sk, Hkv * D);
    __syncthreads();

    // S = Qs . K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + r0 * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          // K stored [key][d] is K^T in column-major order
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, sK + n * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(acc[n], a, bk, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(sS + r0 * L::LDS + n * 16, acc[n], L::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax in base 2 over this tile, one row at a time
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int last = q0 + r + offset;  // last key this row may see
      const int c0 = k0 + lane, c1 = k0 + lane + 32;
      float s0 = sS[r * L::LDS + lane];
      float s1 = sS[r * L::LDS + lane + 32];
      if (c0 >= Sk || (causal && c0 > last)) s0 = NEG_INF;
      if (c1 >= Sk || (causal && c1 > last)) s1 = NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = exp2f(s0 - m_new);
      const float p1 = exp2f(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      const float alpha = exp2f(m_prev - m_new);
      sP[r * L::LDP + lane] = __float2bfloat16(p0);
      sP[r * L::LDP + lane + 32] = __float2bfloat16(p1);
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], sP + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, sO + r0 * L::LDO + n * 16, L::LDO,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(bv, sV + kk * 16 * L::LDQ + n * 16, L::LDQ);
          wmma::mma_sync(acc, pa[kk], bv, acc);
        }
        wmma::store_matrix_sync(sO + r0 * L::LDO + n * 16, acc, L::LDO,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();  // K/V tiles are overwritten by the next iteration
  }

  // out = O / l, lse2 = m + log2(l)
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int qi = q0 + r;
    if (qi >= Sq) break;
    const float l = sL[r];
    const float safe_l = (l == 0.f) ? 1.f : l;
    bf16* orow = out + (((size_t)b * Sq + qi) * H + h) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(sO[r * L::LDO + c] / safe_l);
    if (lane == 0) lse[((size_t)b * H + h) * Sq + qi] = sM[r] + log2f(safe_l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Sq, int Sk, int H, int Hkv, int causal,
                   float qscale, cudaStream_t stream) {
  constexpr int bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, causal, qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ds_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Sk, int H, int Hkv,
                                      int D, int causal, float qscale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, qscale, s);
    case 128:
      return launch<128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, qscale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
