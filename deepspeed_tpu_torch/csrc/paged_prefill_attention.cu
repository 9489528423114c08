// Chunked-prefill flash attention through block tables, for Hopper (sm_90a),
// bf16 in, f32 accumulation.
//
// Replaces the TPU kernel `deepspeed_tpu/ops/pallas/paged_attention.py`
// `paged_prefill_attention` (:366) with `_paged_prefill_kernel` (:267), for
// bf16 and int8 pools, with and without alibi (`_mk_paged_prefill_kernel`
// :348 builds one kernel per (quantized, has_alibi)). It computes what that
// kernel computes:
//   * q (B,S,H,D) bf16, the S new tokens of each row, already written to the
//     pool at positions starts[b]..starts[b]+S-1; pools (Hkv,NB,BS,D) bf16;
//     tables (B,T) int32; starts (B,) int32 -> out (B,S,H,D) bf16;
//   * query i of row b sits at absolute position qpos = starts[b] + i and
//     attends every pool key at a position <= qpos (and > qpos - window when
//     there is a window), position p living in block tables[b, p / BS];
//   * logits (q.k)*scale in f32 (q is not pre-scaled), natural-exp online
//     softmax in f32, p rounded to bf16 before P.V, l == 0 guarded;
//   * every table entry is clamped to [0, NB-1] and keys stop at T*BS, so a
//     parked row (start at the capacity) or a -1 entry reads inside the pool;
//   * int8 pools (K4-int8, :299-312) come with k_scales/v_scales (Hkv,NB,BS)
//     f32, read through the same clamped rows as the values. int8 -> bf16
//     is exact in the K/V tiles; the K scale multiplies the logit columns,
//     (q.k_q)*s_k*scale, and the V scale the probability columns, p*s_v,
//     before they round to bf16 for P.V; l sums the unscaled p. With unit
//     scales the int8 path equals the bf16 path bit for bit.
//   * alibi (K4-alibi, :316-317) comes as slopes (H,) f32: each (query,
//     key) logit gets + slopes[h] * key_pos in f32 after the scale (and the
//     int8 K scale), before the causal and window mask. `has_alibi` is a
//     template flag: the instantiation without it compiles to the kernel
//     without alibi.
//
// Bound on an H100: 4*D operations per (query head, visible key) pair
// against reading q, the visible K/V once and writing out once. At S = 256,
// H = 32, Hkv = 8, D = 128 a fresh prompt (start 0) does ~110 operations per
// byte, under the card's ~295, so bytes bound it; behind a cached prefix of
// 768 keys it does ~470 and the tensor cores bound it.
//
// Design: K1's (`flash_attention_fwd.cu`) WMMA tile scheme with the rows of
// a tile taken over the GQA group: one thread block per (64-row tile, KV
// head g, row b), where tile row r is query position (row0 + r) / n_rep of
// head g*n_rep + (row0 + r) % n_rep, as the TPU kernel's (cq*n_rep) rows
// are. The group's n_rep heads share every K/V tile the block loads. Four
// warps own 16 rows each; K and V tiles of 64 keys are staged in shared
// memory, each key row addressed through the clamped table (a 256-token
// block is four tiles), and both products run on the tensor cores through
// bf16 16x16x16 fragments. The running max, sum and f32 output accumulator
// live in shared memory. The block stops at the tile holding its last
// query's position (the causal frontier) and, with a window, starts at the
// tile holding its first query's lowest visible key. mma.sync/wgmma with
// the accumulator in registers and TMA loads are left for a later change.
// An int8 pool is the same code instantiated on the element type: its tiles
// are converted to bf16 on the way into shared memory, beside the tile's
// key scales.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;       // tile rows (query position x group member)
constexpr int BK = 64;       // keys per KV tile
constexpr int NWARPS = 4;    // each warp owns BQ / NWARPS = 16 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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
  static constexpr int ks = l + BQ * 4;     // f32 key scales of the tile
  static constexpr int vs = ks + BK * 4;    // f32 value scales of the tile
  static constexpr int bytes = vs + BK * 4;
};

// 8 consecutive pool elements as 8 bf16 (int8 -> bf16 is exact).
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const int8_t* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) bf16 w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e] = __float2bfloat16((float)b[e]);
  return *reinterpret_cast<const uint4*>(w);
}

// Keys [k0, k0+BK) of one KV head through the row's table; keys at or past
// `cap` are zero. With scales (int8 pools), each key's scale goes to
// dst_scales (0 past `cap`).
template <int D, int LD, typename KV>
__device__ __forceinline__ void load_tile(bf16* dst, const KV* head_pool,
                                          float* dst_scales, const float* head_scales,
                                          const int* trow, int k0, int cap,
                                          int NB, int BS) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const int p = k0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p < cap) {
      const int phys = min(max(trow[p / BS], 0), NB - 1);
      val = load8(head_pool + ((size_t)phys * BS + p % BS) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
  if (sizeof(KV) == 1) {
    for (int r = threadIdx.x; r < BK; r += NTHREADS) {
      const int p = k0 + r;
      float sc = 0.f;
      if (p < cap) {
        const int phys = min(max(trow[p / BS], 0), NB - 1);
        sc = head_scales[(size_t)phys * BS + p % BS];
      }
      dst_scales[r] = sc;
    }
  }
}

// KV = bf16: ks/vs unused. KV = int8_t: ks/vs are the (Hkv,NB,BS) scales.
// ALIBI: `alibi` holds the (H,) slopes; without it, it is unused.
template <int D, int NREP, typename KV, bool ALIBI>
__global__ void __launch_bounds__(NTHREADS)
paged_prefill_kernel(const bf16* __restrict__ q, const KV* __restrict__ kp,
                     const KV* __restrict__ vp, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ tables,
                     const int* __restrict__ starts, const float* __restrict__ alibi,
                     bf16* __restrict__ out,
                     int S, int H, int NB, int BS, int T, int window,
                     float scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
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
  float* sKs = reinterpret_cast<float*>(smem + L::ks);
  float* sVs = reinterpret_cast<float*>(smem + L::vs);

  const int row0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = S * NREP;
  const int start = starts[b];
  const int cap = T * BS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int* trow = tables + (size_t)b * T;
  const KV* kh = kp + (size_t)g * NB * BS * D;
  const KV* vh = vp + (size_t)g * NB * BS * D;
  const float* ksh = QUANT ? ks + (size_t)g * NB * BS : nullptr;
  const float* vsh = QUANT ? vs + (size_t)g * NB * BS : nullptr;

  // Q tile: row r is position (row0 + r) / NREP of head g*NREP + member
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BQ * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const int fr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (fr < nrows) {
      const int pos = fr / NREP, h = g * NREP + fr % NREP;
      val = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * S + pos) * H + h) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(sQ + r * L::LDQ + c * 8) = val;
  }
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }

  // keys this tile can see: from the first query's window floor up to the
  // last query's position (the causal frontier), inside the capacity
  const int qpos_first = start + row0 / NREP;
  const int qpos_last = start + (min(row0 + BQ, nrows) - 1) / NREP;
  const int k_begin = window > 0 ? max(qpos_first - window + 1, 0) : 0;
  const int k_end = min(qpos_last + 1, cap);
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    load_tile<D, L::LDQ, KV>(sK, kh, sKs, ksh, trow, k0, cap, NB, BS);
    load_tile<D, L::LDQ, KV>(sV, vh, sVs, vsh, trow, k0, cap, NB, BS);
    __syncthreads();

    // S = Q . K^T for this warp's 16 rows
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

    // online softmax (natural exp) over this tile, one row at a time;
    // masked columns get p = 0 exactly
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int fr = row0 + r;
      const int qpos = start + fr / NREP;
      const int c0 = k0 + lane, c1 = k0 + lane + 32;
      const bool live = fr < nrows;
      const bool v0 = live && c0 < cap && c0 <= qpos && (window <= 0 || c0 > qpos - window);
      const bool v1 = live && c1 < cap && c1 <= qpos && (window <= 0 || c1 > qpos - window);
      // the K scale folds into the logit columns, then the alibi bias
      const float d0 = sS[r * L::LDS + lane], d1 = sS[r * L::LDS + lane + 32];
      float s0 = v0 ? (QUANT ? d0 * sKs[lane] : d0) * scale : NEG_INF;
      float s1 = v1 ? (QUANT ? d1 * sKs[lane + 32] : d1) * scale : NEG_INF;
      if (ALIBI) {
        const float slope = alibi[g * NREP + fr % NREP];
        s0 = v0 ? s0 + slope * (float)c0 : NEG_INF;
        s1 = v1 ? s1 + slope * (float)c1 : NEG_INF;
      }
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      const float alpha = expf(m_prev - m_new);
      // the V scale folds into the probability columns
      sP[r * L::LDP + lane] = __float2bfloat16(QUANT ? p0 * sVs[lane] : p0);
      sP[r * L::LDP + lane + 32] = __float2bfloat16(QUANT ? p1 * sVs[lane + 32] : p1);
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

  // out = O / l
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int fr = row0 + r;
    if (fr >= nrows) break;
    const int pos = fr / NREP, h = g * NREP + fr % NREP;
    const float l = sL[r];
    const float safe_l = (l == 0.f) ? 1.f : l;
    bf16* orow = out + (((size_t)b * S + pos) * H + h) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(sO[r * L::LDO + c] / safe_l);
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *starts, *alibi;
  void* out;
  int B, S, H, Hkv, NB, BS, T, window;
  float scale;
};

template <int D, int NREP, typename KV, bool ALIBI>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<D, NREP, KV, ALIBI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S * NREP + BQ - 1) / BQ, a.Hkv, a.B);
  paged_prefill_kernel<D, NREP, KV, ALIBI><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.starts), static_cast<const float*>(a.alibi),
      static_cast<bf16*>(a.out), a.S, a.H,
      a.NB, a.BS, a.T, a.window, a.scale);
  return cudaGetLastError();
}

template <int D, typename KV, bool ALIBI>
cudaError_t launch_d(int n_rep, const Args& a, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<D, 1, KV, ALIBI>(a, s);
    case 2: return launch<D, 2, KV, ALIBI>(a, s);
    case 4: return launch<D, 4, KV, ALIBI>(a, s);
    case 8: return launch<D, 8, KV, ALIBI>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV, bool ALIBI>
cudaError_t launch_kv(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 64: return launch_d<64, KV, ALIBI>(a.H / a.Hkv, a, s);
    case 128: return launch_d<128, KV, ALIBI>(a.H / a.Hkv, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// k_scales == v_scales == nullptr: bf16 pools; both given: int8 pools.
// alibi == nullptr: no bias; else the (H,) f32 slopes.
extern "C" int ds_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
    const void* v_scales, const void* tables, const void* starts,
    const void* alibi, void* out, int B, int S, int H, int Hkv, int D, int NB,
    int BS, int T, int window,
    float scale, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv || NB <= 0 || BS <= 0 || T <= 0 ||
      (k_scales == nullptr) != (v_scales == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scales, v_scales, tables, starts, alibi,
               out, B, S, H, Hkv, NB, BS, T, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alibi)
    return k_scales ? launch_kv<int8_t, true>(D, a, s) : launch_kv<bf16, true>(D, a, s);
  return k_scales ? launch_kv<int8_t, false>(D, a, s) : launch_kv<bf16, false>(D, a, s);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
