// Single-query (decode) attention through block tables, for Hopper (sm_90a).
//
// Replaces the TPU kernel `deepspeed_tpu/ops/pallas/paged_attention.py`
// `paged_decode_attention` (:159) with `_paged_kernel` (:41), for bf16 and
// int8 pools, with and without alibi (`_mk_paged_kernel` :141 builds one
// kernel per (quantized, staged, has_alibi)). It computes what that kernel
// computes:
//   * q (B,1,H,D) bf16, pools (Hkv,NB,BS,D) bf16, tables (B,T) int32,
//     lengths (B,) int32 -> out (B,1,H,D) bf16;
//   * row b attends its first pool_len keys, logical position p living in
//     pool block tables[b, p / BS] at slot p % BS. pool_len = lengths[b] - 1
//     when the new token is staged (k_new/v_new (B,Hkv,D), not in the pool
//     yet), else lengths[b];
//   * with a window, only keys in (qpos - window, qpos] attend, where
//     qpos = lengths[b] - 1 is the query's position;
//   * logits (q.k)*scale in f32, natural-exp online softmax in f32, p rounded
//     to bf16 before P.V; the staged column is folded in last as f32 p*v;
//     l == 0 is guarded (an empty row gives 0).
//   * Memory safety as on the TPU: pool_len is clamped to T*BS (a parked row
//     carries a cursor at the capacity) and every table entry to [0, NB-1]
//     (-1 marks an unowned entry), so a parked row reads block 0 and its
//     output is ignored by the caller.
//   * int8 pools (K3-int8, :73-88) come with k_scales/v_scales (Hkv,NB,BS)
//     f32, one per (KV head, block, slot), read through the same clamped
//     pool row as the values. The K scale multiplies the logit column,
//     (q.k_q)*s_k*scale, the V scale the probability column, p*s_v, before
//     P.V; l sums the unscaled p; p*s_v rounds to bf16 as the bf16 path
//     rounds p, so with unit scales the int8 path equals the bf16 path bit
//     for bit. The staged token is bf16 and folds in without a scale.
//   * alibi (K3-alibi, :89-90, :126-127) comes as slopes (H,) f32: every
//     logit gets + slopes[h] * col in f32 after the scale (and the int8 K
//     scale), before the mask; the staged column gets + slopes[h] * qpos.
//     The bias reaches ~860 at v2's positions, where a bf16 ulp is 4, so it
//     never leaves f32. `has_alibi` is a template flag: the instantiation
//     without it compiles to the kernel without alibi.
//
// Bound on an H100: each valid key and value row is read once and takes
// 4*n_rep*D operations, far below the card's ~295 operations per byte, so
// the bytes read bound it: valid keys * Hkv * D * 2 (K and V) * 2 bytes over
// 3.35 TB/s (int8: valid keys * Hkv * (D + 4) * 2 bytes with the scales).
//
// Alibi adds one multiply-add per logit and reads H floats: the bound is
// unchanged.
//
// Design: one thread block per (KV head g, row b), D threads, holding the
// group's n_rep query heads as the TPU's whole-group tile does. The block
// walks the row's live positions in chunks of 128 (from the window's first
// key when there is a window) and stops at pool_len, so dead blocks are
// never read. Per chunk it first resolves each slot's pool row through the
// clamped table into shared memory; then (A) each warp takes every NW-th
// slot and reduces the n_rep logits across its lanes, (B) one warp per
// query head rescales the running state and writes bf16 probabilities, and
// (C) thread d accumulates column d of P.V with coalesced V loads. At
// B = 64, Hkv = 8 that is 512 blocks on 132 SMs; splitting the KV axis
// across blocks (flash-decoding) is left for a later change. The int8 pool
// is the same code instantiated on the element type, scale folds compiled in.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CH = 128;  // positions per chunk
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

// KV = bf16: ks/vs unused. KV = int8_t: ks/vs are the (Hkv,NB,BS) scales.
// ALIBI: `alibi` holds the (H,) slopes; without it, it is unused.
template <int D, int NREP, typename KV, bool ALIBI>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const bf16* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ tables,
                    const int* __restrict__ lengths, const bf16* __restrict__ kn,
                    const bf16* __restrict__ vn, const float* __restrict__ alibi,
                    bf16* __restrict__ out, int H,
                    int Hkv, int NB, int BS, int T, int staged, int window,
                    float scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int NW = D / 32;   // warps
  constexpr int PER = D / 32;  // row elements per lane
  __shared__ float sP[NREP][CH];
  __shared__ size_t sRow[CH];  // pool row (in units of D) of each chunk slot,
                               // also the index of its scale
  __shared__ float sM[NREP], sL[NREP], sAlpha[NREP], sPn[NREP];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int length = lengths[b];
  const int qpos = length - 1;
  const int pool_len = min(max(staged ? length - 1 : length, 0), T * BS);
  const int lo = window > 0 ? max(qpos - window + 1, 0) : 0;
  const int* trow = tables + (size_t)b * T;
  const size_t head_rows = (size_t)g * NB * BS;

  float qr[NREP][PER];
  const bf16* qg = q + ((size_t)b * H + (size_t)g * NREP) * D;
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int e = 0; e < PER; ++e)
      qr[r][e] = __bfloat162float(qg[r * D + lane * PER + e]);

  float slope[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) slope[r] = ALIBI ? alibi[g * NREP + r] : 0.f;

  float acc[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) acc[r] = 0.f;
  if (tid < NREP) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  __syncthreads();

  for (int c0 = lo; c0 < pool_len; c0 += CH) {
    const int n = min(CH, pool_len - c0);

    // resolve each slot of the chunk through the clamped table
    for (int j = tid; j < n; j += D) {
      const int p = c0 + j;
      const int phys = min(max(trow[p / BS], 0), NB - 1);
      sRow[j] = head_rows + (size_t)phys * BS + p % BS;
    }
    __syncthreads();

    // (A) logits of the chunk
    for (int j = warp; j < n; j += NW) {
      const KV* krow = kp + sRow[j] * D + lane * PER;
      float kf[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) kf[e] = to_float(krow[e]);
      const float sk = QUANT ? ks[sRow[j]] : 1.f;
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) dot += qr[r][e] * kf[e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
        if (lane == 0) {
          const float s = (QUANT ? dot * sk : dot) * scale;
          sP[r][j] = ALIBI ? s + slope[r] * (float)(c0 + j) : s;
        }
      }
    }
    __syncthreads();

    // (B) online-softmax update, one warp per query head
    for (int r = warp; r < NREP; r += NW) {
      float mx = NEG_INF;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sP[r][j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sP[r][j] - m_new);
        sum += p;
        // p (times the V scale) in bf16, as the bf16 path rounds it
        const float pv = QUANT ? p * vs[sRow[j]] : p;
        sP[r][j] = __bfloat162float(__float2bfloat16(pv));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // (C) column tid of P.V for every head of the group
#pragma unroll
    for (int r = 0; r < NREP; ++r) acc[r] *= sAlpha[r];
    for (int j = 0; j < n; ++j) {
      const float vv = to_float(vp[sRow[j] * D + tid]);
#pragma unroll
      for (int r = 0; r < NREP; ++r) acc[r] += sP[r][j] * vv;
    }
    __syncthreads();  // sP and sRow are overwritten by the next chunk
  }

  if (staged) {
    // the row's new token, not in the pool yet: one more column, in f32
    const size_t off = ((size_t)b * Hkv + g) * D;
    if (warp == 0) {
      float kf[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) kf[e] = __bfloat162float(kn[off + lane * PER + e]);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) dot += qr[r][e] * kf[e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
        if (lane == 0) {
          const float sn = ALIBI ? dot * scale + slope[r] * (float)qpos : dot * scale;
          const float m_prev = sM[r];
          const float m_new = fmaxf(m_prev, sn);
          const float alpha = expf(m_prev - m_new);
          const float pn = expf(sn - m_new);
          sL[r] = sL[r] * alpha + pn;
          sM[r] = m_new;
          sAlpha[r] = alpha;
          sPn[r] = pn;
        }
      }
    }
    __syncthreads();
    const float vv = __bfloat162float(vn[off + tid]);
#pragma unroll
    for (int r = 0; r < NREP; ++r) acc[r] = acc[r] * sAlpha[r] + sPn[r] * vv;
  }

  bf16* og = out + ((size_t)b * H + (size_t)g * NREP) * D;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const float l = sL[r];
    og[r * D + tid] = __float2bfloat16(acc[r] / (l == 0.f ? 1.f : l));
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *lengths, *kn, *vn, *alibi;
  void* out;
  int B, H, Hkv, NB, BS, T, staged, window;
  float scale;
};

template <int D, int NREP, typename KV, bool ALIBI>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.Hkv, a.B);
  paged_decode_kernel<D, NREP, KV, ALIBI><<<grid, D, 0, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lengths), static_cast<const bf16*>(a.kn),
      static_cast<const bf16*>(a.vn), static_cast<const float*>(a.alibi),
      static_cast<bf16*>(a.out), a.H, a.Hkv,
      a.NB, a.BS, a.T, a.staged, a.window, a.scale);
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
extern "C" int ds_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
    const void* v_scales, const void* tables, const void* lengths,
    const void* k_new, const void* v_new, const void* alibi, void* out, int B,
    int H, int Hkv,
    int D, int NB, int BS, int T, int staged, int window, float scale,
    void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv || NB <= 0 || BS <= 0 || T <= 0 ||
      (staged && (k_new == nullptr || v_new == nullptr)) ||
      (k_scales == nullptr) != (v_scales == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scales, v_scales, tables, lengths, k_new,
               v_new, alibi, out, B, H, Hkv, NB, BS, T, staged, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alibi)
    return k_scales ? launch_kv<int8_t, true>(D, a, s) : launch_kv<bf16, true>(D, a, s);
  return k_scales ? launch_kv<int8_t, false>(D, a, s) : launch_kv<bf16, false>(D, a, s);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
