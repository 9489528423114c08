// Single-query (decode) attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel `deepspeed_tpu/ops/pallas/decode_attention.py`
// `decode_attention` (:103) with `_decode_kernel` (:39). It computes what
// that kernel computes for a bf16 cache:
//   * q (B,1,H,D), k/v cache (B,M,Hkv,D) bf16, lengths (B,) int32 -> out
//     (B,1,H,D) bf16; row b attends cache slots [0, lengths[b]);
//   * the whole GQA group (the n_rep = H/Hkv query heads of one KV head) is
//     served by one pass over that KV head's cache;
//   * logits s = (q.k)*scale in f32, natural-exp online softmax in f32,
//     p rounded to bf16 before P.V, l == 0 guarded (an empty row gives 0).
// and, for an int8 cache (K2-int8, `_decode_kernel_quant` :97), what the TPU
// kernel's int8 path computes:
//   * k/v cache (B,M,Hkv,D) int8 with k_scales/v_scales (B,M,Hkv) f32, one
//     per (slot, KV head); int8 -> f32 is exact;
//   * the K scale multiplies the logit column, s = (q.k_q)*s_k*scale, and
//     the V scale the probability column, p*s_v, before P.V, so no
//     dequantized cache row is ever formed; l sums the unscaled p;
//   * p*s_v is rounded to bf16 as the bf16 path rounds p (the TPU's int8
//     path keeps it in f32). Multiplying by a unit scale is exact, so with
//     unit scales the int8 path equals the bf16 path on the same
//     integer-valued cache bit for bit.
//
// Bound on an H100: decode reads each valid cache row of K and V once and
// does 4*n_rep*D operations on it, far below the card's ~295 operations per
// byte, so the bytes read bound it: B*Hkv*len*D*2*2 bytes over 3.35 TB/s
// (int8: B*Hkv*len*(D+4)*2 bytes with the scales).
//
// Design: one thread block per (KV head, batch row), D threads. The block
// walks the cache in chunks of 128 slots and stops at lengths[b], so slots
// past a row's length are never read (what the TPU kernel's clamped index map
// buys). Per chunk: (A) each warp takes every NW-th slot, each lane holds
// D/32 elements of the n_rep queries and of the K row, and a warp reduction
// gives the n_rep logits; (B) one warp per query head takes the chunk's max,
// rescales the running state and writes the probabilities; (C) thread d
// accumulates column d of P.V for all n_rep heads, reading V rows with
// coalesced loads. With B*Hkv blocks (32 at B=4 on Llama-3-8B) most of the
// 132 SMs stay idle: splitting the KV axis across blocks (flash-decoding) is
// the first step of a later change that makes this kernel fast. The int8
// cache is the same code instantiated on the element type, with the two
// scale folds compiled in.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CH = 128;  // cache slots per chunk
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

// KV = bf16: ks/vs unused. KV = int8_t: ks/vs are the (B,M,Hkv) scales.
template <int D, int NREP, typename KV>
__global__ void __launch_bounds__(D)
decode_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
              const KV* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ lengths,
              bf16* __restrict__ out, int M, int H, int Hkv, float scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int NW = D / 32;   // warps
  constexpr int PER = D / 32;  // row elements per lane
  __shared__ float sP[NREP][CH];
  __shared__ float sM[NREP], sL[NREP], sAlpha[NREP];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = min(max(lengths[b], 0), M);
  const int stride = Hkv * D;

  // this lane's slice of the n_rep queries of group g
  float qr[NREP][PER];
  const bf16* qg = q + ((size_t)b * H + (size_t)g * NREP) * D;
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int e = 0; e < PER; ++e)
      qr[r][e] = __bfloat162float(qg[r * D + lane * PER + e]);

  const KV* kb = k + ((size_t)b * M * Hkv + g) * D;
  const KV* vb = v + ((size_t)b * M * Hkv + g) * D;
  const size_t srow = (size_t)b * M * Hkv + g;  // scale of slot j: srow + j*Hkv

  float acc[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) acc[r] = 0.f;
  if (tid < NREP) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < len; c0 += CH) {
    const int n = min(CH, len - c0);

    // (A) logits of the chunk
    for (int j = warp; j < n; j += NW) {
      const KV* krow = kb + (size_t)(c0 + j) * stride + lane * PER;
      float kf[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) kf[e] = to_float(krow[e]);
      const float sk = QUANT ? ks[srow + (size_t)(c0 + j) * Hkv] : 1.f;
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) dot += qr[r][e] * kf[e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
        if (lane == 0) sP[r][j] = (QUANT ? dot * sk : dot) * scale;
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
        const float pv = QUANT ? p * vs[srow + (size_t)(c0 + j) * Hkv] : p;
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
      const float vv = to_float(vb[(size_t)(c0 + j) * stride + tid]);
#pragma unroll
      for (int r = 0; r < NREP; ++r) acc[r] += sP[r][j] * vv;
    }
    __syncthreads();  // sP is overwritten by the next chunk
  }

  bf16* og = out + ((size_t)b * H + (size_t)g * NREP) * D;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const float l = sL[r];
    og[r * D + tid] = __float2bfloat16(acc[r] / (l == 0.f ? 1.f : l));
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *lengths;
  void* out;
  int B, M, H, Hkv;
  float scale;
};

template <int D, int NREP, typename KV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.Hkv, a.B);
  decode_kernel<D, NREP, KV><<<grid, D, 0, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.lengths),
      static_cast<bf16*>(a.out), a.M, a.H, a.Hkv, a.scale);
  return cudaGetLastError();
}

template <int D, typename KV>
cudaError_t launch_d(int n_rep, const Args& a, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<D, 1, KV>(a, s);
    case 2: return launch<D, 2, KV>(a, s);
    case 4: return launch<D, 4, KV>(a, s);
    case 8: return launch<D, 8, KV>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV>
cudaError_t launch_kv(int D, const Args& a, cudaStream_t s) {
  const int n_rep = a.H / a.Hkv;
  switch (D) {
    case 64: return launch_d<64, KV>(n_rep, a, s);
    case 128: return launch_d<128, KV>(n_rep, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// k_scales == v_scales == nullptr: a bf16 cache; both given: an int8 cache.
extern "C" int ds_decode_attention(const void* q, const void* k, const void* v,
                                   const void* k_scales, const void* v_scales,
                                   const void* lengths, void* out, int B, int M,
                                   int H, int Hkv, int D, float scale,
                                   void* stream) {
  if ((k_scales == nullptr) != (v_scales == nullptr) || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, k_scales, v_scales, lengths, out, B, M, H, Hkv, scale};
  return k_scales ? launch_kv<int8_t>(D, a, s) : launch_kv<bf16>(D, a, s);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
