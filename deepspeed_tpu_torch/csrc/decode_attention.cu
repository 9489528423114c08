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
//
// Bound on an H100: decode reads each valid cache row of K and V once and
// does 4*n_rep*D operations on it, far below the card's ~295 operations per
// byte, so the bytes read bound it: B*Hkv*len*D*2*2 bytes over 3.35 TB/s.
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
// the first step of a later change that makes this kernel fast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CH = 128;  // cache slots per chunk
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int D, int NREP>
__global__ void __launch_bounds__(D)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ lengths,
              bf16* __restrict__ out, int M, int H, int Hkv, float scale) {
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

  const bf16* kb = k + ((size_t)b * M * Hkv + g) * D;
  const bf16* vb = v + ((size_t)b * M * Hkv + g) * D;

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
      const bf16* krow = kb + (size_t)(c0 + j) * stride + lane * PER;
      float kf[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) kf[e] = __bfloat162float(krow[e]);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) dot += qr[r][e] * kf[e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
        if (lane == 0) sP[r][j] = dot * scale;
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
        sP[r][j] = __bfloat162float(__float2bfloat16(p));  // p in v's dtype
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
      const float vv = __bfloat162float(vb[(size_t)(c0 + j) * stride + tid]);
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

template <int D, int NREP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int M, int H, int Hkv,
                   float scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  decode_kernel<D, NREP><<<grid, D, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), M, H, Hkv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int n_rep, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, int B, int M, int H,
                     int Hkv, float scale, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<D, 1>(q, k, v, lengths, out, B, M, H, Hkv, scale, s);
    case 2: return launch<D, 2>(q, k, v, lengths, out, B, M, H, Hkv, scale, s);
    case 4: return launch<D, 4>(q, k, v, lengths, out, B, M, H, Hkv, scale, s);
    case 8: return launch<D, 8>(q, k, v, lengths, out, B, M, H, Hkv, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ds_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, int B, int M,
                                   int H, int Hkv, int D, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rep = H / Hkv;
  switch (D) {
    case 64:
      return launch_d<64>(n_rep, q, k, v, lengths, out, B, M, H, Hkv, scale, s);
    case 128:
      return launch_d<128>(n_rep, q, k, v, lengths, out, B, M, H, Hkv, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
