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
//   * head dims 64 and 128 at GQA groups of 1, 2, 4 and 8; 80 and 256 at a
//     group of one (phi-2, pythia-1b), the widths `decode_split.cuh` takes.
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
// Design: the split-KV core of `decode_split.cuh`. The grid is (chunk, KV
// head, row) over the cache capacity M in chunks of 128 positions, so the
// split is a function of M alone; each warp copies its 32 slots' rows,
// strided by Hkv*D in (B, M, Hkv, D), with 16-byte cp.async ahead of use,
// and runs both products on mma.sync with the GQA group as the rows; slots
// past a row's length are never read and chunks past it exit at once (what
// the TPU kernel's clamped index map buys). At Llama-3-8B's v1 shape (B = 4,
// Hkv = 8, M = 640) that is 32 (row, head) pairs times five chunks of 128,
// 160 blocks, where the first-slice kernel ran one block per pair on the 132
// SMs. The int8 cache is the same code instantiated on the element type,
// scale folds compiled in.

#include "decode_split.cuh"

namespace {

template <int D, int NREP, typename KV>
__global__ void __launch_bounds__(dsplit::THREADS)
decode_kernel(const dsplit::Params p) {
  dsplit::split_decode<D, NREP, KV, false, false>(p);
}

template <int D, int NREP, typename KV>
cudaError_t launch(const dsplit::Params& p, int B, cudaStream_t s) {
  static bool done[MAX_DEVICES] = {};
  return dsplit::launch_split<D, NREP, KV>(decode_kernel<D, NREP, KV>, p, B, done, s);
}

template <int D, typename KV>
cudaError_t launch_d(int n_rep, const dsplit::Params& p, int B, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<D, 1, KV>(p, B, s);
    case 2: return launch<D, 2, KV>(p, B, s);
    case 4: return launch<D, 4, KV>(p, B, s);
    case 8: return launch<D, 8, KV>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// 80 and 256 (the zoo's phi-2 and pythia-1b) at a group of one only
template <typename KV>
cudaError_t launch_kv(int D, const dsplit::Params& p, int B, cudaStream_t s) {
  const int n_rep = p.H / p.Hkv;
  switch (D) {
    case 64: return launch_d<64, KV>(n_rep, p, B, s);
    case 80: return n_rep == 1 ? launch<80, 1, KV>(p, B, s) : cudaErrorInvalidValue;
    case 128: return launch_d<128, KV>(n_rep, p, B, s);
    case 256: return n_rep == 1 ? launch<256, 1, KV>(p, B, s) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The split of a call over a cache of M slots (`dsplit::plan`): the
// positions a chunk takes, the chunk count, and the workspace it takes,
// f32 floats of partials and zeroed arrival counts (0 and 0 at one chunk).
extern "C" int ds_decode_attention_workspace(int B, int M, int H, int Hkv, int D, int* chunk,
                                             int* chunks, long long* floats, int* counts) {
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  return dsplit::plan(M, B, Hkv, H / Hkv, D, chunk, chunks, floats, counts);
}

// k_scales == v_scales == nullptr: a bf16 cache; both given: an int8 cache.
// part, counts: ds_decode_attention_workspace's (null when it gives 0).
extern "C" int ds_decode_attention(const void* q, const void* k, const void* v,
                                   const void* k_scales, const void* v_scales,
                                   const void* lengths, void* out, void* part, void* counts,
                                   int B, int M, int H, int Hkv, int D, float scale,
                                   void* stream) {
  if (B == 0) return cudaSuccess;
  if ((k_scales == nullptr) != (v_scales == nullptr) || B < 0 || Hkv <= 0 || H % Hkv)
    return cudaErrorInvalidValue;
  const int chunks = dsplit::plan_chunks(M);
  if (chunks == 0 || !dsplit::has_workspace(chunks, part, counts)) return cudaErrorInvalidValue;
  dsplit::Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(part);
  p.counts = static_cast<int*>(counts);
  p.H = H;
  p.Hkv = Hkv;
  p.M = M;
  p.chunks = chunks;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k_scales ? launch_kv<int8_t>(D, p, B, s) : launch_kv<bf16>(D, p, B, s);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
