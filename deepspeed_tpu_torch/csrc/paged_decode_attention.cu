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
//   * head dims 64 and 128 at GQA groups of 1, 2, 4 and 8; 80 and 256 at a
//     group of one (phi-2, pythia-1b), the widths `decode_split.cuh` takes.
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
// Design: the split-KV core of `decode_split.cuh`. The grid is (chunk, KV
// head, row) over the capacity T*BS in chunks of 128 positions, so the
// split is a function of T*BS alone, chunks aligned to absolute positions;
// a chunk wholly outside the row's live keys (below the window's first key,
// or at or past pool_len) exits at once. Each warp resolves its 32
// positions through the clamped table (a pool block's rows for one KV head
// are contiguous, so a slice within one block is one contiguous run) and
// copies them with 16-byte cp.async ahead of use; both products run on
// mma.sync with the GQA group as the rows. The first-slice kernel walked
// each (row, head) serially in one block, so the longest row, the parked
// one at T*BS keys, set the time; now it is T*BS / chunk blocks like any
// full row. The staged column folds in at the merge, last. The int8 pool and
// alibi are the same code instantiated on the element type and the flag.

#include "decode_split.cuh"

// This source builds the kernels without alibi. `paged_decode_attention_alibi.cu`
// includes it with DS_PAGED_ALIBI set to 1 and builds the alibi forms as a
// library of its own, so the two compile in parallel; each library's entry
// point takes the calls of its own form.
#ifndef DS_PAGED_ALIBI
#define DS_PAGED_ALIBI 0
#endif

namespace {

template <int D, int NREP, typename KV, bool ALIBI>
__global__ void __launch_bounds__(dsplit::THREADS)
paged_decode_kernel(const dsplit::Params p) {
  dsplit::split_decode<D, NREP, KV, ALIBI, true>(p);
}

template <int D, int NREP, typename KV, bool ALIBI>
cudaError_t launch(const dsplit::Params& p, int B, cudaStream_t s) {
  static bool done[MAX_DEVICES] = {};
  return dsplit::launch_split<D, NREP, KV>(paged_decode_kernel<D, NREP, KV, ALIBI>, p, B, done,
                                           s);
}

template <int D, typename KV, bool ALIBI>
cudaError_t launch_d(int n_rep, const dsplit::Params& p, int B, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<D, 1, KV, ALIBI>(p, B, s);
    case 2: return launch<D, 2, KV, ALIBI>(p, B, s);
    case 4: return launch<D, 4, KV, ALIBI>(p, B, s);
    case 8: return launch<D, 8, KV, ALIBI>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// 80 and 256 (the zoo's phi-2 and pythia-1b) at a group of one and without
// alibi only
template <typename KV, bool ALIBI>
cudaError_t launch_kv(int D, const dsplit::Params& p, int B, cudaStream_t s) {
  const int n_rep = p.H / p.Hkv;
  switch (D) {
    case 64: return launch_d<64, KV, ALIBI>(n_rep, p, B, s);
    case 128: return launch_d<128, KV, ALIBI>(n_rep, p, B, s);
    default: break;
  }
  if constexpr (!ALIBI) {
    if (n_rep == 1 && D == 80) return launch<80, 1, KV, false>(p, B, s);
    if (n_rep == 1 && D == 256) return launch<256, 1, KV, false>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The split of a call over block tables of T blocks of BS (`dsplit::plan`
// over T*BS positions): the positions a chunk takes, the chunk count, and
// the workspace it takes, f32 floats of partials and zeroed arrival counts
// (0 and 0 at one chunk).
extern "C" int ds_paged_decode_attention_workspace(int B, int H, int Hkv, int D, int BS, int T,
                                                   int* chunk, int* chunks, long long* floats,
                                                   int* counts) {
  if (Hkv <= 0 || H % Hkv || BS <= 0 || T <= 0 || (long long)T * BS > 0x7fffffff)
    return cudaErrorInvalidValue;
  return dsplit::plan(T * BS, B, Hkv, H / Hkv, D, chunk, chunks, floats, counts);
}

// k_scales == v_scales == nullptr: bf16 pools; both given: int8 pools.
// alibi: nullptr in this library, the (H,) f32 slopes in the alibi one
// (DS_PAGED_ALIBI). part, counts:
// ds_paged_decode_attention_workspace's (null when it gives 0).
extern "C" int ds_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
    const void* v_scales, const void* tables, const void* lengths, const void* k_new,
    const void* v_new, const void* alibi, void* out, void* part, void* counts, int B, int H,
    int Hkv, int D, int NB, int BS, int T, int staged, int window, float scale, void* stream) {
  constexpr bool ALIBI = DS_PAGED_ALIBI != 0;
  if (B == 0) return cudaSuccess;
  if (B < 0 || Hkv <= 0 || H % Hkv || NB <= 0 || BS <= 0 || T <= 0 ||
      (long long)T * BS > 0x7fffffff || (staged && (k_new == nullptr || v_new == nullptr)) ||
      (k_scales == nullptr) != (v_scales == nullptr) || (alibi != nullptr) != ALIBI)
    return cudaErrorInvalidValue;
  const int chunks = dsplit::plan_chunks(T * BS);
  if (chunks == 0 || !dsplit::has_workspace(chunks, part, counts)) return cudaErrorInvalidValue;
  dsplit::Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = k_pool;
  p.v = v_pool;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.kn = static_cast<const bf16*>(k_new);
  p.vn = static_cast<const bf16*>(v_new);
  p.alibi = static_cast<const float*>(alibi);
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(part);
  p.counts = static_cast<int*>(counts);
  p.H = H;
  p.Hkv = Hkv;
  p.NB = NB;
  p.BS = BS;
  p.T = T;
  p.staged = staged;
  p.window = window;
  p.chunks = chunks;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k_scales ? launch_kv<int8_t, ALIBI>(D, p, B, s) : launch_kv<bf16, ALIBI>(D, p, B, s);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
