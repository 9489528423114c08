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
//   * GQA reads KV head h / (H/Hkv) directly, with no repeat_kv copy;
//   * D is 64, 80, 128 or 256; Sq and Sk are any, the ragged edges masked
//     here.
//
// Bound on an H100: 4*D operations per live (query, key) pair and head
// against reading q, k, v and writing out and lse once. At the v1 prefill
// (B=4, S=512, H=32, Hkv=8, D=128, causal) that is 8.6 GFLOP (8.7 us at
// 989 TFLOP/s bf16) against 42 MB (12.6 us at 3.35 TB/s): bytes bound it.
// At the llama-1b training call (B=4, S=2048, H=32, Hkv=4, D=64, causal) it
// is 6.9e10 operations (70 us) against 0.14 GB (41 us): operations bound it.
// The zoo's v1 prefills (B=4, S=512, causal) are bound by bytes too: phi-2
// (H = Hkv = 32, D = 80) 5.4 GFLOP (5.4 us) against 42 MB (12.6 us), and
// pythia-1b (H = Hkv = 8, D = 256) 4.3 GFLOP (4.4 us) against 34 MB
// (10.0 us).
//
// Design (`Cfg`): one block of two warpgroups per (q tile of 128 rows,
// head, batch); each warpgroup owns 64 query rows from start to end.
//   * Both products run on the tensor cores as wgmma (m64nNk16, bf16 in,
//     f32 accumulate in registers): S = qs.K^T with both operands read from
//     shared memory through descriptors (K-major), and O += P.V with P in
//     registers and V read MN-major, transposed by the descriptor. Every
//     tile is stored in wgmma's canonical 128-byte-swizzled layout (D/64
//     column blocks of [rows][128 bytes]), so one copy of a K or V tile
//     serves either major-ness.
//   * S, P and O stay in registers. A thread holds two rows of its warp's
//     16 (the accumulator layout), so the online softmax's row max comes
//     from two shuffles within the quad that shares a row; O is rescaled by
//     alpha in place; and S's f32 accumulator, rounded to bf16 and packed,
//     is P's register operand.
//   * K and V tiles (64 keys at D = 64, 128 at D = 128) arrive by cp.async
//     into a ring of three stages: the copy of tile t + 1 is issued right
//     after the barrier that opens tile t, and the wait on tile t's P.V is
//     deferred to tile t + 1, so the tensor cores run P.V(t) and S(t + 1)
//     back to back while the warps cross the barrier. Rows past Sk are
//     zero-filled by the copy and masked.
//   * The causal walk stops at the tile that holds the block's last
//     diagonal key (the TPU kernel's triangular grid), and the mask is
//     evaluated only on tiles that cross the diagonal or the sequence end.
//   * Blocks are numbered longest first: the q tiles with the most KV tiles
//     start in the first wave, so the last wave is not the longest.
//   * The shared-memory opt-in is set once per device, not on every launch.
// Other widths (`Cfg`):
//   * D = 80 does not fill whole 64-column swizzle blocks, so its tiles and
//     O are padded to 128 columns: the copies zero-fill columns 80-127 (no
//     global read), S = qs.K^T takes only its five real k-steps, P.V runs
//     at n = 128 (1.6x the products of that half) and only 80 columns are
//     stored. A 64-column block plus a 16-column 32-byte-swizzle block
//     would drop the padding.
//   * D = 256 keeps three stages by taking one warpgroup a block (Q 32 KB,
//     K and V 192 KB); O is 128 f32 registers a thread beside S's 32:
//     ptxas (-v, CUDA 12.8) gives 226 registers and no spill (208 at 80).
// What holds it: the softmax runs on the warpgroups that issue the
// products, so the tensor cores idle while it does (at the v1 shape each
// block sees only 1-4 tiles, and its prologue load counts too). TMA loads,
// warp specialisation (a producer warp; consumer warpgroups that ping-pong
// softmax and products) and persistent blocks are the next steps.

#include "flash_attention_common.cuh"

namespace {

constexpr int STAGES = 3;    // K/V ring depth
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Tiles by head width: NWG warpgroups of 64 query rows each, KV tiles of
// BK keys, MINB blocks an SM should hold (the register cap follows), and
// DP, the width of the shared tiles and of O's accumulator: D rounded up
// to whole 64-column swizzle blocks (80 -> 128, its columns 80..127 zero).
template <int D>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int NWG = 2, BK = 64, MINB = 2, DP = 64;
};
template <>
struct Cfg<80> {
  static constexpr int NWG = 2, BK = 128, MINB = 1, DP = 128;
};
template <>
struct Cfg<128> {
  static constexpr int NWG = 2, BK = 128, MINB = 1, DP = 128;
};
// one warpgroup: Q (32 KB) and three stages of K and V (192 KB) fill the
// 227 KB an SM gives a block; O is 128 f32 registers a thread
template <>
struct Cfg<256> {
  static constexpr int NWG = 1, BK = 64, MINB = 1, DP = 256;
};

// Shared memory in bytes, every tile in the swizzled layout of
// `flash_attention_common.cuh`: read K-major for Q and K, MN-major for V.
template <int D>
struct Smem {
  using C = Cfg<D>;
  static constexpr int NTHREADS = C::NWG * 128;
  static constexpr int BQ = C::NWG * 64;
  static constexpr int CB = C::DP / 64;             // column blocks
  static constexpr int QBLK = BQ * 128;             // one column block of Q
  static constexpr int KBLK = C::BK * 128;          // one column block of K or V
  static constexpr int q = 0;
  static constexpr int kv = CB * QBLK;              // stage s: K at kv + 2*s*CB*KBLK, V after it
  static constexpr int bytes = kv + STAGES * 2 * CB * KBLK + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(Smem<D>::NTHREADS, Cfg<D>::MINB)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int BH, int Sq, int Sk, int H, int Hkv,
                 int causal, float qscale) {
  using S = Smem<D>;
  constexpr int BK = Cfg<D>::BK, DP = Cfg<D>::DP, BQ = S::BQ, NT = S::NTHREADS, CB = S::CB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem + S::q;

  // longest first: the last q tile (most KV tiles when causal) comes first
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / BH)) * BQ;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int offset = Sk - Sq;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int cq = (lane % 4) * 2;
  // this thread's rows: row0 and row0 + 8
  const int row0 = q0 + wg * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;

  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * D;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    // the last key any row of this tile may see decides where it stops
    const int last_key = min(q0 + BQ, Sq) - 1 + offset;
    n_tiles = min(n_tiles, last_key / BK + 1);
  }

  auto stage = [&](int t) { return smem + S::kv + (t % STAGES) * 2 * CB * S::KBLK; };
  auto issue_kv = [&](int t) {
    cp_rows<BK, D, NT, DP>(stage(t), kb, t * BK, Sk, Hkv * D);
    cp_rows<BK, D, NT, DP>(stage(t) + CB * S::KBLK, vb, t * BK, Sk, Hkv * D);
  };
  cp_rows<BQ, D, NT, DP>(sQ, qb, q0, Sq, H * D);
  issue_kv(0);
  cp_async_commit();

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every warpgroup is done with tile t - 1, whose
    // stage takes tile t + 1: its copy runs while tile t's products do
    cp_async_wait_all();
    if (t == 0) {
      __syncthreads();
      scale_tile<CB * S::QBLK, NT>(sQ, qscale);  // qs, once, in place
    }
    fence_async_smem();
    __syncthreads();
    if (t + 1 < n_tiles) {
      issue_kv(t + 1);
      cp_async_commit();
    }
    const unsigned char* sK = stage(t);
    const unsigned char* sV = sK + CB * S::KBLK;
    const int k0 = t * BK;

    // S = qs . K^T for this warpgroup's 64 rows, on the tensor cores (D/16
    // k-steps: the padding columns are never read)
    float s[BK / 2];
    wg_fence();
    ss_product<D, BK, S::QBLK, S::KBLK>(s, sQ + wg * 64 * 128, sK);
    wg_commit();
    wg_wait_all();

    // the mask, only where the tile crosses the diagonal or the end of keys
    if ((causal && k0 + BK - 1 > q0 + offset) || k0 + BK > Sk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + cq + (e % 2);
          const int row = row0 + (e / 2) * 8;
          if (col >= Sk || (causal && col > row + offset)) s[4 * n + e] = NEG_INF;
        }
    }

    // online softmax in base 2, in registers; a row's four threads agree
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    }
    const float alpha[2] = {fast_exp2(m_run[0] - mx[0]), fast_exp2(m_run[1] - mx[1])};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * n + e] = fast_exp2(s[4 * n + e] - mx[e / 2]);
        sum[e / 2] += s[4 * n + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // this thread's columns only; the quad sums at the end
      l_run[i] = l_run[i] * alpha[i] + sum[i];
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }

    // O += P . V: S's accumulator, rounded to bf16, is P's A operand; V is
    // read MN-major (keys down, head dims across) by the descriptor
    uint32_t p[BK / 16][4];
    pack_rows<BK>(p, s);
    wg_fence();
    rs_product<DP, BK, S::KBLK>(o, p, sV);
    wg_commit();
  }
  wg_wait_all();

  // out = O / l over the D real columns, lse2 = m + log2(l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int row = row0 + i * 8;
    if (row >= Sq) continue;
    const float safe_l = (l == 0.f) ? 1.f : l;
    bf16* orow = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + cq) =
          __floats2bfloat162_rn(o[4 * n + 2 * i] / safe_l, o[4 * n + 2 * i + 1] / safe_l);
    if (lane % 4 == 0) lse[((size_t)b * H + h) * Sq + row] = m_run[i] + log2f(safe_l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                   int Sq, int Sk, int H, int Hkv, int causal, float qscale,
                   cudaStream_t stream) {
  using S = Smem<D>;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, S::bytes, done);
  if (err != cudaSuccess) return err;
  const int n_qt = (Sq + S::BQ - 1) / S::BQ;
  flash_fwd_kernel<D><<<n_qt * B * H, S::NTHREADS, S::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), B * H, Sq, Sk, H, Hkv, causal,
      qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ds_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                                      int causal, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, qscale, s);
    case 80:
      return launch<80>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, qscale, s);
    case 128:
      return launch<128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, qscale, s);
    case 256:
      return launch<256>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, qscale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
