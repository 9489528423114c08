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
//   * logits (q.k)*scale in f32 (q is neither pre-scaled nor pre-rounded:
//     the scale multiplies the f32 logit), online softmax in f32, p rounded
//     to bf16 before P.V, l == 0 guarded;
//   * every table entry is clamped to [0, NB-1] and keys stop at T*BS, so a
//     parked row (start at the capacity) or a -1 entry reads inside the pool;
//   * int8 pools (K4-int8, :299-312) come with k_scales/v_scales (Hkv,NB,BS)
//     f32, read through the same clamped rows as the values. int8 -> bf16
//     is exact in the K/V tiles; the K scale multiplies the logit columns,
//     (q.k_q)*s_k*scale, and the V scale the probability columns, p*s_v,
//     before they round to bf16 for P.V; l sums the unscaled p. The int8
//     kernel uses the bf16 kernel's tiles and products, so with unit scales
//     it equals the bf16 path bit for bit.
//   * alibi (K4-alibi, :316-317) comes as slopes (H,) f32: each (query,
//     key) logit gets + slopes[h] * key_pos in f32 after the scale (and the
//     int8 K scale), before the causal and window mask. `ALIBI` is a
//     template flag: the instantiation without it has no alibi code.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): 4*D operations per
// (query head, visible key) pair against reading q, the visible K/V once
// and writing out once. At the v2 prefill shape (B = 16 rows of S = 256 new
// tokens at starts 0-768 and a parked row, H = 32, Hkv = 8, D = 128) that
// is 35.5 GFLOP (0.036 ms) against ~110 MB (0.033 ms): the tensor cores
// bound it, narrowly; the int8 pools halve the K/V bytes and leave the
// operations. On the same rows at the zoo's widths the bytes bound it:
// phi-2 (H = Hkv = 32, D = 80) 22 GFLOP (22 us) against ~150 MB (~45 us),
// pythia-1b (H = Hkv = 8, D = 256) 18 GFLOP (18 us) against ~120 MB
// (~36 us).
//
// Design: the K1 forward's machinery (`flash_attention_fwd.cu`) behind the
// block table, with the rows of a tile taken over the GQA group.
//   * One block of two warpgroups per (128-row tile, KV head g, row b),
//     tile row r being query position (row0 + r) / NREP of head
//     g*NREP + (row0 + r) % NREP, as the TPU kernel's (cq*n_rep) rows are,
//     so one K/V tile feeds all NREP heads. Each warpgroup owns 64 rows.
//   * Both products run on wgmma with f32 accumulators in registers: S =
//     Q.K^T with both operands K-major in shared memory, O += P.V with P
//     (S's accumulator, rounded to bf16) as the register A operand and V
//     read MN-major. Every tile is in wgmma's 128-byte-swizzled layout. The
//     row max and sum come from the quad that shares a row; O is rescaled
//     in place.
//   * K/V tiles (64 keys at D = 64, 128 at D = 128) arrive by cp.async, each
//     16-byte chunk addressed through the clamped table entry of its key, so
//     a tile may span any number of pool blocks (that per-key gather is why
//     the copies are not TMA's). bf16 pools fill a ring of three tiles: the
//     copy of tile t + 1 is issued right after the barrier that opens tile
//     t and runs under its products; the wait on tile t's P.V is deferred
//     to tile t + 1. int8 pools land in one staging tile (rows and their
//     scales), which the threads convert exactly into one of two bf16
//     tiles at the top of the tile, beside the tile's scales; the staging
//     tile then takes tile t + 1's copy. Keys past the capacity are
//     zero-filled and masked.
//   * A block walks only the tiles from its first query's window floor to
//     its last query's position, and evaluates the mask only on tiles that
//     cross the diagonal, the window edge or the capacity. A row with no
//     visible key so far takes 0 as its reference max, so its masked
//     columns give p = 0.
//   * Other widths (`Cfg`): D = 80 pads its tiles and O to 128 columns
//     (the copies and the int8 conversion write zeros there; S takes its
//     five real k-steps, P.V runs at n = 128, 80 columns are stored), as
//     K1-fwd does; D = 256 takes 32-key tiles to keep three bf16 slots
//     beside its 64 KB Q tile, and O is 128 f32 registers a thread (ptxas,
//     CUDA 12.8: 202 registers bf16, 208 int8, no spill; 198-208 at 80,
//     where the int8 form's products are serialised, C7515). alibi is
//     built at 64 and 128 only.
//   * Blocks are numbered longest first (the last query tile of every
//     (row, KV head) in the first wave). The shared-memory opt-in is set
//     once per device.
// What holds it (PERF.md, H100 80GB HBM3 at 700 W): ~17% of the bf16 peak.
// The two warpgroups meet at a barrier every tile, so their softmax
// (instruction-bound, a large share of a block's time) runs while the
// tensor cores idle, and one block fits an SM at D = 128. What is left: warp specialisation
// (a producer warp for the gather, consumer warpgroups that ping-pong the
// softmax and the products on mbarriers instead of the tile barrier), TMA
// where BS allows whole tiles of a block, and fp8 pools.

#include <limits.h>

#include "flash_attention_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Keys a K/V tile, blocks an SM and the padded tile width DP by head width
// (K1's `Cfg`): D = 80 pads its tiles and O to 128 columns, zero-filled;
// D = 256 takes 32-key tiles, so Q (64 KB) and three bf16 slots (96 KB)
// fit.
template <int D>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int BK = 64, MINB = 2, DP = 64;
};
template <>
struct Cfg<80> {
  static constexpr int BK = 128, MINB = 1, DP = 128;
};
template <>
struct Cfg<128> {
  static constexpr int BK = 128, MINB = 1, DP = 128;
};
template <>
struct Cfg<256> {
  static constexpr int BK = 32, MINB = 1, DP = 256;
};

// Shared memory in bytes. bf16 pools: Q, then a ring of three (K, V) slots
// that cp.async fills. int8 pools: Q, two (K, V) slots that the conversion
// fills, the staging tile (K rows, V rows, K scales, V scales) and two
// slots of the converted tiles' scales.
template <int D, bool QUANT>
struct Smem {
  static constexpr int NT = 256, BQ = 128, BK = Cfg<D>::BK;
  static constexpr int CB = Cfg<D>::DP / 64;      // column blocks
  static constexpr int QBLK = BQ * 128;           // one column block of Q
  static constexpr int KBLK = BK * 128;           // one column block of K or V
  static constexpr int TILE = CB * KBLK;          // a K or V tile
  static constexpr int SLOTS = QUANT ? 2 : 3;
  static constexpr int q = 0;
  static constexpr int kv = CB * QBLK;            // slot s: K at kv + 2*s*TILE, V after it
  static constexpr int stg = kv + SLOTS * 2 * TILE;
  static constexpr int STG = QUANT ? 2 * BK * D + 2 * BK * 4 : 0;
  static constexpr int sc = stg + STG;            // slot s: K scales at sc + 2*s*BK*4, V after
  static constexpr int SC = QUANT ? 2 * 2 * BK * 4 : 0;
  static constexpr int bytes = sc + SC + 1024;    // + alignment slack
};

// 16 int8 values as 16 bf16 (exact), 8 packed pairs
__device__ __forceinline__ void int8_to_bf16(const uint4& raw, uint32_t (&w)[8]) {
  const uint32_t r[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // 0x4B0000uu is 2^23 + uu, uu = b + 128
#define S8F(sel) (__uint_as_float(__byte_perm(r[i], 0x4B000000u, 0x7440u | (sel))) - 8388736.f)
    w[2 * i] = pack_bf16(S8F(0), S8F(1));
    w[2 * i + 1] = pack_bf16(S8F(2), S8F(3));
#undef S8F
  }
}

// KV = bf16: ks/vs unused. KV = int8_t: ks/vs are the (Hkv,NB,BS) scales.
// ALIBI: `alibi` holds the (H,) slopes; without it, it is unused.
template <int D, typename KV, bool ALIBI>
__global__ void __launch_bounds__(256, Cfg<D>::MINB)
paged_prefill_kernel(const bf16* __restrict__ q, const KV* __restrict__ kp,
                     const KV* __restrict__ vp, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ tables,
                     const int* __restrict__ starts, const float* __restrict__ alibi,
                     bf16* __restrict__ out, int B, int S, int H, int Hkv, int NREP, int NB,
                     int BS, int T, int window, float scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  using L = Smem<D, QUANT>;
  constexpr int BK = L::BK, BQ = L::BQ, NT = L::NT, DP = Cfg<D>::DP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem + L::q;

  // longest first: the last query tile of every (row, KV head) comes first
  const int nrows = S * NREP;
  const int n_qt = (nrows + BQ - 1) / BQ;
  const int BG = B * Hkv;
  const int g = (blockIdx.x % BG) % Hkv, b = (blockIdx.x % BG) / Hkv;
  const int row0 = (n_qt - 1 - (int)(blockIdx.x / BG)) * BQ;
  const int start = starts[b];
  const int cap = T * BS;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int cq = (lane % 4) * 2;
  const int* trow = tables + (size_t)b * T;
  const size_t head = (size_t)g * NB * BS;  // pool rows of KV head g

  // this thread's rows: r and r + 8 of its warp's 16
  const int r_first = wg * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
  int qpos[2], hd[2];
  float slope[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int fr = row0 + r_first + 8 * i;
    qpos[i] = start + fr / NREP;
    hd[i] = g * NREP + fr % NREP;
    if (ALIBI && fr < nrows) slope[i] = alibi[hd[i]];
  }

  // keys this tile can see: from the first query's window floor up to the
  // last query's position (the causal frontier), inside the capacity
  const int qpos_first = start + row0 / NREP;
  const int qpos_last = start + (min(row0 + BQ, nrows) - 1) / NREP;
  const int k_begin = window > 0 ? max(qpos_first - window + 1, 0) : 0;
  const int k_end = min(qpos_last + 1, cap);
  const int t_begin = k_begin / BK;
  const int n_tiles = max((k_end + BK - 1) / BK - t_begin, 0);

  auto key_row = [&](int p) -> size_t {  // the pool row of key p < cap
    const int phys = min(max(__ldg(trow + p / BS), 0), NB - 1);
    return head + (size_t)phys * BS + p % BS;
  };
  auto slot = [&](int t) { return smem + L::kv + (t % L::SLOTS) * 2 * L::TILE; };
  unsigned char* stg = smem + L::stg;
  // tile t's copies: straight into its slot (bf16), or into the staging
  // tile with its scales (int8)
  auto issue_kv = [&](int t) {
    const int k0 = (t_begin + t) * BK;
    if constexpr (QUANT) {
      constexpr int CH = D / 16;
      for (int i = threadIdx.x; i < BK * CH; i += NT) {
        const int r = i / CH, c = i % CH, p = k0 + r;
        const bool ok = p < cap;
        const size_t row = ok ? key_row(p) : 0;
        cp_async16(stg + r * D + c * 16, kp + row * D + c * 16, ok);
        cp_async16(stg + BK * D + r * D + c * 16, vp + row * D + c * 16, ok);
      }
      for (int r = threadIdx.x; r < BK; r += NT) {
        const int p = k0 + r;
        const bool ok = p < cap;
        const size_t row = ok ? key_row(p) : 0;
        cp_async4(stg + 2 * BK * D + r * 4, ks + row, ok);
        cp_async4(stg + 2 * BK * D + BK * 4 + r * 4, vs + row, ok);
      }
    } else {
      unsigned char* sK = slot(t);
      constexpr int CH = DP / 8;  // chunks D/8.. are padding, zero-filled
      for (int i = threadIdx.x; i < BK * CH; i += NT) {
        const int r = i / CH, c = i % CH, p = k0 + r;
        const bool ok = p < cap && c < D / 8;
        const size_t at = ok ? key_row(p) * D + c * 8 : 0;
        const int off = (c / 8) * L::KBLK + r * 128 + (((c % 8) ^ (r % 8)) << 4);
        cp_async16(sK + off, kp + at, ok);
        cp_async16(sK + L::TILE + off, vp + at, ok);
      }
    }
  };
  // int8: the staging tile into tile t's bf16 slot (padding columns 0),
  // its scales beside it
  auto convert = [&](int t) {
    unsigned char* sK = slot(t);
    constexpr int CH = DP / 16;
    for (int i = threadIdx.x; i < 2 * BK * CH; i += NT) {
      const int kv = i / (BK * CH), r = (i / CH) % BK, c = i % CH;
      uint32_t w[8] = {};
      if (c < D / 16)
        int8_to_bf16(*reinterpret_cast<const uint4*>(stg + kv * BK * D + r * D + c * 16), w);
      // bf16 chunks 2c and 2c + 1 of row r
      unsigned char* row = sK + kv * L::TILE + (c / 4) * L::KBLK + r * 128;
      const int ch = 2 * (c % 4);
      *reinterpret_cast<uint4*>(row + ((ch ^ (r % 8)) << 4)) = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(row + (((ch + 1) ^ (r % 8)) << 4)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
    float* dst = reinterpret_cast<float*>(smem + L::sc + (t % 2) * 2 * BK * 4);
    const float* src = reinterpret_cast<const float*>(stg + 2 * BK * D);
    for (int i = threadIdx.x; i < 2 * BK; i += NT) dst[i] = src[i];
  };

  // Q tile: row r is position (row0 + r) / NREP of head g*NREP + member
  {
    const bf16* qb = q + ((size_t)b * S * H + (size_t)g * NREP) * D;
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < BQ * CH; i += NT) {
      const int r = i / CH, c = i % CH, fr = row0 + r;
      const bool ok = fr < nrows && c < D / 8;
      cp_async16(sQ + (c / 8) * L::QBLK + r * 128 + (((c % 8) ^ (r % 8)) << 4),
                 qb + (ok ? (size_t)(fr / NREP) * H * D + (size_t)(fr % NREP) * D + c * 8 : 0),
                 ok);
    }
  }
  if (n_tiles > 0) issue_kv(0);
  cp_async_commit();

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  // P, the register A operand of P.V: its registers stay P's until the
  // product that reads them is waited on, one tile later
  uint32_t p[BK / 16][4];

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every warpgroup is done with tile t - 1; the
    // slot tile t + 1 takes was last read by tile t - 2 (bf16: three
    // slots) or is the staging tile, converted here first (int8)
    cp_async_wait_all();
    if constexpr (QUANT) {
      __syncthreads();
      convert(t);
    }
    fence_async_smem();
    __syncthreads();
    const unsigned char* sK = slot(t);
    const unsigned char* sV = sK + L::TILE;
    const int k0 = (t_begin + t) * BK;

    // S = Q . K^T for this warpgroup's 64 rows, on the tensor cores, while
    // the threads look up tile t + 1's keys in the table and start its copy
    float s[BK / 2];
    fence_acc(s);
    wg_fence();
    ss_product<D, BK, L::QBLK, L::KBLK>(s, sQ + wg * 64 * 128, sK);
    wg_commit();
    fence_acc(s);
    if (t + 1 < n_tiles) {
      issue_kv(t + 1);
      cp_async_commit();
    }
    wg_wait_all();
    fence_acc(s);
    fence_acc(o);
    fence_regs(p);

    // the f32 logits: without alibi q.k [* s_k], the scale applied to their
    // differences below; with alibi, as the TPU kernel's, ((q.k) [* s_k]) *
    // scale + slope * key
    const float* kss = reinterpret_cast<const float*>(smem + L::sc + (t % 2) * 2 * BK * 4);
    if constexpr (QUANT || ALIBI) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[4 * n + e];
          if constexpr (QUANT) v *= kss[n * 8 + cq + (e % 2)];
          if constexpr (ALIBI) v = v * scale + slope[e / 2] * (float)(k0 + n * 8 + cq + (e % 2));
          s[4 * n + e] = v;
        }
    }
    // the mask, only where the tile crosses the diagonal, the window floor
    // or the capacity
    if (k0 + BK - 1 > qpos_first || k0 + BK > cap || (window > 0 && k0 <= qpos_last - window)) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + cq + (e % 2), qp = qpos[e / 2];
          if (col >= cap || col > qp || (window > 0 && col <= qp - window))
            s[4 * n + e] = NEG_INF;
        }
    }

    // online softmax in registers; a row's four threads agree. p =
    // exp2((s - m) * c), c = scale * log2(e) on the raw logits (log2(e) on
    // alibi's scaled ones): the difference is formed in the logits' own
    // domain, so alibi's large values (~10^3) lose nothing to the base
    const float c = ALIBI ? LOG2E : scale * LOG2E;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    float ref[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      ref[i] = mx[i] == NEG_INF ? 0.f : mx[i];  // no visible key yet: p = 0
      alpha[i] = fast_exp2((m_run[i] - ref[i]) * c);
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * n + e] = fast_exp2((s[4 * n + e] - ref[e / 2]) * c);
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
    if constexpr (QUANT) {  // the V scale folds into the probability columns
      const float* vss = kss + BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * n + e] *= vss[n * 8 + cq + (e % 2)];
    }

    // O += P . V: P rounded to bf16 is the A operand; V is read MN-major
    pack_rows<BK>(p, s);
    fence_acc(o);
    wg_fence();
    rs_product<DP, BK, L::KBLK>(o, p, sV);
    wg_commit();
    fence_acc(o);
  }
  wg_wait_all();
  fence_acc(o);
  fence_regs(p);
  cp_async_wait_all();  // a block with no tile still has Q's copies in flight

  // out = O / l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int fr = row0 + r_first + 8 * i;
    if (fr >= nrows) continue;
    const float safe_l = (l == 0.f) ? 1.f : l;
    bf16* orow = out + (((size_t)b * S + fr / NREP) * H + hd[i]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + cq) =
          __floats2bfloat162_rn(o[4 * n + 2 * i] / safe_l, o[4 * n + 2 * i + 1] / safe_l);
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *starts, *alibi;
  void* out;
  int B, S, H, Hkv, NB, BS, T, window;
  float scale;
};

template <int D, typename KV, bool ALIBI>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Smem<D, sizeof(KV) == 1>;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(paged_prefill_kernel<D, KV, ALIBI>, L::bytes, done);
  if (err != cudaSuccess) return err;
  const int n_rep = a.H / a.Hkv;
  const long long blocks =
      ((long long)a.S * n_rep + L::BQ - 1) / L::BQ * (long long)a.B * a.Hkv;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  paged_prefill_kernel<D, KV, ALIBI><<<(int)blocks, L::NT, L::bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.starts),
      static_cast<const float*>(a.alibi), static_cast<bf16*>(a.out), a.B, a.S, a.H, a.Hkv, n_rep,
      a.NB, a.BS, a.T, a.window, a.scale);
  return cudaGetLastError();
}

// alibi only at 64 and 128 (the widths an alibi model has)
template <typename KV, bool ALIBI>
cudaError_t launch_kv(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64, KV, ALIBI>(a, s);
    case 128: return launch<128, KV, ALIBI>(a, s);
    default: break;
  }
  if constexpr (!ALIBI) {
    if (D == 80) return launch<80, KV, false>(a, s);
    if (D == 256) return launch<256, KV, false>(a, s);
  }
  return cudaErrorInvalidValue;
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
  const int n_rep = H / Hkv;
  if (n_rep != 1 && n_rep != 2 && n_rep != 4 && n_rep != 8) return cudaErrorInvalidValue;
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
