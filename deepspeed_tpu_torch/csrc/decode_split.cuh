// The split-KV single-query attention core shared by the two decode kernels,
// `decode_kernel` (dense cache, `decode_attention.cu`: K2, K2-int8, K8-a) and
// `paged_decode_kernel` (block tables, `paged_decode_attention.cu`: K3,
// K3-int8, K3-alibi, K8-b). Each source's header states the function; this
// file holds how it is computed.
//
// Bound: decode reads each live key and value row of one KV head once and
// does 4*n_rep*D operations on it, far below the card's ~295 operations a
// byte, so the bytes bound it and the design has one job: keep enough bytes
// in flight on every SM (by Little's law ~2 MB across the card).
//
// Design (flash-decoding):
//   * Grid (chunk, KV head g, row b). The KV axis is cut into chunks of
//     CHUNK positions, so the chunk count is a function of the cache
//     capacity alone (M, or T*BS) and never of B, H, Hkv or the card: a
//     tensor-parallel shard runs the very same blocks on its heads, and two
//     calls give the same bits. A block whose chunk lies wholly outside the
//     row's live keys [lo, hi) exits at once. On an H100, CHUNK = 128 (four
//     warps, three blocks an SM) timed fastest at the v1, v2 and Bloom shapes
//     and at M = 8192, against 64 and 256 (PERF.md section 6).
//   * Each warp takes 32 consecutive positions of the chunk, resolves their
//     cache rows (through the clamped table for K3) and issues every 16-byte
//     cp.async of its K slice, then of its V slice, before it computes: a
//     block has its whole chunk in flight at once (64 KB at D = 128 in
//     bf16). Rows land in shared memory with their 16-byte pieces
//     XOR-swizzled by the row, so ldmatrix reads them without bank
//     conflicts.
//   * Both products run on mma.sync.m16n8k16 (bf16 in, f32 out) with the GQA
//     group as the 16 rows (n_rep <= 8 real, the rest zero): S = Q.K^T over
//     the slice (K by ldmatrix), the logits scaled (and alibi-biased) in f32,
//     the slice's own max, p = exp(s - m) rounded to bf16 as the A operand of
//     P.V straight from S's accumulator registers (V by ldmatrix.trans). An
//     int8 cache is converted to bf16 on its way into the fragments (exact),
//     its K scale folded into the logit column and its V scale into p before
//     the rounding, so with unit scales the int8 path runs the bf16 path's
//     products on the same values and gives its bits.
//   * The warps' (m, l, O) meet once, in shared memory, summed in warp order;
//     a row whose live keys fit one chunk writes its output there. Otherwise
//     each chunk writes its f32 partial to the workspace, and the row's last
//     chunk to arrive (an integer count it leaves at 0) merges every partial
//     in chunk order, acc*exp(m_i - m), folds in K3's staged column last, as
//     f32 p*v, and divides by l (l == 0 gives zeros).
//   * Widths: D = 64, 128, and for a GQA group of one (the zoo's phi-2 and
//     pythia-1b) 80 and 256. At D = 80, S takes two pairs of k-steps and
//     one single step (ldmatrix.x2) and P.V ten n8 tiles; its 160-byte rows
//     keep pieces 8-9 (bf16) or 4 (int8) unswizzled. At D = 256 a warp's
//     O is 16 x 256 f32, 128 registers a thread beside Q's 32 fragment
//     registers, and a block's K and V slices fill 128 KB, one block an SM
//     (ptxas, CUDA 12.8: 146-155 registers, no spill; 63-78 at 80).
#pragma once

#include "hopper_common.cuh"

namespace {
namespace dsplit {

constexpr int SLICE = 32;           // positions a warp takes
constexpr int CHUNK = 128;          // positions a block takes
constexpr int NW = CHUNK / SLICE;   // warps a block
constexpr int THREADS = NW * 32;
constexpr int OPAD = 8;             // f32 padding of a warp's O rows in shared memory
constexpr int PEXTRA = 16;          // floats after a partial's O: n_rep m, n_rep l, padding
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const bf16* q;            // (B, H, D)
  const void* k;            // K2: (B, M, Hkv, D); K3: (Hkv, NB, BS, D)
  const void* v;
  const float* ks;          // int8 only: one scale per cache row, the values' row index
  const float* vs;
  const int* tables;        // K3: (B, T)
  const int* lengths;       // (B,)
  const bf16* kn;           // K3, staged: (B, Hkv, D)
  const bf16* vn;
  const float* alibi;       // K3-alibi: (H,)
  bf16* out;                // (B, H, D)
  float* part;              // (B, Hkv, chunks, n_rep*D + PEXTRA) f32 when chunks > 1
  int* counts;              // (B*Hkv,) arrival counts, 0 between calls
  int H, Hkv, M, NB, BS, T, staged, window, chunks;
  float scale;
};

template <int D, typename KV>
struct Geo {
  static constexpr int ROWB = D * (int)sizeof(KV);  // bytes of a cache row
  static constexpr int PIECES = ROWB / 16;          // its 16-byte pieces
  // pieces are swizzled within groups of SW (a power of two, at most 8);
  // a last group shorter than SW (D = 80: pieces 8-9 in bf16, 4 in int8)
  // stays in place, so no piece leaves its row
  static constexpr int SW = PIECES >= 8 ? 8 : PIECES >= 4 ? 4 : PIECES >= 2 ? 2 : 1;
  static constexpr int SWIZZLED = PIECES / SW * SW;
  static constexpr int SLICEB = SLICE * ROWB;       // one warp's K (or V) slice
};

// shared-memory byte offset of piece `pc` of slice row `key`
template <int D, typename KV>
__device__ __forceinline__ int piece_at(int key, int pc) {
  using G = Geo<D, KV>;
  return key * G::ROWB + ((pc < G::SWIZZLED ? pc ^ (key % G::SW) : pc) << 4);
}

// floats of the block's combine area (it reuses the K/V slices' bytes)
template <int D, int NREP>
constexpr int combine_floats() {
  return NW * NREP * (D + OPAD) + NREP * D + NW * NREP * 3 + 4 * NREP + 4;
}

template <int D, int NREP, typename KV>
constexpr int smem_bytes() {
  return NW * 2 * Geo<D, KV>::SLICEB > combine_floats<D, NREP>() * 4
             ? NW * 2 * Geo<D, KV>::SLICEB
             : combine_floats<D, NREP>() * 4;
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a_lo, uint32_t a_hi, uint32_t b0,
                                    uint32_t b1) {
  // A rows 8-15 (a1, a3) are zero: the group has at most eight heads
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a_lo), "r"(0u), "r"(a_hi), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t i8x2(int8_t lo, int8_t hi) {
  return pack_bf16((float)lo, (float)hi);  // |x| <= 128: exact in bf16
}

// S's B fragments for key tile j (8 keys) and k-steps 2u, 2u+1:
// {b0, b1} of step 2u, then of step 2u+1.
template <int D, typename KV>
__device__ __forceinline__ void k_frag(uint32_t (&bk)[4], const unsigned char* sK, int j, int u,
                                       int lane) {
  if constexpr (sizeof(KV) == 2) {
    const int key = 8 * j + (lane & 7);
    ldsm_x4(bk, sK + piece_at<D, KV>(key, 4 * u + (lane >> 3)));
  } else {
    const int key = 8 * j + (lane >> 2), t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int8_t* row = reinterpret_cast<const int8_t*>(sK + piece_at<D, KV>(key, 2 * u + h));
      bk[2 * h] = i8x2(row[2 * t], row[2 * t + 1]);
      bk[2 * h + 1] = i8x2(row[8 + 2 * t], row[9 + 2 * t]);
    }
  }
}

// S's B fragments {b0, b1} for key tile j and the single k-step s (the last
// of a width that is an odd number of k16 steps, D = 80).
template <int D, typename KV>
__device__ __forceinline__ void k_frag1(uint32_t (&bk)[2], const unsigned char* sK, int j, int s,
                                        int lane) {
  if constexpr (sizeof(KV) == 2) {
    const int key = 8 * j + (lane & 7);
    ldsm_x2(bk, sK + piece_at<D, KV>(key, 2 * s + ((lane >> 3) & 1)));
  } else {
    const int key = 8 * j + (lane >> 2), t = lane & 3;
    const int8_t* row = reinterpret_cast<const int8_t*>(sK + piece_at<D, KV>(key, s));
    bk[0] = i8x2(row[2 * t], row[2 * t + 1]);
    bk[1] = i8x2(row[8 + 2 * t], row[9 + 2 * t]);
  }
}

// P.V's B fragments for k-step s (16 keys) and column tiles 2n, 2n+1:
// {b0, b1} of tile 2n, then of tile 2n+1.
template <int D, typename KV>
__device__ __forceinline__ void v_frag(uint32_t (&bv)[4], const unsigned char* sV, int s, int n,
                                       int lane) {
  if constexpr (sizeof(KV) == 2) {
    const int mi = lane >> 3;
    const int key = 16 * s + (mi & 1) * 8 + (lane & 7);
    ldsm_x4_t(bv, sV + piece_at<D, KV>(key, 2 * n + (mi >> 1)));
  } else {
    const int gr = lane >> 2, t = lane & 3;
    const int k0 = 16 * s + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * (2 * n + h) + gr, pc = col >> 4, at = col & 15;
      auto val = [&](int key) {
        return reinterpret_cast<const int8_t*>(sV + piece_at<D, KV>(key, pc))[at];
      };
      bv[2 * h] = i8x2(val(k0), val(k0 + 1));
      bv[2 * h + 1] = i8x2(val(k0 + 8), val(k0 + 9));
    }
  }
}

// Issue one slice's 16-byte copies: slice row kk from cache row `row` of
// lane kk, zero-filled where that lane's key is not live.
template <int D, typename KV>
__device__ __forceinline__ void copy_slice(unsigned char* dst, const KV* src, size_t row,
                                           bool live, int lane) {
  using G = Geo<D, KV>;
  constexpr int PER = 16 / (int)sizeof(KV);
#pragma unroll
  for (int i = 0; i < G::PIECES; ++i) {
    const int idx = i * 32 + lane, kk = idx / G::PIECES, pc = idx % G::PIECES;
    const size_t r = __shfl_sync(FULL, row, kk);
    const bool ok = __shfl_sync(FULL, (int)live, kk);
    cp_async16(dst + piece_at<D, KV>(kk, pc), src + r * D + pc * PER, ok);
  }
}

template <int D, int NREP, typename KV, bool ALIBI, bool PAGED>
__device__ __forceinline__ void split_decode(const Params& p) {
  using G = Geo<D, KV>;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int TOTAL = NREP * D;
  constexpr int PSTRIDE = TOTAL + PEXTRA;
  extern __shared__ __align__(128) unsigned char smem[];

  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;  // mma fragment row (head) and column pair
  const int k0 = c * CHUNK + warp * SLICE;  // this warp's first position

  // the row's live keys [lo, hi) and the chunks they touch; K3's table
  // entry for this lane's key is read beside the length, not after it
  const int length = p.lengths[b];
  int entry = 0;
  if constexpr (PAGED)
    entry = p.tables[(size_t)b * p.T + min(k0 + lane, p.T * p.BS - 1) / p.BS];
  int lo = 0, hi, qpos = 0;
  if constexpr (PAGED) {
    qpos = length - 1;
    hi = min(max(p.staged ? length - 1 : length, 0), p.T * p.BS);
    lo = p.window > 0 ? max(qpos - p.window + 1, 0) : 0;
  } else {
    hi = min(max(length, 0), p.M);
  }
  const bool any = hi > lo;
  const int first = any ? lo / CHUNK : 0;
  const int n_live = any ? (hi + CHUNK - 1) / CHUNK - first : 1;
  if (c < first || c >= first + n_live) return;

  const size_t bg = (size_t)b * p.Hkv + g;
  const int klo = max(lo, k0), khi = min(hi, k0 + SLICE);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_w = NEG_INF, l_w = 0.f;

  if (khi > klo) {  // warp-uniform
    unsigned char* sK = smem + warp * 2 * G::SLICEB;
    unsigned char* sV = sK + G::SLICEB;
    const int key = k0 + lane;
    const bool live = key >= klo && key < khi;
    size_t row = 0;  // the cache row of this lane's key
    if (live) {
      if constexpr (PAGED) {
        const int phys = min(max(entry, 0), p.NB - 1);
        row = ((size_t)g * p.NB + phys) * p.BS + key % p.BS;
      } else {
        row = ((size_t)b * p.M + key) * p.Hkv + g;
      }
    }
    copy_slice<D, KV>(sK, static_cast<const KV*>(p.k), row, live, lane);
    cp_async_commit();
    copy_slice<D, KV>(sV, static_cast<const KV*>(p.v), row, live, lane);
    cp_async_commit();
    float sk = 1.f, sv = 1.f;
    if (QUANT && live) {
      sk = p.ks[row];
      sv = p.vs[row];
    }

    // Q's A fragments: row gr is head g*NREP + gr; rows past the group are 0
    uint32_t qa[D / 16][2];
    const uint32_t* qg = reinterpret_cast<const uint32_t*>(
        p.q + ((size_t)b * p.H + (size_t)g * NREP + (gr < NREP ? gr : 0)) * D);
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      qa[s][0] = gr < NREP ? qg[8 * s + t] : 0u;
      qa[s][1] = gr < NREP ? qg[8 * s + 4 + t] : 0u;
    }
    const float slope = ALIBI && gr < NREP ? p.alibi[g * NREP + gr] : 0.f;

    cp_async_wait<1>();  // this lane's K copies have landed
    __syncwarp();        // and every lane's
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int u = 0; u < D / 32; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bk[4];
        k_frag<D, KV>(bk, sK, j, u, lane);
        mma(s[j], qa[2 * u][0], qa[2 * u][1], bk[0], bk[1]);
        mma(s[j], qa[2 * u + 1][0], qa[2 * u + 1][1], bk[2], bk[3]);
      }
    if constexpr (D % 32 == 16) {  // the odd last k-step
      constexpr int st = D / 16 - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bk[2];
        k_frag1<D, KV>(bk, sK, j, st, lane);
        mma(s[j], qa[st][0], qa[st][1], bk[0], bk[1]);
      }
    }

    // logits of head gr at slice keys 8j + 2t + e, and the slice's max
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 8 * j + 2 * t + e, pos = k0 + kk;
        float x = s[j][e];
        if constexpr (QUANT) x *= __shfl_sync(FULL, sk, kk);
        x *= p.scale;
        if constexpr (ALIBI) x += slope * (float)pos;
        s[j][e] = pos >= klo && pos < khi ? x : NEG_INF;
        mx = fmaxf(mx, s[j][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 8 * j + 2 * t + e, pos = k0 + kk;
        const float pr = pos >= klo && pos < khi ? expf(s[j][e] - mx) : 0.f;
        sum += pr;
        // p (times the V scale) is rounded to bf16 by the packing below
        s[j][e] = QUANT ? pr * __shfl_sync(FULL, sv, kk) : pr;
      }
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    m_w = mx;
    l_w = sum;

    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t a_lo = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      const uint32_t a_hi = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bv[4];
        v_frag<D, KV>(bv, sV, ks, n, lane);
        mma(o[2 * n], a_lo, a_hi, bv[0], bv[1]);
        mma(o[2 * n + 1], a_lo, a_hi, bv[2], bv[3]);
      }
    }
  }

  // the warps meet: (m, l, O) of each, summed in warp order
  float* sO = reinterpret_cast<float*>(smem);  // [NW][NREP][D + OPAD]
  float* sF = sO + NW * NREP * (D + OPAD);     // [NREP][D] the chunk's (then the row's) O
  float* sML = sF + TOTAL;                     // [NW][NREP][2]
  float* sW = sML + NW * NREP * 2;             // [NW][NREP] the warps' weights
  float* sM = sW + NW * NREP;                  // [NREP] m, l, and the staged fold
  float* sL = sM + NREP;
  float* sA = sL + NREP;
  float* sPn = sA + NREP;
  int* sFlag = reinterpret_cast<int*>(sPn + NREP);
  __syncthreads();  // every warp is done with its K and V slices
  if (gr < NREP) {
    float* row = sO + (warp * NREP + gr) * (D + OPAD) + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) = make_float2(o[n][0], o[n][1]);
    if (t == 0) {
      sML[(warp * NREP + gr) * 2] = m_w;
      sML[(warp * NREP + gr) * 2 + 1] = l_w;
    }
  }
  __syncthreads();
  if (tid < NREP) {
    float m = NEG_INF, l = 0.f;
    for (int w = 0; w < NW; ++w) m = fmaxf(m, sML[(w * NREP + tid) * 2]);
    for (int w = 0; w < NW; ++w) {
      const float e = expf(sML[(w * NREP + tid) * 2] - m);
      sW[w * NREP + tid] = e;
      l = fmaf(sML[(w * NREP + tid) * 2 + 1], e, l);
    }
    sM[tid] = m;
    sL[tid] = l;
  }
  __syncthreads();
  for (int i = tid * 4; i < TOTAL; i += THREADS * 4) {
    const int r = i / D, d = i % D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < NW; ++w) {
      const float e = sW[w * NREP + r];
      const float4 x = *reinterpret_cast<const float4*>(sO + (w * NREP + r) * (D + OPAD) + d);
      acc = make_float4(fmaf(x.x, e, acc.x), fmaf(x.y, e, acc.y), fmaf(x.z, e, acc.z),
                        fmaf(x.w, e, acc.w));
    }
    *reinterpret_cast<float4*>(sF + i) = acc;
  }

  if (n_live > 1) {
    // publish this chunk's partial; the row's last chunk to arrive merges
    float* part = p.part + bg * p.chunks * PSTRIDE;
    __syncthreads();
    float* mine = part + (size_t)c * PSTRIDE;
    for (int i = tid * 4; i < TOTAL; i += THREADS * 4)
      *reinterpret_cast<float4*>(mine + i) = *reinterpret_cast<const float4*>(sF + i);
    if (tid < NREP) {
      mine[TOTAL + tid] = sM[tid];
      mine[TOTAL + NREP + tid] = sL[tid];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *sFlag = atomicAdd(p.counts + bg, 1) == n_live - 1;
    __syncthreads();
    if (!*sFlag) return;
    __threadfence();
    const float* live0 = part + (size_t)first * PSTRIDE;
    if (tid < NREP) {
      float m = NEG_INF, l = 0.f;
      for (int i = 0; i < n_live; ++i) m = fmaxf(m, __ldcg(live0 + (size_t)i * PSTRIDE + TOTAL + tid));
      for (int i = 0; i < n_live; ++i) {
        const float* pi = live0 + (size_t)i * PSTRIDE + TOTAL;
        l = fmaf(__ldcg(pi + NREP + tid), expf(__ldcg(pi + tid) - m), l);
      }
      sM[tid] = m;
      sL[tid] = l;
    }
    __syncthreads();
    for (int j = tid * 4; j < TOTAL; j += THREADS * 4) {
      const int r = j / D;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = 0; i < n_live; ++i) {
        const float* pi = live0 + (size_t)i * PSTRIDE;
        const float e = expf(__ldcg(pi + TOTAL + r) - sM[r]);
        const float4 x = __ldcg(reinterpret_cast<const float4*>(pi + j));
        acc = make_float4(fmaf(x.x, e, acc.x), fmaf(x.y, e, acc.y), fmaf(x.z, e, acc.z),
                          fmaf(x.w, e, acc.w));
      }
      *reinterpret_cast<float4*>(sF + j) = acc;
    }
    if (tid == 0) p.counts[bg] = 0;
  }
  __syncthreads();

  if constexpr (PAGED) {
    if (p.staged) {
      // the row's new token, not in the pool yet: one more column, in f32
      if (warp == 0) {
        constexpr int PER = (D + 31) / 32;  // columns a lane takes, the last lanes fewer
        float kf[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e)
          kf[e] = lane * PER + e < D ? __bfloat162float(p.kn[bg * D + lane * PER + e]) : 0.f;
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          const bf16* qr = p.q + ((size_t)b * p.H + (size_t)g * NREP + r) * D + lane * PER;
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < PER; ++e)
            if (lane * PER + e < D) dot += __bfloat162float(qr[e]) * kf[e];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
          if (lane == 0) {
            const float sn =
                ALIBI ? dot * p.scale + p.alibi[g * NREP + r] * (float)qpos : dot * p.scale;
            const float m_new = fmaxf(sM[r], sn);
            const float alpha = expf(sM[r] - m_new), pn = expf(sn - m_new);
            sL[r] = sL[r] * alpha + pn;
            sA[r] = alpha;
            sPn[r] = pn;
          }
        }
      }
      __syncthreads();
    }
  }

  bf16* og = p.out + ((size_t)b * p.H + (size_t)g * NREP) * D;
  for (int i = tid; i < TOTAL; i += THREADS) {
    const int r = i / D;
    float acc = sF[i];
    if constexpr (PAGED)
      if (p.staged) acc = acc * sA[r] + sPn[r] * __bfloat162float(p.vn[bg * D + i % D]);
    const float l = sL[r];
    og[i] = __float2bfloat16(acc / (l == 0.f ? 1.f : l));
  }
}

// Launch `kernel` over (chunks, Hkv, B).
template <int D, int NREP, typename KV, typename Kernel>
cudaError_t launch_split(Kernel kernel, const Params& p, int B, bool (&done)[MAX_DEVICES],
                         cudaStream_t s) {
  cudaError_t err = allow_smem(kernel, smem_bytes<D, NREP, KV>(), done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.chunks, p.Hkv, B), THREADS, smem_bytes<D, NREP, KV>(), s>>>(p);
  return cudaGetLastError();
}

// The chunk count of a call over a cache of `capacity` positions (chunk c
// covers positions [c*CHUNK, (c+1)*CHUNK); a capacity of 0 still takes
// one), or 0 when the grid cannot hold it.
inline int plan_chunks(int capacity) {
  if (capacity < 0) return 0;
  const long long chunks = capacity > 0 ? (capacity + (long long)CHUNK - 1) / CHUNK : 1;
  return chunks <= 65535 ? (int)chunks : 0;
}

// The split of a call: the positions a chunk takes, the chunk count, and the
// workspace it takes when it has more than one chunk (else 0 and 0): the
// partials, (B, Hkv, chunks, n_rep*D + PEXTRA) f32, and B*Hkv arrival counts.
inline cudaError_t plan(int capacity, int B, int Hkv, int n_rep, int D, int* chunk, int* chunks,
                        long long* floats, int* counts) {
  *chunk = CHUNK;
  *chunks = plan_chunks(capacity);
  const bool split = *chunks > 1;
  *floats = split ? (long long)B * Hkv * *chunks * (n_rep * D + PEXTRA) : 0;
  *counts = split ? B * Hkv : 0;
  return *chunks && B >= 0 && Hkv > 0 && n_rep > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether a call with `chunks` chunks has the workspace it needs.
inline bool has_workspace(int chunks, const void* part, const void* counts) {
  return chunks == 1 ||
         (part != nullptr && counts != nullptr && reinterpret_cast<uintptr_t>(part) % 16 == 0);
}

}  // namespace dsplit
}  // namespace
