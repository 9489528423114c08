// Flash attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bf16 in, f32 accumulation.
//
// Replaces the TPU kernels of `deepspeed_tpu/ops/pallas/flash_attention.py`
// `_bwd` (:425): `_dq_kernel` (:204) / `_dq_kernel_tri` (:235) with
// `_dq_update` (:184), and `_dkv_kernel` (:279) / `_dkv_kernel_tri` (:315)
// with `_dkv_update` (:257) and the GQA group sum (:553). The triangular and
// rectangular TPU grids compute the same function; here one kernel of each
// kind covers both. It computes what those kernels compute:
//   * q, dO (B,Sq,H,D) and k, v (B,Sk,Hkv,D) bf16; the forward's base-2
//     lse and delta = rowsum(dO*O) (B,H,Sq) f32, delta taken outside, as
//     `_bwd` takes it (:434);
//   * qs = q*(softmax_scale*log2 e) rounded to bf16, the forward's operand;
//   * p = exp2(qs.k^T - lse), with bottom-right aligned causal masking
//     (key j seen by query i when j <= i + Sk - Sq); masked entries, keys
//     past Sk and queries past Sq get p = 0 exactly;
//   * ds = p*(dO.v^T - delta);
//   * dq = softmax_scale * sum_j ds.k, with ds rounded to bf16 (:199, :232);
//   * dk = ln2 * sum_i ds^T.qs with ds rounded to bf16 (:274, :311);
//   * dv = sum_i p^T.dO. The TPU kernel keeps p in f32 for this product
//     (:267); here p is rounded to bf16 for the tensor cores, which moves dv
//     by about 2^-9 relative, well inside the 2e-2 bf16 tolerance against
//     the plain version;
//   * D is 64, 80, 128 or 256; Sq and Sk are any, the ragged edges masked
//     here.
//
// Bound on an H100: five products of 2*D operations each per live
// (query, key) pair and head, 10*D in all (S and dP are computed in both
// kernels, so the kernels do 14*D), against reading q, k, v, o, dO, lse and
// delta and writing dq, dk and dv once. At B=4, S=2048, H=32, Hkv=4, D=64
// causal that is 1.72e11 operations (0.174 ms at 989 TFLOP/s bf16) against
// ~0.2 GB (0.06 ms at 3.35 TB/s): the tensor cores bound it. The zoo's
// training calls are bound the same way: phi-2 (B=2, H = Hkv = 32, D = 80)
// and pythia-1b (B=4, H = Hkv = 8, D = 256), S=2048 causal, give dq 0.065
// and 0.104 ms, dk/dv 0.087 and 0.139 ms (6*D and 8*D operations a pair).
//
// Design. Nothing is carried between blocks, so each kernel owns its
// outputs outright: no f32 intermediate in device memory, no atomic, and
// every sum is taken in a fixed order, so two calls on the same inputs give
// the same bits (remat re-runs the forward, and a run with remat must match
// one without).
//   * Every product runs on the tensor cores as wgmma (m64nNk16, bf16 in,
//     f32 accumulate in registers). S and dP are SS products (both operands
//     K-major in shared memory); dq, dK and dV are RS products whose A
//     operand is the previous accumulator, rounded to bf16 and packed in
//     registers, and whose B operand (K, qs, dO) is read MN-major,
//     transposed by the descriptor. Every tile is stored in wgmma's
//     canonical 128-byte-swizzled layout, so one copy serves both uses.
//   * dq (`DqCfg`): one block of NWG warpgroups per (q tile of 64*NWG rows,
//     head, batch). K and V tiles of BK keys arrive by cp.async into a ring
//     of three stages, the next tile's copy issued right after the barrier
//     that opens the current one, and the wait on each tile's dq product
//     deferred to the next tile. The block walks the KV tiles up to the
//     causal stop (`hi` of :497); dq accumulates in registers and is
//     written once. Blocks are numbered longest first.
//   * dk/dv (`DkvCfg`): one block per (64 keys a warpgroup, KV head,
//     batch), dk and dv in registers for the whole GQA group. The block
//     walks the n_rep query heads of its group and, for each, the q tiles
//     from the causal start (`lo` of :523); each step's q, dO, lse and delta
//     arrive by cp.async into a ring of three stages. It scales q to qs in
//     place, forms S^T = K.qs^T and dP^T = V.dO^T, then dV += P^T.dO and
//     dK += dS^T.qs (waited at the next step), and writes dk and dv once.
//     Blocks are numbered longest first (the first KV tile sees every q
//     tile when causal).
//   * The mask is evaluated only on tiles that cross the diagonal or the
//     sequence ends; the shared-memory opt-in is set once per device.
// Other widths (`DP` of the configs: D rounded up to whole 64-column
// swizzle blocks):
//   * D = 80 fills no whole swizzle block, so every tile and the dq, dk and
//     dv accumulators are padded to 128 columns, as in K1-fwd: the copies
//     zero-fill columns 80-127 (no global read), S and dP take only their
//     five real k-steps, the padded columns of dq, dk and dv come out zero
//     (their K, qs and dO columns are) and only 80 columns are stored. The
//     tiles are the D = 128 ones.
//   * D = 256, dq: q and dO take 64 KB, so one warpgroup a block and K/V
//     tiles of 32 keys keep the three-stage ring (96 KB, 161 KB in all);
//     dq is 128 f32 registers a thread beside S's and dP's 16 each.
//   * D = 256, dk/dv: dk and dv of 64 keys at 256 columns would be 256 f32
//     registers a thread in one warpgroup. So two warpgroups share the
//     block's 64 keys, each owning 128 of the 256 columns of dk and dv (128
//     registers). Each forms the whole S^T and dP^T itself from the shared
//     tiles (the same products on the same operands, so the two agree) and
//     multiplies its half of qs and dO: no hand-over, no extra barrier, at
//     the price of S^T and dP^T twice (12*D operations a pair against 8*D).
//     K and V take 64 KB, a q step (32 rows) 33 KB: 164 KB with three stages.
// What holds them: S and dP are computed in both kernels (14*D operations
// a pair against 10*D); p and ds are formed on the warpgroups that issue
// the products, so the tensor cores idle meanwhile; dk/dv rescales each q
// tile in shared memory (one barrier more a step); D = 80 pays the padding
// on the RS products (1.6x), D = 256 one warpgroup a dq block and the
// doubled S^T and dP^T. TMA, warp specialisation and one fused kernel (dq
// reduced in a fixed order) are the next steps.

#include "flash_attention_common.cuh"

namespace {

constexpr int STAGES = 3;       // ring depth
constexpr float LN2 = 0.6931471805599453f;

// Tiles by head width. dq: NWG warpgroups of 64 query rows each, walking
// KV tiles of BK keys. dk/dv: NWG warpgroups in groups of CS that share 64
// keys, each of a group owning DP/CS columns of dk and dv, walking q tiles
// of BQ rows. MINB is the number of blocks an SM should hold; DP the width
// of the shared tiles and the accumulators (header).
template <int D>
struct DqCfg;
template <>
struct DqCfg<64> {
  static constexpr int NWG = 2, BK = 64, MINB = 2, DP = 64;
};
template <>
struct DqCfg<80> {
  static constexpr int NWG = 2, BK = 64, MINB = 1, DP = 128;
};
template <>
struct DqCfg<128> {
  static constexpr int NWG = 2, BK = 64, MINB = 1, DP = 128;
};
template <>
struct DqCfg<256> {
  static constexpr int NWG = 1, BK = 32, MINB = 1, DP = 256;
};
template <int D>
struct DkvCfg;
template <>
struct DkvCfg<64> {
  static constexpr int NWG = 1, BQ = 64, MINB = 2, DP = 64, CS = 1;
};
template <>
struct DkvCfg<80> {
  static constexpr int NWG = 2, BQ = 32, MINB = 1, DP = 128, CS = 1;
};
template <>
struct DkvCfg<128> {
  static constexpr int NWG = 2, BQ = 32, MINB = 1, DP = 128, CS = 1;
};
template <>
struct DkvCfg<256> {
  static constexpr int NWG = 2, BQ = 32, MINB = 1, DP = 256, CS = 2;
};

// Shared memory in bytes, every bf16 tile in the swizzled layout of
// `flash_attention_common.cuh` (read K-major, or MN-major through the
// descriptor).
template <int D>
struct DqSmem {
  using C = DqCfg<D>;
  static constexpr int NTHREADS = C::NWG * 128;
  static constexpr int BQ = C::NWG * 64;          // query rows per block
  static constexpr int CB = C::DP / 64;
  static constexpr int QBLK = BQ * 128;           // one column block of q or dO
  static constexpr int KBLK = C::BK * 128;        // one column block of K or V
  static constexpr int q = 0;
  static constexpr int dout = CB * QBLK;
  static constexpr int kv = 2 * CB * QBLK;        // stage s: K at kv + 2*s*CB*KBLK, V after it
  static constexpr int bytes = kv + STAGES * 2 * CB * KBLK + 1024;
};

template <int D>
struct DkvSmem {
  using C = DkvCfg<D>;
  static constexpr int NTHREADS = C::NWG * 128;
  static constexpr int BKV = C::NWG / C::CS * 64; // keys per block
  static constexpr int DW = C::DP / C::CS;        // dk/dv columns a warpgroup owns
  static constexpr int BQ = C::BQ;
  static constexpr int CB = C::DP / 64;
  static constexpr int KBLK = BKV * 128;          // one column block of K or V
  static constexpr int QBLK = BQ * 128;           // one column block of q or dO
  static constexpr int k = 0;
  static constexpr int v = CB * KBLK;
  static constexpr int ring = 2 * CB * KBLK;
  // one stage: q (scaled to qs in place), dO, lse and delta of one q tile
  static constexpr int s_q = 0;
  static constexpr int s_dout = CB * QBLK;
  static constexpr int s_lse = 2 * CB * QBLK;
  static constexpr int s_delta = s_lse + BQ * 4;
  static constexpr int STAGE = ((s_delta + BQ * 4 + 1023) / 1024) * 1024;
  static constexpr int bytes = ring + STAGES * STAGE + 1024;
};

// Start copying [r0, r0+ROWS) of one head's f32 row vector; zero past `n`.
template <int ROWS, int NT>
__device__ __forceinline__ void cp_vec(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    const bool ok = r0 + i < n;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok);
  }
}

template <int D>
__global__ void __launch_bounds__(DqSmem<D>::NTHREADS, DqCfg<D>::MINB)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int BH, int Sq, int Sk, int H, int Hkv,
                    int causal, float qscale, float scale) {
  using S = DqSmem<D>;
  constexpr int BK = DqCfg<D>::BK, DP = DqCfg<D>::DP, BQ = S::BQ, NT = S::NTHREADS,
                CB = S::CB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem + S::q;
  unsigned char* sDO = smem + S::dout;

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

  const size_t qrow = (size_t)b * Sq * H + h;
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
  cp_rows<BQ, D, NT, DP>(sQ, q + qrow * D, q0, Sq, H * D);
  cp_rows<BQ, D, NT, DP>(sDO, dout + qrow * D, q0, Sq, H * D);
  issue_kv(0);
  cp_async_commit();

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const size_t at = ((size_t)b * H + h) * Sq + (row < Sq ? row : 0);
    row_lse[i] = lse[at];
    row_delta[i] = delta[at];
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const unsigned char* sQw = sQ + wg * 64 * 128;
  const unsigned char* sDOw = sDO + wg * 64 * 128;

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every warpgroup is done with tile t - 2, whose
    // stage takes tile t + 1: its copy runs while tile t's products do
    cp_async_wait_all();
    if (t == 0) {
      __syncthreads();
      scale_tile<CB * S::QBLK, NT>(sQ, qscale);
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

    // S = qs.K^T and dP = dO.V^T for this warpgroup's 64 rows, D/16
    // k-steps (the padding columns are never read; the wait also retires
    // the previous tile's dq product)
    float s[BK / 2], dp[BK / 2];
    wg_fence();
    ss_product<D, BK, S::QBLK, S::KBLK>(s, sQw, sK);
    ss_product<D, BK, S::QBLK, S::KBLK>(dp, sDOw, sV);
    wg_commit();
    wg_wait_all();

    // p and ds in registers; the mask only where the tile crosses the
    // diagonal or the end of the keys
    const bool masked = (causal && k0 + BK - 1 > q0 + offset) || k0 + BK > Sk;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + cq + (e % 2);
        const int row = row0 + (e / 2) * 8;
        float p = fast_exp2(s[4 * n + e] - row_lse[e / 2]);
        if (masked && (col >= Sk || (causal && col > row + offset))) p = 0.f;
        s[4 * n + e] = p * (dp[4 * n + e] - row_delta[e / 2]);  // ds
      }

    // dq += ds.K, K read MN-major; waited at the next tile
    uint32_t ds[BK / 16][4];
    pack_rows<BK>(ds, s);
    wg_fence();
    rs_product<DP, BK, S::KBLK>(acc, ds, sK);
    wg_commit();
  }
  wg_wait_all();

  // dq = scale * acc over the D real columns, written once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= Sq) continue;
    bf16* orow = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + cq) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(DkvSmem<D>::NTHREADS, DkvCfg<D>::MINB)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int BHkv, int Sq, int Sk,
                     int H, int Hkv, int causal, float qscale) {
  using S = DkvSmem<D>;
  constexpr int BQ = S::BQ, BKV = S::BKV, NT = S::NTHREADS, CB = S::CB, DP = DkvCfg<D>::DP,
                CS = DkvCfg<D>::CS, DW = S::DW;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);

  // longest first: the first KV tile sees every q tile when causal
  const int bh = blockIdx.x % BHkv;
  const int k0 = (int)(blockIdx.x / BHkv) * BKV;
  const int hk = bh % Hkv, b = bh / Hkv;
  const int n_rep = H / Hkv;
  const int offset = Sk - Sq;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  // this warpgroup's 64 keys (of the block's BKV) and its DW columns of dk
  // and dv (of DP)
  const int kgrp = wg / CS, part = wg % CS;
  const int cq = (lane % 4) * 2;
  // this thread's keys: key0 and key0 + 8
  const int key0 = k0 + kgrp * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;

  // the first q tile with a row that sees key k0 (`lo` of the TPU kernel)
  int lo = 0;
  if (causal && k0 - offset > 0) lo = (k0 - offset) / BQ;
  const int per_head = (Sq + BQ - 1) / BQ - lo;
  const int n_steps = n_rep * per_head;  // (query head, q tile) steps, heads in order

  auto stage = [&](int it) { return smem + S::ring + (it % STAGES) * S::STAGE; };
  auto issue = [&](int it) {
    const int h = hk * n_rep + it / per_head;
    const int q0 = (lo + it % per_head) * BQ;
    unsigned char* st = stage(it);
    const size_t qrow = (size_t)b * Sq * H + h;
    cp_rows<BQ, D, NT, DP>(st + S::s_q, q + qrow * D, q0, Sq, H * D);
    cp_rows<BQ, D, NT, DP>(st + S::s_dout, dout + qrow * D, q0, Sq, H * D);
    cp_vec<BQ, NT>(reinterpret_cast<float*>(st + S::s_lse), lse + ((size_t)b * H + h) * Sq, q0,
                   Sq);
    cp_vec<BQ, NT>(reinterpret_cast<float*>(st + S::s_delta), delta + ((size_t)b * H + h) * Sq,
                   q0, Sq);
  };
  const size_t kvrow = (size_t)b * Sk * Hkv + hk;
  cp_rows<BKV, D, NT, DP>(smem + S::k, k + kvrow * D, k0, Sk, Hkv * D);
  cp_rows<BKV, D, NT, DP>(smem + S::v, v + kvrow * D, k0, Sk, Hkv * D);
  if (n_steps > 0) issue(0);
  cp_async_commit();

  float dk_acc[DW / 2], dv_acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const unsigned char* sKw = smem + S::k + kgrp * 64 * 128;
  const unsigned char* sVw = smem + S::v + kgrp * 64 * 128;
  const int cols = part * (DW / 64) * S::QBLK;  // this warpgroup's column blocks of qs, dO

  for (int it = 0; it < n_steps; ++it) {
    // step it has landed, and every warpgroup is done with step it - 2,
    // whose stage takes step it + 1: its copy runs while step it's products do
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_steps) {
      issue(it + 1);
      cp_async_commit();
    }
    unsigned char* st = stage(it);
    const float* sLse = reinterpret_cast<const float*>(st + S::s_lse);
    const float* sDelta = reinterpret_cast<const float*>(st + S::s_delta);
    scale_tile<CB * S::QBLK, NT>(st + S::s_q, qscale);
    fence_async_smem();
    __syncthreads();
    const int q0 = (lo + it % per_head) * BQ;

    // S^T = K.qs^T and dP^T = V.dO^T for this warpgroup's 64 keys over the
    // D real columns, whole on each warpgroup of a column split (the wait
    // also retires the previous step's dV and dK products)
    float s[BQ / 2], dp[BQ / 2];
    wg_fence();
    ss_product<D, BQ, S::KBLK, S::QBLK>(s, sKw, st + S::s_q);
    ss_product<D, BQ, S::KBLK, S::QBLK>(dp, sVw, st + S::s_dout);
    wg_commit();
    wg_wait_all();

    // p^T and ds^T in registers; the mask only where the tile crosses the
    // diagonal or the end of the keys or queries
    const bool masked = (causal && k0 + BKV - 1 > q0 + offset) || k0 + BKV > Sk ||
                        q0 + BQ > Sq;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(sLse + n * 8 + cq);
      const float2 d2 = *reinterpret_cast<const float2*>(sDelta + n * 8 + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + n * 8 + cq + (e % 2);
        const int kj = key0 + (e / 2) * 8;
        float p = fast_exp2(s[4 * n + e] - (e % 2 ? l2.y : l2.x));
        if (masked && (kj >= Sk || qi >= Sq || (causal && kj > qi + offset))) p = 0.f;
        s[4 * n + e] = p;
        dp[4 * n + e] = p * (dp[4 * n + e] - (e % 2 ? d2.y : d2.x));  // ds
      }
    }

    // dV += p^T.dO and dK += ds^T.qs on this warpgroup's DW columns, dO
    // and qs read MN-major; waited at the next step
    uint32_t pt[BQ / 16][4], dst[BQ / 16][4];
    pack_rows<BQ>(pt, s);
    pack_rows<BQ>(dst, dp);
    wg_fence();
    rs_product<DW, BQ, S::QBLK>(dv_acc, pt, st + S::s_dout + cols);
    rs_product<DW, BQ, S::QBLK>(dk_acc, dst, st + S::s_q + cols);
    wg_commit();
  }
  wg_wait_all();
  cp_async_wait_all();  // K and V when there was no step

  // dk = ln2 * acc, dv = acc, this thread's keys and the real columns of
  // this warpgroup's DW, once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = key0 + i * 8;
    if (kj >= Sk) continue;
    const size_t o = (kvrow + (size_t)kj * Hkv) * D + part * DW;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      if (part * DW + n * 8 >= D) break;
      *reinterpret_cast<__nv_bfloat162*>(dk + o + n * 8 + cq) =
          __floats2bfloat162_rn(dk_acc[4 * n + 2 * i] * LN2, dk_acc[4 * n + 2 * i + 1] * LN2);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + n * 8 + cq) =
          __floats2bfloat162_rn(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
                      int H, int Hkv, int causal, float qscale, float scale,
                      cudaStream_t stream) {
  using S = DqSmem<D>;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, S::bytes, done);
  if (err != cudaSuccess) return err;
  const int n_qt = (Sq + S::BQ - 1) / S::BQ;
  flash_bwd_dq_kernel<D><<<n_qt * B * H, S::NTHREADS, S::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), B * H, Sq, Sk, H, Hkv, causal,
      qscale, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                       int Sk, int H, int Hkv, int causal, float qscale, cudaStream_t stream) {
  using S = DkvSmem<D>;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, S::bytes, done);
  if (err != cudaSuccess) return err;
  const int n_kt = (Sk + S::BKV - 1) / S::BKV;
  flash_bwd_dkv_kernel<D><<<n_kt * B * Hkv, S::NTHREADS, S::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      B * Hkv, Sq, Sk, H, Hkv, causal, qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ds_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, void* dq, int B, int Sq, int Sk,
                                         int H, int Hkv, int D, int causal, float qscale,
                                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal, qscale,
                           scale, s);
    case 80:
      return launch_dq<80>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal, qscale,
                           scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal, qscale,
                            scale, s);
    case 256:
      return launch_dq<256>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, Hkv, causal, qscale,
                            scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ds_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, int B,
                                          int Sq, int Sk, int H, int Hkv, int D, int causal,
                                          float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sk == 0 || Hkv == 0) return cudaSuccess;
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal,
                            qscale, s);
    case 80:
      return launch_dkv<80>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal,
                            qscale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal,
                             qscale, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hkv, causal,
                             qscale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
