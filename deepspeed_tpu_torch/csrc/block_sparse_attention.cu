// Block-sparse attention forward for Hopper (sm_90a), bf16 in, f32
// accumulation.
//
// Replaces the TPU kernel `deepspeed_tpu/ops/pallas/block_sparse_attention.py`
// `block_sparse_attention` (:110, its `pallas_call` at :147, body
// `_bs_kernel` :53). It computes what that kernel computes:
//   * q/k/v (B,S,H,D) bf16 and a block layout given as its padded indices:
//     idx (H, S/blk, Kmax) int32, the live KV blocks of each (head, query
//     block) in ascending order, and nlive (H, S/blk) int32 their counts
//     (`padded_layout_indices`) -> out (B,S,H,D) bf16;
//   * q is pre-scaled in bf16 by the scale rounded to bf16 (:123-124), and
//     the online softmax runs in f32 over exactly the live KV blocks of each
//     query block, p = exp(s - m) taken as exp2((s - m) * log2(e)) on the f32
//     logits; entries kk >= nlive are never read;
//   * causal: blocks above the diagonal contribute nothing and the diagonal
//     block is masked inside (key j seen by query i when j <= i);
//   * p is rounded to bf16 before P.V, the running sum l takes the f32 p,
//     and a row that sees no key outputs zeros (`_finalize` :103-107).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 at the full 700 W): the
// work is 4*blk^2*D operations per live (query block, key block) pair,
// against reading q, the live K and V blocks once each and writing out.
// `chip_smoke.py`'s SPARSE_SHAPES, from `chip_smoke.check_sparse` on an
// NVIDIA H100 80GB HBM3 at a 700.00 W power limit:
//   (a) B=1 S=4096 H=8 D=128 block 64, causal BigBird, ~3.4 live blocks a
//       query block: 0.0100 ms (bytes);
//   (b) S=16384 H=32, the same layout: 0.160 ms (bytes);
//   (c) S=4096 H=8, Fixed, not causal, Kmax 19: 0.0206 ms (operations);
//   (d) B=2 S=1024 H=4 D=64 block 32, causal, a fully masked row: 0.0012 ms
//       (bytes);
//   (e) B=1 S=8192 H=16 D=128 block 128, BSLongformer (block 0 global), not
//       causal, 4.9 live blocks a query block, one of 64 a head: 0.0426 ms
//       (operations; 0.0401 by bytes).
// With few live blocks a query block, the bytes bound it and a tile's fixed
// costs (its Q load, the ring's fill, the store of O) are most of its time.
//
// Design: K1's machinery (`flash_attention_fwd.cu`) behind an index list.
//   * A tile is 64 query rows a warpgroup: one query block at block 64 (one
//     warpgroup), one at block 128 (two warpgroups in one block, so each
//     live K/V slab is read once for all 128 rows), two adjacent query
//     blocks 2j and 2j+1 at block 32 (one warpgroup, `QPT` = 2; see below).
//   * Products on wgmma with f32 accumulators in registers: S = qs.K^T with
//     both operands K-major in shared memory (m64 n-blk), O += P.V with P,
//     S's accumulator rounded to bf16, as the register A operand and V read
//     MN-major (m64 nD). The row max and sum come from the quad that shares
//     a row; O is rescaled in place.
//   * Live blocks arrive by TMA. Each is one contiguous slab of blk rows
//     H*D apart, so it is one box per 64 columns of a 3D tensor map over
//     (H*D, S, B) at (h*D + 64c, kb*blk, b), landing in wgmma's 128-byte
//     swizzle. Q arrives the same way, on step 0's barrier, and is scaled in
//     place (`scale_tile`). The 3D map clips at S, so a tile that runs past
//     the sequence (block 32, an odd number of query blocks) loads zeros
//     there and stores nothing there.
//   * A ring of ST stages, one mbarrier a stage. One thread walks the
//     tile's live lists and issues each step's copies; the step's key block
//     and its halves go into the stage's slot of `meta` before the
//     barrier's arrival, so the other threads read the lists only from
//     there. Thread 0 issues steps 0..ST-1; at step t, once a warpgroup has
//     waited for S(t) (and so for its P.V(t-1)), its leader counts itself
//     done with step t-1's stage, and the last warpgroup to do so issues
//     step t-1+ST there: two steps' copies are in flight under the products
//     of step t, and the warpgroups of a block never meet inside the walk.
//     The walk's state lives in shared memory for that reason. The step
//     past the last carries END.
//   * Block 32: the tile walks the merged ascending union of both query
//     blocks' lists, 32 keys a step (m64n32), and each half (two warps)
//     masks the steps that are not in its own list whole (p = 0, alpha =
//     1; a select, not a branch, which made ptxas serialise the products,
//     C7513). At (d) that computes ~1.6x the live pairs, in one code path
//     with the other blocks; mma.sync was not taken, since this design met
//     (d)'s floor (0.027-0.029 ms against the parent's 0.120 and masked
//     SDPA's 0.096-0.117, event ms, `chip_ab.py sparse`, PERF.md).
//   * Causal: each list ends at its first entry above its own query block
//     (the lists are ascending), and the mask is evaluated only on the
//     diagonal block. A row with no visible key so far takes 0 as its
//     reference max, so its masked columns give p = 0 and it ends at
//     exactly 0.
//   * Tiles run longest first: `order` (H * tiles a head, from
//     `tile_order`, cached with the layout) lists them by live blocks,
//     most first, and block x takes tile order[x / B] of batch x % B; no
//     order is the identity. Each tile walks its blocks in ascending order
//     in one thread block (no split, no atomics): the output's bits repeat.
//   * O / l goes into the Q tile's shared memory (a warpgroup's own rows)
//     and out by one TMA store.
//   * Shared memory at block <= 64 stays within 113 KB, so two blocks fit
//     an SM (the alignment slack is cut to 896 bytes for it); the opt-in is
//     set once per device.
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a), registers a thread, no spills;
// dynamic shared memory a block (blocks an SM by it):
//   block 32: D 64 92, 41,940 B (5); D 128 120, 82,900 B (2)
//   block 64: D 64 114, 58,308 B (3); D 128 148, 115,652 B (2)
//   block 128 (256 threads): D 64 157, 115,652 B (1 by registers); D 128
//   216, 230,340 B (1)
// What holds it (`chip_ab.py sparse`, PERF.md, H100 80GB HBM3 at
// 700.00 W; device ms): (a) 0.0215, 2.1x its bound, and (d) 0.024: a
// tile's fill (Q and its first slabs, one DRAM or L2 round trip) and its
// store are most of a 3-step tile, and below ~0.03 ms the wrapper's host
// path (~20 us a call) sets the event time; (b) 0.32-0.35, 2.1x: bytes,
// with K/V slabs read again by neighbouring tiles that run apart; (c)
// 0.062, 33% of the bf16 peak, and (e) 0.136, 3.2x: the softmax runs on
// the warpgroup that issues the products, so a step is S, then softmax,
// then P.V in series (~2.1 us a 128 x 128 step at (e), ~53% of an SM's
// rate), and (e)'s 64-step row is its critical path. Probes that lost:
// warpgroups taking turns to issue S (named barriers; no change), and
// P.V(t-1) issued behind S(t) so the softmax runs under it (slower on
// every row). Warp specialisation with a producer warp and register
// reallocation, so that two S accumulators fit, is the next step.

#include <limits.h>

#include "flash_attention_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int END = -1;            // meta: the step past a tile's last live block
constexpr int KB_BITS = 24;        // meta: key block in the low bits, halves above

// The tile of a block size and head width: NWG warpgroups of 64 query rows,
// QPT query blocks, ST stages of (K, V) slabs. Shared memory: Q (the output
// at the end), the ring, the stages' mbarriers, meta slots and counts, and
// the walk's state.
template <int BLK, int D>
struct Cfg {
  static constexpr int NWG = BLK == 128 ? 2 : 1;
  static constexpr int NT = NWG * 128;
  static constexpr int BQ = NWG * 64;              // query rows a tile
  static constexpr int QPT = BQ / BLK;             // query blocks a tile
  static constexpr int MINB = NWG == 1 ? 2 : 1;    // blocks an SM should hold
  static constexpr int ST = BLK == 32 ? 4 : 3;
  static constexpr int CB = D / 64;                // column blocks
  static constexpr int QBLK = BQ * 128;            // one column block of Q
  static constexpr int KBLK = BLK * 128;           // one column block of a K or V slab
  static constexpr int TILE = CB * KBLK;           // a K or V slab
  static constexpr int q = 0;
  static constexpr int kv = CB * QBLK;             // stage s: K at kv + 2*s*TILE, V after it
  static constexpr int bars = kv + ST * 2 * TILE;
  static constexpr int meta = bars + ST * 8;       // a stage's step
  static constexpr int count = meta + ST * 4;      // warpgroups done with a stage
  static constexpr int walk = count + ST * 4;      // the walk's state
  static constexpr int SLACK = 896;                // for the 1024-byte alignment of Q
  static constexpr int bytes = walk + 5 * 4 + SLACK;
  static_assert(kv % 1024 == 0 && KBLK % 1024 == 0, "swizzled tiles");
};

template <int BLK, int D>
__global__ void __launch_bounds__(Cfg<BLK, D>::NT, Cfg<BLK, D>::MINB)
block_sparse_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, const int* __restrict__ idx,
                    const int* __restrict__ nlive, const int* __restrict__ order, int B, int n,
                    int kmax, int causal, float qscale) {
  using L = Cfg<BLK, D>;
  constexpr int NT = L::NT, CB = L::CB, ST = L::ST;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  if (smem - smem_raw > L::SLACK) __trap();  // a dynamic base below 128-byte alignment
  unsigned char* sQ = smem + L::q;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  int* meta = reinterpret_cast<int*>(smem + L::meta);
  int* count = reinterpret_cast<int*>(smem + L::count);
  // ia, ib: the next entries of the two lists; na, nb: their live counts
  volatile int* walk = reinterpret_cast<int*>(smem + L::walk);
  enum { IA, IB, NA, NB, ENDED };

  const int ntiles = (n + L::QPT - 1) / L::QPT;
  const int b = blockIdx.x % B;
  const int tile = order ? __ldg(order + blockIdx.x / B) : blockIdx.x / B;
  const int h = tile / ntiles;
  const int qa = (tile % ntiles) * L::QPT;  // the tile's first query block
  const int q0 = qa * BLK;                  // and first query row
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int cq = (lane % 4) * 2;
  // this thread's rows of the tile: r_first and r_first + 8, both in its
  // half (the query block qa + half)
  const int r_first = wg * 64 + ((tid / 32) % 4) * 16 + lane / 4;
  const int half = r_first / BLK;

  // The walk: the merged ascending union of the tile's lists (one list
  // unless QPT = 2 and block qa + 1 exists), each cut at its own query
  // block when causal. A step is its key block and the halves whose list
  // holds it. Thread 0 issues the prologue, then each step's issue falls
  // to the leader of the last warpgroup done with the stage it takes.
  const int* la = idx + ((size_t)h * n + qa) * kmax;
  const int* lb = la + kmax;
  auto next = [&]() -> int {
    const int ia = walk[IA], ib = walk[IB];
    int ka = ia < walk[NA] ? __ldg(la + ia) : INT_MAX;
    int kb = ib < walk[NB] ? __ldg(lb + ib) : INT_MAX;
    if (causal) {
      if (ka > qa) ka = INT_MAX;
      if (kb > qa + 1) kb = INT_MAX;
    }
    const int k = min(ka, kb);
    if (k == INT_MAX) return END;
    walk[IA] = ia + (ka == k);
    walk[IB] = ib + (kb == k);
    return k | (ka == k ? 1 << KB_BITS : 0) | (kb == k ? 2 << KB_BITS : 0);
  };
  // step `step`'s copies into its stage (Q too at step 0), or its END
  auto issue = [&](int step) {
    if (walk[ENDED]) return;
    const int s = step % ST;
    const int m = next();
    meta[s] = m;
    if (m == END) {
      mbar_arrive(full + s);
      walk[ENDED] = 1;
      return;
    }
    const int kb = m & ((1 << KB_BITS) - 1);
    unsigned char* sK = smem + L::kv + s * 2 * L::TILE;
    mbar_expect(full + s, 2 * L::TILE + (step == 0 ? CB * L::QBLK : 0));
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const int col = h * D + 64 * c;
      if (step == 0) tma_load_3d(sQ + c * L::QBLK, &qmap, col, q0, b, full + s);
      tma_load_3d(sK + c * L::KBLK, &kmap, col, kb * BLK, b, full + s);
      tma_load_3d(sK + L::TILE + c * L::KBLK, &vmap, col, kb * BLK, b, full + s);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 1);
      count[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    walk[IA] = 0;
    walk[IB] = 0;
    walk[ENDED] = 0;
    walk[NA] = __ldg(nlive + (size_t)h * n + qa);
    walk[NB] = L::QPT == 2 && qa + 1 < n ? __ldg(nlive + (size_t)h * n + qa + 1) : 0;
  }
  __syncthreads();
  if (tid == 0)
    for (int step = 0; step < ST; ++step) issue(step);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  // P, the register A operand of P.V: its registers stay P's until the
  // product that reads them is waited on, one step later
  uint32_t p[BLK / 16][4];

  for (int t = 0;; ++t) {
    const int s = t % ST;
    mbar_wait(full + s, (t / ST) & 1);
    const int m = meta[s];
    if (m == END) break;
    if (t == 0) {  // qs, once, in place
      scale_tile<CB * L::QBLK, NT>(sQ, qscale);
      fence_async_smem();
      __syncthreads();
    }
    const int kb = m & ((1 << KB_BITS) - 1);
    const bool mine = L::QPT == 1 || ((m >> (KB_BITS + half)) & 1);
    const unsigned char* sK = smem + L::kv + s * 2 * L::TILE;
    const unsigned char* sV = sK + L::TILE;

    // S = qs . K^T for this warpgroup's 64 rows
    float sc[BLK / 2];
    fence_acc(sc);
    wg_fence();
    ss_product<D, BLK, L::QBLK, L::KBLK>(sc, sQ + wg * 64 * 128, sK);
    wg_commit();
    fence_acc(sc);
    wg_wait_all();  // S(t), and P.V(t - 1): its stage is free in this warpgroup
    fence_acc(sc);
    fence_acc(o);
    fence_regs(p);
    // the last warpgroup done with it issues step t - 1 + ST there (the
    // warpgroups need not meet: one's softmax may run under the other's
    // products)
    if (t > 0 && tid % 128 == 0) {
      __threadfence_block();
      if (atomicAdd(count + (t - 1) % ST, 1) == L::NWG - 1) {
        __threadfence_block();
        count[(t - 1) % ST] = 0;
        issue(t - 1 + ST);
      }
    }

    // the mask: a key block of the other half's list only (all of it: p =
    // 0, alpha = 1), or the diagonal block
    if constexpr (L::QPT == 2) {
#pragma unroll
      for (int i = 0; i < BLK / 2; ++i) sc[i] = mine ? sc[i] : NEG_INF;
    }
    if (causal && kb == qa + half) {
#pragma unroll
      for (int nn = 0; nn < BLK / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nn * 8 + cq + (e % 2) > r_first + (e / 2) * 8 - half * BLK)
            sc[4 * nn + e] = NEG_INF;
    }
    // online softmax in registers; a row's four threads agree
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nn = 0; nn < BLK / 8; ++nn) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * nn], sc[4 * nn + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * nn + 2], sc[4 * nn + 3]));
    }
    float nref[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      const float ref = mx[i] == NEG_INF ? 0.f : mx[i];  // no visible key yet: p = 0
      alpha[i] = fast_exp2((m_run[i] - ref) * LOG2E);
      nref[i] = -ref * LOG2E;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nn = 0; nn < BLK / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * nn + e] = fast_exp2(fmaf(sc[4 * nn + e], LOG2E, nref[e / 2]));
        sum[e / 2] += sc[4 * nn + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // this thread's columns only; the quad sums at the end
      l_run[i] = l_run[i] * alpha[i] + sum[i];
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      o[4 * nn] *= alpha[0];
      o[4 * nn + 1] *= alpha[0];
      o[4 * nn + 2] *= alpha[1];
      o[4 * nn + 3] *= alpha[1];
    }
    pack_rows<BLK>(p, sc);

    // O += P . V: P rounded to bf16 is the A operand; V is read MN-major
    fence_regs(p);
    fence_acc(o);
    wg_fence();
    rs_product<D, BLK, L::KBLK>(o, p, sV);
    wg_commit();
    fence_acc(o);
  }
  wg_wait_all();
  fence_acc(o);
  fence_regs(p);

  // out = O / l, bf16, into this warpgroup's rows of the Q tile (its own S
  // products are done), then one TMA store of the tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const float safe_l = (l == 0.f) ? 1.f : l;
    const int r = r_first + 8 * i;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
      *reinterpret_cast<uint32_t*>(sQ + (nn / 8) * L::QBLK + r * 128 +
                                   (((nn % 8) ^ (r % 8)) << 4) + cq * 2) =
          pack_bf16(o[4 * nn + 2 * i] / safe_l, o[4 * nn + 2 * i + 1] / safe_l);
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < CB; ++c) tma_store_3d(&omap, sQ + c * L::QBLK, h * D + 64 * c, q0, b);
    tma_store_drain();
  }
}

// (H*D, S, B) bf16 in boxes of 64 columns (the 128-byte swizzle's width)
// by `rows`. A geometry is encoded once and kept (a few µs a call on the
// host, which bounds the small shapes); each call's map is a kept one with
// its tensor's address.
cudaError_t bshd_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, int rows) {
  struct Kept {
    int B, S, H, D, rows;
    CUtensorMap map;
  };
  constexpr int KEEP = 16;
  static Kept kept[KEEP];
  static int used = 0, oldest = 0;
  for (int i = 0; i < used; ++i) {
    const Kept& k = kept[i];
    if (k.B == B && k.S == S && k.H == H && k.D == D && k.rows == rows) {
      *map = k.map;
      return tensor_map_address(map, base);
    }
  }
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cudaError_t err = tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims,
                                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if (used < KEEP) {
    kept[used++] = Kept{B, S, H, D, rows, *map};
  } else {
    kept[oldest] = Kept{B, S, H, D, rows, *map};
    oldest = (oldest + 1) % KEEP;
  }
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *idx, *nlive, *order;
  void* out;
  int B, S, H, kmax, causal;
  float qscale;
};

template <int BLK, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Cfg<BLK, D>;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(block_sparse_kernel<BLK, D>, L::bytes, done);
  CUtensorMap qm, km, vm, om;
  if (err == cudaSuccess) err = bshd_map(&qm, a.q, a.B, a.S, a.H, D, L::BQ);
  if (err == cudaSuccess) err = bshd_map(&km, a.k, a.B, a.S, a.H, D, BLK);
  if (err == cudaSuccess) err = bshd_map(&vm, a.v, a.B, a.S, a.H, D, BLK);
  if (err == cudaSuccess) err = bshd_map(&om, a.out, a.B, a.S, a.H, D, L::BQ);
  if (err != cudaSuccess) return err;
  const int n = a.S / BLK;
  const long long blocks = (long long)a.H * ((n + L::QPT - 1) / L::QPT) * a.B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  block_sparse_kernel<BLK, D><<<(int)blocks, L::NT, L::bytes, stream>>>(
      qm, km, vm, om, static_cast<const int*>(a.idx), static_cast<const int*>(a.nlive),
      static_cast<const int*>(a.order), a.B, n, a.kmax, a.causal, a.qscale);
  return cudaGetLastError();
}

template <int BLK>
cudaError_t launch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 64: return launch<BLK, 64>(a, s);
    case 128: return launch<BLK, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// order == nullptr: tiles in their natural order; else H * tiles a head
// int32 tile numbers (`tile_order`). q, k, v and out 16-byte aligned.
extern "C" int ds_block_sparse_attention(const void* q, const void* k, const void* v,
                                         const void* idx, const void* nlive, const void* order,
                                         void* out, int B, int S, int H, int D, int blk,
                                         int kmax, int causal, float qscale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (B < 0 || S < 0 || H < 0 || S % blk != 0 || kmax < 1 || S / blk >= (1 << KB_BITS))
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  const Args a{q, k, v, idx, nlive, order, out, B, S, H, kmax, causal, qscale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (blk) {
    case 32: return launch_d<32>(D, a, s);
    case 64: return launch_d<64>(D, a, s);
    case 128: return launch_d<128>(D, a, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
