// Causal flash-attention backward: dQ (with delta = rowsum(dO * O)), and
// dK/dV summed over each GQA group, recomputing the probabilities tile by
// tile from the forward's per-row log-sum-exp (no [T, S] buffer).
//
// Replaces the Pallas kernels of `_flash_backward` in
// dla_tpu/ops/flash_attention.py:
//   flash_bwd_dq_kernel  <- `_flash_bwd_dq_kernel`  (pallas_call at :398)
//   flash_bwd_dkv_kernel <- `_flash_bwd_dkv_kernel` (pallas_call at :438)
//
// Per (query row q, key column k) both recompute
//   p  = mask ? exp(s * scale - lse[q]) : 0      s = q . k (fp32)
//   dp = dO[q] . v[k]                             (fp32 from bf16 operands)
//   ds = bf16(p * (dp - delta[q]))                delta = rowsum(dO * O)
// and accumulate in fp32
//   dQ = scale * sum_k ds k        dV = sum_q bf16(p) dO
//   dK = scale * sum_q ds q        (q over every head of the GQA group)
// writing each gradient once, in bf16. The mask is the forward's: causal
// on the global index, optional sliding window (q - window, q], optional
// equal segment ids. A fully masked row (lse = -1e30) never reaches the
// exp: the mask is tested first.
//
// What bounds them on an H100: at the SFT shape (B=4, T=2048, H=32, KH=8,
// D=64) dQ does 3 and dK/dV 4 causal T x T x D products — ~100 and ~140
// GFLOP against ~70 MB of operands, far above the ~295 flop/byte bf16
// balance point, so tensor-core operations bound both; at D = 64 the
// exp and mask work per score entry is of the same order as a tile's
// products, so it has to overlap them.
//
// Design (Hopper: wgmma + TMA, see hopper.cuh):
//  - Each output tile is owned by one block, which loops over the tiles
//    it needs, so nothing is summed across blocks: no atomics, and the
//    gradients are bit-identical from run to run.
//  - A block is 3 warpgroups. Warpgroup 0 is the producer: one warp
//    keeps TMA loads of the streamed 64-row tiles in flight through a
//    STAGES-deep ring in shared memory (full / empty mbarriers), with
//    each tile's per-row scalars beside it by cp.async, and gives its
//    registers up (setmaxnreg). Warpgroups 1 and 2 are consumers, 64
//    rows of the block's 128-row tile each; they take the registers and
//    run every product on wgmma, the scores in fp32 accumulators, while
//    the other consumer's products keep the tensor cores busy.
//  - dQ: block = (batch, query head, 128 query rows), heaviest query
//    tiles (most live key tiles under the causal mask) issued first.
//    Q and dO arrive once by TMA; the prologue reads O and dO rows and
//    writes delta ([B, H, T] fp32) for the dK/dV kernel launched after
//    it. K/V tiles and their segment ids stream through the ring.
//    S = Q K^T and dP = dO V^T are wgmmas over K-major tiles; mask, P
//    and dS happen in the accumulators, which become bf16 A fragments in
//    registers for dQ += dS K, K read through a transposed descriptor.
//  - dK/dV: block = (batch, kv head, 128 keys), key tile 0 (the
//    heaviest) first. K and V arrive once; Q and dO tiles of every
//    (group member, live query tile) pair stream through the ring with
//    their lse, delta and segment ids. Each consumer computes
//    S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are already the A
//    fragments of dV += P^T dO and dK += dS^T Q (dO, Q through
//    transposed descriptors): nothing is transposed through shared
//    memory, and the fp32 dK and dV stay in registers until the end.
//  - The score-to-gradient work per entry (mask, exp, dS, bf16 pack) is
//    of the same order as a tile's products at D = 64, so it is kept to
//    a few instructions: the mask is two compares against per-row
//    bounds, and only on tiles that cross an edge or carry segment ids;
//    the exp is one MUFU.EX2.
//  - Head dims 64 and 128 are native; 80 (phi-2) and 96 (phi3-mini) run
//    the 128 kernel through an 80- or 96-column tensor map: the second
//    64-column box starts at column 64 and TMA fills the columns past D
//    with zeros (exact zero products), and stores are masked to col < D.
//    Every map stride is a 16-byte multiple (D * 2 bytes per head).
//  - Tiles above the diagonal or outside the window are skipped (the
//    Pallas `_block_live` rule), per block and per consumer warpgroup;
//    ragged T and S tails read as zeros and are masked.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using dla::bf16;
using dla::Strides;
namespace hp = dla::hopper;

constexpr int BM = 128;       // rows of the block's own tile
constexpr int BN = 64;        // rows of a streamed tile
constexpr int STAGES = 3;     // depth of the ring
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const bf16* out;    // dQ: O and dO rows for delta
  const bf16* dout;
  const float* lse;   // [B, H, T]
  float* delta;       // [B, H, T]: written by dQ, read by dK/dV
  const int* qseg;    // [B, T] or null
  const int* kseg;    // [B, S] or null
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides os, dos, dqs, dks, dvs;
  int H, KH, T, S, D;
  float scale;
  int window;         // 0: none
};

// any unmasked (query, key) pair in rows [q0, q0 + nq) x keys [k0, k0 + nk)
// under the causal and window rules (the Pallas `_block_live`)
__device__ __forceinline__ bool live(int q0, int nq, int k0, int nk,
                                     int window) {
  if (k0 > q0 + nq - 1) return false;
  return window == 0 || q0 - (k0 + nk - 1) < window;
}

// the dynamic shared memory rounded up to 1024 bytes (the swizzle atom),
// by offsetting the array itself so the compiler keeps knowing that
// pointers into it are shared-memory addresses (ld/st.shared)
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024 - (hp::smem_addr(raw) & 1023)) & 1023);
}

__device__ __forceinline__ float exp2_ftz(float x) {  // one MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K-major descriptor of k-step kk of a [ROWS, DP] tile of subtiles, at
// row offset `row0` (a multiple of 8)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  return hp::desc_sw128(tile + (kk / 4) * ROWS * 128 + row0 * 128 +
                            (kk % 4) * 32,
                        16, 1024);
}

// MN-major (transposed) descriptor of k-step kk (rows 16 kk..) of a
// [ROWS, DP] tile of subtiles
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return hp::desc_sw128(tile + kk * 16 * 128, ROWS * 128, 1024);
}

// S and dP of one 64 x 64 score tile: two K-major products over DP,
// issued and waited for
template <int DP, int AROWS, int BROWS>
__device__ __forceinline__ void scores(float (&s)[32], float (&dp)[32],
                                       uint32_t a1, uint32_t b1, uint32_t a2,
                                       uint32_t b2, int arow0) {
  hp::fence_regs(s);
  hp::fence_regs(dp);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    hp::wgmma_ss_n64(s, desc_k<AROWS>(a1, arow0, kk),
                           desc_k<BROWS>(b1, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    hp::wgmma_ss_n64(dp, desc_k<AROWS>(a2, arow0, kk),
                           desc_k<BROWS>(b2, 0, kk), kk > 0);
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(s);
  hp::fence_regs(dp);
}

// issue acc += A B over 64 k-rows: A from register fragments (the bf16
// scores of the thread's rows), B a [BN, DP] ring tile read through the
// transposed descriptor
template <int DP>
__device__ __forceinline__ void issue_acc(float (&acc)[DP / 2],
                                          const uint32_t (&a)[4][4],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (DP == 64)
      hp::wgmma_rs_n64<1>(acc, a[kk], desc_mn<BN>(b, kk), 1);
    else
      hp::wgmma_rs_n128<1>(acc, a[kk], desc_mn<BN>(b, kk), 1);
  }
}

// dS of a dQ score tile as the bf16 A fragments `fr`. Entry (row r
// of the thread, tile column c) is live iff lo[r] <= c < hi[r] (causal,
// window, ragged tails) and, with SEG, the segment ids agree; without
// MASK every entry is live (a tile inside all the edges).
template <bool MASK, bool SEG>
__device__ __forceinline__ void dq_tile(const float (&s)[32],
                                        const float (&dp)[32],
                                        uint32_t (&fr)[4][4], int tig,
                                        const int (&lo)[2],
                                        const int (&hi)[2],
                                        const int (&seg)[2], const int* ks,
                                        const float (&lse2)[2],
                                        const float (&dlt)[2], float scale2) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int c = nb * 8 + tig * 2;
    int2 kseg2 = make_int2(0, 0);
    if (SEG) kseg2 = *reinterpret_cast<const int2*>(ks + c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = nb * 4 + r * 2 + e;
        float p = exp2_ftz(fmaf(s[i], scale2, -lse2[r]));
        if (MASK) {
          bool ok = c + e >= lo[r] && c + e < hi[r];
          if (SEG) ok = ok && seg[r] == (e ? kseg2.y : kseg2.x);
          p = ok ? p : 0.f;
        }
        d2[e] = p * (dp[i] - dlt[r]);
      }
      fr[nb / 2][(nb % 2) * 2 + r] = dla::pack_bf16(d2[0], d2[1]);
    }
  }
}

// P^T and dS^T of a dK/dV score tile (rows: the thread's keys, columns:
// the tile's queries, whose lse, delta and segment ids are in `rs`) as
// the bf16 A fragments `pf`, `dsf`; live entries as in dq_tile
template <bool MASK, bool SEG>
__device__ __forceinline__ void dkv_tile(const float (&s)[32],
                                         const float (&dp)[32],
                                         uint32_t (&pf)[4][4],
                                         uint32_t (&dsf)[4][4], int tig,
                                         const int (&lo)[2],
                                         const int (&hi)[2],
                                         const int (&kseg)[2],
                                         const float* rs, float scale2) {
  constexpr int N = 64;  // queries of the tile
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int c = nb * 8 + tig * 2;
    const float2 l2 = *reinterpret_cast<const float2*>(rs + c);
    const float2 d2 = *reinterpret_cast<const float2*>(rs + N + c);
    int2 sg = make_int2(0, 0);
    if (SEG) sg = *reinterpret_cast<const int2*>(rs + 2 * N + c);
    const float lx[2] = {l2.x * LOG2E, l2.y * LOG2E}, dl[2] = {d2.x, d2.y};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p2[2], ds2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = nb * 4 + r * 2 + e;
        float p = exp2_ftz(fmaf(s[i], scale2, -lx[e]));
        if (MASK) {
          bool ok = c + e >= lo[r] && c + e < hi[r];
          if (SEG) ok = ok && kseg[r] == (e ? sg.y : sg.x);
          p = ok ? p : 0.f;
        }
        p2[e] = p;
        ds2[e] = p * (dp[i] - dl[e]);
      }
      pf[nb / 2][(nb % 2) * 2 + r] = dla::pack_bf16(p2[0], p2[1]);
      dsf[nb / 2][(nb % 2) * 2 + r] = dla::pack_bf16(ds2[0], ds2[1]);
    }
  }
}

// store rows of a [64, DP] fp32 accumulator (rows r0 / r1 of this thread)
// times `mul` as bf16, columns < D
template <int DP>
__device__ __forceinline__ void store_acc(bf16* dst, Strides st, int b,
                                          int h, int r0, int r1, int rows,
                                          int D, const float (&acc)[DP / 2],
                                          float mul, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    if (row >= rows) continue;
    bf16* p = dst + b * st.b + h * st.h + (long long)row * st.t;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = nb * 8 + tig * 2;
      if (col < D)
        *reinterpret_cast<uint32_t*>(&p[col]) = dla::pack_bf16(
            acc[nb * 4 + 2 * r] * mul, acc[nb * 4 + 2 * r + 1] * mul);
    }
  }
}

// ------------------------------------------------------------------- dQ

template <int DP>
struct DqLayout {  // byte offsets from the 1024-aligned base
  static constexpr int TILE = BM * DP * 2;    // Q or dO
  static constexpr int KV = BN * DP * 2;      // K or V
  static constexpr int Q = 0, DO = TILE, RING = 2 * TILE;
  static constexpr int STAGE = 2 * KV;        // K then V
  static constexpr int KSEG = RING + STAGES * STAGE;   // STAGES x BN ints
  static constexpr int DELTA = KSEG + STAGES * BN * 4;  // BM floats
  static constexpr int BAR = DELTA + BM * 4;  // full[S], empty[S], once
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = DqLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base(smem_raw);
  const uint32_t base = hp::smem_addr(smem);
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES,
                 once = empty + 8 * STAGES;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.KH);
  const int n_qt = (a.T + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BM;  // heaviest first
  const int j_end = min((a.S + BN - 1) / BN, (q0 + BM - 1) / BN + 1);
  const int wg = threadIdx.x / 128;
  int* kseg_s = reinterpret_cast<int*>(smem + L::KSEG);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full + 8 * s, 32);     // the producer warp
      hp::mbar_init(empty + 8 * s, 8);     // the consumers' 8 warps
    }
    hp::mbar_init(once, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    hp::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hp::prefetch_map(&tq);
      hp::prefetch_map(&tdo);
      hp::prefetch_map(&tk);
      hp::prefetch_map(&tv);
      hp::mbar_arrive_expect_tx(once, 2 * L::TILE);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        hp::tma_load_4d(base + L::Q + c * BM * 128, &tq, once, c * 64, h, q0,
                        b);
        hp::tma_load_4d(base + L::DO + c * BM * 128, &tdo, once, c * 64, h,
                        q0, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < j_end; ++j) {
      const int k0 = j * BN;
      if (!live(q0, BM, k0, BN, a.window)) continue;
      hp::mbar_wait(empty + 8 * stage, phase ^ 1);
      if (a.qseg != nullptr) {  // the keys' segment ids, by cp.async
        int* ks = kseg_s + stage * BN;
        for (int i = lane; i < BN; i += 32) {
          if (k0 + i < a.S)
            hp::cp_async4(hp::smem_addr(ks + i),
                          a.kseg + (long long)b * a.S + k0 + i);
          else
            ks[i] = -1;
        }
        hp::cp_async_arrive(full + 8 * stage);
      }
      if (lane == 0) {
        const uint32_t st = base + L::RING + stage * L::STAGE;
        hp::mbar_arrive_expect_tx(full + 8 * stage, L::STAGE);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          hp::tma_load_4d(st + c * BN * 128, &tk, full + 8 * stage, c * 64,
                          kh, k0, b);
          hp::tma_load_4d(st + L::KV + c * BN * 128, &tv, full + 8 * stage,
                          c * 64, kh, k0, b);
        }
      } else {
        hp::mbar_arrive(full + 8 * stage);
      }
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  hp::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32, gid = lane / 4, tig = lane % 4;
  const int rw = q0 + cw * 64;  // this warpgroup's first row

  {  // delta = rowsum(dO * O) in fp32: two threads per row
    const int r = ct / 2, half = ct % 2, row = rw + r;
    float acc = 0.f;
    if (row < a.T) {
      const long long ro = b * a.os.b + h * a.os.h + (long long)row * a.os.t;
      const long long rd =
          b * a.dos.b + h * a.dos.h + (long long)row * a.dos.t;
      const int c0 = half * (a.D / 2);
      for (int c = c0; c < c0 + a.D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(a.out + ro + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(a.dout + rd + c);
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 =
            reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 gf = __bfloat1622float2(g2[e]);
          acc = fmaf(of.x, gf.x, acc);
          acc = fmaf(of.y, gf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[cw * 64 + r] = acc;
      if (row < a.T) a.delta[((long long)b * a.H + h) * a.T + row] = acc;
    }
    hp::bar_sync(1 + cw, 128);
  }

  const int row0 = rw + warp * 16 + gid, row1 = row0 + 8;
  float lse2[2], dlt[2];
  int seg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    dlt[r] = delta_s[row - q0];
    lse2[r] = 0.f;
    if (row < a.T) {
      lse2[r] = a.lse[((long long)b * a.H + h) * a.T + row] * LOG2E;
      if (a.qseg != nullptr) seg[r] = a.qseg[(long long)b * a.T + row];
    }
  }
  const float scale2 = a.scale * LOG2E;

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  hp::mbar_wait(once, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < j_end; ++j) {
    const int k0 = j * BN;
    if (!live(q0, BM, k0, BN, a.window)) continue;
    hp::mbar_wait(full + 8 * stage, phase);
    if (live(rw, 64, k0, BN, a.window) && rw < a.T) {
      const uint32_t kt = base + L::RING + stage * L::STAGE;
      float s[32], dp[32];
      scores<DP, BM, BN>(s, dp, base + L::Q, kt, base + L::DO, kt + L::KV,
                         cw * 64);
      // live columns of each row, local to the tile: [lo, hi)
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? row1 : row0;
        hi[r] = row < a.T ? min(row + 1, a.S) - k0 : 0;
        lo[r] = a.window > 0 ? row - a.window + 1 - k0 : 0;
      }
      // the positional mask only where the tile crosses an edge
      const bool edge = k0 + BN - 1 > rw || k0 + BN > a.S || rw + 64 > a.T ||
                        (a.window > 0 && rw + 63 - k0 >= a.window);
      const int* ks = kseg_s + stage * BN;
      uint32_t frag[4][4];
      if (a.qseg != nullptr)
        dq_tile<true, true>(s, dp, frag, tig, lo, hi, seg, ks, lse2, dlt,
                            scale2);
      else if (edge)
        dq_tile<true, false>(s, dp, frag, tig, lo, hi, seg, ks, lse2, dlt,
                             scale2);
      else
        dq_tile<false, false>(s, dp, frag, tig, lo, hi, seg, ks, lse2, dlt,
                              scale2);
      hp::fence_regs(dq);
      hp::fence_regs(frag);
      hp::wgmma_fence();
      issue_acc<DP>(dq, frag, kt);  // dQ += dS K
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(frag);
      hp::fence_regs(dq);
    }
    if (lane == 0) hp::mbar_arrive(empty + 8 * stage);
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }
  store_acc<DP>(a.dq, a.dqs, b, h, row0, row1, a.T, a.D, dq, a.scale, tig);
}

// ---------------------------------------------------------------- dK/dV

template <int DP>
struct DkvLayout {  // byte offsets from the 1024-aligned base
  static constexpr int TILE = BM * DP * 2;    // K or V
  static constexpr int QT = BN * DP * 2;      // a streamed Q or dO tile
  static constexpr int K = 0, V = TILE, RING = 2 * TILE;
  static constexpr int STAGE = 2 * QT;        // Q then dO
  static constexpr int ROWS = RING + STAGES * STAGE;  // STAGES x 3 x BN
  static constexpr int BAR = ROWS + STAGES * 3 * BN * 4;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = DkvLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base(smem_raw);
  const uint32_t base = hp::smem_addr(smem);
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES,
                 once = empty + 8 * STAGES;
  const int b = blockIdx.x / a.KH, kvh = blockIdx.x % a.KH;
  const int k0 = blockIdx.y * BM;  // key tile 0 has the most live q tiles
  const int G = a.H / a.KH;
  const int n_qt = (a.T + BN - 1) / BN;
  const int wg = threadIdx.x / 128;
  // per stage: lse, delta and query segment id of the tile's rows
  float* rows_s = reinterpret_cast<float*>(smem + L::ROWS);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full + 8 * s, 32);
      hp::mbar_init(empty + 8 * s, 8);
    }
    hp::mbar_init(once, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    hp::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hp::prefetch_map(&tq);
      hp::prefetch_map(&tdo);
      hp::prefetch_map(&tk);
      hp::prefetch_map(&tv);
      hp::mbar_arrive_expect_tx(once, 2 * L::TILE);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        hp::tma_load_4d(base + L::K + c * BM * 128, &tk, once, c * 64, kvh,
                        k0, b);
        hp::tma_load_4d(base + L::V + c * BM * 128, &tv, once, c * 64, kvh,
                        k0, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      const long long hrow = ((long long)b * a.H + h) * a.T;
      for (int it = k0 / BN; it < n_qt; ++it) {
        const int q0 = it * BN;
        if (!live(q0, BN, k0, BM, a.window)) break;  // and every later one
        hp::mbar_wait(empty + 8 * stage, phase ^ 1);
        // the rows' lse, delta and segment ids, by cp.async (a load that
        // waited here would cost every tile its latency)
        float* rs = rows_s + stage * 3 * BN;
        int* sg = reinterpret_cast<int*>(rs + 2 * BN);
        for (int i = lane; i < BN; i += 32) {
          const int r = q0 + i;
          if (r < a.T) {
            hp::cp_async4(hp::smem_addr(rs + i), a.lse + hrow + r);
            hp::cp_async4(hp::smem_addr(rs + BN + i), a.delta + hrow + r);
            if (a.qseg != nullptr)
              hp::cp_async4(hp::smem_addr(sg + i),
                            a.qseg + (long long)b * a.T + r);
          } else {
            rs[i] = rs[BN + i] = 0.f;
          }
          if (a.qseg == nullptr || r >= a.T) sg[i] = 0;
        }
        hp::cp_async_arrive(full + 8 * stage);
        if (lane == 0) {
          const uint32_t st = base + L::RING + stage * L::STAGE;
          hp::mbar_arrive_expect_tx(full + 8 * stage, L::STAGE);
#pragma unroll
          for (int c = 0; c < DP / 64; ++c) {
            hp::tma_load_4d(st + c * BN * 128, &tq, full + 8 * stage, c * 64,
                            h, q0, b);
            hp::tma_load_4d(st + L::QT + c * BN * 128, &tdo, full + 8 * stage,
                            c * 64, h, q0, b);
          }
        } else {
          hp::mbar_arrive(full + 8 * stage);
        }
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  hp::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32, gid = lane / 4, tig = lane % 4;
  const int kw = k0 + cw * 64;  // this warpgroup's first key
  const int key0 = kw + warp * 16 + gid, key1 = key0 + 8;
  int kseg[2] = {0, 0};
  if (a.qseg != nullptr) {
    if (key0 < a.S) kseg[0] = a.kseg[(long long)b * a.S + key0];
    if (key1 < a.S) kseg[1] = a.kseg[(long long)b * a.S + key1];
  }
  const float scale2 = a.scale * LOG2E;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  hp::mbar_wait(once, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int g = 0; g < G; ++g) {
    for (int it = k0 / BN; it < n_qt; ++it) {
      const int q0 = it * BN;
      if (!live(q0, BN, k0, BM, a.window)) break;
      hp::mbar_wait(full + 8 * stage, phase);
      if (live(q0, BN, kw, 64, a.window) && kw < a.S) {
        const uint32_t qt = base + L::RING + stage * L::STAGE;
        float s[32], dp[32];  // S^T, dP^T: rows = keys, columns = queries
        scores<DP, BM, BN>(s, dp, base + L::K, qt, base + L::V, qt + L::QT,
                           cw * 64);
        // live queries of each key, local to the tile: [lo, hi)
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = r ? key1 : key0;
          lo[r] = key - q0;
          hi[r] = key < a.S ? (a.window > 0 ? min(a.T, key + a.window) : a.T)
                                  - q0
                            : 0;
        }
        const bool edge = kw + 63 > q0 || q0 + BN > a.T || kw + 64 > a.S ||
                          (a.window > 0 && q0 + BN - 1 - kw >= a.window);
        const float* rs = rows_s + stage * 3 * BN;
        uint32_t pf[4][4], dsf[4][4];
        if (a.qseg != nullptr)
          dkv_tile<true, true>(s, dp, pf, dsf, tig, lo, hi, kseg, rs, scale2);
        else if (edge)
          dkv_tile<true, false>(s, dp, pf, dsf, tig, lo, hi, kseg, rs,
                                scale2);
        else
          dkv_tile<false, false>(s, dp, pf, dsf, tig, lo, hi, kseg, rs,
                                 scale2);
        hp::fence_regs(dv);
        hp::fence_regs(dk);
        hp::fence_regs(pf);
        hp::fence_regs(dsf);
        hp::wgmma_fence();
        issue_acc<DP>(dv, pf, qt + L::QT);  // dV += P^T dO
        issue_acc<DP>(dk, dsf, qt);         // dK += dS^T Q
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(pf);
        hp::fence_regs(dsf);
        hp::fence_regs(dv);
        hp::fence_regs(dk);
      }
      if (lane == 0) hp::mbar_arrive(empty + 8 * stage);
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
  }
  store_acc<DP>(a.dk, a.dks, b, kvh, key0, key1, a.S, a.D, dk, a.scale, tig);
  store_acc<DP>(a.dv, a.dvs, b, kvh, key0, key1, a.S, a.D, dv, 1.f, tig);
}

// ------------------------------------------------------------------ host

inline Strides st_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// the four tile maps of q, dout (rows T, H heads) and k, v (rows S, KH
// heads); `q_rows` / `k_rows` are the TMA box heights
inline int make_maps(CUtensorMap (&m)[4], const void* q, const void* dout,
                     const void* k, const void* v, Strides qs, Strides dos,
                     Strides ks, Strides vs, int B, int H, int KH, int T,
                     int S, int D, int q_rows, int k_rows) {
  int err = hp::make_tile_map(&m[0], q, D, H, T, B, qs.b, qs.h, qs.t, q_rows);
  if (!err)
    err = hp::make_tile_map(&m[1], dout, D, H, T, B, dos.b, dos.h, dos.t,
                            q_rows);
  if (!err)
    err = hp::make_tile_map(&m[2], k, D, KH, S, B, ks.b, ks.h, ks.t, k_rows);
  if (!err)
    err = hp::make_tile_map(&m[3], v, D, KH, S, B, vs.b, vs.h, vs.t, k_rows);
  return err;
}

template <int DP>
int launch_dq(const CUtensorMap (&m)[4], const Args& a, int B,
              cudaStream_t stream) {
  constexpr int smem = DqLayout<DP>::BYTES;
  cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(B * a.H, (a.T + BM - 1) / BM);
  flash_bwd_dq_kernel<DP><<<grid, THREADS, smem, stream>>>(m[0], m[1], m[2],
                                                          m[3], a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const CUtensorMap (&m)[4], const Args& a, int B,
               cudaStream_t stream) {
  constexpr int smem = DkvLayout<DP>::BYTES;
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(B * a.KH, (a.S + BM - 1) / BM);
  flash_bwd_dkv_kernel<DP><<<grid, THREADS, smem, stream>>>(m[0], m[1], m[2],
                                                           m[3], a);
  return (int)cudaGetLastError();
}

// head dims the kernels take: 64 and 128 natively, 80 and 96 through the
// 128 kernel
bool head_dim_ok(int D) { return D == 64 || D == 80 || D == 96 || D == 128; }

}  // namespace

// dQ and delta = rowsum(dout * out) ([B, H, T] fp32, for the dK/dV
// kernel). strides: 18 element strides (b, head, row) of q, k, v, out,
// dout, dq. Returns a cudaError_t, or hopper::kMapError + a CUresult when
// a tensor map cannot be encoded.
extern "C" int dla_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* out, const void* dout,
                                const void* lse, const void* qseg,
                                const void* kseg, void* dq, void* delta,
                                int B, int H, int KH, int T, int S, int D,
                                const long long* strides, float scale,
                                int window, void* stream) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.out = static_cast<const bf16*>(out);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.dq = static_cast<bf16*>(dq);
  a.os = st_at(strides, 3);
  a.dos = st_at(strides, 4);
  a.dqs = st_at(strides, 5);
  a.H = H, a.KH = KH, a.T = T, a.S = S, a.D = D;
  a.scale = scale, a.window = window;
  CUtensorMap m[4];
  const int err = make_maps(m, q, dout, k, v, st_at(strides, 0), a.dos,
                            st_at(strides, 1), st_at(strides, 2), B, H, KH,
                            T, S, D, BM, BN);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dq<64>(m, a, B, s) : launch_dq<128>(m, a, B, s);
}

// dK, dV summed over each GQA group, from the dQ kernel's delta.
// strides: 18 element strides (b, head, row) of q, k, v, dout, dk, dv.
extern "C" int dla_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* qseg,
                                 const void* kseg, void* dk, void* dv, int B,
                                 int H, int KH, int T, int S, int D,
                                 const long long* strides, float scale,
                                 int window, void* stream) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.lse = static_cast<const float*>(lse);
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dks = st_at(strides, 4);
  a.dvs = st_at(strides, 5);
  a.H = H, a.KH = KH, a.T = T, a.S = S, a.D = D;
  a.scale = scale, a.window = window;
  CUtensorMap m[4];
  const int err = make_maps(m, q, dout, k, v, st_at(strides, 0),
                            st_at(strides, 3), st_at(strides, 1),
                            st_at(strides, 2), B, H, KH, T, S, D, BN, BM);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dkv<64>(m, a, B, s) : launch_dkv<128>(m, a, B, s);
}

// dynamic shared memory per block of the dQ (dkv = 0) or dK/dV (dkv = 1)
// kernel at head dim D
extern "C" int dla_flash_bwd_smem_bytes(int dkv, int D) {
  if (!head_dim_ok(D)) return -1;
  if (dkv) return D == 64 ? DkvLayout<64>::BYTES : DkvLayout<128>::BYTES;
  return D == 64 ? DqLayout<64>::BYTES : DqLayout<128>::BYTES;
}

// the first status of a failed tensor-map encode (hopper::kMapError): a
// launch function returns it plus the encode's CUresult
extern "C" int dla_map_error_base() { return hp::kMapError; }
