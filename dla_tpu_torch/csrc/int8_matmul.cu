// int8 weight-only matmul: out[M, N] = bf16((bf16(x) @ bf16(w)) * scale[n]).
//
// Replaces the Pallas kernel `_kernel` / `_int8_matmul_2d` in
// dla_tpu/ops/quant_matmul.py (pallas_call at :86).
//
// What bounds it on an H100: at decode (M = batch = 64) every weight byte
// is used by only 64 rows, ~128 operations per byte — far below the ~590
// int8-byte/bf16-flop balance point, so the int8 weight bytes read from
// HBM bound it (3.35 TB/s). At prefill (M = 8192) it is bound by tensor
// core operations.
//
// Two kernels; the wrapper (ops/quant_matmul.py `plan`) picks one from
// (M, N, K):
//
// int8_mm_tma_kernel (M > 64: prefill). Hopper design (hopper.cuh):
//  - One block per 128 x 256 output tile, output tiles walked in groups
//    of 8 M tiles so that the blocks on the card at one time share their
//    x and w tiles in L2.
//  - 3 warpgroups. A producer warp keeps a 6-stage ring of {x tile
//    [128, 64] bf16; w tile [64, 256] int8 as two boxes of 128 columns}, both
//    128-byte swizzled, full by TMA (x and w rows are 16-byte multiples:
//    the wrapper's K % 8 and N % 16 checks), full / empty mbarriers.
//    Ragged M, N and K read as zeros.
//  - The product is computed transposed, out^T = w^T x^T, so that w is
//    the wgmma's register operand: each consumer warpgroup owns 128
//    output columns and converts only its own w columns, straight into
//    bf16 A fragments — no converted tile in shared memory, no barrier
//    between the warpgroups. A transposed ldmatrix of 16-bit pairs gives
//    each thread the k pairs of two neighbouring columns; the conversion
//    is exact (|w| <= 127; the magic-number route, 2^23 + byte as an
//    fp32 bit pattern, minus 2^23 + 128, upper half taken). B is the x
//    tile, K-major: RS wgmma m64n128k16. A consumer converts the next
//    stage's fragments while its products of this stage run.
//  - fp32 accumulators; the epilogue multiplies by scale[n] and rounds
//    once to bf16 — the casts of int8_matmul_plain. No atomics: one
//    thread owns each output and sums K in a fixed order.
//
// int8_mm_decode_kernel (M <= 64, decode). The rollout's decode step
// calls it 225 times at M = 64, where each weight byte meets 64 rows
// (~128 operations a byte): the int8 weight bytes bound it. Design:
//  - The product is computed transposed as in the TMA kernel: out^T =
//    w^T x^T, w^T the RS wgmma's register operand (converted exactly
//    from int8 by the same byte-permute route), the batch (M <= 64) the
//    wgmma's N, x the K-major B tile. 64 < M < 128 takes the TMA kernel,
//    which reads the rows past M as zeros.
//  - A block owns 64 * CW output columns: CW consumer warpgroups of 64
//    columns each and one producer warp, which keeps a 6-stage TMA ring
//    of {x tile [64, 64] bf16, 128-byte swizzled; CW w boxes [64 k, 64
//    n] int8, 64-byte swizzled} full. Each consumer converts the next
//    stage's w fragments while this stage's products run.
//  - When the output tiles alone cannot fill the card (every projection
//    but lm_head), K is split across the blocks of a thread-block
//    cluster (grid y = cluster y = splits, each block a contiguous run of
//    64-deep K tiles). After the loop each block parks its fp32 partial
//    tile in its own shared memory, and each block of the cluster sums
//    one slice of the tile over the cluster's blocks in rank order,
//    through distributed shared memory, then scales and rounds once. One
//    launch, no partial tile in HBM, no second kernel, no atomics, and
//    the sum's order is fixed.
//  - The wrapper's planner picks the columns per block (128, or 64 with
//    clusters of up to 16 for narrow N) and the splits so that every
//    call of the step puts a block on every SM, splitting K at most 4
//    ways at 128 columns (each doubling of the cluster costs its
//    reduction more than the wider block saves).
//  - Launched with programmatic stream serialization: a block requests
//    its first stages' weights (which no kernel writes) before waiting
//    for the previous kernel of the stream, so the step's back-to-back
//    projections overlap one's tail with the next one's first loads.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using dla::bf16;

// ------------------------------------------------------- int8_mm_tma_kernel

namespace hp = dla::hopper;

constexpr int TBM = 128;      // output rows (x rows) of a block
constexpr int TBK = 64;       // K depth of a ring stage
constexpr int TTHREADS = 384; // producer warpgroup + 2 consumer warpgroups
constexpr int GROUP_M = 8;    // M tiles walked together (L2 reuse)
constexpr int STAGES = 6;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int H = 2;          // 64-column wgmma groups per consumer
constexpr int TBN = 128 * H;  // output columns (w columns) of a block

// byte offsets from the 1024-aligned base
constexpr int XT = TBM * TBK * 2;    // x tile, bf16, swizzled
constexpr int WSUB = TBK * 128;      // w box: [64 k, 128 n] int8
constexpr int STAGE = XT + H * WSUB;
constexpr int BAR = STAGES * STAGE;  // full[S], empty[S]
constexpr int SMEM_BYTES = BAR + 2 * STAGES * 8 + 1024;

// the dynamic shared memory rounded up to 1024 bytes (the swizzle atom)
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024 - (hp::smem_addr(raw) & 1023)) & 1023);
}

// One register of int8 as ldmatrix.trans delivers a [k, n] tile read as
// 16-bit pairs: bytes (k, n), (k, n + 1), (k + 1, n), (k + 1, n + 1) ->
// bf16x2 {(k, n), (k + 1, n)} and {(k, n + 1), (k + 1, n + 1)}, the k
// pairs of the A fragments of output columns n and n + 1. Each byte
// u + 128 becomes the fp32 2^23 + u + 128 (a byte permute); minus
// 2^23 + 128 that is the value exactly, and as it has at most 8
// significant bits its bf16 is the fp32's upper half (a byte permute,
// no conversion instruction).
__device__ __forceinline__ void int8_kpairs(uint32_t w, uint32_t& n0,
                                            uint32_t& n1) {
  const uint32_t u = w ^ 0x80808080u;  // byte + 128, unsigned
  constexpr float MAGIC = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - MAGIC;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - MAGIC;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - MAGIC;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - MAGIC;
  n0 = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  n1 = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// The A fragments (w^T, bf16) of one stage for this warp: fr[kk * H + h]
// is k-step kk of the warp's 16 output columns in half h. Fragment row
// g (< 8) is output column 2 g of those 16, row g + 8 column 2 g + 1, so
// that one transposed ldmatrix of 16-bit pairs gives both. The w tile is
// H boxes of [64 k, 128 n] int8, 128-byte swizzled; column n_local of
// the block is box n_local / 128, 16-byte chunk (n_local % 128) / 16.
__device__ __forceinline__ void load_w_frags(uint32_t (&fr)[4 * H][4],
                                             uint32_t wt, int cw, int warp,
                                             int lane) {
  const int j = lane >> 3, i = lane & 7;
#pragma unroll
  for (int p = 0; p < 2 * H; ++p) {
    // matrices of this load: units 2p and 2p + 1 (unit u = kk * H + h),
    // each its k-rows 0..7 then 8..15
    const int u = 2 * p + (j >> 1);
    const int kr = 16 * (u / H) + 8 * (j & 1) + i;
    const int n_local = 64 * (H * cw + u % H) + 16 * warp;
    const uint32_t addr = wt + (n_local >> 7) * (TBK * 128) + kr * 128 +
                          ((((n_local & 127) >> 4) ^ (kr & 7)) << 4);
    uint32_t r[4];
    hp::ldsm_x4_trans(r, addr);
    int8_kpairs(r[0], fr[2 * p][0], fr[2 * p][1]);
    int8_kpairs(r[1], fr[2 * p][2], fr[2 * p][3]);
    int8_kpairs(r[2], fr[2 * p + 1][0], fr[2 * p + 1][1]);
    int8_kpairs(r[3], fr[2 * p + 1][2], fr[2 * p + 1][3]);
  }
}

__global__ void __launch_bounds__(TTHREADS, 1)
int8_mm_tma_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ scale, bf16* __restrict__ out,
                   int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base(smem_raw);
  const uint32_t base = hp::smem_addr(smem);
  const uint32_t full = base + BAR, empty = full + 8 * STAGES;
  // grouped walk over the output tiles
  const int tiles_m = (M + TBM - 1) / TBM, tiles_n = (N + TBN - 1) / TBN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (int)blockIdx.x / per_group * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int in_group = (int)blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * TBM;
  const int n0 = in_group / group_m * TBN;
  const int k_tiles = (K + TBK - 1) / TBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full + 8 * s, 1);    // the producer's expect_tx
      hp::mbar_init(empty + 8 * s, 8);   // the consumers' 8 warps
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    hp::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    hp::prefetch_map(&tx);
    hp::prefetch_map(&tw);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      hp::mbar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t st = base + stage * STAGE, bar = full + 8 * stage;
      hp::mbar_arrive_expect_tx(bar, STAGE);
      hp::tma_load_2d(st, &tx, bar, kt * TBK, m0);
#pragma unroll
      for (int h = 0; h < H; ++h)
        hp::tma_load_2d(st + XT + h * WSUB, &tw, bar, n0 + 128 * h,
                        kt * TBK);
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  // out^T = w^T x^T: each consumer owns 128 output columns (w^T rows, the
  // A operand, converted into registers) against the block's 128 x rows
  // (B, K-major from the x tile)
  hp::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32, gid = lane / 4, tig = lane % 4;
  float acc[H][64];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

  // Step kt issues its products from fragments `cur`, converts stage
  // kt + 1's w tile into `nxt` while they run, then waits for them and
  // frees stage kt. The two fragment sets alternate (the loop runs two
  // steps per turn so that both stay in registers).
  int stage = 0;
  uint32_t phase = 0;
  uint32_t fa[4 * H][4], fb[4 * H][4];
  hp::mbar_wait(full, 0);
  load_w_frags(fa, base + XT, cw, warp, lane);
  auto step = [&](uint32_t (&cur)[4 * H][4], uint32_t (&nxt)[4 * H][4],
                  int kt) {
    const uint32_t st = base + stage * STAGE;
#pragma unroll
    for (int h = 0; h < H; ++h) hp::fence_regs(acc[h]);
    hp::fence_regs(cur);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      const uint64_t dx = hp::desc_sw128(st + kk * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < H; ++h)
        hp::wgmma_rs_n128<0>(acc[h], cur[kk * H + h], dx, 1);
    }
    hp::wgmma_commit();
    int next = stage + 1;
    uint32_t next_phase = phase;
    if (next == STAGES) next = 0, next_phase ^= 1;
    if (kt + 1 < k_tiles) {
      hp::mbar_wait(full + 8 * next, next_phase);
      load_w_frags(nxt, base + next * STAGE + XT, cw, warp, lane);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(cur);
#pragma unroll
    for (int h = 0; h < H; ++h) hp::fence_regs(acc[h]);
    if (lane == 0) hp::mbar_arrive(empty + 8 * stage);
    stage = next, phase = next_phase;
  };
  for (int kt = 0; kt < k_tiles; kt += 2) {
    step(fa, fb, kt);
    if (kt + 1 < k_tiles) step(fb, fa, kt + 1);
  }

  // epilogue: fragment rows g / g + 8 are output columns n / n + 1, the
  // accumulator columns are output rows; scale per column, one bf16
  // rounding, rows < M, columns < N
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int n = n0 + 64 * (H * cw + h) + 16 * warp + 2 * gid;
    if (n >= N) continue;  // N % 16 == 0: n + 1 < N as well
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + nb * 8 + tig * 2 + e;
        if (m < M)
          *reinterpret_cast<uint32_t*>(&out[(size_t)m * N + n]) =
              dla::pack_bf16(acc[h][nb * 4 + e] * s0,
                             acc[h][nb * 4 + 2 + e] * s1);
      }
  }
}

// ---------------------------------------------------- int8_mm_decode_kernel

constexpr int DBK = 64;      // K depth of a ring stage
constexpr int DCOLS = 64;    // output columns of a consumer (one w box)
constexpr int DSTAGES = 6;
constexpr int MB = 64;       // x rows of a block: the wgmma's N

template <int CW>
struct Dec {
  static constexpr int THREADS = 128 * CW + 32;  // consumers + producer warp
  static constexpr int TN = DCOLS * CW;          // output columns of a block
  static constexpr int XT = MB * DBK * 2;        // x tile, bf16, 128B swizzle
  static constexpr int WBOX = DBK * DCOLS;       // w box, int8, 64B swizzle
  static constexpr int STAGE = XT + CW * WBOX;
  static constexpr int RING = DSTAGES * STAGE;
  static constexpr int LD = TN + 4;              // fp32 row pitch, sum tile
  static constexpr int SUM = MB * LD * 4;        // [MB, TN] fp32 partial
  static constexpr int BAR = RING > SUM ? RING : SUM;
  static constexpr int SMEM = BAR + 2 * DSTAGES * 8 + 1024;
  // blocks an SM holds at once (shared memory and registers)
  static constexpr int MIN_BLOCKS = CW == 1 ? 3 : 2;
};

// The A fragments (w^T, bf16) of one stage for this warp: fr[kk] is
// k-step kk of the warp's 16 output columns; as in load_w_frags,
// fragment row g (< 8) is column 2 g of those 16 and row g + 8 column
// 2 g + 1. The box is [64 k, 64 n] int8 with 64-byte rows, 64-byte
// swizzled: the warp's 16 columns are 16-byte chunk `warp` of a row,
// stored at chunk warp ^ ((k >> 1) & 3).
__device__ __forceinline__ void load_w_frags_64(uint32_t (&fr)[4][4],
                                                uint32_t wt, int warp,
                                                int lane) {
  const int j = lane >> 3, i = lane & 7;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int kr = 16 * (2 * p + (j >> 1)) + 8 * (j & 1) + i;
    const uint32_t addr = wt + kr * 64 + ((warp ^ ((kr >> 1) & 3)) << 4);
    uint32_t r[4];
    hp::ldsm_x4_trans(r, addr);
    int8_kpairs(r[0], fr[2 * p][0], fr[2 * p][1]);
    int8_kpairs(r[1], fr[2 * p][2], fr[2 * p][3]);
    int8_kpairs(r[2], fr[2 * p + 1][0], fr[2 * p + 1][1]);
    int8_kpairs(r[3], fr[2 * p + 1][2], fr[2 * p + 1][3]);
  }
}

template <int CW>
__global__ void __launch_bounds__(Dec<CW>::THREADS, Dec<CW>::MIN_BLOCKS)
int8_mm_decode_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const float* __restrict__ scale,
                      bf16* __restrict__ out, int M, int N, int K) {
  using C = Dec<CW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base(smem_raw);
  const uint32_t base = hp::smem_addr(smem);
  const uint32_t full = base + C::BAR, empty = full + 8 * DSTAGES;
  const int n0 = blockIdx.x * C::TN;
  const int splits = gridDim.y, split = blockIdx.y;  // cluster rank = split
  const int k_tiles = (K + DBK - 1) / DBK;
  const int kt0 = split * k_tiles / splits;
  const int nk = (split + 1) * k_tiles / splits - kt0;
  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;

  hp::grid_dep_launch();  // the next kernel may start loading its weights
  if (threadIdx.x == 0) {
    for (int s = 0; s < DSTAGES; ++s) {
      hp::mbar_init(full + 8 * s, 1);        // the producer's expect_tx
      hp::mbar_init(empty + 8 * s, 4 * CW);  // the consumers' warps
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  float acc[MB / 2];
#pragma unroll
  for (int i = 0; i < MB / 2; ++i) acc[i] = 0.f;
  const int cw = warp_id / 4, warp = warp_id % 4;
  const int gid = lane / 4, tig = lane % 4;

  if (warp_id == 4 * CW) {  // --------------------------------- producer
    if (lane == 0 && nk > 0) {
      hp::prefetch_map(&tx);
      hp::prefetch_map(&tw);
      // The first stages' weights do not depend on earlier kernels: they
      // are requested before the wait for the grid this one follows (a
      // launch with programmatic stream serialization starts while that
      // grid still runs), x only after it.
      const int first = nk < DSTAGES ? nk : DSTAGES;
      for (int t = 0; t < first; ++t) {
        const uint32_t st = base + t * C::STAGE, bar = full + 8 * t;
        hp::mbar_arrive_expect_tx(bar, C::STAGE);
#pragma unroll
        for (int c = 0; c < CW; ++c)
          hp::tma_load_2d(st + C::XT + c * C::WBOX, &tw, bar,
                          n0 + DCOLS * c, (kt0 + t) * DBK);
      }
      hp::grid_dep_wait();
      for (int t = 0; t < first; ++t)
        hp::tma_load_2d(base + t * C::STAGE, &tx, full + 8 * t,
                        (kt0 + t) * DBK, 0);
      int stage = first == DSTAGES ? 0 : first;
      uint32_t phase = first == DSTAGES ? 1 : 0;
      for (int t = first; t < nk; ++t) {
        const int k0 = (kt0 + t) * DBK;
        hp::mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = base + stage * C::STAGE, bar = full + 8 * stage;
        hp::mbar_arrive_expect_tx(bar, C::STAGE);
        hp::tma_load_2d(st, &tx, bar, k0, 0);
#pragma unroll
        for (int c = 0; c < CW; ++c)
          hp::tma_load_2d(st + C::XT + c * C::WBOX, &tw, bar,
                          n0 + DCOLS * c, k0);
        if (++stage == DSTAGES) stage = 0, phase ^= 1;
      }
    }
    __syncwarp();
  } else if (nk > 0) {  // -------------------------------------- consumers
    // stage t's products are issued from fragments `cur`; stage t + 1's
    // w tile is converted into `nxt` while they run (two steps a turn,
    // so both fragment sets stay in registers)
    int stage = 0;
    uint32_t phase = 0;
    uint32_t fa[4][4], fb[4][4];
    const uint32_t wofs = C::XT + cw * C::WBOX;
    hp::mbar_wait(full, 0);
    load_w_frags_64(fa, base + wofs, warp, lane);
    auto step = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4], int t) {
      const uint32_t st = base + stage * C::STAGE;
      hp::fence_regs(acc);
      hp::fence_regs(cur);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DBK / 16; ++kk)
        hp::wgmma_rs_n64<0>(acc, cur[kk],
                            hp::desc_sw128(st + kk * 32, 16, 1024), 1);
      hp::wgmma_commit();
      int next = stage + 1;
      uint32_t next_phase = phase;
      if (next == DSTAGES) next = 0, next_phase ^= 1;
      if (t + 1 < nk) {
        hp::mbar_wait(full + 8 * next, next_phase);
        load_w_frags_64(nxt, base + next * C::STAGE + wofs, warp, lane);
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(cur);
      hp::fence_regs(acc);
      if (lane == 0) hp::mbar_arrive(empty + 8 * stage);
      stage = next, phase = next_phase;
    };
    for (int t = 0; t < nk; t += 2) {
      step(fa, fb, t);
      if (t + 1 < nk) step(fb, fa, t + 1);
    }
  }

  // The accumulator: d[i] is output column n (w^T row 16 warp + gid +
  // 8 ((i >> 1) & 1), i.e. column 16 warp + 2 gid + ((i >> 1) & 1) of
  // this consumer's 64) and output row m = 8 (i >> 2) + 2 tig + (i & 1).
  const int nl = DCOLS * cw + 16 * warp + 2 * gid;  // column in the block
  hp::grid_dep_wait();  // earlier kernels are done with the output's memory
  if (splits == 1) {  // no cluster: scale, round, store from registers
    const int n = n0 + nl;
    if (warp_id < 4 * CW && n < N) {  // N % 16 == 0: n + 1 < N as well
      const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
      for (int nb = 0; nb < MB / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = nb * 8 + tig * 2 + e;
          if (m < M)
            *reinterpret_cast<uint32_t*>(&out[(size_t)m * N + n]) =
                dla::pack_bf16(acc[nb * 4 + e] * s0, acc[nb * 4 + 2 + e] * s1);
        }
    }
    return;
  }

  // Split K: park the partial tile [MB, TN] in this block's shared memory
  // (over the drained ring), then sum slice `split` of the tile over the
  // cluster's blocks in rank order 0, 1, ..., scale and round once.
  __syncthreads();  // every product of this block is done: the ring is free
  float* part = reinterpret_cast<float*>(smem);
  if (warp_id < 4 * CW) {
#pragma unroll
    for (int nb = 0; nb < MB / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = nb * 8 + tig * 2 + e;
        *reinterpret_cast<float2*>(&part[m * C::LD + nl]) =
            make_float2(acc[nb * 4 + e], acc[nb * 4 + 2 + e]);
      }
  }
  hp::cluster_sync();
  constexpr int QUADS = MB * C::TN / 4;   // float4 groups of the tile
  const int q0 = split * QUADS / splits, q1 = (split + 1) * QUADS / splits;
  for (int q = q0 + threadIdx.x; q < q1; q += C::THREADS) {
    const int m = q / (C::TN / 4), nq = (q % (C::TN / 4)) * 4;
    const int n = n0 + nq;
    if (m >= M || n >= N) continue;  // N % 16 == 0: all four or none
    const uint32_t off = base + (uint32_t)(m * C::LD + nq) * 4;
    // every rank's load in flight before the first sum
    float4 v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < splits) v[r] = hp::ld_cluster_f4(hp::map_rank(off, r));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < splits)
        sum.x += v[r].x, sum.y += v[r].y, sum.z += v[r].z, sum.w += v[r].w;
    const float4 sc = *reinterpret_cast<const float4*>(scale + n);
    *reinterpret_cast<uint2*>(&out[(size_t)m * N + n]) =
        make_uint2(dla::pack_bf16(sum.x * sc.x, sum.y * sc.y),
                   dla::pack_bf16(sum.z * sc.z, sum.w * sc.w));
  }
  hp::cluster_sync();  // no block leaves while the others read its tile
}

template <int CW>
int launch_decode(const void* x, const void* w, const float* scale, bf16* out,
                  int M, int N, int K, int splits, cudaStream_t stream) {
  using C = Dec<CW>;
  CUtensorMap tx, tw;
  int err = hp::make_matrix_map(&tx, x, M, K, 2, MB, DBK);
  if (!err)
    err = hp::make_matrix_map(&tw, w, K, N, 1, DBK, DCOLS,
                              CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  auto kernel = int8_mm_decode_kernel<CW>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  if (splits > 8)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + C::TN - 1) / C::TN, splits, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  // programmatic stream serialization: the kernel may start while the
  // stream's previous kernel finishes (it waits in grid_dep_wait)
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = splits;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tx, tw, scale, out,
                                           M, N, K);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// M <= 64 (decode): the cluster split-K kernel with `tile_n` (64 or 128)
// output columns per block and `splits` (1, 2, 4, 8 or 16; at most the
// 64-deep K tiles) K splits, one cluster of `splits` blocks per column
// tile. Returns a cudaError_t, or hopper::kMapError + a CUresult when a
// tensor map cannot be encoded.
extern "C" int dla_int8_matmul_decode(const void* x, const void* w,
                                      const void* scale, void* out, int M,
                                      int N, int K, int tile_n, int splits,
                                      void* stream) {
  const int k_tiles = (K + DBK - 1) / DBK;
  if (M < 1 || M > MB || splits < 1 || splits > 16 ||
      (splits & (splits - 1)) || splits > k_tiles)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_n == 128 && splits <= 8)
    return launch_decode<2>(x, w, sc, o, M, N, K, splits, s);
  if (tile_n == 64) return launch_decode<1>(x, w, sc, o, M, N, K, splits, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory per block of the decode kernel, by tile_n
extern "C" int dla_int8_matmul_decode_smem_bytes(int tile_n) {
  return tile_n == 128 ? Dec<2>::SMEM : Dec<1>::SMEM;
}

// M > 64: the TMA + wgmma kernel at 128 x 256 output tiles. Returns a
// cudaError_t, or hopper::kMapError + a CUresult when a tensor map cannot
// be encoded.
extern "C" int dla_int8_matmul_tma(const void* x, const void* w,
                                   const void* scale, void* out, int M, int N,
                                   int K, void* stream) {
  CUtensorMap tx, tw;
  int err = hp::make_matrix_map(&tx, x, M, K, 2, TBM, TBK);
  if (!err) err = hp::make_matrix_map(&tw, w, K, N, 1, TBK, 128);
  if (err) return err;
  cudaFuncSetAttribute(int8_mm_tma_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  const int tiles = ((M + TBM - 1) / TBM) * ((N + TBN - 1) / TBN);
  int8_mm_tma_kernel<<<tiles, TTHREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const float*>(scale), static_cast<bf16*>(out), M,
      N, K);
  return (int)cudaGetLastError();
}

// dynamic shared memory per block of the TMA kernel
extern "C" int dla_int8_matmul_smem_bytes() { return SMEM_BYTES; }
