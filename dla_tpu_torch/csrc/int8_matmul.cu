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
// int8_mm_tma_kernel (M >= 128, prefill). Hopper design (hopper.cuh):
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
// int8_mm_kernel (M < 128, decode), the first version of the port: one
// block per (64-row M tile, 64-column N tile, K split), looping over K
// in 64-deep tiles. Each K tile of w is read from HBM once per M tile
// (at decode: once), as 16-byte vector loads into registers one tile
// ahead of the compute, converted int8 -> bf16 on its way into shared
// memory, and multiplied with mma.sync bf16 products into fp32
// accumulators; the per-channel fp32 scale multiplies the fp32 product
// before the single bf16 rounding. When M and N give too few tiles to
// occupy the card (decode projections), K is split across blocks: each
// split writes an fp32 partial and a second small kernel sums the splits
// in a fixed order (deterministic), scales and rounds. No tensor maps on
// this path: decode calls it 225 times a step.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using dla::bf16;

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;
constexpr int XS = BK + 8;  // shared row stride (bf16) of the x tile [BM][BK]
constexpr int WS = BN + 8;  // shared row stride (bf16) of the w tile [BK][BN]

__global__ void __launch_bounds__(THREADS)
int8_mm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, bf16* __restrict__ out,
               float* __restrict__ partial, int M, int N, int K,
               int tiles_per_split) {
  __shared__ __align__(16) bf16 xs[BM * XS];
  __shared__ __align__(16) bf16 ws[BK * WS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt_begin = blockIdx.z * tiles_per_split;
  const int kt_end = min(k_tiles, kt_begin + tiles_per_split);
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // warp's 32x32 tile

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one K tile: x 64x64 bf16 = 512 16-byte chunks (4 per thread),
  // w 64x64 int8 = 256 chunks (2 per thread); K % 8 == 0 and N % 16 == 0
  // (checked by the wrapper) make every chunk wholly in or out of bounds
  uint4 xr[4], wr[2];
  auto load_tile = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / 8, cc = (c % 8) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      xr[i] = (gm < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / 4, cc = (c % 4) * 16;
      const int gk = k0 + r, gn = n0 + cc;
      wr[i] = (gk < K && gn < N)
                  ? *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / 8, cc = (c % 8) * 8;
      *reinterpret_cast<uint4*>(&xs[r * XS + cc]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / 4, cc = (c % 4) * 16;
      const int8_t* v = reinterpret_cast<const int8_t*>(&wr[i]);
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        packed[j] = dla::pack_bf16((float)v[2 * j], (float)v[2 * j + 1]);
      uint4* dst = reinterpret_cast<uint4*>(&ws[r * WS + cc]);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  };

  if (kt_begin < kt_end) load_tile(kt_begin);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __syncthreads();  // the previous tile's products have read smem
    store_tile();
    __syncthreads();
    if (kt + 1 < kt_end) load_tile(kt + 1);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* p = &xs[(wm + mt * 16 + gid) * XS + kk * 16 + tig * 2];
        a[mt][0] = dla::ld32(p);
        a[mt][1] = dla::ld32(p + 8 * XS);
        a[mt][2] = dla::ld32(p + 8);
        a[mt][3] = dla::ld32(p + 8 * XS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* p = &ws[(kk * 16 + tig * 2) * WS + wn + nt * 8 + gid];
        const uint32_t b0 = dla::pack_raw(p[0], p[WS]);
        const uint32_t b1 = dla::pack_raw(p[8 * WS], p[9 * WS]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) dla::mma_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + gid + half * 8;
        const int col = n0 + wn + nt * 8 + tig * 2;
        if (row >= M || col >= N) continue;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (gridDim.z == 1) {
          *reinterpret_cast<uint32_t*>(&out[(size_t)row * N + col]) =
              dla::pack_bf16(v0 * scale[col], v1 * scale[col + 1]);
        } else {
          float* dst = partial + ((size_t)blockIdx.z * M + row) * N + col;
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        }
      }
}

// sum the K splits in split order, scale per channel, round to bf16
__global__ void int8_mm_finalize(const float* __restrict__ partial,
                                 const float* __restrict__ scale,
                                 bf16* __restrict__ out, int M, int N,
                                 int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * total + i];
    out[i] = __float2bfloat16_rn(s * scale[i % N]);
  }
}

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

}  // namespace

// M < 128 (decode): the split-K kernel; `partial` is [splits, M, N] fp32
// scratch when splits > 1. Returns a cudaError_t.
extern "C" int dla_int8_matmul(const void* x, const void* w, const void* scale,
                               void* out, void* partial, int M, int N, int K,
                               int splits, void* stream) {
  const int k_tiles = (K + BK - 1) / BK;
  const int per_split = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + per_split - 1) / per_split;  // no empty splits
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_mm_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<bf16*>(out),
      static_cast<float*>(partial), M, N, K, per_split);
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const size_t need = (total + 255) / 256;
    const int blocks = need > 4096 ? 4096 : (int)need;
    int8_mm_finalize<<<blocks, 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<const float*>(scale),
        static_cast<bf16*>(out), M, N, splits);
  }
  return (int)cudaGetLastError();
}

// M >= 128: the TMA + wgmma kernel at 128 x 256 output tiles. Returns a
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
