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
// Design: one block per (64-row M tile, 64-column N tile, K split),
// looping over K in 64-deep tiles — the TPU kernel never blocked K only
// because its whole K strip fit VMEM. Each K tile of w is read from HBM
// once per M tile (at decode: once), as 16-byte vector loads into
// registers one tile ahead of the compute (register double buffering),
// converted int8 -> bf16 (exact: |w| <= 127) on its way into shared
// memory, and multiplied with mma.sync bf16 tensor-core products into
// fp32 accumulators; the per-channel fp32 scale multiplies the fp32
// product before the single bf16 rounding. When M and N give too few
// tiles to occupy the card (decode projections), K is split across
// blocks: each split writes an fp32 partial and a second small kernel
// sums the splits in a fixed order (deterministic), scales and rounds.
// Not yet: cp.async/TMA pipelines and wgmma, which the compute-bound
// prefill shapes need to approach the tensor-core peak.
#include "common.cuh"

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

}  // namespace

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
