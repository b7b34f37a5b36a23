// Single-token decode attention over a contiguous KV cache (bf16 or int8
// with K-major fp32 scales), joint softmax with the new token's k/v.
//
// Replaces the Pallas kernel `_body` / `_call` in
// dla_tpu/ops/decode_kernel.py (pallas_call at :201).
//
// What bounds it on an H100: each cache byte meets g = H / KH query rows,
// a few operations per byte, so the cache bytes read from HBM bound it.
//
// Design (decode_attn_kernel, one launch per call):
//  - A fixed grid: one block per (batch, kv head) pair, times `split`
//    blocks along S when the pairs alone cannot fill the card (few rows
//    at a long cache). The fill level comes from a device scalar (the
//    Pallas kernel's scalar prefetch), so the launch is the same at every
//    step and a CUDA graph can replay it: blocks and slices past the fill
//    read nothing, and columns at or past it are never loaded (their
//    shared-memory rows are zero-filled), so they cannot poison the
//    result (they may hold NaN).
//  - Each of the 4 warps walks its own 16-column slices of the block's
//    columns (slices w, w + 4, ...) with its own 2-stage cp.async ring of
//    16-byte loads (K rows, V rows, their scales, the bias) and its own
//    online softmax; no block barrier inside the loop.
//  - Both products on tensor cores (mma.sync m16n8k16, fp32 sums), the
//    g <= 8 query rows of the kv head as the 8-wide operand: scores
//    S^T = K q^T with K dequantized into A fragments in registers
//    (value = bf16(int8 * fp32 scale), the plain version's casts), then
//    O^T += V^T P^T with V^T from a transposed ldmatrix (int8: the
//    16-bit-pair route of the int8 matmul, dequantized per column), P
//    rounded to bf16 as the plain version does.
//  - The log-sum-exp merge of the 4 warps' (and the split's blocks')
//    partial sums with the new token's own column happens in the same
//    kernel, in a fixed order (split block, warp, then the new column);
//    a split's blocks form a cluster and read each other's partials
//    through distributed shared memory. No atomics, no partials in HBM.
// Softcap applies to the scaled score before the additive bias.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using dla::bf16;
namespace hp = dla::hopper;

constexpr int WARPS = 4, THREADS = 128;
constexpr int SL = 16;     // cache columns of a warp's slice
constexpr int GMAX = 8;    // query rows per kv head (the mma's n = 8)
constexpr int PLD = 24;    // bf16 row pitch of a warp's P^T buffer

template <int D, bool INT8>
struct Cfg {
  static constexpr int ROW = INT8 ? D : 2 * D;  // bytes of a cache row
  // smem pitch: the least odd number of 16-byte chunks past the row (D = 80
  // int8: 5 chunks of data, pitch 7), so 8 rows spread over the banks
  static constexpr int LD = 16 * ((ROW / 16 + 1) | 1);
  static constexpr int STAGE = 2 * SL * LD + 3 * SL * 4;  // K, V, ks, vs, bias
  static constexpr int RING = WARPS * 2 * STAGE;
  static constexpr int PART = WARPS * (2 * GMAX + D * GMAX) * 4;
  static constexpr int BODY = RING > PART ? RING : PART;
  static constexpr int SMEM = BODY + WARPS * GMAX * PLD * 2;
};

// four int8 bytes of one row, times that row's scale, as two bf16x2 (the
// two lower bytes, then the two upper): the plain version's
// bf16(int8 * fp32 scale). The byte -> fp32 step is exact (2^23 + byte +
// 128 as a bit pattern, minus 2^23 + 128).
__device__ __forceinline__ void dequant4(uint32_t w, float s, uint32_t& lo,
                                         uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float MAGIC = 8388736.f;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - MAGIC;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - MAGIC;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - MAGIC;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - MAGIC;
  lo = dla::pack_bf16(f0 * s, f1 * s);
  hi = dla::pack_bf16(f2 * s, f3 * s);
}

// One register of int8 as a transposed ldmatrix of 16-bit pairs delivers
// it from a [c, d] tile: bytes (c, d), (c, d + 1), (c + 1, d), (c + 1,
// d + 1) -> the c pairs of columns d and d + 1, each value times its
// row's scale (s0 for c, s1 for c + 1), rounded to bf16.
__device__ __forceinline__ void dequant_cpairs(uint32_t w, float s0, float s1,
                                               uint32_t& d0, uint32_t& d1) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float MAGIC = 8388736.f;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - MAGIC;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - MAGIC;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - MAGIC;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - MAGIC;
  d0 = dla::pack_bf16(f0 * s0, f2 * s1);
  d1 = dla::pack_bf16(f1 * s0, f3 * s1);
}

struct Args {
  const bf16* q;      // [B, K * G, D]
  const void* kc;     // [B, S, K, D] int8 or bf16
  const void* vc;
  const float* ks;    // [B, K, S] (int8 only)
  const float* vs;
  const bf16* kn;     // [B, K, D]
  const bf16* vn;
  const float* bias;  // [B, S]
  void* out;          // [B, K * G, D] bf16 or fp32
  const int* fill_dev;  // device scalar, or null: fill_host
  int fill_host;
  int S, K, G, cols;  // cols: cache columns of a split block
  float scale, softcap;
  int out_bf16;
};

template <int D, bool INT8>
__global__ void __launch_bounds__(THREADS, 4)
decode_attn_kernel(const Args a) {
  using C = Cfg<D, INT8>;
  constexpr int KS = D / 16;      // k-steps of the score product
  constexpr int CPR = C::ROW / 16;  // 16-byte chunks of a cache row
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_self[GMAX], wt[8 * WARPS][GMAX], w_self[GMAX],
      inv_l[GMAX];
  hp::grid_dep_launch();  // the next kernel may start loading its weights
  const int pair = blockIdx.x, b = pair / a.K, kh = pair % a.K;
  const int split = gridDim.y, rank = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int G = a.G, S = a.S;
  int fill = a.fill_dev ? *a.fill_dev : a.fill_host;
  fill = min(max(fill, 0), S);
  const int c_lo = rank * a.cols, c_hi = min(fill, c_lo + a.cols);
  const int slices = c_hi > c_lo ? (c_hi - c_lo + SL - 1) / SL : 0;

  // q^T as the score product's B operand: k-step ks holds q[g = gid] at
  // d = 16 ks + 4 tig .. + 3 (the same d order as the K fragments below)
  const size_t head0 = ((size_t)b * a.K + kh) * G;
  uint32_t qf[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint2 v = make_uint2(0, 0);
    if (gid < G)
      v = *reinterpret_cast<const uint2*>(a.q + (head0 + gid) * D + 16 * ks +
                                          4 * tig);
    qf[ks][0] = v.x, qf[ks][1] = v.y;
  }

  // per-warp state: O^T accumulators (rows d, columns g = 2 tig, 2 tig +
  // 1), running max and (per-lane) running sum of the two g's
  float acc[D / 16][4];
#pragma unroll
  for (int t = 0; t < D / 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  float m_run[2] = {dla::kNegInf, dla::kNegInf}, l_run[2] = {0.f, 0.f};

  uint8_t* ring = smem + warp * 2 * C::STAGE;
  bf16* pt = reinterpret_cast<bf16*>(smem + C::BODY) + warp * GMAX * PLD;
  const size_t row_stride = (size_t)a.K * C::ROW;  // bytes between columns
  const uint8_t* kbase = static_cast<const uint8_t*>(a.kc) +
                         ((size_t)b * S * a.K + kh) * C::ROW;
  const uint8_t* vbase = static_cast<const uint8_t*>(a.vc) +
                         ((size_t)b * S * a.K + kh) * C::ROW;
  const size_t srow = ((size_t)b * a.K + kh) * S;

  // slice i of this block into stage st: rows past c_hi read nothing and
  // land as zeros
  auto issue = [&](int i, int st) {
    if (i < slices) {
      uint8_t* kd = ring + st * C::STAGE;
      uint8_t* vd = kd + SL * C::LD;
      float* sd = reinterpret_cast<float*>(vd + SL * C::LD);
      const int c0 = c_lo + SL * i;
      for (int u = lane; u < SL * CPR; u += 32) {
        const int r = u / CPR, ch = u % CPR, c = c0 + r;
        const bool live = c < c_hi;
        const size_t off = live ? c * row_stride + ch * 16 : 0;
        hp::cp_async16(hp::smem_addr(kd + r * C::LD + ch * 16), kbase + off,
                       live ? 16 : 0);
        hp::cp_async16(hp::smem_addr(vd + r * C::LD + ch * 16), vbase + off,
                       live ? 16 : 0);
      }
      for (int u = lane; u < 3 * SL; u += 32) {
        const int which = u / SL, r = u % SL, c = c0 + r;
        const bool live = c < c_hi && (which == 2 || INT8);
        const float* src = which == 2 ? a.bias + (size_t)b * S
                           : which == 0 ? a.ks + srow : a.vs + srow;
        hp::cp_async4z(hp::smem_addr(sd + u), live ? src + c : a.bias,
                       live ? 4 : 0);
      }
    }
    hp::cp_async_commit();
  };

  issue(warp, 0);
  issue(warp + WARPS, 1);
  for (int i = warp, it = 0; i < slices; i += WARPS, ++it) {
    const int st = it & 1;
    hp::cp_async_wait<1>();
    __syncwarp();
    const uint8_t* kt = ring + st * C::STAGE;
    const uint8_t* vt = kt + SL * C::LD;
    const float* ksc = reinterpret_cast<const float*>(vt + SL * C::LD);
    const float* vsc = ksc + SL;
    const float* bsc = vsc + SL;
    const int c0 = c_lo + SL * i;

    // scores S^T [16 columns, 8 g]: A = K rows gid and gid + 8, d = 16 ks
    // + 4 tig .. + 3 as slots (2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9)
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    const float sk0 = INT8 ? ksc[gid] : 1.f, sk1 = INT8 ? ksc[gid + 8] : 1.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t af[4];
      if constexpr (INT8) {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
            kt + gid * C::LD + 16 * ks + 4 * tig);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
            kt + (gid + 8) * C::LD + 16 * ks + 4 * tig);
        dequant4(w0, sk0, af[0], af[2]);
        dequant4(w1, sk1, af[1], af[3]);
      } else {
        const uint2 w0 = *reinterpret_cast<const uint2*>(
            kt + gid * C::LD + 2 * (16 * ks + 4 * tig));
        const uint2 w1 = *reinterpret_cast<const uint2*>(
            kt + (gid + 8) * C::LD + 2 * (16 * ks + 4 * tig));
        af[0] = w0.x, af[2] = w0.y, af[1] = w1.x, af[3] = w1.y;
      }
      dla::mma_16816(sc, af, qf[ks][0], qf[ks][1]);
    }

    // online softmax of the slice: sc[2 h + e] is column c0 + gid + 8 h,
    // g = 2 tig + e
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      live[h] = c0 + gid + 8 * h < c_hi;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = sc[2 * h + e] * a.scale;
        if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
        s += bsc[gid + 8 * h];
        sc[2 * h + e] = live[h] ? s : dla::kNegInf;  // replaced, not added
      }
    }
    float corr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(sc[e], sc[2 + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m_run[e], mx);
      corr[e] = __expf(m_run[e] - m_new);
      m_run[e] = m_new;
      const float p0 = live[0] ? __expf(sc[e] - m_new) : 0.f;
      const float p1 = live[1] ? __expf(sc[2 + e] - m_new) : 0.f;
      l_run[e] = l_run[e] * corr[e] + p0 + p1;
      // P^T for the value product, rounded to bf16: pt[g][c]
      pt[(2 * tig + e) * PLD + gid] = __float2bfloat16_rn(p0);
      pt[(2 * tig + e) * PLD + gid + 8] = __float2bfloat16_rn(p1);
    }
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      acc[t][0] *= corr[0], acc[t][1] *= corr[1];
      acc[t][2] *= corr[0], acc[t][3] *= corr[1];
    }
    __syncwarp();
    // B = P^T [16 columns, 8 g]: (c = 2 tig, 2 tig + 1 | + 8; g = gid)
    const uint32_t pb0 = *reinterpret_cast<const uint32_t*>(
        pt + gid * PLD + 2 * tig);
    const uint32_t pb1 = *reinterpret_cast<const uint32_t*>(
        pt + gid * PLD + 2 * tig + 8);

    // O^T [D, 8 g] += V^T [D, 16 columns] P^T
    const int j = lane >> 3, i8 = lane & 7;
    if constexpr (INT8) {
      // one x4 load: matrices (columns 0-7 | 8-15) x (d chunk t | t + 1);
      // fragment rows g / g + 8 are d = 16 t + 2 g / 2 g + 1
      const float sv0 = vsc[2 * tig], sv1 = vsc[2 * tig + 1];
      const float sv8 = vsc[2 * tig + 8], sv9 = vsc[2 * tig + 9];
#pragma unroll
      for (int t = 0; t + 1 < KS; t += 2) {
        uint32_t r[4], f0[4], f1[4];
        hp::ldsm_x4_trans(r, hp::smem_addr(vt + (i8 + 8 * (j & 1)) * C::LD +
                                           16 * (t + (j >> 1))));
        dequant_cpairs(r[0], sv0, sv1, f0[0], f0[1]);
        dequant_cpairs(r[1], sv8, sv9, f0[2], f0[3]);
        dequant_cpairs(r[2], sv0, sv1, f1[0], f1[1]);
        dequant_cpairs(r[3], sv8, sv9, f1[2], f1[3]);
        dla::mma_16816(acc[t], f0, pb0, pb1);
        dla::mma_16816(acc[t + 1], f1, pb0, pb1);
      }
      if constexpr (KS % 2) {  // D = 80: the last d chunk alone, one x2 load
        uint32_t r[2], f0[4];
        hp::ldsm_x2_trans(r, hp::smem_addr(vt + (i8 + 8 * (j & 1)) * C::LD +
                                           16 * (KS - 1)));
        dequant_cpairs(r[0], sv0, sv1, f0[0], f0[1]);
        dequant_cpairs(r[1], sv8, sv9, f0[2], f0[3]);
        dla::mma_16816(acc[KS - 1], f0, pb0, pb1);
      }
    } else {
      // one x4 load per 16 d: matrices (columns 0-7 | 8-15) x (d 0-7 |
      // 8-15); fragment rows g / g + 8 are d = 16 t + g / g + 8
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
        uint32_t f[4];
        hp::ldsm_x4_trans(f, hp::smem_addr(vt + (i8 + 8 * (j >> 1)) * C::LD +
                                           2 * (16 * t + 8 * (j & 1))));
        dla::mma_16816(acc[t], f, pb0, pb1);
      }
    }
    __syncwarp();  // the stage and pt are read: the next copies may land
    issue(i + 2 * WARPS, st);
  }
  hp::cp_async_wait<0>();

  // the new token's own column (always unmasked): s_self[g]
  if (warp == 0) {
    const size_t kv_row = ((size_t)b * a.K + kh) * D;
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32)
        part += __bfloat162float(a.q[(head0 + g) * D + d]) *
                __bfloat162float(a.kn[kv_row + d]);
      part = dla::warp_sum(part);
      float s = part * a.scale;
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      if (lane == 0) s_self[g] = s;
    }
  }

  // park this warp's partial (m, l, O^T) over the drained ring
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem) + warp * (2 * GMAX + D * GMAX);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float l = l_run[e];
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    l += __shfl_xor_sync(0xffffffffu, l, 8);
    l += __shfl_xor_sync(0xffffffffu, l, 16);
    if (gid == 0) {
      part[2 * tig + e] = m_run[e];
      part[GMAX + 2 * tig + e] = l;
    }
  }
#pragma unroll
  for (int t = 0; t < D / 16; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = INT8 ? 16 * t + 2 * gid + h : 16 * t + gid + 8 * h;
      *reinterpret_cast<float2*>(&part[2 * GMAX + d * GMAX + 2 * tig]) =
          make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
    }
  if (split > 1)
    hp::cluster_sync();
  else
    __syncthreads();

  // merge in a fixed order: split block, warp, then the new column
  constexpr int PSTRIDE = (2 * GMAX + D * GMAX) * 4;  // bytes per partial
  const uint32_t pbase = hp::smem_addr(smem);
  auto ld_part = [&](int r, int w, int idx) -> float {
    const uint32_t addr = pbase + w * PSTRIDE + idx * 4;
    if (split == 1)
      return *reinterpret_cast<const float*>(smem + w * PSTRIDE + idx * 4);
    return hp::ld_cluster_f32(hp::map_rank(addr, r));
  };
  const int np = split * WARPS;
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float m = s_self[g];
    for (int p = 0; p < np; ++p) m = fmaxf(m, ld_part(p / WARPS, p % WARPS, g));
    float l = 0.f;
    for (int p = 0; p < np; ++p) {
      const float f =
          __expf(ld_part(p / WARPS, p % WARPS, g) - m);
      wt[p][g] = f;
      l += f * ld_part(p / WARPS, p % WARPS, GMAX + g);
    }
    w_self[g] = __expf(s_self[g] - m);
    inv_l[g] = 1.f / (l + w_self[g]);
  }
  __syncthreads();
  const int dn = D / split, d0 = rank * dn;
  const size_t kv_row = ((size_t)b * a.K + kh) * D;
  for (int idx = threadIdx.x; idx < G * dn; idx += THREADS) {
    const int g = idx / dn, d = d0 + idx % dn;
    float o = 0.f;
    for (int p = 0; p < np; ++p)
      o += wt[p][g] * ld_part(p / WARPS, p % WARPS, 2 * GMAX + d * GMAX + g);
    o += w_self[g] * __bfloat162float(a.vn[kv_row + d]);
    o *= inv_l[g];
    const size_t at = (head0 + g) * D + d;
    if (a.out_bf16)
      static_cast<bf16*>(a.out)[at] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(a.out)[at] = o;
  }
  if (split > 1) hp::cluster_sync();  // the others read this block's partials
}

template <int D, bool INT8>
int launch(const Args& a, int pairs, int split, cudaStream_t stream) {
  using C = Cfg<D, INT8>;
  auto kernel = decode_attn_kernel<D, INT8>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       C::SMEM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pairs, split, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool INT8>
int dispatch(int D, const Args& a, int pairs, int split, cudaStream_t st) {
  switch (D) {
    case 64: return launch<64, INT8>(a, pairs, split, st);
    case 80: return launch<80, INT8>(a, pairs, split, st);
    case 96: return launch<96, INT8>(a, pairs, split, st);
    case 128: return launch<128, INT8>(a, pairs, split, st);
    case 256: return launch<256, INT8>(a, pairs, split, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, K*G, D] bf16; caches [B, S, K, D]; scales [B, K, S] fp32 (int8
// only); k_new/v_new [B, K, D] bf16; bias [B, S] fp32; out [B, K*G, D]
// bf16 or fp32. The fill level is *fill_dev when fill_dev is not null,
// else fill_host. `split` (1, 2, 4 or 8) blocks per (batch, kv head)
// pair share the cache's columns as one cluster.
extern "C" int dla_decode_attention(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* kn, const void* vn, const void* bias,
    void* out, const void* fill_dev, int B, int S, int K, int G, int D,
    int fill_host, int split, int cache_int8, float scale, float softcap,
    int out_bf16, void* stream) {
  if (G < 1 || G > GMAX || split < 1 || split > 8 || (split & (split - 1)) ||
      B < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.kc = kc, a.vc = vc;
  a.ks = static_cast<const float*>(ks), a.vs = static_cast<const float*>(vs);
  a.kn = static_cast<const bf16*>(kn), a.vn = static_cast<const bf16*>(vn);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.fill_dev = static_cast<const int*>(fill_dev);
  a.fill_host = fill_host;
  a.S = S, a.K = K, a.G = G;
  a.cols = ((S + split - 1) / split + SL - 1) / SL * SL;
  a.scale = scale, a.softcap = softcap, a.out_bf16 = out_bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_int8) return dispatch<true>(D, a, B * K, split, st);
  return dispatch<false>(D, a, B * K, split, st);
}

// dynamic shared memory per block, by head dim and cache type
extern "C" int dla_decode_attention_smem_bytes(int D, int cache_int8) {
  switch (D) {
    case 64: return cache_int8 ? Cfg<64, true>::SMEM : Cfg<64, false>::SMEM;
    case 80: return cache_int8 ? Cfg<80, true>::SMEM : Cfg<80, false>::SMEM;
    case 96: return cache_int8 ? Cfg<96, true>::SMEM : Cfg<96, false>::SMEM;
    case 128:
      return cache_int8 ? Cfg<128, true>::SMEM : Cfg<128, false>::SMEM;
    case 256:
      return cache_int8 ? Cfg<256, true>::SMEM : Cfg<256, false>::SMEM;
  }
  return -1;
}
