// Causal flash-attention forward: out = softmax(mask(q k^T * scale)) v and
// the per-row log-sum-exp, blockwise with an online softmax.
//
// Replaces the Pallas kernel `_flash_kernel` / `_flash_forward` in
// dla_tpu/ops/flash_attention.py (pallas_call at :227).
//
// What bounds it on an H100: at the rollout prefill (T = 128, D = 128)
// the causal work is ~64 operations per byte of q/k/v/out, under the
// ~295 flop/byte bf16 balance point, so HBM bytes bound it; at long T the
// T^2 products take over and tensor-core operations bound it.
//
// Design: one block of 4 warps per (batch, query head, 64-row query
// tile); each warp owns 16 query rows, keeps them as mma.sync A
// fragments in registers, and loops over 64-row K/V tiles staged in
// shared memory. Scores, the running max/sum and the output accumulator
// stay in registers (the m16n8k16 fragment layout is known, so rows are
// rescaled in place): HBM sees q, k, v once per (query tile, kv head
// member) and the output once. GQA: query head h reads kv head
// h / (H / KH). Tiles entirely above the causal diagonal or outside the
// sliding window are skipped (the Pallas `_block_live` rule); ragged T
// and S tails are masked instead of being forced to tile multiples. The
// masked probability is an explicit zero — p = where(mask, exp(s - m), 0)
// — so a tile that masks a whole row leaves it inert. Optional [B, T] /
// [B, S] int32 segment ids restrict attention to equal ids (packing).
// Not yet: a K/V cp.async/TMA pipeline, wgmma, and the warp
// specialisation that long-T training shapes need.
#include "common.cuh"

namespace {

using dla::bf16;
using dla::Strides;

constexpr int BQ = 64, BKV = 64, THREADS = 128;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int KH, int T, int S,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale,
                 int window) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) bf16 k_s[BKV * LD];
  __shared__ __align__(16) bf16 v_s[BKV * LD];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;

  // the query tile goes through shared memory into A fragments
  dla::load_rows<D, BQ, THREADS>(k_s, q, qs, b, h, q0, T);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p = &k_s[(warp * 16 + gid) * LD + kk * 16 + tig * 2];
    qa[kk][0] = dla::ld32(p);
    qa[kk][1] = dla::ld32(p + 8 * LD);
    qa[kk][2] = dla::ld32(p + 8);
    qa[kk][3] = dla::ld32(p + 8 * LD + 8);
  }
  __syncthreads();

  const int row[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  int seg[2] = {0, 0};
  if (qseg != nullptr) {
    for (int r = 0; r < 2; ++r)
      if (row[r] < T) seg[r] = qseg[(long long)b * T + row[r]];
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {dla::kNegInf, dla::kNegInf}, l[2] = {0.f, 0.f};

  const int n_tiles = (S + BKV - 1) / BKV;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;
    if (k0 > q0 + BQ - 1) break;  // above the diagonal: this and all later
    if (window > 0 && !(q0 - k0 - BKV + 1 < window)) continue;
    dla::load_rows<D, BKV, THREADS>(k_s, k, ks, b, kh, k0, S);
    dla::load_rows<D, BKV, THREADS>(v_s, v, vs, b, kh, k0, S);
    __syncthreads();

    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* p = &k_s[(nt * 8 + gid) * LD + kk * 16 + tig * 2];
        dla::mma_16816(s[nt], qa[kk], dla::ld32(p), dla::ld32(p + 8));
      }
    }

    // mask, scale, online softmax (rows row[0] -> e 0,1; row[1] -> e 2,3)
    uint32_t live = 0;  // bit (nt * 4 + e): entry unmasked
    float mx[2] = {dla::kNegInf, dla::kNegInf};
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, col = k0 + nt * 8 + tig * 2 + (e % 2);
        bool ok = col <= row[r] && col < S;
        if (window > 0) ok = ok && (row[r] - col < window);
        if (qseg != nullptr && ok)
          ok = row[r] < T && seg[r] == kseg[(long long)b * S + col];
        s[nt][e] = ok ? s[nt][e] * scale : dla::kNegInf;
        if (ok) live |= 1u << (nt * 4 + e);
        mx[r] = fmaxf(mx[r], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const float p = (live >> (nt * 4 + e)) & 1u ? __expf(s[nt][e] - m[r]) : 0.f;
        s[nt][e] = p;
        l[r] += p;  // this lane's columns; lanes of a row are summed at the end
      }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }
    // P (bf16, as the Pallas kernel casts it) @ V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = dla::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = dla::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = dla::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = dla::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const bf16* p = &v_s[(kk * 16 + tig * 2) * LD + nt * 8 + gid];
        dla::mma_16816(o[nt], pa, dla::pack_raw(p[0], p[LD]),
                       dla::pack_raw(p[8 * LD], p[9 * LD]));
      }
    }
    __syncthreads();  // all warps done with k_s / v_s before the next load
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float safe = lt == 0.f ? 1.f : lt;
    if (row[r] >= T) continue;
    const float inv = 1.f / safe;
    bf16* dst = out + b * os.b + h * os.h + (long long)row[r] * os.t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(&dst[nt * 8 + tig * 2]) =
          dla::pack_bf16(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    if (tig == 0) lse[((long long)b * H + h) * T + row[r]] = m[r] + logf(safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* qseg,
           const int* kseg, void* out, float* lse, int B, int H, int KH,
           int T, int S, const long long* st, float scale, int window,
           cudaStream_t stream) {
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), qseg, kseg, static_cast<bf16*>(out), lse,
      H, KH, T, S, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides (b, head, row) of q, k, v, out in that order
extern "C" int dla_flash_fwd(const void* q, const void* k, const void* v,
                             const void* qseg, const void* kseg, void* out,
                             void* lse, int B, int H, int KH, int T, int S,
                             int D, const long long* strides, float scale,
                             int window, void* stream) {
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kseg);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, qs, ks, out, l, B, H, KH, T, S, strides, scale,
                      window, s);
  if (D == 96)
    return launch<96>(q, k, v, qs, ks, out, l, B, H, KH, T, S, strides, scale,
                      window, s);
  if (D == 128)
    return launch<128>(q, k, v, qs, ks, out, l, B, H, KH, T, S, strides,
                       scale, window, s);
  return (int)cudaErrorInvalidValue;
}
