// Causal flash-attention backward: dQ, and dK/dV summed over each GQA
// group, recomputing the probabilities tile by tile from the forward's
// per-row log-sum-exp (FlashAttention-2 style; no [T, S] buffer).
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
// balance point, so tensor-core operations bound both.
//
// Design: the TPU's sequential grid axis becomes a loop inside the block,
// so each output tile is owned by one block and nothing is summed across
// blocks (no atomics: the gradients are deterministic).
//  - dQ: one block of 4 warps per (batch, query head, 64-row query tile),
//    looping over the live 64-column K/V tiles; each warp owns 16 query
//    rows and keeps their dQ accumulator in mma.sync registers.
//  - dK/dV: one block per (batch, kv head, 64-row key tile), looping over
//    (group member, query tile) pairs, so dK and dV accumulate per kv
//    head and no [B, H, S, D] per-query-head buffer exists; each warp
//    owns 16 keys and computes the transposed tiles S^T = K Q^T and
//    dP^T = V dO^T directly, so P^T and dS^T feed the next products as
//    register A fragments with no transpose through shared memory.
// Both stage their four operand tiles (Q, dO, K, V) in dynamic shared
// memory rather than registers: with two fp32 [16, D] accumulators per
// warp (dK/dV at D = 128) the register file is the tighter resource.
// Tiles above the diagonal or outside the window are skipped (the Pallas
// `_block_live` rule); ragged T and S tails are masked. Not yet: a
// cp.async/TMA pipeline, wgmma, ldmatrix fragment loads, and staging the
// segment ids in shared memory.
#include "common.cuh"

namespace {

using dla::bf16;
using dla::Strides;

constexpr int BQ = 64, BK = 64, THREADS = 128;

template <int D>
constexpr int tile_bytes() {
  return 64 * (D + 8) * (int)sizeof(bf16);
}

// A fragment (16 x 16, rows r0.., cols c0..) of a row-major tile in smem
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int r0, int c0, int gid, int tig) {
  const bf16* p = &t[(r0 + gid) * LD + c0 + tig * 2];
  a[0] = dla::ld32(p);
  a[1] = dla::ld32(p + 8 * LD);
  a[2] = dla::ld32(p + 8);
  a[3] = dla::ld32(p + 8 * LD + 8);
}

// acc[nt] += A(16 x 16) * B where B[k][n] = t[n0 + n][c0 + k]: the tile's
// rows are the product's output columns (Q K^T, dO V^T and transposes)
template <int LD, int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4],
                                         const uint32_t (&a)[4], const bf16* t,
                                         int c0, int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const bf16* p = &t[(nt * 8 + gid) * LD + c0 + tig * 2];
    dla::mma_16816(acc[nt], a, dla::ld32(p), dla::ld32(p + 8));
  }
}

// acc[nt] += A(16 x 16) * B where B[k][n] = t[r0 + k][nt * 8 + n]: the
// tile's columns are the product's output columns (P V, dS K, P^T dO, ...)
template <int LD, int NT>
__device__ __forceinline__ void mma_cols(float (&acc)[NT][4],
                                         const uint32_t (&a)[4], const bf16* t,
                                         int r0, int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const bf16* p = &t[(r0 + tig * 2) * LD + nt * 8 + gid];
    dla::mma_16816(acc[nt], a, dla::pack_raw(p[0], p[LD]),
                   dla::pack_raw(p[8 * LD], p[9 * LD]));
  }
}

// the A fragment of columns [16 kk, 16 kk + 16) of a 16-row fp32
// accumulator tile, rounded to bf16 (the C -> A layouts line up)
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[NT][4], int kk) {
  a[0] = dla::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = dla::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = dla::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = dla::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, Strides st, int b,
                                           int h, const int (&row)[2],
                                           int rows, const float (&acc)[D / 8][4],
                                           float mul, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= rows) continue;
    bf16* p = dst + b * st.b + h * st.h + (long long)row[r] * st.t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(&p[nt * 8 + tig * 2]) =
          dla::pack_bf16(acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qseg, const int* __restrict__ kseg,
                    bf16* __restrict__ dq, int H, int KH, int T, int S,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Strides dqs, float scale, int window) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + BQ * LD;
  bf16* k_s = do_s + BQ * LD;
  bf16* v_s = k_s + BK * LD;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;

  dla::load_rows<D, BQ, THREADS>(q_s, q, qs, b, h, q0, T);
  dla::load_rows<D, BQ, THREADS>(do_s, dout, dos, b, h, q0, T);

  const int row[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  int seg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    const long long i = ((long long)b * H + h) * T + row[r];
    lse_r[r] = lse[i];
    delta_r[r] = delta[i];
    if (qseg != nullptr) seg[r] = qseg[(long long)b * T + row[r]];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int n_tiles = (S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    if (k0 > q0 + BQ - 1) break;  // above the diagonal: this and all later
    if (window > 0 && !(q0 - k0 - BK + 1 < window)) continue;
    __syncthreads();  // every warp is done with the previous K/V tile
    dla::load_rows<D, BK, THREADS>(k_s, k, ks, b, kh, k0, S);
    dla::load_rows<D, BK, THREADS>(v_s, v, vs, b, kh, k0, S);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a<LD>(a, q_s, warp * 16, kk * 16, gid, tig);
      mma_rows<LD>(s, a, k_s, kk * 16, gid, tig);      // Q K^T
      load_a<LD>(a, do_s, warp * 16, kk * 16, gid, tig);
      mma_rows<LD>(dp, a, v_s, kk * 16, gid, tig);     // dO V^T
    }
    // rows row[0] -> e 0,1; row[1] -> e 2,3; s becomes ds
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, col = k0 + nt * 8 + tig * 2 + (e % 2);
        bool ok = col <= row[r] && col < S && row[r] < T;
        if (window > 0) ok = ok && (row[r] - col < window);
        if (qseg != nullptr && ok) ok = seg[r] == kseg[(long long)b * S + col];
        const float p = ok ? __expf(s[nt][e] * scale - lse_r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[r]);
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
      mma_cols<LD>(acc, a, k_s, kk * 16, gid, tig);    // dS K
    }
  }
  store_rows<D>(dq, dqs, b, h, row, T, acc, scale, tig);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ qseg, const int* __restrict__ kseg,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                     int KH, int T, int S, Strides qs, Strides ks, Strides vs,
                     Strides dos, Strides dks, Strides dvs, float scale,
                     int window) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + BK * LD;
  bf16* q_s = v_s + BK * LD;
  bf16* do_s = q_s + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * LD);
  float* delta_s = lse_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ);
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BK;
  const int G = H / KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;

  dla::load_rows<D, BK, THREADS>(k_s, k, ks, b, kvh, k0, S);
  dla::load_rows<D, BK, THREADS>(v_s, v, vs, b, kvh, k0, S);

  const int key[2] = {k0 + warp * 16 + gid, k0 + warp * 16 + gid + 8};
  int kseg_r[2] = {0, 0};
  if (qseg != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (key[r] < S) kseg_r[r] = kseg[(long long)b * S + key[r]];
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int n_qt = (T + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    // query tiles before k0 / BQ lie entirely above the diagonal
    for (int it = k0 / BQ; it < n_qt; ++it) {
      const int q0 = it * BQ;
      if (window > 0 && !(q0 - k0 - BK + 1 < window)) break;  // and later
      __syncthreads();  // every warp is done with the previous Q/dO tile
      dla::load_rows<D, BQ, THREADS>(q_s, q, qs, b, h, q0, T);
      dla::load_rows<D, BQ, THREADS>(do_s, dout, dos, b, h, q0, T);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const int r = q0 + i;
        const long long li = ((long long)b * H + h) * T + r;
        lse_s[i] = r < T ? lse[li] : 0.f;
        delta_s[i] = r < T ? delta[li] : 0.f;
        qseg_s[i] = (qseg != nullptr && r < T) ? qseg[(long long)b * T + r]
                                               : 0;
      }
      __syncthreads();

      // transposed tiles: rows = this warp's 16 keys, cols = 64 queries
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        load_a<LD>(a, k_s, warp * 16, kk * 16, gid, tig);
        mma_rows<LD>(s, a, q_s, kk * 16, gid, tig);    // K Q^T
        load_a<LD>(a, v_s, warp * 16, kk * 16, gid, tig);
        mma_rows<LD>(dp, a, do_s, kk * 16, gid, tig);  // V dO^T
      }
      // s becomes p^T, dp becomes ds^T
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, qc = nt * 8 + tig * 2 + (e % 2);
          const int qrow = q0 + qc;
          bool ok = qrow >= key[r] && qrow < T && key[r] < S;
          if (window > 0) ok = ok && (qrow - key[r] < window);
          if (qseg != nullptr) ok = ok && qseg_s[qc] == kseg_r[r];
          const float p = ok ? __expf(s[nt][e] * scale - lse_s[qc]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - delta_s[qc]);
        }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s, kk);
        mma_cols<LD>(dv_acc, a, do_s, kk * 16, gid, tig);  // P^T dO
        acc_to_a(a, dp, kk);
        mma_cols<LD>(dk_acc, a, q_s, kk * 16, gid, tig);   // dS^T Q
      }
    }
  }
  store_rows<D>(dk, dks, b, kvh, key, S, dk_acc, scale, tig);
  store_rows<D>(dv, dvs, b, kvh, key, S, dv_acc, 1.f, tig);
}

inline Strides st_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* qseg,
              const int* kseg, void* dq, int B, int H, int KH, int T, int S,
              const long long* st, float scale, int window,
              cudaStream_t stream) {
  constexpr int smem = 4 * tile_bytes<D>();
  cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      qseg, kseg, static_cast<bf16*>(dq), H, KH, T, S, st_at(st, 0),
      st_at(st, 1), st_at(st, 2), st_at(st, 3), st_at(st, 4), scale, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* qseg,
               const int* kseg, void* dk, void* dv, int B, int H, int KH,
               int T, int S, const long long* st, float scale, int window,
               cudaStream_t stream) {
  constexpr int smem = 4 * tile_bytes<D>() + 3 * BQ * 4;
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((S + BK - 1) / BK, KH, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      qseg, kseg, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KH, T, S,
      st_at(st, 0), st_at(st, 1), st_at(st, 2), st_at(st, 3), st_at(st, 4),
      st_at(st, 5), scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 15 element strides (b, head, row) of q, k, v, dout, dq
extern "C" int dla_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* qseg,
                                const void* kseg, void* dq, int B, int H,
                                int KH, int T, int S, int D,
                                const long long* strides, float scale,
                                int window, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kseg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, l, dl, qs, ks, dq, B, H, KH, T, S,
                         strides, scale, window, s);
  if (D == 96)
    return launch_dq<96>(q, k, v, dout, l, dl, qs, ks, dq, B, H, KH, T, S,
                         strides, scale, window, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, l, dl, qs, ks, dq, B, H, KH, T, S,
                          strides, scale, window, s);
  return (int)cudaErrorInvalidValue;
}

// strides: 18 element strides (b, head, row) of q, k, v, dout, dk, dv
extern "C" int dla_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* qseg,
                                 const void* kseg, void* dk, void* dv, int B,
                                 int H, int KH, int T, int S, int D,
                                 const long long* strides, float scale,
                                 int window, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kseg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, l, dl, qs, ks, dk, dv, B, H, KH, T,
                          S, strides, scale, window, s);
  if (D == 96)
    return launch_dkv<96>(q, k, v, dout, l, dl, qs, ks, dk, dv, B, H, KH, T,
                          S, strides, scale, window, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, l, dl, qs, ks, dk, dv, B, H, KH, T,
                           S, strides, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
