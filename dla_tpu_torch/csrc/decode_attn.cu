// Single-token decode attention over a contiguous KV cache (bf16 or int8
// with K-major fp32 scales), joint softmax with the new token's k/v.
//
// Replaces the Pallas kernel `_body` / `_call` in
// dla_tpu/ops/decode_kernel.py (pallas_call at :201).
//
// What bounds it on an H100: each cache byte meets g = H / KH query rows,
// a few operations per byte, so the cache bytes read from HBM bound it.
//
// Design (flash-decoding): the TPU kernel walks S sequentially inside
// one grid row per batch element; at B = 64 and KH = 8 that is 512
// blocks' worth of work, which on 132 SMs leaves long S serial. Here S is
// split into 64-column chunks: one block per (chunk, kv head, batch)
// handles all g query heads of that kv head, so every cache byte is read
// once. Only chunks below the fill level are launched; columns at or
// past it are never read, and inside the fill's chunk their scores are
// replaced by -1e30 and their values skipped (they may hold NaN). int8
// K/V are dequantized in registers with the K-major scale
// scale[b, kh, s], rounded to bf16 as the Pallas kernel does, then meet
// the bf16-rounded query in fp32. Each chunk writes its unnormalised
// output with its max and sum; a second small kernel merges the chunks by
// log-sum-exp together with the new token's own column, which therefore
// joins exactly once. Softcap applies to the scaled score before the
// additive bias. Not yet: vectorised int8 value loads and tensor-core
// products, which long caches at large g would want.
#include "common.cuh"

namespace {

using dla::bf16;

constexpr int CS = 64, THREADS = 128, GMAX = 8;

template <int D, bool INT8>
__global__ void __launch_bounds__(THREADS)
decode_chunk_kernel(const bf16* __restrict__ q, const void* __restrict__ kc,
                    const void* __restrict__ vc,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const float* __restrict__ bias, float* __restrict__ ws,
                    int S, int K, int G, int bound, int nch, float scale,
                    float softcap) {
  constexpr int EPL = D / 32;  // key elements per lane
  __shared__ float q_s[GMAX][D];
  __shared__ float sc[GMAX][CS];
  __shared__ float mrow[GMAX], lrow[GMAX];
  const int chunk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = chunk * CS;
  const size_t scale_row = ((size_t)b * K + kh) * S;

  for (int i = tid; i < G * D; i += THREADS)
    q_s[i / D][i % D] =
        __bfloat162float(q[((size_t)b * K * G + (size_t)kh * G) * D + i]);
  __syncthreads();

  // scores: warp w takes columns w, w + 4, ...; lanes split the head dim
  for (int cl = warp; cl < CS; cl += THREADS / 32) {
    const int c = c0 + cl;
    if (c >= bound) {
      if (lane < G) sc[lane][cl] = dla::kNegInf;  // replaced, not bias-added
      continue;
    }
    const size_t base = (((size_t)b * S + c) * K + kh) * D + lane * EPL;
    float kv[EPL];
    if (INT8) {
      const int8_t* k8 = static_cast<const int8_t*>(kc) + base;
      const float sk = kscale[scale_row + c];
#pragma unroll
      for (int i = 0; i < EPL; ++i) kv[i] = dla::round_bf16((float)k8[i] * sk);
    } else {
      const bf16* kb = static_cast<const bf16*>(kc) + base;
#pragma unroll
      for (int i = 0; i < EPL; ++i) kv[i] = __bfloat162float(kb[i]);
    }
    const float bc = bias[(size_t)b * S + c];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      if (j >= G) break;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) part += q_s[j][lane * EPL + i] * kv[i];
      part = dla::warp_sum(part);
      float s = part * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if (lane == 0) sc[j][cl] = s + bc;
    }
  }
  __syncthreads();

  // chunk-local softmax statistics; p rounded to bf16 for the value product
  for (int j = warp; j < G; j += THREADS / 32) {
    const float a = sc[j][lane], bb = sc[j][lane + 32];
    const float mx = dla::warp_max(fmaxf(a, bb));
    const float pa = c0 + lane < bound ? __expf(a - mx) : 0.f;
    const float pb = c0 + lane + 32 < bound ? __expf(bb - mx) : 0.f;
    const float sum = dla::warp_sum(pa + pb);
    sc[j][lane] = dla::round_bf16(pa);
    sc[j][lane + 32] = dla::round_bf16(pb);
    if (lane == 0) {
      mrow[j] = mx;
      lrow[j] = sum;
    }
  }
  __syncthreads();

  const int nvalid = min(CS, bound - c0);
  const size_t out_base = ((size_t)b * K + kh) * nch + chunk;
  for (int d = tid; d < D; d += THREADS) {
    float acc[GMAX];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) acc[j] = 0.f;
    for (int cl = 0; cl < nvalid; ++cl) {
      const int c = c0 + cl;
      const size_t idx = (((size_t)b * S + c) * K + kh) * D + d;
      const float vv =
          INT8 ? dla::round_bf16((float)static_cast<const int8_t*>(vc)[idx] *
                                 vscale[scale_row + c])
               : __bfloat162float(static_cast<const bf16*>(vc)[idx]);
#pragma unroll
      for (int j = 0; j < GMAX; ++j)
        if (j < G) acc[j] += sc[j][cl] * vv;
    }
#pragma unroll
    for (int j = 0; j < GMAX; ++j)
      if (j < G) ws[(out_base * G + j) * (D + 2) + d] = acc[j];
  }
  if (tid < G) {
    ws[(out_base * G + tid) * (D + 2) + D] = mrow[tid];
    ws[(out_base * G + tid) * (D + 2) + D + 1] = lrow[tid];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
                    const bf16* __restrict__ vn, const float* __restrict__ ws,
                    void* __restrict__ out, int K, int G, int nch, float scale,
                    float softcap, int out_bf16) {
  __shared__ float s_self[GMAX];
  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t head0 = (size_t)b * K * G + (size_t)kh * G;
  const size_t kv_row = ((size_t)b * K + kh) * D;

  // the new token's own column: always unmasked (delta 0)
  for (int j = warp; j < G; j += THREADS / 32) {
    float part = 0.f;
    for (int d = lane; d < D; d += 32)
      part += __bfloat162float(q[(head0 + j) * D + d]) *
              __bfloat162float(kn[kv_row + d]);
    part = dla::warp_sum(part);
    float s = part * scale;
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    if (lane == 0) s_self[j] = s;
  }
  __syncthreads();

  const size_t chunk0 = ((size_t)b * K + kh) * nch;
  for (int d = tid; d < D; d += THREADS) {
    const float v_self = __bfloat162float(vn[kv_row + d]);
    for (int j = 0; j < G; ++j) {
      float mx = s_self[j];
      for (int c = 0; c < nch; ++c)
        mx = fmaxf(mx, ws[((chunk0 + c) * G + j) * (D + 2) + D]);
      const float e = __expf(s_self[j] - mx);
      float l = e, acc = e * v_self;
      for (int c = 0; c < nch; ++c) {
        const float* part = ws + ((chunk0 + c) * G + j) * (D + 2);
        const float f = __expf(part[D] - mx);
        l += f * part[D + 1];
        acc += f * part[d];
      }
      const float o = acc / l;
      if (out_bf16)
        static_cast<bf16*>(out)[(head0 + j) * D + d] = __float2bfloat16_rn(o);
      else
        static_cast<float*>(out)[(head0 + j) * D + d] = o;
    }
  }
}

template <int D, bool INT8>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* kn, const void* vn, const void* bias,
           void* ws, void* out, int B, int S, int K, int G, int bound,
           float scale, float softcap, int out_bf16, cudaStream_t stream) {
  const int nch = (bound + CS - 1) / CS;
  const bf16* qb = static_cast<const bf16*>(q);
  float* w = static_cast<float*>(ws);
  if (nch > 0) {
    decode_chunk_kernel<D, INT8><<<dim3(nch, K, B), THREADS, 0, stream>>>(
        qb, kc, vc, static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const float*>(bias), w, S,
        K, G, bound, nch, scale, softcap);
  }
  decode_merge_kernel<D><<<dim3(K, B), THREADS, 0, stream>>>(
      qb, static_cast<const bf16*>(kn), static_cast<const bf16*>(vn), w, out,
      K, G, nch, scale, softcap, out_bf16);
  return (int)cudaGetLastError();
}

template <bool INT8>
int dispatch(int D, const void* q, const void* kc, const void* vc,
             const void* ks, const void* vs, const void* kn, const void* vn,
             const void* bias, void* ws, void* out, int B, int S, int K,
             int G, int bound, float scale, float softcap, int out_bf16,
             cudaStream_t st) {
  if (D == 64)
    return launch<64, INT8>(q, kc, vc, ks, vs, kn, vn, bias, ws, out, B, S,
                            K, G, bound, scale, softcap, out_bf16, st);
  if (D == 96)
    return launch<96, INT8>(q, kc, vc, ks, vs, kn, vn, bias, ws, out, B, S,
                            K, G, bound, scale, softcap, out_bf16, st);
  if (D == 128)
    return launch<128, INT8>(q, kc, vc, ks, vs, kn, vn, bias, ws, out, B, S,
                             K, G, bound, scale, softcap, out_bf16, st);
  if (D == 256)
    return launch<256, INT8>(q, kc, vc, ks, vs, kn, vn, bias, ws, out, B, S,
                             K, G, bound, scale, softcap, out_bf16, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, K*G, D] bf16; caches [B, S, K, D]; scales [B, K, S] fp32 (int8
// only); k_new/v_new [B, K, D] bf16; bias [B, S] fp32; ws holds
// B*K*ceil(bound/64)*G*(D+2) floats; out [B, K*G, D] bf16 or fp32.
extern "C" int dla_decode_attention(const void* q, const void* kc,
                                    const void* vc, const void* ks,
                                    const void* vs, const void* kn,
                                    const void* vn, const void* bias, void* ws,
                                    void* out, int B, int S, int K, int G,
                                    int D, int bound, int cache_int8,
                                    float scale, float softcap, int out_bf16,
                                    void* stream) {
  if (G < 1 || G > GMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_int8)
    return dispatch<true>(D, q, kc, vc, ks, vs, kn, vn, bias, ws, out, B, S,
                          K, G, bound, scale, softcap, out_bf16, st);
  return dispatch<false>(D, q, kc, vc, ks, vs, kn, vn, bias, ws, out, B, S, K,
                         G, bound, scale, softcap, out_bf16, st);
}
