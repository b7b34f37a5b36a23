// The fused categorical draw: jax.random.categorical's threefry bits,
// uniform, gumbel and argmax in one pass over the filtered logits.
//
// Replaces no Pallas kernel: the JAX package draws with
// jax.random.categorical (dla_tpu/ops/sampling.py:sample_token and
// sample_token_per_row) and leaves the ~150 elementwise integer passes
// to XLA, which fuses them. The plain version is
// dla_tpu_torch/ops/prng.py (categorical / categorical_per_row).
//
// Per element j of row i: bits = w0 ^ w1 of threefry2x32(key, (hi(c),
// lo(c))), c the counter; u = max(tiny, (float in [1, 2) of the top 23
// bits) - 1 + tiny); g = -logf(-logf(u)) (precise logf, never __logf);
// v = g + logit. The token is the argmax of v over the row, the lowest
// index winning ties and a NaN beating every number (jnp.argmax's rule).
// Counters: batch mode (one key) runs c over the flattened [B, V], so
// row i starts at i * V; per-row mode (jax.vmap of categorical over
// rows) runs c over 0..V-1 under the row's key fold_in(PRNGKey(seed_i),
// position_i), derived here from the seed and position on the device.
//
// Bound: it reads the fp32 logits once (B * V * 4 bytes: 32.8 MB at the
// rollout's [64, 128256], 0.0098 ms at 3.35 TB/s) and does ~90 integer
// and float operations an element (20 threefry rounds of add, rotate,
// xor, five key injections, two logs), 0.74 G at that shape: by
// operations on the CUDA cores. Design: grid (chunks of a row, rows);
// each thread walks its elements with a stride of the block (coalesced
// loads), keeps its best (value, index), the block reduces by warp
// shuffles, one partial per block; a second kernel, one warp per row,
// reduces the row's partials to the token. Keys and seeds are read from
// device memory and nothing is decided on the host, so the draw is
// captured in the decode step's CUDA graph.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;   // elements of a row per block
constexpr float kTiny = 1.17549435e-38f;      // float32 smallest normal

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// jax._src.prng threefry2x32: 20 rounds, key schedule k0, k1, k0^k1^C
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
  return -logf(-logf(u));
}

// (va, ia) ranks before (vb, ib): jnp.argmax's order
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  const bool an = va != va, bn = vb != vb;
  if (an != bn) return an;
  if (!an && va != vb) return va > vb;
  return ia < ib;
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) v = ov, i = oi;
  }
}

struct Args {
  const float* logits;        // [B, V] fp32, rows contiguous
  const long long* key;       // [2] (batch mode) or null
  const long long* seeds;     // [B] uint32 values (per-row mode) or null
  const long long* positions; // [B] (per-row mode) or null
  float* part_v;              // [B, chunks]
  int* part_i;
  int* out;                   // [B] int32 tokens
  float* noise;               // [B, V] gumbel values, or null
  int V, chunks;
};

__global__ void __launch_bounds__(THREADS)
draw_partial_kernel(Args a) {
  const int row = blockIdx.y, chunk = blockIdx.x;
  uint32_t k0, k1;
  unsigned long long base;
  if (a.key != nullptr) {          // one key; counters over [B, V]
    k0 = (uint32_t)a.key[0];
    k1 = (uint32_t)a.key[1];
    base = (unsigned long long)row * (unsigned long long)a.V;
  } else {                         // fold_in(PRNGKey(seed), position)
    uint32_t x0 = 0u, x1 = (uint32_t)a.positions[row];
    threefry2x32(0u, (uint32_t)a.seeds[row], x0, x1);
    k0 = x0, k1 = x1;
    base = 0ull;
  }
  const float* lg = a.logits + (long long)row * a.V;
  float* nz = a.noise ? a.noise + (long long)row * a.V : nullptr;
  const int lo = chunk * CHUNK;
  const int hi = min(a.V, lo + CHUNK);
  float best_v = -INFINITY;
  int best_i = 0x7fffffff;
  for (int j = lo + threadIdx.x; j < hi; j += THREADS) {
    const unsigned long long c = base + (unsigned long long)j;
    uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
    threefry2x32(k0, k1, x0, x1);
    const float g = gumbel_of(x0 ^ x1);
    if (nz) nz[j] = g;
    const float v = __fadd_rn(g, lg[j]);
    if (better(v, j, best_v, best_i)) best_v = v, best_i = j;
  }
  warp_best(best_v, best_i);
  __shared__ float sv[THREADS / 32];
  __shared__ int si[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) sv[warp] = best_v, si[warp] = best_i;
  __syncthreads();
  if (warp == 0) {
    best_v = lane < THREADS / 32 ? sv[lane] : -INFINITY;
    best_i = lane < THREADS / 32 ? si[lane] : 0x7fffffff;
    warp_best(best_v, best_i);
    if (lane == 0) {
      a.part_v[row * a.chunks + chunk] = best_v;
      a.part_i[row * a.chunks + chunk] = best_i;
    }
  }
}

__global__ void draw_final_kernel(Args a) {
  const int row = blockIdx.x, lane = threadIdx.x;
  float best_v = -INFINITY;
  int best_i = 0x7fffffff;
  for (int c = lane; c < a.chunks; c += 32) {
    const float v = a.part_v[row * a.chunks + c];
    const int i = a.part_i[row * a.chunks + c];
    if (better(v, i, best_v, best_i)) best_v = v, best_i = i;
  }
  warp_best(best_v, best_i);
  if (lane == 0) a.out[row] = best_i;
}

}  // namespace

// partials per row: the scratch the caller allocates is [B, chunks] of
// fp32 values and of int32 indices
extern "C" int dla_categorical_draw_chunks(int V) {
  return (V + CHUNK - 1) / CHUNK;
}

// One draw of B tokens. Batch mode: `key` [2] int64 (uint32 words),
// `seeds` and `positions` null. Per-row mode: `key` null, `seeds` [B]
// and `positions` [B] int64. `noise` (optional) receives the gumbel
// values. Returns cudaGetLastError() of the two launches.
extern "C" int dla_categorical_draw(const void* logits, const void* key,
                                    const void* seeds, const void* positions,
                                    void* part_v, void* part_i, void* out,
                                    void* noise, int B, int V, void* stream) {
  if (B < 1 || V < 1 || B > 65535 ||
      (key == nullptr) == (seeds == nullptr || positions == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.logits = static_cast<const float*>(logits);
  a.key = static_cast<const long long*>(key);
  a.seeds = static_cast<const long long*>(seeds);
  a.positions = static_cast<const long long*>(positions);
  a.part_v = static_cast<float*>(part_v);
  a.part_i = static_cast<int*>(part_i);
  a.out = static_cast<int*>(out);
  a.noise = static_cast<float*>(noise);
  a.V = V;
  a.chunks = dla_categorical_draw_chunks(V);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  draw_partial_kernel<<<dim3(a.chunks, B), THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  draw_final_kernel<<<B, 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}
