// Shared device helpers for the port's hand-written Hopper kernels.
//
// The products use the warp-level tensor-core instruction
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulation), whose register
// fragment layout is fixed by PTX, so a kernel can rescale and mask
// accumulators in registers (the flash-attention online softmax needs
// that). For a warp lane: gid = lane / 4, tig = lane % 4.
//   A (16x16, row-major): reg0 = A[gid][2tig..+1], reg1 = A[gid+8][2tig..+1],
//                         reg2 = A[gid][2tig+8..+9], reg3 = A[gid+8][2tig+8..+9]
//   B (16x8, B[k][n]):    reg0 = B[2tig..+1][gid], reg1 = B[2tig+8..+9][gid]
//   C (16x8, fp32):       c0,c1 = C[gid][2tig..+1], c2,c3 = C[gid+8][2tig..+1]
// Each 32-bit register holds two bf16 values, the lower index in the low
// half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dla {

constexpr float kNegInf = -1e30f;  // finite: fully masked rows stay finite

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 already in memory -> bf16x2, `lo` in the low half
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  uint32_t l = *reinterpret_cast<const uint16_t*>(&lo);
  uint32_t h = *reinterpret_cast<const uint16_t*>(&hi);
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// round a float to the nearest bf16 and back (the "cast to bf16" of a
// dequantized value before it meets a product)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Strides {  // element strides of a [B, heads, rows, D] view
  long long b, h, t;
};

// Stage rows [r0, r0 + ROWS) of head h of batch b into shared memory with
// a padded row pitch of D + 8 (conflict-free mma fragment reads); rows at
// or past `rows` are zero-filled. 16-byte loads: the head dim must be
// contiguous and the row strides multiples of 8 elements.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          Strides st, int b, int h, int r0,
                                          int rows) {
  constexpr int LD = D + 8, CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows)
      v = *reinterpret_cast<const uint4*>(
          src + b * st.b + h * st.h + (long long)(r0 + r) * st.t + cc);
    *reinterpret_cast<uint4*>(&dst[r * LD + cc]) = v;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace dla
