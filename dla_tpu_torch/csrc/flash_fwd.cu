// Causal flash-attention forward: out = softmax(mask(q k^T * scale)) v and
// the per-row log-sum-exp, blockwise with an online softmax.
//
// Replaces the Pallas kernel `_flash_kernel` / `_flash_forward` in
// dla_tpu/ops/flash_attention.py (pallas_call at :227).
//
// What bounds it on an H100: at the rollout prefill (T = 128, D = 128)
// the causal work is ~64 operations per byte of q/k/v/out, under the
// ~295 flop/byte bf16 balance point, so HBM bytes bound it; at the SFT
// shape (T = 2048, D = 64) the two causal T x T x D products bound it
// (tensor-core operations), with the exp and mask work per score entry
// of the same order as a tile's products, so it has to stay small.
//
// Design (Hopper: wgmma + TMA, see hopper.cuh; the backward's structure):
//  - Work item = (batch, query head, 128 query rows). One persistent
//    block per SM walks every gridDim-th item, heaviest query tiles (most
//    live key tiles under the causal mask) first. Nothing is summed
//    across blocks: no atomics.
//  - 3 warpgroups. Warpgroup 0 is the producer: one warp loads each
//    item's Q tile by TMA into one of two buffers and keeps a STAGES-deep
//    ring of 128-key K/V tiles full (full / empty mbarriers, the ring
//    running on from one item into the next), with the keys' segment ids
//    beside each tile by cp.async, and gives its registers up
//    (setmaxnreg). So the next item's loads overlap this item's last
//    tiles and its epilogue — at the rollout prefill (T = 128) an item is
//    a single tile. Warpgroups 1 and 2 are consumers of 64 query rows
//    each, Q resident in shared memory; while one runs its softmax the
//    other's products keep the tensor cores busy.
//  - Per K/V tile a consumer computes S = Q K^T (SS wgmma, K-major), the
//    online softmax in its fp32 accumulators (one ex2.approx per entry;
//    per-row integer bounds for causal, window and ragged tails, tested
//    only on tiles that cross an edge; segment ids on a template path of
//    their own; masked probabilities an explicit zero so a fully masked
//    row stays inert), rescales O, and adds P V with P taken straight
//    from the accumulators as bf16 A fragments (RS wgmma, the Pallas
//    kernel's cast of p to v's dtype) and V read through a transposed
//    descriptor.
//  - Tiles above the diagonal or outside the window are skipped (the
//    Pallas `_block_live` rule), per block and per consumer; ragged T and
//    S tails read as zeros (TMA) and are masked. GQA: query head h reads
//    kv head h / (H / KH). Optional [B, T] / [B, S] int32 segment ids
//    restrict attention to equal ids (packing).
//  - Head dims 64 and 128 are native; 80 (phi-2) and 96 (phi3-mini) run
//    the 128 kernel through an 80- or 96-column tensor map: the second
//    64-column box starts at column 64 and TMA fills the columns past D
//    with zeros (exact zero products), and stores are masked to col < D.
//    Every map stride is a 16-byte multiple (D * 2 bytes per head).
//  - lse is [B, H, T] fp32 (natural log), -1e30 for a fully masked row,
//    as the backward kernels read it.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using dla::bf16;
using dla::Strides;
namespace hp = dla::hopper;

constexpr int BM = 128;       // query rows of a block
constexpr int BN = 128;       // keys of a streamed K/V tile
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const int* qseg;  // [B, T] or null
  const int* kseg;  // [B, S] or null
  bf16* out;
  float* lse;       // [B, H, T]
  Strides os;
  int B, H, KH, T, S, D;
  float scale;
  int window;       // 0: none
};

template <int DP>
struct FwdLayout {  // byte offsets from the 1024-aligned base
  static constexpr int STAGES = DP == 64 ? 3 : 2;
  static constexpr int QT = BM * DP * 2;   // a Q tile (two buffers)
  static constexpr int KV = BN * DP * 2;   // K or V tile
  static constexpr int Q = 0, RING = 2 * QT;
  static constexpr int STAGE = 2 * KV;     // K then V
  static constexpr int KSEG = RING + STAGES * STAGE;  // STAGES x BN ints
  // full[S], empty[S], qfull[2], qempty[2]
  static constexpr int BAR = KSEG + STAGES * BN * 4;
  static constexpr int BYTES = BAR + (2 * STAGES + 4) * 8 + 1024;
};

// any unmasked (query, key) pair in rows [q0, q0 + nq) x keys [k0, k0 + nk)
// under the causal and window rules (the Pallas `_block_live`)
__device__ __forceinline__ bool live(int q0, int nq, int k0, int nk,
                                     int window) {
  if (k0 > q0 + nq - 1) return false;
  return window == 0 || q0 - (k0 + nk - 1) < window;
}

// the dynamic shared memory rounded up to 1024 bytes (the swizzle atom)
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

// Online-softmax step of one 64 x BN score tile held as wgmma
// accumulators `s` (rows r0 / r1 of the thread: index i = nb * 4 + 2 r +
// e, column nb * 8 + 2 tig + e). Entry (row r, tile column c) is live iff
// lo[r] <= c < hi[r] and, with SEG, the segment ids agree; without MASK
// every entry is live. Updates the running max m2 (log2 domain, scaled)
// and the thread's partial sums l, returns the factor `corr` that
// rescales O, and the probabilities as bf16 A fragments `pf`.
template <bool MASK, bool SEG>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BN / 2], uint32_t (&pf)[BN / 16][4], float (&m2)[2],
    float (&l)[2], float (&corr)[2], int tig, const int (&lo)[2],
    const int (&hi)[2], const int (&seg)[2], const int* ks, float scale2) {
  float mx[2] = {dla::kNegInf, dla::kNegInf};
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    const int c = nb * 8 + tig * 2;
    int2 kseg2 = make_int2(0, 0);
    if (SEG) kseg2 = *reinterpret_cast<const int2*>(ks + c);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = nb * 4 + r * 2 + e;
        float v = s[i] * scale2;
        if (MASK) {
          bool ok = c + e >= lo[r] && c + e < hi[r];
          if (SEG) ok = ok && seg[r] == (e ? kseg2.y : kseg2.x);
          v = ok ? v : dla::kNegInf;
        }
        s[i] = v;
        mx[r] = fmaxf(mx[r], v);
      }
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m2[r], mx[r]);
    corr[r] = exp2_ftz(m2[r] - m_new);
    m2[r] = m_new;
    l[r] *= corr[r];
    // a row masked so far has m_new = -1e30 and every entry at -1e30:
    // subtracting 0 sends them to exp2(-1e30) = 0 (the explicit zero)
    mu[r] = m_new == dla::kNegInf ? 0.f : m_new;
  }
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = nb * 4 + r * 2;
      const float p0 = exp2_ftz(s[i] - mu[r]);
      const float p1 = exp2_ftz(s[i + 1] - mu[r]);
      l[r] += p0 + p1;
      pf[nb / 2][(nb % 2) * 2 + r] = dla::pack_bf16(p0, p1);
    }
}

// Work item w of a block's walk: items run heaviest query tile first
// (the most live key tiles under the causal mask), every (batch, head)
// of one query tile before the next, so the heads sharing a kv head run
// side by side and find its K/V in L2.
struct Item {
  int b, h, kh, q0;
};

__device__ __forceinline__ Item item(int w, int bh, int H, int KH, int n_qt) {
  const int r = w % bh, h = r % H;
  return Item{r / H, h, h / (H / KH), (n_qt - 1 - w / bh) * BM};
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = FwdLayout<DP>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base(smem_raw);
  const uint32_t base = hp::smem_addr(smem);
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES,
                 qfull = empty + 8 * STAGES, qempty = qfull + 16;
  const int n_qt = (a.T + BM - 1) / BM;
  const int n_items = a.B * a.H * n_qt;
  const int wg = threadIdx.x / 128;
  int* kseg_s = reinterpret_cast<int*>(smem + L::KSEG);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full + 8 * s, 32);     // the producer warp
      hp::mbar_init(empty + 8 * s, 8);     // the consumers' 8 warps
    }
    for (int q = 0; q < 2; ++q) {
      hp::mbar_init(qfull + 8 * q, 1);
      hp::mbar_init(qempty + 8 * q, 8);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    hp::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      hp::prefetch_map(&tq);
      hp::prefetch_map(&tk);
      hp::prefetch_map(&tv);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      const Item t = item(w, a.B * a.H, a.H, a.KH, n_qt);
      const int j_end = min((a.S + BN - 1) / BN, (t.q0 + BM - 1) / BN + 1);
      if (lane == 0) {  // Q into buffer it % 2 once its last item is done
        const uint32_t qb = 8 * (it & 1), qphase = (it >> 1) & 1;
        hp::mbar_wait(qempty + qb, qphase ^ 1);
        hp::mbar_arrive_expect_tx(qfull + qb, L::QT);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          hp::tma_load_4d(base + L::Q + (it & 1) * L::QT + c * BM * 128, &tq,
                          qfull + qb, c * 64, t.h, t.q0, t.b);
      }
      for (int j = 0; j < j_end; ++j) {
        const int k0 = j * BN;
        if (!live(t.q0, BM, k0, BN, a.window)) continue;
        hp::mbar_wait(empty + 8 * stage, phase ^ 1);
        if (a.qseg != nullptr) {  // the keys' segment ids, by cp.async
          int* ks = kseg_s + stage * BN;
          for (int i = lane; i < BN; i += 32) {
            if (k0 + i < a.S)
              hp::cp_async4(hp::smem_addr(ks + i),
                            a.kseg + (long long)t.b * a.S + k0 + i);
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
                            t.kh, k0, t.b);
            hp::tma_load_4d(st + L::KV + c * BN * 128, &tv, full + 8 * stage,
                            c * 64, t.kh, k0, t.b);
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
  const float scale2 = a.scale * LOG2E;
  int stage = 0;
  uint32_t phase = 0;
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const Item t = item(w, a.B * a.H, a.H, a.KH, n_qt);
    const int j_end = min((a.S + BN - 1) / BN, (t.q0 + BM - 1) / BN + 1);
    const int rw = t.q0 + cw * 64;  // this warpgroup's first row
    const int row0 = rw + warp * 16 + gid, row1 = row0 + 8;
    const uint32_t qtile = base + L::Q + (it & 1) * L::QT;
    int seg[2] = {0, 0};
    if (a.qseg != nullptr) {
      if (row0 < a.T) seg[0] = a.qseg[(long long)t.b * a.T + row0];
      if (row1 < a.T) seg[1] = a.qseg[(long long)t.b * a.T + row1];
    }
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m2[2] = {dla::kNegInf, dla::kNegInf}, l[2] = {0.f, 0.f};

    hp::mbar_wait(qfull + 8 * (it & 1), (it >> 1) & 1);
    for (int j = 0; j < j_end; ++j) {
      const int k0 = j * BN;
      if (!live(t.q0, BM, k0, BN, a.window)) continue;
      hp::mbar_wait(full + 8 * stage, phase);
      if (live(rw, 64, k0, BN, a.window) && rw < a.T) {
        const uint32_t kt = base + L::RING + stage * L::STAGE;
        float s[BN / 2];
        hp::fence_regs(s);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          hp::wgmma_ss_n128(s, desc_k<BM>(qtile, cw * 64, kk),
                               desc_k<BN>(kt, 0, kk), kk > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(s);
        // live columns of each row, local to the tile: [lo, hi)
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? row1 : row0;
          hi[r] = row < a.T ? min(row + 1, a.S) - k0 : 0;
          lo[r] = a.window > 0 ? row - a.window + 1 - k0 : 0;
        }
        // the positional mask only where the tile crosses an edge
        const bool edge = k0 + BN - 1 > rw || k0 + BN > a.S ||
                          rw + 64 > a.T ||
                          (a.window > 0 && rw + 63 - k0 >= a.window);
        const int* ks = kseg_s + stage * BN;
        uint32_t pf[BN / 16][4];
        float corr[2];
        if (a.qseg != nullptr)
          softmax_tile<true, true>(s, pf, m2, l, corr, tig, lo, hi, seg, ks,
                                   scale2);
        else if (edge)
          softmax_tile<true, false>(s, pf, m2, l, corr, tig, lo, hi, seg, ks,
                                    scale2);
        else
          softmax_tile<false, false>(s, pf, m2, l, corr, tig, lo, hi, seg,
                                     ks, scale2);
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        hp::fence_regs(o);
        hp::fence_regs(pf);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {  // O += P V
          if constexpr (DP == 64)
            hp::wgmma_rs_n64<1>(o, pf[kk], desc_mn<BN>(kt + L::KV, kk), 1);
          else
            hp::wgmma_rs_n128<1>(o, pf[kk], desc_mn<BN>(kt + L::KV, kk), 1);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(pf);
        hp::fence_regs(o);
      }
      if (lane == 0) hp::mbar_arrive(empty + 8 * stage);
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    // this item's Q tile is read: the producer may load the next but one
    if (lane == 0) hp::mbar_arrive(qempty + 8 * (it & 1));

    // out = O / l (l = 0: a fully masked row -> 0, lse -1e30), columns < D
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      if (row >= a.T) continue;
      const float inv = lt == 0.f ? 1.f : 1.f / lt;
      bf16* dst =
          a.out + t.b * a.os.b + t.h * a.os.h + (long long)row * a.os.t;
#pragma unroll
      for (int nb = 0; nb < DP / 8; ++nb) {
        const int col = nb * 8 + tig * 2;
        if (col < a.D)
          *reinterpret_cast<uint32_t*>(&dst[col]) = dla::pack_bf16(
              o[nb * 4 + 2 * r] * inv, o[nb * 4 + 2 * r + 1] * inv);
      }
      if (tig == 0)
        a.lse[((long long)t.b * a.H + t.h) * a.T + row] =
            lt == 0.f ? dla::kNegInf : m2[r] * LN2 + logf(lt);
    }
  }
}

template <int DP>
int launch(const CUtensorMap (&m)[3], const Args& a, int sms,
           cudaStream_t stream) {
  constexpr int smem = FwdLayout<DP>::BYTES;
  cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int items = a.B * a.H * ((a.T + BM - 1) / BM);
  flash_fwd_kernel<DP><<<min(items, sms), THREADS, smem, stream>>>(
      m[0], m[1], m[2], a);
  return (int)cudaGetLastError();
}

// head dims the kernels take: 64 and 128 natively, 80 and 96 through the
// 128 kernel
bool head_dim_ok(int D) { return D == 64 || D == 80 || D == 96 || D == 128; }

}  // namespace

// strides: 12 element strides (b, head, row) of q, k, v, out in that
// order; sms: the card's multiprocessors (one persistent block each).
// Returns a cudaError_t, or hopper::kMapError + a CUresult when a
// tensor map cannot be encoded.
extern "C" int dla_flash_fwd(const void* q, const void* k, const void* v,
                             const void* qseg, const void* kseg, void* out,
                             void* lse, int B, int H, int KH, int T, int S,
                             int D, const long long* strides, float scale,
                             int window, int sms, void* stream) {
  if (!head_dim_ok(D)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.os = Strides{strides[9], strides[10], strides[11]};
  a.B = B, a.H = H, a.KH = KH, a.T = T, a.S = S, a.D = D;
  a.scale = scale, a.window = window;
  CUtensorMap m[3];
  int err = hp::make_tile_map(&m[0], q, D, H, T, B, strides[0], strides[1],
                              strides[2], BM);
  if (!err)
    err = hp::make_tile_map(&m[1], k, D, KH, S, B, strides[3], strides[4],
                            strides[5], BN);
  if (!err)
    err = hp::make_tile_map(&m[2], v, D, KH, S, B, strides[6], strides[7],
                            strides[8], BN);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(m, a, sms, s) : launch<128>(m, a, sms, s);
}

// dynamic shared memory per block of the forward kernel at head dim D
extern "C" int dla_flash_fwd_smem_bytes(int D) {
  if (!head_dim_ok(D)) return -1;
  return D == 64 ? FwdLayout<64>::BYTES : FwdLayout<128>::BYTES;
}
