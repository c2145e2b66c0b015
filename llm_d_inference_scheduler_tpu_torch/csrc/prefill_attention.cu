// Prefill attention for Hopper (sm_90a), bound to PyTorch with ctypes: K3.
//
// Replaces no TPU kernel. The JAX package computes prefill attention as
// plain XLA einsums (llm_d_inference_scheduler_tpu/ops/attention.py:
// causal_attention, whose docstring leaves a flash kernel for later); the
// port's eager version of it (ops/attention.py) ran two f32 GEMMs on CUDA
// cores, a mask pass and a softmax over [B, H, S, T] f32 logits. This
// kernel computes the same masked attention in one launch, with the logits
// never leaving the SM.
//
// What it computes. q [B, S, H, D] are a window's new rows; the K/V columns
// are an optional prior part [B, P, Hkv, D] (the cached prefix, gathered)
// followed by the new part [B, S, Hkv, D]:
//   prior column j is visible to every row where j < prior_len[b];
//   new column t is visible to row i where t <= i and t < new_len[b].
// prior_len and new_len are device int32 [B] (absent: P and S). GQA: q
// head h reads KV head h / (H / Hkv) in place. out [B, S, H, D] in q's
// dtype. A row that sees no column at all comes out zero.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): operations. At the
// serving shapes (32/8 heads, D 128, a 1024-row window over up to 3 K
// cached columns) Q, K, V and O are about 32 MB a layer against about
// 43 GFLOP of visible QK and PV products: ~44 us of operations against
// ~10 us of bytes.
//
// Design (bf16, warp-specialised wgmma fed by TMA):
//   * One CTA per (batch row, q head, 128-row q tile); three warpgroups.
//     A producer warp keeps K/V tiles of 128 columns in flight by TMA
//     through a ring of stages, completed on mbarriers (K and V of a stage
//     on barriers of their own, so Q.K^T starts while V lands). Two
//     consumer warpgroups own 64 q rows each: S = Q.K^T on wgmma from
//     shared memory into f32 registers; the online softmax in registers
//     (running max and sum, exp2 with log2(e)/sqrt(D) folded into one
//     scale); P rounded to bf16 in registers as the A operand of the P.V
//     wgmma, V from shared memory, O in f32 registers; O divided by the
//     sum and written in q's dtype.
//   * Causal skipping: K/V tiles past a q tile's last row (or past
//     new_len, or past prior_len) are never loaded. Only the tiles that
//     cross the diagonal or a ragged edge are masked, in registers.
//   * Launch order: the heaviest (last) q tiles first; within a tile the
//     heads of one KV head next to one another, so a group's q heads find
//     its K/V in L2.
//   * Operands are 4-D tensor maps (D, heads, rows, batch) over the
//     callers' contiguous layouts, 128-byte swizzled boxes of 64 columns:
//     no copy, no concatenation. D is padded to 64 or 128 by TMA's
//     out-of-bounds zero fill, so one template serves every D that is a
//     multiple of 8 up to 128; a box's rows past the tensor's end read
//     zeros, and the ragged last q tile stores only its rows.
//   * f32 on CUDA cores (not TF32): four threads a q row, 32 rows a CTA,
//     K/V tiles of 32 columns in shared memory, the same masks and online
//     softmax with expf.
// Left for later work: overlapping one tile's softmax with the next
// tile's Q.K^T inside a warpgroup, a persistent grid, and reading the prior
// K/V from the pages by block table instead of a gathered copy.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // q rows of a CTA (two consumer warpgroups of 64)
constexpr int BN = 128;  // K/V columns of a tile
constexpr int THREADS = 384;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier, TMA and wgmma (PTX) ----------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// d[64] (+)= A (64x16, K-major, smem) * B (16x128, K-major, smem), f32;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 }, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64] += A (64x16, bf16 pairs in registers) * B (16x128, MN-major, smem), f32.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 }, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A (64x16, bf16 pairs in registers) * B (16x64, MN-major, smem), f32.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 }, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db) {
  if constexpr (DP == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n64(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Which K/V tiles a CTA visits, and whether each is masked: prior tiles
// first (columns < prior_len), then new tiles up to the q tile's last row
// and new_len.
struct Span {
  int plen, nlen, n_prior, n_tiles;
  __device__ Span(const int* prior_len, const int* new_len, int b, int P, int S, int m0,
                  int rows, int cols) {
    plen = prior_len ? min(max(prior_len[b], 0), P) : P;
    nlen = new_len ? min(max(new_len[b], 0), S) : S;
    n_prior = (plen + cols - 1) / cols;
    n_tiles = n_prior + (min(m0 + rows, nlen) + cols - 1) / cols;
  }
};

// (q tile, batch row, q head) of this CTA: the last (heaviest) q tiles
// launch first, and q heads of one KV head are neighbours.
__device__ __forceinline__ void cta_coords(int n_qtiles, int B, int H, int& tile, int& b,
                                           int& h) {
  const int per_tile = B * H;
  tile = n_qtiles - 1 - (int)blockIdx.x / per_tile;
  const int rem = (int)blockIdx.x % per_tile;
  b = rem / H;
  h = rem % H;
}

// ---- bf16: warp-specialised wgmma fed by TMA --------------------------------

// DP: D padded to 64 or 128 (one or two 64-column swizzled boxes a row).
template <int DP>
struct WgCfg {
  static constexpr int HALVES = DP / 64;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;  // K or V of one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int STAGES = DP == 128 ? 2 : 4;
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (size_t)STAGES * STAGE_BYTES + (1 + 3 * STAGES) * 8;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    prefill_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                   const __grid_constant__ CUtensorMap kn_map,
                                   const __grid_constant__ CUtensorMap vn_map,
                                   const __grid_constant__ CUtensorMap kp_map,
                                   const __grid_constant__ CUtensorMap vp_map,
                                   bf16* __restrict__ out, const int* __restrict__ prior_len,
                                   const int* __restrict__ new_len, int B, int S, int P, int H,
                                   int Hkv, int D, float scale_log2, int n_qtiles) {
  using Cfg = WgCfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes and must start 1024-aligned.
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;  // HALVES boxes of [BM rows][64 columns]
  unsigned char* kv_s = smem + Cfg::Q_BYTES;  // stage s: K boxes, then V boxes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + Cfg::STAGES * Cfg::STAGE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + Cfg::STAGES;
  uint64_t* empty = v_full + Cfg::STAGES;

  int tile, b, h;
  cta_coords(n_qtiles, B, H, tile, b, h);
  const int kvh = h / (H / Hkv);
  const int m0 = tile * BM;
  const Span span(prior_len, new_len, b, P, S, m0, BM, BN);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread loads Q once, then keeps the K/V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(q_full, Cfg::Q_BYTES);
      for (int c = 0; c < Cfg::HALVES; ++c)
        tma_load_4d(q_s + c * BM * 128, &q_map, q_full, c * 64, h, m0, b);
      for (int it = 0; it < span.n_tiles; ++it) {
        const int s = it % Cfg::STAGES;
        mbar_wait(&empty[s], ((it / Cfg::STAGES) & 1) ^ 1);
        const bool prior = it < span.n_prior;
        const int row = (prior ? it : it - span.n_prior) * BN;
        unsigned char* st = kv_s + s * Cfg::STAGE_BYTES;
        mbar_expect_tx(&k_full[s], Cfg::KV_BYTES);
        for (int c = 0; c < Cfg::HALVES; ++c)
          tma_load_4d(st + c * BN * 128, prior ? &kp_map : &kn_map, &k_full[s], c * 64, kvh,
                      row, b);
        mbar_expect_tx(&v_full[s], Cfg::KV_BYTES);
        for (int c = 0; c < Cfg::HALVES; ++c)
          tma_load_4d(st + Cfg::KV_BYTES + c * BN * 128, prior ? &vp_map : &vn_map, &v_full[s],
                      c * 64, kvh, row, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int r0 = m0 + wg * 64;                    // first row of this warpgroup
  const int row_a = r0 + warp * 16 + (lane >> 2);  // this thread's rows: row_a, row_a + 8
  // Accumulator element 4i + v sits at row row_a (+8 for v >= 2), column
  // 8i + 2 * (lane % 4) (+1 for odd v).
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const unsigned char* q_w = q_s + wg * 64 * 128;  // this warpgroup's rows of each box

  mbar_wait(q_full, 0);
  for (int it = 0; it < span.n_tiles; ++it) {
    const int s = it % Cfg::STAGES;
    const uint32_t parity = (it / Cfg::STAGES) & 1;
    const unsigned char* k_t = kv_s + s * Cfg::STAGE_BYTES;
    const unsigned char* v_t = k_t + Cfg::KV_BYTES;

    // S = Q K^T over D in steps of 16 (32 bytes of a 128-byte row).
    float sc[64];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * BM * 128 + (kk % 4) * 32;
      wgmma_ss_n128(sc, smem_desc(q_w + off, 16, 1024),
                    smem_desc(k_t + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(sc[i]);

    // Masks of a tile that crosses prior_len, the diagonal or new_len.
    const bool prior = it < span.n_prior;
    const int c0 = (prior ? it : it - span.n_prior) * BN;
    if (prior ? c0 + BN > span.plen : (c0 + BN - 1 > r0 || c0 + BN > span.nlen)) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = c0 + 8 * i + 2 * (lane & 3) + (v & 1);
          const int r = row_a + 8 * (v >> 1);
          const bool ok = prior ? c < span.plen : (c <= r && c < span.nlen);
          if (!ok) sc[4 * i + v] = -INFINITY;
        }
    }

    // Online softmax, rows a and b (each spread over the 4 lanes of a quad).
    float t_a = -INFINITY, t_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      t_a = fmaxf(t_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
      t_b = fmaxf(t_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      t_a = fmaxf(t_a, __shfl_xor_sync(0xffffffffu, t_a, x));
      t_b = fmaxf(t_b, __shfl_xor_sync(0xffffffffu, t_b, x));
    }
    const float n_a = fmaxf(m_a, t_a * scale_log2), n_b = fmaxf(m_b, t_b * scale_log2);
    // A row with no visible column yet subtracts 0, so exp2 sees -inf, not NaN.
    const float u_a = n_a == -INFINITY ? 0.f : n_a, u_b = n_b == -INFINITY ? 0.f : n_b;
    const float corr_a = exp2f(m_a - u_a), corr_b = exp2f(m_b - u_b);
    m_a = n_a;
    m_b = n_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i] *= corr_a;
      o[4 * i + 1] *= corr_a;
      o[4 * i + 2] *= corr_b;
      o[4 * i + 3] *= corr_b;
    }
    // P in bf16 as wgmma's A fragments: k step kk covers columns 16kk..16kk+15,
    // which are accumulator blocks 2kk and 2kk + 1.
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p0 = exp2f(fmaf(sc[4 * i], scale_log2, -u_a));
      const float p1 = exp2f(fmaf(sc[4 * i + 1], scale_log2, -u_a));
      const float p2 = exp2f(fmaf(sc[4 * i + 2], scale_log2, -u_b));
      const float p3 = exp2f(fmaf(sc[4 * i + 3], scale_log2, -u_b));
      l_a += p0 + p1;
      l_b += p2 + p3;
      pa[i / 2][(i % 2) * 2] = pack_bf16(p0, p1);
      pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V over the tile's columns in steps of 16 (V MN-major: 64-column
    // boxes of D, LBO = next box; 16 rows of 128 bytes a step).
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_pv<DP>(o, pa[kk], smem_desc(v_t + kk * 2048, BN * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_operand(o[i]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f, inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int c = 8 * i + 2 * (lane & 3);
    if (c >= D) continue;
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int r = row_a + 8 * hv;
      if (r >= S) continue;
      const float inv = hv ? inv_b : inv_a;
      *reinterpret_cast<__nv_bfloat162*>(out + (((int64_t)b * S + r) * H + h) * D + c) =
          __floats2bfloat162_rn(o[4 * i + 2 * hv] * inv, o[4 * i + 2 * hv + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) !=
        cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map over a contiguous [batch, rows, heads, D] tensor, as
// the 4-D (D, heads, rows, batch), boxes of {64, 1, box_rows, 1} with a
// 128-byte swizzle (D < 64 reads zeros past D).
bool make_map(CUtensorMap* map, const void* ptr, int D, int heads, int rows, int batch,
              int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t gdim[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t gstride[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t bdim[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim, gstride,
             bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_wgmma(const bf16* q, const bf16* kn, const bf16* vn, const bf16* kp,
                         const bf16* vp, bf16* out, const int* plen, const int* nlen, int B,
                         int S, int P, int H, int Hkv, int D, cudaStream_t stream) {
  using Cfg = WgCfg<DP>;
  CUtensorMap q_map, kn_map, vn_map, kp_map, vp_map;
  if (!make_map(&q_map, q, D, H, S, B, BM) || !make_map(&kn_map, kn, D, Hkv, S, B, BN) ||
      !make_map(&vn_map, vn, D, Hkv, S, B, BN))
    return cudaErrorInvalidValue;
  if (P > 0) {
    if (!make_map(&kp_map, kp, D, Hkv, P, B, BN) || !make_map(&vp_map, vp, D, Hkv, P, B, BN))
      return cudaErrorInvalidValue;
  } else {  // no prior part: never read
    kp_map = kn_map;
    vp_map = vn_map;
  }
  auto kern = prefill_attention_wgmma_kernel<DP>;
  // The attribute belongs to the function on each device: set it once there.
  static uint64_t sized = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(sized >> dev & 1)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Cfg::SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 64) sized |= (uint64_t)1 << dev;
  }
  const int n_qtiles = (S + BM - 1) / BM;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kern<<<dim3(n_qtiles * B * H), dim3(THREADS), Cfg::SMEM, stream>>>(
      q_map, kn_map, vn_map, kp_map, vp_map, out, plen, nlen, B, S, P, H, Hkv, D, scale_log2,
      n_qtiles);
  return cudaGetLastError();
}

// ---- f32 path: CUDA cores ---------------------------------------------------

constexpr int SR = 32;   // q rows of a CTA, four threads each
constexpr int SBN = 32;  // K/V columns of a tile

// DQ = D padded to a multiple of 4, divided by 4: the dimensions a thread
// holds (d = 4k + sub, so a quad's threads read neighbouring words).
template <int DQ>
__global__ void __launch_bounds__(128) prefill_attention_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ kn, const float* __restrict__ vn,
    const float* __restrict__ kp, const float* __restrict__ vp, float* __restrict__ out,
    const int* __restrict__ prior_len, const int* __restrict__ new_len, int B, int S, int P,
    int H, int Hkv, int D, float scale, int n_qtiles) {
  constexpr int DP = 4 * DQ;
  __shared__ float ks[SBN][DP];
  __shared__ float vs[SBN][DP];
  int tile, b, h;
  cta_coords(n_qtiles, B, H, tile, b, h);
  const int kvh = h / (H / Hkv);
  const int m0 = tile * SR;
  const Span span(prior_len, new_len, b, P, S, m0, SR, SBN);
  const int r = m0 + (threadIdx.x >> 2), sub = threadIdx.x & 3;

  float qv[DQ], o[DQ];
#pragma unroll
  for (int k = 0; k < DQ; ++k) {
    const int d = 4 * k + sub;
    qv[k] = (r < S && d < D) ? q[(((int64_t)b * S + r) * H + h) * D + d] : 0.f;
    o[k] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int it = 0; it < span.n_tiles; ++it) {
    const bool prior = it < span.n_prior;
    const int c0 = (prior ? it : it - span.n_prior) * SBN;
    const int rows = prior ? P : S;
    const float* kg = prior ? kp : kn;
    const float* vg = prior ? vp : vn;
    for (int i = threadIdx.x; i < SBN * DP; i += 128) {
      const int j = i / DP, d = i % DP;
      const bool in = c0 + j < rows && d < D;
      const int64_t at = (((int64_t)b * rows + c0 + j) * Hkv + kvh) * D + d;
      ks[j][d] = in ? kg[at] : 0.f;
      vs[j][d] = in ? vg[at] : 0.f;
    }
    __syncthreads();
    float sc[SBN];
    float t = -INFINITY;
#pragma unroll
    for (int j = 0; j < SBN; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < DQ; ++k) acc = fmaf(qv[k], ks[j][4 * k + sub], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      const int c = c0 + j;
      const bool ok = prior ? c < span.plen : (c <= r && c < span.nlen);
      sc[j] = ok ? acc * scale : -INFINITY;
      t = fmaxf(t, sc[j]);
    }
    const float n = fmaxf(m, t);
    const float u = n == -INFINITY ? 0.f : n;
    const float corr = expf(m - u);
    m = n;
    l *= corr;
#pragma unroll
    for (int k = 0; k < DQ; ++k) o[k] *= corr;
#pragma unroll
    for (int j = 0; j < SBN; ++j) {
      const float p = expf(sc[j] - u);
      l += p;
#pragma unroll
      for (int k = 0; k < DQ; ++k) o[k] = fmaf(p, vs[j][4 * k + sub], o[k]);
    }
    __syncthreads();
  }
  if (r >= S) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int k = 0; k < DQ; ++k) {
    const int d = 4 * k + sub;
    if (d < D) out[(((int64_t)b * S + r) * H + h) * D + d] = o[k] * inv;
  }
}

template <int DQ>
cudaError_t launch_simt(const float* q, const float* kn, const float* vn, const float* kp,
                        const float* vp, float* out, const int* plen, const int* nlen, int B,
                        int S, int P, int H, int Hkv, int D, cudaStream_t stream) {
  const int n_qtiles = (S + SR - 1) / SR;
  prefill_attention_simt_kernel<DQ><<<dim3(n_qtiles * B * H), dim3(128), 0, stream>>>(
      q, kn, vn, kp, vp, out, plen, nlen, B, S, P, H, Hkv, D, 1.f / sqrtf((float)D), n_qtiles);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, out [B, S, H, D]; kn, vn [B, S,
// Hkv, D]; kp, vp [B, P, Hkv, D] (unused when P is 0); all contiguous and
// 16-byte aligned. prior_len, new_len: device int32 [B], or null for P and
// S. D a multiple of 8 up to 128; H a multiple of Hkv. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take (the Python
// wrapper checks these first) or a tensor map that cannot be encoded.
extern "C" int prefill_attention(const void* q, const void* kn, const void* vn, const void* kp,
                                 const void* vp, void* out, const void* prior_len,
                                 const void* new_len, int B, int S, int P, int H, int Hkv,
                                 int D, int dtype, void* stream) {
  if (B < 0 || S < 0 || P < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D < 8 || D > 128 ||
      D % 8 != 0 || (dtype != 0 && dtype != 1) || (P > 0 && (kp == nullptr || vp == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const int* pl = static_cast<const int*>(prior_len);
  const int* nl = static_cast<const int*>(new_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    auto f = D <= 64 ? launch_wgmma<64> : launch_wgmma<128>;
    return (int)f(static_cast<const bf16*>(q), static_cast<const bf16*>(kn),
                  static_cast<const bf16*>(vn), static_cast<const bf16*>(kp),
                  static_cast<const bf16*>(vp), static_cast<bf16*>(out), pl, nl, B, S, P, H, Hkv,
                  D, s);
  }
  auto f = D <= 32 ? launch_simt<8> : D <= 64 ? launch_simt<16> : launch_simt<32>;
  return (int)f(static_cast<const float*>(q), static_cast<const float*>(kn),
                static_cast<const float*>(vn), static_cast<const float*>(kp),
                static_cast<const float*>(vp), static_cast<float*>(out), pl, nl, B, S, P, H, Hkv,
                D, s);
}
