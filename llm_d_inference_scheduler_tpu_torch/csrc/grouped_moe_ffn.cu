// Grouped-expert SwiGLU FFN for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Replaces the TPU kernel `_grouped_ffn_call`
// (llm_d_inference_scheduler_tpu/ops/pallas_moe.py:76, body `_ffn_kernel` at
// :46). The rows of x_pad are grouped by expert and padded so that every row
// tile of `tm` rows belongs to one expert, tile_expert[tile]. For each tile:
//   act = silu(x @ w1_e) * (x @ w3_e)   in f32, rounded to x's dtype
//   out = act @ w2_e                    in f32 over all of F, rounded once
// which keeps both rounding points of the TPU kernel; only the summation
// order differs.
//
// Layouts (row-major, contiguous; the JAX package's, no transposed copies):
//   x_pad, out    [Tp, D]       Tp = n_tiles * tm
//   tile_expert   [n_tiles] int32, each in [0, E)
//   rows_used     [1] int32 on the device: rows in use (off[E] of the glue);
//                 tiles at or past it are padding, skipped, written as zeros
//   w1, w3        [E, D, F]
//   w2            [E, F, D]
//   ws            [Tp, F]       act, the caller's workspace in x's dtype
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at decode sizes bytes
// (every expert that holds a row streams its 3 * D * F weights once, ~0.35 GB
// per expert in bf16 at Mixtral width; 0.42 ms for 8 routed rows on 4
// experts), at prefill sizes about evenly bytes and operations (6 * D * F
// flops per routed row: 0.78 ms of operations and 0.85 ms of bytes for 2200
// routed rows at Mixtral width).
//
// Design. Two launches for every row tile: (a) gate/up writes act to ws,
// (b) down reads it over all of F. The TPU kernel fused the two into one
// sequential loop over F tiles with an f32 accumulator in VMEM; on the GPU
// that loop would serialise one CTA per row tile, so act goes through device
// memory (Tp * F values) instead. Row tiles are the grid's fastest axis: the
// CTAs that run together share a column tile of the same experts' weights,
// which they then read from L2 rather than device memory.
//   * bf16, every size: warp-specialised wgmma. One producer warp issues TMA
//     loads of A (x_pad or act, K-major) and of the weights (MN-major: [K, N]
//     row-major as the JAX layout has them) into a ring of 128-byte-swizzled
//     stages of 64-deep K tiles, completed on mbarriers; two consumer
//     warpgroups (setmaxnreg 232) run wgmma m64n128k16 from shared memory, B
//     through wgmma's transpose bit, one group of products in flight. Each
//     consumer holds two 64 x 128 f32 accumulators: gate/up the w1 and w3
//     products of the same 128 columns (SwiGLU fused in the epilogue), down
//     two neighbouring 128-column blocks. Row tiles are 64 rows (tm = 64),
//     one wgmma M; the two consumers sit side by side over the columns and
//     share the A tile (CTA tiles 64 x 256 and 64 x 512). The weights'
//     tensor maps are 3-D (N, K, E), so one descriptor covers every expert;
//     all maps are encoded on the host for each call. A column tile that
//     reaches past N (a multiple of 128 that is not one of the tile's width)
//     loads and stores only its 128-wide blocks that exist. At Mixtral width
//     and 2200 routed rows it runs the tensor cores at ~480 TFLOP/s over the
//     rows it computes (the glue pads each expert to whole tiles, 16 % more
//     rows); at decode sizes it streams the weights of the experts that hold
//     a row (PERF.md has both against their bounds, and what was tried).
//   * f32: CUDA-core FMA (not TF32), 16 x 16 threads, register micro-tiles.
//   * Weight offsets are 64-bit (E * D * F is 470 M elements at Mixtral
//     width). Tiles past rows_used read no weights.
// Left for later work: a persistent grid that overlaps one tile's epilogue
// with the next one's loads, TMA stores, and narrower column tiles where few
// row tiles are live (at 2 routed rows the 64 x 512 down tiles give 16 CTAs
// to a card of 132 SMs).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ void zero_tile(T* c, int64_t ldc, int rows, int cols) {
  const int chunks = cols * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, ch = i - r * chunks;
    reinterpret_cast<uint4*>(c + r * ldc)[ch] = make_uint4(0, 0, 0, 0);
  }
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
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

// d[64] += A (64x16, K-major, smem) * B (16x128, MN-major, smem), f32.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// ---- bf16: warp-specialised wgmma fed by TMA --------------------------------

// Two consumer warpgroups side by side over the columns of a 64-row tile,
// then one producer warpgroup. BK = 64 (one 128-byte swizzle row of bf16).
// Each consumer holds two 64 x 128 f32 accumulators: gate/up the w1 and w3
// products of the same 128 columns, down two neighbouring 128-column blocks.
template <bool GATE_UP>
struct WgmmaCfg {
  static constexpr int CONSUMERS = 2;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int BM = 64;
  static constexpr int WG_COLS = GATE_UP ? 128 : 256;  // columns of one B per consumer
  static constexpr int BN = WG_COLS * CONSUMERS;       // CTA columns of one B
  static constexpr int NBMAT = GATE_UP ? 2 : 1;        // w1 and w3, or w2
  static constexpr int BOX_BYTES = 64 * 128;           // a {64 N, 64 K} weight box
  static constexpr int A_BYTES = BM * 128;             // [BM, 64] K-major
  static constexpr int B_MAT_BYTES = BN / 64 * BOX_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + NBMAT * B_MAT_BYTES;
  static constexpr int STAGES = (220 * 1024) / STAGE_BYTES;  // 3 (72 KB each)
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "stage does not fit");
};

// C [Tp, N] (act for gate/up, out for down) from A [Tp, K] (x_pad or act)
// and B_e [K, N] (w1/w3 or w2). Grid (row tile, column tile of BN).
template <bool GATE_UP>
__global__ void __launch_bounds__(WgmmaCfg<GATE_UP>::THREADS, 1)
    grouped_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                         const __grid_constant__ CUtensorMap b1_map,
                         const __grid_constant__ CUtensorMap b3_map, int N, int K,
                         const int* __restrict__ tile_expert,
                         const int* __restrict__ rows_used, bf16* __restrict__ C) {
  using Cfg = WgmmaCfg<GATE_UP>;
  constexpr int BK = 64;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes and must start 1024-aligned.
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::STAGES * Cfg::STAGE_BYTES);
  uint64_t* empty = full + Cfg::STAGES;

  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * Cfg::BN;
  const int64_t m0 = (int64_t)tile * Cfg::BM;
  const int ncols = min(Cfg::BN, N - n0);  // a multiple of 128
  if (m0 >= rows_used[0]) {  // padding tile: zero rows in, zero rows out
    if (!GATE_UP) zero_tile(C + m0 * N + n0, N, Cfg::BM, ncols);
    return;  // gate/up: the down kernel never reads this tile's act
  }
  const int e = tile_expert[tile];
  const int KT = K / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * Cfg::CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == Cfg::CONSUMERS) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) {
      const uint32_t bytes = Cfg::A_BYTES + Cfg::NBMAT * (ncols / 64) * Cfg::BOX_BYTES;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % Cfg::STAGES;
        mbar_wait(&empty[s], ((kt / Cfg::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        unsigned char* st = smem + s * Cfg::STAGE_BYTES;
        tma_load_2d(st, &a_map, &full[s], kt * BK, (int)m0);
#pragma unroll
        for (int j = 0; j < Cfg::NBMAT; ++j) {
          unsigned char* bt = st + Cfg::A_BYTES + j * Cfg::B_MAT_BYTES;
          for (int c = 0; c < ncols; c += 64)
            tma_load_3d(bt + c / 64 * Cfg::BOX_BYTES, j == 0 ? &b1_map : &b3_map, &full[s],
                        n0 + c, kt * BK, e);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wn = wg;  // the consumer's column block
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    // Column (within the CTA tile) and B matrix of accumulator j. A block
    // past N computes on a box that was not loaded and is not stored.
    constexpr int NACC = 2;
    int col[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) col[j] = wn * Cfg::WG_COLS + (GATE_UP ? 0 : j * 128);
    float acc[NACC][64];
#pragma unroll
    for (int j = 0; j < NACC; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;

    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % Cfg::STAGES;
      mbar_wait(&full[s], (kt / Cfg::STAGES) & 1);
      const unsigned char* st = smem + s * Cfg::STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K-major rows of 128 bytes in 8-row swizzle atoms; 16 K values
        // are 32 bytes further.
        const uint64_t da = smem_desc(st + kk * 32, 16, 1024);
#pragma unroll
        for (int j = 0; j < NACC; ++j) {
          // B: MN-major 64-column boxes (LBO = next box), 8-row K groups of
          // 1024 bytes (SBO); 16 K rows are 2048 bytes further.
          const unsigned char* b_t = st + Cfg::A_BYTES + (GATE_UP ? j * Cfg::B_MAT_BYTES : 0) +
                                     col[j] / 64 * Cfg::BOX_BYTES;
          wgmma_m64n128k16(acc[j], da, smem_desc(b_t + kk * 2048, Cfg::BOX_BYTES, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group of stage kt-1 is done: release it
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % Cfg::STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NACC; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[j][i]);

    // Epilogue: d[4i + v] sits at row 16 * warp + lane / 4 (+8 for v >= 2),
    // column 8i + 2 * (lane % 4) (+1 for odd v).
    const int64_t r0 = m0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < (GATE_UP ? 1 : NACC); ++j) {
      if (col[j] >= ncols) continue;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = n0 + col[j] + i * 8 + 2 * (lane & 3);
          float v0 = acc[j][4 * i + 2 * h], v1 = acc[j][4 * i + 2 * h + 1];
          if (GATE_UP) {
            v0 = silu(v0) * acc[NACC - 1][4 * i + 2 * h];
            v1 = silu(v1) * acc[NACC - 1][4 * i + 2 * h + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(C + (r0 + 8 * h) * N + c) =
              __floats2bfloat162_rn(v0, v1);
        }
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

// A bf16 tensor map with a 128-byte swizzle: `rank` dims innermost first,
// row-major and contiguous, boxes of `box`.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
              const uint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t bdim[3], estride[3] = {1, 1, 1};
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    stride *= dims[i];
    if (i + 1 < rank) gstride[i] = stride;
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdim,
             gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool GATE_UP>
cudaError_t launch_wgmma(const bf16* A, const bf16* B1, const bf16* B3, int N, int K, int E,
                         const int* te, const int* ru, bf16* C, int n_tiles,
                         cudaStream_t stream) {
  using Cfg = WgmmaCfg<GATE_UP>;
  CUtensorMap a_map, b1_map, b3_map;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)n_tiles * Cfg::BM};
  const uint32_t a_box[2] = {64, Cfg::BM};
  const uint64_t b_dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint32_t b_box[3] = {64, 64, 1};
  if (!make_map(&a_map, A, 2, a_dims, a_box) || !make_map(&b1_map, B1, 3, b_dims, b_box) ||
      !make_map(&b3_map, GATE_UP ? B3 : B1, 3, b_dims, b_box))
    return cudaErrorInvalidValue;
  auto kern = grouped_wgmma_kernel<GATE_UP>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_tiles, (N + Cfg::BN - 1) / Cfg::BN), dim3(Cfg::THREADS), Cfg::SMEM, stream>>>(
      a_map, b1_map, b3_map, N, K, te, ru, C);
  return cudaGetLastError();
}

// ---- f32 path: CUDA cores ---------------------------------------------------

// f32 on CUDA cores: a [64, 64] output tile, 256 threads as 16 x 16, each
// thread 4 rows x 4 adjacent columns; K in steps of 16 through shared memory
// (A stored transposed so a thread's rows are one broadcast read).
template <bool GATE_UP>
__global__ void __launch_bounds__(256) grouped_simt_kernel(
    const float* __restrict__ A, const float* __restrict__ B1,
    const float* __restrict__ B3, int N, int K,
    const int* __restrict__ tile_expert, const int* __restrict__ rows_used,
    float* __restrict__ C) {
  constexpr int BM = 64, BN = 64, BK = 16, RM = BM / 16;
  constexpr int NB = GATE_UP ? 2 : 1;
  __shared__ float As[BK][BM];
  __shared__ __align__(16) float Bs[NB][BK][BN];
  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int64_t m0 = (int64_t)tile * BM;
  if (m0 >= rows_used[0]) {
    if (!GATE_UP) zero_tile(C + m0 * N + n0, N, BM, BN);
    return;
  }
  const int64_t e = tile_expert[tile];
  const float* a_g = A + m0 * K;
  const float* b_g[NB];
  b_g[0] = B1 + e * K * N + n0;
  if (GATE_UP) b_g[NB - 1] = B3 + e * K * N + n0;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[NB][RM][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 256) {
      const int r = i / BK, c = i % BK;
      As[c][r] = a_g[(int64_t)r * K + k0 + c];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
      for (int i = tid; i < BK * BN / 4; i += 256) {
        const int r = i / (BN / 4), c = i % (BN / 4);
        reinterpret_cast<float4*>(&Bs[j][r][0])[c] =
            reinterpret_cast<const float4*>(b_g[j] + (int64_t)(k0 + r) * N)[c];
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[kk][ty * RM + i];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float4 b = reinterpret_cast<const float4*>(&Bs[j][kk][0])[tx];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[j][i][0] += a[i] * b.x;
          acc[j][i][1] += a[i] * b.y;
          acc[j][i][2] += a[i] * b.z;
          acc[j][i][3] += a[i] * b.w;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float4 v = make_float4(acc[0][i][0], acc[0][i][1], acc[0][i][2], acc[0][i][3]);
    if (GATE_UP) {
      v.x = silu(v.x) * acc[NB - 1][i][0];
      v.y = silu(v.y) * acc[NB - 1][i][1];
      v.z = silu(v.z) * acc[NB - 1][i][2];
      v.w = silu(v.w) * acc[NB - 1][i][3];
    }
    reinterpret_cast<float4*>(C + (m0 + ty * RM + i) * N + n0)[tx] = v;
  }
}

template <bool GATE_UP>
cudaError_t launch_simt(const float* A, const float* B1, const float* B3, int N, int K,
                        const int* te, const int* ru, float* C, int n_tiles,
                        cudaStream_t stream) {
  grouped_simt_kernel<GATE_UP><<<dim3(n_tiles, N / 64), dim3(256), 0, stream>>>(
      A, B1, B3, N, K, te, ru, C);
  return cudaGetLastError();
}

// ---- dispatch ---------------------------------------------------------------

// CTA tiles of 64 x 256 (gate/up, for each of w1 and w3) and 64 x 512 (down).
cudaError_t run_bf16(const bf16* x, const bf16* w1, const bf16* w3, const bf16* w2,
                     bf16* ws, bf16* out, const int* te, const int* ru, int n_tiles, int D,
                     int F, int E, cudaStream_t s) {
  const cudaError_t e = launch_wgmma<true>(x, w1, w3, F, D, E, te, ru, ws, n_tiles, s);
  if (e != cudaSuccess) return e;
  return launch_wgmma<false>(ws, w2, nullptr, D, F, E, te, ru, out, n_tiles, s);
}

cudaError_t run_f32(const float* x, const float* w1, const float* w3, const float* w2,
                    float* ws, float* out, const int* te, const int* ru, int n_tiles,
                    int D, int F, cudaStream_t s) {
  cudaError_t e = launch_simt<true>(x, w1, w3, F, D, te, ru, ws, n_tiles, s);
  if (e != cudaSuccess) return e;
  return launch_simt<false>(ws, w2, nullptr, D, F, te, ru, out, n_tiles, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tm (rows per tile) must be 64; D
// and F are multiples of 128; E is the number of experts. ws is the caller's
// [n_tiles * tm, F] workspace in x's dtype. Returns cudaGetLastError() after
// the launches (0 on success), or cudaErrorInvalidValue for arguments the
// kernel does not take (the Python wrapper checks these first) or a tensor
// map that cannot be encoded.
extern "C" int grouped_moe_ffn(const void* x_pad, const void* tile_expert,
                               const void* rows_used, const void* w1, const void* w3,
                               const void* w2, void* ws, void* out, int n_tiles, int tm,
                               int D, int F, int E, int dtype, void* stream) {
  if (n_tiles < 0 || tm != 64 || D <= 0 || F <= 0 ||
      D % 128 != 0 || F % 128 != 0 || E <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const int* te = static_cast<const int*>(tile_expert);
  const int* ru = static_cast<const int*>(rows_used);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1) {
    auto x = static_cast<const bf16*>(x_pad);
    auto a = static_cast<const bf16*>(w1);
    auto b = static_cast<const bf16*>(w3);
    auto c = static_cast<const bf16*>(w2);
    auto w = static_cast<bf16*>(ws);
    auto o = static_cast<bf16*>(out);
    e = run_bf16(x, a, b, c, w, o, te, ru, n_tiles, D, F, E, s);
  } else {
    auto x = static_cast<const float*>(x_pad);
    auto a = static_cast<const float*>(w1);
    auto b = static_cast<const float*>(w3);
    auto c = static_cast<const float*>(w2);
    auto w = static_cast<float*>(ws);
    auto o = static_cast<float*>(out);
    e = run_f32(x, a, b, c, w, o, te, ru, n_tiles, D, F, s);
  }
  return (int)e;
}
