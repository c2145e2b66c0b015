// Paged decode attention for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Replaces the TPU kernel `paged_decode_attention_pallas`
// (llm_d_inference_scheduler_tpu/ops/pallas_paged_attention.py:139, body
// `_kernel` at :40). One new token per sequence attends to the first
// seq_len - 1 positions of its paged KV cache plus its own K/V (`cur_k`,
// `cur_v`), an always-visible extra column. Softmax is online, in f32; the
// output is written in q's dtype.
//
// Layouts (row-major, contiguous):
//   q, out        [B, H, D]
//   k/v_pages     [N, block, Hkv, D]   one layer's pages
//   block_tables  [B, max_blocks] int32
//   seq_lens      [B] int32 (counts the current token)
//   cur_k, cur_v  [B, Hkv, D]
//   part_acc      [B, H, S, D] f32, part_ml [B, H, S, 2] f32: workspace
//   tickets       [B * Hkv] int32, zero between calls (the kernel resets it)
//
// Bound on an H100 SXM (3.35 TB/s): bytes. A call must read the K and V rows
// of every cached position once, 2 * sum(seq_len - 1) * Hkv * D * sizeof(T)
// (2.8 us for the serving phase's four rows of ~1116, ~1085, ~82 and ~80
// positions at llama3-8b width); its two dot products per position are ~1
// flop per byte, far below the card's balance point.
//
// Design: one launch. Grid (Hkv, B, S), S from shapes alone (the wrapper
// picks it so that the grid covers the SMs even at batch 1). Each row's
// cached positions are cut on the device, from seq_lens, into as few splits
// of whole 64-position tiles as fill its S CTAs (at least 64 positions
// each): a short row takes one or two CTAs and its other CTAs exit at once,
// a long one shares its positions evenly. Each busy CTA writes a partial
// softmax (m, l, acc) for the q_per_kv query heads of its KV head, so each
// K/V row is brought from memory once per group; the last of a row's CTAs
// to finish (an atomic ticket after __threadfence) merges the partials with
// the current token's column and writes the output. The TPU kernel walked a
// row's pages in one sequential program instead.
//   * K/V tiles are copied into shared memory with 16-byte cp.async
//     through a ring of 2-3 stages (the TPU kernel double-buffered its page
//     DMA). Each position's physical page comes from the split's slice of
//     the block table, staged in shared memory once. Rows past the split end
//     are zero-filled; shared rows are padded by 16 bytes, so the ldmatrix
//     reads are free of bank conflicts.
//   * bf16: mma.sync m16n8k16 with f32 accumulation, four warps. QK^T puts
//     16 positions on M and 8 query heads on N (llama's 4 heads per KV head
//     waste half of N, not 12 of 16 rows), q's fragments held in registers.
//     The probabilities go from the QK accumulator to the B operand of PV
//     by movmatrix, in two bf16 parts (p = hi + lo), so rounding them costs
//     no accuracy; PV (O^T = V^T P^T) reads V^T through ldmatrix.trans.
//     Warps split the heads in blocks of 8 and the positions of a tile; the
//     warps of one head block merge through shared memory at the end.
//   * f32: CUDA cores, one warp per query head, 32-position tiles. QK: lane
//     = position, a full dot product per lane from shared memory. PV: lanes
//     own 16-byte chunks of the output row, groups of lanes take alternate
//     positions, and the groups are summed once at the end.
//   * Any head_dim that is a multiple of 16 up to 256, q_per_kv up to 32,
//     bf16 or f32; the page walk is bounded by max_blocks * block, so a
//     position past the block table (a lane that overshoots inside a fused
//     decode chunk) never indexes outside the table row.
// Left for later work: TMA for the page rows (a page's slice of one KV head
// is a 2-D box {D, block} with row stride Hkv * D), and a persistent grid
// that sizes the number of CTAs, not only their share, from seq_lens.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF
constexpr int kChunk = 64;         // split granularity; positions per bf16 tile
constexpr int kTile = 32;          // positions per shared-memory tile (f32 kernel)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// The transpose of an 8x8 b16 matrix held one row pair per thread.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x / d, by a shift when d is a power of two (block sizes and chunk counts
// usually are).
struct FastDiv {
  int d, shift;
  __device__ __forceinline__ explicit FastDiv(int d_) : d(d_), shift(0) {
    while ((1 << shift) < d) ++shift;
    if ((1 << shift) != d) shift = -1;
  }
  __device__ __forceinline__ int operator()(int x) const {
    return shift >= 0 ? x >> shift : x / d;
  }
};

// 16 bytes as four floats.
__device__ __forceinline__ void load_f4(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// The row's share of CTA s: positions [start, end) of its `cached`, and how
// many of the row's S CTAs take part (at least 1: CTA 0 always reports, so
// a row with nothing cached still gets its current token's column). Shares
// are whole kChunk tiles, at least one, at most split_len positions.
struct Split {
  int start, end, used;
  __device__ __forceinline__ Split(int cached, int S, int split_len, int s) {
    int chunk = (cached + S - 1) / S;
    chunk = max(kChunk, (chunk + kChunk - 1) / kChunk * kChunk);
    chunk = min(chunk, split_len);
    used = max(1, (cached + chunk - 1) / chunk);
    start = s * chunk;
    end = min(cached, start + chunk);
  }
};

// Cached positions of row b, clamped to the block table.
__device__ __forceinline__ int cached_len(const int* seq_lens, int b, int cap) {
  const int c = seq_lens[b] - 1;
  return c < 0 ? 0 : (c > cap ? cap : c);
}

// Shared memory past the K/V ring: the split's page ids, then the merge's
// per-head scratch and the ticket flag.
struct Tail {
  int* pages;
  float* head;  // [3 * 32]: M, 1 / L, weight of the current column
  int* flag;
  __device__ __forceinline__ Tail(unsigned char* p, int n_pages) {
    pages = reinterpret_cast<int*>(p);
    head = reinterpret_cast<float*>(pages + ((n_pages + 3) & ~3));
    flag = reinterpret_cast<int*>(head + 96);
  }
  static size_t bytes(int n_pages) { return ((n_pages + 3) & ~3) * 4 + 96 * 4 + 16; }
};

// Copies positions [tile_start, tile_start + rows) of K and V (one KV head)
// into `base`: K rows 0..rows-1, then V rows; positions at or past `end`
// are zero-filled.
template <typename T>
__device__ __forceinline__ void load_kv_tile(unsigned char* base, int rows, int tile_start,
                                             int start, int end, const T* k_pages,
                                             const T* v_pages, const int* pg_s, int pg0,
                                             int block, int64_t row_elems, int g, int D,
                                             int stride) {
  const int C = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  const FastDiv div_c(C), div_block(block), div_rows(rows);
  for (int i = threadIdx.x; i < 2 * rows * C; i += blockDim.x) {
    const int row = div_c(i);
    const int c = i - row * C;
    const int kv = div_rows(row);  // 0: K, 1: V
    const int p = tile_start + row - kv * rows;
    const bool ok = p < end;
    const int pp = ok ? p : start;  // a valid address for the zero fill
    const int pb = div_block(pp);
    const int64_t off = ((int64_t)pg_s[pb - pg0] * block + (pp - pb * block)) * row_elems +
                        (int64_t)g * D;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>((kv ? v_pages : k_pages) + off);
    cp_async16(base + row * stride + c * 16, src + c * 16, ok ? 16 : 0);
  }
}

// Four values of T at p (8-byte aligned for bf16, 16 for f32) as floats.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    uint2 u;
    u.x = pack_bf16(v.x, v.y);
    u.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = u;
  }
}

// Every thread of the CTA calls this after writing its partial of split s.
// The last of the row's `used` CTAs of KV head g to arrive merges them all
// with the current token's column, writes the q_per_kv output rows and
// resets the ticket for the next call.
template <typename T>
__device__ void arrive_and_merge(const T* __restrict__ q, const T* __restrict__ cur_k,
                                 const T* __restrict__ cur_v, const float* part_acc,
                                 const float* part_ml, int* tickets, T* __restrict__ out,
                                 int b, int g, int H, int Hkv, int D, int S, int used,
                                 float scale, const Tail& tail) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int qpk = H / Hkv;
  __threadfence();  // this CTA's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) *tail.flag = atomicAdd(&tickets[b * Hkv + g], 1) == used - 1;
  __syncthreads();
  if (!*tail.flag) return;
  __threadfence();

  const T* ck = cur_k + ((int64_t)b * Hkv + g) * D;
  for (int hh = warp; hh < qpk; hh += nwarps) {
    const int h = g * qpk + hh;
    const T* qh = q + ((int64_t)b * H + h) * D;
    float dot = 0.f;
    for (int e = lane; e < D; e += 32) dot += to_f32(qh[e]) * to_f32(ck[e]);
    const float s_cur = warp_sum(dot) * scale;
    const float* ml = part_ml + 2 * ((int64_t)b * H + h) * S;
    float M = s_cur;
    for (int s = lane; s < used; s += 32) M = fmaxf(M, __ldcg(ml + 2 * s));
    M = warp_max(M);
    float L = 0.f;  // an empty partial has m = NEG_INF, l = 0: weight 0
    for (int s = lane; s < used; s += 32)
      L += __ldcg(ml + 2 * s + 1) * expf(__ldcg(ml + 2 * s) - M);
    L = warp_sum(L);
    const float w_cur = expf(s_cur - M);
    if (lane == 0) {
      tail.head[hh] = M;
      tail.head[32 + hh] = 1.f / (L + w_cur);
      tail.head[64 + hh] = w_cur;
    }
  }
  __syncthreads();
  const int C4 = D / 4;
  const T* cv = cur_v + ((int64_t)b * Hkv + g) * D;
  for (int i = tid; i < qpk * C4; i += nthreads) {
    const int hh = i / C4, c = (i - hh * C4) * 4;
    const int64_t row = (int64_t)b * H + g * qpk + hh;
    const float M = tail.head[hh], w_cur = tail.head[64 + hh];
    const float4 v = load4(cv + c);
    float4 a = make_float4(w_cur * v.x, w_cur * v.y, w_cur * v.z, w_cur * v.w);
    const float* ml = part_ml + 2 * row * S;
    const float* pa = part_acc + row * S * D + c;
    for (int s = 0; s < used; ++s) {
      const float w = expf(__ldcg(ml + 2 * s) - M);
      const float4 p = __ldcg(reinterpret_cast<const float4*>(pa + (int64_t)s * D));
      a.x += w * p.x;
      a.y += w * p.y;
      a.z += w * p.z;
      a.w += w * p.w;
    }
    const float inv = tail.head[32 + hh];
    store4(out + row * D + c, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
  if (tid == 0) tickets[b * Hkv + g] = 0;
}

// ---- bf16: tensor cores ----------------------------------------------------

// NB blocks of 8 query heads (q_per_kv <= 8 * NB); four warps, warp w takes
// head block w % NB and the 16-position blocks w / NB, w / NB + 4 / NB, ...
// of each 64-position tile. DMAX bounds head_dim (its register arrays).
template <int NB, int DMAX, int NSTAGE>
__global__ void __launch_bounds__(128) paged_decode_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, const bf16* __restrict__ cur_k,
    const bf16* __restrict__ cur_v, float* part_acc, float* part_ml, int* tickets,
    bf16* __restrict__ out, int H, int Hkv, int D, int block, int max_blocks,
    int split_len, float scale) {
  constexpr int WP = 4 / NB;  // warps per head block
  constexpr int ND = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, b = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qpk = H / Hkv;
  const int nd = D / 16;
  const int stride = D * 2 + 16;               // padded shared row, bytes
  const int stage_bytes = 2 * kChunk * stride;  // K tile + V tile

  const Split sp(cached_len(seq_lens, b, max_blocks * block), S, split_len, s);
  if (s >= sp.used) return;
  const int start = sp.start, end = sp.end;
  const Tail tail(smem + NSTAGE * stage_bytes, split_len / block + 2);

  const int pg0 = start / block;
  const int npg = end > start ? (end - 1) / block - pg0 + 1 : 0;
  for (int i = tid; i < npg; i += 128)
    tail.pages[i] = block_tables[(int64_t)b * max_blocks + pg0 + i];

  // q as the B operand of QK^T: this lane's head is gq of its block, its
  // d values 2 * tq (+1) and 8 + 2 * tq (+1) of each 16.
  const int nb = warp % NB, wp = warp / NB;
  const int gq = lane >> 2, tq = lane & 3;
  const int head = nb * 8 + gq;
  const bool hvalid = head < qpk;
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
      q + ((int64_t)b * H + g * qpk + (hvalid ? head : 0)) * D);
  uint32_t qf[ND][2];
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    qf[kk][0] = kk < nd && hvalid ? qrow[kk * 8 + tq] : 0u;
    qf[kk][1] = kk < nd && hvalid ? qrow[kk * 8 + 4 + tq] : 0u;
  }
  __syncthreads();  // page ids staged

  // o[db]: O^T rows d = 16 db + gq (+8 for [2], [3]), heads 2 tq (+1).
  float o[ND][4];
#pragma unroll
  for (int db = 0; db < ND; ++db)
#pragma unroll
    for (int v = 0; v < 4; ++v) o[db][v] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int64_t row_elems = (int64_t)Hkv * D;
  const int ntiles = (end - start + kChunk - 1) / kChunk;
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < ntiles)
      load_kv_tile(smem + st * stage_bytes, kChunk, start + st * kChunk, start, end, k_pages,
                   v_pages, tail.pages, pg0, block, row_elems, g, D, stride);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int ts = start + it * kChunk;
    cp_async_wait<NSTAGE - 2>();  // tile `it` has landed
    __syncthreads();  // ...for every thread; and tile it-1's buffer is free
    const int nxt = it + NSTAGE - 1;
    if (nxt < ntiles)
      load_kv_tile(smem + (nxt % NSTAGE) * stage_bytes, kChunk, start + nxt * kChunk, start,
                   end, k_pages, v_pages, tail.pages, pg0, block, row_elems, g, D, stride);
    cp_async_commit();
    const unsigned char* base = smem + (it % NSTAGE) * stage_bytes;

#pragma unroll
    for (int blk = wp; blk < 4; blk += WP) {
      const int p0 = ts + blk * 16;
      if (p0 >= end) break;
      // S^T (16 positions x 8 heads) = K_blk q^T.
      const unsigned char* kb = base + (blk * 16 + (lane & 15)) * stride + (lane >> 4) * 16;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        if (kk < nd) {
          uint32_t a[4];
          ldmatrix_x4(a, kb + kk * 32);
          mma_bf16(sc, a, qf[kk][0], qf[kk][1]);
        }
      }
      const bool lo_ok = p0 + gq < end, hi_ok = p0 + gq + 8 < end;
      const float s0 = lo_ok ? sc[0] * scale : kNegInf, s1 = lo_ok ? sc[1] * scale : kNegInf;
      const float s2 = hi_ok ? sc[2] * scale : kNegInf, s3 = hi_ok ? sc[3] * scale : kNegInf;
      float mx0 = fmaxf(s0, s2), mx1 = fmaxf(s1, s3);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
      const float p0v = lo_ok ? __expf(s0 - mn0) : 0.f, p1v = lo_ok ? __expf(s1 - mn1) : 0.f;
      const float p2v = hi_ok ? __expf(s2 - mn0) : 0.f, p3v = hi_ok ? __expf(s3 - mn1) : 0.f;
      l0 = l0 * c0 + p0v + p2v;
      l1 = l1 * c1 + p1v + p3v;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int db = 0; db < ND; ++db) {
        o[db][0] *= c0;
        o[db][1] *= c1;
        o[db][2] *= c0;
        o[db][3] *= c1;
      }
      // P^T as the B operand of PV, p = hi + lo in bf16.
      const uint32_t h01 = pack_bf16(p0v, p1v), h23 = pack_bf16(p2v, p3v);
      const float2 f01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h01));
      const float2 f23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h23));
      const uint32_t bh0 = movmatrix_trans(h01), bh1 = movmatrix_trans(h23);
      const uint32_t bl0 = movmatrix_trans(pack_bf16(p0v - f01.x, p1v - f01.y));
      const uint32_t bl1 = movmatrix_trans(pack_bf16(p2v - f23.x, p3v - f23.y));
      // O^T += V_blk^T P^T.
      const unsigned char* vb = base + (kChunk + blk * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                           stride + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int db = 0; db < ND; ++db) {
        if (db < nd) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, vb + db * 32);
          mma_bf16(o[db], a, bh0, bh1);
          mma_bf16(o[db], a, bl0, bl1);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // Merge the WP warps of each head block through shared memory (the ring
  // is free now), then write this CTA's partial.
  __syncthreads();
  float* ml_s = reinterpret_cast<float*>(smem);  // [4 warps][8 heads][2]
  float* red = ml_s + 64;                        // [4 warps][8 heads][D]
  if (gq == 0) {
    ml_s[(warp * 8 + 2 * tq) * 2] = m0;
    ml_s[(warp * 8 + 2 * tq) * 2 + 1] = l0;
    ml_s[(warp * 8 + 2 * tq + 1) * 2] = m1;
    ml_s[(warp * 8 + 2 * tq + 1) * 2 + 1] = l1;
  }
  __syncthreads();
  float M0 = kNegInf, M1 = kNegInf;
#pragma unroll
  for (int w = 0; w < WP; ++w) {
    M0 = fmaxf(M0, ml_s[((w * NB + nb) * 8 + 2 * tq) * 2]);
    M1 = fmaxf(M1, ml_s[((w * NB + nb) * 8 + 2 * tq + 1) * 2]);
  }
  const float w0 = __expf(m0 - M0), w1 = __expf(m1 - M1);
#pragma unroll
  for (int db = 0; db < ND; ++db) {
    if (db < nd) {
      const int d = db * 16 + gq;
      red[(warp * 8 + 2 * tq) * D + d] = o[db][0] * w0;
      red[(warp * 8 + 2 * tq + 1) * D + d] = o[db][1] * w1;
      red[(warp * 8 + 2 * tq) * D + d + 8] = o[db][2] * w0;
      red[(warp * 8 + 2 * tq + 1) * D + d + 8] = o[db][3] * w1;
    }
  }
  __syncthreads();
  for (int i = tid; i < qpk * D; i += 128) {
    const int hh = i / D, d = i - hh * D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WP; ++w) a += red[((w * NB + hh / 8) * 8 + hh % 8) * D + d];
    part_acc[(((int64_t)b * H + g * qpk + hh) * S + s) * D + d] = a;
  }
  for (int hh = tid; hh < qpk; hh += 128) {
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int w = 0; w < WP; ++w) M = fmaxf(M, ml_s[((w * NB + hh / 8) * 8 + hh % 8) * 2]);
#pragma unroll
    for (int w = 0; w < WP; ++w) {
      const float* e = ml_s + ((w * NB + hh / 8) * 8 + hh % 8) * 2;
      L += e[1] * __expf(e[0] - M);
    }
    const int64_t part = ((int64_t)b * H + g * qpk + hh) * S + s;
    part_ml[2 * part] = M;
    part_ml[2 * part + 1] = L;
  }
  arrive_and_merge(q, cur_k, cur_v, part_acc, part_ml, tickets, out, b, g, H, Hkv, D, S,
                   sp.used, scale, tail);
}

// ---- f32: CUDA cores ---------------------------------------------------------

template <int NSTAGE>
__global__ void __launch_bounds__(1024) paged_decode_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, const float* __restrict__ cur_k,
    const float* __restrict__ cur_v, float* part_acc, float* part_ml, int* tickets,
    float* __restrict__ out, int H, int Hkv, int D, int block, int max_blocks,
    int split_len, float scale) {
  using T = float;
  constexpr int VN = 4;  // floats in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, b = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int qpk = H / Hkv;
  const int h = g * qpk + warp;
  const int row_bytes = D * (int)sizeof(T);
  const int C = row_bytes / 16;       // 16-byte chunks per row
  const int stride = row_bytes + 16;  // padded shared-memory row
  const int stage_bytes = 2 * kTile * stride;  // K tile + V tile

  const Split sp(cached_len(seq_lens, b, max_blocks * block), S, split_len, s);
  if (s >= sp.used) return;
  const int start = sp.start, end = sp.end;

  unsigned char* kv_s = smem;
  unsigned char* q_s = smem + NSTAGE * stage_bytes;
  float* p_s = reinterpret_cast<float*>(q_s + qpk * row_bytes);
  const Tail tail(reinterpret_cast<unsigned char*>(p_s + qpk * kTile), split_len / block + 2);

  const int pg0 = start / block;
  const int npg = end > start ? (end - 1) / block - pg0 + 1 : 0;
  for (int i = tid; i < npg; i += nthreads)
    tail.pages[i] = block_tables[(int64_t)b * max_blocks + pg0 + i];
  const uint4* qg = reinterpret_cast<const uint4*>(q + ((int64_t)b * H + g * qpk) * D);
  for (int i = tid; i < qpk * C; i += nthreads)
    reinterpret_cast<uint4*>(q_s)[i] = qg[i];
  __syncthreads();

  const int64_t row_elems = (int64_t)Hkv * D;  // between positions in a page
  // PV lane layout: CP lanes per output row (one 16-byte chunk each, CH
  // chunks when a row has more than 32), P = 32 / CP position groups.
  int CP = 1;
  while (CP < C && CP < 32) CP <<= 1;
  const int P = 32 / CP, grp = lane / CP, cl = lane % CP;
  const int CH = (C + 31) / 32;

  float m = kNegInf, l = 0.f;
  float acc[2][VN];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int v = 0; v < VN; ++v) acc[j][v] = 0.f;

  // Ring of NSTAGE tile buffers; one commit group per tile slot (empty
  // groups past the last tile keep the wait count constant).
  const int ntiles = (end - start + kTile - 1) / kTile;
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < ntiles)
      load_kv_tile(kv_s + st * stage_bytes, kTile, start + st * kTile, start, end, k_pages,
                   v_pages, tail.pages, pg0, block, row_elems, g, D, stride);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int ts = start + it * kTile;
    cp_async_wait<NSTAGE - 2>();  // tile `it` has landed
    __syncthreads();  // ...for every thread; and tile it-1's buffer is free
    const int nxt = it + NSTAGE - 1;
    if (nxt < ntiles)
      load_kv_tile(kv_s + (nxt % NSTAGE) * stage_bytes, kTile, start + nxt * kTile, start,
                   end, k_pages, v_pages, tail.pages, pg0, block, row_elems, g, D, stride);
    cp_async_commit();
    const unsigned char* base = kv_s + (it % NSTAGE) * stage_bytes;

    // QK: lane = position.
    const bool valid = ts + lane < end;
    const unsigned char* krow = base + lane * stride;
    const unsigned char* qrow = q_s + warp * row_bytes;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float kf[VN], qf[VN];
      load_f4(*reinterpret_cast<const uint4*>(krow + c * 16), kf);
      load_f4(*reinterpret_cast<const uint4*>(qrow + c * 16), qf);
#pragma unroll
      for (int v = 0; v < VN; v += 2) {
        s0 += qf[v] * kf[v];
        s1 += qf[v + 1] * kf[v + 1];
      }
    }
    const float logit = valid ? (s0 + s1) * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(logit));
    const float corr = expf(m - m_new);
    const float p = valid ? expf(logit - m_new) : 0.f;
    l = l * corr + warp_sum(p);
    p_s[warp * kTile + lane] = p;
    __syncwarp();

    // PV: lanes own output chunks; position groups take alternate rows.
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < VN; ++v) acc[j][v] *= corr;
    for (int t = grp; t < kTile; t += P) {
      const float pt = p_s[warp * kTile + t];
      const unsigned char* vrow = base + (kTile + t) * stride;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = cl + 32 * j;
        if (j < CH && c < C) {
          float vf[VN];
          load_f4(*reinterpret_cast<const uint4*>(vrow + c * 16), vf);
#pragma unroll
          for (int v = 0; v < VN; ++v) acc[j][v] += pt * vf[v];
        }
      }
    }
    m = m_new;
  }
  cp_async_wait<0>();

  // Sum the position groups, then group 0 writes the partial row.
  for (int o = 16; o >= CP; o >>= 1)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < VN; ++v)
        acc[j][v] += __shfl_xor_sync(0xffffffffu, acc[j][v], o);
  const int64_t part = ((int64_t)b * H + h) * S + s;
  if (grp == 0) {
    float* dst = part_acc + part * D;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = cl + 32 * j;
      if (j < CH && c < C)
#pragma unroll
        for (int v = 0; v < VN; ++v) dst[c * VN + v] = acc[j][v];
    }
  }
  if (lane == 0) {
    part_ml[2 * part] = m;
    part_ml[2 * part + 1] = l;
  }
  arrive_and_merge(q, cur_k, cur_v, part_acc, part_ml, tickets, out, b, g, H, Hkv, D, S,
                   sp.used, scale, tail);
}

constexpr size_t kSmemBudget = 200 * 1024;  // of the 227 KB a block may use

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *kp, *vp, *ck, *cv;
  const int *bt, *sl;
  float *pa, *pm;
  int* tickets;
  void* out;
  int B, H, Hkv, D, block, max_blocks, S, split_len;
  float scale;
  cudaStream_t stream;
};

template <int NB, int DMAX, int NSTAGE>
cudaError_t launch_mma(const Args& a) {
  const size_t smem = NSTAGE * 2 * kChunk * (size_t)(a.D * 2 + 16) +
                      Tail::bytes(a.split_len / a.block + 2);
  auto kern = paged_decode_mma_kernel<NB, DMAX, NSTAGE>;
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.Hkv, a.B, a.S), dim3(128), smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kp),
      static_cast<const bf16*>(a.vp), a.bt, a.sl, static_cast<const bf16*>(a.ck),
      static_cast<const bf16*>(a.cv), a.pa, a.pm, a.tickets, static_cast<bf16*>(a.out), a.H,
      a.Hkv, a.D, a.block, a.max_blocks, a.split_len, a.scale);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_mma_nb(const Args& a) {
  // Three stages where they fit in ~110 KB (two CTAs per SM), else two.
  const size_t stage = 2 * kChunk * (size_t)(a.D * 2 + 16);
  const bool three = 3 * stage <= 110 * 1024;
  if (a.D <= 128)
    return three ? launch_mma<NB, 128, 3>(a) : launch_mma<NB, 128, 2>(a);
  return three ? launch_mma<NB, 256, 3>(a) : launch_mma<NB, 256, 2>(a);
}

template <int NSTAGE>
cudaError_t launch_simt(const Args& a, size_t smem) {
  auto kern = paged_decode_simt_kernel<NSTAGE>;
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.Hkv, a.B, a.S), dim3(32 * (a.H / a.Hkv)), smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kp),
      static_cast<const float*>(a.vp), a.bt, a.sl, static_cast<const float*>(a.ck),
      static_cast<const float*>(a.cv), a.pa, a.pm, a.tickets, static_cast<float*>(a.out), a.H,
      a.Hkv, a.D, a.block, a.max_blocks, a.split_len, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Args& a) {
  const int qpk = a.H / a.Hkv;
  const int row_bytes = a.D * 4;
  const size_t stage = 2 * kTile * (size_t)(row_bytes + 16);  // K + V tile
  const size_t extra = (size_t)qpk * row_bytes                // q rows
                       + (size_t)qpk * kTile * sizeof(float)  // p
                       + Tail::bytes(a.split_len / a.block + 2);
  if (extra + 4 * stage <= kSmemBudget) return launch_simt<4>(a, extra + 4 * stage);
  if (extra + 3 * stage <= kSmemBudget) return launch_simt<3>(a, extra + 3 * stage);
  return launch_simt<2>(a, extra + 2 * stage);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part_acc / part_ml are the caller's f32
// workspace of [B, H, S, D] and [B, H, S, 2]; tickets [B * Hkv] int32 is
// zero on entry and left zero; split_len is a multiple of 64 and
// S * split_len covers max_blocks * block. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for arguments the
// kernel does not take (the Python wrapper checks these first).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, const void* cur_k,
    const void* cur_v, void* out, void* part_acc, void* part_ml, void* tickets, int B,
    int H, int Hkv, int D, int block, int max_blocks, int S, int split_len,
    int dtype, void* stream) {
  if (B < 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > 32 || D <= 0 ||
      D % 16 != 0 || D > 256 || block <= 0 || max_blocks <= 0 || S <= 0 ||
      split_len <= 0 || split_len % kChunk != 0 ||
      (long long)S * split_len < (long long)max_blocks * block ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a{q,
         k_pages,
         v_pages,
         cur_k,
         cur_v,
         static_cast<const int*>(block_tables),
         static_cast<const int*>(seq_lens),
         static_cast<float*>(part_acc),
         static_cast<float*>(part_ml),
         static_cast<int*>(tickets),
         out,
         B,
         H,
         Hkv,
         D,
         block,
         max_blocks,
         S,
         split_len,
         1.0f / sqrtf((float)D),
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_f32(a);
  const int qpk = H / Hkv;
  return (int)(qpk <= 8 ? launch_mma_nb<1>(a) : qpk <= 16 ? launch_mma_nb<2>(a)
                                                         : launch_mma_nb<4>(a));
}
