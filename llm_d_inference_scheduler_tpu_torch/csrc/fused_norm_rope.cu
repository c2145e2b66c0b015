// RMSNorm, QK-norm and RoPE of the served layer for Hopper (sm_90a), bound
// to PyTorch with ctypes: K4.
//
// Replaces no TPU kernel. The JAX package computes its norms and rotary
// embeddings as plain jnp (llm_d_inference_scheduler_tpu/ops/norms.py:
// rms_norm, ops/rope.py: apply_rope); their eager ports (ops/norms.py,
// ops/rope.py) run each call as 9-10 launches of f32 passes over the row:
// casts, a broadcast multiply, a mean reduce, a reciprocal square root,
// RoPE's multiplies over strided halves and a concatenation. A served layer
// calls them six times. These kernels compute the same functions in one
// pass each.
//
// Two entry points:
//   rms_norm      rows [R, W] -> out [R, W]: x * rsqrt(mean(x^2) + eps) * w.
//                 With a residual r it first forms s = r + x, rounded to
//                 the dtype, writes s and normalises s: the layer's
//                 `x = x + attn; h = norm(x)` in one pass.
//   qk_norm_rope  q [T, Hq, D] and k [T, Hk, D] in one launch: for every
//                 (token, head) row, the per-head RMSNorm with q_norm or
//                 k_norm (where given), rounded to the dtype, then the
//                 non-interleaved rotation of (x[:D/2], x[D/2:]) by the
//                 token's cos/sin [T, D/2] (f32).
//
// Bound on an H100 SXM (3.35 TB/s): bytes, at about 0.5 FLOP a byte. At
// Qwen3-32B's serving window (1024 tokens, width 5120, 64 + 8 heads of 128)
// a norm moves 21 MB (6.3 us at the bandwidth), with the residual 42 MB
// (12.5 us), and the QK-norm and RoPE 38 MB (11.4 us): about 30 us a
// layer, 1.9 ms a window of 64 layers.
//
// Design:
//   * rms_norm: one CTA per row. Each thread loads its VPT 16-byte vectors
//     of the row once (coalesced: vector j of thread t is t + j * blockDim)
//     and keeps them in f32 registers; the sum of squares goes through warp
//     shuffles and one shared-memory step; the output is written once in
//     the input's dtype. VPT (1, 2, 4 or 8) keeps the CTA at 256 threads or
//     fewer up to width 8192 bf16.
//   * qk_norm_rope: one CTA per token. Its q and k rows (18 KB at Qwen3's
//     64 + 8 heads) are copied into shared memory with cp.async, all in
//     flight at once and holding no registers, so many tokens' bytes are
//     in flight on an SM (a first design that loaded rows into registers
//     held 2 CTAs an SM and reached 57 % of the bandwidth). Then up to 4
//     warps walk the rows: a row is LPR lanes, each holding one 16-byte
//     vector of each half (LPR 8 for bf16 at head_dim 128: a warp holds 4
//     rows), so the rotation needs no shuffle and the sum of squares takes
//     log2(LPR) shuffles; a head dim whose half does not split so takes a
//     warp a row. Each lane reads the token's cos/sin and the norm weights
//     once, while the rows land. Outputs go straight to global memory.
//   * Rounding follows the eager chain: f32 inside; the normed q/k rounded
//     to the dtype before RoPE; the output rounded once. Products and sums
//     use the _rn intrinsics, which the compiler never contracts into an
//     FMA, so they round as the eager kernels' separate multiplies and adds
//     do: RoPE alone gives the eager bits exactly, and a norm differs from
//     eager only by the order of its f32 sum of squares.
//   * Widths: multiples of 8 from 8 to 32768 (16-byte vectors, rows
//     16-byte aligned); head dims: multiples of 16 from 16 to 256; a
//     token's q and k rows up to 48 KB (Qwen3-32B's take 36 KB in f32). f32
//     and bf16. The wrapper (ops/fused_norm.py) allocates the outputs; nothing
//     here synchronises, and each entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_WIDTH = 32768;
constexpr int MAX_HEAD_DIM = 256;
constexpr int QK_WARPS = 4;  // warps of a qk_norm_rope CTA (at most)
// Shared memory a qk_norm_rope CTA may take for its token's rows: the
// dynamic size a launch gets without an opt-in (36 KB covers the widest
// token the port serves, 64 + 8 heads of 128 in f32).
constexpr int QK_MAX_SMEM = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// N elements of T moved as one aligned vector access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1 / sqrt(mean + eps) with the eager chain's roundings: the mean as the
// sum times 1/n (as PyTorch's CUDA mean), an IEEE square root and an IEEE
// reciprocal.
__device__ __forceinline__ float inv_rms(float sum_sq, int n, float eps) {
  const float mean = __fmul_rn(sum_sq, __frcp_rn(static_cast<float>(n)));
  return __frcp_rn(__fsqrt_rn(__fadd_rn(mean, eps)));
}

// ---- rms_norm ----------------------------------------------------------------

// The most threads a CTA of VPT vectors a thread takes (dispatch_rms_norm):
// 256 below VPT 8; at VPT 8, MAX_WIDTH's row (1024 f32, 512 bf16).
constexpr int rms_max_threads(int vpt, int elem_bytes) {
  return vpt < 8 ? 256 : MAX_WIDTH * elem_bytes / 16 / 8;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(rms_max_threads(VPT, sizeof(T)))
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ w,
                    T* __restrict__ out, T* __restrict__ res_out, int width, float eps) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  __shared__ float partial[32];
  const int nvec = width / V;
  const size_t base = static_cast<size_t>(blockIdx.x) * width;
  const P* xr = reinterpret_cast<const P*>(x + base);
  float v[VPT][V];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      P a = xr[i];
      if (res != nullptr) {
        const P b = reinterpret_cast<const P*>(res + base)[i];
#pragma unroll
        for (int e = 0; e < V; ++e)
          a.v[e] = from_f32<T>(__fadd_rn(to_f32(b.v[e]), to_f32(a.v[e])));
        reinterpret_cast<P*>(res_out + base)[i] = a;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[j][e] = to_f32(a.v[e]);
        ss = fmaf(v[j][e], v[j][e], ss);
      }
    }
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    ss = warp_sum(lane < nwarps ? partial[lane] : 0.f);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float inv = inv_rms(partial[0], width, eps);
  const P* wr = reinterpret_cast<const P*>(w);
  P* o = reinterpret_cast<P*>(out + base);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      const P wv = wr[i];
      P r;
#pragma unroll
      for (int e = 0; e < V; ++e)
        r.v[e] = from_f32<T>(__fmul_rn(__fmul_rn(v[j][e], inv), to_f32(wv.v[e])));
      o[i] = r;
    }
  }
}

template <typename T, int VPT>
cudaError_t launch_rms_norm(const void* x, const void* res, const void* w, void* out,
                            void* res_out, int rows, int width, float eps, cudaStream_t s) {
  const int nvec = width / (16 / static_cast<int>(sizeof(T)));
  const int threads = ((nvec + VPT - 1) / VPT + 31) / 32 * 32;
  rms_norm_kernel<T, VPT><<<rows, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<T*>(res_out), width, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rms_norm(const void* x, const void* res, const void* w, void* out,
                              void* res_out, int rows, int width, float eps, cudaStream_t s) {
  // The fewest vectors a thread that keeps the CTA at 256 threads or
  // fewer; 8 (up to 1024 threads) past that.
  const int nvec = width / (16 / static_cast<int>(sizeof(T)));
  auto f = nvec <= 256   ? launch_rms_norm<T, 1>
           : nvec <= 512 ? launch_rms_norm<T, 2>
           : nvec <= 1024 ? launch_rms_norm<T, 4>
                          : launch_rms_norm<T, 8>;
  return f(x, res, w, out, res_out, rows, width, eps, s);
}

// ---- qk_norm_rope --------------------------------------------------------------

// N elements of T at p (aligned to the 16-byte chunks it is read in, or to
// the whole when smaller); zeros where the lane holds none.
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const T* p, bool active) {
  constexpr int CHUNK = N * sizeof(T) < 16 ? N : 16 / sizeof(T);
  Pack<T, N> out;
#pragma unroll
  for (int c = 0; c < N; c += CHUNK) {
    Pack<T, CHUNK> a;
    if (active) {
      a = *reinterpret_cast<const Pack<T, CHUNK>*>(p + c);
    } else {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) a.v[i] = from_f32<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) out.v[c + i] = a.v[i];
  }
  return out;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

// One CTA a token: its q and k rows are copied into shared memory with
// cp.async (all in flight at once, no registers held), then each warp
// walks row groups: a row is LPR lanes (a power of two up to 32), each
// holding PAIRS elements of each half, so a warp holds 32 / LPR rows.
template <typename T, int PAIRS, int LPR>
__global__ void __launch_bounds__(QK_WARPS * 32)
    qk_norm_rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ qw, const T* __restrict__ kw,
                        const float* __restrict__ cos, const float* __restrict__ sin,
                        T* __restrict__ q_out, T* __restrict__ k_out, int hq, int hk,
                        int head_dim, float eps) {
  using P = Pack<T, PAIRS>;
  constexpr int V = 16 / sizeof(T);
  constexpr int RPW = 32 / LPR;  // rows a warp holds at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows_sm = reinterpret_cast<T*>(smem_raw);  // [hq + hk, head_dim]
  const size_t t = blockIdx.x;
  const int nq = hq * head_dim, nk = hk * head_dim;
  for (int i = threadIdx.x * V; i < nq; i += blockDim.x * V)
    cp_async16(rows_sm + i, q + t * nq + i);
  for (int i = threadIdx.x * V; i < nk; i += blockDim.x * V)
    cp_async16(rows_sm + nq + i, k + t * nk + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int half = head_dim / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sub = lane / LPR;  // the lane's row within the warp's group
  const int e0 = (lane % LPR) * PAIRS;
  const bool holds = e0 < half;
  const bool norm = qw != nullptr;
  const int rows = hq + hk;
  const int groups = (rows + RPW - 1) / RPW;
  // The token's cos/sin and the norm weights, read while the rows land.
  const Pack<float, PAIRS> c = load_pack<float, PAIRS>(cos + t * half + e0, holds);
  const Pack<float, PAIRS> s = load_pack<float, PAIRS>(sin + t * half + e0, holds);
  P wq1, wq2, wk1, wk2;  // the norm weights' halves
  if (norm) {
    wq1 = load_pack<T, PAIRS>(qw + e0, holds);
    wq2 = load_pack<T, PAIRS>(qw + half + e0, holds);
    wk1 = load_pack<T, PAIRS>(kw + e0, holds);
    wk2 = load_pack<T, PAIRS>(kw + half + e0, holds);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int g = warp; g < groups; g += nwarps) {
    const int r = g * RPW + sub;
    const bool on = holds && r < rows;
    const bool is_q = r < hq;
    const P ra = load_pack<T, PAIRS>(rows_sm + r * head_dim + e0, on);
    const P rb = load_pack<T, PAIRS>(rows_sm + r * head_dim + half + e0, on);
    float a[PAIRS], b[PAIRS];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      a[i] = to_f32(ra.v[i]);
      b[i] = to_f32(rb.v[i]);
    }
    if (norm) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) ss = fmaf(b[i], b[i], fmaf(a[i], a[i], ss));
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = inv_rms(ss, head_dim, eps);
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const float w1 = to_f32(is_q ? wq1.v[i] : wk1.v[i]);
        const float w2 = to_f32(is_q ? wq2.v[i] : wk2.v[i]);
        a[i] = to_f32(from_f32<T>(__fmul_rn(__fmul_rn(a[i], inv), w1)));
        b[i] = to_f32(from_f32<T>(__fmul_rn(__fmul_rn(b[i], inv), w2)));
      }
    }
    if (on) {
      P o1, o2;
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        o1.v[i] = from_f32<T>(__fsub_rn(__fmul_rn(a[i], c.v[i]), __fmul_rn(b[i], s.v[i])));
        o2.v[i] = from_f32<T>(__fadd_rn(__fmul_rn(b[i], c.v[i]), __fmul_rn(a[i], s.v[i])));
      }
      T* dst = is_q ? q_out + t * nq + r * head_dim : k_out + t * nk + (r - hq) * head_dim;
      *reinterpret_cast<P*>(dst + e0) = o1;
      *reinterpret_cast<P*>(dst + half + e0) = o2;
    }
  }
}

template <typename T, int PAIRS, int LPR>
cudaError_t launch_qk(const void* q, const void* k, const void* qw, const void* kw,
                      const float* cos, const float* sin, void* q_out, void* k_out, int tokens,
                      int hq, int hk, int head_dim, float eps, cudaStream_t s) {
  const int groups = (hq + hk + 32 / LPR - 1) / (32 / LPR);
  const int warps = groups < QK_WARPS ? groups : QK_WARPS;
  const int smem = (hq + hk) * head_dim * static_cast<int>(sizeof(T));
  if (smem > QK_MAX_SMEM) return cudaErrorInvalidValue;
  qk_norm_rope_kernel<T, PAIRS, LPR><<<tokens, warps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(qw),
      static_cast<const T*>(kw), cos, sin, static_cast<T*>(q_out), static_cast<T*>(k_out), hq,
      hk, head_dim, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_qk(const void* q, const void* k, const void* qw, const void* kw,
                        const float* cos, const float* sin, void* q_out, void* k_out, int tokens,
                        int hq, int hk, int head_dim, float eps, cudaStream_t s) {
  // A 16-byte vector of each half a lane where the half splits into a
  // power-of-two count of them (bf16: head dims 16, 32, 64, 128, 256; f32:
  // 16-256 as well); else a whole warp a row, 1, 2 or 4 elements a lane.
  constexpr int V = 16 / sizeof(T);
  const int half = head_dim / 2;
  const int lanes = half / V;
  decltype(&launch_qk<T, 1, 32>) f;
  if (half % V == 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0) {
    f = lanes == 1    ? launch_qk<T, V, 1>
        : lanes == 2  ? launch_qk<T, V, 2>
        : lanes == 4  ? launch_qk<T, V, 4>
        : lanes == 8  ? launch_qk<T, V, 8>
        : lanes == 16 ? launch_qk<T, V, 16>
                      : launch_qk<T, V, 32>;
  } else {
    f = half <= 32 ? launch_qk<T, 1, 32> : half <= 64 ? launch_qk<T, 2, 32> : launch_qk<T, 4, 32>;
  }
  return f(q, k, qw, kw, cos, sin, q_out, k_out, tokens, hq, hk, head_dim, eps, s);
}

}  // namespace

// x, residual, out, residual_out: [rows, width] in the dtype (0 f32, 1
// bf16); weight [width] in the dtype. residual and residual_out come
// together or not at all. Returns a cudaError_t.
extern "C" int rms_norm(const void* x, const void* residual, const void* weight, void* out,
                        void* residual_out, int rows, int width, float eps, int dtype,
                        void* stream) {
  if (rows < 0 || width < 8 || width > MAX_WIDTH || width % 8 != 0 ||
      (dtype != 0 && dtype != 1) || x == nullptr || weight == nullptr || out == nullptr ||
      (residual == nullptr) != (residual_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = dtype == 1 ? dispatch_rms_norm<bf16> : dispatch_rms_norm<float>;
  return (int)f(x, residual, weight, out, residual_out, rows, width, eps, s);
}

// q [tokens, hq, head_dim], k [tokens, hk, head_dim] and the outputs in
// the dtype; q_norm and k_norm [head_dim] in the dtype, both or neither;
// cos and sin [tokens, head_dim / 2] f32. Returns a cudaError_t.
extern "C" int qk_norm_rope(const void* q, const void* k, const void* q_norm,
                            const void* k_norm, const void* cos, const void* sin, void* q_out,
                            void* k_out, int tokens, int hq, int hk, int head_dim, float eps,
                            int dtype, void* stream) {
  if (tokens < 0 || hq < 0 || hk < 0 || hq + hk == 0 || head_dim < 16 ||
      head_dim > MAX_HEAD_DIM || head_dim % 16 != 0 || (dtype != 0 && dtype != 1) ||
      (q_norm == nullptr) != (k_norm == nullptr) || cos == nullptr || sin == nullptr ||
      (hq > 0 && (q == nullptr || q_out == nullptr)) ||
      (hk > 0 && (k == nullptr || k_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (tokens == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = dtype == 1 ? dispatch_qk<bf16> : dispatch_qk<float>;
  return (int)f(q, k, q_norm, k_norm, static_cast<const float*>(cos),
                static_cast<const float*>(sin), q_out, k_out, tokens, hq, hk, head_dim, eps, s);
}
