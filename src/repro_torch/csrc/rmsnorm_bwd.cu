// Fused RMSNorm, backward: with r = rsqrt(mean(x^2) + eps) per row,
//   dx = r * (w * g) - (x * r^3) * mean(x * w * g)   in x's dtype,
//   dw = sum over rows of (g * x) * r                in fp32,
// the gradients of csrc/rmsnorm.cu's out = x * r * w for the output gradient
// g, computed in fp32.
//
// Replaces the autodiff of the reference's RMSNorm (src/repro/kernels/ref.py:422
// rmsnorm_reference, which the reference trains through; its Pallas kernel
// src/repro/kernels/rmsnorm.py:20 has no backward).  Three launches, all
// deterministic (no atomics):
//
//   1. one block of 256 threads per row: the row's sum of squares and
//      sum of x * w * g in one pass (fp32, warp shuffles, one shared-memory
//      step), then dx in a second pass (the row is in L1/L2 by then), and r
//      for the row into a scratch vector;
//   2. per tile of 256 columns and ROWS_PER_PARTIAL = 64 rows, each thread
//      sums (g * x) * r down its column in row order: one fp32 partial of dw
//      per (row tile, column), coalesced across the block's threads;
//   3. one thread per column sums its partials in row-tile order.
//
// Any D: rows whose width is a multiple of 16 bytes are read and written 16
// bytes a thread in launch 1, other widths one value a thread.  Bound:
// device-memory bytes (x and g read, dx written; launch 2 reads x and g again,
// about 5/3 of the least bytes), a few FLOPs per byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_PARTIAL = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// VEC values of T per access: 16 bytes when VEC * sizeof(T) == 16, else 1.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) rmsnorm_bwd_dx_kernel(const T* __restrict__ x,
                                                                 const float* __restrict__ w,
                                                                 const T* __restrict__ g,
                                                                 T* __restrict__ dx,
                                                                 float* __restrict__ rs, int D,
                                                                 float eps) {
  using P = Pack<T, VEC>;
  static_assert(VEC == 1 || sizeof(P) == 16, "vector accesses are 16 bytes");
  __shared__ float warp_sums[2][THREADS / 32];
  __shared__ float totals[2];

  const size_t row = blockIdx.x;
  const P* xr = reinterpret_cast<const P*>(x + row * D);
  const P* gr = reinterpret_cast<const P*>(g + row * D);
  P* dxr = reinterpret_cast<P*>(dx + row * D);
  const int n = D / VEC;

  float ss = 0.f, sxwg = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const P xp = xr[i];
    const P gp = gr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xf = to_f(xp.v[e]);
      ss = fmaf(xf, xf, ss);
      sxwg = fmaf(xf, w[i * VEC + e] * to_f(gp.v[e]), sxwg);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
    sxwg += __shfl_xor_sync(0xffffffffu, sxwg, off);
  }
  if (threadIdx.x % 32 == 0) {
    warp_sums[0][threadIdx.x / 32] = ss;
    warp_sums[1][threadIdx.x / 32] = sxwg;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float a = threadIdx.x < THREADS / 32 ? warp_sums[0][threadIdx.x] : 0.f;
    float c = threadIdx.x < THREADS / 32 ? warp_sums[1][threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (threadIdx.x == 0) {
      totals[0] = a;
      totals[1] = c;
    }
  }
  __syncthreads();
  const float r = 1.f / sqrtf(totals[0] / static_cast<float>(D) + eps);
  const float r3 = r * r * r;
  const float mean_xwg = totals[1] / static_cast<float>(D);
  if (threadIdx.x == 0) rs[row] = r;

  for (int i = threadIdx.x; i < n; i += THREADS) {
    const P xp = xr[i];
    const P gp = gr[i];
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float wg = w[i * VEC + e] * to_f(gp.v[e]);
      o.v[e] = from_f<T>(r * wg - to_f(xp.v[e]) * r3 * mean_xwg);
    }
    dxr[i] = o;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rmsnorm_bwd_dw_partial_kernel(const T* __restrict__ x,
                                                                         const T* __restrict__ g,
                                                                         const float* __restrict__ rs,
                                                                         float* __restrict__ part,
                                                                         long long rows, int D) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= D) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * ROWS_PER_PARTIAL;
  const long long r1 = r0 + ROWS_PER_PARTIAL < rows ? r0 + ROWS_PER_PARTIAL : rows;
  float acc = 0.f;
  for (long long row = r0; row < r1; ++row) {
    const size_t off = static_cast<size_t>(row) * D + col;
    acc += to_f(g[off]) * to_f(x[off]) * rs[row];
  }
  part[static_cast<size_t>(blockIdx.y) * D + col] = acc;
}

__global__ void __launch_bounds__(THREADS) rmsnorm_bwd_dw_reduce_kernel(const float* __restrict__ part,
                                                                        float* __restrict__ dw,
                                                                        int n_part, int D) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= D) return;
  float acc = 0.f;
  for (int i = 0; i < n_part; ++i) acc += part[static_cast<size_t>(i) * D + col];
  dw[col] = acc;
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const void* g, void* dx, float* dw, float* rs,
                   float* part, long long rows, int D, float eps, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (vec == V) {
    rmsnorm_bwd_dx_kernel<T, V><<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
        xt, w, gt, static_cast<T*>(dx), rs, D, eps);
  } else {
    rmsnorm_bwd_dx_kernel<T, 1><<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
        xt, w, gt, static_cast<T*>(dx), rs, D, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_part = static_cast<int>((rows + ROWS_PER_PARTIAL - 1) / ROWS_PER_PARTIAL);
  const unsigned col_blocks = static_cast<unsigned>((D + THREADS - 1) / THREADS);
  rmsnorm_bwd_dw_partial_kernel<T><<<dim3(col_blocks, n_part), THREADS, 0, stream>>>(xt, gt, rs, part,
                                                                                     rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dw_reduce_kernel<<<col_blocks, THREADS, 0, stream>>>(part, dw, n_part, D);
  return cudaGetLastError();
}

}  // namespace

// The number of fp32 partials of dw per column for `rows` rows: the wrapper
// allocates n_partials(rows) * D floats of scratch for `part`.
extern "C" long long veer_rmsnorm_bwd_partials(long long rows) {
  return (rows + ROWS_PER_PARTIAL - 1) / ROWS_PER_PARTIAL;
}

// Launches on `stream` (PyTorch's current stream) and returns the first
// failing launch's cudaError_t, else 0; the caller raises on anything but 0.
// x, g and dx are (rows, D) contiguous of one dtype (0: fp32, 1: bf16); w and
// dw (D,) fp32; rs (rows,) and part (n_partials(rows), D) fp32 scratch.
// `vec` is 16 bytes' worth of values (4 fp32, 8 bf16) when D is a multiple of
// it and x, g, dx are 16-byte aligned, else 1.  The partial tiles stack along
// the grid's y axis (at most 65535 of them: 4.19M rows).
extern "C" int veer_rmsnorm_bwd(const void* x, const float* w, const void* g, void* dx, float* dw,
                                float* rs, float* part, int dtype, long long rows, int D, float eps,
                                int vec, void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (rows > 2147483647LL || veer_rmsnorm_bwd_partials(rows) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(x, w, g, dx, dw, rs, part, rows, D, eps, vec, s)
                 : launch<__nv_bfloat16>(x, w, g, dx, dw, rs, part, rows, D, eps, vec, s);
  return static_cast<int>(err);
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
