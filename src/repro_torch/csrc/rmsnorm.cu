// Fused RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w over the last axis,
// computed in fp32 and written in x's dtype.
//
// Replaces src/repro/kernels/rmsnorm.py::rmsnorm_pallas (_rms_kernel), which
// normalises a (rows_block, D) VMEM tile per grid step.  Here one block of
// 256 threads owns one row: each thread sums the squares of its slice of the
// row in fp32, the block reduces the sums through warp shuffles and one
// shared-memory step, and a second pass (the row is now in L1/L2) writes
// (x * r) * w, the reference's order, with r = 1 / sqrtf(mean + eps)
// (correctly rounded sqrt and divide, no fast-math rsqrt).
//
// Any D: rows whose width is a multiple of 16 bytes are read and written 16
// bytes a thread (8 bf16 or 4 fp32 values); other widths one value a thread.
// Bound: device-memory bytes (x read once, out written once, w read once),
// a few FLOPs per byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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
__global__ void __launch_bounds__(THREADS) rmsnorm_kernel(const T* __restrict__ x,
                                                          const float* __restrict__ w,
                                                          T* __restrict__ out, int D, float eps) {
  using P = Pack<T, VEC>;
  static_assert(VEC == 1 || sizeof(P) == 16, "vector accesses are 16 bytes");
  __shared__ float warp_sums[THREADS / 32];
  __shared__ float total;

  const size_t row = blockIdx.x;
  const P* xr = reinterpret_cast<const P*>(x + row * D);
  P* orow = reinterpret_cast<P*>(out + row * D);
  const int n = D / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const P pk = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f(pk.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (threadIdx.x == 0) total = t;
  }
  __syncthreads();
  const float r = 1.f / sqrtf(total / static_cast<float>(D) + eps);

  for (int i = threadIdx.x; i < n; i += THREADS) {
    const P pk = xr[i];
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f<T>(to_f(pk.v[e]) * r * w[i * VEC + e]);
    orow[i] = o;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* out, long long rows, int D, float eps,
                   int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid(static_cast<unsigned>(rows));
  if (vec == V) {
    rmsnorm_kernel<T, V><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), w,
                                                      static_cast<T*>(out), D, eps);
  } else {
    rmsnorm_kernel<T, 1><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), w,
                                                      static_cast<T*>(out), D, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns the launch's
// cudaError_t; the caller raises on anything but 0.  x and out are (rows, D)
// contiguous, w is (D,) fp32.  `vec` is 16 bytes' worth of values (4 fp32,
// 8 bf16) when D is a multiple of it and every pointer is 16-byte aligned,
// else 1.
extern "C" int veer_rmsnorm(const void* x, const float* w, void* out, int dtype, long long rows,
                            int D, float eps, int vec, void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(x, w, out, rows, D, eps, vec, s)
                                     : launch<__nv_bfloat16>(x, w, out, rows, D, eps, vec, s);
  return static_cast<int>(err);
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
