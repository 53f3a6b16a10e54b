// Fused RMSNorm, backward: with r = rsqrt(mean(x^2) + eps) per row,
//   dx = r * (w * g) - (x * r^3) * mean(x * w * g)   in x's dtype,
//   dw = sum over rows of (g * x) * r                in fp32,
// the gradients of csrc/rmsnorm.cu's out = x * r * w for the output gradient
// g, computed in fp32.
//
// Replaces the autodiff of the reference's RMSNorm (src/repro/kernels/ref.py:422
// rmsnorm_reference, which the reference trains through; its Pallas kernel
// src/repro/kernels/rmsnorm.py:20 has no backward).
//
// Bound: device-memory bytes (x and g read, dx written; a few FLOPs per
// byte).  So x and g are read once, in one pass over the rows, and two
// launches do it all, deterministically (no atomics, the same bits on every
// run and every card):
//
//   1. one block of 256 threads per strip of 32 rows (fewer where the rows
//      would fill fewer than 256 blocks: the strip depends on the row count
//      alone, so the sums are the same on every card).  A thread owns
//      the same columns in every row: NV vectors of 16 bytes (one value where
//      the row or a pointer is not 16-byte aligned), w for them in
//      registers.  Per row it holds its x and g in registers (the next two
//      rows' are loaded meanwhile), reduces the sum of squares and the sum of
//      x * w * g over the block (warp shuffles, one shared-memory step),
//      writes dx from its registers and adds (g * x) * r into its fp32 dw
//      accumulators, in row order.  Narrow rows (at most 128 vectors, as
//      whisper-tiny's 384) go two or four at a time, each to its own group
//      of 128 or 64 threads, so that a strip is not 32 rows of latency one
//      after the other.  Rows wider than 256 * NV_MAX vectors keep their x
//      and g in shared memory instead (each thread reads back only what it
//      wrote, so no barrier guards it), and the accumulators too; a row
//      wider than shared memory holds (D > ~19,000 in fp32, ~29,000 in
//      bf16) keeps its accumulators in its partial of dw in device memory
//      and reads x and g a second time there (mostly from L2).  At the
//      end each group writes its fp32 partial of dw;
//   2. the partials of a column summed in a fixed order: eight warps add a
//      contiguous range of them each, in order, then their sums in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STRIP = 32;    // rows per block of launch 1 (fewer for fewer rows)
constexpr int MIN_BLOCKS = 256;  // blocks launch 1 aims at: two to each SM of an H100
constexpr int NV_MAX = 4;        // vectors per thread kept in registers
constexpr int REDUCE_COLS = 32;   // launch 2: a block of 32 columns ...
constexpr int REDUCE_SPLIT = 8;   // ... by 8 warps, each over a contiguous range of partials
constexpr int REDUCE_BATCH = 16;  // partials a thread loads at once

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

// The sums of two values over a group of WPG warps (the whole block when
// WPG = WARPS), the same in every thread of the group: each warp's by
// shuffles, then every thread adds its group's warp sums in order.  `buf`
// alternates between rows, so one barrier a row keeps a row's reads apart
// from the next row's writes.
template <int WPG>
__device__ __forceinline__ void group_sums(float& a, float& b, float (*buf)[2][WARPS], int parity) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    buf[parity][0][warp] = a;
    buf[parity][1][warp] = b;
  }
  __syncthreads();
  a = b = 0.f;
  const int w0 = warp / WPG * WPG;
#pragma unroll
  for (int w = 0; w < WPG; ++w) {
    a += buf[parity][0][w0 + w];
    b += buf[parity][1][w0 + w];
  }
}

// Launch 1 with each thread's x and g in registers.  The block's threads
// form GROUPS groups of THREADS / GROUPS that take rows r0 + g, r0 + g +
// GROUPS, ... of the strip (several rows at once where a row is narrow); a
// thread holds NV vectors of VEC values of its row, vectors i + k * (THREADS
// / GROUPS) for its index i in the group.  Each group writes its own fp32
// partial of dw: partial row blockIdx.x * GROUPS + g.
template <typename T, int VEC, int NV, int GROUPS>
__global__ void __launch_bounds__(THREADS) rmsnorm_bwd_rows_kernel(const T* __restrict__ x,
                                                                   const float* __restrict__ w,
                                                                   const T* __restrict__ g,
                                                                   T* __restrict__ dx,
                                                                   float* __restrict__ part, long long rows,
                                                                   int strip, int D, float eps) {
  using P = Pack<T, VEC>;
  static_assert(VEC == 1 || sizeof(P) == 16, "vector accesses are 16 bytes");
  constexpr int TPG = THREADS / GROUPS;  // threads per group
  __shared__ float buf[2][2][WARPS];
  const int n = D / VEC;
  const int grp = threadIdx.x / TPG, lane = threadIdx.x % TPG;
  const long long r0 = static_cast<long long>(blockIdx.x) * strip;
  const long long r1 = r0 + strip < rows ? r0 + strip : rows;

  float wv[NV][VEC], acc[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * TPG;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      wv[k][e] = i < n ? w[i * VEC + e] : 0.f;
      acc[k][e] = 0.f;
    }
  }
  auto load = [&](P(&xd)[NV], P(&gd)[NV], long long row) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + k * TPG;
      if (i < n) {
        xd[k] = reinterpret_cast<const P*>(x + row * D)[i];
        gd[k] = reinterpret_cast<const P*>(g + row * D)[i];
      }
    }
  };

  // x and g of the group's row and of its next two rows are in flight at
  // once; every group steps together (the barrier in group_sums), a group
  // whose row is past the strip computing nothing at that step
  P xv[NV], gv[NV], xn[NV], gn[NV];
  if (r0 + grp < r1) load(xv, gv, r0 + grp);
  if (r0 + grp + GROUPS < r1) load(xn, gn, r0 + grp + GROUPS);
  for (long long base = r0; base < r1; base += GROUPS) {
    const long long row = base + grp;
    const bool live = row < r1, far = row + 2 * GROUPS < r1;
    P x2[NV], g2[NV];
    if (far) load(x2, g2, row + 2 * GROUPS);
    float ss = 0.f, sxwg = 0.f;
    if (live) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (lane + k * TPG < n) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xf = to_f(xv[k].v[e]);
            ss = fmaf(xf, xf, ss);
            sxwg = fmaf(xf, wv[k][e] * to_f(gv[k].v[e]), sxwg);
          }
        }
      }
    }
    group_sums<WARPS / GROUPS>(ss, sxwg, buf, static_cast<int>(((base - r0) / GROUPS) & 1));
    if (live) {
      const float r = 1.f / sqrtf(ss / static_cast<float>(D) + eps);
      const float r3 = r * r * r;
      const float mean_xwg = sxwg / static_cast<float>(D);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = lane + k * TPG;
        if (i < n) {
          P o;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xf = to_f(xv[k].v[e]), gf = to_f(gv[k].v[e]);
            o.v[e] = from_f<T>(r * (wv[k][e] * gf) - xf * r3 * mean_xwg);
            acc[k][e] += gf * xf * r;
          }
          reinterpret_cast<P*>(dx + row * D)[i] = o;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {  // rows not loaded are past the strip: never read
      xv[k] = xn[k];
      gv[k] = gn[k];
      xn[k] = x2[k];
      gn[k] = g2[k];
    }
  }

  float* out = part + (static_cast<size_t>(blockIdx.x) * GROUPS + grp) * D;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * TPG;
    if (i < n) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[i * VEC + e] = acc[k][e];
    }
  }
}

// Launch 1 for rows wider than NV_MAX * THREADS vectors: the same arithmetic.
// STAGED: each thread's x, g and dw accumulators in dynamic shared memory (D
// fp32, then the row's x and g).  Otherwise (a row wider than shared memory
// holds) the accumulators live in the block's partial of dw and the second
// loop reads x and g again from device memory: the same operations in the
// same order.
template <typename T, int VEC, bool STAGED>
__global__ void __launch_bounds__(THREADS) rmsnorm_bwd_wide_kernel(const T* __restrict__ x,
                                                                   const float* __restrict__ w,
                                                                   const T* __restrict__ g,
                                                                   T* __restrict__ dx,
                                                                   float* __restrict__ part, long long rows,
                                                                   int strip, int D, float eps) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float buf[2][2][WARPS];
  const int n = D / VEC;
  float* out = part + static_cast<size_t>(blockIdx.x) * D;
  float* acc = STAGED ? smem : out;
  P* xs = reinterpret_cast<P*>(smem + D);
  P* gs = xs + n;
  const long long r0 = static_cast<long long>(blockIdx.x) * strip;
  const long long r1 = r0 + strip < rows ? r0 + strip : rows;
  for (int i = threadIdx.x; i < n; i += THREADS)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i * VEC + e] = 0.f;

  for (long long row = r0; row < r1; ++row) {
    const P* xr = reinterpret_cast<const P*>(x + row * D);
    const P* gr = reinterpret_cast<const P*>(g + row * D);
    float ss = 0.f, sxwg = 0.f;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const P xp = xr[i], gp = gr[i];
      if (STAGED) {
        xs[i] = xp;
        gs[i] = gp;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = to_f(xp.v[e]);
        ss = fmaf(xf, xf, ss);
        sxwg = fmaf(xf, w[i * VEC + e] * to_f(gp.v[e]), sxwg);
      }
    }
    group_sums<WARPS>(ss, sxwg, buf, static_cast<int>((row - r0) & 1));
    const float r = 1.f / sqrtf(ss / static_cast<float>(D) + eps);
    const float r3 = r * r * r;
    const float mean_xwg = sxwg / static_cast<float>(D);
    P* dxr = reinterpret_cast<P*>(dx + row * D);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const P xp = STAGED ? xs[i] : xr[i], gp = STAGED ? gs[i] : gr[i];
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = to_f(xp.v[e]), gf = to_f(gp.v[e]);
        o.v[e] = from_f<T>(r * (w[i * VEC + e] * gf) - xf * r3 * mean_xwg);
        acc[i * VEC + e] += gf * xf * r;
      }
      dxr[i] = o;
    }
  }

  if (STAGED)
    for (int i = threadIdx.x; i < n; i += THREADS)
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[i * VEC + e] = acc[i * VEC + e];
}

// Launch 2: dw[col] = the sum of the column's partials, in a fixed order:
// warp w of the block adds partials [w m, (w + 1) m) in order (m =
// n_part / REDUCE_SPLIT rounded up), then the warps' sums are added in warp
// order.
__global__ void __launch_bounds__(REDUCE_COLS * REDUCE_SPLIT) rmsnorm_bwd_dw_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ dw, int n_part, int D) {
  __shared__ float sums[REDUCE_SPLIT][REDUCE_COLS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * REDUCE_COLS + lane;
  const int m = (n_part + REDUCE_SPLIT - 1) / REDUCE_SPLIT;
  const int i0 = warp * m, i1 = min(i0 + m, n_part);
  float acc = 0.f;
  if (col < D) {
    int i = i0;
    for (; i + REDUCE_BATCH <= i1; i += REDUCE_BATCH) {  // the loads in flight at once
      float v[REDUCE_BATCH];
#pragma unroll
      for (int u = 0; u < REDUCE_BATCH; ++u) v[u] = part[static_cast<size_t>(i + u) * D + col];
#pragma unroll
      for (int u = 0; u < REDUCE_BATCH; ++u) acc += v[u];
    }
    for (; i < i1; ++i) acc += part[static_cast<size_t>(i) * D + col];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < D) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < REDUCE_SPLIT; ++w) total += sums[w][lane];
    dw[col] = total;
  }
}

// Rows processed at once by a block of launch 1 for `n` vectors a row: four
// where a row fits 64 threads, two where it fits 128, else one.
int row_groups(int n) { return n <= THREADS / 4 ? 4 : n <= THREADS / 2 ? 2 : 1; }

// Rows per block of launch 1: MAX_STRIP, or fewer where that would leave
// fewer than MIN_BLOCKS blocks; a function of the row count alone, so the
// sums are the same on every card.
int strip_rows(long long rows) {
  return static_cast<int>(rows >= static_cast<long long>(MAX_STRIP) * MIN_BLOCKS ? MAX_STRIP
                                                                               : (rows + MIN_BLOCKS - 1) / MIN_BLOCKS);
}

long long strips(long long rows) { return (rows + strip_rows(rows) - 1) / strip_rows(rows); }

template <typename T, int VEC>
cudaError_t launch_rows(const T* x, const float* w, const T* g, T* dx, float* part, long long rows, int D,
                        float eps, cudaStream_t stream) {
  const int n = D / VEC;
  const int strip = strip_rows(rows);
  const unsigned blocks = static_cast<unsigned>(strips(rows));
  if (n <= THREADS / 4) {
    rmsnorm_bwd_rows_kernel<T, VEC, 1, 4><<<blocks, THREADS, 0, stream>>>(x, w, g, dx, part, rows, strip, D, eps);
  } else if (n <= THREADS / 2) {
    rmsnorm_bwd_rows_kernel<T, VEC, 1, 2><<<blocks, THREADS, 0, stream>>>(x, w, g, dx, part, rows, strip, D, eps);
  } else if (n <= THREADS) {
    rmsnorm_bwd_rows_kernel<T, VEC, 1, 1><<<blocks, THREADS, 0, stream>>>(x, w, g, dx, part, rows, strip, D, eps);
  } else if (n <= 2 * THREADS) {
    rmsnorm_bwd_rows_kernel<T, VEC, 2, 1><<<blocks, THREADS, 0, stream>>>(x, w, g, dx, part, rows, strip, D, eps);
  } else if (n <= NV_MAX * THREADS) {
    rmsnorm_bwd_rows_kernel<T, VEC, NV_MAX, 1><<<blocks, THREADS, 0, stream>>>(x, w, g, dx, part, rows, strip,
                                                                               D, eps);
  } else {
    const size_t smem = D * sizeof(float) + 2 * static_cast<size_t>(D) * sizeof(T);
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem + sizeof(float) * 2 * 2 * WARPS <= static_cast<size_t>(optin)) {
      err = cudaFuncSetAttribute(rmsnorm_bwd_wide_kernel<T, VEC, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      rmsnorm_bwd_wide_kernel<T, VEC, true><<<blocks, THREADS, smem, stream>>>(x, w, g, dx, part, rows, strip, D,
                                                                               eps);
    } else {
      rmsnorm_bwd_wide_kernel<T, VEC, false><<<blocks, THREADS, 0, stream>>>(x, w, g, dx, part, rows, strip, D,
                                                                             eps);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const void* g, void* dx, float* dw, float* part,
                   long long rows, int D, float eps, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  cudaError_t err = vec == V ? launch_rows<T, V>(xt, w, gt, dxt, part, rows, D, eps, stream)
                             : launch_rows<T, 1>(xt, w, gt, dxt, part, rows, D, eps, stream);
  if (err != cudaSuccess) return err;
  const int n_part = static_cast<int>(strips(rows) * row_groups(D / vec));
  rmsnorm_bwd_dw_reduce_kernel<<<static_cast<unsigned>((D + REDUCE_COLS - 1) / REDUCE_COLS),
                                 REDUCE_COLS * REDUCE_SPLIT, 0, stream>>>(part, dw, n_part, D);
  return cudaGetLastError();
}

}  // namespace

// The number of fp32 partials of dw per column for `rows` rows of D values
// read `vec` at a time: the wrapper allocates n_partials * D floats of
// scratch for `part`.
extern "C" long long veer_rmsnorm_bwd_partials(long long rows, int D, int vec) {
  return strips(rows) * row_groups(D / vec);
}

// Launches on `stream` (PyTorch's current stream) and returns the first
// failing launch's cudaError_t, else 0; the caller raises on anything but 0.
// x, g and dx are (rows, D) contiguous of one dtype (0: fp32, 1: bf16); w and
// dw (D,) fp32; part (n_partials(rows, D, vec), D) fp32 scratch.  `vec` is 16
// bytes' worth of values (4 fp32, 8 bf16) when D is a multiple of it and x,
// g, dx are 16-byte aligned, else 1.  Rows wider than 1024 vectors go through
// shared memory: 4 + 2 * sizeof(x) bytes a column, up to 227 KB (D ~19,000
// in fp32, ~29,000 in bf16); wider rows read x and g twice.
extern "C" int veer_rmsnorm_bwd(const void* x, const float* w, const void* g, void* dx, float* dw,
                                float* part, int dtype, long long rows, int D, float eps, int vec,
                                void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (veer_rmsnorm_bwd_partials(rows, D, vec) > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(x, w, g, dx, dw, part, rows, D, eps, vec, s)
                 : launch<__nv_bfloat16>(x, w, g, dx, dw, part, rows, D, eps, vec, s);
  return static_cast<int>(err);
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
