// Flash attention, forward: GQA with causal / sliding-window / chunked-local
// masks shifted by q_offset.  This is the fp32 instance, on the CUDA cores;
// bf16 inputs, the serving path's, go to flash_attention_sm90.cu (wgmma).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (_fa_kernel).  The TPU kernel walks a sequential grid (B, H, q tile,
// kv tile) and carries the online-softmax state (acc, m, l) in VMEM scratch
// from one kv step to the next.  Here blocks run in parallel and in no order,
// so one block owns one (q tile, b*h) pair and walks the kv tiles itself in
// a loop, with the state in registers.
//
// Layout: q (B, S, H, D), k and v (B, T, KV, D), o (B, S, H, D), all
// contiguous, fp32.  Query head h reads KV head h / (H / KV): GQA
// costs no copy of K or V.  Blocks of consecutive q tiles of one head read
// the same K/V tiles, which the 50 MB L2 serves after the first.
//
// Per block: BQ = 64 query rows, 256 threads as a 16 x 16 grid (ty, tx).  A
// thread owns rows ty + 16*i (i < 4) of the tile; for S = Q K^T it computes
// columns tx + 16*j (j < 4) of each kv tile of BK = 64 keys, and for
// O += P V the output columns tx + 16*j (j < D/16).  The 16 threads that
// share a row are one half-warp, so the row max and row sum of the online
// softmax are four xor-shuffles.  Q, K and V tiles are converted to fp32 in
// shared memory (rows padded by 4 floats, so the float4 reads of Q and K hit
// distinct banks), and every product and the softmax are fp32 FMAs on the
// CUDA cores.  No tensor cores: TF32 would not hold the fp32 tolerance of
// 2e-6, and wgmma / TMA are later work.
//
// Masks follow the reference exactly: a masked score becomes NEG_INF = -1e30
// (finite), keys at or beyond T are masked and their K/V rows read as zero,
// and a kv tile whose pairs are all masked is skipped by the predicate of
// flash_attention.py:65-73.  A row's output is acc / max(l, 1e-30), written
// in the input's dtype.  Query rows at or beyond S are computed on zeros
// and not written: no padding is materialized.
//
// Bound.  For the prefill shape the work is 4*D FLOPs per visible (q, k)
// pair, far above the bytes of q, k, v and o: the kernel is bound by
// operations.  On the CUDA cores it can reach at most the fp32 rate, so it
// sits well above the bf16 tensor-core bound that PERF.md states.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
static_assert(BQ == 64 && BK == 64 && THREADS == 256, "the thread grid is 16 x 16, 4 rows x 4 keys each");

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, S, H) natural-log sum of exponentials, or null (serving)
  int B, S, T, H, KV;
  int causal, has_window, window, has_chunk, chunk, q_offset;
  float scale;
};

// Load ROWS rows of D elements, starting at sequence index `start`, of
// head `head` from x (B, L, NH, D) into smem[r * ld + d] as fp32; rows at or
// beyond L read as zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* smem, int ld, const T* x, int b, int start,
                                          int L, int NH, int head) {
  constexpr int CHUNKS = D / 4;  // four elements per chunk
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const int d = (c % CHUNKS) * 4;
    const int pos = start + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < L) {
      const size_t off = ((static_cast<size_t>(b) * L + pos) * NH + head) * D + d;
      val = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + off);
    }
    *reinterpret_cast<float4*>(smem + r * ld + d) = val;
  }
}

template <typename T>
__device__ __forceinline__ void store(T* p, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, float v) { *p = v; }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int LDQ = D + 4;   // padded fp32 row of Q and K
  constexpr int LDV = D;       // V rows are read along d: no conflicts unpadded
  constexpr int LDP = BK + 1;  // P rows
  constexpr int NJ = D / 16;   // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + BQ * LDQ;
  float* sv = sk + BK * LDQ;
  float* sp = sv + BK * LDV;

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int nq = gridDim.x;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q_row0 = qi * BQ;
  const int q_start = q_row0 + p.q_offset;

  load_tile<T, D, BQ>(sq, LDQ, static_cast<const T*>(p.q), b, q_row0, p.S, p.H, h);

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (p.T + BK - 1) / BK;
  for (int ki = 0; ki < nk; ++ki) {
    const int k_start = ki * BK;
    // block-level skip: is any (q, k) pair of this tile unmasked?
    bool needed = true;
    if (p.causal) needed &= k_start <= q_start + BQ - 1;
    if (p.has_window) needed &= k_start + BK - 1 > q_start - p.window;
    if (p.has_chunk) {
      needed &= floordiv(k_start, p.chunk) <= floordiv(q_start + BQ - 1, p.chunk);
      needed &= floordiv(k_start + BK - 1, p.chunk) >= floordiv(q_start, p.chunk);
    }
    if (!needed) continue;  // uniform over the block

    __syncthreads();  // the previous tile's readers of sk, sv, sp are done
    load_tile<T, D, BK>(sk, LDQ, static_cast<const T*>(p.k), b, k_start, p.T, p.KV, kvh);
    load_tile<T, D, BK>(sv, LDV, static_cast<const T*>(p.v), b, k_start, p.T, p.KV, kvh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty + 16 * i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_start + tx + 16 * j;
        bool keep = kpos < p.T;
        if (p.causal) keep &= kpos <= qpos;
        if (p.has_window) keep &= kpos > qpos - p.window;
        if (p.has_chunk) keep &= floordiv(kpos, p.chunk) == floordiv(qpos, p.chunk);
        s[i][j] = keep ? s[i][j] * p.scale : NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        row_sum += pv;
        sp[(ty + 16 * i) * LDP + tx + 16 * j] = pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sp[(ty + 16 * i) * LDP + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sv[t * LDV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_row0 + ty + 16 * i;
    if (row >= p.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && tx == 0)  // what the backward recomputes P from
      p.lse[(static_cast<size_t>(b) * p.S + row) * p.H + h] = m[i] + logf(fmaxf(l[i], 1e-30f));
    T* orow = o + ((static_cast<size_t>(b) * p.S + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store<T>(orow + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns the launch's
// cudaError_t; the caller raises on anything but 0.  dtype must be 0
// (fp32).  `window` / `chunk` apply when `has_window` / `has_chunk`.  `lse`
// (B, S, H) fp32 receives each row's m + log(max(l, 1e-30)) for the backward
// (flash_attention_bwd.cu) when it is not null; serving passes null.  The
// wrapper has checked shapes, types, contiguity and 16-byte alignment.
extern "C" int veer_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int dtype, int B, int S, int T, int H, int KV,
                                        int D, int causal, int has_window, int window, int has_chunk,
                                        int chunk, int q_offset, float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, lse, B, S, T, H, KV, causal, has_window, window, has_chunk, chunk, q_offset,
           scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);  // bf16: flash_attention_sm90.cu
  return static_cast<int>(dispatch_d<float>(D, p, s));
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
