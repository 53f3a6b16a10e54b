// Flash attention, backward, fp32: dQ, dK, dV of GQA attention with causal /
// sliding-window / chunked-local masks shifted by q_offset, from the forward's
// inputs, its output o, its log-sum-exp lse and the output's gradient dO,
// all fp32, with fp32 FMAs on the CUDA cores.  The bf16 instance runs on the
// tensor cores (flash_attention_bwd_sm90.cu); TF32 would not hold this
// instance's tolerance of 1e-5.
//
// Replaces the backward of the reference's flash custom VJP,
// src/repro/kernels/ref.py:190 _flash_bwd_impl (under the jax.custom_vjp at
// :94).  The TPU has no Pallas backward: the reference differentiates its
// jnp flash path, which scans q blocks inside a scan over kv blocks and
// carries the dK/dV accumulators from one q block to the next.  Here blocks
// run in parallel and in no order, so the work is split FA2-style into three
// launches, deterministic and without atomics:
//
//   1. delta: δ = rowsum(dO ∘ O) in fp32, one warp per (b, s, h) row;
//   2. dK/dV: one block per (b, kv head, tile of BK = 64 keys).  It holds K
//      and V of its tile in shared memory and loops over the G query heads of
//      the group (GQA sums there) and the query tiles of BQ = 64 rows that see
//      any key of the tile, accumulating dV += Pᵀ dO and dK += dSᵀ Q in
//      registers;
//   3. dQ: one block per (b, head, query tile), looping over the key tiles it
//      sees, dQ += dS K in registers.
//
// Both 2 and 3 recompute S = Q Kᵀ and dP = dO Vᵀ and, as ref.py:232-239,
//   P = exp(S * scale − lse),  dS = P ∘ (dP − δ) * scale,
// with P = 0 where the mask hides the pair (so a query row with no visible
// key, and every padded key or query row, gets and gives zero gradients).
//
// Per block: 256 threads as a 16 x 16 grid (ty, tx), as in the fp32 forward
// (flash_attention.cu): for a 64 x 64 tile of S a thread owns rows ty + 16 i
// and keys tx + 16 j (i, j < 4); for a 64 x D accumulator rows ty + 16 i and
// columns tx + 16 j (j < D / 16).  Tiles are converted to fp32 in shared
// memory, rows padded by 4 floats so the float4 reads of the dot products hit
// distinct banks.  Keys at or beyond T and query rows at or beyond S read as
// zeros and are masked; no padding is materialized.
//
// Bound.  Per visible (q, k) pair the backward does five products of D
// multiply-adds at least (S, dP, dV, dK, dQ; 10 D FLOPs); this kernel does
// seven (S and dP twice): at the prefill shape it is bound by operations, at
// most the fp32 rate of the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
static_assert(BQ == 64 && BK == 64 && THREADS == 256, "the thread grid is 16 x 16, 4 rows x 4 keys each");

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* lse;  // (B, S, H)
  const float* g;    // dO, (B, S, H, D)
  float* delta;      // (B, S, H) scratch
  float* dq;
  float* dk;
  float* dv;
  int B, S, T, H, KV;
  int causal, has_window, window, has_chunk, chunk, q_offset;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Load ROWS rows of D elements, starting at sequence index `start`, of head
// `head` from x (B, L, NH, D) into smem[r * ld + d] as fp32; rows at or beyond
// L read as zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* smem, int ld, const float* x, int b, int start, int L,
                                          int NH, int head) {
  constexpr int CHUNKS = D / 4;  // four elements per chunk
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const int d = (c % CHUNKS) * 4;
    const int pos = start + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < L) val = load4(x + ((static_cast<size_t>(b) * L + pos) * NH + head) * D + d);
    *reinterpret_cast<float4*>(smem + r * ld + d) = val;
  }
}

// Load the lse and δ of query rows [row0, row0 + BQ) of head h.
__device__ __forceinline__ void load_rows(float* slse, float* sdelta, const Params& p, int b, int h,
                                          int row0) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int row = row0 + r;
    const size_t idx = (static_cast<size_t>(b) * p.S + row) * p.H + h;
    slse[r] = row < p.S ? p.lse[idx] : 0.f;
    sdelta[r] = row < p.S ? p.delta[idx] : 0.f;
  }
}

// Is the pair (qpos, kpos) visible under every mask?
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool keep = kpos < p.T;
  if (p.causal) keep &= kpos <= qpos;
  if (p.has_window) keep &= kpos > qpos - p.window;
  if (p.has_chunk) keep &= floordiv(kpos, p.chunk) == floordiv(qpos, p.chunk);
  return keep;
}

// Is any pair of q positions [q0, q1] and k positions [k0, k1] visible?
__device__ __forceinline__ bool any_visible(const Params& p, int q0, int q1, int k0, int k1) {
  bool any = k0 < p.T;
  if (p.causal) any &= k0 <= q1;
  if (p.has_window) any &= k1 > q0 - p.window;
  if (p.has_chunk) {
    any &= floordiv(k0, p.chunk) <= floordiv(q1, p.chunk);
    any &= floordiv(k1, p.chunk) >= floordiv(q0, p.chunk);
  }
  return any;
}

// S = Q Kᵀ and dP = dO Vᵀ for the thread's 4 x 4 pairs, then P and dS into
// shared memory (P only where sp is not null).
template <int D>
__device__ __forceinline__ void probs_and_dS(const Params& p, const float* sq, const float* sg,
                                             const float* sk, const float* sv, const float* slse,
                                             const float* sdelta, float* sp, float* sds, int q_row0,
                                             int k_start) {
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c[j], s[i][j]);
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sg + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(sv + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], c[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q_row0 + r + p.q_offset;
    const bool row_ok = q_row0 + r < p.S;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool keep = row_ok && visible(p, qpos, k_start + c);
      const float pr = keep ? expf(s[i][j] * p.scale - slse[r]) : 0.f;
      if (sp != nullptr) sp[r * LDP + c] = pr;
      sds[r * LDP + c] = pr * (dp[i][j] - sdelta[r]) * p.scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) delta_kernel(const float* __restrict__ o, const float* __restrict__ g,
                                                        float* __restrict__ delta, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform over the warp
  float acc = 0.f;
  for (int d = lane * 4; d < D; d += 128) acc = dot4(load4(o + row * D + d), load4(g + row * D + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(const Params p) {
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 1;
  constexpr int NJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + BK * LD;
  float* sq = sv + BK * LD;
  float* sg = sq + BQ * LD;
  float* sp = sg + BQ * LD;
  float* sds = sp + BQ * LDP;
  float* slse = sds + BQ * LDP;
  float* sdelta = slse + BQ;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV;
  const int G = p.H / p.KV;
  const int k_start = blockIdx.x * BK;

  load_tile<D, BK>(sk, LD, p.k, b, k_start, p.T, p.KV, kvh);
  load_tile<D, BK>(sv, LD, p.v, b, k_start, p.T, p.KV, kvh);

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (p.S + BQ - 1) / BQ;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    for (int qi = 0; qi < nq; ++qi) {
      const int q_row0 = qi * BQ;
      const int q_start = q_row0 + p.q_offset;
      if (!any_visible(p, q_start, q_start + BQ - 1, k_start, k_start + BK - 1)) continue;  // uniform
      __syncthreads();  // the previous tile's readers of sq, sg, sp, sds are done
      load_tile<D, BQ>(sq, LD, p.q, b, q_row0, p.S, p.H, h);
      load_tile<D, BQ>(sg, LD, p.g, b, q_row0, p.S, p.H, h);
      load_rows(slse, sdelta, p, b, h, q_row0);
      __syncthreads();
      probs_and_dS<D>(p, sq, sg, sk, sv, slse, sdelta, sp, sds, q_row0, k_start);
      __syncthreads();
      // dV += Pᵀ dO and dK += dSᵀ Q over the tile's query rows: this thread's
      // keys ty + 16 i and columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pc[4], dc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pc[i] = sp[r * LDP + ty + 16 * i];
          dc[i] = sds[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float gv = sg[r * LD + tx + 16 * j];
          const float qv = sq[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(pc[i], gv, dv[i][j]);
            dk[i][j] = fmaf(dc[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k_start + ty + 16 * i;
    if (key >= p.T) continue;
    const size_t off = ((static_cast<size_t>(b) * p.T + key) * p.KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      p.dk[off + tx + 16 * j] = dk[i][j];
      p.dv[off + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 1;
  constexpr int NJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sg = sq + BQ * LD;
  float* sk = sg + BQ * LD;
  float* sv = sk + BK * LD;
  float* sds = sv + BK * LD;
  float* slse = sds + BQ * LDP;
  float* sdelta = slse + BQ;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int qi = gridDim.x - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q_row0 = qi * BQ;
  const int q_start = q_row0 + p.q_offset;

  load_tile<D, BQ>(sq, LD, p.q, b, q_row0, p.S, p.H, h);
  load_tile<D, BQ>(sg, LD, p.g, b, q_row0, p.S, p.H, h);
  load_rows(slse, sdelta, p, b, h, q_row0);

  float dq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  const int nk = (p.T + BK - 1) / BK;
  for (int ki = 0; ki < nk; ++ki) {
    const int k_start = ki * BK;
    if (!any_visible(p, q_start, q_start + BQ - 1, k_start, k_start + BK - 1)) continue;  // uniform
    __syncthreads();  // the previous tile's readers of sk, sv, sds are done
    load_tile<D, BK>(sk, LD, p.k, b, k_start, p.T, p.KV, kvh);
    load_tile<D, BK>(sv, LD, p.v, b, k_start, p.T, p.KV, kvh);
    __syncthreads();
    probs_and_dS<D>(p, sq, sg, sk, sv, slse, sdelta, nullptr, sds, q_row0, k_start);
    __syncthreads();
    // dQ += dS K: this thread's rows ty + 16 i and columns tx + 16 j
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float dc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dc[i] = sds[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = sk[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(dc[i], kv, dq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_row0 + ty + 16 * i;
    if (row >= p.S) continue;
    float* dqrow = p.dq + ((static_cast<size_t>(b) * p.S + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqrow[tx + 16 * j] = dq[i][j];
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int LD = D + 4;
  constexpr int LDP = BK + 1;
  const long long rows = static_cast<long long>(p.B) * p.S * p.H;
  delta_kernel<D><<<static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, stream>>>(
      p.o, p.g, p.delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (p.T > 0) {
    const int smem = static_cast<int>(sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * LDP + 2 * BQ));
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<D><<<dim3((p.T + BK - 1) / BK, p.B * p.KV), THREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int smem = static_cast<int>(sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * LDP + 2 * BQ));
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3((p.S + BQ - 1) / BQ, p.B * p.H), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns the first
// failing launch's cudaError_t, else 0; the caller raises on anything but 0.
// q, o, dO, dq (B, S, H, D); k, v, dk, dv (B, T, KV, D); lse and the scratch
// delta (B, S, H) fp32; all fp32, contiguous, 16-byte aligned.  `window` /
// `chunk` apply when `has_window` / `has_chunk`.  The wrapper has checked
// shapes, types and alignment.
extern "C" int veer_flash_attention_bwd(const float* q, const float* k, const float* v, const float* o,
                                        const float* lse, const float* g, float* delta, float* dq,
                                        float* dk, float* dv, int B, int S, int T, int H, int KV, int D,
                                        int causal, int has_window, int window, int has_chunk, int chunk,
                                        int q_offset, float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, lse, g, delta, dq, dk, dv, B, S, T, H, KV,
                 causal, has_window, window, has_chunk, chunk, q_offset, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch<16>(p, s));
    case 32: return static_cast<int>(launch<32>(p, s));
    case 64: return static_cast<int>(launch<64>(p, s));
    case 128: return static_cast<int>(launch<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
