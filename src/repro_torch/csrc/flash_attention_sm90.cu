// Flash attention, forward, bf16 on Hopper's tensor cores: GQA with causal /
// sliding-window / chunked-local masks shifted by q_offset, for the dense
// LM's prefill.  The fp32 instance stays on the CUDA cores
// (flash_attention.cu): TF32 would not hold its tolerance of 2e-6.
//
// Replaces src/repro/kernels/flash_attention.py:112 flash_attention_pallas
// (_fa_kernel), whose sequential grid (B, H, q tile, kv tile) carries the
// online-softmax state in VMEM from one kv step to the next.  Here one block
// owns one 128-row q tile of one (b, h) and walks its kv tiles in a loop,
// the state in registers; blocks of the longest causal rows launch first.
//
// What bounds it on the H100: operations, 4 * D FLOPs per visible (q, k)
// pair against 2 bytes per element of q, k, v and o; at the prefill shape
// (B=2, S=T=4096, H=32, KV=8, D=128, causal) 2.75e11 FLOPs, 0.278 ms at
// the 989 TFLOP/s bf16 tensor-core peak, far above the bytes' 0.015 ms.  So
// both products run as wgmma on bf16 operands with fp32 accumulators (P V
// twice, for P's hi and lo parts: 6 * D tensor-core FLOPs per pair):
//
//   * 384 threads, three warpgroups.  One thread of the first (the producer,
//     24 registers) copies Q once and K and V tiles of BK = 128 keys into a
//     ring of two shared-memory stages by TMA (cp.async.bulk.tensor), in the
//     swizzled layout that wgmma reads (wgmma.cuh), each copy completing on
//     an mbarrier; a stage is refilled once both consumers have released it.
//     The two consumer warpgroups (240 registers) own q rows [64c, 64c + 64)
//     of the tile each (wgmma's A operand is 64 rows) and take turns to issue
//     Q K^T (two named barriers), so that one's softmax overlaps the other's
//     product.  GQA is read in place: query head h reads kv head
//     h / (H / KV).  Rows past S or T are filled with zeros by the copy and
//     masked; no padding is materialized.
//   * S = Q K^T: wgmma m64n128k16, A and B K-major from shared memory.
//     Products of bf16 values are exact in fp32: only the order of the sum
//     differs from the reference's fp32 dot.
//   * Softmax in registers, in base 2: x = s * (scale * log2 e), masked to
//     NEG_INF = -1e30, the row max and sum over the four threads of a quad
//     (the accumulator layout puts a row's columns there), p = exp2(x - m)
//     (ex2.approx, within 2 ulps of fp32).
//     The row sum l adds the fp32 p.
//   * O += P V: wgmma m64nDk16 with P as the A operand in registers (the
//     accumulator layout of S is the A fragment layout of the next product),
//     V from shared memory MN-major (its rows are keys).  P goes in as two
//     bf16 operands, hi = bf16(P) and lo = bf16(P - hi), two products into
//     the same accumulator: the TPU kernel multiplies P by V in fp32, and P
//     rounded to bf16 alone (relative error 2^-9 per term) moved the logits
//     of an MoE model by routing tokens to other experts (PERF.md, PR 21);
//     hi + lo carries ~2^-17.  V is exact in bf16.  The plain mirror of this
//     arithmetic is ref.flash_attention_tc_reference.
//   * o = acc / max(l, 1e-30), written in bf16.  A kv tile whose pairs are
//     all masked for the block is skipped (the predicate of
//     flash_attention.py:65-73 at this tile size).  Masks cost nothing on a
//     tile that is fully visible; elsewhere each row's visible keys are one
//     interval [klo, khi], computed once for all masks (an integer division
//     per element would cost more than the exponentials).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 128;
constexpr int BK = 128;
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // a producer warpgroup and two consumer warpgroups
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x in one instruction (flushing results below 2^-126 to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // (B, S, H) natural-log sum of exponentials, or null (serving)
  int B, S, T, H, KV;
  int causal, has_window, window, has_chunk, chunk, q_offset;
  float scale;
};

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

// Is every pair visible?
__device__ __forceinline__ bool all_visible(const Params& p, int q0, int q1, int k0, int k1) {
  bool all = k1 < p.T;
  if (p.causal) all &= k1 <= q0;
  if (p.has_window) all &= k0 > q1 - p.window;
  if (p.has_chunk) {
    const int c = floordiv(k0, p.chunk);
    all &= floordiv(k1, p.chunk) == c && floordiv(q0, p.chunk) == c && floordiv(q1, p.chunk) == c;
  }
  return all;
}

template <int D>
struct Smem {
  static constexpr int W = wg::atom_bytes(D);
  static constexpr int TILE_Q = BQ * D * 2, TILE_KV = BK * D * 2;
  static constexpr int BYTES = TILE_Q + 2 * STAGES * TILE_KV + 1024 /* barriers */ + 1024 /* alignment */;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  constexpr int W = Smem<D>::W;
  constexpr int TILE_Q = Smem<D>::TILE_Q, TILE_KV = Smem<D>::TILE_KV;
  constexpr int BOXES = D * 2 / W;  // TMA boxes per tile: one per swizzle atom
  constexpr int NS = BK / 2;        // fp32 accumulators of S per thread
  constexpr int NO = D / 2;         // of O

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* sq = smem;
  uint8_t* skv = sq + TILE_Q;  // stage s: K at skv + 2 s TILE_KV, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + 2 * STAGES * TILE_KV);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int tid = threadIdx.x;
  const int nq = gridDim.x;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q_row0 = qi * BQ;
  const int q_start = q_row0 + p.q_offset;

  // the kv tiles the block needs form one range
  const int nk = (p.T + BK - 1) / BK;
  int kt0 = nk, kt1 = -1;
  for (int ki = 0; ki < nk; ++ki) {
    if (any_visible(p, q_start, q_start + BQ - 1, ki * BK, ki * BK + BK - 1)) {
      kt0 = min(kt0, ki);
      kt1 = ki;
    }
  }

  if (tid == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(k_full + s, 1);
      wg::mbar_init(v_full + s, 1);
      wg::mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup index, warp-uniform to the compiler (else it serializes wgmma)
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 0) {
    // ---- producer warpgroup: one thread keeps the TMA copies in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      wg::mbar_expect_tx(q_full, TILE_Q);
      for (int a = 0; a < BOXES; ++a)
        wg::tma_load_4d(sq + a * BQ * W, &tq, q_full, a * W / 2, h, q_row0, b);
      for (int ki = kt0; ki <= kt1; ++ki) {
        const int it = ki - kt0, s = it % STAGES;
        if (it >= STAGES) wg::mbar_wait(empty + s, (it / STAGES - 1) & 1);
        uint8_t* sk = skv + 2 * s * TILE_KV;
        wg::mbar_expect_tx(k_full + s, TILE_KV);
        for (int a = 0; a < BOXES; ++a)
          wg::tma_load_4d(sk + a * BK * W, &tk, k_full + s, a * W / 2, kvh, ki * BK, b);
        wg::mbar_expect_tx(v_full + s, TILE_KV);
        for (int a = 0; a < BOXES; ++a)
          wg::tma_load_4d(sk + TILE_KV + a * BK * W, &tv, v_full + s, a * W / 2, kvh, ki * BK, b);
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 q rows each ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wgi - 1, t = tid % 128;
    const int wq0 = q_start + 64 * c;  // this warpgroup's first and last q position
    const int wq1 = wq0 + 63;
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const float scale2 = p.scale * LOG2E;
    // the keys [klo, khi] that each of this thread's two rows sees: every mask
    // at once, computed once (the per-element test is two comparisons)
    int klo[2], khi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = wq0 + wg::acc_row(t, i);
      klo[i] = 0;
      khi[i] = p.T - 1;
      if (p.causal) khi[i] = min(khi[i], qpos);
      if (p.has_window) klo[i] = max(klo[i], qpos - p.window + 1);
      if (p.has_chunk) {
        const int c0 = floordiv(qpos, p.chunk) * p.chunk;
        klo[i] = max(klo[i], c0);
        khi[i] = static_cast<int>(min(static_cast<long long>(khi[i]), static_cast<long long>(c0) + p.chunk - 1));
      }
    }
    const uint32_t uq = wg::smem_u32(sq);

    wg::mbar_wait(q_full, 0);
    // The warpgroups take turns to issue Q K^T (named barriers 1 and 2), so
    // that one's softmax runs while the other's product is on the tensor cores.
    if (c == 1 && kt0 <= kt1) wg::bar_arrive(1, 256);
    for (int ki = kt0; ki <= kt1; ++ki) {
      const int it = ki - kt0, s = it % STAGES;
      const uint32_t par = (it / STAGES) & 1;
      const uint32_t uk = wg::smem_u32(skv + 2 * s * TILE_KV), uv = uk + TILE_KV;
      const int k0 = ki * BK;
      float sc[NS];
      wg::mbar_wait(k_full + s, par);
      wg::bar_sync(1 + c, 256);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wg::wgmma_ss<BK, 0, 0>(sc, wg::desc_k<W>(uq, BQ, 64 * c, ks), wg::desc_k<W>(uk, BK, 0, ks),
                               ks > 0);
      wg::commit();
      if (c == 0 || ki < kt1) wg::bar_arrive(2 - c, 256);  // the other's turn, if it has one
      {
        wg::wait<0>();
        wg::fence_regs(sc);

        float mx[2] = {m[0], m[1]};
        if (all_visible(p, wq0, wq1, k0, k0 + BK - 1)) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float x = sc[4 * j + 2 * i + e] * scale2;
                sc[4 * j + 2 * i + e] = x;
                mx[i] = fmaxf(mx[i], x);
              }
        } else {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kpos = k0 + wg::acc_col(t, j, e);
                const bool keep = kpos >= klo[i] && kpos <= khi[i];
                const float x = keep ? sc[4 * j + 2 * i + e] * scale2 : NEG_INF;
                sc[4 * j + 2 * i + e] = x;
                mx[i] = fmaxf(mx[i], x);
              }
        }
        float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          corr[i] = ex2(m[i] - mx[i]);
          m[i] = mx[i];
        }
        // P as bf16 hi + lo, the A fragments of the second product
        uint32_t pf[BK / 4], pl[BK / 4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float p0 = ex2(sc[4 * j + 2 * i] - m[i]);
            const float p1 = ex2(sc[4 * j + 2 * i + 1] - m[i]);
            sum[i] += p0 + p1;
            wg::split_bf16(p0, p1, pf[2 * j + i], pl[2 * j + i]);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
          l[i] = l[i] * corr[i] + sum[i];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            o[4 * j + 2 * i] *= corr[i];
            o[4 * j + 2 * i + 1] *= corr[i];
          }

        wg::mbar_wait(v_full + s, par);
        wg::fence_regs(o);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // keys 16 kk .. 16 kk + 15: n8 blocks 2 kk and 2 kk + 1 of S
          const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
          const uint32_t a_lo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
          const uint64_t dv = wg::desc_mn<W>(uv, BK, 0, kk);
          wg::wgmma_rs<D, 1>(o, a, dv, 1);
          wg::wgmma_rs<D, 1>(o, a_lo, dv, 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(o);
      }
      if (t == 0) wg::mbar_arrive(empty + s);  // this warpgroup is done with the stage
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q_row0 + 64 * c + wg::acc_row(t, i);
      if (row >= p.S) continue;
      const float lc = fmaxf(l[i], 1e-30f);
      // the backward's lse in natural log: m is the base-2 max of s * scale * log2 e
      if (p.lse != nullptr && t % 4 == 0)
        p.lse[(static_cast<size_t>(b) * p.S + row) * p.H + h] = m[i] * LN2 + logf(lc);
      __nv_bfloat16* orow = p.o + ((static_cast<size_t>(b) * p.S + row) * p.H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 val =
            __floats2bfloat162_rn(o[4 * j + 2 * i] / lc, o[4 * j + 2 * i + 1] / lc);
        *reinterpret_cast<__nv_bfloat162*>(orow + wg::acc_col(t, j, 0)) = val;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (so the library needs no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A map of x (B, L, NH, D) bf16 whose boxes are `rows` sequence rows of one
// head and one swizzle atom of D, swizzled as wgmma.cuh lays tiles out.
template <int D>
bool make_map(CUtensorMap* map, const void* x, int B, int L, int NH, int rows) {
  constexpr int W = wg::atom_bytes(D);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(NH) * D * 2,
                                 static_cast<cuuint64_t>(L) * NH * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(W / 2), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, p.q, p.B, p.S, p.H, BQ) || !make_map<D>(&tk, p.k, p.B, p.T, p.KV, BK) ||
      !make_map<D>(&tv, p.v, p.B, p.T, p.KV, BK))
    return cudaErrorInvalidValue;
  const int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_wgmma_kernel<D><<<grid, THREADS, smem, stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns the launch's
// cudaError_t; the caller raises on anything but 0.  q (B, S, H, D), k and v
// (B, T, KV, D), o (B, S, H, D): contiguous bf16, 16-byte aligned (the
// wrapper checks).  `window` / `chunk` apply when `has_window` / `has_chunk`.
// `lse` (B, S, H) fp32 receives each row's natural-log m + log(max(l, 1e-30))
// for the backward (flash_attention_bwd.cu) when it is not null; serving
// passes null.
extern "C" int veer_flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* o,
                                           float* lse, int B, int S, int T, int H, int KV, int D,
                                           int causal, int has_window, int window, int has_chunk,
                                           int chunk, int q_offset, float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) {  // no keys: acc = 0, l = 0, o = 0 / 1e-30, lse = NEG_INF + log(1e-30)
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);  // the wrapper fills it
    return static_cast<int>(cudaMemsetAsync(o, 0, static_cast<size_t>(B) * S * H * D * 2, s));
  }
  const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
                 B, S, T, H, KV, causal, has_window, window, has_chunk, chunk, q_offset, scale};
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
