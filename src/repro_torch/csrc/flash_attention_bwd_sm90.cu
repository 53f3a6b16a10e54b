// Flash attention, backward, bf16 on Hopper's tensor cores: dQ, dK, dV of GQA
// attention with causal / sliding-window / chunked-local masks shifted by
// q_offset, from the forward's inputs, its output o, its log-sum-exp lse and
// the output's gradient dO.  The fp32 instance stays on the CUDA cores
// (flash_attention_bwd.cu): TF32 would not hold its tolerance of 1e-5.
//
// Replaces the backward of the reference's flash custom VJP,
// src/repro/kernels/ref.py:190 _flash_bwd_impl (under _flash.defvjp at :117),
// which scans q blocks inside a scan over kv blocks and carries the dK/dV
// accumulators from one q block to the next.  As
//   δ = rowsum(dO ∘ O),  P = exp(S · scale − lse),  dV = Pᵀ dO,
//   dP = dO Vᵀ,  dS = P ∘ (dP − δ) · scale,  dQ = dS K,  dK = dSᵀ Q,
// with P = 0 where a mask hides the pair (so every row past S or T gives and
// gets exactly zero gradient).  Three launches, deterministic and without
// atomics (the result does not depend on the order blocks run in):
//
//   1. flash_bwd_delta_kernel: δ and lse · log2 e per (b, h, row), one warp a
//      row, into a (B, H, Sp) scratch (Sp = S rounded up to 128, zeros past S)
//      whose rows of 64 are contiguous, so a bulk copy brings them in;
//   2. flash_bwd_dkdv_wgmma_kernel: one block per (b, kv head, 128 keys);
//   3. flash_bwd_dq_wgmma_kernel: one block per (b, head, 128 query rows).
//
// What bounds it on the H100: operations.  At least five products of D
// multiply-adds per visible (q, k) pair (10 D FLOPs): 0.695 ms at the
// prefill shape (B=2, S=T=4096, H=32, KV=8, D=128, causal) at the 989
// TFLOP/s bf16 tensor-core peak, far above its bytes' 0.05 ms.  So every
// product runs as wgmma on bf16 operands with fp32 accumulators, shaped as
// the forward (flash_attention_sm90.cu; shared helpers in wgmma.cuh):
//
//   * Copies by TMA into the swizzled layout wgmma reads, each completing on
//     an mbarrier; the block's resident tiles once, the streamed ones
//     through a ring of shared-memory stages, a stage refilled once every
//     consumer warp has released it.  Two consumer warpgroups own 64 rows of
//     the block each (wgmma's M).  Rows past S or T are filled with zeros by
//     the copies.
//   * dK/dV block (256 threads: the two warpgroups, thread 0 also issuing
//     the copies KV_STAGES - 1 tiles ahead): K and V of its 128 keys
//     resident.  It loops over the G query heads of the group (GQA sums
//     there, in head order) and, inside, over the 64-row query tiles that
//     see its keys, streaming Q, dO and the tile's lse · log2 e and δ.
//     Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (SS, keys as M); their accumulator layout is
//     the A-fragment layout of the next products, so dV += Pᵀ dO and dK +=
//     dSᵀ Q run as RS wgmma with dO and Q as MN-major B operands (as the
//     forward reads V).  lse and δ are per column here, read from shared
//     memory.  dK and dV take 128 fp32 registers a thread at D = 128, so the
//     block has no producer warpgroup: with 384 threads ptxas compiles for
//     168 registers whatever setmaxnreg grants at run time, and spilled.
//   * dQ block (384 threads: a producer warpgroup of 24 registers, one thread
//     of which issues the copies, and the two consumer warpgroups, as the
//     forward): Q and dO of its 128 rows resident; it loops over the 64-key
//     tiles it sees, streaming K and V: S = Q Kᵀ and dP = dO Vᵀ (SS), then
//     dQ += dS K (RS, K as the MN-major B operand).  S and dP are computed
//     again here: 10 products per pair where 5 is the least, a floor of
//     twice the bound (an ordered dQ accumulation across the dK/dV blocks
//     would remove it).
//   * Precision.  q, k, v and dO are exact in bf16, so S and dP are single
//     bf16 products with fp32 accumulation.  P = exp2(s · scale · log2 e −
//     lse · log2 e) (ex2.approx, within 2 ulps of fp32) and dS are fp32 and
//     go in as bf16 hi + lo, two products into the same accumulator: the
//     reference multiplies them in fp32, and one bf16 operand moved the MoE
//     models' logits (PERF.md, PR 21).  dQ, dK and dV are written in bf16.
//     The plain mirror of this arithmetic is
//     ref.flash_attention_bwd_tc_reference.
//   * Masks cost nothing on a tile that is fully visible; elsewhere each
//     row's visible columns are one interval, computed once; a tile that a
//     warpgroup sees nothing of is skipped.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int THREADS = 384;      // dQ: a producer warpgroup and two consumer warpgroups
constexpr int KV_THREADS = 256;   // dK/dV: two warpgroups, one thread of which copies
constexpr int STAGES = 2;         // shared-memory stages of the dQ block's ring
constexpr int KV_STAGES = 3;      // of the dK/dV block's
constexpr int KV_KEYS = 128;      // keys of a dK/dV block
constexpr int KV_ROWS = 64;       // query rows of each tile it streams
constexpr int Q_ROWS = 128;       // query rows of a dQ block
constexpr int Q_KEYS = 64;        // keys of each tile it streams
constexpr int PAD = 128;          // scratch rows are padded to a multiple of this
constexpr int CONSUMER_WARPS = 8; // arrivals that release a stage
constexpr int DELTA_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wg::mbar_wait that gives up after ~4 s: a fault in the copy protocol ends
// the launch with an error instead of leaving the card spinning.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(wg::smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      const uint64_t t = now_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 4000000000ull) __trap();
    }
  }
}

// `bytes` (a multiple of 16) from global memory to shared memory in one bulk
// copy, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(wg::smem_u32(bar))
               : "memory");
}

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* g;  // dO
  const float* lse;        // (B, S, H), natural log
  float* lse2;             // (B, H, Sp) scratch: lse * log2 e, 0 past S
  float* delta;            // (B, H, Sp) scratch: rowsum(dO * O), 0 past S
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, S, T, H, KV, Sp;
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

// Is every pair visible, every query row before S among them?
__device__ __forceinline__ bool all_visible(const Params& p, int q0, int q1, int k0, int k1) {
  bool all = k1 < p.T && q1 - p.q_offset < p.S;
  if (p.causal) all &= k1 <= q0;
  if (p.has_window) all &= k0 > q1 - p.window;
  if (p.has_chunk) {
    const int c = floordiv(k0, p.chunk);
    all &= floordiv(k1, p.chunk) == c && floordiv(q0, p.chunk) == c && floordiv(q1, p.chunk) == c;
  }
  return all;
}

// ---- 1. δ and lse * log2 e ------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DELTA_THREADS) flash_bwd_delta_kernel(const Params p, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (DELTA_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform over the warp
  // row = (b H + h) Sp + s: consecutive warps write consecutive rows
  const int s = static_cast<int>(row % p.Sp);
  const long long bh = row / p.Sp;
  if (s >= p.S) {
    if (lane == 0) p.delta[row] = p.lse2[row] = 0.f;
    return;
  }
  const size_t src = (static_cast<size_t>(bh / p.H) * p.S + s) * p.H + bh % p.H;
  float acc = 0.f;
  for (int d = lane * 4; d < D; d += 128) {
    const uint2 ro = *reinterpret_cast<const uint2*>(p.o + src * D + d);
    const uint2 rg = *reinterpret_cast<const uint2*>(p.g + src * D + d);
    const float2 o0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ro.x));
    const float2 o1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ro.y));
    const float2 g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rg.x));
    const float2 g1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rg.y));
    acc = fmaf(o0.x, g0.x, acc);
    acc = fmaf(o0.y, g0.y, acc);
    acc = fmaf(o1.x, g1.x, acc);
    acc = fmaf(o1.y, g1.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.delta[row] = acc;
    p.lse2[row] = p.lse[src] * LOG2E;
  }
}

// P and dS of two adjacent columns (e = 0, 1) of one accumulator row:
// P = exp2(s * scale2 - l2), 0 where `keep` is false, and
// dS = P * (dp - d) * scale.
__device__ __forceinline__ void probs(const float (&s)[2], const float (&dp)[2], const float (&l2)[2],
                                      const float (&d)[2], const bool (&keep)[2], float scale2, float scale,
                                      float (&pr)[2], float (&ds)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    pr[e] = keep[e] ? ex2(__fmul_rn(s[e], scale2) - l2[e]) : 0.f;
    ds[e] = pr[e] * (dp[e] - d[e]) * scale;
  }
}

// ---- 2. dK and dV ---------------------------------------------------------------

template <int D>
struct KvSmem {
  static constexpr int TILE_K = KV_KEYS * D * 2, TILE_Q = KV_ROWS * D * 2;
  static constexpr int BYTES = 2 * TILE_K + KV_STAGES * 2 * TILE_Q + KV_STAGES * 2 * KV_ROWS * 4 +
                               1024 /* barriers */ + 1024 /* alignment */;
};

template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv) {
  constexpr int W = wg::atom_bytes(D);
  constexpr int TILE_K = KvSmem<D>::TILE_K, TILE_Q = KvSmem<D>::TILE_Q;
  constexpr int BOXES = D * 2 / W;  // TMA boxes per tile: one per swizzle atom
  constexpr int NA = D / 2;         // fp32 accumulators of dK (and of dV) per thread
  constexpr int NS = KV_ROWS / 2;   // of Sᵀ (and of dPᵀ)

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* sk = smem;
  uint8_t* sv = sk + TILE_K;
  uint8_t* sqg = sv + TILE_K;  // stage s: Q at sqg + 2 s TILE_Q, dO after it
  float* srow = reinterpret_cast<float*>(sqg + 2 * KV_STAGES * TILE_Q);  // stage s: lse2 at 2 s KV_ROWS, δ after
  uint64_t* bars = reinterpret_cast<uint64_t*>(srow + 2 * KV_STAGES * KV_ROWS);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + KV_STAGES;

  // blocks launch in the order of blockIdx.x first: every (b, kv head) of a
  // key tile before the next tile, so under a causal mask the longest
  // blocks (the first keys, seen by every query) start first
  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int G = p.H / p.KV;
  const int k0 = blockIdx.y * KV_KEYS;

  // The query tiles that see the block's keys form one range [qt0, qt1] (each
  // mask is a prefix or a suffix of tiles); the block walks it once per head
  // of the group: iteration it is head it / nv, tile qt0 + it % nv.
  const int nq = (p.S + KV_ROWS - 1) / KV_ROWS;
  int qt0 = nq, qt1 = -1;
  for (int qi = 0; qi < nq; ++qi) {
    const int q0 = qi * KV_ROWS + p.q_offset;
    if (any_visible(p, q0, q0 + KV_ROWS - 1, k0, k0 + KV_KEYS - 1)) {
      qt0 = min(qt0, qi);
      qt1 = qi;
    }
  }
  const int nv = qt1 - qt0 + 1, n_it = G * max(nv, 0);

  if (tid == 0) {
    wg::mbar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, CONSUMER_WARPS);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  // Thread 0 keeps the copies KV_STAGES - 1 iterations ahead: a stage is
  // refilled once every warp has released it.  (No producer warpgroup: the
  // compile budget of 384 threads, 168 registers, cannot hold dK and dV.)
  const bool producer = tid == 0;
  auto produce = [&](int it) {
    const int s = it % KV_STAGES, h = kvh * G + it / nv, qi = qt0 + it % nv;
    if (it >= KV_STAGES) mbar_wait(empty + s, (it / KV_STAGES - 1) & 1);
    uint8_t* sq = sqg + 2 * s * TILE_Q;
    wg::mbar_expect_tx(full + s, 2 * TILE_Q + 2 * KV_ROWS * 4);
    for (int a = 0; a < BOXES; ++a) {
      wg::tma_load_4d(sq + a * KV_ROWS * W, &tq, full + s, a * W / 2, h, qi * KV_ROWS, b);
      wg::tma_load_4d(sq + TILE_Q + a * KV_ROWS * W, &tg, full + s, a * W / 2, h, qi * KV_ROWS, b);
    }
    const size_t r = (static_cast<size_t>(b) * p.H + h) * p.Sp + qi * KV_ROWS;
    bulk_load(srow + 2 * s * KV_ROWS, p.lse2 + r, KV_ROWS * 4, full + s);
    bulk_load(srow + (2 * s + 1) * KV_ROWS, p.delta + r, KV_ROWS * 4, full + s);
  };
  if (producer && n_it > 0) {
    wg::mbar_expect_tx(kv_full, 2 * TILE_K);
    for (int a = 0; a < BOXES; ++a) {
      wg::tma_load_4d(sk + a * KV_KEYS * W, &tk, kv_full, a * W / 2, kvh, k0, b);
      wg::tma_load_4d(sv + a * KV_KEYS * W, &tv, kv_full, a * W / 2, kvh, k0, b);
    }
    for (int it = 0; it < KV_STAGES - 1 && it < n_it; ++it) produce(it);
  }

  // the warpgroup (64 keys each), warp-uniform to the compiler (else it
  // serializes wgmma)
  const int c = __shfl_sync(0xffffffffu, tid / 128, 0), t = tid % 128;
  const int wk0 = k0 + 64 * c;  // this warpgroup's first key
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
  // the query positions [qlo, qhi] that each of this thread's two keys is
  // seen by: every mask at once, rows past S and keys past T included
  int qlo[2], qhi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = wk0 + wg::acc_row(t, i);
    long long lo = p.q_offset, hi = static_cast<long long>(p.S) - 1 + p.q_offset;
    if (key >= p.T) hi = lo - 1;
    if (p.causal) lo = max(lo, static_cast<long long>(key));
    if (p.has_window) hi = min(hi, static_cast<long long>(key) + p.window - 1);
    if (p.has_chunk) {
      const long long c0 = static_cast<long long>(floordiv(key, p.chunk)) * p.chunk;
      lo = max(lo, c0);
      hi = min(hi, c0 + p.chunk - 1);
    }
    if (hi < lo) lo = 1, hi = 0;
    qlo[i] = static_cast<int>(lo);
    qhi[i] = static_cast<int>(hi);
  }
  const float scale2 = p.scale * LOG2E;
  const uint32_t uk = wg::smem_u32(sk), uv = wg::smem_u32(sv);

  if (n_it > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    if (producer && it + KV_STAGES - 1 < n_it) produce(it + KV_STAGES - 1);
    const int s = it % KV_STAGES;
    const int q0 = (qt0 + it % nv) * KV_ROWS + p.q_offset;
    mbar_wait(full + s, (it / KV_STAGES) & 1);
    if (any_visible(p, q0, q0 + KV_ROWS - 1, wk0, wk0 + 63)) {
      const uint32_t uq = wg::smem_u32(sqg + 2 * s * TILE_Q), ug = uq + TILE_Q;
      const float* sl = srow + 2 * s * KV_ROWS;
      const float* sd = sl + KV_ROWS;
      float st[NS], dpt[NS];
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wg::wgmma_ss<KV_ROWS, 0, 0>(st, wg::desc_k<W>(uk, KV_KEYS, 64 * c, ks), wg::desc_k<W>(uq, KV_ROWS, 0, ks),
                                    ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wg::wgmma_ss<KV_ROWS, 0, 0>(dpt, wg::desc_k<W>(uv, KV_KEYS, 64 * c, ks), wg::desc_k<W>(ug, KV_ROWS, 0, ks),
                                    ks > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(st);
      wg::fence_regs(dpt);

      // Pᵀ and dSᵀ (rows: keys, columns: query rows), as the A fragments of
      // the next products
      const bool full_tile = all_visible(p, q0, q0 + KV_ROWS - 1, wk0, wk0 + 63);
      uint32_t ph[NS / 2], pl[NS / 2], dh[NS / 2], dl[NS / 2];
#pragma unroll
      for (int j = 0; j < KV_ROWS / 8; ++j) {
        const int col = wg::acc_col(t, j, 0);
        const float2 l2 = *reinterpret_cast<const float2*>(sl + col);
        const float2 dd = *reinterpret_cast<const float2*>(sd + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i;
          bool keep[2] = {true, true};
          if (!full_tile) {
            keep[0] = q0 + col >= qlo[i] && q0 + col <= qhi[i];
            keep[1] = q0 + col + 1 >= qlo[i] && q0 + col + 1 <= qhi[i];
          }
          float pr[2], ds[2];
          probs({st[x], st[x + 1]}, {dpt[x], dpt[x + 1]}, {l2.x, l2.y}, {dd.x, dd.y}, keep, scale2, p.scale, pr,
                ds);
          wg::split_bf16(pr[0], pr[1], ph[2 * j + i], pl[2 * j + i]);
          wg::split_bf16(ds[0], ds[1], dh[2 * j + i], dl[2 * j + i]);
        }
      }

      wg::fence_regs(dk);
      wg::fence_regs(dv);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < KV_ROWS / 16; ++kk) {
        // query rows 16 kk .. 16 kk + 15: n8 blocks 2 kk and 2 kk + 1
        const uint32_t a_hi[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
        const uint32_t a_lo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
        const uint32_t b_hi[4] = {dh[4 * kk], dh[4 * kk + 1], dh[4 * kk + 2], dh[4 * kk + 3]};
        const uint32_t b_lo[4] = {dl[4 * kk], dl[4 * kk + 1], dl[4 * kk + 2], dl[4 * kk + 3]};
        const uint64_t dgo = wg::desc_mn<W>(ug, KV_ROWS, 0, kk);
        const uint64_t dqq = wg::desc_mn<W>(uq, KV_ROWS, 0, kk);
        wg::wgmma_rs<D, 1>(dv, a_hi, dgo, 1);
        wg::wgmma_rs<D, 1>(dv, a_lo, dgo, 1);
        wg::wgmma_rs<D, 1>(dk, b_hi, dqq, 1);
        wg::wgmma_rs<D, 1>(dk, b_lo, dqq, 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(dk);
      wg::fence_regs(dv);
    }
    // this warp is done with the stage (its shared-memory reads and wgmma)
    if (t % 32 == 0) wg::mbar_arrive(empty + s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = wk0 + wg::acc_row(t, i);
    if (key >= p.T) continue;
    const size_t off = ((static_cast<size_t>(b) * p.T + key) * p.KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = wg::acc_col(t, j, 0);
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + col) =
          __floats2bfloat162_rn(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + col) =
          __floats2bfloat162_rn(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// ---- 3. dQ ----------------------------------------------------------------------

template <int D>
struct QSmem {
  static constexpr int TILE_Q = Q_ROWS * D * 2, TILE_K = Q_KEYS * D * 2;
  static constexpr int BYTES = 2 * TILE_Q + STAGES * 2 * TILE_K + 1024 /* barriers */ + 1024 /* alignment */;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv) {
  constexpr int W = wg::atom_bytes(D);
  constexpr int TILE_Q = QSmem<D>::TILE_Q, TILE_K = QSmem<D>::TILE_K;
  constexpr int BOXES = D * 2 / W;
  constexpr int NA = D / 2;        // fp32 accumulators of dQ per thread
  constexpr int NS = Q_KEYS / 2;   // of S (and of dP)

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* sq = smem;
  uint8_t* sg = sq + TILE_Q;
  uint8_t* skv = sg + TILE_Q;  // stage s: K at skv + 2 s TILE_K, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + 2 * STAGES * TILE_K);
  uint64_t* qg_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int qi = gridDim.y - 1 - static_cast<int>(blockIdx.y);  // longest causal rows first, every (b, h)
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q_row0 = qi * Q_ROWS;
  const int q_start = q_row0 + p.q_offset;

  // the key tiles the block sees form one range (each mask is a prefix or a
  // suffix of tiles)
  const int nk = (p.T + Q_KEYS - 1) / Q_KEYS;
  int kt0 = nk, kt1 = -1;
  for (int ki = 0; ki < nk; ++ki) {
    if (any_visible(p, q_start, q_start + Q_ROWS - 1, ki * Q_KEYS, ki * Q_KEYS + Q_KEYS - 1)) {
      kt0 = min(kt0, ki);
      kt1 = ki;
    }
  }

  if (tid == 0) {
    wg::mbar_init(qg_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, CONSUMER_WARPS);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && kt0 <= kt1) {
      wg::mbar_expect_tx(qg_full, 2 * TILE_Q);
      for (int a = 0; a < BOXES; ++a) {
        wg::tma_load_4d(sq + a * Q_ROWS * W, &tq, qg_full, a * W / 2, h, q_row0, b);
        wg::tma_load_4d(sg + a * Q_ROWS * W, &tg, qg_full, a * W / 2, h, q_row0, b);
      }
      int it = 0;
      for (int ki = kt0; ki <= kt1; ++ki, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + s, (it / STAGES - 1) & 1);
        uint8_t* sk = skv + 2 * s * TILE_K;
        wg::mbar_expect_tx(full + s, 2 * TILE_K);
        for (int a = 0; a < BOXES; ++a) {
          wg::tma_load_4d(sk + a * Q_KEYS * W, &tk, full + s, a * W / 2, kvh, ki * Q_KEYS, b);
          wg::tma_load_4d(sk + TILE_K + a * Q_KEYS * W, &tv, full + s, a * W / 2, kvh, ki * Q_KEYS, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wgi - 1, t = tid % 128;
    const int wq0 = q_start + 64 * c;  // this warpgroup's first and last q position
    const int wq1 = wq0 + 63;
    float dq[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dq[i] = 0.f;
    // per row of this thread: lse * log2 e, δ, and the keys [klo, khi] it sees
    float l2[2], dd[2];
    int klo[2], khi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q_row0 + 64 * c + wg::acc_row(t, i);  // < Sp: the scratch holds it
      const size_t r = (static_cast<size_t>(b) * p.H + h) * p.Sp + row;
      l2[i] = p.lse2[r];
      dd[i] = p.delta[r];
      const int qpos = row + p.q_offset;
      klo[i] = 0;
      khi[i] = row < p.S ? p.T - 1 : -1;
      if (p.causal) khi[i] = min(khi[i], qpos);
      if (p.has_window) klo[i] = max(klo[i], qpos - p.window + 1);
      if (p.has_chunk) {
        const int c0 = floordiv(qpos, p.chunk) * p.chunk;
        klo[i] = max(klo[i], c0);
        khi[i] = static_cast<int>(min(static_cast<long long>(khi[i]), static_cast<long long>(c0) + p.chunk - 1));
      }
    }
    const float scale2 = p.scale * LOG2E;
    const uint32_t uq = wg::smem_u32(sq), ug = wg::smem_u32(sg);

    if (kt0 <= kt1) mbar_wait(qg_full, 0);
    int it = 0;
    for (int ki = kt0; ki <= kt1; ++ki, ++it) {
      const int kb = ki * Q_KEYS;
      const int s = it % STAGES;
      mbar_wait(full + s, (it / STAGES) & 1);
      if (any_visible(p, wq0, wq1, kb, kb + Q_KEYS - 1)) {
        const uint32_t uk = wg::smem_u32(skv + 2 * s * TILE_K), uv = uk + TILE_K;
        float sc[NS], dp[NS];
        wg::fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wg::wgmma_ss<Q_KEYS, 0, 0>(sc, wg::desc_k<W>(uq, Q_ROWS, 64 * c, ks), wg::desc_k<W>(uk, Q_KEYS, 0, ks),
                                     ks > 0);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wg::wgmma_ss<Q_KEYS, 0, 0>(dp, wg::desc_k<W>(ug, Q_ROWS, 64 * c, ks), wg::desc_k<W>(uv, Q_KEYS, 0, ks),
                                     ks > 0);
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(sc);
        wg::fence_regs(dp);

        const bool full_tile = all_visible(p, wq0, wq1, kb, kb + Q_KEYS - 1);
        uint32_t dh[NS / 2], dl[NS / 2];
#pragma unroll
        for (int j = 0; j < Q_KEYS / 8; ++j) {
          const int kpos = kb + wg::acc_col(t, j, 0);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * j + 2 * i;
            bool keep[2] = {true, true};
            if (!full_tile) {
              keep[0] = kpos >= klo[i] && kpos <= khi[i];
              keep[1] = kpos + 1 >= klo[i] && kpos + 1 <= khi[i];
            }
            float pr[2], ds[2];
            probs({sc[x], sc[x + 1]}, {dp[x], dp[x + 1]}, {l2[i], l2[i]}, {dd[i], dd[i]}, keep, scale2, p.scale,
                  pr, ds);
            wg::split_bf16(ds[0], ds[1], dh[2 * j + i], dl[2 * j + i]);
          }
        }

        wg::fence_regs(dq);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < Q_KEYS / 16; ++kk) {
          const uint32_t a_hi[4] = {dh[4 * kk], dh[4 * kk + 1], dh[4 * kk + 2], dh[4 * kk + 3]};
          const uint32_t a_lo[4] = {dl[4 * kk], dl[4 * kk + 1], dl[4 * kk + 2], dl[4 * kk + 3]};
          const uint64_t dkk = wg::desc_mn<W>(uk, Q_KEYS, 0, kk);
          wg::wgmma_rs<D, 1>(dq, a_hi, dkk, 1);
          wg::wgmma_rs<D, 1>(dq, a_lo, dkk, 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(dq);
      }
      if (t % 32 == 0) wg::mbar_arrive(empty + s);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q_row0 + 64 * c + wg::acc_row(t, i);
      if (row >= p.S) continue;
      __nv_bfloat16* dqrow = p.dq + ((static_cast<size_t>(b) * p.S + row) * p.H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dqrow + wg::acc_col(t, j, 0)) =
            __floats2bfloat162_rn(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
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
// head and one swizzle atom of D, swizzled as wgmma.cuh lays tiles out; rows
// past L read as zeros.
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
cudaError_t launch(const Params& p, const void* q, const void* k, const void* v, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.Sp;
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>((rows + DELTA_THREADS / 32 - 1) / (DELTA_THREADS / 32)),
                              DELTA_THREADS, 0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap tq, tg, tk, tv;
  if (!make_map<D>(&tq, q, p.B, p.S, p.H, KV_ROWS) || !make_map<D>(&tg, p.g, p.B, p.S, p.H, KV_ROWS) ||
      !make_map<D>(&tk, k, p.B, p.T, p.KV, KV_KEYS) || !make_map<D>(&tv, v, p.B, p.T, p.KV, KV_KEYS))
    return cudaErrorInvalidValue;
  int smem = KvSmem<D>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<D><<<dim3(p.B * p.KV, (p.T + KV_KEYS - 1) / KV_KEYS), KV_THREADS, smem, stream>>>(
      p, tq, tg, tk, tv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (!make_map<D>(&tq, q, p.B, p.S, p.H, Q_ROWS) || !make_map<D>(&tg, p.g, p.B, p.S, p.H, Q_ROWS) ||
      !make_map<D>(&tk, k, p.B, p.T, p.KV, Q_KEYS) || !make_map<D>(&tv, v, p.B, p.T, p.KV, Q_KEYS))
    return cudaErrorInvalidValue;
  smem = QSmem<D>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D><<<dim3(p.B * p.H, (p.S + Q_ROWS - 1) / Q_ROWS), THREADS, smem, stream>>>(
      p, tq, tg, tk, tv);
  return cudaGetLastError();
}

}  // namespace

// fp32 elements of the scratch that veer_flash_attention_bwd_tc takes: lse *
// log2 e and δ, each (B, H, S rounded up to 128).
extern "C" long long veer_flash_attention_bwd_tc_scratch(int B, int S, int H) {
  return 2LL * B * H * ((S + PAD - 1) / PAD * PAD);
}

// Launches on `stream` (PyTorch's current stream) and returns the first
// failing launch's cudaError_t, else 0; the caller raises on anything but 0.
// q, o, dO, dq (B, S, H, D); k, v, dk, dv (B, T, KV, D): contiguous bf16,
// 16-byte aligned; lse (B, S, H) fp32 from the forward; `scratch` fp32 of
// veer_flash_attention_bwd_tc_scratch(B, S, H) elements, 16-byte aligned.
// `window` / `chunk` apply when `has_window` / `has_chunk`.  The wrapper has
// checked shapes, types and alignment.
extern "C" int veer_flash_attention_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                                           const float* lse, const void* g, float* scratch, void* dq, void* dk,
                                           void* dv, int B, int S, int T, int H, int KV, int D, int causal,
                                           int has_window, int window, int has_chunk, int chunk, int q_offset,
                                           float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0 || (S + Q_ROWS - 1) / Q_ROWS > 65535 || (T + KV_KEYS - 1) / KV_KEYS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);  // tiles along the grid's y axis
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0)  // no keys: every probability is 0, so is dQ
    return static_cast<int>(cudaMemsetAsync(dq, 0, static_cast<size_t>(B) * S * H * D * 2, s));
  const int Sp = (S + PAD - 1) / PAD * PAD;
  float* lse2 = scratch;
  float* delta = scratch + static_cast<size_t>(B) * H * Sp;
  const Params p{static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(g), lse, lse2, delta,
                 static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), B, S, T, H, KV, Sp, causal, has_window, window, has_chunk,
                 chunk, q_offset, scale};
  switch (D) {
    case 16: return static_cast<int>(launch<16>(p, q, k, v, s));
    case 32: return static_cast<int>(launch<32>(p, q, k, v, s));
    case 64: return static_cast<int>(launch<64>(p, q, k, v, s));
    case 128: return static_cast<int>(launch<128>(p, q, k, v, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
