// The chunk-parallel pieces of the Mamba-2 SSD scan on Hopper's tensor cores
// that the forward (ssd_scan_sm90.cu) and the backward (ssd_scan_bwd_sm90.cu)
// share: the within-chunk cumulative sums, C.B^T once per group, and each
// chunk's own state.  Each piece is a device function that a kernel of the
// including file runs as its whole body (the kernels keep their files' names,
// so a profile tells the forward's launches from the backward's).  The
// layouts, copies and wgmma helpers are wgmma.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace ssd_tc {

using bf16 = __nv_bfloat16;
constexpr int WG = 128;  // threads of a warpgroup
constexpr int TILE = 64; // rows of a wgmma A tile; columns of P per block

// Element strides (the last axis of x, B, C and y is contiguous).
struct Strides {
  long long xb, xl, xh;
  long long db, dl, dh;
  long long bb, bl, bg;
  long long cb, cl, cg;
  long long yb, yl, yh;
};

struct Shape {
  int B, L, H, P, G, N, chunk, nc;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// rows [r0, r0 + rows) of a (., width) bf16 matrix with row stride `ld` into
// a swizzled tile of `tile_rows` rows (row r0 + r lands in tile row r + dr).
template <int W>
__device__ __forceinline__ void copy_rows(uint8_t* tile, int tile_rows, int dr, const bf16* src,
                                          long long ld, int r0, int rows, int width) {
  const int chunks = width / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, col = (e % chunks) * 8;
    wg::cp_async16(wg::smem_u32(tile + wg::tile_offset<W>(dr + r, col, tile_rows)),
                   src + (r0 + r) * ld + col);
  }
}

// cs[b, l, h] (contiguous (B, L, H)): the within-chunk cumulative sum of
// dt * A, in order in fp32, each product and sum rounded.  One thread per
// (b, chunk, h).
__device__ __forceinline__ void cumsum_body(const float* __restrict__ dt, const float* __restrict__ A,
                                            float* __restrict__ cs, const Shape& sh, const Strides& st) {
  const long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= static_cast<long long>(sh.B) * sh.nc * sh.H) return;
  const int h = static_cast<int>(u % sh.H);
  const int z = static_cast<int>((u / sh.H) % sh.nc);
  const int b = static_cast<int>(u / (static_cast<long long>(sh.H) * sh.nc));
  const float a = A[h];
  const float* d = dt + b * st.db + h * st.dh + static_cast<long long>(z) * sh.chunk * st.dl;
  float* out = cs + (static_cast<long long>(b) * sh.L + static_cast<long long>(z) * sh.chunk) * sh.H + h;
  float run = 0.f;
  for (int i = 0; i < sh.chunk; ++i) {
    run = __fadd_rn(run, __fmul_rn(d[i * st.dl], a));
    out[static_cast<long long>(i) * sh.H] = run;
  }
}

// cb[b, z, g, i, j] = C_i . B_j for the 64-row tile of i and every j of the
// tiles up to its diagonal (fp32, (B, nc, G, chunk, chunk)); one warpgroup
// per (tile, chunk, b * G + g), the longest tile first.
template <int N>
__device__ __forceinline__ void cb_body(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                                        float* __restrict__ cb, const Shape& sh, const Strides& st) {
  constexpr int W = wg::atom_bytes(N);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sc = align1024(smem_raw);           // 64 x N
  uint8_t* sb = sc + TILE * N * 2;             // chunk x N (the rows up to the diagonal)
  const int it = static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int z = blockIdx.y;
  const int b = blockIdx.z / sh.G, g = blockIdx.z % sh.G;
  const int t = threadIdx.x;
  const long long l0 = static_cast<long long>(z) * sh.chunk;
  const int jrows = (it + 1) * TILE;

  copy_rows<W>(sc, TILE, 0, Cm + b * st.cb + g * st.cg, st.cl, l0 + it * TILE, TILE, N);
  copy_rows<W>(sb, sh.chunk, 0, Bm + b * st.bb + g * st.bg, st.bl, l0, jrows, N);
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  wg::fence_async_smem();
  __syncthreads();

  const uint32_t uc = wg::smem_u32(sc), ub = wg::smem_u32(sb);
  float* out = cb + (((static_cast<long long>(b) * sh.nc + z) * sh.G + g) * sh.chunk +
                     it * TILE) * sh.chunk;
  for (int jt = 0; jt <= it; ++jt) {
    float d[TILE / 2];
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
      wg::wgmma_ss<TILE, 0, 0>(d, wg::desc_k<W>(uc, TILE, 0, ks),
                               wg::desc_k<W>(ub, sh.chunk, jt * TILE, ks), ks > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(d);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(out + static_cast<long long>(wg::acc_row(t, i)) * sh.chunk +
                                   jt * TILE + wg::acc_col(t, j, 0)) =
            make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  }
}

// Dynamic shared memory of chunk_state_body<N, REV>.
__host__ __device__ constexpr int chunk_state_smem(int N, bool rev, int chunk) {
  return TILE * N * 2 + (rev ? 3 : 2) * TILE * TILE * 2 + chunk * 4 + 1024;
}

// A chunk's own state, for 64 columns p of P: state[b, z, h, p, n] =
// sum_j a_j[p] K_j[n] (fp32, (B, nc, H, P, N)).  Forward (REV false): a_j =
// exp(cs_end - cs_j) dt_j x_j, K = B, the left operand split into bf16 hi +
// lo (two products).  Reverse (REV true, the backward's gradient of the
// state, the rows dy and C passed as x and B): a_i = exp(cs_i) dy_i, K = C,
// split into hi + mid + lo (three products: 24 bits of each weighted row; the
// initial state's gradient is the sum of these over every chunk, held to
// 1e-5 of its largest element).  One warpgroup per (P tile, h, b * nc + z).
template <int N, bool REV>
__device__ __forceinline__ void chunk_state_body(const bf16* __restrict__ x, const float* __restrict__ dt,
                                                 const bf16* __restrict__ Bm, const float* __restrict__ cs,
                                                 float* __restrict__ state, const Shape& sh,
                                                 const Strides& st) {
  constexpr int WB = wg::atom_bytes(N);
  constexpr int PARTS = REV ? 3 : 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb = align1024(smem_raw);     // 64 rows j x N, MN-major
  uint8_t* shi = sb + TILE * N * 2;      // PARTS x (64 rows j x 64 columns p), MN-major
  float* wj = reinterpret_cast<float*>(shi + PARTS * TILE * TILE * 2);  // chunk
  const int p0 = blockIdx.x * TILE, h = blockIdx.y;
  const int b = blockIdx.z / sh.nc, z = blockIdx.z % sh.nc;
  const int g = h / (sh.H / sh.G);
  const int t = threadIdx.x;
  const long long l0 = static_cast<long long>(z) * sh.chunk;
  const float* csb = cs + (static_cast<long long>(b) * sh.L + l0) * sh.H + h;
  const float cs_end = csb[static_cast<long long>(sh.chunk - 1) * sh.H];
  for (int j = t; j < sh.chunk; j += WG) {
    if constexpr (REV)
      wj[j] = expf(csb[static_cast<long long>(j) * sh.H]);
    else
      wj[j] = __fmul_rn(expf(__fsub_rn(cs_end, csb[static_cast<long long>(j) * sh.H])),
                        dt[b * st.db + (l0 + j) * st.dl + h * st.dh]);
  }
  const bf16* xb = x + b * st.xb + h * st.xh + p0;
  const bf16* bb = Bm + b * st.bb + g * st.bg;

  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint32_t ub = wg::smem_u32(sb), uhi = wg::smem_u32(shi);
  for (int j0 = 0; j0 < sh.chunk; j0 += TILE) {
    __syncthreads();  // the previous sub-tile's products are done; wj is written
    copy_rows<WB>(sb, TILE, 0, bb, st.bl, l0 + j0, TILE, N);
    wg::cp_async_commit();
    for (int e = t; e < TILE * TILE / 8; e += WG) {
      const int j = e / (TILE / 8), p = (e % (TILE / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(xb + (l0 + j0 + j) * st.xl + p);
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
      const float w = wj[j0 + j];
      uint32_t parts[PARTS][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a0 = __fmul_rn(__bfloat162float(xv[2 * k]), w);
        const float a1 = __fmul_rn(__bfloat162float(xv[2 * k + 1]), w);
        if constexpr (REV) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a0, a1);
          parts[0][k] = *reinterpret_cast<const uint32_t*>(&hi);
          wg::split_bf16(a0 - __low2float(hi), a1 - __high2float(hi), parts[1][k], parts[2][k]);
        } else {
          wg::split_bf16(a0, a1, parts[0][k], parts[1][k]);
        }
      }
      const uint32_t off = wg::tile_offset<128>(j, p, TILE);
#pragma unroll
      for (int q = 0; q < PARTS; ++q)
        *reinterpret_cast<uint4*>(shi + q * TILE * TILE * 2 + off) =
            make_uint4(parts[q][0], parts[q][1], parts[q][2], parts[q][3]);
    }
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
    __syncthreads();
    wg::fence_regs(d);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks) {
      const uint64_t db = wg::desc_mn<WB>(ub, TILE, 0, ks);
#pragma unroll
      for (int q = 0; q < PARTS; ++q)
        wg::wgmma_ss<N, 1, 1>(d, wg::desc_mn<128>(uhi + q * TILE * TILE * 2, TILE, 0, ks), db, 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(d);
  }
  float* out = state + ((static_cast<long long>(b) * sh.nc + z) * sh.H + h) * sh.P * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(out + static_cast<long long>(p0 + wg::acc_row(t, i)) * N +
                                 wg::acc_col(t, j, 0)) =
          make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
}

}  // namespace ssd_tc
