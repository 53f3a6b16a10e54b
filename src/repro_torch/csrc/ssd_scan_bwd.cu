// Mamba-2 SSD scan, backward: the gradients of the chunked state-space
// duality (csrc/ssd_scan.cu's forward) for the output gradients dy and dS
// (the final state's; zero when not given).  Per (batch b, head h) and chunk,
// with cs the within-chunk cumulative sum of dt * A, u = dt x, S_in the state
// entering the chunk and R the gradient of the state leaving it:
//
//   R of the chunk before = exp(cs_end) R + sum_i exp(cs_i) dy_i (x) C_i
//   du_j = sum_{i>=j} (C_i . B_j) exp(cs_i - cs_j) dy_i + exp(cs_end - cs_j) R B_j
//   dC_i = sum_{j<=i} exp(cs_i - cs_j) (dy_i . u_j) B_j + exp(cs_i) dy_i S_in
//   dB_j = sum_{i>=j} exp(cs_i - cs_j) (dy_i . u_j) C_i + exp(cs_end - cs_j) u_j R
//   dcs  = the four exponents' terms; ddA its reverse cumulative sum
//   dx = dt du,  d_dt = x . du + A ddA,  dA = sum dt ddA
//
// with dB and dC summed over the heads of their group.  x, B, C and dy are
// fp32 or bf16 (read as fp32), dt and A fp32; dx, dB and dC come back in
// x's dtype, d_dt, dA and the initial state's gradient in fp32.  The math is
// ref.ssd_bwd_reference's.
//
// Replaces the autodiff of the reference's chunked SSD
// (src/repro/kernels/ref.py:325 ssd_reference, which the reference trains
// through; its Pallas kernel src/repro/kernels/ssd_scan.py:89 ssd_pallas has
// no backward).  Three launches, deterministic (no atomics: every sum in a
// fixed order, the same bits on every run):
//
//   1. the scans: one block per (h, b, 64-column tile of P, direction).  The
//      forward direction carries the state through the chunks in order (cs
//      summed in order by one thread, as the forward kernels do) and writes
//      the state entering each chunk; the reverse direction carries R from
//      dS back through the chunks, writes the R leaving each chunk and, at
//      the end, the initial state's gradient.  The (P tile x N) state lives
//      in registers, each thread owning 4 x 4 of each 64-column tile of N.
//      This is the sequential part; it does 2 c P N FMAs a chunk.
//   2. the chunks: one block per (h, b, chunk, tile of P), all independent
//      once S_in and R are known.  Two sweeps over the chunk's 64-row tiles:
//      the first over column tiles J (rows j of B and u), each against every
//      row tile I >= J (C, dy): C.B^T and dy.u^T recomputed, masked and
//      decayed, give du_J, dB_J and the column sums of the decayed
//      (C.B^T)(dy.u^T); the second over row tiles I against J <= I gives
//      dC_I.  The row sums, the state and inter-chunk terms come alongside.
//      dx is written here; dB, dC, d_dt (per tile of P) and dA (per chunk)
//      are fp32 partials of this head.
//   3. the partials summed in order: over the heads of a group (and the
//      tiles of P) for dB and dC, over the tiles of P for d_dt, over batch,
//      chunks and tiles for dA.
//
// dA is a sum with heavy cancellation: dA a = sum_k cs_k dcs_k (of one head,
// 8,192 terms at the main path's shape), and dcs_k holds the row sum minus
// the column sum of the decayed (C.B^T)(dy.u^T), each large, with |cs| up to
// ~100.  In fp32, in any order, those row and column sums lose ~1e-5 of dA.
// So they, the rest of dcs, its reverse cumulative sum ddA, a chunk's share
// of dA and the ordered sums of launch 3 accumulate in double and round to
// fp32 once.
//
// What bounds it on this card: operations.  Per (b, h, chunk of c rows) the
// backward needs ~3 c^2 N / 2 + c^2 P FMAs for the intra-chunk products and
// ~6 c P N for the state and inter-chunk ones; at the main path's shape (c
// 256, N 128, P 64) that is ~27M FMAs against ~0.3 MB read.  The products
// are fp32 FMAs on the CUDA cores: every one a 64 x 64 tile of two
// shared-memory operands (mma_tile), each thread a 4 x 4 register tile, the
// operands at odd row strides so that a warp's reads fall in distinct banks
// whichever of a matrix's two axes it walks.  This is the simple design;
// wgmma, TMA and a chunk-parallel scan are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;      // rows of a chunk tile, columns of a P tile and of an N tile
constexpr int PS = TILE + 1;  // row stride of a (64 x 64) matrix in shared memory
constexpr int MAX_NT = 2;     // tiles of 64 columns of N: N <= 128

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

struct Shape {
  int B, L, H, P, G, N, chunk;
  int NT;        // tiles of 64 columns of N
  int NS;        // row stride of a (64 x N) matrix in shared memory: 64 NT + 1
  int n_chunks;  // L / chunk
  int p_tiles;   // tiles of 64 columns of P
};

// acc[r][q] += sum_{k < K} A(ty + 16 r, k) * B(k, tx + 16 q), with
// A(i, k) = a[i * ai + k * ak] and B(k, j) = b[k * bk + j * bj]: this
// thread's 4 x 4 of a 64 x 64 tile of the product of two shared-memory
// operands.
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* a, int ai, int ak,
                                         const float* b, int bk, int bj, int K) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* ar = a + ty * ai;
  const float* bc = b + tx * bj;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = ar[16 * r * ai + k * ak];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = bc[k * bk + 16 * q * bj];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
}

// The sum of v over the 16 threads of a row (one ty): every thread gets it.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [r0, r0 + 64) and columns [0, cols) of a row-major matrix `src` (row
// stride `ld` elements) into `dst` (row stride `ds`), each row times
// scale[r0 + r] where `scale` is given; zero at rows >= limit, columns >=
// cols, up to `width` columns.
template <typename T>
__device__ void load_tile(float* dst, int ds, const T* src, long long ld, int r0, int limit,
                          int cols, int width, const float* scale) {
  for (int idx = threadIdx.x; idx < TILE * width; idx += THREADS) {
    const int r = idx / width, col = idx % width;
    float v = 0.f;
    if (r0 + r < limit && col < cols) {
      v = to_f(src[(long long)(r0 + r) * ld + col]);
      if (scale != nullptr) v *= scale[r0 + r];
    }
    dst[r * ds + col] = v;
  }
}

// cs[i] = sum_{k <= i} dt[k] * a over the chunk, in order, each product and
// add rounded (as the forward kernels sum it); one thread.
__device__ __forceinline__ void chunk_cumsum(float* cs, const float* dts, float a, int c) {
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int i = 0; i < c; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], a));
      cs[i] = run;
    }
  }
}

// ---- launch 1: the forward scan of the states and the reverse scan of R ------

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                    const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
                    const float* __restrict__ init_state, const float* __restrict__ d_final,
                    float* __restrict__ s_in, float* __restrict__ r_out, float* __restrict__ d_init,
                    Shape sh) {
  extern __shared__ float smem[];
  const int NS = sh.NS, c = sh.chunk, NW = TILE * sh.NT;
  float* vs = smem;             // 64 x PS: rows of u (forward) or dy (reverse), weighted, this P tile
  float* ks = vs + TILE * PS;   // 64 x NS: rows of B (forward) or C (reverse)
  float* dts = ks + TILE * NS;  // c
  float* cs = dts + c;          // c
  float* wts = cs + c;          // c: exp(cs_end - cs_j) dt_j (forward), exp(cs_i) (reverse)

  const int h = blockIdx.x, b = blockIdx.y, reverse = blockIdx.z & 1, p0 = (blockIdx.z >> 1) * TILE;
  const int g = h / (sh.H / sh.G), pcols = min(TILE, sh.P - p0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float a = A[h];
  const long long HP = (long long)sh.H * sh.P, GN = (long long)sh.G * sh.N, PN = (long long)sh.P * sh.N;
  const T* vsrc = (reverse ? dy : x) + ((long long)b * sh.L * sh.H + h) * sh.P + p0;
  const T* ksrc = (reverse ? Cm : Bm) + (long long)b * sh.L * GN + (long long)g * sh.N;
  const float* dtb = dt + (long long)b * sh.L * sh.H + h;
  const long long st_off = ((long long)b * sh.H + h) * PN;                 // (b, h) of a (B, H, P, N) state
  const long long sc_off = ((long long)b * sh.H + h) * sh.n_chunks * PN;   // (b, h) of the scratch

  // S[nt][r][q]: row p0 + ty + 16 r, column 64 nt + tx + 16 q of the state (or R)
  float S[MAX_NT][4][4];
  const float* s0 = reverse ? d_final : init_state;
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = ty + 16 * r, n = 64 * nt + tx + 16 * q;
        S[nt][r][q] = (s0 != nullptr && nt < sh.NT && p < pcols && n < sh.N)
                          ? s0[st_off + (long long)(p0 + p) * sh.N + n] : 0.f;
      }

  for (int step = 0; step < sh.n_chunks; ++step) {
    const int z = reverse ? sh.n_chunks - 1 - step : step;
    const long long l0 = (long long)z * c;
    // the state entering chunk z (forward) or the gradient of the one leaving it (reverse)
    float* out = (reverse ? r_out : s_in) + sc_off + z * PN;
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = ty + 16 * r, n = 64 * nt + tx + 16 * q;
          if (nt < sh.NT && p < pcols && n < sh.N) out[(long long)(p0 + p) * sh.N + n] = S[nt][r][q];
        }
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = threadIdx.x; i < c; i += THREADS) dts[i] = dtb[(l0 + i) * sh.H];
    __syncthreads();
    chunk_cumsum(cs, dts, a, c);
    __syncthreads();
    const float cs_end = cs[c - 1];
    for (int i = threadIdx.x; i < c; i += THREADS)
      wts[i] = reverse ? expf(cs[i]) : expf(cs_end - cs[i]) * dts[i];

    float acc[MAX_NT][4][4];
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) zero(acc[nt]);
    for (int j0 = 0; j0 < c; j0 += TILE) {
      __syncthreads();  // wts written; vs and ks free
      load_tile(vs, PS, vsrc + l0 * HP, HP, j0, c, pcols, TILE, wts);
      load_tile(ks, NS, ksrc + l0 * GN, GN, j0, c, sh.N, NW, (const float*)nullptr);
      __syncthreads();
      // acc(p, n) += sum_j V(j, p) K(j, n)
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
        if (nt < sh.NT) mma_tile(acc[nt], vs, 1, PS, ks + 64 * nt, NS, 1, TILE);
    }
    const float decay = expf(cs_end);
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) S[nt][r][q] = fmaf(S[nt][r][q], decay, acc[nt][r][q]);
  }

  if (reverse) {
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = ty + 16 * r, n = 64 * nt + tx + 16 * q;
          if (nt < sh.NT && p < pcols && n < sh.N) d_init[st_off + (long long)(p0 + p) * sh.N + n] = S[nt][r][q];
        }
  }
}

// ---- launch 2: each chunk's gradients, given S_in and R ---------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                     const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
                     const float* __restrict__ s_in, const float* __restrict__ r_in, T* __restrict__ dx,
                     float* __restrict__ part_b, float* __restrict__ part_c, float* __restrict__ part_dt,
                     float* __restrict__ part_a, Shape sh) {
  extern __shared__ float smem[];
  const int NS = sh.NS, c = sh.chunk, NT = sh.NT, NW = TILE * NT;
  float* ct = smem;              // 64 x NS  rows of C of the row tile I
  float* bt = ct + TILE * NS;    // 64 x NS  rows of B of the column tile J
  float* ms = bt + TILE * NS;    // 64 x NS  R (first sweep), then S_in (second), as ms[p * NS + n]
  float* dyt = ms + TILE * NS;   // 64 x PS  rows of dy of I, this P tile
  float* ut = dyt + TILE * PS;   // 64 x PS  rows of u = dt x of J, this P tile
  float* w1 = ut + TILE * PS;    // 64 x PS  (C.B^T) o M of the pair (I, J), M the masked decays
  float* w2 = w1 + TILE * PS;    // 64 x PS  (dy.u^T) o M
  float* tt = w2 + TILE * PS;    // 64 x PS  (C.B^T) o (dy.u^T) o M
  // c rows each (the doubles first: the offset so far is even):
  double* rsum = reinterpret_cast<double*>(tt + TILE * PS);  // row sums of tt (into dcs_i)
  double* csum = rsum + c;                                  // column sums of tt (out of dcs_j)
  float* dts = reinterpret_cast<float*>(csum + c);
  float* cs = dts + c;           //   the cumulative sum of dt * A
  float* ecs = cs + c;           //   exp(cs_i)
  float* wend = ecs + c;         //   exp(cs_end - cs_j)
  float* off = wend + c;         //   exp(cs_i) C_i . (dy_i S_in) (into dcs_i)
  float* wq = off + c;           //   exp(cs_end - cs_j) u_j . (R B_j) (out of dcs_j, into dcs_end)
  float* xdu = wq + c;           //   x_j . du_j, then d_dt's partial
  float* red = xdu + c;          // WARPS + 1

  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z / sh.p_tiles, pt = blockIdx.z % sh.p_tiles;
  const int p0 = pt * TILE, g = h / (sh.H / sh.G), pcols = min(TILE, sh.P - p0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[h];
  const long long HP = (long long)sh.H * sh.P, GN = (long long)sh.G * sh.N, PN = (long long)sh.P * sh.N;
  const long long l0 = (long long)z * c;
  const long long xo = ((b * (long long)sh.L + l0) * sh.H + h) * sh.P + p0;  // row 0 of the chunk
  const T* xz = x + xo;
  const T* dyz = dy + xo;
  T* dxz = dx + xo;
  const long long bo = (b * (long long)sh.L + l0) * GN + (long long)g * sh.N;
  const T* bz = Bm + bo;
  const T* cz = Cm + bo;
  const float* dtz = dt + (b * (long long)sh.L + l0) * sh.H + h;
  const long long so = (((long long)b * sh.H + h) * sh.n_chunks + z) * PN;  // (b, h, z) of the scratch
  // partials of this (b, l, h, p tile): ((b L + l) H + h) p_tiles + pt
  const long long po = ((b * (long long)sh.L + l0) * sh.H + h) * sh.p_tiles + pt;
  const long long prow = (long long)sh.H * sh.p_tiles;  // from one row l to the next

  for (int i = tid; i < c; i += THREADS) {
    dts[i] = dtz[(long long)i * sh.H];
    rsum[i] = csum[i] = 0.0;
  }
  for (int idx = tid; idx < TILE * NW; idx += THREADS) {
    const int p = idx / NW, n = idx % NW;
    ms[p * NS + n] = (p < pcols && n < sh.N) ? r_in[so + (long long)(p0 + p) * sh.N + n] : 0.f;
  }
  __syncthreads();
  chunk_cumsum(cs, dts, a, c);
  __syncthreads();
  const float cs_end = cs[c - 1];
  for (int i = tid; i < c; i += THREADS) {
    ecs[i] = expf(cs[i]);
    wend[i] = expf(cs_end - cs[i]);
  }

  // ---- sweep 1: column tiles J: du_J, dB_J, the column sums, wq_J -------------------
  for (int j0 = 0; j0 < c; j0 += TILE) {
    __syncthreads();  // bt, ut free; the row arrays written
    load_tile(bt, NS, bz, GN, j0, c, sh.N, NW, (const float*)nullptr);
    load_tile(ut, PS, xz, HP, j0, c, pcols, TILE, dts);
    __syncthreads();
    float du[4][4], db[MAX_NT][4][4];
    float wr[4];  // exp(cs_end - cs_j) of this thread's rows j, 0 past the chunk
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty + 16 * r;
      wr[r] = j < c ? wend[j] : 0.f;
    }
    {
      // (B R^T)(j, p), into du_j and wq_j
      float br[4][4];
      zero(br);
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
        if (nt < NT) mma_tile(br, bt + 64 * nt, NS, 1, ms + 64 * nt, 1, NS, TILE);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s = fmaf(ut[(ty + 16 * r) * PS + tx + 16 * q], br[r][q], s);
          du[r][q] = wr[r] * br[r][q];
        }
        s = row_sum16(s);
        const int j = j0 + ty + 16 * r;
        if (tx == 0 && j < c) wq[j] = wr[r] * s;
      }
      // (u R)(j, n), into dB_j
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        zero(db[nt]);
        if (nt < NT) {
          float ur[4][4];
          zero(ur);
          mma_tile(ur, ut, PS, 1, ms + 64 * nt, NS, 1, TILE);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) db[nt][r][q] = wr[r] * ur[r][q];
        }
      }
    }
    for (int i0 = j0; i0 < c; i0 += TILE) {
      __syncthreads();  // ct, dyt, w1, w2, tt free
      load_tile(ct, NS, cz, GN, i0, c, sh.N, NW, (const float*)nullptr);
      load_tile(dyt, PS, dyz, HP, i0, c, pcols, TILE, (const float*)nullptr);
      __syncthreads();
      float cb[4][4], gm[4][4];
      zero(cb);
      zero(gm);
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
        if (nt < NT) mma_tile(cb, ct + 64 * nt, NS, 1, bt + 64 * nt, 1, NS, TILE);  // C_i . B_j
      mma_tile(gm, dyt, PS, 1, ut, 1, PS, TILE);                                     // dy_i . u_j
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int il = ty + 16 * r, jl = tx + 16 * q, i = i0 + il, j = j0 + jl;
          const float m = (j <= i && i < c) ? expf(cs[i] - cs[j]) : 0.f;
          w1[il * PS + jl] = cb[r][q] * m;
          w2[il * PS + jl] = gm[r][q] * m;
          tt[il * PS + jl] = cb[r][q] * gm[r][q] * m;
        }
      __syncthreads();
      if (tid < TILE) {  // row sums of tt, in order of j
        const int i = i0 + tid;
        if (i < c) {
          double s = 0.0;
          for (int jl = 0; jl < TILE; ++jl) s += static_cast<double>(tt[tid * PS + jl]);
          rsum[i] += s;
        }
      } else if (tid < 2 * TILE) {  // column sums, in order of i
        const int jl = tid - TILE, j = j0 + jl;
        if (j < c) {
          double s = 0.0;
          for (int il = 0; il < TILE; ++il) s += static_cast<double>(tt[il * PS + jl]);
          csum[j] += s;
        }
      }
      // du_j += sum_i w1(i, j) dy_i;  dB_j += sum_i w2(i, j) C_i
      mma_tile(du, w1, 1, PS, dyt, PS, 1, TILE);
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
        if (nt < NT) mma_tile(db[nt], w2, 1, PS, ct + 64 * nt, NS, 1, TILE);
    }
    // dx_j = dt_j du_j; x_j . du_j; dB_j's partial
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty + 16 * r;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (j < c && p < pcols) {
          s = fmaf(to_f(xz[j * HP + p]), du[r][q], s);
          dxz[j * HP + p] = from_f<T>(dts[j] * du[r][q]);
        }
      }
      s = row_sum16(s);
      if (tx == 0 && j < c) xdu[j] = s;
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = 64 * nt + tx + 16 * q;
          if (nt < NT && j < c && n < sh.N) part_b[(po + j * prow) * sh.N + n] = db[nt][r][q];
        }
    }
  }

  // ---- <R, S_in>, as S_in takes R's place --------------------------------------------
  __syncthreads();
  float rs = 0.f;
  for (int idx = tid; idx < TILE * NW; idx += THREADS) {
    const int p = idx / NW, n = idx % NW;
    const float sv = (p < pcols && n < sh.N) ? s_in[so + (long long)(p0 + p) * sh.N + n] : 0.f;
    rs = fmaf(ms[p * NS + n], sv, rs);
    ms[p * NS + n] = sv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
  if (tid % 32 == 0) red[tid / 32] = rs;

  // ---- sweep 2: row tiles I: dC_I and the inter-chunk term of dcs_i ---------------------
  for (int i0 = 0; i0 < c; i0 += TILE) {
    __syncthreads();  // ct, dyt free; ms holds S_in
    load_tile(ct, NS, cz, GN, i0, c, sh.N, NW, (const float*)nullptr);
    load_tile(dyt, PS, dyz, HP, i0, c, pcols, TILE, (const float*)nullptr);
    __syncthreads();
    float dc[MAX_NT][4][4];
    float er[4], offs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      er[r] = i < c ? ecs[i] : 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      zero(dc[nt]);
      if (nt < NT) {
        float ys[4][4];  // (dy S_in)(i, n)
        zero(ys);
        mma_tile(ys, dyt, PS, 1, ms + 64 * nt, NS, 1, TILE);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dc[nt][r][q] = er[r] * ys[r][q];
            offs[r] = fmaf(ct[(ty + 16 * r) * NS + 64 * nt + tx + 16 * q], ys[r][q], offs[r]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float s = row_sum16(offs[r]);
      const int i = i0 + ty + 16 * r;
      if (tx == 0 && i < c) off[i] = er[r] * s;
    }
    for (int j0 = 0; j0 <= i0; j0 += TILE) {
      __syncthreads();  // bt, ut, w2 free
      load_tile(bt, NS, bz, GN, j0, c, sh.N, NW, (const float*)nullptr);
      load_tile(ut, PS, xz, HP, j0, c, pcols, TILE, dts);
      __syncthreads();
      float gm[4][4];
      zero(gm);
      mma_tile(gm, dyt, PS, 1, ut, 1, PS, TILE);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int il = ty + 16 * r, jl = tx + 16 * q, i = i0 + il, j = j0 + jl;
          w2[il * PS + jl] = (j <= i && i < c) ? gm[r][q] * expf(cs[i] - cs[j]) : 0.f;
        }
      __syncthreads();
      // dC_i += sum_j w2(i, j) B_j
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
        if (nt < NT) mma_tile(dc[nt], w2, PS, 1, bt + 64 * nt, NS, 1, TILE);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = 64 * nt + tx + 16 * q;
          if (nt < NT && i < c && n < sh.N) part_c[(po + i * prow) * sh.N + n] = dc[nt][r][q];
        }
    }
  }

  // ---- dcs, its reverse cumulative sum ddA, d_dt's and dA's partials, in order --------
  __syncthreads();
  if (tid == 0) {  // dcs, its reverse cumulative sum and dA's sum in double: they cancel heavily
    double rsd = 0.0, wq_sum = 0.0;
    for (int w = 0; w < WARPS; ++w) rsd += static_cast<double>(red[w]);
    for (int j = 0; j < c; ++j) wq_sum += static_cast<double>(wq[j]);
    double run = 0.0, da = 0.0;
    for (int i = c - 1; i >= 0; --i) {
      double d = rsum[i] - csum[i] + static_cast<double>(off[i]) - static_cast<double>(wq[i]);
      if (i == c - 1) d += static_cast<double>(ecs[i]) * rsd + wq_sum;
      run += d;  // ddA_i
      xdu[i] = static_cast<float>(static_cast<double>(xdu[i]) + static_cast<double>(a) * run);
      da += static_cast<double>(dts[i]) * run;
    }
    part_a[(((long long)h * sh.B + b) * sh.n_chunks + z) * sh.p_tiles + pt] = static_cast<float>(da);
  }
  __syncthreads();
  for (int i = tid; i < c; i += THREADS) part_dt[po + i * prow] = xdu[i];
}

// ---- launch 3: partials summed in order ---------------------------------------------

// out[r K + k] = sum over s < S, in order and in double, of part[(r S + s) K + k]
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ out, long long rows, int S, int K) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= rows * K) return;
  const long long r = idx / K;
  const int k = static_cast<int>(idx % K);
  const float* p = part + r * S * K + k;
  double acc = 0.0;
  for (int s = 0; s < S; ++s) acc += static_cast<double>(p[(long long)s * K]);
  out[idx] = from_f<T>(static_cast<float>(acc));
}

long long scan_smem_floats(int NS, int chunk) { return (long long)TILE * PS + (long long)TILE * NS + 3LL * chunk; }
long long chunk_smem_floats(int NS, int chunk) {
  return 3LL * TILE * NS + 5LL * TILE * PS + 11LL * chunk + WARPS + 1;  // rsum, csum: 2 floats a row
}

template <typename T>
cudaError_t reduce(const float* part, T* out, long long rows, int S, int K, cudaStream_t stream) {
  const long long n = rows * K;
  if (n == 0) return cudaSuccess;
  ssd_bwd_reduce_kernel<T><<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      part, out, rows, S, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                   const void* dy, const float* init_state, const float* d_final, void* dx, float* d_dt,
                   float* dA, void* dB, void* dC, float* d_init, float* s_in, float* r_z, float* part_b,
                   float* part_c, float* part_dt, float* part_a, const Shape& sh, cudaStream_t stream) {
  const size_t scan_smem = 4 * static_cast<size_t>(scan_smem_floats(sh.NS, sh.chunk));
  const size_t chunk_smem = 4 * static_cast<size_t>(chunk_smem_floats(sh.NS, sh.chunk));
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(scan_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(chunk_smem));
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  ssd_bwd_scan_kernel<T><<<dim3(sh.H, sh.B, 2 * sh.p_tiles), THREADS, scan_smem, stream>>>(
      xt, dt, A, bt, ct, dyt, init_state, d_final, s_in, r_z, d_init, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T><<<dim3(sh.H, sh.B, sh.n_chunks * sh.p_tiles), THREADS, chunk_smem, stream>>>(
      xt, dt, A, bt, ct, dyt, s_in, r_z, static_cast<T*>(dx), part_b, part_c, part_dt, part_a, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long BL = (long long)sh.B * sh.L;
  const int rep = sh.H / sh.G;
  if ((err = reduce<T>(part_b, static_cast<T*>(dB), BL * sh.G, rep * sh.p_tiles, sh.N, stream)) != cudaSuccess)
    return err;
  if ((err = reduce<T>(part_c, static_cast<T*>(dC), BL * sh.G, rep * sh.p_tiles, sh.N, stream)) != cudaSuccess)
    return err;
  if ((err = reduce<float>(part_dt, d_dt, BL * sh.H, sh.p_tiles, 1, stream)) != cudaSuccess) return err;
  return reduce<float>(part_a, dA, sh.H, sh.B * sh.n_chunks * sh.p_tiles, 1, stream);
}

}  // namespace

// Dynamic shared memory, in bytes, that the larger of the backward's
// kernels (launch 2) needs at (N, chunk); the wrapper refuses shapes above
// the card's 227 KB a block.
extern "C" long long veer_ssd_scan_bwd_smem_bytes(int N, int chunk) {
  const int NS = TILE * ((N + TILE - 1) / TILE) + 1;
  const long long a = scan_smem_floats(NS, chunk), b = chunk_smem_floats(NS, chunk);
  return 4LL * (a > b ? a : b);
}

// Bytes of the six fp32 scratch buffers, in the order veer_ssd_scan_bwd
// takes them: the states entering the chunks and the R leaving them (B, H,
// n_chunks, P, N) each, the partials of dB and dC (B, L, H, P tiles, N) each,
// of d_dt (B, L, H, P tiles) and of dA (H, B, n_chunks, P tiles).
extern "C" void veer_ssd_scan_bwd_scratch(int Bsz, int L, int H, int P, int N, int chunk, long long* sizes) {
  const long long nc = chunk > 0 ? L / chunk : 0, pt = (P + TILE - 1) / TILE;
  sizes[0] = sizes[1] = 4LL * Bsz * H * nc * P * N;
  sizes[2] = sizes[3] = 4LL * Bsz * L * H * pt * N;
  sizes[4] = 4LL * Bsz * L * H * pt;
  sizes[5] = 4LL * H * Bsz * nc * pt;
}

// Launches on `stream` (PyTorch's current stream) and returns the first
// cudaError_t; the caller raises on anything but 0.  dtype 0: x, B, C, dy,
// dx, dB and dC fp32; 1: bf16.  Every tensor is contiguous: x, dy, dx (B, L,
// H, P); dt, d_dt (B, L, H) fp32; A, dA (H,) fp32; B, C, dB, dC (B, L, G, N);
// init_state, d_final (may be null: zeros) and d_init (B, H, P, N) fp32.  L
// must be a multiple of chunk, H of G, and N at most 128.
extern "C" int veer_ssd_scan_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                                 const void* Cm, const void* dy, const float* init_state,
                                 const float* d_final, void* dx, float* d_dt, float* dA, void* dB, void* dC,
                                 float* d_init, float* s_in, float* r_z, float* part_b, float* part_c,
                                 float* part_dt, float* part_a, int dtype, int Bsz, int L, int H, int P,
                                 int G, int N, int chunk, void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (chunk <= 0 || L % chunk || G <= 0 || H % G || N > TILE * MAX_NT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int p_tiles = (P + TILE - 1) / TILE, n_chunks = L / chunk;
  if (Bsz > 65535 || 2 * p_tiles > 65535 || (long long)n_chunks * p_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NT = (N + TILE - 1) / TILE;
  const Shape sh{Bsz, L, H, P, G, N, chunk, NT, TILE * NT + 1, n_chunks, p_tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, dt, A, Bm, Cm, dy, init_state, d_final, dx, d_dt, dA, dB, dC,
                                          d_init, s_in, r_z, part_b, part_c, part_dt, part_a, sh, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, init_state, d_final, dx, d_dt, dA, dB,
                                                  dC, d_init, s_in, r_z, part_b, part_c, part_dt, part_a, sh,
                                                  s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
