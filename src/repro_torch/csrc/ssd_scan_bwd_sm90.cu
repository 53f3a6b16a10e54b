// Mamba-2 SSD scan, backward, for bf16 x, B, C and dy on Hopper's tensor
// cores: the gradients of the chunked state-space duality (the math of
// ssd_scan_bwd.cu and ref.ssd_bwd_reference; the fp32 instance stays there,
// on the CUDA cores: TF32 would not hold its 1e-5).  Per (batch b, head h)
// and chunk, with cs the within-chunk cumulative sum of dt * A, u = dt x,
// S_in the state entering the chunk, R the gradient of the state leaving it
// and M_ij = exp(cs_i - cs_j) on the causal half:
//
//   du_j = sum_{i>=j} (C_i . B_j) M_ij dy_i + exp(cs_end - cs_j) R B_j
//   dB_j = sum_{i>=j} (dy_i . u_j) M_ij C_i + exp(cs_end - cs_j) u_j R
//   dC_i = sum_{j<=i} (dy_i . u_j) M_ij B_j + exp(cs_i) dy_i S_in
//   dcs  = the four exponents' terms; ddA its reverse cumulative sum
//   dx = dt du,  d_dt = x . du + A ddA,  dA = sum dt ddA
//
// Replaces the autodiff of the reference's chunked SSD
// (src/repro/kernels/ref.py:325 ssd_reference, which the reference trains
// through; src/repro/kernels/ssd_scan.py:89 ssd_pallas has no backward).
// Only the carries of S_in and R across chunks are sequential, so the entry
// point launches, in order on the caller's stream:
//
//   1-3. the forward's kernels 1-3 (ssd_tc.cuh): cs; CB = C B^T once per
//        (b, chunk, group) on the causal tiles; each chunk's own state
//        sum_j exp(cs_end - cs_j) dt_j x_j (x) B_j, its left operand as bf16
//        hi + lo;
//   4.   each chunk's own reverse state sum_i exp(cs_i) dy_i (x) C_i, the
//        weighted rows as bf16 hi + mid + lo;
//   5.   ssd_bwd_tc_pass: per (b, h, 256 elements of P x N), over the chunks
//        forward then back: S_in (bf16 hi + lo, and fp32 in place of the own
//        states), R (bf16 hi + lo), the initial state's gradient, and each
//        warp's sum R . S_in of each chunk in double;
//   6.   ssd_bwd_tc_cols: per (64-row tile J of the chunk, run of heads,
//        b * nc + z): for each head, B_J R^T, x_J R, then for every row tile
//        I >= J: (x_J dy_I^T) on wgmma, W1^T = (CB o M)^T and W2^T = (dt_j
//        x_J dy_I^T) o M^T as register A fragments split into hi + lo, du_J
//        += W1^T dy_I and dB_J += W2^T C_I; T's column sums in double; dx,
//        x . du and exp(cs_end - cs_j) u_j . (R B_j);
//   7.   ssd_bwd_tc_rows: per (row tile I, run of heads, b * nc + z): dy_I
//        S_in, then for every J <= I: (dy_I x_J^T), W2 as hi + lo
//        fragments, dC_I += W2 B_J; T's row sums in double;
//   8.   ssd_bwd_tc_finish: per (b, z, h), a thread a row: dcs, its reverse
//        cumulative sum ddA (a block scan), d_dt and a partial of dA, all in
//        double;
//   9.   ordered sums of the partials: dB and dC over the runs of heads of a
//        group (a block of 6 and 7 sums its run's heads in fp32 in
//        registers, in order), dA over batch and chunks.
//
// Every product is wgmma m64nNk16 with fp32 accumulators.  x, B, C and dy go
// in exact, as bf16; dy.u^T is (dy.x^T) times dt_j.  Operands computed in
// fp32 go in split (wgmma.cuh's split_bf16): R, S_in, W1, W2 and the own
// states' weighted rows, two parts each (three for the reverse ones, whose
// sum over every chunk is the initial state's gradient, an fp32 output held
// to 1e-5 of its largest element).  No atomics: every sum has a fixed
// order, the same bits on every run.  T = (CB o M) o (dt_j dy.x^T)'s row and
// column sums, dcs, its reverse cumulative sum and dA accumulate in double:
// dA A = sum_k cs_k dcs_k cancels heavily (|cs| up to ~100).  The plain
// mirror of this arithmetic is ref.ssd_bwd_tc_reference.
//
// What bounds it on the H100: operations.  At mamba2-2.7b's shape (B=2,
// L=4096, H=80, P=64, G=1, N=128, chunk 256) the least work is 118.6
// GFLOP (0.120 ms at the bf16 tensor-core rate); with the splits, the two
// sweeps' shared dy.x^T and the diagonal tiles in full this design runs
// ~52M multiply-adds per (b, h, chunk), ~0.27 TFLOP.  Scratch at that shape,
// bytes written + read: the own states 84 MB each (forward: written, read
// and overwritten with S_in in fp32, read; reverse: written, read), S_in and
// R as bf16 hi + lo 84 MB each (written once, read by every row or column
// tile of their chunk: 4 x), CB 8.4 MB, the partials of dB and dC over runs
// of 8 heads 42 MB each (per head: 335.5 MB), the per-row sums ~18 MB:
// ~1.3 GB moved, ~0.4 ms at 3.35 TB/s if none stays in the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc.cuh"
#include "wgmma.cuh"

namespace {

using namespace ssd_tc;

constexpr int PASS_THREADS = 256;
constexpr int MAX_RUN = 8;  // ref.TC_BWD_MAX_RUN

struct Runs {
  int run;   // heads a block of launches 6 and 7 walks
  int runs;  // runs of a group: (H / G) / run
  int nt;    // 64-row tiles of a chunk
};

__global__ void ssd_bwd_tc_cumsum(const float* __restrict__ dt, const float* __restrict__ A,
                                  float* __restrict__ cs, Shape sh, Strides st) {
  cumsum_body(dt, A, cs, sh, st);
}

template <int N>
__global__ void __launch_bounds__(WG) ssd_bwd_tc_cb(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                                                    float* __restrict__ cb, Shape sh, Strides st) {
  cb_body<N>(Bm, Cm, cb, sh, st);
}

// 3 (REV false) and 4 (REV true: dy and C passed as x and B).
template <int N, bool REV>
__global__ void __launch_bounds__(WG) ssd_bwd_tc_own_state(
    const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ Bm,
    const float* __restrict__ cs, float* __restrict__ state, Shape sh, Strides st) {
  chunk_state_body<N, REV>(x, dt, Bm, cs, state, sh, st);
}

__device__ __forceinline__ float chunk_decay(const float* cs, const Shape& sh, int b, int z, int h) {
  return expf(cs[(static_cast<long long>(b) * sh.L + static_cast<long long>(z + 1) * sh.chunk - 1) * sh.H + h]);
}

// 5. one thread per element e of P x N of one (b, h).  `st` holds the own
// forward states and leaves with S_in in fp32; s_hl and r_hl get S_in and R
// as bf16 (hi, then lo: each (2, B, nc, H, P, N)); rs_part gets each warp's
// sum of R . S_in for each chunk, (B, H, nc, P N / 32).  Each loop loads
// the next chunk's operand before it works on this one's.
__global__ void __launch_bounds__(PASS_THREADS) ssd_bwd_tc_pass(
    float* __restrict__ st, const float* __restrict__ rl, const float* __restrict__ cs,
    const float* __restrict__ init, const float* __restrict__ d_final, bf16* __restrict__ s_hl,
    bf16* __restrict__ r_hl, double* __restrict__ rs_part, float* __restrict__ d_init, Shape sh) {
  const int PN = sh.P * sh.N, nw = PN / 32;
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const long long lo = static_cast<long long>(sh.B) * sh.nc * sh.H * PN;
  const long long zs = static_cast<long long>(sh.H) * PN;  // from one chunk to the next
  const long long i0 = (static_cast<long long>(b) * sh.nc * sh.H + h) * PN + e;
  float carry = init != nullptr ? init[static_cast<long long>(bh) * PN + e] : 0.f;
  float next = st[i0];
  for (int z = 0; z < sh.nc; ++z) {
    const long long idx = i0 + z * zs;
    const float own = next;
    if (z + 1 < sh.nc) next = st[idx + zs];
    const bf16 hi = __float2bfloat16_rn(carry);
    s_hl[idx] = hi;
    s_hl[lo + idx] = __float2bfloat16_rn(carry - __bfloat162float(hi));
    st[idx] = carry;
    carry = __fadd_rn(__fmul_rn(carry, chunk_decay(cs, sh, b, z, h)), own);
  }
  float r = d_final != nullptr ? d_final[static_cast<long long>(bh) * PN + e] : 0.f;
  const long long last = i0 + (sh.nc - 1) * zs;
  float s_next = st[last], own_next = rl[last];
  for (int z = sh.nc - 1; z >= 0; --z) {
    const long long idx = i0 + z * zs;
    const float s_z = s_next, own = own_next;
    if (z > 0) {
      s_next = st[idx - zs];
      own_next = rl[idx - zs];
    }
    const bf16 hi = __float2bfloat16_rn(r);
    r_hl[idx] = hi;
    r_hl[lo + idx] = __float2bfloat16_rn(r - __bfloat162float(hi));
    double v = static_cast<double>(r) * static_cast<double>(s_z);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (threadIdx.x % 32 == 0) rs_part[(static_cast<long long>(bh) * sh.nc + z) * nw + e / 32] = v;
    r = __fadd_rn(__fmul_rn(r, chunk_decay(cs, sh, b, z, h)), own);
  }
  d_init[static_cast<long long>(bh) * PN + e] = r;
}

// The sum of v over the four threads of an accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two bf16 of a swizzled tile (wgmma.cuh's layout) at (row, col), col even.
template <int W>
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int row, int col) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(tile + wg::tile_offset<W>(row, col, TILE));
  return make_float2(__low2float(v), __high2float(v));
}

// The cs and dt rows of the chunk of one head into shared memory.
__device__ __forceinline__ void load_rows(float* csj, float* dtj, const float* cs, const float* dt,
                                          const Shape& sh, int b, long long l0, int h) {
  for (int i = threadIdx.x; i < sh.chunk; i += WG) {
    const long long row = (static_cast<long long>(b) * sh.L + l0 + i) * sh.H + h;
    csj[i] = cs[row];
    dtj[i] = dt[row];
  }
}

__host__ __device__ constexpr int sweep_smem(int N, int P, int chunk) {
  return 2 * TILE * N * 2 + 2 * TILE * P * 2 + 2 * P * N * 2 + 2 * chunk * 4 + 1024;
}

// 6. column tile J of chunk z, for the run of heads blockIdx.y: du_J (dx,
// x . du), dB_J (its run's partial), T's column sums, wq_J.
template <int N, int P>
__global__ void __launch_bounds__(WG) ssd_bwd_tc_cols(
    const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ dy, const float* __restrict__ cs,
    const float* __restrict__ cb, const bf16* __restrict__ r_hl, bf16* __restrict__ dx,
    double* __restrict__ csum_out, float* __restrict__ wq_out, float* __restrict__ xdu_out,
    float* __restrict__ part_b, Shape sh, Runs rn) {
  constexpr int WN = wg::atom_bytes(N), WP = wg::atom_bytes(P);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb = align1024(smem_raw);  // B_J: 64 rows j x N
  uint8_t* sx = sb + TILE * N * 2;    // x_J: 64 rows j x P
  uint8_t* srh = sx + TILE * P * 2;   // R: P rows x N, hi
  uint8_t* srl = srh + P * N * 2;     //   and lo
  uint8_t* sdy = srl + P * N * 2;     // dy_I: 64 rows i x P
  uint8_t* sc = sdy + TILE * P * 2;   // C_I: 64 rows i x N
  float* csj = reinterpret_cast<float*>(sc + TILE * N * 2);
  float* dtj = csj + sh.chunk;
  const int c = sh.chunk, t = threadIdx.x;
  const int J = blockIdx.x, j0 = J * TILE;
  const int h0 = blockIdx.y * rn.run, g = h0 / (sh.H / sh.G);
  const int b = blockIdx.z / sh.nc, z = blockIdx.z % sh.nc;
  const long long l0 = static_cast<long long>(z) * c;
  const long long HP = static_cast<long long>(sh.H) * P, GN = static_cast<long long>(sh.G) * N;
  const long long lo = static_cast<long long>(sh.B) * sh.nc * sh.H * P * N;
  const bf16* bz = Bm + static_cast<long long>(b) * sh.L * GN + static_cast<long long>(g) * N;
  const bf16* cz = Cm + static_cast<long long>(b) * sh.L * GN + static_cast<long long>(g) * N;
  const float* cbz = cb + ((static_cast<long long>(b) * sh.nc + z) * sh.G + g) * c * c;
  const uint32_t ub = wg::smem_u32(sb), ux = wg::smem_u32(sx), urh = wg::smem_u32(srh),
                 url = wg::smem_u32(srl), udy = wg::smem_u32(sdy), uc = wg::smem_u32(sc);
  int jr[2];  // this thread's rows j in the chunk
#pragma unroll
  for (int i = 0; i < 2; ++i) jr[i] = j0 + wg::acc_row(t, i);

  copy_rows<WN>(sb, TILE, 0, bz, GN, l0 + j0, TILE, N);
  float dB[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k) dB[k] = 0.f;

  for (int r = 0; r < rn.run; ++r) {
    const int h = h0 + r;
    const bf16* xh = x + static_cast<long long>(b) * sh.L * HP + static_cast<long long>(h) * P;
    const bf16* dyh = dy + static_cast<long long>(b) * sh.L * HP + static_cast<long long>(h) * P;
    const bf16* rz = r_hl + ((static_cast<long long>(b) * sh.nc + z) * sh.H + h) * P * N;
    __syncthreads();  // the previous head is done with sx, srh, srl and the rows
    copy_rows<WP>(sx, TILE, 0, xh, HP, l0 + j0, TILE, P);
    copy_rows<WN>(srh, P, 0, rz, N, 0, P, N);
    copy_rows<WN>(srl, P, 0, rz + lo, N, 0, P, N);
    wg::cp_async_commit();
    load_rows(csj, dtj, cs, dt, sh, b, l0, h);
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
    __syncthreads();
    const float cs_end = csj[c - 1];
    float wend[2], sj[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wend[i] = expf(__fsub_rn(cs_end, csj[jr[i]]));
      sj[i] = __fmul_rn(wend[i], dtj[jr[i]]);
    }

    // du_J starts as exp(cs_end - cs_j) (B_J R^T); wq_j = exp(cs_end - cs_j)
    // dt_j x_j . (B_J R^T)_j
    float du[P / 2];
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      const uint64_t da = wg::desc_k<WN>(ub, TILE, 0, ks);
      wg::wgmma_ss<P, 0, 0>(du, da, wg::desc_k<WN>(urh, P, 0, ks), ks > 0);
      wg::wgmma_ss<P, 0, 0>(du, da, wg::desc_k<WN>(url, P, 0, ks), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(du);
    float wq[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s = 0.f;
#pragma unroll
      for (int jn = 0; jn < P / 8; ++jn) {
        const float2 xv = tile_pair<WP>(sx, wg::acc_row(t, i), wg::acc_col(t, jn, 0));
        s = fmaf(xv.x, du[4 * jn + 2 * i], s);
        s = fmaf(xv.y, du[4 * jn + 2 * i + 1], s);
        du[4 * jn + 2 * i] *= wend[i];
        du[4 * jn + 2 * i + 1] *= wend[i];
      }
      wq[i] = sj[i] * quad_sum(s);
    }

    // dB_J += exp(cs_end - cs_j) dt_j (x_J R)
    {
      float tmp[N / 2];
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        const uint64_t da = wg::desc_k<WP>(ux, TILE, 0, ks);
        wg::wgmma_ss<N, 0, 1>(tmp, da, wg::desc_mn<WN>(urh, P, 0, ks), ks > 0);
        wg::wgmma_ss<N, 0, 1>(tmp, da, wg::desc_mn<WN>(url, P, 0, ks), 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(tmp);
#pragma unroll
      for (int jn = 0; jn < N / 8; ++jn)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dB[4 * jn + 2 * i] = fmaf(sj[i], tmp[4 * jn + 2 * i], dB[4 * jn + 2 * i]);
          dB[4 * jn + 2 * i + 1] = fmaf(sj[i], tmp[4 * jn + 2 * i + 1], dB[4 * jn + 2 * i + 1]);
        }
    }

    double csum[2] = {0.0, 0.0};
    for (int I = J; I < rn.nt; ++I) {
      const int i0 = I * TILE;
      __syncthreads();  // every thread's products of the last tile are done
      copy_rows<WP>(sdy, TILE, 0, dyh, HP, l0 + i0, TILE, P);
      copy_rows<WN>(sc, TILE, 0, cz, GN, l0 + i0, TILE, N);
      wg::cp_async_commit();
      wg::cp_async_wait<0>();
      wg::fence_async_smem();
      __syncthreads();

      float dxt[TILE / 2];  // (x_J dy_I^T)[j, i]
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks)
        wg::wgmma_ss<TILE, 0, 0>(dxt, wg::desc_k<WP>(ux, TILE, 0, ks), wg::desc_k<WP>(udy, TILE, 0, ks), ks > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(dxt);

      // W1^T = (CB o M)^T: du_J += W1^T dy_I; T = W1 o (dt_j dy.x^T) summed
      // over i
      {
        uint32_t ah[TILE / 4], al[TILE / 4];
#pragma unroll
        for (int jn = 0; jn < TILE / 8; ++jn)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int jj = jr[i];
            float w[2];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int ii = i0 + wg::acc_col(t, jn, cc);
              float w1 = 0.f;
              if (jj <= ii) w1 = __fmul_rn(cbz[static_cast<long long>(ii) * c + jj], expf(__fsub_rn(csj[ii], csj[jj])));
              const float gm = __fmul_rn(dxt[4 * jn + 2 * i + cc], dtj[jj]);
              csum[i] += static_cast<double>(__fmul_rn(w1, gm));
              w[cc] = w1;
            }
            wg::split_bf16(w[0], w[1], ah[2 * jn + i], al[2 * jn + i]);
          }
        wg::fence_regs(du);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          const uint32_t a_hi[4] = {ah[4 * kk], ah[4 * kk + 1], ah[4 * kk + 2], ah[4 * kk + 3]};
          const uint32_t a_lo[4] = {al[4 * kk], al[4 * kk + 1], al[4 * kk + 2], al[4 * kk + 3]};
          const uint64_t bdy = wg::desc_mn<WP>(udy, TILE, 0, kk);
          wg::wgmma_rs<P, 1>(du, a_hi, bdy, 1);
          wg::wgmma_rs<P, 1>(du, a_lo, bdy, 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(du);
      }
      // W2^T = (dt_j x_J dy_I^T) o M^T: dB_J += W2^T C_I
      {
        uint32_t ah[TILE / 4], al[TILE / 4];
#pragma unroll
        for (int jn = 0; jn < TILE / 8; ++jn)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int jj = jr[i];
            float w[2];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int ii = i0 + wg::acc_col(t, jn, cc);
              const float m = jj <= ii ? expf(__fsub_rn(csj[ii], csj[jj])) : 0.f;
              w[cc] = __fmul_rn(__fmul_rn(dxt[4 * jn + 2 * i + cc], dtj[jj]), m);
            }
            wg::split_bf16(w[0], w[1], ah[2 * jn + i], al[2 * jn + i]);
          }
        wg::fence_regs(dB);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          const uint32_t a_hi[4] = {ah[4 * kk], ah[4 * kk + 1], ah[4 * kk + 2], ah[4 * kk + 3]};
          const uint32_t a_lo[4] = {al[4 * kk], al[4 * kk + 1], al[4 * kk + 2], al[4 * kk + 3]};
          const uint64_t bc = wg::desc_mn<WN>(uc, TILE, 0, kk);
          wg::wgmma_rs<N, 1>(dB, a_hi, bc, 1);
          wg::wgmma_rs<N, 1>(dB, a_lo, bc, 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(dB);
      }
    }

    // dx_j = dt_j du_j; x_j . du_j; the row values
    bf16* dxh = dx + static_cast<long long>(b) * sh.L * HP + static_cast<long long>(h) * P;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float dtv = dtj[jr[i]];
      float s = 0.f;
#pragma unroll
      for (int jn = 0; jn < P / 8; ++jn) {
        const int col = wg::acc_col(t, jn, 0);
        const float2 xv = tile_pair<WP>(sx, wg::acc_row(t, i), col);
        const float d0 = du[4 * jn + 2 * i], d1 = du[4 * jn + 2 * i + 1];
        s = fmaf(xv.y, d1, fmaf(xv.x, d0, s));
        *reinterpret_cast<__nv_bfloat162*>(dxh + (l0 + jr[i]) * HP + col) =
            __floats2bfloat162_rn(__fmul_rn(dtv, d0), __fmul_rn(dtv, d1));
      }
      s = quad_sum(s);
      const double cs_i = quad_sum(csum[i]);
      if (t % 4 == 0) {
        const long long row = (static_cast<long long>(b) * sh.H + h) * sh.L + l0 + jr[i];
        csum_out[row] = cs_i;
        wq_out[row] = wq[i];
        xdu_out[row] = s;
      }
    }
  }

  // this run's dB partial: part_b[((b L + l) G + g) runs + run of the group][n]
  const int rg = blockIdx.y % rn.runs;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* out = part_b + ((((static_cast<long long>(b) * sh.L + l0 + jr[i]) * sh.G + g) * rn.runs) + rg) * N;
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn)
      *reinterpret_cast<float2*>(out + wg::acc_col(t, jn, 0)) = make_float2(dB[4 * jn + 2 * i], dB[4 * jn + 2 * i + 1]);
  }
}

// 7. row tile I of chunk z, for the run of heads blockIdx.y: dC_I (its run's
// partial), T's row sums, exp(cs_i) C_i . (dy_i S_in).
template <int N, int P>
__global__ void __launch_bounds__(WG) ssd_bwd_tc_rows(
    const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ dy, const float* __restrict__ cs,
    const float* __restrict__ cb, const bf16* __restrict__ s_hl, double* __restrict__ rsum_out,
    float* __restrict__ off_out, float* __restrict__ part_c, Shape sh, Runs rn) {
  constexpr int WN = wg::atom_bytes(N), WP = wg::atom_bytes(P);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sc = align1024(smem_raw);  // C_I: 64 rows i x N
  uint8_t* sdy = sc + TILE * N * 2;   // dy_I: 64 rows i x P
  uint8_t* ssh = sdy + TILE * P * 2;  // S_in: P rows x N, hi
  uint8_t* ssl = ssh + P * N * 2;     //   and lo
  uint8_t* sx = ssl + P * N * 2;      // x_J: 64 rows j x P
  uint8_t* sb = sx + TILE * P * 2;    // B_J: 64 rows j x N
  float* csj = reinterpret_cast<float*>(sb + TILE * N * 2);
  float* dtj = csj + sh.chunk;
  const int c = sh.chunk, t = threadIdx.x;
  const int I = rn.nt - 1 - static_cast<int>(blockIdx.x), i0 = I * TILE;  // longest first
  const int h0 = blockIdx.y * rn.run, g = h0 / (sh.H / sh.G);
  const int b = blockIdx.z / sh.nc, z = blockIdx.z % sh.nc;
  const long long l0 = static_cast<long long>(z) * c;
  const long long HP = static_cast<long long>(sh.H) * P, GN = static_cast<long long>(sh.G) * N;
  const long long lo = static_cast<long long>(sh.B) * sh.nc * sh.H * P * N;
  const bf16* bz = Bm + static_cast<long long>(b) * sh.L * GN + static_cast<long long>(g) * N;
  const bf16* cz = Cm + static_cast<long long>(b) * sh.L * GN + static_cast<long long>(g) * N;
  const float* cbz = cb + ((static_cast<long long>(b) * sh.nc + z) * sh.G + g) * c * c;
  const uint32_t ux = wg::smem_u32(sx), ush = wg::smem_u32(ssh), usl = wg::smem_u32(ssl),
                 udy = wg::smem_u32(sdy), ubm = wg::smem_u32(sb);
  int ir[2];  // this thread's rows i in the chunk
#pragma unroll
  for (int i = 0; i < 2; ++i) ir[i] = i0 + wg::acc_row(t, i);

  copy_rows<WN>(sc, TILE, 0, cz, GN, l0 + i0, TILE, N);
  float dC[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k) dC[k] = 0.f;

  for (int r = 0; r < rn.run; ++r) {
    const int h = h0 + r;
    const bf16* xh = x + static_cast<long long>(b) * sh.L * HP + static_cast<long long>(h) * P;
    const bf16* dyh = dy + static_cast<long long>(b) * sh.L * HP + static_cast<long long>(h) * P;
    const bf16* sz = s_hl + ((static_cast<long long>(b) * sh.nc + z) * sh.H + h) * P * N;
    __syncthreads();  // the previous head is done with sdy, ssh, ssl and the rows
    copy_rows<WP>(sdy, TILE, 0, dyh, HP, l0 + i0, TILE, P);
    copy_rows<WN>(ssh, P, 0, sz, N, 0, P, N);
    copy_rows<WN>(ssl, P, 0, sz + lo, N, 0, P, N);
    wg::cp_async_commit();
    load_rows(csj, dtj, cs, dt, sh, b, l0, h);
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
    __syncthreads();

    // dC_I += exp(cs_i) (dy_I S_in); off_i = exp(cs_i) C_i . (dy_I S_in)_i
    float off[2];
    {
      float tmp[N / 2];
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        const uint64_t da = wg::desc_k<WP>(udy, TILE, 0, ks);
        wg::wgmma_ss<N, 0, 1>(tmp, da, wg::desc_mn<WN>(ush, P, 0, ks), ks > 0);
        wg::wgmma_ss<N, 0, 1>(tmp, da, wg::desc_mn<WN>(usl, P, 0, ks), 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(tmp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float e = expf(csj[ir[i]]);
        float s = 0.f;
#pragma unroll
        for (int jn = 0; jn < N / 8; ++jn) {
          const float2 cv = tile_pair<WN>(sc, wg::acc_row(t, i), wg::acc_col(t, jn, 0));
          s = fmaf(cv.y, tmp[4 * jn + 2 * i + 1], fmaf(cv.x, tmp[4 * jn + 2 * i], s));
          dC[4 * jn + 2 * i] = fmaf(e, tmp[4 * jn + 2 * i], dC[4 * jn + 2 * i]);
          dC[4 * jn + 2 * i + 1] = fmaf(e, tmp[4 * jn + 2 * i + 1], dC[4 * jn + 2 * i + 1]);
        }
        off[i] = e * quad_sum(s);
      }
    }

    double rsum[2] = {0.0, 0.0};
    for (int J = 0; J <= I; ++J) {
      const int j0 = J * TILE;
      __syncthreads();  // every thread's products of the last tile are done
      copy_rows<WP>(sx, TILE, 0, xh, HP, l0 + j0, TILE, P);
      copy_rows<WN>(sb, TILE, 0, bz, GN, l0 + j0, TILE, N);
      wg::cp_async_commit();
      wg::cp_async_wait<0>();
      wg::fence_async_smem();
      __syncthreads();

      float dxv[TILE / 2];  // (dy_I x_J^T)[i, j]
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks)
        wg::wgmma_ss<TILE, 0, 0>(dxv, wg::desc_k<WP>(udy, TILE, 0, ks), wg::desc_k<WP>(ux, TILE, 0, ks), ks > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(dxv);

      uint32_t ah[TILE / 4], al[TILE / 4];
#pragma unroll
      for (int jn = 0; jn < TILE / 8; ++jn)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ii = ir[i], jl = j0 + wg::acc_col(t, jn, 0);
          const float2 cbv = *reinterpret_cast<const float2*>(cbz + static_cast<long long>(ii) * c + jl);
          float w[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int jj = jl + cc;
            const float m = jj <= ii ? expf(__fsub_rn(csj[ii], csj[jj])) : 0.f;
            const float gm = __fmul_rn(dxv[4 * jn + 2 * i + cc], dtj[jj]);
            w[cc] = __fmul_rn(gm, m);
            rsum[i] += static_cast<double>(__fmul_rn(__fmul_rn(cc ? cbv.y : cbv.x, m), gm));
          }
          wg::split_bf16(w[0], w[1], ah[2 * jn + i], al[2 * jn + i]);
        }
      wg::fence_regs(dC);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        const uint32_t a_hi[4] = {ah[4 * kk], ah[4 * kk + 1], ah[4 * kk + 2], ah[4 * kk + 3]};
        const uint32_t a_lo[4] = {al[4 * kk], al[4 * kk + 1], al[4 * kk + 2], al[4 * kk + 3]};
        const uint64_t bb = wg::desc_mn<WN>(ubm, TILE, 0, kk);
        wg::wgmma_rs<N, 1>(dC, a_hi, bb, 1);
        wg::wgmma_rs<N, 1>(dC, a_lo, bb, 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(dC);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const double rs = quad_sum(rsum[i]);
      if (t % 4 == 0) {
        const long long row = (static_cast<long long>(b) * sh.H + h) * sh.L + l0 + ir[i];
        rsum_out[row] = rs;
        off_out[row] = off[i];
      }
    }
  }

  const int rg = blockIdx.y % rn.runs;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* out = part_c + ((((static_cast<long long>(b) * sh.L + l0 + ir[i]) * sh.G + g) * rn.runs) + rg) * N;
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn)
      *reinterpret_cast<float2*>(out + wg::acc_col(t, jn, 0)) = make_float2(dC[4 * jn + 2 * i], dC[4 * jn + 2 * i + 1]);
  }
}

// The sum of v over the block, in a fixed order (every thread gets it);
// `red` holds a double per warp.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) s += red[w];
  return s;
}

// v summed over this thread and every later one of the block (a reverse
// inclusive scan, in a fixed order).
__device__ __forceinline__ double block_rscan(double v, double* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += u;
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;  // the warp's total
  __syncthreads();
  for (int w = static_cast<int>(blockDim.x) / 32 - 1; w > warp; --w) v += red[w];
  return v;
}

// 8. one block of `chunk` threads per (b, z, h), a thread per row i: dcs_i,
// its reverse cumulative sum ddA_i, d_dt_i and the chunk's share of dA, in
// double.  The row arrays are (B, H, L).
__global__ void __launch_bounds__(256) ssd_bwd_tc_finish(
    const float* __restrict__ cs, const float* __restrict__ dt, const float* __restrict__ A,
    const double* __restrict__ rs_part, int nw, const double* __restrict__ rsum,
    const double* __restrict__ csum, const float* __restrict__ off, const float* __restrict__ wq,
    const float* __restrict__ xdu, float* __restrict__ d_dt, double* __restrict__ part_a, Shape sh) {
  __shared__ double red[8];
  const int h = blockIdx.x % sh.H, z = (blockIdx.x / sh.H) % sh.nc, b = blockIdx.x / (sh.H * sh.nc);
  const int i = threadIdx.x, c = sh.chunk;
  const long long l0 = static_cast<long long>(z) * c;
  const long long rh = (static_cast<long long>(b) * sh.H + h) * sh.L + l0 + i;  // (B, H, L)
  const long long rl = (static_cast<long long>(b) * sh.L + l0 + i) * sh.H + h;  // (B, L, H)
  double part = 0.0;
  const double* rp = rs_part + ((static_cast<long long>(b) * sh.H + h) * sh.nc + z) * nw;
  for (int k = i; k < nw; k += c) part += rp[k];
  const double rs = block_sum(part, red);
  const double wqv = static_cast<double>(wq[rh]);
  const double wq_sum = block_sum(wqv, red);
  double d = rsum[rh] - csum[rh] + static_cast<double>(off[rh]) - wqv;
  if (i == c - 1) d += static_cast<double>(chunk_decay(cs, sh, b, z, h)) * rs + wq_sum;
  const double run = block_rscan(d, red);  // ddA_i
  d_dt[rl] = static_cast<float>(static_cast<double>(xdu[rh]) + static_cast<double>(A[h]) * run);
  const double da = block_sum(static_cast<double>(dt[rl]) * run, red);
  if (i == 0) part_a[(static_cast<long long>(h) * sh.B + b) * sh.nc + z] = da;
}

__device__ __forceinline__ void store(float* p, double v) { *p = static_cast<float>(v); }
__device__ __forceinline__ void store(bf16* p, double v) { *p = __float2bfloat16_rn(static_cast<float>(v)); }

// 9. out[r K + k] = the sum over s < S, in order and in double, of part[(r S
// + s) K + k], rounded to fp32 once (and then to bf16 for a bf16 out).
template <typename TP, typename TO>
__global__ void ssd_bwd_tc_reduce(const TP* __restrict__ part, TO* __restrict__ out, long long rows, int S,
                                  int K) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * K) return;
  const long long r = idx / K;
  const int k = static_cast<int>(idx % K);
  const TP* p = part + r * S * K + k;
  double acc = 0.0;
  for (int s = 0; s < S; ++s) acc += static_cast<double>(p[static_cast<long long>(s) * K]);
  store(out + idx, acc);
}

template <typename TP, typename TO>
cudaError_t reduce(const TP* part, TO* out, long long rows, int S, int K, cudaStream_t s) {
  const long long n = rows * K;
  ssd_bwd_tc_reduce<TP, TO><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(part, out, rows, S, K);
  return cudaGetLastError();
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int head_run(int rep) {
  int run = 1;
  for (int d = 1; d <= (rep < MAX_RUN ? rep : MAX_RUN); ++d)
    if (rep % d == 0) run = d;
  return run;
}

long long round_up(long long n) { return (n + 1023) / 1024 * 1024; }

// The scratch's pieces, in bytes, in the order the entry point carves them.
constexpr int N_PIECES = 14;
void pieces(int Bsz, int L, int H, int P, int G, int N, int chunk, long long* out) {
  const long long nc = L / chunk, BLH = static_cast<long long>(Bsz) * L * H;
  const long long states = 4LL * Bsz * nc * H * P * N;
  const long long runs = (H / G) / head_run(H / G);
  const long long parts = 4LL * Bsz * L * G * runs * N;
  const long long v[N_PIECES] = {
      4 * BLH,                                     // cs
      4LL * Bsz * nc * G * chunk * chunk,          // CB
      states,                                      // own forward states, then S_in
      states,                                      // own reverse states
      states,                                      // S_in, bf16 hi + lo
      states,                                      // R, bf16 hi + lo
      8LL * Bsz * H * nc * ((static_cast<long long>(P) * N) / 32),  // sum R . S_in, a partial a warp
      8 * BLH, 8 * BLH,                            // T's row and column sums
      4 * BLH, 4 * BLH, 4 * BLH,                   // off, wq, x . du
      parts + parts,                               // dB's and dC's partials
      8LL * H * Bsz * nc,                          // dA's partials
  };
  for (int i = 0; i < N_PIECES; ++i) out[i] = round_up(v[i]);
}

template <int N, int P>
cudaError_t launch(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm, const bf16* dy,
                   const float* init, const float* d_final, bf16* dx, float* d_dt, float* dA, bf16* dB, bf16* dC,
                   float* d_init, uint8_t* scratch, const Shape& sh, cudaStream_t s) {
  long long sz[N_PIECES];
  pieces(sh.B, sh.L, sh.H, sh.P, sh.G, sh.N, sh.chunk, sz);
  uint8_t* at[N_PIECES];
  for (int i = 0; i < N_PIECES; ++i) at[i] = i == 0 ? scratch : at[i - 1] + sz[i - 1];
  float* cs = reinterpret_cast<float*>(at[0]);
  float* cb = reinterpret_cast<float*>(at[1]);
  float* st_f = reinterpret_cast<float*>(at[2]);
  float* st_r = reinterpret_cast<float*>(at[3]);
  bf16* s_hl = reinterpret_cast<bf16*>(at[4]);
  bf16* r_hl = reinterpret_cast<bf16*>(at[5]);
  double* rs_part = reinterpret_cast<double*>(at[6]);
  double* rsum = reinterpret_cast<double*>(at[7]);
  double* csum = reinterpret_cast<double*>(at[8]);
  float* off = reinterpret_cast<float*>(at[9]);
  float* wq = reinterpret_cast<float*>(at[10]);
  float* xdu = reinterpret_cast<float*>(at[11]);
  float* part_b = reinterpret_cast<float*>(at[12]);
  float* part_c = part_b + sz[12] / 8;
  double* part_a = reinterpret_cast<double*>(at[13]);

  // x and dy, B and C: contiguous, of one shape each
  const long long HP = static_cast<long long>(sh.H) * P, GN = static_cast<long long>(sh.G) * N;
  const Strides st{sh.L * HP, HP, P, static_cast<long long>(sh.L) * sh.H, sh.H, 1,
                   sh.L * GN, GN, N, sh.L * GN, GN, N, sh.L * HP, HP, P};
  const int rep = sh.H / sh.G, run = head_run(rep);
  const Runs rn{run, rep / run, sh.chunk / TILE};
  const long long units = static_cast<long long>(sh.B) * sh.nc * sh.H;

  ssd_bwd_tc_cumsum<<<static_cast<unsigned>((units + 255) / 256), 256, 0, s>>>(dt, A, cs, sh, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_cb = (TILE + sh.chunk) * N * 2 + 1024;
  if ((err = set_smem(ssd_bwd_tc_cb<N>, smem_cb)) != cudaSuccess) return err;
  ssd_bwd_tc_cb<N><<<dim3(rn.nt, sh.nc, sh.B * sh.G), WG, smem_cb, s>>>(Bm, Cm, cb, sh, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 own_grid(P / TILE, sh.H, sh.B * sh.nc);
  const int smem_f = chunk_state_smem(N, false, sh.chunk), smem_r = chunk_state_smem(N, true, sh.chunk);
  if ((err = set_smem(ssd_bwd_tc_own_state<N, false>, smem_f)) != cudaSuccess) return err;
  ssd_bwd_tc_own_state<N, false><<<own_grid, WG, smem_f, s>>>(x, dt, Bm, cs, st_f, sh, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(ssd_bwd_tc_own_state<N, true>, smem_r)) != cudaSuccess) return err;
  ssd_bwd_tc_own_state<N, true><<<own_grid, WG, smem_r, s>>>(dy, dt, Cm, cs, st_r, sh, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_tc_pass<<<dim3(P * N / PASS_THREADS, sh.B * sh.H), PASS_THREADS, 0, s>>>(st_f, st_r, cs, init, d_final, s_hl, r_hl,
                                                                   rs_part, d_init, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 sweep_grid(rn.nt, sh.H / run, sh.B * sh.nc);
  const int smem_sw = sweep_smem(N, P, sh.chunk);
  if ((err = set_smem(ssd_bwd_tc_cols<N, P>, smem_sw)) != cudaSuccess) return err;
  ssd_bwd_tc_cols<N, P><<<sweep_grid, WG, smem_sw, s>>>(x, dt, Bm, Cm, dy, cs, cb, r_hl, dx, csum, wq, xdu,
                                                        part_b, sh, rn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(ssd_bwd_tc_rows<N, P>, smem_sw)) != cudaSuccess) return err;
  ssd_bwd_tc_rows<N, P><<<sweep_grid, WG, smem_sw, s>>>(x, dt, Bm, Cm, dy, cs, cb, s_hl, rsum, off, part_c,
                                                        sh, rn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_tc_finish<<<static_cast<unsigned>(units), sh.chunk, 0, s>>>(cs, dt, A, rs_part, P * N / 32, rsum, csum,
                                                                       off, wq, xdu, d_dt, part_a, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long BLG = static_cast<long long>(sh.B) * sh.L * sh.G;
  if ((err = reduce(part_b, dB, BLG, rn.runs, N, s)) != cudaSuccess) return err;
  if ((err = reduce(part_c, dC, BLG, rn.runs, N, s)) != cudaSuccess) return err;
  return reduce(part_a, dA, sh.H, sh.B * sh.nc, 1, s);
}

}  // namespace

// Bytes of scratch a call needs (the wrapper allocates one buffer of it).
extern "C" long long veer_ssd_scan_bwd_tc_scratch(int Bsz, int L, int H, int P, int G, int N, int chunk) {
  long long sz[N_PIECES];
  pieces(Bsz, L, H, P, G, N, chunk, sz);
  long long total = 0;
  for (int i = 0; i < N_PIECES; ++i) total += sz[i];
  return total;
}

// The heads a block sums dB and dC over, for `rep` heads a group.
extern "C" int veer_ssd_scan_bwd_tc_head_run(int rep) { return head_run(rep); }

// Launches on `stream` (PyTorch's current stream) and returns the first
// cudaError_t; the caller raises on anything but 0.  Every tensor is
// contiguous, its base 16-byte aligned: x, dy, dx (B, L, H, P) bf16; dt, d_dt
// (B, L, H) fp32; A, dA (H,) fp32; B, C, dB, dC (B, L, G, N) bf16;
// init_state, d_final (null: zeros) and d_init (B, H, P, N) fp32.  Shapes:
// chunk in {64, 128, 256}, L a multiple of it, P = 64, N in {64, 128}, H a
// multiple of G (the wrapper checks).
extern "C" int veer_ssd_scan_bwd_tc(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                                    const void* dy, const float* init_state, const float* d_final, void* dx,
                                    float* d_dt, float* dA, void* dB, void* dC, float* d_init, void* scratch,
                                    int Bsz, int L, int H, int P, int G, int N, int chunk, void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G) return static_cast<int>(cudaErrorInvalidValue);
  if ((chunk != 64 && chunk != 128 && chunk != 256) || L % chunk || P != 64 || (N != 64 && N != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{Bsz, L, H, P, G, N, chunk, L / chunk};
  const int run = head_run(H / G);
  if (static_cast<long long>(Bsz) * sh.nc > 65535 || H / run > 65535 || static_cast<long long>(Bsz) * G > 65535 ||
      static_cast<long long>(Bsz) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xb = static_cast<const bf16*>(x), *bb = static_cast<const bf16*>(Bm),
             *cb = static_cast<const bf16*>(Cm), *yb = static_cast<const bf16*>(dy);
  bf16 *dxb = static_cast<bf16*>(dx), *dbb = static_cast<bf16*>(dB), *dcb = static_cast<bf16*>(dC);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  const cudaError_t err =
      N == 64 ? launch<64, 64>(xb, dt, A, bb, cb, yb, init_state, d_final, dxb, d_dt, dA, dbb, dcb, d_init, sc, sh, s)
              : launch<128, 64>(xb, dt, A, bb, cb, yb, init_state, d_final, dxb, d_dt, dA, dbb, dcb, d_init, sc, sh, s);
  return static_cast<int>(err);
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
