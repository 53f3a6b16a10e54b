// Mamba-2 SSD scan, forward, bf16 on Hopper's tensor cores: the chunked
// state-space duality of arXiv:2405.21060 as its chunk-parallel algorithm.
// The fp32 instance stays on the CUDA cores (ssd_scan.cu): TF32 would not
// hold its tolerance of 1e-5.
//
// Replaces src/repro/kernels/ssd_scan.py:89 ssd_pallas, whose grid
// (B, H, n_chunks) walks the chunks in order on one TPU core and carries the
// (P, N) state in VMEM scratch.  Only that carry is sequential: everything
// else about a chunk depends on its own inputs.  So the one C entry point
// launches five kernels in order on the caller's stream:
//
//   1. ssd_tc_cumsum      per (b, chunk, h): cs, the within-chunk cumulative
//                         sum of dt * A, in order in fp32, each product and
//                         sum rounded (as the fp32 instance does).
//   2. ssd_tc_cb          per (b, chunk, group, 64-row tile): CB = C B^T on
//                         the causal half, once per group (not once per
//                         head), wgmma, fp32 out.
//   3. ssd_tc_chunk_state per (b, chunk, h, 64 columns of P): the chunk's own
//                         state  sum_j (exp(cs_end - cs_j) dt_j x_j) (x) B_j,
//                         wgmma with that left operand split into bf16
//                         hi + lo (two products: a bf16 operand alone would
//                         cost ~2^-9 per term, beyond the final state's 1e-4),
//                         B exact in bf16, fp32 out.
//   4. ssd_tc_state_pass  per (b, h, 256 elements of P x N), over the chunks
//                         in order: S_in[z] = exp(cs_end[z-1]) S_in[z-1] +
//                         state[z-1], from initial_state or zero; writes each
//                         S_in split into bf16 hi + lo and the fp32 final
//                         state.
//   5. ssd_tc_chunk_out   per (b, chunk, h, 64-row tile, 64 columns of P):
//                         y = exp(cs_i) (C_i . S_in) + (CB o L o dt) x, wgmma
//                         on S_in's hi and lo parts and on CB o L o dt split
//                         likewise (four products; C and x are exact in
//                         bf16), fp32 sums, y rounded once to bf16.
//
// Kernels 1-3 run the bodies in ssd_tc.cuh, which the backward
// (ssd_scan_bwd_sm90.cu) runs too.
//
// The splits stand where the TPU kernel multiplies in fp32: one bf16 operand
// costs ~2^-9 per term, and rounding S_in and CB o L o dt so (as the
// published Mamba-2 kernels do) moved the logits of a model with an MoE block
// after its mamba mixer by routing tokens to other experts (PERF.md, PR 21).
//
// Every rounding above is mirrored by ref.ssd_chunked_reference, the plain
// PyTorch version of this arithmetic.  Operands copied as they are (x, B, C,
// S_in) arrive by cp.async into the swizzled tiles wgmma reads (wgmma.cuh);
// operands computed on the way (the hi/lo split, CB o L o dt) are written by
// the threads into the same layout.
//
// What bounds it on the H100: bytes.  At mamba2-2.7b's prefill shape (B=2,
// L=4096, H=80, P=64, G=1, N=128, chunk 256) the inputs and outputs are
// ~180 MB (0.054 ms at 3.35 TB/s), the least work 3.25e10 FLOPs (0.033 ms
// at the bf16 peak).  The chunk-parallel form adds its scratch: the chunk
// states in fp32 (B nc H P N * 4 = 84 MB written and read), S_in as bf16
// hi + lo (84 MB written and read), CB (8 MB) and cs (3 MB): ~0.11 ms more at the
// memory rate, the price of 2,560 independent (b, chunk, h) units instead of
// the sequential form's 160 (b, h) walks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc.cuh"
#include "wgmma.cuh"

namespace {

using namespace ssd_tc;

// 1. cs[b, l, h] (contiguous (B, L, H)): the within-chunk cumulative sum.
__global__ void ssd_tc_cumsum(const float* __restrict__ dt, const float* __restrict__ A,
                              float* __restrict__ cs, Shape sh, Strides st) {
  cumsum_body(dt, A, cs, sh, st);
}

// 2. cb[b, z, g, i, j] = C_i . B_j on the causal tiles (fp32, (B, nc, G,
// chunk, chunk)).
template <int N>
__global__ void __launch_bounds__(WG) ssd_tc_cb(const bf16* __restrict__ Bm,
                                                const bf16* __restrict__ Cm,
                                                float* __restrict__ cb, Shape sh, Strides st) {
  cb_body<N>(Bm, Cm, cb, sh, st);
}

// 3. state[b, z, h, p, n] = sum_j a_j[p] B_j[n], a_j = exp(cs_end - cs_j) dt_j
// x_j, for 64 columns p of P (fp32, (B, nc, H, P, N)).
template <int N>
__global__ void __launch_bounds__(WG) ssd_tc_chunk_state(
    const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ Bm,
    const float* __restrict__ cs, float* __restrict__ state, Shape sh, Strides st) {
  chunk_state_body<N, false>(x, dt, Bm, cs, state, sh, st);
}

// 4. the state entering each chunk as bf16 hi + lo (each (B, nc, H, P, N),
// lo after hi), and the fp32 final state.  One thread per element of P x N
// of one (b, h).
__global__ void ssd_tc_state_pass(const float* __restrict__ state, const float* __restrict__ cs,
                                  const float* __restrict__ init, bf16* __restrict__ s_in,
                                  float* __restrict__ final_state, Shape sh) {
  const int PN = sh.P * sh.N;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const long long lo = static_cast<long long>(sh.B) * sh.nc * sh.H * PN;
  float carry = init != nullptr ? init[static_cast<long long>(bh) * PN + e] : 0.f;
  for (int z = 0; z < sh.nc; ++z) {
    const long long idx = ((static_cast<long long>(b) * sh.nc + z) * sh.H + h) * PN + e;
    const bf16 hi = __float2bfloat16_rn(carry);
    s_in[idx] = hi;
    s_in[lo + idx] = __float2bfloat16_rn(carry - __bfloat162float(hi));
    const float decay =
        expf(cs[(static_cast<long long>(b) * sh.L + static_cast<long long>(z + 1) * sh.chunk - 1) * sh.H + h]);
    carry = __fadd_rn(__fmul_rn(carry, decay), state[idx]);
  }
  final_state[static_cast<long long>(bh) * PN + e] = carry;
}

// 5. y for the 64-row tile of i and 64 columns of P of one (b, chunk, h).
template <int N>
__global__ void __launch_bounds__(WG) ssd_tc_chunk_out(
    const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ Cm,
    const float* __restrict__ cs, const float* __restrict__ cb, const bf16* __restrict__ s_in,
    bf16* __restrict__ y, Shape sh, Strides st) {
  constexpr int WN = wg::atom_bytes(N);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sc = align1024(smem_raw);   // 64 rows i x N, K-major
  uint8_t* ss = sc + TILE * N * 2;     // 64 rows p x N, K-major: S_in's hi
  uint8_t* ssl = ss + TILE * N * 2;    // and lo
  uint8_t* sm = ssl + TILE * N * 2;    // 64 rows i x 64 j, K-major: M's hi
  uint8_t* sml = sm + TILE * TILE * 2; // and lo
  uint8_t* sx = sml + TILE * TILE * 2; // 64 rows j x 64 p, MN-major
  float* csj = reinterpret_cast<float*>(sx + TILE * TILE * 2);  // cs of rows [0, i0 + 64)
  float* dtj = csj + sh.chunk;                                   // dt of the same rows
  const int n_it = sh.chunk / TILE;
  const int it = n_it - 1 - static_cast<int>(blockIdx.x) % n_it;  // longest first
  const int p0 = (static_cast<int>(blockIdx.x) / n_it) * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z / sh.nc, z = blockIdx.z % sh.nc;
  const int g = h / (sh.H / sh.G);
  const int t = threadIdx.x;
  const int i0 = it * TILE;
  const long long l0 = static_cast<long long>(z) * sh.chunk;

  copy_rows<WN>(sc, TILE, 0, Cm + b * st.cb + g * st.cg, st.cl, l0 + i0, TILE, N);
  const long long s_lo = static_cast<long long>(sh.B) * sh.nc * sh.H * sh.P * N;
  const bf16* sin = s_in + (((static_cast<long long>(b) * sh.nc + z) * sh.H + h) * sh.P) * N;
  copy_rows<WN>(ss, TILE, 0, sin, N, p0, TILE, N);
  copy_rows<WN>(ssl, TILE, 0, sin + s_lo, N, p0, TILE, N);
  wg::cp_async_commit();
  const float* csb = cs + (static_cast<long long>(b) * sh.L + l0) * sh.H + h;
  for (int j = t; j < i0 + TILE; j += WG) {
    csj[j] = csb[static_cast<long long>(j) * sh.H];
    dtj[j] = dt[b * st.db + (l0 + j) * st.dl + h * st.dh];
  }
  wg::cp_async_wait<0>();
  wg::fence_async_smem();
  __syncthreads();

  // inter-chunk: (C_i . S_in) exp(cs_i)
  float d[TILE / 2];
  const uint32_t uc = wg::smem_u32(sc), us = wg::smem_u32(ss), usl = wg::smem_u32(ssl);
  const uint32_t um = wg::smem_u32(sm), uml = wg::smem_u32(sml), ux = wg::smem_u32(sx);
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    const uint64_t dc = wg::desc_k<WN>(uc, TILE, 0, ks);
    wg::wgmma_ss<TILE, 0, 0>(d, dc, wg::desc_k<WN>(us, TILE, 0, ks), ks > 0);
    wg::wgmma_ss<TILE, 0, 0>(d, dc, wg::desc_k<WN>(usl, TILE, 0, ks), 1);
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(d);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float e = expf(csj[i0 + wg::acc_row(t, i)]);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      d[4 * j + 2 * i] *= e;
      d[4 * j + 2 * i + 1] *= e;
    }
  }

  // intra-chunk: (CB o L o dt) x over the column tiles up to the diagonal
  const float* cbt = cb + (((static_cast<long long>(b) * sh.nc + z) * sh.G + g) * sh.chunk + i0) *
                              sh.chunk;
  const bf16* xb = x + b * st.xb + h * st.xh + p0;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * TILE;
    __syncthreads();  // the previous tile's products are done with sm and sx
    copy_rows<128>(sx, TILE, 0, xb, st.xl, l0 + j0, TILE, TILE);
    wg::cp_async_commit();
    for (int e = t; e < TILE * TILE / 8; e += WG) {
      const int i = e / (TILE / 8), j = (e % (TILE / 8)) * 8;
      const float4 c0 = *reinterpret_cast<const float4*>(cbt + static_cast<long long>(i) * sh.chunk + j0 + j);
      const float4 c1 = *reinterpret_cast<const float4*>(cbt + static_cast<long long>(i) * sh.chunk + j0 + j + 4);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float ci = csj[i0 + i];
      float mv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int jj = j0 + j + k;
        mv[k] = jj <= i0 + i
                    ? __fmul_rn(__fmul_rn(cv[k], expf(__fsub_rn(ci, csj[jj]))), dtj[jj])
                    : 0.f;
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) wg::split_bf16(mv[2 * k], mv[2 * k + 1], hi[k], lo[k]);
      const uint32_t off = wg::tile_offset<128>(i, j, TILE);
      *reinterpret_cast<uint4*>(sm + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sml + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
    __syncthreads();
    wg::fence_regs(d);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks) {
      const uint64_t dx = wg::desc_mn<128>(ux, TILE, 0, ks);
      wg::wgmma_ss<TILE, 0, 1>(d, wg::desc_k<128>(um, TILE, 0, ks), dx, 1);
      wg::wgmma_ss<TILE, 0, 1>(d, wg::desc_k<128>(uml, TILE, 0, ks), dx, 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(d);
  }

  bf16* yb = y + b * st.yb + h * st.yh + p0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = yb + (l0 + i0 + wg::acc_row(t, i)) * st.yl;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + wg::acc_col(t, j, 0)) =
          __floats2bfloat162_rn(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int N>
cudaError_t launch(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
                   const float* init, bf16* y, float* final_state, float* cs, float* cb,
                   float* state, bf16* s_in, const Shape& sh, const Strides& st, cudaStream_t s) {
  const int c = sh.chunk, nt = c / TILE;
  const long long units = static_cast<long long>(sh.B) * sh.nc * sh.H;
  ssd_tc_cumsum<<<static_cast<unsigned>((units + 255) / 256), 256, 0, s>>>(dt, A, cs, sh, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_cb = (TILE + c) * N * 2 + 1024;
  if ((err = set_smem(ssd_tc_cb<N>, smem_cb)) != cudaSuccess) return err;
  ssd_tc_cb<N><<<dim3(nt, sh.nc, sh.B * sh.G), WG, smem_cb, s>>>(Bm, Cm, cb, sh, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int smem_state = chunk_state_smem(N, false, c);
  if ((err = set_smem(ssd_tc_chunk_state<N>, smem_state)) != cudaSuccess) return err;
  ssd_tc_chunk_state<N><<<dim3(sh.P / TILE, sh.H, sh.B * sh.nc), WG, smem_state, s>>>(
      x, dt, Bm, cs, state, sh, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_tc_state_pass<<<dim3((sh.P * N + 255) / 256, sh.B * sh.H), 256, 0, s>>>(
      state, cs, init, s_in, final_state, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int smem_out = 3 * TILE * N * 2 + 3 * TILE * TILE * 2 + 2 * c * 4 + 1024;
  if ((err = set_smem(ssd_tc_chunk_out<N>, smem_out)) != cudaSuccess) return err;
  ssd_tc_chunk_out<N><<<dim3(nt * (sh.P / TILE), sh.H, sh.B * sh.nc), WG, smem_out, s>>>(
      x, dt, Cm, cs, cb, s_in, y, sh, st);
  return cudaGetLastError();
}

}  // namespace

// Scratch, in bytes, that a call needs (the wrapper allocates it and passes
// the four pieces in this order): cs (B, L, H) fp32, CB (B, nc, G, chunk,
// chunk) fp32, the chunk states (B, nc, H, P, N) fp32, S_in (2, B, nc, H, P,
// N) bf16 (hi, then lo).
extern "C" void veer_ssd_scan_tc_scratch(int Bsz, int L, int H, int P, int G, int N, int chunk,
                                         long long* bytes) {
  const long long nc = L / chunk;
  bytes[0] = 4LL * Bsz * L * H;
  bytes[1] = 4LL * Bsz * nc * G * chunk * chunk;
  bytes[2] = 4LL * Bsz * nc * H * P * N;
  bytes[3] = 4LL * Bsz * nc * H * P * N;
}

// Launches the five kernels on `stream` (PyTorch's current stream) and
// returns the first cudaError_t; the caller raises on anything but 0.  x, B,
// C and y are bf16 with 15 element strides as the fp32 instance takes them
// (x, dt, B, C, y; each (b, l, head)), every stride of x, B and C a multiple
// of 8 and their bases 16-byte aligned (cp.async copies 16 bytes); dt and A
// fp32; init_state (null: zeros) and final_state contiguous (B, H, P, N)
// fp32.  Shapes: chunk in {64, 128, 256}, L a multiple of it, P a multiple
// of 64, N in {64, 128}, H a multiple of G (the wrapper checks).
extern "C" int veer_ssd_scan_tc(const void* x, const float* dt, const float* A, const void* Bm,
                                const void* Cm, const float* init_state, void* y,
                                float* final_state, float* cs, float* cb, float* state,
                                void* s_in, int Bsz, int L, int H, int P, int G, int N, int chunk,
                                const long long* strides, void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || P <= 0) return 0;
  if ((chunk != 64 && chunk != 128 && chunk != 256) || L % chunk || P % TILE || G <= 0 || H % G ||
      (N != 64 && N != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{Bsz, L, H, P, G, N, chunk, L / chunk};
  if (sh.B * sh.nc > 65535 || H > 65535 || static_cast<long long>(sh.B) * sh.G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8], strides[9],
                   strides[10], strides[11], strides[12], strides[13], strides[14]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(Bm);
  const bf16* cbm = static_cast<const bf16*>(Cm);
  bf16* yb = static_cast<bf16*>(y);
  bf16* sin = static_cast<bf16*>(s_in);
  const cudaError_t err =
      N == 64 ? launch<64>(xb, dt, A, bb, cbm, init_state, yb, final_state, cs, cb, state, sin, sh, st, s)
              : launch<128>(xb, dt, A, bb, cbm, init_state, yb, final_state, cs, cb, state, sin, sh, st, s);
  return static_cast<int>(err);
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
