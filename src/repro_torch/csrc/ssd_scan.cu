// Mamba-2 SSD scan, forward (chunked state-space duality, arXiv:2405.21060):
// for each (batch b, head h), over the chunks of the sequence in order,
//
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      (intra-chunk)
//         + exp(cs_i) C_i . state                                 (inter-chunk)
//   state <- exp(cs_end) state + sum_j exp(cs_end - cs_j) dt_j x_j (x) B_j
//
// with cs the within-chunk cumulative sum of dt * A.  This is the fp32
// instance, on the CUDA cores: x, B, C, dt and A fp32, y and the final state
// fp32.  bf16 inputs, the serving path's, go to ssd_scan_sm90.cu (the
// chunk-parallel form on tensor cores).  The initial state is read when
// given, zero otherwise.
//
// Replaces src/repro/kernels/ssd_scan.py:89 ssd_pallas, whose grid
// (B, H, n_chunks) walks the chunks in order on one TPU core and carries the
// (P, N) state in VMEM scratch from one grid step to the next.  Blocks on
// Hopper run in no order, so here one block owns one (b, h, 64-column tile of
// P) and loops over the chunks itself, with the state (P-tile x N, fp32) in
// shared memory.  Row p of the state and column p of y depend on column p of
// x alone, so P splits across blocks without communication; C.B^T and the
// decays are shared by all of P and computed by each block for its head.
//
// What bounds it on this card: operations.  Per (b, h, chunk of c rows) the
// block does c^2 N / 2 FMAs for C.B^T (recomputed per head, as the TPU kernel
// does; the least work computes it once per group), c^2 P / 2 for the
// intra-chunk product, c N P for C.state and c P N for the state update.  At
// the main path's shape (c 256, N 128, P 64) that is ~12M FMAs per (b, h,
// chunk) against ~0.1 MB of input read, far above the card's ~20 FMAs per
// byte in fp32.  The products are fp32 FMAs on the CUDA cores (TF32 tensor
// cores keep ~3 digits and would not hold the reference's 1e-5), each thread
// computing a 4x4 (or 4x2, 4x8) register tile from 16-byte shared-memory
// reads laid out to avoid bank conflicts.  Decays use expf (not __expf) and
// the cumulative sum runs in order, as the reference's does.  The shared
// memory (~105 KB at the main path's shape) lets two blocks share an SM.
// The bf16 instance (ssd_scan_sm90.cu) takes the chunk-parallel form on
// tensor cores, C.B^T once per group.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int TI = 64;        // chunk rows per row tile (rows of y, C)
constexpr int TJ = 32;        // chunk rows per column tile (rows of B, x)
constexpr int PT = 64;        // columns of P per block
constexpr int XS = PT + 4;    // row stride of the x tile and the state
constexpr int MS = TJ + 4;    // row stride of the masked C.B^T tile

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Element strides of the inputs and outputs (the last axis of x, B, C and y
// is contiguous; the states are contiguous (B, H, P, N)).
struct Strides {
  long long xb, xl, xh;
  long long db, dl, dh;
  long long bb, bl, bg;
  long long cb, cl, cg;
  long long yb, yl, yh;
};

struct Shape {
  int L, H, P, G, N, NP, chunk;  // NP: N rounded up to a multiple of 4
};

// rows [r0, r0 + rows) of a (., N) matrix of one chunk into smem with row
// stride NS = NP + 4, zero past the chunk's end and past N.
template <typename T>
__device__ void load_rows_n(float* dst, const T* src, long long row_stride, int r0, int rows,
                            int limit, int N, int NP) {
  const int NS = NP + 4;
  for (int idx = threadIdx.x; idx < rows * NP; idx += THREADS) {
    const int r = idx / NP, n = idx % NP;
    float v = 0.f;
    if (r0 + r < limit && n < N) v = to_f(src[(long long)(r0 + r) * row_stride + n]);
    dst[r * NS + n] = v;
  }
}

// rows [r0, r0 + TJ) of x's p-tile into smem with row stride XS.
template <typename T>
__device__ void load_x(float* dst, const T* src, long long row_stride, int r0, int limit,
                       int pcols) {
  for (int idx = threadIdx.x; idx < TJ * PT; idx += THREADS) {
    const int r = idx / PT, p = idx % PT;
    float v = 0.f;
    if (r0 + r < limit && p < pcols) v = to_f(src[(long long)(r0 + r) * row_stride + p]);
    dst[r * XS + p] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ init_state, T* __restrict__ y,
                float* __restrict__ final_state, Shape sh, Strides st) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NP = sh.NP, NS = NP + 4, c = sh.chunk;
  const int c4 = (c + 3) & ~3;
  float* Cs = smem;                 // TI x NS  C rows of the row tile
  float* Bs = Cs + TI * NS;         // TJ x NS  B rows of the column tile
  float* xs = Bs + TJ * NS;         // TJ x XS  x rows of the column tile, this p-tile
  float* Ms = xs + TJ * XS;         // TI x MS  masked, decayed C.B^T of the pair
  float* S = Ms + TI * MS;          // NP x XS  state, transposed: S[n][p]
  float* cs = S + NP * XS;          // c  within-chunk cumulative sum of dt * A
  float* dts = cs + c4;             // c  dt
  float* ecs = dts + c4;            // c  exp(cs)
  float* wj = ecs + c4;             // c  exp(cs_end - cs_j) * dt_j

  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * PT;
  const int g = h / (sh.H / sh.G);
  const int pcols = min(PT, sh.P - p0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[h];

  const T* xbh = x + b * st.xb + h * st.xh + p0;
  const float* dbh = dt + b * st.db + h * st.dh;
  const T* bbg = Bm + b * st.bb + g * st.bg;
  const T* cbg = Cm + b * st.cb + g * st.cg;
  T* ybh = y + b * st.yb + h * st.yh + p0;
  const long long state_off = ((long long)b * sh.H + h) * sh.P * sh.N;

  for (int idx = tid; idx < NP * XS; idx += THREADS) {
    const int n = idx / XS, p = idx % XS;
    float v = 0.f;
    if (init_state != nullptr && n < sh.N && p < pcols)
      v = init_state[state_off + (long long)(p0 + p) * sh.N + n];
    S[idx] = v;
  }

  const int n_chunks = sh.L / c;
  for (int z = 0; z < n_chunks; ++z) {
    const long long l0 = (long long)z * c;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < c; i += THREADS) dts[i] = dbh[(l0 + i) * st.dl];
    __syncthreads();
    if (tid == 0) {  // in order, each product and sum rounded, as the reference's
      float run = 0.f;
      for (int i = 0; i < c; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], a));
        cs[i] = run;
      }
    }
    __syncthreads();
    const float cs_end = cs[c - 1];
    for (int i = tid; i < c; i += THREADS) {
      ecs[i] = expf(cs[i]);
      wj[i] = expf(cs_end - cs[i]) * dts[i];
    }

    // ---- y, one row tile of TI rows at a time ------------------------------
    for (int i0 = 0; i0 < c; i0 += TI) {
      __syncthreads();
      load_rows_n(Cs, cbg + l0 * st.cl, st.cl, i0, TI, c, sh.N, NP);
      __syncthreads();
      // acc[r][q]: row i0 + ty + 16 r, column 4 tx + q of the p-tile
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      // inter-chunk: C_i . state, then times exp(cs_i)
      for (int n = 0; n < NP; n += 4) {
        float4 cr[4], sr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = ld4(Cs + (ty + 16 * r) * NS + n);
#pragma unroll
        for (int k = 0; k < 4; ++k) sr[k] = ld4(S + (n + k) * XS + 4 * tx);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float cv = at(cr[r], k);
            acc[r][0] = fmaf(cv, sr[k].x, acc[r][0]);
            acc[r][1] = fmaf(cv, sr[k].y, acc[r][1]);
            acc[r][2] = fmaf(cv, sr[k].z, acc[r][2]);
            acc[r][3] = fmaf(cv, sr[k].w, acc[r][3]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < c ? ecs[i] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }

      // intra-chunk: column tiles up to the diagonal
      const int j_end = min(c, i0 + TI);
      for (int j0 = 0; j0 < j_end; j0 += TJ) {
        __syncthreads();  // Bs, xs and Ms are free
        load_rows_n(Bs, bbg + l0 * st.bl, st.bl, j0, TJ, c, sh.N, NP);
        load_x(xs, xbh + l0 * st.xl, st.xl, j0, c, pcols);
        __syncthreads();
        // s[r][e] = C_i . B_j for i = i0 + ty + 16 r, j = j0 + tx + 16 e
        float s[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
        for (int n = 0; n < NP; n += 4) {
          float4 cr[4], br[2];
#pragma unroll
          for (int r = 0; r < 4; ++r) cr[r] = ld4(Cs + (ty + 16 * r) * NS + n);
#pragma unroll
          for (int e = 0; e < 2; ++e) br[e] = ld4(Bs + (tx + 16 * e) * NS + n);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = s[r][e];
              v = fmaf(cr[r].x, br[e].x, v);
              v = fmaf(cr[r].y, br[e].y, v);
              v = fmaf(cr[r].z, br[e].z, v);
              v = fmaf(cr[r].w, br[e].w, v);
              s[r][e] = v;
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int il = ty + 16 * r, i = i0 + il;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = tx + 16 * e, j = j0 + jl;
            float m = 0.f;
            if (j <= i && i < c) m = s[r][e] * expf(cs[i] - cs[j]) * dts[j];
            Ms[il * MS + jl] = m;
          }
        }
        __syncthreads();
        for (int j = 0; j < TJ; j += 4) {
          float4 mr[4], xr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) mr[r] = ld4(Ms + (ty + 16 * r) * MS + j);
#pragma unroll
          for (int k = 0; k < 4; ++k) xr[k] = ld4(xs + (j + k) * XS + 4 * tx);
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float mv = at(mr[r], k);
              acc[r][0] = fmaf(mv, xr[k].x, acc[r][0]);
              acc[r][1] = fmaf(mv, xr[k].y, acc[r][1]);
              acc[r][2] = fmaf(mv, xr[k].z, acc[r][2]);
              acc[r][3] = fmaf(mv, xr[k].w, acc[r][3]);
            }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= c) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = 4 * tx + q;
          if (p < pcols) ybh[(l0 + i) * st.yl + p] = from_f<T>(acc[r][q]);
        }
      }
    }

    // ---- state update, after every y of the chunk has read the old state ----
    const float chunk_decay = expf(cs_end);
    for (int nb = 0; nb < NP; nb += 128) {
      // contrib[q][e]: state column p = 4 tx + q, row n = nb + 8 ty + e
      const bool live = nb + 8 * ty < NP;
      float contrib[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) contrib[q][e] = 0.f;
      for (int j0 = 0; j0 < c; j0 += TJ) {
        __syncthreads();
        load_rows_n(Bs, bbg + l0 * st.bl, st.bl, j0, TJ, c, sh.N, NP);
        load_x(xs, xbh + l0 * st.xl, st.xl, j0, c, pcols);
        __syncthreads();
        if (!live) continue;
        for (int j = 0; j < TJ && j0 + j < c; ++j) {
          const float w = wj[j0 + j];
          const float4 xr = ld4(xs + j * XS + 4 * tx);
          const float xw[4] = {xr.x * w, xr.y * w, xr.z * w, xr.w * w};
          const float4 b0 = ld4(Bs + j * NS + nb + 8 * ty);
          const float4 b1 = ld4(Bs + j * NS + nb + 8 * ty + 4);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 8; ++e) contrib[q][e] = fmaf(xw[q], bv[e], contrib[q][e]);
        }
      }
      __syncthreads();  // every thread is past its reads of S for this chunk
      if (live) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = nb + 8 * ty + e;
          if (n >= NP) break;
          float* row = S + n * XS + 4 * tx;
#pragma unroll
          for (int q = 0; q < 4; ++q) row[q] = fmaf(row[q], chunk_decay, contrib[q][e]);
        }
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < pcols * sh.N; idx += THREADS) {
    const int p = idx / sh.N, n = idx % sh.N;
    final_state[state_off + (long long)(p0 + p) * sh.N + n] = S[n * XS + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                   const float* init_state, void* y, float* final_state, int Bsz, const Shape& sh,
                   const Strides& st, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_scan_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(sh.H, Bsz, (sh.P + PT - 1) / PT);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init_state, static_cast<T*>(y), final_state, sh, st);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, that a launch at (N, chunk) needs; the
// wrapper refuses shapes above the card's 227 KB a block.
extern "C" long long veer_ssd_scan_smem_bytes(int N, int chunk) {
  const long long NP = (N + 3) / 4 * 4, NS = NP + 4, c4 = (chunk + 3) / 4 * 4;
  return 4LL * (TI * NS + TJ * NS + TJ * XS + TI * MS + NP * XS + 4 * c4);
}

// Launches on `stream` (PyTorch's current stream) and returns the launch's
// cudaError_t; the caller raises on anything but 0.  dtype must be 0: x, B,
// C and y fp32.  dt and A are fp32; init_state (may be null: zeros) and
// final_state are contiguous (B, H, P, N) fp32.  `strides` holds 15 element
// strides: x (b, l, h), dt (b, l, h), B (b, l, g), C (b, l, g), y (b, l, h);
// the last axis of x, B, C and y is contiguous.  L must be a multiple of
// chunk and H of G.
extern "C" int veer_ssd_scan(const void* x, const float* dt, const float* A, const void* Bm,
                             const void* Cm, const float* init_state, void* y, float* final_state,
                             int dtype, int Bsz, int L, int H, int P, int G, int N, int chunk,
                             const long long* strides, void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0) return 0;
  if (chunk <= 0 || L % chunk || G <= 0 || H % G) return static_cast<int>(cudaErrorInvalidValue);
  if (Bsz > 65535 || (P + PT - 1) / PT > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{L, H, P, G, N, (N + 3) / 4 * 4, chunk};
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8], strides[9],
                   strides[10], strides[11], strides[12], strides[13], strides[14]};
  const size_t smem = static_cast<size_t>(veer_ssd_scan_smem_bytes(N, chunk));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);  // bf16: ssd_scan_sm90.cu
  return static_cast<int>(
      launch<float>(x, dt, A, Bm, Cm, init_state, y, final_state, Bsz, sh, st, smem, s));
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
