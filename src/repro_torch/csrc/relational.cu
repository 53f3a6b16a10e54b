// Relational elementwise kernel for the torch data plane: FILTER masks and
// PROJECT values over float64 / int64 columns.
//
// Replaces src/repro/kernels/relational.py::_elementwise_pallas (the Pallas
// kernel the JAX plane's filter/project programs run through).  One
// plan-interpreting kernel serves every predicate and projection, so a
// single compile covers them all.  The plan (column pointers, coefficients,
// terms, and the and/or/not tree in postfix order) is one array of 64-bit
// words, laid out by kernels/relational.py::_pack; it has no fixed capacity.
//
// Exactness.  A term is  acc = const; acc = acc + v_j * col_j[i]  left to
// right, exactly the reference's ``np.full(n, const)`` then
// ``out = out + float(v) * col`` per coefficient.  Every multiply and add is
// rounded on its own (__dmul_rn / __dadd_rn, and the file is compiled with
// -fmad=false), because one fused multiply-add changes a sink's bytes and so
// its content digest.  int64 columns are converted with __ll2double_rn.  NaN
// results follow the host's rules: the first NaN operand, quieted, or the
// host's default NaN for an invalid operation, so NaN payloads match numpy's
// too.  The one exception is an add of two NaNs with different bits: IEEE
// 754 leaves the result's payload open, and numpy's own choice varies with
// the array's length and the row's place in it, so there the result is NaN
// but its bits may differ from numpy's.  The NaN rules cost a test per
// operation, so each step tests a thread's four rows at once and applies
// them only where one is NaN.  Comparisons use the reference's +-1e-12
// bands; every comparison with NaN is false, as in numpy.
//
// Bound.  No reuse across rows: the kernel is bound by device-memory bytes,
// 8 per column read, 1 per host mask read or mask written, 8 per output
// value.  At the main path's 1M rows the whole call is ~5 us of traffic, so
// fixed costs and latency decide its time.  The design:
//
//  * The plan travels in the launch's parameters (a __grid_constant__
//    struct of 1 KiB of plan words), so every thread reads the same plan
//    word at the same time from the constant bank: no upload, no staging,
//    no barrier for it.  A larger plan is read from device memory instead
//    (the wrapper uploads it); that is the same kernel fed by another route.
//  * A block per tile of rows.  The block queues every distinct column and
//    host mask of the program for its tile at once, as 16-byte
//    asynchronous copies into shared memory (cp.async; 8-byte ones for a
//    column at an odd element offset, plain loads for a mask's tail or a
//    mask at an odd offset), so each thread has several copies in flight
//    before any arithmetic, and the blocks resident on an SM overlap one
//    another's copies, arithmetic and stores.  The evaluating threads read
//    values by the plan's runtime column slot from shared memory (a
//    register array indexed at run time would spill).  The tile's row
//    count follows from the column count and the shared-memory budget;
//    columns (and masks) beyond what one block's shared memory can hold are
//    read from device memory where they are used, so no count is too
//    large.  Blocks of 128 threads and tiles of 512 rows measured fastest
//    on the H100 at 1M and 16M rows: a grid of one wave walking tiles
//    through a two-stage ring, larger blocks or tiles, and register caps
//    for more resident blocks were all slower (PERF.md, section 6).
//  * Each thread evaluates four rows of a tile and stores them wide: four
//    consecutive mask bytes as one 4-byte store, or two pairs of values as
//    two 16-byte stores (see Rows).
//
// The C launcher reads each device's shared-memory limit and opts every
// instance in to more than 48 KiB of dynamic shared memory once, at the
// device's first launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

// term codes: comparison bands of a mask atom, or a projected value
enum { CODE_LE = 0, CODE_LT = 1, CODE_EQ = 2, CODE_NE = 3, CODE_VALUE = 4 };
// postfix program opcodes (the bool stack is a 64-bit register per row)
enum { OP_ATOM = 0, OP_HOST = 1, OP_TRUE = 2, OP_FALSE = 3, OP_NOT = 4, OP_AND = 5, OP_OR = 6 };

// Plan header: word k of the plan holds field k.  The sections it points at
// hold one word per column pointer, per column's is-int64 flag, per
// host-mask pointer and per output pointer; two per product (column slot,
// coefficient bits), four per term (const bits, code, start, count) and two
// per program step (opcode, argument).
enum {
  H_N_TERMS, H_N_PROG, H_DEFAULT_NAN, H_COL, H_IS_INT, H_HOST, H_OUT, H_PROD, H_TERM, H_PROG,
  H_WORDS
};

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kMaxTileRows = kThreads * kRowsPerThread;  // one pass of the block's threads
constexpr int kRowGranule = 16;  // tile rows: a host mask's tile is whole 16-byte copies
constexpr int kTileBytesTarget = 64 * 1024;  // column bytes of a tile, when the columns allow

// The plan-word capacity of the parameter route (kernels/relational.py's
// PARAM_WORDS); with the 24-byte head it stays within the 4,096 bytes of
// kernel parameters that every toolkit allows.
constexpr int kParamWords = 128;

// Launch arguments: the plan words by value (ParamArgs) or by address
// (DeviceArgs), with the row count and the tile shape the launcher chose.
struct Head {
  long long n;
  int rows;    // rows of a tile, a multiple of kRowGranule
  int staged;  // columns 0..staged-1 go through shared memory; the rest are read in place
  int hosts;   // host masks 0..hosts-1 likewise
};
struct ParamArgs {
  Head h;
  long long w[kParamWords];
};
struct DeviceArgs {
  Head h;
  const long long* w;
};
static_assert(sizeof(Head) == 24 && sizeof(ParamArgs) <= 4096, "parameter plan too large");

__device__ __forceinline__ long long word(const ParamArgs& a, int k) { return a.w[k]; }
__device__ __forceinline__ long long word(const DeviceArgs& a, int k) { return __ldg(a.w + k); }

__device__ __forceinline__ double bits(long long w) { return __longlong_as_double(w); }
__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }

__device__ __forceinline__ double nan_result(double r, double a, double b, long long default_nan) {
  if (!isnan(r)) return r;
  const long long quiet = 0x0008000000000000LL;
  if (isnan(a)) return bits(__double_as_longlong(a) | quiet);
  if (isnan(b)) return bits(__double_as_longlong(b) | quiet);
  return bits(default_nan);
}

__device__ __forceinline__ unsigned long long compare(long long code, double v) {
  switch (code) {
    case CODE_LE: return v <= 1e-12;
    case CODE_LT: return v < -1e-12;
    case CODE_EQ: return fabs(v) <= 1e-12;
    default: return fabs(v) > 1e-12;
  }
}

// The plan's section offsets, decoded once per thread from the header.
struct Plan {
  int col, is_int, host, out, prod, term, prog, n_terms, n_prog;
  long long default_nan;
};

template <class A>
__device__ __forceinline__ Plan decode(const A& a) {
  Plan p;
  p.n_terms = static_cast<int>(word(a, H_N_TERMS));
  p.n_prog = static_cast<int>(word(a, H_N_PROG));
  p.default_nan = word(a, H_DEFAULT_NAN);
  p.col = static_cast<int>(word(a, H_COL));
  p.is_int = static_cast<int>(word(a, H_IS_INT));
  p.host = static_cast<int>(word(a, H_HOST));
  p.out = static_cast<int>(word(a, H_OUT));
  p.prod = static_cast<int>(word(a, H_PROD));
  p.term = static_cast<int>(word(a, H_TERM));
  p.prog = static_cast<int>(word(a, H_PROG));
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The host masks' part of a tile's shared memory, after the columns'.
template <class A>
__device__ __forceinline__ const uint8_t* host_stage(const A& a, const long long* stage) {
  return reinterpret_cast<const uint8_t*>(stage + static_cast<long long>(a.h.staged) * a.h.rows);
}

// Queue the copies of tile rows [r0, r0 + rows) of every staged column and
// host mask into shared memory: column c at stage[c * tile_rows], then
// host mask h at byte h * tile_rows of host_stage.
template <class A>
__device__ __forceinline__ void load_tile(const A& a, const Plan& p, long long* stage, long long r0,
                                          int rows) {
  const int tile_rows = a.h.rows;
  for (int c = 0; c < a.h.staged; ++c) {
    const long long* src = reinterpret_cast<const long long*>(word(a, p.col + c)) + r0;
    long long* dst = stage + static_cast<long long>(c) * tile_rows;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int k = threadIdx.x; 2 * k + 1 < rows; k += kThreads) cp_async16(dst + 2 * k, src + 2 * k);
      if ((rows & 1) && threadIdx.x == 0) cp_async8(dst + rows - 1, src + rows - 1);
    } else {  // a view at an odd element offset
      for (int k = threadIdx.x; k < rows; k += kThreads) cp_async8(dst + k, src + k);
    }
  }
  uint8_t* masks = reinterpret_cast<uint8_t*>(stage + static_cast<long long>(a.h.staged) * tile_rows);
  for (int h = 0; h < a.h.hosts; ++h) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(word(a, p.host + h)) + r0;
    uint8_t* dst = masks + h * tile_rows;
    const int body = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? rows & ~15 : 0;
    for (int k = threadIdx.x; 16 * k < body; k += kThreads) cp_async16(dst + 16 * k, src + 16 * k);
    for (int k = body + threadIdx.x; k < rows; k += kThreads) dst[k] = src[k];  // a tail, or a view
  }
}

// A thread's four rows of a tile are two pairs of neighbouring rows, at
// tile rows ra, ra + 1 and rb, rb + 1 (ra, rb even): consecutive for a mask
// program (rb = ra + 2, so its four mask bytes are one 4-byte store), and a
// warp's width apart for a value program (rb = ra + 2 * kThreads, so each of
// a warp's 16-byte value stores covers 512 contiguous bytes).
struct Rows {
  int ra, rb;        // tile rows of the two pairs
  long long ia, ib;  // their rows in the columns
  __device__ __forceinline__ long long row(int q) const { return (q < 2 ? ia : ib) + (q & 1); }
};

// The four values of column `slot` at the thread's rows, as float64.
template <class A>
__device__ __forceinline__ void column4(const A& a, const Plan& p, const long long* stage, int slot,
                                        const Rows& w, double (&x)[kRowsPerThread]) {
  long long raw[kRowsPerThread];
  if (slot < a.h.staged) {
    const long long* col = stage + static_cast<long long>(slot) * a.h.rows;
    const longlong2 lo = *reinterpret_cast<const longlong2*>(col + w.ra);
    const longlong2 hi = *reinterpret_cast<const longlong2*>(col + w.rb);
    raw[0] = lo.x, raw[1] = lo.y, raw[2] = hi.x, raw[3] = hi.y;
  } else {  // beyond shared memory: read in place
    const long long* col = reinterpret_cast<const long long*>(word(a, p.col + slot));
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) raw[q] = w.row(q) < a.h.n ? __ldg(col + w.row(q)) : 0;
  }
  const bool is_int = word(a, p.is_int + slot) != 0;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) x[q] = is_int ? __ll2double_rn(raw[q]) : bits(raw[q]);
}

template <class A>
__device__ __forceinline__ void eval_term(const A& a, const Plan& p, const long long* stage, int t,
                                          const Rows& w, double (&acc)[kRowsPerThread]) {
  const int term = p.term + 4 * t;
  const double c = bits(word(a, term));
  const int start = p.prod + 2 * static_cast<int>(word(a, term + 2));
  const int count = static_cast<int>(word(a, term + 3));
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = c;
  for (int j = 0; j < count; ++j) {
    const int slot = static_cast<int>(word(a, start + 2 * j));
    const double v = bits(word(a, start + 2 * j + 1));
    double x[kRowsPerThread];
    column4(a, p, stage, slot, w, x);
    // each step rounded on its own; the NaN rules only where a row is NaN,
    // tested once for the thread's four rows
    double m[kRowsPerThread], sum[kRowsPerThread];
    bool any = false;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      m[q] = __dmul_rn(v, x[q]);
      any |= isnan(m[q]);
    }
    if (any) {
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) m[q] = nan_result(m[q], v, x[q], p.default_nan);
    }
    any = false;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      sum[q] = __dadd_rn(acc[q], m[q]);
      any |= isnan(sum[q]);
    }
    if (any) {
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) sum[q] = nan_result(sum[q], acc[q], m[q], p.default_nan);
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) acc[q] = sum[q];
  }
}

// A pair of values at row i of `out`: one 16-byte store where it can.
__device__ __forceinline__ void store_pair(double* out, long long i, long long n, double v0, double v1) {
  if (i + 1 < n && (reinterpret_cast<uintptr_t>(out + i) & 15) == 0) {
    *reinterpret_cast<double2*>(out + i) = make_double2(v0, v1);
  } else {
    if (i < n) out[i] = v0;
    if (i + 1 < n) out[i + 1] = v1;
  }
}

// A value program at the thread's rows of the tile: every term, stored.
template <class A>
__device__ __forceinline__ void eval_values(const A& a, const Plan& p, const long long* stage,
                                            const Rows& w, bool second) {
  for (int t = 0; t < p.n_terms; ++t) {
    double v[kRowsPerThread];
    eval_term(a, p, stage, t, w, v);
    double* out = reinterpret_cast<double*>(word(a, p.out + t));
    store_pair(out, w.ia, a.h.n, v[0], v[1]);
    if (second) store_pair(out, w.ib, a.h.n, v[2], v[3]);
  }
}

// A mask program at the thread's four consecutive rows: the postfix tree
// on one bool stack per row, then one 4-byte store where it can.
template <class A>
__device__ __forceinline__ void eval_mask(const A& a, const Plan& p, const long long* stage, const Rows& w) {
  const long long n = a.h.n;
  const long long i = w.ia;
  const bool full = i + kRowsPerThread <= n;
  unsigned long long st[kRowsPerThread] = {};  // bit 0 is the top of each row's stack
  for (int k = 0; k < p.n_prog; ++k) {
    const long long op = word(a, p.prog + 2 * k);
    const int arg = static_cast<int>(word(a, p.prog + 2 * k + 1));
    switch (op) {
      case OP_ATOM: {
        double v[kRowsPerThread];
        eval_term(a, p, stage, arg, w, v);
        const long long code = word(a, p.term + 4 * arg + 1);
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) st[q] = (st[q] << 1) | compare(code, v[q]);
        break;
      }
      case OP_HOST: {
        const uint8_t* h = reinterpret_cast<const uint8_t*>(word(a, p.host + arg)) + i;
        uint32_t b = 0;
        if (arg < a.h.hosts) {
          b = *reinterpret_cast<const uint32_t*>(host_stage(a, stage) + arg * a.h.rows + w.ra);
        } else if (full && (reinterpret_cast<uintptr_t>(h) & 3) == 0) {
          b = __ldg(reinterpret_cast<const uint32_t*>(h));
        } else {
          for (int q = 0; q < kRowsPerThread && i + q < n; ++q) b |= static_cast<uint32_t>(h[q]) << (8 * q);
        }
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) st[q] = (st[q] << 1) | (((b >> (8 * q)) & 0xffu) != 0);
        break;
      }
      case OP_TRUE:
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) st[q] = (st[q] << 1) | 1ull;
        break;
      case OP_FALSE:
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) st[q] <<= 1;
        break;
      case OP_NOT:
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) st[q] ^= 1ull;
        break;
      case OP_AND:
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) {
          const unsigned long long top = st[q] & 1ull;
          st[q] = (st[q] >> 1) & (~1ull | top);
        }
        break;
      default:  // OP_OR
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) {
          const unsigned long long top = st[q] & 1ull;
          st[q] = (st[q] >> 1) | top;
        }
        break;
    }
  }
  uint8_t* out = reinterpret_cast<uint8_t*>(word(a, p.out)) + i;
  if (full && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
    uint32_t b = 0;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) b |= static_cast<uint32_t>(st[q] & 1ull) << (8 * q);
    *reinterpret_cast<uint32_t*>(out) = b;
  } else {
    for (int q = 0; q < kRowsPerThread && i + q < n; ++q) out[q] = static_cast<uint8_t>(st[q] & 1ull);
  }
}

// The thread's rows of the tile that starts at row r0 and holds `rows`.
template <class A>
__device__ __forceinline__ void eval_tile(const A& a, const Plan& p, const long long* stage, long long r0,
                                          int rows) {
  if (p.n_prog == 0) {
    const int ra = 2 * threadIdx.x, rb = ra + 2 * kThreads;
    if (ra >= rows) return;
    const bool second = rb < rows;  // else the second pair repeats the first and is not stored
    const Rows w{ra, second ? rb : ra, r0 + ra, r0 + (second ? rb : ra)};
    eval_values(a, p, stage, w, second);
  } else {
    const int ra = kRowsPerThread * threadIdx.x;
    if (ra < rows) eval_mask(a, p, stage, Rows{ra, ra + 2, r0 + ra, r0 + ra + 2});
  }
}

// Block b takes tile b: its staged columns' and masks' rows are queued as
// asynchronous copies at once, then evaluated from shared memory.
template <class A>
__global__ void __launch_bounds__(kThreads) relational_kernel(const __grid_constant__ A a) {
  extern __shared__ __align__(16) long long tile[];
  const Plan p = decode(a);
  const long long r0 = static_cast<long long>(blockIdx.x) * a.h.rows;
  const int rows = static_cast<int>(lmin(a.h.rows, a.h.n - r0));
  load_tile(a, p, tile, r0, rows);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  eval_tile(a, p, tile, r0, rows);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

namespace {
constexpr int kMaxDevices = 64;
int g_smem_optin[kMaxDevices];  // 0 until the device's first launch
std::mutex g_mutex;

// The device's largest dynamic shared memory for a block, read at its first
// launch, with every instance opted in to it.
cudaError_t smem_optin(int* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_smem_optin[device] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    const void* instances[] = {reinterpret_cast<const void*>(&relational_kernel<ParamArgs>),
                               reinterpret_cast<const void*>(&relational_kernel<DeviceArgs>)};
    for (const void* fn : instances)
      if (err == cudaSuccess) err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    g_smem_optin[device] = optin;
  }
  *out = g_smem_optin[device];
  return cudaSuccess;
}

// The tile shape and grid for n rows of n_cols columns and n_hosts host
// masks: as many of each in shared memory as half a block's share holds at
// the smallest tile, tiles of kMaxTileRows rows (fewer where
// kTileBytesTarget bytes cannot hold them), and a block per tile.
cudaError_t shape(long long n, int n_cols, int n_hosts, Head* h, unsigned* grid, size_t* smem) {
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const int cap = optin / 2 / kRowGranule;  // bytes a row may hold, of columns and of masks
  const int staged = n_cols < cap / 8 ? n_cols : cap / 8;
  const int hosts = n_hosts < cap ? n_hosts : cap;
  const int row_bytes = 8 * staged + hosts;
  int rows = kTileBytesTarget / row_bytes / kRowGranule * kRowGranule;
  rows = rows < kRowGranule ? kRowGranule : (rows < kMaxTileRows ? rows : kMaxTileRows);
  if (n < rows) rows = static_cast<int>((n + kRowGranule - 1) / kRowGranule * kRowGranule);
  const long long tiles = (n + rows - 1) / rows;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;  // past the grid's limit
  h->n = n;
  h->rows = rows;
  h->staged = staged;
  h->hosts = hosts;
  *grid = static_cast<unsigned>(tiles);
  *smem = static_cast<size_t>(row_bytes) * rows;
  return cudaSuccess;
}

}  // namespace

extern "C" int veer_relational_header_words() { return H_WORDS; }

// Launch on `stream` (PyTorch's current stream) on the calling thread's
// current device, which the caller has set, and return the launch's
// cudaError_t; the caller raises on anything but 0.  No synchronisation.
//
// veer_relational_launch_params: `words` is the packed plan in host memory,
// at most kParamWords of them, copied into the launch's parameters;
// veer_relational_launch_device: `plan` is the packed plan already in device
// memory.  The wrapper picks between them (kernels/relational.py::route).
extern "C" int veer_relational_launch_params(const long long* words, long long n_words, long long n,
                                             int n_cols, int n_hosts, void* stream) {
  if (n <= 0) return 0;
  if (n_words > kParamWords) return static_cast<int>(cudaErrorInvalidValue);
  ParamArgs a;
  unsigned grid = 0;
  size_t smem = 0;
  cudaError_t err = shape(n, n_cols, n_hosts, &a.h, &grid, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(a.w, words, static_cast<size_t>(n_words) * sizeof(long long));
  relational_kernel<ParamArgs><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int veer_relational_launch_device(const long long* plan, long long n, int n_cols, int n_hosts,
                                             void* stream) {
  if (n <= 0) return 0;
  DeviceArgs a;
  unsigned grid = 0;
  size_t smem = 0;
  cudaError_t err = shape(n, n_cols, n_hosts, &a.h, &grid, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.w = plan;
  relational_kernel<DeviceArgs><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
