// Relational elementwise kernel for the torch data plane: FILTER masks and
// PROJECT values over float64 / int64 columns.
//
// Replaces src/repro/kernels/relational.py::_elementwise_pallas (the Pallas
// kernel the JAX plane's filter/project programs run through).  One
// plan-interpreting kernel serves every predicate and projection, so a
// single compile covers them all.  The plan (column pointers, coefficients,
// terms, and the and/or/not tree in postfix order) is one int64 array in
// device memory, laid out by kernels/relational.py::_pack; it has no fixed
// capacity.  Each block stages it in shared memory when it fits in 48 KiB
// (the kernel's <true> instance), and reads it from device memory
// otherwise (<false>).
//
// Exactness.  A term is  acc = const; acc = acc + v_j * col_j[i]  left to
// right, exactly the reference's ``np.full(n, const)`` then
// ``out = out + float(v) * col`` per coefficient.  Every multiply and add is
// rounded on its own (__dmul_rn / __dadd_rn, and the file is compiled with
// -fmad=false), because one fused multiply-add changes a sink's bytes and so
// its content digest.  NaN results follow the host's rules: the first NaN
// operand, quieted, or the host's default NaN for an invalid operation, so
// NaN payloads match numpy's too.  The one exception is an add of two NaNs
// with different bits: IEEE 754 leaves the result's payload open, and
// numpy's own choice varies with the array's length and the row's place in
// it, so there the result is NaN but its bits may differ from numpy's.
// Comparisons use the reference's +-1e-12 bands; every comparison with NaN
// is false, as in numpy.
//
// Bound.  No reuse across rows: the kernel is bound by device-memory bytes,
// 8 per column read, 1 per host mask read or mask written, 8 per output
// value.  Each thread takes rows in a grid-stride loop; neighbouring threads
// read neighbouring 8-byte words, so loads are coalesced.  No 8x128 tiling
// and no padding: n is a runtime argument.

#include <cuda_runtime.h>
#include <stdint.h>

// term codes: comparison bands of a mask atom, or a projected value
enum { CODE_LE = 0, CODE_LT = 1, CODE_EQ = 2, CODE_NE = 3, CODE_VALUE = 4 };
// postfix program opcodes (the bool stack is a 64-bit register)
enum { OP_ATOM = 0, OP_HOST = 1, OP_TRUE = 2, OP_FALSE = 3, OP_NOT = 4, OP_AND = 5, OP_OR = 6 };

// Plan header: word k of the plan array holds field k.  The sections it
// points at hold one word per column pointer, per column's is-int64 flag,
// per host-mask pointer and per output pointer; two per product (column
// slot, coefficient bits), four per term (const bits, code, start, count)
// and two per program step (opcode, argument).
enum {
  H_N_TERMS, H_N_PROG, H_DEFAULT_NAN, H_COL, H_IS_INT, H_HOST, H_OUT, H_PROD, H_TERM, H_PROG,
  H_WORDS
};

__device__ __forceinline__ double bits(long long w) { return __longlong_as_double(w); }

__device__ __forceinline__ double nan_result(double r, double a, double b, long long default_nan) {
  if (!isnan(r)) return r;
  const long long quiet = 0x0008000000000000LL;
  if (isnan(a)) return bits(__double_as_longlong(a) | quiet);
  if (isnan(b)) return bits(__double_as_longlong(b) | quiet);
  return bits(default_nan);
}

// The plan's sections, decoded once per thread from the header.
struct Plan {
  const long long *cols, *is_int, *hosts, *outs, *prods, *terms, *prog;
  int n_terms, n_prog;
  long long default_nan;
};

__device__ __forceinline__ Plan decode(const long long* P) {
  Plan p;
  p.cols = P + P[H_COL];
  p.is_int = P + P[H_IS_INT];
  p.hosts = P + P[H_HOST];
  p.outs = P + P[H_OUT];
  p.prods = P + P[H_PROD];
  p.terms = P + P[H_TERM];
  p.prog = P + P[H_PROG];
  p.n_terms = static_cast<int>(P[H_N_TERMS]);
  p.n_prog = static_cast<int>(P[H_N_PROG]);
  p.default_nan = P[H_DEFAULT_NAN];
  return p;
}

__device__ __forceinline__ double load_col(const Plan& p, long long c, long long i) {
  const void* col = reinterpret_cast<const void*>(p.cols[c]);
  if (p.is_int[c]) return __ll2double_rn(static_cast<const long long*>(col)[i]);
  return static_cast<const double*>(col)[i];
}

__device__ __forceinline__ double eval_term(const Plan& p, int t, long long i) {
  const long long* term = p.terms + 4 * t;
  double acc = bits(term[0]);
  const long long* prod = p.prods + 2 * term[2];
  const int count = static_cast<int>(term[3]);
  for (int j = 0; j < count; ++j, prod += 2) {
    const double v = bits(prod[1]);
    const double x = load_col(p, prod[0], i);
    const double m = nan_result(__dmul_rn(v, x), v, x, p.default_nan);
    acc = nan_result(__dadd_rn(acc, m), acc, m, p.default_nan);
  }
  return acc;
}

__device__ __forceinline__ unsigned long long compare(long long code, double v) {
  switch (code) {
    case CODE_LE: return v <= 1e-12;
    case CODE_LT: return v < -1e-12;
    case CODE_EQ: return fabs(v) <= 1e-12;
    default: return fabs(v) > 1e-12;
  }
}

// kStaged: the plan is copied to shared memory first, and read from there
// with shared-memory loads (the choice is made at compile time so that the
// compiler knows which memory every plan read goes to).
template <bool kStaged>
__global__ void relational_kernel(const long long* __restrict__ plan, int plan_words,
                                  long long n) {
  extern __shared__ long long staged[];
  if (kStaged) {
    for (int k = threadIdx.x; k < plan_words; k += blockDim.x) staged[k] = plan[k];
    __syncthreads();
  }
  const Plan p = decode(kStaged ? staged : plan);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (p.n_prog == 0) {
      for (int t = 0; t < p.n_terms; ++t) {
        reinterpret_cast<double*>(p.outs[t])[i] = eval_term(p, t, i);
      }
      continue;
    }
    unsigned long long st = 0;  // bit 0 is the top of the stack
    for (int k = 0; k < p.n_prog; ++k) {
      const int arg = static_cast<int>(p.prog[2 * k + 1]);
      switch (p.prog[2 * k]) {
        case OP_ATOM:
          st = (st << 1) | compare(p.terms[4 * arg + 1], eval_term(p, arg, i));
          break;
        case OP_HOST:
          st = (st << 1) | (reinterpret_cast<const uint8_t*>(p.hosts[arg])[i] != 0);
          break;
        case OP_TRUE:
          st = (st << 1) | 1ull;
          break;
        case OP_FALSE:
          st <<= 1;
          break;
        case OP_NOT:
          st ^= 1ull;
          break;
        case OP_AND: {
          const unsigned long long top = st & 1ull;
          st >>= 1;
          st &= ~1ull | top;
          break;
        }
        default: {  // OP_OR
          const unsigned long long top = st & 1ull;
          st >>= 1;
          st |= top;
          break;
        }
      }
    }
    reinterpret_cast<uint8_t*>(p.outs[0])[i] = static_cast<uint8_t>(st & 1ull);
  }
}

extern "C" int veer_relational_header_words() { return H_WORDS; }

// Launches on `stream` (PyTorch's current stream) on the calling thread's
// current device, which the caller has set, and returns the launch's
// cudaError_t; the caller raises on anything but 0.  `plan` is the packed
// plan, `plan_words` long, already in device memory.  No synchronisation.
extern "C" int veer_relational_launch(const long long* plan, long long plan_words, long long n,
                                      void* stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = static_cast<long long>(sms) * 32;  // grid-stride beyond this
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t plan_bytes = static_cast<size_t>(plan_words) * sizeof(long long);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan_bytes <= 48 * 1024) {
    relational_kernel<true><<<static_cast<unsigned>(blocks), threads, plan_bytes, s>>>(
        plan, static_cast<int>(plan_words), n);
  } else {
    relational_kernel<false><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        plan, static_cast<int>(plan_words), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* veer_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
