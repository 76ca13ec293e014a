// Per-row symmetric int8 quantization and the local steps of the int8
// all-reduce around it, hand-written for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/native.py).
//
//   quantize_int8              replaces repro/kernels/int8_quant.py::_quant_kernel
//   quantize_int8_shards       B7 on the tp shards of each row, written shard
//                              first: the layout all_to_all_single sends
//   dequant_sum_quantize_int8  dequantize the tp received shards, sum them in
//                              fp32 in rank order, quantize the sum with B7's rule
//   dequantize_int8_gathered   dequantize the gathered slices straight into
//                              the reduced tensor's layout and dtype
//
// The last three are the whole local part of core/quantized_collectives.py's
// reduce (repro/core/quantized_collectives.py::quantized_psum around the two
// collectives): three launches where the composition of B7 with PyTorch ops
// took eleven (B7 twice, three copies, six elementwise ops).
//
// B7's rule, for each row of width d:
//   amax  = max_j |x_j|                      (fp32)
//   scale = max(amax, 1e-8) * (1/127)        (fp32, written as (rows, 1))
//   q_j   = clamp(rint(x_j / scale), -127, 127)   (int8)
// The scale multiplies by the fp32 reciprocal of 127, as the reference's
// compiled kernel does (XLA turns its "/ 127" into that product).  rint
// rounds half to even, as jnp.round and torch.round do; the division is the
// IEEE one (no fast-math), and the dequantize products and the rank sums are
// spelled out as round-to-nearest operations (__fmul_rn, __fadd_rn), so q,
// the scales and the results are bit-equal to the plain PyTorch versions on
// the same card.
//
// What bounds them on the card is bytes, and at the serving path's shapes
// (a few rows of 2048) the cost of a launch: each element is read once from
// device memory and written once; the arithmetic is a handful of operations
// per element.  The TPU kernel stages a (block_rows, d) tile in VMEM; here a
// row is owned by one warp (short rows) or one block of 256 threads (rows of
// at least 256 vectors).  Pass 1 reads the row with 16-byte loads (8-byte
// ones of int8 for the rank sum) and reduces |x| by warp shuffles (and shared
// memory across the block's warps); pass 2 reads the row again, which then
// comes from L1/L2, not device memory, recomputes its values and writes q
// with one store per vector.  Rows whose width or base address does not
// allow vectors take a scalar path.
//
// Every entry returns cudaGetLastError() after its launch; the Python wrapper
// raises on a non-zero code.  dtype codes: 0 = float32, 1 = bfloat16.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInv127 = 1.0f / 127.0f;
// the gathered dequantize's grid: 16 blocks an SM of an H100, then it strides
constexpr long kMaxGatherBlocks = 132L * 16;

// N int8 values stored (and, for the rank sum, loaded) as one word.
template <int N>
struct QStore;
template <>
struct QStore<4> {
  using type = uint32_t;
};
template <>
struct QStore<8> {
  using type = uint2;
};

__device__ __forceinline__ int8_t quant1(float v, float s) {
  const float r = fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// What a quantize row reads: N values at a time (vector i) or one (element
// j), in fp32.
//   XRow<T>  a row of x, float32 or bfloat16
//   SumRow   sum_t q_t * s_t over the tp received shards, in rank order
template <typename T>
struct XRow {
  static constexpr int N = Vec<T>::N;
  const T* x;
  __device__ __forceinline__ void vec(int i, float* v) const {
    Vec<T>::unpack(reinterpret_cast<const uint4*>(x)[i], v);
  }
  __device__ __forceinline__ float one(int j) const { return to_float(x[j]); }
};

struct SumRow {
  static constexpr int N = 8;
  const int8_t* q;        // rank 0's row; rank t's is q_stride further
  const float* s;         // rank 0's scale; rank t's is s_stride further
  int tp;
  size_t q_stride, s_stride;
  __device__ __forceinline__ void vec(int i, float* v) const {
    for (int t = 0; t < tp; ++t) {
      union {
        uint2 word;
        int8_t b[N];
      } u;
      u.word = reinterpret_cast<const uint2*>(q + t * q_stride)[i];
      const float st = s[t * s_stride];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float x = __fmul_rn(static_cast<float>(u.b[j]), st);
        v[j] = t == 0 ? x : __fadd_rn(v[j], x);
      }
    }
  }
  __device__ __forceinline__ float one(int j) const {
    float v = 0.0f;
    for (int t = 0; t < tp; ++t) {
      const float x = __fmul_rn(static_cast<float>(q[t * q_stride + j]),
                                s[t * s_stride]);
      v = t == 0 ? x : __fadd_rn(v, x);
    }
    return v;
  }
};

// Row i of a kernel's rows: its source, and where its q and scale go.
//   XRows   rows of x (rows, d); row i = (source row i / tp, shard i % tp)
//           goes to row (i % tp) * (rows / tp) + i / tp: shard first (tp 1
//           keeps the order)
//   SumRows row r of the received shards (tp, R, d) and scales (tp, R, 1)
template <typename T>
struct XRows {
  using Row = XRow<T>;
  const T* x;
  int d, tp;
  long per_shard;
  __device__ __forceinline__ Row row(long i) const { return {x + i * d}; }
  __device__ __forceinline__ long out_row(long i) const {
    return (i % tp) * per_shard + i / tp;
  }
};

struct SumRows {
  using Row = SumRow;
  const int8_t* q;
  const float* s;
  int d, tp;
  long R;
  __device__ __forceinline__ Row row(long i) const {
    return {q + i * d, s + i, tp, (size_t)R * d, (size_t)R};
  }
  __device__ __forceinline__ long out_row(long i) const { return i; }
};

// This thread's share (elements t, t + nt, ... or vectors thereof) of a
// row's abs-max.
template <bool VEC, typename Row>
__device__ __forceinline__ float row_amax(const Row& src, int d, int t,
                                          int nt) {
  float m = 0.0f;
  if (VEC) {
    constexpr int N = Row::N;
    for (int i = t; i < d / N; i += nt) {
      float v[N];
      src.vec(i, v);
#pragma unroll
      for (int j = 0; j < N; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  } else {
    for (int i = t; i < d; i += nt) m = fmaxf(m, fabsf(src.one(i)));
  }
  return m;
}

template <bool VEC, typename Row>
__device__ __forceinline__ void row_store(const Row& src,
                                          int8_t* __restrict__ qr, int d,
                                          int t, int nt, float s) {
  if (VEC) {
    constexpr int N = Row::N;
    using Q = typename QStore<N>::type;
    Q* qv = reinterpret_cast<Q*>(qr);
    for (int i = t; i < d / N; i += nt) {
      float v[N];
      src.vec(i, v);
      union {
        Q word;
        int8_t b[N];
      } o;
#pragma unroll
      for (int j = 0; j < N; ++j) o.b[j] = quant1(v[j], s);
      qv[i] = o.word;
    }
  } else {
    for (int i = t; i < d; i += nt) qr[i] = quant1(src.one(i), s);
  }
}

// One warp per row, kWarps rows per block.
template <bool VEC, typename Rows>
__global__ void __launch_bounds__(kThreads)
    quant_warp_rows(Rows rows_of, int8_t* __restrict__ q,
                    float* __restrict__ scale, long rows, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // uniform across the warp
  const auto src = rows_of.row(row);
  const long o = rows_of.out_row(row);
  const float amax = warp_max(row_amax<VEC>(src, d, lane, 32));
  const float s = fmaxf(amax, 1e-8f) * kInv127;
  row_store<VEC>(src, q + o * d, d, lane, 32, s);
  if (lane == 0) scale[o] = s;
}

// One block of kThreads per row.
template <bool VEC, typename Rows>
__global__ void __launch_bounds__(kThreads)
    quant_block_rows(Rows rows_of, int8_t* __restrict__ q,
                     float* __restrict__ scale, long rows, int d) {
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = blockIdx.x;
  const auto src = rows_of.row(row);
  const long o = rows_of.out_row(row);
  float amax = warp_max(row_amax<VEC>(src, d, threadIdx.x, kThreads));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(amax, 1e-8f) * kInv127;
  row_store<VEC>(src, q + o * d, d, threadIdx.x, kThreads, s);
  if (threadIdx.x == 0) scale[o] = s;
}

template <typename Rows>
cudaError_t launch_rows(const Rows& rows_of, int8_t* q, float* scale,
                        long rows, int d, int vec, int block_per_row,
                        cudaStream_t stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  const long blocks = block_per_row ? rows : (rows + kWarps - 1) / kWarps;
  if (block_per_row && vec)
    quant_block_rows<true><<<blocks, kThreads, 0, stream>>>(rows_of, q, scale,
                                                           rows, d);
  else if (block_per_row)
    quant_block_rows<false><<<blocks, kThreads, 0, stream>>>(rows_of, q, scale,
                                                            rows, d);
  else if (vec)
    quant_warp_rows<true><<<blocks, kThreads, 0, stream>>>(rows_of, q, scale,
                                                          rows, d);
  else
    quant_warp_rows<false><<<blocks, kThreads, 0, stream>>>(rows_of, q, scale,
                                                           rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_x(const void* x, void* q, void* scale, long rows, int d,
                     int tp, int vec, int block_per_row, cudaStream_t stream) {
  if (tp < 1 || rows % tp) return cudaErrorInvalidValue;
  const XRows<T> rows_of{static_cast<const T*>(x), d, tp, rows / tp};
  return launch_rows(rows_of, static_cast<int8_t*>(q),
                     static_cast<float*>(scale), rows, d, vec, block_per_row,
                     stream);
}

// out (R, tp * d) of T from q (tp, R, d) int8 and s (tp, R) fp32:
// out[r, t * d + j] = T(q[t, r, j] * s[t, r]); VEC: 8 values a thread at a
// time (d % 8 == 0, q 8-byte and out 16-byte aligned).  Grid-stride.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    dequant_gathered(const int8_t* __restrict__ q, const float* __restrict__ s,
                     T* __restrict__ out, long R, int d, int tp) {
  const long rd = R * d;
  const long n = VEC ? tp * rd / 8 : tp * rd;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long)gridDim.x * kThreads) {
    const long e = VEC ? i * 8 : i;            // element of q (t, r, j)
    const long t = e / rd, r = (e - t * rd) / d;
    const long j = e - t * rd - r * d;
    const float st = s[t * R + r];
    T* o = out + r * tp * d + t * d + j;
    if (VEC) {
      union {
        uint2 word;
        int8_t b[8];
      } u;
      u.word = reinterpret_cast<const uint2*>(q)[i];
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = __fmul_rn(static_cast<float>(u.b[k]), st);
      constexpr int NV = Vec<T>::N;
#pragma unroll
      for (int k = 0; k < 8 / NV; ++k)
        reinterpret_cast<uint4*>(o)[k] = Vec<T>::pack(v + k * NV);
    } else {
      store(o, __fmul_rn(static_cast<float>(q[e]), st));
    }
  }
}

template <typename T>
cudaError_t launch_gathered(const void* q, const void* s, void* out, long R,
                            int d, int tp, int vec, cudaStream_t stream) {
  if (R < 1 || d < 1 || tp < 1) return cudaErrorInvalidValue;
  const long n = vec ? tp * R * d / 8 : tp * R * d;
  const long want = (n + kThreads - 1) / kThreads;
  const long blocks = want < kMaxGatherBlocks ? want : kMaxGatherBlocks;
  auto qt = static_cast<const int8_t*>(q);
  auto st = static_cast<const float*>(s);
  auto ot = static_cast<T*>(out);
  if (vec)
    dequant_gathered<T, true><<<blocks, kThreads, 0, stream>>>(qt, st, ot, R,
                                                              d, tp);
  else
    dequant_gathered<T, false><<<blocks, kThreads, 0, stream>>>(qt, st, ot, R,
                                                               d, tp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, d) contiguous -> q (rows, d) int8, scale (rows,) fp32.
// vec != 0 requires d % (16 / sizeof(T)) == 0 and 16-byte-aligned x and q.
int quantize_int8(int dtype, const void* x, void* q, void* scale, int rows,
                  int d, int vec, int block_per_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_x<float>(x, q, scale, rows, d, 1, vec, block_per_row, s);
  if (dtype == 1)
    return launch_x<__nv_bfloat16>(x, q, scale, rows, d, 1, vec,
                                   block_per_row, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (R, tp * d) contiguous, seen as R * tp rows of d -> q (tp, R, d) int8,
// scale (tp, R) fp32: shard t of row r is quantized as one row and written at
// (t, r).  vec as quantize_int8's.
int quantize_int8_shards(int dtype, const void* x, void* q, void* scale,
                         long long R, int d, int tp, int vec,
                         int block_per_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_x<float>(x, q, scale, R * tp, d, tp, vec, block_per_row, s);
  if (dtype == 1)
    return launch_x<__nv_bfloat16>(x, q, scale, R * tp, d, tp, vec,
                                   block_per_row, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q_recv (tp, R, d) int8, s_recv (tp, R) fp32 -> q2 (R, d) int8, s2 (R,)
// fp32: row r of sum_t q_t * s_t (fp32, rank order) quantized with B7's
// rule.  vec != 0 requires d % 8 == 0 and 8-byte-aligned q_recv and q2.
int dequant_sum_quantize_int8(const void* q_recv, const void* s_recv,
                              void* q2, void* s2, long long R, int d, int tp,
                              int vec, int block_per_row, void* stream) {
  if (tp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const SumRows rows_of{static_cast<const int8_t*>(q_recv),
                        static_cast<const float*>(s_recv), d, tp, (long)R};
  return launch_rows(rows_of, static_cast<int8_t*>(q2),
                     static_cast<float*>(s2), R, d, vec, block_per_row,
                     static_cast<cudaStream_t>(stream));
}

// q (tp, R, d) int8, s (tp, R) fp32 -> out (R, tp * d) of the dtype.
// vec != 0 requires d % 8 == 0, q 8-byte and out 16-byte aligned.
int dequantize_int8_gathered(int dtype, const void* q, const void* s,
                             void* out, long long R, int d, int tp, int vec,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gathered<float>(q, s, out, R, d, tp, vec, st);
  if (dtype == 1)
    return launch_gathered<__nv_bfloat16>(q, s, out, R, d, tp, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
