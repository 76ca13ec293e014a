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
// (a few rows of 2048) the cost of a launch: the arithmetic is a handful of
// operations per element.  The TPU kernel stages a (block_rows, d) tile in
// VMEM; here a row is read twice, once for its abs-max and once to write q
// (its values recomputed), and how the rows map onto blocks is a launch
// plan that the wrapper computes (repro_torch/kernels/native.py, row_plan):
//
//   warp   one warp a row, 8 rows a block: rows under 256 vectors (the
//          serving path's 2048-wide shards), or whose width or base address
//          forbids vector loads; the row stays in L1/L2 between the passes
//   block  one block of 256 threads a row: rows of at least 256 vectors
//          when there are enough rows to fill the card (a prefill grant's
//          512 rows of 2048)
//   split  each row cut into `segments` segments of whole vectors, one
//          block each (the last segment takes the ragged tail): rows of at
//          least 2 x 16,384 elements too few to give 4 x 132 blocks, as the
//          training path's gradient mean gives (dp rows of a whole
//          flattened leaf, up to 96.5 M elements a row).  One block a row
//          would leave 130 of 132 SMs idle and walk the row with 4 KB of
//          loads in flight, latency-bound at a few GB/s.  Pass A
//          (quant_split_amax): each block reduces |x| over its segment and
//          writes one fp32 partial to a (rows, segments) scratch buffer.
//          Pass B (quant_split_store), a second launch on the same grid:
//          each block takes the max of its row's partials (an abs-max
//          does not depend on order, so the scale is the one-block
//          kernel's and the plain version's bit for bit), recomputes its
//          segment's values and writes q; segment 0's block writes the
//          scale.  No atomics and no wait across blocks: every run gives
//          the same bits, and a CUDA graph can capture the two launches.
//          A row larger than the 50 MB L2 cannot stay there between the
//          passes, so this path reads each element twice from device
//          memory and writes q once: about 1.7x the bound of one read and
//          one write.
//
// A thread reads units: 16-byte vectors, 8-byte ones of int8 for the rank
// sum, or single values on the scalar path.  On a split row it issues
// kUnroll loads before it uses any, so that enough bytes are in flight to
// cover the latency of device memory; the warp and block kernels take one
// at a time.  Rows whose width or base address does not allow vectors take
// the scalar path, split the same way when they are long.  Each value is
// quantized with a multiply by the row's reciprocal scale (quant1 below),
// the IEEE division kept for the values near a rounding tie, and the rank
// sum reads its int8 without int-to-float conversions: both keep the bits
// and take the quarter-rate conversions off a long row's path.
//
// Every entry returns cudaGetLastError() after its launch; the Python wrapper
// raises on a non-zero code.  dtype codes: 0 = float32, 1 = bfloat16.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInv127 = 1.0f / 127.0f;
// loads a thread issues before it uses any on a split row (the warp and
// block kernels walk one unit at a time: unrolled, their registers would
// halve the blocks an SM holds, and a prefill grant's 1024 rows would take
// two waves)
constexpr int kUnroll = 4;
// the gathered dequantize's grid: 16 blocks an SM of an H100, then it strides
constexpr long kMaxGatherBlocks = 132L * 16;
// launch plan modes (native.ROW_MODES)
enum { kWarpRows = 0, kBlockRows = 1, kSplitRows = 2 };

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

// 1.5 * 2^23: adding it to |c| <= 127 rounds c to an integer, half to even,
// and leaves that integer, in two's complement, in the sum's low byte
// (0x4B400000 + c); subtracting it back gives the integer as a float.
constexpr float kMagic = 12582912.0f;

// clamp(rint(v / s), -127, 127) as int8, given inv = 1 / s (IEEE).  As
// |v| <= amax, |v / s| <= 128: the product p = v * inv lies within
// 128 * 2^-23 (1.6e-5) of v / s, and the IEEE quotient within 2^-18
// (3.9e-6) of it.  Unless p lies within 2^-12 of a half-integer, rint(p) is
// rint of the IEEE quotient, which is computed only there.  So a value
// costs a multiply, three adds and a clamp, where the IEEE division (a
// reciprocal and a range check with its own slow path), rintf and the
// float-to-int conversion took ~20 instructions, three of them on the SM's
// quarter-rate pipe; the bits are the same.
__device__ __forceinline__ int8_t quant1(float v, float s, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  const float t = __fadd_rn(c, kMagic);
  const float off = fabsf(__fsub_rn(c, __fsub_rn(t, kMagic)));
  if (off < 0.5f - 0x1p-12f) return static_cast<int8_t>(__float_as_int(t));
  const float r = fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// The 4 int8 of w as exact floats without the quarter-rate int-to-float
// conversion: byte b, sign flipped (b + 128), becomes the low byte of
// 0x4B400000, the float kMagic + b + 128.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* v) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B400000u, 0x7640 + j)),
                     kMagic + 128.0f);
}

// What a quantize row reads: N values at a time (vector i) or one (element
// j), in fp32.
//   XRow<T>  a row of x, float32 or bfloat16
//   SumRow   sum_t q_t * s_t over the tp received shards, in rank order
template <typename T>
struct XRow {
  static constexpr int N = Vec<T>::N;
  const T* x;
  __device__ __forceinline__ void vec(long i, float* v) const {
    Vec<T>::unpack(reinterpret_cast<const uint4*>(x)[i], v);
  }
  __device__ __forceinline__ float one(long j) const { return to_float(x[j]); }
};

struct SumRow {
  static constexpr int N = 8;
  const int8_t* q;        // rank 0's row; rank t's is q_stride further
  const float* s;         // rank 0's scale; rank t's is s_stride further
  int tp;
  size_t q_stride, s_stride;
  __device__ __forceinline__ void vec(long i, float* v) const {
    for (int t = 0; t < tp; ++t) {
      const uint2 w = reinterpret_cast<const uint2*>(q + t * q_stride)[i];
      const float st = s[t * s_stride];
      float qf[N];
      int8x4_to_float(w.x, qf);
      int8x4_to_float(w.y, qf + 4);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float x = __fmul_rn(qf[j], st);
        v[j] = t == 0 ? x : __fadd_rn(v[j], x);
      }
    }
  }
  __device__ __forceinline__ float one(long j) const {
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

// Values of a row's unit i: a vector of Row::N (VEC) or one element.
template <bool VEC, typename Row>
__device__ __forceinline__ void load_unit(const Row& src, long i, float* v) {
  if constexpr (VEC)
    src.vec(i, v);
  else
    v[0] = src.one(i);
}

// q of unit i from its N values: one store of N int8.
template <int N>
__device__ __forceinline__ void store_unit(int8_t* __restrict__ qr, long i,
                                           const float* v, float s,
                                           float inv) {
  if constexpr (N == 1) {
    qr[i] = quant1(v[0], s, inv);
  } else {
    using Q = typename QStore<N>::type;
    union {
      Q word;
      int8_t b[N];
    } o;
#pragma unroll
    for (int j = 0; j < N; ++j) o.b[j] = quant1(v[j], s, inv);
    reinterpret_cast<Q*>(qr)[i] = o.word;
  }
}

// This thread's share (units lo + t, lo + t + nt, ... below hi) of the
// abs-max of a row's units [lo, hi); U loads in flight.
template <bool VEC, int U, typename Row>
__device__ __forceinline__ float span_amax(const Row& src, long lo, long hi,
                                           int t, int nt) {
  constexpr int N = VEC ? Row::N : 1;
  float m = 0.0f;
  long i = lo + t;
  for (; U > 1 && i + (U - 1) * (long)nt < hi; i += U * (long)nt) {
    float v[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) load_unit<VEC>(src, i + u * nt, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < N; ++j) m = fmaxf(m, fabsf(v[u][j]));
  }
  for (; i < hi; i += nt) {
    float v[N];
    load_unit<VEC>(src, i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) m = fmaxf(m, fabsf(v[j]));
  }
  return m;
}

// This thread's share of q over a row's units [lo, hi) at scale s: the
// values recomputed, U loads issued before their stores.
template <bool VEC, int U, typename Row>
__device__ __forceinline__ void span_store(const Row& src,
                                           int8_t* __restrict__ qr, long lo,
                                           long hi, int t, int nt, float s) {
  constexpr int N = VEC ? Row::N : 1;
  const float inv = 1.0f / s;
  long i = lo + t;
  for (; U > 1 && i + (U - 1) * (long)nt < hi; i += U * (long)nt) {
    float v[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) load_unit<VEC>(src, i + u * nt, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) store_unit<N>(qr, i + u * nt, v[u], s, inv);
  }
  for (; i < hi; i += nt) {
    float v[N];
    load_unit<VEC>(src, i, v);
    store_unit<N>(qr, i, v, s, inv);
  }
}

// The max of v over the block's threads, to every thread (once a kernel).
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[kWarps];
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w]);
  return v;
}

template <bool VEC, typename Rows>
__device__ __forceinline__ long row_units(int d) {
  return VEC ? d / Rows::Row::N : d;
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
  const long units = row_units<VEC, Rows>(d);
  const float amax = warp_max(span_amax<VEC, 1>(src, 0, units, lane, 32));
  const float s = fmaxf(amax, 1e-8f) * kInv127;
  span_store<VEC, 1>(src, q + o * d, 0, units, lane, 32, s);
  if (lane == 0) scale[o] = s;
}

// One block of kThreads per row.
template <bool VEC, typename Rows>
__global__ void __launch_bounds__(kThreads)
    quant_block_rows(Rows rows_of, int8_t* __restrict__ q,
                     float* __restrict__ scale, long rows, int d) {
  const long row = blockIdx.x;
  const auto src = rows_of.row(row);
  const long o = rows_of.out_row(row);
  const long units = row_units<VEC, Rows>(d);
  const float amax =
      block_max(span_amax<VEC, 1>(src, 0, units, threadIdx.x, kThreads));
  const float s = fmaxf(amax, 1e-8f) * kInv127;
  span_store<VEC, 1>(src, q + o * d, 0, units, threadIdx.x, kThreads, s);
  if (threadIdx.x == 0) scale[o] = s;
}

// Block b of a split launch: row b / segments, units [lo, hi) of its
// segment b % segments (seg_units each, the last one ragged).
struct Segment {
  long row, lo, hi;
  int seg;
};

template <bool VEC, typename Rows>
__device__ __forceinline__ Segment segment_of(int d, int segments,
                                              int seg_units) {
  Segment g;
  g.row = blockIdx.x / segments;
  g.seg = blockIdx.x % segments;
  g.lo = (long)g.seg * seg_units;
  const long units = row_units<VEC, Rows>(d);
  g.hi = g.lo + seg_units < units ? g.lo + seg_units : units;
  return g;
}

// Split pass A: partial[b] = max |x| over block b's segment.
template <bool VEC, typename Rows>
__global__ void __launch_bounds__(kThreads)
    quant_split_amax(Rows rows_of, float* __restrict__ partial, int d,
                     int segments, int seg_units) {
  const Segment g = segment_of<VEC, Rows>(d, segments, seg_units);
  const float m = block_max(span_amax<VEC, kUnroll>(
      rows_of.row(g.row), g.lo, g.hi, threadIdx.x, kThreads));
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// Split pass B: the row's scale from its segments' partials, then q over
// block b's segment; segment 0's block writes the scale.
template <bool VEC, typename Rows>
__global__ void __launch_bounds__(kThreads)
    quant_split_store(Rows rows_of, const float* __restrict__ partial,
                      int8_t* __restrict__ q, float* __restrict__ scale,
                      int d, int segments, int seg_units) {
  const Segment g = segment_of<VEC, Rows>(d, segments, seg_units);
  const float* mine = partial + g.row * segments;
  float m = 0.0f;
  for (int k = threadIdx.x; k < segments; k += kThreads)
    m = fmaxf(m, mine[k]);
  const float s = fmaxf(block_max(m), 1e-8f) * kInv127;
  const long o = rows_of.out_row(g.row);
  span_store<VEC, kUnroll>(rows_of.row(g.row), q + o * d, g.lo, g.hi,
                           threadIdx.x, kThreads, s);
  if (g.seg == 0 && threadIdx.x == 0) scale[o] = s;
}

template <bool VEC, typename Rows>
cudaError_t launch_mode(const Rows& rows_of, int8_t* q, float* scale,
                        float* partial, long rows, int d, int mode,
                        int segments, int seg_units, cudaStream_t stream) {
  if (mode == kSplitRows) {
    const long blocks = rows * segments;
    quant_split_amax<VEC><<<blocks, kThreads, 0, stream>>>(
        rows_of, partial, d, segments, seg_units);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    quant_split_store<VEC><<<blocks, kThreads, 0, stream>>>(
        rows_of, partial, q, scale, d, segments, seg_units);
  } else if (mode == kBlockRows) {
    quant_block_rows<VEC><<<rows, kThreads, 0, stream>>>(rows_of, q, scale,
                                                         rows, d);
  } else {
    quant_warp_rows<VEC><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                           stream>>>(rows_of, q, scale, rows, d);
  }
  return cudaGetLastError();
}

// Launch the quantize of `rows` rows of d under a plan (native.row_plan):
// vec, mode, and for the split mode `segments` segments of seg_len elements
// (whole vectors; the last ragged, none empty) with partial a (rows,
// segments) fp32 scratch.
template <typename Rows>
cudaError_t launch_rows(const Rows& rows_of, int8_t* q, float* scale,
                        float* partial, long rows, int d, int vec, int mode,
                        int segments, int seg_len, cudaStream_t stream) {
  if (rows < 1 || d < 1 || mode < kWarpRows || mode > kSplitRows)
    return cudaErrorInvalidValue;
  const int n = vec ? Rows::Row::N : 1;
  if (mode == kSplitRows &&
      (partial == nullptr || segments < 1 || seg_len < 1 || seg_len % n ||
       (long)(segments - 1) * seg_len >= d || (long)segments * seg_len < d))
    return cudaErrorInvalidValue;
  if (vec)
    return launch_mode<true>(rows_of, q, scale, partial, rows, d, mode,
                             segments, seg_len / n, stream);
  return launch_mode<false>(rows_of, q, scale, partial, rows, d, mode,
                            segments, seg_len, stream);
}

template <typename T>
cudaError_t launch_x(const void* x, void* q, void* scale, void* partial,
                     long rows, int d, int tp, int vec, int mode,
                     int segments, int seg_len, cudaStream_t stream) {
  if (tp < 1 || rows % tp) return cudaErrorInvalidValue;
  const XRows<T> rows_of{static_cast<const T*>(x), d, tp, rows / tp};
  return launch_rows(rows_of, static_cast<int8_t*>(q),
                     static_cast<float*>(scale),
                     static_cast<float*>(partial), rows, d, vec, mode,
                     segments, seg_len, stream);
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

// Each quantize entry takes a launch plan (native.row_plan): vec, mode (0 a
// warp a row, 1 a block a row, 2 split), segments and seg_len (elements a
// segment; a multiple of the vector under vec) for mode 2, and partial, a
// (rows, segments) fp32 scratch for mode 2 (unused otherwise).

// x (rows, d) contiguous -> q (rows, d) int8, scale (rows,) fp32.
// vec != 0 requires d % (16 / sizeof(T)) == 0 and 16-byte-aligned x and q.
int quantize_int8(int dtype, const void* x, void* q, void* scale,
                  void* partial, int rows, int d, int vec, int mode,
                  int segments, int seg_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_x<float>(x, q, scale, partial, rows, d, 1, vec, mode,
                           segments, seg_len, s);
  if (dtype == 1)
    return launch_x<__nv_bfloat16>(x, q, scale, partial, rows, d, 1, vec,
                                   mode, segments, seg_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (R, tp * d) contiguous, seen as R * tp rows of d -> q (tp, R, d) int8,
// scale (tp, R) fp32: shard t of row r is quantized as one row and written at
// (t, r).  vec as quantize_int8's.
int quantize_int8_shards(int dtype, const void* x, void* q, void* scale,
                         void* partial, long long R, int d, int tp, int vec,
                         int mode, int segments, int seg_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_x<float>(x, q, scale, partial, R * tp, d, tp, vec, mode,
                           segments, seg_len, s);
  if (dtype == 1)
    return launch_x<__nv_bfloat16>(x, q, scale, partial, R * tp, d, tp, vec,
                                   mode, segments, seg_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q_recv (tp, R, d) int8, s_recv (tp, R) fp32 -> q2 (R, d) int8, s2 (R,)
// fp32: row r of sum_t q_t * s_t (fp32, rank order) quantized with B7's
// rule.  vec != 0 requires d % 8 == 0 and 8-byte-aligned q_recv and q2.
int dequant_sum_quantize_int8(const void* q_recv, const void* s_recv,
                              void* q2, void* s2, void* partial, long long R,
                              int d, int tp, int vec, int mode, int segments,
                              int seg_len, void* stream) {
  if (tp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const SumRows rows_of{static_cast<const int8_t*>(q_recv),
                        static_cast<const float*>(s_recv), d, tp, (long)R};
  return launch_rows(rows_of, static_cast<int8_t*>(q2),
                     static_cast<float*>(s2), static_cast<float*>(partial), R,
                     d, vec, mode, segments, seg_len,
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
