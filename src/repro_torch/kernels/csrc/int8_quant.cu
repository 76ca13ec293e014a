// Per-row symmetric int8 quantization, hand-written for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (repro_torch/kernels/native.py).
//
//   quantize_int8  replaces repro/kernels/int8_quant.py::_quant_kernel
//
// For each row of x (rows, d), float32 or bfloat16:
//   amax  = max_j |x_j|                      (fp32)
//   scale = max(amax, 1e-8) * (1/127)        (fp32, written as (rows, 1))
//   q_j   = clamp(rint(x_j / scale), -127, 127)   (int8)
// The scale multiplies by the fp32 reciprocal of 127, as the reference's
// compiled kernel does (XLA turns its "/ 127" into that product).  rint
// rounds half to even, as jnp.round and torch.round do; the division is the
// IEEE one (no fast-math), so q and the scale are bit-equal to the plain
// PyTorch version on the same card.
//
// What bounds it on the card is bytes: each element is read once from
// device memory and 1 byte plus 4 bytes per row are written; the arithmetic
// is a handful of operations per element.  The TPU kernel stages a
// (block_rows, d) tile in VMEM; here a row is owned by one warp (short rows)
// or one block of 256 threads (rows of at least 256 16-byte vectors).  Pass 1
// reads the row with 16-byte loads and reduces |x| by warp shuffles (and
// shared memory across the block's warps); pass 2 reads the row again, which
// then comes from L1/L2, not device memory, and writes q with one store per
// 16-byte input vector.  Rows whose width or base address does not allow
// 16-byte vectors take a scalar path.
//
// The entry returns cudaGetLastError() after its launch; the Python wrapper
// raises on a non-zero code.  dtype codes: 0 = float32, 1 = bfloat16.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInv127 = 1.0f / 127.0f;

// N int8 values stored with one aligned store.
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

// This thread's share (elements t, t + nt, ... or vectors thereof) of a
// row's abs-max.
template <typename T, bool VEC>
__device__ __forceinline__ float row_amax(const T* __restrict__ xr, int d,
                                          int t, int nt) {
  float m = 0.0f;
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = t; i < d / N; i += nt) {
      float v[N];
      Vec<T>::unpack(xv[i], v);
#pragma unroll
      for (int j = 0; j < N; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  } else {
    for (int i = t; i < d; i += nt) m = fmaxf(m, fabsf(to_float(xr[i])));
  }
  return m;
}

template <typename T, bool VEC>
__device__ __forceinline__ void row_store(const T* __restrict__ xr,
                                          int8_t* __restrict__ qr, int d,
                                          int t, int nt, float s) {
  if (VEC) {
    constexpr int N = Vec<T>::N;
    using Q = typename QStore<N>::type;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    Q* qv = reinterpret_cast<Q*>(qr);
    for (int i = t; i < d / N; i += nt) {
      float v[N];
      Vec<T>::unpack(xv[i], v);
      union {
        Q word;
        int8_t b[N];
      } o;
#pragma unroll
      for (int j = 0; j < N; ++j) o.b[j] = quant1(v[j], s);
      qv[i] = o.word;
    }
  } else {
    for (int i = t; i < d; i += nt) qr[i] = quant1(to_float(xr[i]), s);
  }
}

// One warp per row, kWarps rows per block.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    quant_warp_rows(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scale, int rows, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + row * d;
  const float amax = warp_max(row_amax<T, VEC>(xr, d, lane, 32));
  const float s = fmaxf(amax, 1e-8f) * kInv127;
  row_store<T, VEC>(xr, q + row * d, d, lane, 32, s);
  if (lane == 0) scale[row] = s;
}

// One block of kThreads per row.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    quant_block_rows(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int rows, int d) {
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = blockIdx.x;
  const T* xr = x + row * d;
  float amax = warp_max(row_amax<T, VEC>(xr, d, threadIdx.x, kThreads));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(amax, 1e-8f) * kInv127;
  row_store<T, VEC>(xr, q + row * d, d, threadIdx.x, kThreads, s);
  if (threadIdx.x == 0) scale[row] = s;
}

template <typename T, bool VEC>
void launch(const void* x, void* q, void* scale, int rows, int d,
            int block_per_row, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scale);
  if (block_per_row) {
    quant_block_rows<T, VEC><<<rows, kThreads, 0, stream>>>(xt, qt, st, rows,
                                                           d);
  } else {
    const int blocks = (rows + kWarps - 1) / kWarps;
    quant_warp_rows<T, VEC><<<blocks, kThreads, 0, stream>>>(xt, qt, st, rows,
                                                            d);
  }
}

template <typename T>
void launch_t(const void* x, void* q, void* scale, int rows, int d, int vec,
              int block_per_row, cudaStream_t stream) {
  if (vec)
    launch<T, true>(x, q, scale, rows, d, block_per_row, stream);
  else
    launch<T, false>(x, q, scale, rows, d, block_per_row, stream);
}

}  // namespace

extern "C" {

// x (rows, d) contiguous -> q (rows, d) int8, scale (rows,) fp32.
// vec != 0 requires d % (16 / sizeof(T)) == 0 and 16-byte-aligned x and q.
int quantize_int8(int dtype, const void* x, void* q, void* scale, int rows,
                  int d, int vec, int block_per_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_t<float>(x, q, scale, rows, d, vec, block_per_row, s);
  else
    launch_t<__nv_bfloat16>(x, q, scale, rows, d, vec, block_per_row, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
