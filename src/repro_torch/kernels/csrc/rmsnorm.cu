// Fused RMSNorm, hand-written for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (repro_torch/kernels/native.py).
//
//   rms_norm  replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel
//
// For each row of x (rows, d), float32 or bfloat16, and gamma (d,), float32
// or bfloat16:
//   var   = sum_j x_j^2 / d                     (fp32)
//   out_j = (x_j * rsqrt(var + eps)) * gamma_j  (fp32, written as x's type)
//
// What bounds it on the card is bytes: each element is read once and
// written once, with a few operations per element.  The TPU kernel stages a
// (block_rows, d) tile in VMEM; here a row is owned by one warp (short rows)
// or one block of 256 threads (rows of at least 256 16-byte vectors), as in
// int8_quant.cu.  Pass 1 reads the row with 16-byte loads and reduces the
// sum of squares by warp shuffles (and shared memory across the block's
// warps); pass 2 reads the row again, which then comes from L1/L2, not
// device memory, scales it and writes it with 16-byte stores.  gamma is read
// element by element (it is d values, shared by every row, and stays in
// cache).  Rows whose width or base address does not allow 16-byte vectors
// take a scalar path.  rsqrtf is the card's reciprocal square root (2 ulp),
// so the result agrees with the plain PyTorch version within fp32 rounding,
// not bit for bit.
//
// The entry returns cudaGetLastError() after its launch; the Python wrapper
// raises on a non-zero code.  dtype codes: 0 = float32, 1 = bfloat16.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// This thread's share (elements t, t + nt, ... or vectors thereof) of a
// row's sum of squares.
template <typename T, bool VEC>
__device__ __forceinline__ float row_sumsq(const T* __restrict__ xr, int d,
                                           int t, int nt) {
  float s = 0.0f;
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = t; i < d / N; i += nt) {
      float v[N];
      Vec<T>::unpack(xv[i], v);
#pragma unroll
      for (int j = 0; j < N; ++j) s = fmaf(v[j], v[j], s);
    }
  } else {
    for (int i = t; i < d; i += nt) {
      const float v = to_float(xr[i]);
      s = fmaf(v, v, s);
    }
  }
  return s;
}

template <typename T, typename G, bool VEC>
__device__ __forceinline__ void row_store(const T* __restrict__ xr,
                                          const G* __restrict__ gamma,
                                          T* __restrict__ outr, int d, int t,
                                          int nt, float r) {
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(outr);
    for (int i = t; i < d / N; i += nt) {
      float v[N];
      Vec<T>::unpack(xv[i], v);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = v[j] * r * to_float(gamma[i * N + j]);
      ov[i] = Vec<T>::pack(v);
    }
  } else {
    for (int i = t; i < d; i += nt)
      store(outr + i, to_float(xr[i]) * r * to_float(gamma[i]));
  }
}

// One warp per row, kWarps rows per block.
template <typename T, typename G, bool VEC>
__global__ void __launch_bounds__(kThreads)
    rms_warp_rows(const T* __restrict__ x, const G* __restrict__ gamma,
                  T* __restrict__ out, int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + row * d;
  const float ss = warp_sum(row_sumsq<T, VEC>(xr, d, lane, 32));
  const float r = rsqrtf(ss / (float)d + eps);
  row_store<T, G, VEC>(xr, gamma, out + row * d, d, lane, 32, r);
}

// One block of kThreads per row.
template <typename T, typename G, bool VEC>
__global__ void __launch_bounds__(kThreads)
    rms_block_rows(const T* __restrict__ x, const G* __restrict__ gamma,
                   T* __restrict__ out, int rows, int d, float eps) {
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = blockIdx.x;
  const T* xr = x + row * d;
  const float part = warp_sum(row_sumsq<T, VEC>(xr, d, threadIdx.x, kThreads));
  if (lane == 0) red[warp] = part;
  __syncthreads();
  float ss = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) ss += red[w];
  const float r = rsqrtf(ss / (float)d + eps);
  row_store<T, G, VEC>(xr, gamma, out + row * d, d, threadIdx.x, kThreads, r);
}

template <typename T, typename G, bool VEC>
void launch(const void* x, const void* gamma, void* out, int rows, int d,
            float eps, int block_per_row, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const G* gt = static_cast<const G*>(gamma);
  T* ot = static_cast<T*>(out);
  if (block_per_row) {
    rms_block_rows<T, G, VEC><<<rows, kThreads, 0, stream>>>(xt, gt, ot, rows,
                                                             d, eps);
  } else {
    const int blocks = (rows + kWarps - 1) / kWarps;
    rms_warp_rows<T, G, VEC><<<blocks, kThreads, 0, stream>>>(xt, gt, ot, rows,
                                                              d, eps);
  }
}

template <typename T, typename G>
void launch_v(const void* x, const void* gamma, void* out, int rows, int d,
              float eps, int vec, int block_per_row, cudaStream_t stream) {
  if (vec)
    launch<T, G, true>(x, gamma, out, rows, d, eps, block_per_row, stream);
  else
    launch<T, G, false>(x, gamma, out, rows, d, eps, block_per_row, stream);
}

template <typename T>
void launch_g(int gamma_dtype, const void* x, const void* gamma, void* out,
              int rows, int d, float eps, int vec, int block_per_row,
              cudaStream_t stream) {
  if (gamma_dtype == 0)
    launch_v<T, float>(x, gamma, out, rows, d, eps, vec, block_per_row,
                       stream);
  else
    launch_v<T, __nv_bfloat16>(x, gamma, out, rows, d, eps, vec,
                               block_per_row, stream);
}

}  // namespace

extern "C" {

// x (rows, d) contiguous, gamma (d,) -> out (rows, d) of x's type.
// vec != 0 requires d % (16 / sizeof(T)) == 0 and 16-byte-aligned x and out.
int rms_norm(int dtype, int gamma_dtype, const void* x, const void* gamma,
             void* out, int rows, int d, float eps, int vec,
             int block_per_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_g<float>(gamma_dtype, x, gamma, out, rows, d, eps, vec,
                    block_per_row, s);
  else
    launch_g<__nv_bfloat16>(gamma_dtype, x, gamma, out, rows, d, eps, vec,
                            block_per_row, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
