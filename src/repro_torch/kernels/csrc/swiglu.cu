// Fused SwiGLU activation, hand-written for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/native.py).
//
//   swiglu  replaces repro/kernels/swiglu.py::_swiglu_kernel
//
// For gate and up of n elements each, float32 or bfloat16:
//   out = gate / (1 + exp(-gate)) * up      (fp32, written as gate's type)
// i.e. silu(gate) * up with the product taken in fp32, as the TPU kernel
// does (the model's MLP rounds silu(gate) to the activation type first; it
// does not call this kernel).  expf and the division are the IEEE ones (the
// build has no fast-math), so fp32 results stay within an ulp or two of the
// plain PyTorch version.
//
// What bounds it on the card is bytes: two inputs read once and one output
// written once, five operations per element.  The TPU kernel walks
// (block_rows, block_cols) VMEM tiles; the operation is elementwise, so here
// it is one grid-stride pass over the flat tensors with 16-byte loads and
// stores (4 fp32 or 8 bf16 values a thread a step).  The n % N elements past
// the last whole vector are done by the first threads of the grid.  Inputs
// whose base addresses do not allow 16-byte vectors take a scalar path.
//
// The entry returns cudaGetLastError() after its launch; the Python wrapper
// raises on a non-zero code.  dtype codes: 0 = float32, 1 = bfloat16.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks for each SM

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    swiglu_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                  T* __restrict__ out, long long n) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (VEC) {
    constexpr int N = Vec<T>::N;
    const long long nv = n / N;
    const uint4* gv = reinterpret_cast<const uint4*>(gate);
    const uint4* uv = reinterpret_cast<const uint4*>(up);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      float g[N], u[N];
      Vec<T>::unpack(gv[i], g);
      Vec<T>::unpack(uv[i], u);
#pragma unroll
      for (int j = 0; j < N; ++j) g[j] = silu_mul(g[j], u[j]);
      ov[i] = Vec<T>::pack(g);
    }
    done = nv * N;
  }
  for (long long i = done + tid; i < n; i += stride)
    store(out + i, silu_mul(to_float(gate[i]), to_float(up[i])));
}

template <typename T>
void launch(const void* gate, const void* up, void* out, long long n, int vec,
            cudaStream_t stream) {
  const long long items = vec ? n / Vec<T>::N + 1 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* g = static_cast<const T*>(gate);
  const T* u = static_cast<const T*>(up);
  T* o = static_cast<T*>(out);
  if (vec)
    swiglu_kernel<T, true><<<(int)blocks, kThreads, 0, stream>>>(g, u, o, n);
  else
    swiglu_kernel<T, false><<<(int)blocks, kThreads, 0, stream>>>(g, u, o, n);
}

}  // namespace

extern "C" {

// gate, up, out: n contiguous elements each.  vec != 0 requires all three
// base addresses 16-byte aligned.
int swiglu(int dtype, const void* gate, const void* up, void* out,
           long long n, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(gate, up, out, n, vec, s);
  else
    launch<__nv_bfloat16>(gate, up, out, n, vec, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
