// The dropless grouped expert products of an MoE layer (layers/moe.py's
// sigmoid-routed afmoe router): every (token, slot) assignment runs through
// its expert's SwiGLU, with no capacity and no dropped assignment.  It
// replaces no TPU kernel: the reference's MoE products are jnp.einsum over a
// capacity buffer, outside any Pallas kernel; this kernel exists because a
// dropless layer has ragged per-expert row counts that a batched matmul over
// a fixed (experts, capacity) buffer cannot take without padding every
// expert to the largest.
//
// Inputs, as moe_experts.py prepares them on the device (no host read, so a
// CUDA graph captures the call): the A = T * k assignments sorted by local
// expert (`order`: the assignment index a = t * k + j of each sorted row;
// assignments of other ranks' experts sort last and are never read), and
// `offsets` (e_loc + 1): sorted rows [offsets[e], offsets[e + 1]) belong to
// local expert e.
//
//   gate_up:  H[r] = silu(x[t] Wg[e]) * (x[t] Wu[e])     (bf16, sorted rows)
//   down:     Y[a] = w[a] * (H[r] Wd[e])                 (fp32, row a)
//
// with t = order[r] / k and a = order[r].  The caller sums Y over the k
// slots of each token (layers/moe.py).  A row's products accumulate over the
// same K chunks in the same order whatever other rows share its tile, so an
// assignment's output does not depend on how tokens were batched.
//
// What bounds it on the card: bytes.  Each expert hit streams its three
// 2048 x 1024 bf16 matrices (12.6 MB at Trinity-Mini's widths) for a few
// rows; a decode step's 24 tokens reach ~97 of 128 experts a layer.  The
// design streams weight tiles through a cp.async ring in shared memory
// (4 stages at decode, 3 at a grant) with mma.sync m16n8k16 (bf16 in, fp32
// sums) on the tiles that have landed:
//   - a block owns BM sorted rows of one expert (BM 16 at decode, where an
//     expert sees 1-3 rows; 64 at a grant) and BN output columns; its four
//     warps split the columns and share the rows;
//   - the grid is sized for the worst case, Σ_e ceil(c_e / BM) <= (A +
//     e_loc (BM - 1)) / BM tiles, and a block past the device-side tile
//     count exits at once; each block finds its expert by a scan of
//     `offsets`;
//   - gathered activation rows (gate_up) and the matching sorted H rows
//     (down) are zero-filled past the tile's rows (cp.async with a zero
//     source size), and the epilogue writes only real rows;
//   - decode and grant launches are distinct kernels
//     (moe_experts_decode_*, moe_experts_grant_*), so a device trace tells
//     the two calls apart.
// Hopper's wgmma with TMA under mbarriers is the headroom left.

#include "flash_tc.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBK = 64;        // K chunk of a stage
constexpr int kSA = kBK + 8;   // padded smem row stride of an A tile

__device__ __forceinline__ void cp_async_wait_stages(int pending) {
  // pending groups allowed in flight: the ring depth less one, or less
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

// The expert and row range of tile `tile` (tiles laid out expert by expert,
// ceil(c_e / BM) each); false past the last tile.
template <int BM>
__device__ __forceinline__ bool find_tile(const int* __restrict__ offsets,
                                          int e_loc, int tile, int& e,
                                          int& r0, int& r1) {
  int start = 0;
  for (int i = 0; i < e_loc; ++i) {
    const int a = offsets[i], b = offsets[i + 1];
    const int n = (b - a + BM - 1) / BM;
    if (tile < start + n) {
      e = i;
      r0 = a + (tile - start) * BM;
      r1 = min(r0 + BM, b);
      return true;
    }
    start += n;
  }
  return false;
}

// A tile (BM x kBK) of rows row_ptr(i) (nullptr: zeros, read from no
// address: `valid` only stands in as the copy's source), columns k0..k0+63
template <int BM, typename RowPtr>
__device__ __forceinline__ void load_a(__nv_bfloat16* dst, int k0,
                                       RowPtr row_ptr,
                                       const __nv_bfloat16* valid) {
  constexpr int kChunks = BM * kBK / 8;
#pragma unroll
  for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (kChunks % kThreads == 0 || i < kChunks) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const __nv_bfloat16* src = row_ptr(r);
      cp_async16(smem_u32(dst + r * kSA + c), src ? src + k0 + c : valid,
                 src ? 16 : 0);
    }
  }
}

// B tile (kBK x BN) of a row-major (K, N) matrix w with row stride ld,
// rows k0.., columns n0..
template <int BN>
__device__ __forceinline__ void load_b(__nv_bfloat16* dst,
                                       const __nv_bfloat16* __restrict__ w,
                                       long long ld, int k0, int n0) {
  constexpr int kSB = BN + 8;
  constexpr int kChunks = kBK * BN / 8;
  static_assert(kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    cp_async16(smem_u32(dst + r * kSB + c), w + (k0 + r) * ld + n0 + c, 16);
  }
}

// acc[mi][n] += A (BM x 16 at kk) B (16 x warp's columns at kk), for NM
// matrices sharing A; the warp owns columns warp * BN / 4 + 16 p .. of each
template <int BM, int BN, int NM>
__device__ __forceinline__ void mma_stage(
    float (&acc)[NM][BM / 16][BN / 32][4], const __nv_bfloat16* a_s,
    const __nv_bfloat16* const (&b_s)[NM]) {
  constexpr int kSB = BN + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a_off = (lane & 15) * kSA + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kSB +
                    (lane >> 4) * 8 + warp * (BN / 4);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[BM / 16][4];
#pragma unroll
    for (int mi = 0; mi < BM / 16; ++mi)
      ldsm_x4(a[mi], smem_u32(a_s + a_off + mi * 16 * kSA + kk * 16));
#pragma unroll
    for (int g = 0; g < NM; ++g)
#pragma unroll
      for (int p = 0; p < BN / 64; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(b_s[g] + b_off + kk * 16 * kSB + p * 16));
#pragma unroll
        for (int mi = 0; mi < BM / 16; ++mi) {
          mma_bf16(acc[g][mi][2 * p], a[mi], b[0], b[1]);
          mma_bf16(acc[g][mi][2 * p + 1], a[mi], b[2], b[3]);
        }
      }
  }
}

// The K loop of one block over an NS-stage ring: NM matrices of row stride
// ldb (K, N) read at columns n0, with the A rows of row_ptr.
template <int BM, int BN, int NM, int NS, typename RowPtr>
__device__ __forceinline__ void k_loop(
    float (&acc)[NM][BM / 16][BN / 32][4], __nv_bfloat16* smem, int K,
    const __nv_bfloat16* const (&w)[NM], long long ldb, int n0,
    RowPtr row_ptr) {
  constexpr int kATile = BM * kSA, kBTile = kBK * (BN + 8);
  constexpr int kStage = kATile + NM * kBTile;
#pragma unroll
  for (int g = 0; g < NM; ++g)
#pragma unroll
    for (int mi = 0; mi < BM / 16; ++mi)
#pragma unroll
      for (int n = 0; n < BN / 32; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][mi][n][c] = 0.f;
  const int nk = K / kBK;
  auto load = [&](int kt, int st) {
    __nv_bfloat16* s = smem + st * kStage;
    load_a<BM>(s, kt * kBK, row_ptr, w[0]);
#pragma unroll
    for (int g = 0; g < NM; ++g)
      load_b<BN>(s + kATile + g * kBTile, w[g], ldb, kt * kBK, n0);
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_stages(NS - 2);
    __syncthreads();  // stage kt landed; every warp is done with kt - 1's
    if (kt + NS - 1 < nk) load(kt + NS - 1, (kt + NS - 1) % NS);
    cp_async_commit();
    const __nv_bfloat16* s = smem + (kt % NS) * kStage;
    const __nv_bfloat16* b_s[NM];
#pragma unroll
    for (int g = 0; g < NM; ++g) b_s[g] = s + kATile + g * kBTile;
    mma_stage<BM, BN, NM>(acc, s, b_s);
  }
  cp_async_wait_stages(0);
}

template <int BM, int BN, int NM, int NS>
__host__ __device__ constexpr int smem_bytes() {
  return NS * (BM * kSA + NM * kBK * (BN + 8)) * 2;
}

// H[r, n0 + ...] = silu(x Wg) * (x Wu) of tile (blockIdx.y), columns
// blockIdx.x * BN ..
template <int BM, int NS>
__device__ __forceinline__ void gate_up_body(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ order,
    const int* __restrict__ offsets, const __nv_bfloat16* __restrict__ wg,
    const __nv_bfloat16* __restrict__ wu, __nv_bfloat16* __restrict__ h,
    int D, int F, int k, int e_loc) {
  constexpr int BN = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int e, r0, r1;
  if (!find_tile<BM>(offsets, e_loc, blockIdx.y, e, r0, r1)) return;
  const int n0 = blockIdx.x * BN;
  const long long we = (long long)e * D * F;
  const __nv_bfloat16* const w[2] = {wg + we, wu + we};
  float acc[2][BM / 16][BN / 32][4];
  k_loop<BM, BN, 2, NS>(acc, smem, D, w, F, n0, [&](int i) {
    const int r = r0 + i;
    return r < r1 ? x + (long long)(order[r] / k) * D
                  : (const __nv_bfloat16*)nullptr;
  });
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < BM / 16; ++mi)
#pragma unroll
    for (int n = 0; n < BN / 32; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + mi * 16 + (lane >> 2) + 8 * half;
        if (r >= r1) continue;
        const int col = n0 + warp * (BN / 4) + n * 8 + (lane & 3) * 2;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float g = acc[0][mi][n][2 * half + c];
          const float u = acc[1][mi][n][2 * half + c];
          v[c] = g / (1.f + __expf(-g)) * u;
        }
        *reinterpret_cast<uint32_t*>(h + (long long)r * F + col) =
            pack_bf16(v[0], v[1]);
      }
}

// Y[a, n0 + ...] = w[a] * (H[r] Wd) of tile (blockIdx.y), a = order[r]
template <int BM, int NS>
__device__ __forceinline__ void down_body(
    const __nv_bfloat16* __restrict__ h, const int* __restrict__ order,
    const int* __restrict__ offsets, const float* __restrict__ wts,
    const __nv_bfloat16* __restrict__ wd, float* __restrict__ y, int D,
    int F, int e_loc) {
  constexpr int BN = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int e, r0, r1;
  if (!find_tile<BM>(offsets, e_loc, blockIdx.y, e, r0, r1)) return;
  const int n0 = blockIdx.x * BN;
  const __nv_bfloat16* const w[1] = {wd + (long long)e * F * D};
  float acc[1][BM / 16][BN / 32][4];
  k_loop<BM, BN, 1, NS>(acc, smem, F, w, D, n0, [&](int i) {
    const int r = r0 + i;
    return r < r1 ? h + (long long)r * F : (const __nv_bfloat16*)nullptr;
  });
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < BM / 16; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + mi * 16 + (lane >> 2) + 8 * half;
      if (r >= r1) continue;
      const int a = order[r];
      const float wa = wts[a];
#pragma unroll
      for (int n = 0; n < BN / 32; ++n) {
        const int col = n0 + warp * (BN / 4) + n * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(y + (long long)a * D + col) =
            make_float2(wa * acc[0][mi][n][2 * half],
                        wa * acc[0][mi][n][2 * half + 1]);
      }
    }
}

constexpr int kDecBM = 16, kDecNS = 4;
constexpr int kGrantBM = 64, kGrantNS = 3;

#define GATE_UP_ARGS                                                      \
  const __nv_bfloat16 *x, const int *order, const int *offsets,          \
      const __nv_bfloat16 *wg, const __nv_bfloat16 *wu, __nv_bfloat16 *h, \
      int D, int F, int k, int e_loc
#define DOWN_ARGS                                                         \
  const __nv_bfloat16 *h, const int *order, const int *offsets,          \
      const float *wts, const __nv_bfloat16 *wd, float *y, int D, int F, \
      int e_loc

__global__ void __launch_bounds__(kThreads)
    moe_experts_decode_gate_up(GATE_UP_ARGS) {
  gate_up_body<kDecBM, kDecNS>(x, order, offsets, wg, wu, h, D, F, k, e_loc);
}
__global__ void __launch_bounds__(kThreads)
    moe_experts_grant_gate_up(GATE_UP_ARGS) {
  gate_up_body<kGrantBM, kGrantNS>(x, order, offsets, wg, wu, h, D, F, k,
                                   e_loc);
}
__global__ void __launch_bounds__(kThreads)
    moe_experts_decode_down(DOWN_ARGS) {
  down_body<kDecBM, kDecNS>(h, order, offsets, wts, wd, y, D, F, e_loc);
}
__global__ void __launch_bounds__(kThreads)
    moe_experts_grant_down(DOWN_ARGS) {
  down_body<kGrantBM, kGrantNS>(h, order, offsets, wts, wd, y, D, F, e_loc);
}

// the worst-case tile count of A sorted rows over e_loc experts at BM rows
int max_tiles(int A, int e_loc, int bm) {
  const long long t = ((long long)A + (long long)e_loc * (bm - 1)) / bm;
  return (int)(t < A ? t : A);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

// Shared-memory bytes of a launch (decode != 0: the decode kernels)
int moe_experts_smem_bytes(int decode, int down) {
  if (down)
    return decode ? smem_bytes<kDecBM, 128, 1, kDecNS>()
                  : smem_bytes<kGrantBM, 128, 1, kGrantNS>();
  return decode ? smem_bytes<kDecBM, 64, 2, kDecNS>()
                : smem_bytes<kGrantBM, 64, 2, kGrantNS>();
}

// x (T, D), order (A,) int32, offsets (e_loc + 1,) int32, wg/wu (E, D, F),
// h (A, F): bf16.  D % 64 == 0, F % 64 == 0 (the wrapper checks).
int moe_gate_up(int decode, const void* x, const void* order,
                const void* offsets, const void* wg, const void* wu, void* h,
                int A, int D, int F, int k, int e_loc, void* stream) {
  const int bm = decode ? kDecBM : kGrantBM;
  const int smem = moe_experts_smem_bytes(decode, 0);
  const dim3 grid(F / 64, max_tiles(A, e_loc, bm));
  auto kernel = decode ? moe_experts_decode_gate_up
                       : moe_experts_grant_gate_up;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (grid.y == 0) return 0;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int*)order, (const int*)offsets,
      (const __nv_bfloat16*)wg, (const __nv_bfloat16*)wu,
      (__nv_bfloat16*)h, D, F, k, e_loc);
  return (int)cudaGetLastError();
}

// h (A, F) bf16 sorted rows, wts (A,) fp32 by assignment, wd (E, F, D)
// bf16, y (A, D) fp32 by assignment.  D % 128 == 0, F % 64 == 0.
int moe_down(int decode, const void* h, const void* order,
             const void* offsets, const void* wts, const void* wd, void* y,
             int A, int D, int F, int e_loc, void* stream) {
  const int bm = decode ? kDecBM : kGrantBM;
  const int smem = moe_experts_smem_bytes(decode, 1);
  const dim3 grid(D / 128, max_tiles(A, e_loc, bm));
  auto kernel = decode ? moe_experts_decode_down : moe_experts_grant_down;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (grid.y == 0) return 0;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const int*)order, (const int*)offsets,
      (const float*)wts, (const __nv_bfloat16*)wd, (float*)y, D, F, e_loc);
  return (int)cudaGetLastError();
}

}  // extern "C"
