// Dense flash-attention prefill with a causal offset, hand-written for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (repro_torch/kernels/native.py).
//
//   flash_prefill  replaces repro/kernels/flash_prefill.py::_flash_kernel
//
// q (B, Hq, Sq, hd) attends k, v (B, Hkv, Sk, hd), all contiguous and of one
// type (float32 or bfloat16); q head h reads kv head h / (Hq / Hkv).  Query
// row i sits at position q_start + i; key j is attended iff
//   j < Sk,  and j <= q_start + i (causal),  and j > q_start + i - window
//   (window > 0).
// out (B, Hq, Sq, hd), q's type, is softmax(q k^T / sqrt(hd)) v normalised,
// with the running (max, denominator, accumulator) per row in fp32.  A row
// with no attended key comes out 0, as the reference oracle gives it (the
// Pallas kernel leaves a padding-dependent value there: it does not mask p).
//
// What bounds it on the card is operations: 4 * hd FLOPs per attended
// (query, key) pair against one read of q, k and v, at 989 TFLOP/s bf16.
// The dtype picks the kernel:
//   - bfloat16: flash_prefill_tc_kernel, the tensor-core tile loop of
//     flash_tc.cuh (mma.sync m16n8k16 from ldmatrix fragments, K/V stages
//     filled by cp.async, the online softmax in registers; P rounded to bf16
//     before P V).  A block of 4 warps owns (b, q head, 128-query tile), 32
//     rows a warp, up to hd 128 (64-query tiles above).  mma.sync does not
//     reach half of the bf16 peak: wgmma fed by TMA is where the remaining
//     headroom lies.
//   - float32: flash_prefill_kernel, fp32 FMAs on the CUDA cores (TF32 would
//     keep three digits, against fp32's 1e-5 tolerance).  One block of 256
//     threads owns (b, q head, 64-query tile); each key tile is staged in
//     shared memory, and the block's 16 x 16 threads each hold a 4 x 4 patch
//     of the score tile and a 4 x (4 * NV) patch of the output accumulator in
//     registers (NV = ceil(hd / 64)), reading q, k, p and v from shared
//     memory as float4s: rows are padded so that the k reads of a
//     quarter-warp fall in distinct banks.
// Both walk the 64-key tiles in a loop, which takes the place of the TPU's
// sequential k grid axis.  Tiles wholly above the causal diagonal or wholly
// below the window are skipped; that is exact, since such a tile only ever
// adds p = 0 (after a valid key) or is wiped by alpha = 0 (before one).
// Query tiles are issued last-first, so the longest causal rows start first.
//
// The entry returns cudaGetLastError() after its launch; the Python wrapper
// raises on a non-zero code.  dtype codes: 0 = float32, 1 = bfloat16.

#include "common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // finite, so an empty row stays NaN-free
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kPS = kBK + 4;       // row stride of the probability tile

// head_dim rounded up to a float4, and the row stride of the q and k tiles
__host__ __device__ inline int hd4(int hd) { return (hd + 3) & ~3; }
__host__ __device__ inline int qk_stride(int hd) { return hd4(hd) + 4; }
__host__ __device__ inline int nv_of(int hd) { return (hd + 63) / 64; }

// Shared-memory floats of a block: q tile, k tile, v tile (64 * NV columns,
// zero past hd), probability tile, and (m, l, alpha) per query row.  At
// hd 256 that is 216.8 KB, under the 227 KB a block may use; at hd 128,
// 118.5 KB, one block per SM.
inline size_t smem_floats(int hd) {
  return (size_t)(kBQ + kBK) * qk_stride(hd) +
         (size_t)kBK * 64 * nv_of(hd) + (size_t)kBQ * kPS + 3 * kBQ;
}

__device__ __forceinline__ bool attended(int kpos, int qpos, int Sk,
                                         int causal, int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window) ok = ok && kpos > qpos - window;
  return ok;
}

// grid (query tiles, Hq, B); NV = ceil(hd / 64) output column groups.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Hq,
                     int Hkv, int Sq, int Sk, int hd, int q_start, int causal,
                     int window, float scale) {
  const int nq = gridDim.x;
  const int iq = nq - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hkv = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int HD4 = hd4(hd), QS = qk_stride(hd), VS = 64 * NV;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // kBQ * QS
  float* k_s = q_s + kBQ * QS;        // kBK * QS
  float* v_s = k_s + kBK * QS;        // kBK * VS
  float* p_s = v_s + kBK * VS;        // kBQ * kPS
  float* m_s = p_s + kBQ * kPS;       // kBQ
  float* l_s = m_s + kBQ;             // kBQ
  float* a_s = l_s + kBQ;             // kBQ

  const int row0 = iq * kBQ;          // first query row of the tile
  const int rows = min(kBQ, Sq - row0);
  const T* qb = q + (((size_t)b * Hq + h) * Sq + row0) * hd;
  const T* kb = k + ((size_t)b * Hkv + hkv) * Sk * hd;
  const T* vb = v + ((size_t)b * Hkv + hkv) * Sk * hd;

  // the q tile, zero past the last row and past hd
  for (int i = tid; i < kBQ * HD4; i += kThreads) {
    const int r = i / HD4, d = i - r * HD4;
    q_s[r * QS + d] = (r < rows && d < hd) ? to_float(qb[(size_t)r * hd + d])
                                           : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  float acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[i][c] = 0.f;

  // key tiles that can hold an attended key for some row of this tile
  const int q_lo = q_start + row0, q_hi = q_start + row0 + rows - 1;
  const int nk = (Sk + kBK - 1) / kBK;
  int t_begin = 0, t_end = nk;
  if (window) t_begin = max(0, q_lo - window + 1) / kBK;
  if (causal) t_end = q_hi < 0 ? 0 : min(nk, q_hi / kBK + 1);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * kBK;
    const int keys = min(kBK, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * VS; i += kThreads) {
      const int t = i / VS, d = i - t * VS;
      const bool in = t < keys && d < hd;
      const size_t off = (size_t)(k0 + t) * hd + d;
      if (d < HD4) k_s[t * QS + d] = in ? to_float(kb[off]) : 0.f;
      v_s[i] = in ? to_float(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(ty + 16 * i) * kPS + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();

    // online softmax, one warp per 8 rows, two keys a lane; the mask is
    // applied to the max and again to p, so a masked key adds exactly 0
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const int qpos = q_start + row0 + r;
      float* pr = p_s + r * kPS;
      const bool ok0 = attended(k0 + lane, qpos, Sk, causal, window);
      const bool ok1 = attended(k0 + lane + 32, qpos, Sk, causal, window);
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float mx = warp_max(fmaxf(ok0 ? s0 : kNegInf, ok1 ? s1 : kNegInf));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      const float p0 = ok0 ? expf(s0 - m_cur) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_cur) : 0.f;
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v: rows ty + 16 i, columns 4 tx + 64 c + e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) acc[i][c] *= a;
    }
    for (int t = 0; t < kBK; t += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPS + t);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (t + tt) * VS + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = tt == 0   ? pv[i].x
                            : tt == 1 ? pv[i].y
                            : tt == 2 ? pv[i].z
                                      : pv[i].w;
            acc[i][4 * c + 0] = fmaf(p, vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(p, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }
  __syncthreads();

  T* ob = out + (((size_t)b * Hq + h) * Sq + row0) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * c + 4 * tx + e;
        if (d < hd) store(ob + (size_t)r * hd + d, acc[i][4 * c + e] / l);
      }
  }
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Hq, int Hkv, int Sq, int Sk, int hd, int q_start,
                   int causal, int window, float scale, cudaStream_t stream) {
  // raise the dynamic shared-memory limit past the 48 KB default once per
  // instantiation, so steady-state launches (and graph captures) make no call
  static size_t allowed = 0;
  const size_t smem = smem_floats(hd) * sizeof(float);
  if (smem > 48 * 1024 && smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<T, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  const int nq = (Sq + kBQ - 1) / kBQ;
  flash_prefill_kernel<T, NV><<<dim3(nq, Hq, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, hd,
      q_start, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     int B, int Hq, int Hkv, int Sq, int Sk, int hd,
                     int q_start, int causal, int window, float scale,
                     cudaStream_t st) {
  switch (nv_of(hd)) {
    case 1:
      return launch<T, 1>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, q_start,
                          causal, window, scale, st);
    case 2:
      return launch<T, 2>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, q_start,
                          causal, window, scale, st);
    case 3:
      return launch<T, 3>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, q_start,
                          causal, window, scale, st);
    case 4:
      return launch<T, 4>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, q_start,
                          causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;  // hd > 256: the wrapper refuses it
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core tile loop (flash_tc.cuh)
// ---------------------------------------------------------------------------

// m-tiles a warp owns: two (128 query rows a block) up to hd 128, where the
// fp32 output fragments of 32 rows fit in registers beside the scores
__host__ __device__ constexpr int dense_m(int KD) { return KD <= 8 ? 2 : 1; }

// grid (Hq, query tiles, B); KD = the largest hd / 16 it takes (4, 8, 16),
// exactly that one when kExact.  Query tiles are issued longest first
// (blockIdx.y 0 is the last tile, whose causal rows are longest) so a wave's
// tail holds the short ones; when the whole grid fits in one wave (`pair`),
// the second half of the issue order runs shortest first instead, so that
// the blocks sharing an SM pair a long tile with a short one.
template <int KD, bool kExact>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(KD, dense_m(KD)))
flash_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                        int Sq, int Sk, int hd, int q_start, int causal,
                        int window, float scale_log2, int vec,
                        int pair) {
  const int nq = gridDim.y, y = blockIdx.y, half = (nq + 1) / 2;
  const int iq = (pair && y >= half) ? y - half : nq - 1 - y;
  const int h = blockIdx.x, b = blockIdx.z;
  const int hkv = h / (Hq / Hkv);
  constexpr int kRows = kTcRows * dense_m(KD);
  const int row0 = iq * kRows;
  const int rows = min(kRows, Sq - row0);
  const size_t q_base = (((size_t)b * Hq + h) * Sq + row0) * hd;
  const size_t kv_base = ((size_t)b * Hkv + hkv) * Sk * hd;

  const int q_lo = q_start + row0, q_hi = q_start + row0 + rows - 1;
  const int nk = (Sk + kTcKeys - 1) / kTcKeys;
  int t_begin = 0, t_end = nk;
  if (window) t_begin = max(0, q_lo - window + 1) / kTcKeys;
  if (causal) t_end = q_hi < 0 ? 0 : min(nk, q_hi / kTcKeys + 1);

  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* ob = out + q_base;
  flash_tc_block<KD, dense_m(KD), kExact>(
      reinterpret_cast<__nv_bfloat16*>(tc_smem), q + q_base, k + kv_base,
      v + kv_base, hd, vec != 0, scale_log2, t_begin, t_end,
      [=](int r) { return r < rows ? (long long)r * hd : -1LL; },
      [=](int key) { return key < Sk ? (long long)key * hd : -1LL; },
      [=](int r, int key) {
        return attended(key, q_start + row0 + r, Sk, causal, window);
      },
      [=](int k0) {  // every row attends keys k0 .. k0 + 63
        const int k1 = k0 + kTcKeys - 1;
        return k1 < Sk && (!causal || k1 <= q_lo) &&
               (!window || k0 > q_hi - window);
      },
      [=](int r, int d, float x0, float x1) {
        if (r >= rows) return;
        __nv_bfloat16* p = ob + (size_t)r * hd + d;
        if (d + 1 < hd && !(hd & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < hd) p[0] = __float2bfloat16(x0);
          if (d + 1 < hd) p[1] = __float2bfloat16(x1);
        }
      },
      [](int, float, float) {});
}

template <int KD, bool kExact>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int B, int Hq, int Hkv, int Sq, int Sk, int hd,
                      int q_start, int causal, int window, int vec,
                      float scale, cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t smem = tc_smem_bytes(hd, dense_m(KD));
  if (smem > 48 * 1024 && smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_tc_kernel<KD, kExact>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int rows = kTcRows * dense_m(KD);
  const int nq = (Sq + rows - 1) / rows;
  const int pair = (long long)nq * Hq * B <=
                   (long long)tc_min_blocks(KD, dense_m(KD)) * sms;
  flash_prefill_tc_kernel<KD, kExact>
      <<<dim3(Hq, nq, B), kTcThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Hq, Hkv, Sq, Sk, hd,
      q_start, causal, window, scale * kLog2e, vec, pair);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// vec: hd % 8 == 0 and q, k, v 16-byte aligned (bf16 only: cp.async chunks)
int flash_prefill(int dtype, const void* q, const void* k, const void* v,
                  void* out, int B, int Hq, int Hkv, int Sq, int Sk, int hd,
                  int q_start, int causal, int window, int vec, float scale,
                  void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_t<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, q_start,
                                causal, window, scale, st);
  if (dtype == 1)
    return (int)tc_dispatch_hd(hd, [&](auto kd, auto exact) {
      return launch_tc<decltype(kd)::value, decltype(exact)::value>(
          q, k, v, out, B, Hq, Hkv, Sq, Sk, hd, q_start, causal, window, vec,
          scale, st);
    });
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
