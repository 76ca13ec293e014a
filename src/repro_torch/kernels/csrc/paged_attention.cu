// Paged attention kernels of the port's serving path, hand-written for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (repro_torch/kernels/native.py).  Three kernels:
//
//   paged_decode   replaces repro/kernels/flash_decode.py::_decode_kernel
//   decode_reduce  replaces repro/kernels/flash_decode.py::_decode_reduce_kernel
//   paged_prefill  replaces repro/kernels/flash_prefill_paged.py::_prefill_kernel
//
// Decode is bound by bytes at the serving shapes (it reads every resident
// K/V page once per step): one thread block per output tile, a loop over the
// pages of the block table in place of the TPU's sequential page grid axis,
// fp32 accumulation on the CUDA cores with the running softmax state (max,
// denominator, accumulator) in shared memory.  Tensor cores (wgmma) and TMA
// page loads are later work for it.
//
// Paged prefill is bound by operations (4 * hd FLOPs per attended pair
// against one read of the prefix, at 989 TFLOP/s bf16).  The dtype picks the
// kernel:
//   - bfloat16: paged_prefill_tc_kernel, the tensor-core tile loop of
//     flash_tc.cuh (mma.sync m16n8k16 from ldmatrix fragments, K/V stages
//     filled by cp.async, the online softmax in registers; P rounded to bf16
//     before P V), each 64-key tile gathered through the block table from
//     ceil(64 / ps) pages.  mma.sync does not reach half of the bf16 peak:
//     wgmma fed by TMA is where the remaining headroom lies.
//   - float32: paged_prefill_kernel, the CUDA-core page loop of the decode
//     kernel (TF32 would keep three digits, against fp32's 1e-5 tolerance).
//
// Every entry returns cudaGetLastError() after its launch; the Python wrapper
// raises on a non-zero code.  dtype codes: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // finite, so an empty span folds NaN-free
constexpr int kDecodeThreads = 128;
constexpr int kPrefillThreads = 256;
constexpr int kReduceThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Load one (ps, hd) page of head h into shared memory as fp32: K with a
// padded row stride (hd + 1) so the score loop's per-key rows fall in
// different banks, V dense.  Pool layout (N, ps, Hkv, hd), contiguous.
template <typename T>
__device__ __forceinline__ void load_page(const T* __restrict__ k_pages,
                                          const T* __restrict__ v_pages,
                                          int page, int h, int ps, int Hkv,
                                          int hd, float* k_s, float* v_s) {
  const size_t base = ((size_t)page * ps * Hkv + h) * hd;
  const size_t row = (size_t)Hkv * hd;
  for (int i = threadIdx.x; i < ps * hd; i += blockDim.x) {
    const int t = i / hd, d = i - t * hd;
    const size_t off = base + t * row + d;
    k_s[t * (hd + 1) + d] = to_float(k_pages[off]);
    v_s[i] = to_float(v_pages[off]);
  }
}

// One online-softmax step over a loaded page for R query rows.
//   scores:  p_s[r*ps + t] = q_r . k_t * scale   (NEG_INF where masked)
//   rows:    m' = max(m, max_t s), alpha = exp(m - m'),
//            p = exp(s - m') * mask, l' = l * alpha + sum_t p
//   acc:     acc' = acc * alpha + p @ V
// valid(r, t) gives the mask; it is evaluated in both passes so the
// probability of a masked key is exactly 0 (the reference multiplies by the
// mask: a fully masked page keeps m at NEG_INF and exp(0) = 1 would leak).
template <typename Valid>
__device__ __forceinline__ void softmax_page(const float* q_s, const float* k_s,
                                             const float* v_s, float* p_s,
                                             float* acc, float* m_s, float* l_s,
                                             float* a_s, int R, int ps, int hd,
                                             float scale, Valid valid) {
  const int hdp = hd + 1;
  for (int i = threadIdx.x; i < R * ps; i += blockDim.x) {
    const int r = i / ps, t = i - r * ps;
    const float* qr = q_s + r * hdp;
    const float* kr = k_s + t * hdp;
    float dot = 0.f;
    for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
    p_s[i] = valid(r, t) ? dot * scale : kNegInf;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float* pr = p_s + r * ps;
    float mx = kNegInf;
    for (int t = 0; t < ps; ++t) mx = fmaxf(mx, pr[t]);
    const float m_prev = m_s[r];
    const float m_cur = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_cur);
    float sum = 0.f;
    for (int t = 0; t < ps; ++t) {
      const float p = valid(r, t) ? expf(pr[t] - m_cur) : 0.f;
      pr[t] = p;
      sum += p;
    }
    l_s[r] = l_s[r] * alpha + sum;
    m_s[r] = m_cur;
    a_s[r] = alpha;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const float* pr = p_s + r * ps;
    float pv = 0.f;
    for (int t = 0; t < ps; ++t) pv = fmaf(pr[t], v_s[t * hd + d], pv);
    acc[i] = acc[i] * a_s[r] + pv;
  }
  __syncthreads();
}

// Shared-memory floats of a block holding R query rows (see the carve-up in
// the kernels below; the host computes the same number).
__host__ __device__ inline size_t smem_floats(int R, int ps, int hd) {
  return (size_t)R * (hd + 1) + (size_t)ps * (hd + 1) + (size_t)ps * hd +
         (size_t)R * ps + (size_t)R * hd + 3 * (size_t)R;
}

// ---------------------------------------------------------------------------
// decode: one block per (split, kv head, request)
// ---------------------------------------------------------------------------

// q (B, Hkv, gk, hd) with row r = g*K + qi; out (B, Hkv, S, gk, hd) fp32,
// m/l (B, Hkv, S, gk) fp32.  Span `split` walks page-walk indices
// [split*pps, (split+1)*pps); indices >= MB (a ragged last span) read page 0
// and are always masked (their key positions are >= MB*ps >= length).
template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int Hkv, int gk, int K, int hd, int N, int ps, int MB,
                    int S, int pps, int window, int guard, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hdp = hd + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                   // gk * hdp
  float* k_s = q_s + gk * hdp;         // ps * hdp
  float* v_s = k_s + ps * hdp;         // ps * hd
  float* p_s = v_s + ps * hd;          // gk * ps
  float* acc = p_s + gk * ps;          // gk * hd
  float* m_s = acc + gk * hd;          // gk
  float* l_s = m_s + gk;               // gk
  float* a_s = l_s + gk;               // gk

  const int length = lengths[b];
  const T* qb = q + ((size_t)b * Hkv + h) * gk * hd;
  for (int i = threadIdx.x; i < gk * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    q_s[r * hdp + d] = to_float(qb[i]);
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < gk; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int jj = 0; jj < pps; ++jj) {
    const int j = split * pps + jj;            // global page-walk index
    // dead-page skip: a page wholly past the resident tokens would leave
    // (m, l, acc) unchanged (alpha = exp(0) = 1, p = 0); the walk is
    // monotone, so every later page of the span is dead too
    if (guard && j * ps >= length) break;
    int page = j < MB ? block_tables[(size_t)b * MB + j] : 0;
    page = min(max(page, 0), N - 1);           // -1 pads alias page 0
    load_page(k_pages, v_pages, page, h, ps, Hkv, hd, k_s, v_s);
    __syncthreads();
    const int kbase = j * ps;
    softmax_page(q_s, k_s, v_s, p_s, acc, m_s, l_s, a_s, gk, ps, hd, scale,
                 [=](int r, int t) {
                   const int kpos = kbase + t;
                   // validity doubles as causality: every paged key sits at
                   // a position < length <= length + qi
                   bool ok = kpos < length;
                   if (window) ok = ok && kpos > length + (r % K) - window;
                   return ok;
                 });
  }

  const size_t row0 = (((size_t)b * Hkv + h) * S + split) * gk;
  for (int i = threadIdx.x; i < gk * hd; i += blockDim.x) {
    const int r = i / hd;
    out[row0 * hd + i] = acc[i] / fmaxf(l_s[r], 1e-30f);
  }
  for (int r = threadIdx.x; r < gk; r += blockDim.x) {
    m_out[row0 + r] = m_s[r];
    l_out[row0 + r] = l_s[r];
  }
}

// ---------------------------------------------------------------------------
// split-KV reduce: one block per (kv head, request), threads over (gk, hd)
// ---------------------------------------------------------------------------

// Folds the S span partials: m = max_s m_s, w_s = exp(m_s - m) * l_s,
// out = sum_s o_s * w_s / max(sum_s w_s, 1e-30).  A neutral span
// (0, NEG_INF, 0) contributes nothing.
__global__ void __launch_bounds__(kReduceThreads)
decode_reduce_kernel(const float* __restrict__ o, const float* __restrict__ m,
                     const float* __restrict__ l, float* __restrict__ o_out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Hkv, int S, int gk, int hd) {
  const size_t bh = (size_t)blockIdx.y * Hkv + blockIdx.x;
  const float* ob = o + bh * S * gk * hd;
  const float* mb = m + bh * S * gk;
  const float* lb = l + bh * S * gk;
  for (int i = threadIdx.x; i < gk * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    float mx = kNegInf;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, mb[s * gk + r]);
    float lsum = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = expf(mb[s * gk + r] - mx) * lb[s * gk + r];
      lsum += w;
      acc += ob[((size_t)s * gk + r) * hd + d] * w;
    }
    o_out[bh * gk * hd + i] = acc / fmaxf(lsum, 1e-30f);
    if (d == 0) {
      m_out[bh * gk + r] = mx;
      l_out[bh * gk + r] = lsum;
    }
  }
}

// ---------------------------------------------------------------------------
// paged prefill: one block per (query block, kv head, request)
// ---------------------------------------------------------------------------

// q (B, Hq, Sq, hd), Hq = Hkv * group; the block holds the R = group * bq
// rows r = g * bq + i of query block iq (query index iq*bq + i; rows past Sq
// are zero and never written).  out (B, Hq, Sq, hd) fp32, m/l (B, Hq, Sq).
// Key position j*ps + t is attended iff < prefix_lens[b] (and, with a
// window, > q_starts[b] + query index - window); pages past the prefix are
// skipped (bit-identical: they would be wholly masked).
template <typename T>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ prefix_lens,
                     const int* __restrict__ q_starts, float* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Hkv, int group, int Sq, int hd, int N, int ps, int MB,
                     int bq, int window, float scale) {
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int R = group * bq;
  const int hdp = hd + 1;
  const int Hq = Hkv * group;
  extern __shared__ float smem[];
  float* q_s = smem;                   // R * hdp
  float* k_s = q_s + R * hdp;          // ps * hdp
  float* v_s = k_s + ps * hdp;         // ps * hd
  float* p_s = v_s + ps * hd;          // R * ps
  float* acc = p_s + R * ps;           // R * hd
  float* m_s = acc + R * hd;           // R
  float* l_s = m_s + R;                // R
  float* a_s = l_s + R;                // R

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int g = r / bq, qi = iq * bq + (r - g * bq);
    float v = 0.f;
    if (qi < Sq)
      v = to_float(q[(((size_t)b * Hq + h * group + g) * Sq + qi) * hd + d]);
    q_s[r * hdp + d] = v;
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int prefix_len = prefix_lens[b];
  const int q0 = q_starts[b] + iq * bq;        // absolute position of row i=0
  const int n_pages = prefix_len <= 0 ? 0 : min(MB, (prefix_len + ps - 1) / ps);
  for (int j = 0; j < n_pages; ++j) {
    int page = block_tables[(size_t)b * MB + j];
    page = min(max(page, 0), N - 1);           // -1 pads alias page 0
    load_page(k_pages, v_pages, page, h, ps, Hkv, hd, k_s, v_s);
    __syncthreads();
    const int kbase = j * ps;
    softmax_page(q_s, k_s, v_s, p_s, acc, m_s, l_s, a_s, R, ps, hd, scale,
                 [=](int r, int t) {
                   const int kpos = kbase + t;
                   // causality vs the prefix is implied: every valid prefix
                   // position is < q_start <= the query's position
                   bool ok = kpos < prefix_len;
                   if (window) ok = ok && kpos > q0 + (r % bq) - window;
                   return ok;
                 });
  }

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const int g = r / bq, qi = iq * bq + (r - g * bq);
    if (qi < Sq)
      out[(((size_t)b * Hq + h * group + g) * Sq + qi) * hd + d] =
          acc[i] / fmaxf(l_s[r], 1e-30f);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int g = r / bq, qi = iq * bq + (r - g * bq);
    if (qi < Sq) {
      const size_t o = ((size_t)b * Hq + h * group + g) * Sq + qi;
      m_out[o] = m_s[r];
      l_out[o] = l_s[r];
    }
  }
}

// bfloat16 paged prefill: the tensor-core tile loop of flash_tc.cuh.  The
// R = group * bq rows of (query block iq, kv head h) are cut into blocks of
// 64 (one when group <= 64); grid (query blocks * row blocks, Hkv, B).  Key
// position j is attended iff j < min(prefix_len, MB * ps) and, with a
// window, j > q0 + i - window; tiles wholly past the prefix or wholly below
// every row's window are skipped (exact: they would be wholly masked).
template <int KD, bool kExact>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(KD, 1))
paged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pages,
                        const __nv_bfloat16* __restrict__ v_pages,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ prefix_lens,
                        const int* __restrict__ q_starts,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int Hkv, int group, int Sq,
                        int hd, int N, int ps, int MB, int bq, int window,
                        float scale_log2, int vec) {
  const int R = group * bq, nrb = (R + kTcRows - 1) / kTcRows;
  const int iq = blockIdx.x / nrb, row_base = (blockIdx.x % nrb) * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Hq = Hkv * group;
  const int klen = max(0, min(prefix_lens[b], MB * ps));
  const int q0 = q_starts[b] + iq * bq;        // absolute position of row i=0
  const int t_end = (klen + kTcKeys - 1) / kTcKeys;
  const int t_begin =
      window ? min(t_end, max(0, q0 - window + 1) / kTcKeys) : 0;
  const int* bt = block_tables + (size_t)b * MB;

  // row r of the block is row_base + r = g * bq + i of the group's rows;
  // its element offset in q and out, or -1 past R or Sq
  auto q_row = [=](int r) -> long long {
    const int rr = row_base + r;
    if (rr >= R) return -1;
    const int g = rr / bq, qi = iq * bq + (rr - g * bq);
    if (qi >= Sq) return -1;
    return (((long long)b * Hq + h * group + g) * Sq + qi) * hd;
  };
  extern __shared__ __align__(16) unsigned char tc_smem[];
  flash_tc_block<KD, 1, kExact>(
      reinterpret_cast<__nv_bfloat16*>(tc_smem), q, k_pages, v_pages, hd,
      vec != 0, scale_log2, t_begin, t_end, q_row,
      [=](int key) -> long long {
        if (key >= klen) return -1;
        const int j = key / ps;
        const int page = min(max(__ldg(bt + j), 0), N - 1);  // -1 pads: page 0
        return (((long long)page * ps + (key - j * ps)) * Hkv + h) * hd;
      },
      [=](int r, int key) {
        // causality vs the prefix is implied: every valid prefix position
        // is < q_start <= the query's position
        bool ok = key < klen;
        if (window) ok = ok && key > q0 + (row_base + r) % bq - window;
        return ok;
      },
      [=](int k0) {  // every row (query index < bq) attends k0 .. k0 + 63
        return k0 + kTcKeys <= klen && (!window || k0 > q0 + bq - 1 - window);
      },
      [=](int r, int d, float x0, float x1) {
        const long long o = q_row(r);
        if (o < 0) return;
        float* p = out + o + d;
        if (d + 1 < hd && !(hd & 1)) {
          *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
        } else {
          if (d < hd) p[0] = x0;
          if (d + 1 < hd) p[1] = x1;
        }
      },
      [=](int r, float m, float l) {
        const long long o = q_row(r);
        if (o < 0) return;
        m_out[o / hd] = m;
        l_out[o / hd] = l;
      });
}

// Raise a kernel's dynamic shared-memory limit past the 48 KB default when a
// launch needs it.  Each kernel instantiation remembers the largest limit it
// has set, so steady-state launches (and CUDA-graph captures) make no call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* k_pages,
                          const void* v_pages, const int* block_tables,
                          const int* lengths, float* out, float* m, float* l,
                          int B, int Hkv, int gk, int K, int hd, int N, int ps,
                          int MB, int S, int pps, int window, int guard,
                          float scale, cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t smem = smem_floats(gk, ps, hd) * sizeof(float);
  cudaError_t e = allow_smem(paged_decode_kernel<T>, smem, &allowed);
  if (e != cudaSuccess) return e;
  paged_decode_kernel<T><<<dim3(S, Hkv, B), kDecodeThreads, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, block_tables, lengths,
      out, m, l, Hkv, gk, K, hd, N, ps, MB, S, pps, window, guard, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prefill(const void* q, const void* k_pages,
                           const void* v_pages, const int* block_tables,
                           const int* prefix_lens, const int* q_starts,
                           float* out, float* m, float* l, int B, int Hkv,
                           int group, int Sq, int hd, int N, int ps, int MB,
                           int bq, int window, float scale,
                           cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t smem = smem_floats(group * bq, ps, hd) * sizeof(float);
  cudaError_t e = allow_smem(paged_prefill_kernel<T>, smem, &allowed);
  if (e != cudaSuccess) return e;
  const int nq = (Sq + bq - 1) / bq;
  paged_prefill_kernel<T><<<dim3(nq, Hkv, B), kPrefillThreads, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages, block_tables,
      prefix_lens, q_starts, out, m, l, Hkv, group, Sq, hd, N, ps, MB, bq,
      window, scale);
  return cudaGetLastError();
}

template <int KD, bool kExact>
cudaError_t launch_prefill_tc(const void* q, const void* k_pages,
                              const void* v_pages, const int* block_tables,
                              const int* prefix_lens, const int* q_starts,
                              float* out, float* m, float* l, int B, int Hkv,
                              int group, int Sq, int hd, int N, int ps, int MB,
                              int bq, int window, int vec, float scale,
                              cudaStream_t stream) {
  static size_t allowed = 0;
  const size_t smem = tc_smem_bytes(hd, 1);
  cudaError_t e =
      allow_smem(paged_prefill_tc_kernel<KD, kExact>, smem, &allowed);
  if (e != cudaSuccess) return e;
  const int nq = (Sq + bq - 1) / bq;
  const int nrb = (group * bq + kTcRows - 1) / kTcRows;
  paged_prefill_tc_kernel<KD, kExact>
      <<<dim3(nq * nrb, Hkv, B), kTcThreads, smem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
          (const __nv_bfloat16*)v_pages, block_tables, prefix_lens, q_starts,
          out, m, l, Hkv, group, Sq, hd, N, ps, MB, bq, window,
          scale * kLog2e, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes a CUDA-core block of R query rows needs (the wrappers
// check it against the card's per-block limit before launching).
long long paged_attention_smem_bytes(int R, int ps, int hd) {
  return (long long)(smem_floats(R, ps, hd) * sizeof(float));
}

int paged_decode(int dtype, const void* q, const void* k_pages,
                 const void* v_pages, const void* block_tables,
                 const void* lengths, void* out, void* m, void* l, int B,
                 int Hkv, int gk, int K, int hd, int N, int ps, int MB, int S,
                 int pps, int window, int guard, float scale, void* stream) {
  auto st = (cudaStream_t)stream;
  auto bt = (const int*)block_tables;
  auto ln = (const int*)lengths;
  if (dtype == 0)
    return (int)launch_decode<float>(q, k_pages, v_pages, bt, ln, (float*)out,
                                     (float*)m, (float*)l, B, Hkv, gk, K, hd,
                                     N, ps, MB, S, pps, window, guard, scale,
                                     st);
  if (dtype == 1)
    return (int)launch_decode<__nv_bfloat16>(
        q, k_pages, v_pages, bt, ln, (float*)out, (float*)m, (float*)l, B, Hkv,
        gk, K, hd, N, ps, MB, S, pps, window, guard, scale, st);
  return (int)cudaErrorInvalidValue;
}

int decode_reduce(const void* o, const void* m, const void* l, void* o_out,
                  void* m_out, void* l_out, int B, int Hkv, int S, int gk,
                  int hd, void* stream) {
  decode_reduce_kernel<<<dim3(Hkv, B), kReduceThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)o, (const float*)m, (const float*)l, (float*)o_out,
      (float*)m_out, (float*)l_out, Hkv, S, gk, hd);
  return (int)cudaGetLastError();
}

// vec: hd % 8 == 0 and q and the pools 16-byte aligned (bf16 only:
// cp.async chunks)
int paged_prefill(int dtype, const void* q, const void* k_pages,
                  const void* v_pages, const void* block_tables,
                  const void* prefix_lens, const void* q_starts, void* out,
                  void* m, void* l, int B, int Hkv, int group, int Sq, int hd,
                  int N, int ps, int MB, int bq, int window, int vec,
                  float scale, void* stream) {
  auto st = (cudaStream_t)stream;
  auto bt = (const int*)block_tables;
  auto pl = (const int*)prefix_lens;
  auto qs = (const int*)q_starts;
  if (dtype == 0)
    return (int)launch_prefill<float>(q, k_pages, v_pages, bt, pl, qs,
                                      (float*)out, (float*)m, (float*)l, B,
                                      Hkv, group, Sq, hd, N, ps, MB, bq,
                                      window, scale, st);
  if (dtype == 1)
    return (int)tc_dispatch_hd(hd, [&](auto kd, auto exact) {
      return launch_prefill_tc<decltype(kd)::value, decltype(exact)::value>(
          q, k_pages, v_pages, bt, pl, qs, (float*)out, (float*)m, (float*)l,
          B, Hkv, group, Sq, hd, N, ps, MB, bq, window, vec, scale, st);
    });
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
