// Paged attention kernels of the port's serving path, hand-written for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (repro_torch/kernels/native.py).  Three kernels:
//
//   paged_decode   replaces repro/kernels/flash_decode.py::_decode_kernel,
//                  and at S > 1 spans also _decode_reduce_kernel: the fold
//                  runs inside the decode launch (fold_tile below)
//   decode_reduce  the same fold as a launch of its own, over given partials
//   paged_prefill  replaces repro/kernels/flash_prefill_paged.py::_prefill_kernel
//
// Decode is bound by bytes: every resident K/V page is read once per step and
// a query row does ~4 FLOPs per byte read (at K = 1, ~13 TFLOP/s of fp32 keep
// 3.35 TB/s busy: a fifth of the CUDA cores, so tensor cores buy nothing).
// What the card needs is bytes in flight, ~25 KB an SM, and every lane busy.
// The design: a block of 8 warps per (span, kv head, request, 4-row tile).
//   - The warps split the span's pages round-robin (page jj to warp jj % 8).
//     Each warp keeps the running softmax state of the 4 rows in registers
//     and walks its pages with a three-stage cp.async ring of its own:
//     16-byte copies, neighbouring lanes on neighbouring addresses, two
//     batches of 8 KB a warp in flight (128 KB a block) while it computes a
//     third.  A lane reads back only what it copied, so the ring needs no
//     barrier.  (hd off the 16-byte grid or an unaligned pool takes
//     synchronous element loads into the same layout.)
//   - A lane owns 8 consecutive head dims of a key: 16 lanes cover a key row
//     up to hd 128 (a warp reads 2 keys per 16-byte load), 32 up to hd 256.
//     Scores are lane FMAs in fp32; a reduce-scatter over the key's lanes
//     leaves each lane one or two complete scores, so the mask and the exp
//     run once per score, and p goes back to the key's lanes through a
//     256-byte buffer a warp for p @ V, which accumulates each lane's 8
//     columns over its keys.
//   - The running max moves lazily: the state is rescaled only when a score
//     passes it by more than a factor 2^8 (one warp vote a batch, where an
//     eager step would reduce every row's max across lanes), and once at the
//     end to each row's largest score, so (m, l) keep the reference's
//     meaning.
//   - The warps merge once, through shared memory, with the
//     merge_softmax_states rule, in warp order, and write one partial a span.
//     The warp-to-page assignment and the merge order do not depend on the
//     dead-page guard, and a dead page leaves a warp's state bit-identical
//     (alpha is exactly 1, p exactly 0), so the guard stays bit-identical.
//   - A short grid (one long request, one tp rank's heads) leaves SMs idle:
//     the launch then puts a thread-block cluster of 2, 4 or 8 blocks on each
//     span (the largest whose clusters all fit the card at once), their warps
//     splitting its pages, and the cluster merges in rank order through
//     distributed shared memory: still one launch and one partial a span.
//   - With S > 1 spans the launch folds its own partials (the split-KV
//     reduce, which as a launch of its own cost more than its work: ~4 us
//     on an H100 against a 0.1 us bound).  Each block writes its share of a span's
//     partial to the caller's scratch, fences, and counts itself in with one
//     atomicAdd on the (request, kv head, row tile)'s arrival counter; the
//     block that arrives last (S * C arrivals close a tile) reads the S
//     partials back through L2 and folds them in span order, then puts the
//     counter back to 0 for the next launch (or graph replay).  The fold's
//     order depends on the shapes only, so the result is the same bits
//     whichever block arrives last, and those of the standalone reduce.
//   - Arithmetic is fp32 for both dtypes; bf16 takes exp2 on the SFU in log2
//     units, fp32 the accurate expf (its tolerance is 1e-5).  The fold takes
//     expf for both, with every rounding spelled out.
//   - Limits: hd <= 256 (32 lanes x 8 dims).  Any number of query rows: each
//     4-row tile is a block of its own, re-reading the span from L2.  The
//     shared memory is one constexpr count (kDecSmemBytes) asserted to fit
//     at compile time.
// Measured on an H100, the walk is bound by the latency of each warp's
// dependent shuffle and FMA chain (236 registers a thread leave two warps a
// scheduler) and a block's fixed cost, not by bytes.
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
//   - float32: paged_prefill_kernel, a CUDA-core page loop with the softmax
//     state in shared memory (TF32 would keep three digits, against fp32's
//     1e-5 tolerance).
//
// Every entry returns cudaGetLastError() after its launch; the Python wrapper
// raises on a non-zero code.  dtype codes: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // finite, so an empty span folds NaN-free
constexpr int kPrefillThreads = 256;

// The fp32 paged prefill's page step (paged_prefill_kernel below).
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

// Shared-memory floats of a CUDA-core prefill block holding R query rows (see
// the carve-up in paged_prefill_kernel; the host asks for the same number).
__host__ __device__ inline size_t smem_floats(int R, int ps, int hd) {
  return (size_t)R * (hd + 1) + (size_t)ps * (hd + 1) + (size_t)ps * hd +
         (size_t)R * ps + (size_t)R * hd + 3 * (size_t)R;
}

// ---------------------------------------------------------------------------
// decode: 8 warps per (span, kv head, request, 4-row tile)
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecRows = 4;                 // query rows of a block
constexpr int kDecDims = 8;                 // consecutive head dims of a lane
constexpr int kDecMaxHd = 32 * kDecDims;    // 256
constexpr int kDecStages = 3;               // cp.async ring of each warp
// one stage of a warp: 8 16-byte pieces a lane of K, then of V (8 key slots
// of one piece in bf16, 4 of two in fp32), piece-major: [piece][lane]
constexpr int kDecStageVecs = 2 * 8 * 32;   // uint4s
constexpr size_t kDecRingBytes =
    (size_t)kDecWarps * kDecStages * kDecStageVecs * sizeof(uint4);
// the merge buffers (aliasing the ring once every warp is done): m, l and
// acc of each warp's rows, then the block's, which the cluster's ranks read
constexpr size_t kDecMergeBytes =
    (size_t)(kDecWarps + 1) * kDecRows * (kDecMaxHd + 2) * sizeof(float);
constexpr int kDecMaxCluster = 8;           // blocks sharing one span
// each warp's probabilities of a batch, [key group][row * slots + slot],
// after the ring (the loop uses both)
constexpr size_t kDecPBytes = (size_t)kDecWarps * 2 * 32 * sizeof(float);
constexpr size_t kDecSmemBytes = kDecRingBytes + kDecPBytes > kDecMergeBytes
                                     ? kDecRingBytes + kDecPBytes
                                     : kDecMergeBytes;
static_assert(kDecSmemBytes <= kTcMaxSmemBytes,
              "the decode block's shared memory must fit the card's 227 KB");

// ---------------------------------------------------------------------------
// split-KV fold: one 4-row tile of one (request, kv head), a block of
// kDecThreads; the decode launch's last block of a tile and the standalone
// decode_reduce_kernel both run it
// ---------------------------------------------------------------------------

constexpr int kFoldSpans = 256;             // span weights held at a time
constexpr int kFoldElems = 4;               // (row, dim) elements a thread
constexpr int kFoldPre = 8;                 // spans of them loaded up front
constexpr size_t kFoldSmemBytes =
    (size_t)kDecRows * (kFoldSpans + 1) * sizeof(float);   // ws, then mxs
static_assert(kFoldSmemBytes + sizeof(int) <= kDecSmemBytes,
              "the fold reuses the decode block's shared memory");

// Folds the S span partials o (.., S, gk, hd), m/l (.., S, gk) of rows
// row0 .. row0 + rows - 1 of (request, kv head) bh into o_out (.., gk, hd),
// m_out/l_out (.., gk):
//   m = max_s m_s,  w_s = exp(m_s - m) * l_s,  l = sum_s w_s,
//   out = (sum_s o_s * w_s) / max(l, 1e-30),
// each w_s once per (row, span), by warp r for row r, into shared memory;
// the sums in span order 0 .. S-1 with every rounding spelled out (no
// contraction left to the compiler), so every caller gets the same bits
// from the same partials.  A neutral span (0, NEG_INF, 0) contributes
// nothing.  The partials are read through L2 (ld.global.cg): in the decode
// launch other blocks wrote them.  The fold sits at the end of a launch, on
// its critical path, so every load it needs (each row's first 32 spans' m
// and l, each thread's elements of the first kFoldPre spans) is asked for
// before anything waits: one round trip to L2 up to S = 8.  ws:
// kFoldSmemBytes of shared memory.
__device__ __forceinline__ void fold_tile(
    const float* o, const float* m, const float* l, float* __restrict__ o_out,
    float* __restrict__ m_out, float* __restrict__ l_out, size_t bh, int S,
    int gk, int hd, int row0, int rows, float* ws) {
  float* mxs = ws + kDecRows * kFoldSpans;         // [row]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const size_t pr = bh * S * gk + row0;            // (bh, span 0, row0)
  const size_t orow = bh * gk + row0;
  const int n_el = rows * hd;
  const bool row_warp = warp < rows;
  // (row, dim) elements in rounds of kFoldElems a thread (one round up to
  // hd 256)
  for (int e0 = 0; e0 < n_el; e0 += kFoldElems * kDecThreads) {
    float ov[kFoldElems][kFoldPre];
#pragma unroll
    for (int e = 0; e < kFoldElems; ++e) {
      const int i = e0 + e * kDecThreads + t;
      const int r = i / hd, d = i - r * hd;
      const float* op = o + ((pr + r) * hd + d);
#pragma unroll
      for (int s = 0; s < kFoldPre; ++s)
        if (i < n_el && s < S) ov[e][s] = __ldcg(op + (size_t)s * gk * hd);
    }
    // warp r: row r's max over the spans, lane s holding span s's m and l
    float mv = kNegInf, lv = 0.f, mx = kNegInf;
    if (row_warp) {
      const float* mr = m + pr + warp;
      if (lane < S) {
        mv = __ldcg(mr + (size_t)lane * gk);
        lv = __ldcg(l + pr + warp + (size_t)lane * gk);
      }
      mx = mv;
      for (int s = lane + 32; s < S; s += 32)
        mx = fmaxf(mx, __ldcg(mr + (size_t)s * gk));
      mx = warp_max(mx);
      if (lane == 0) mxs[warp] = mx;
    }
    // each element's l is its row's, summed by the element's thread
    float acc[kFoldElems], lsum[kFoldElems];
#pragma unroll
    for (int e = 0; e < kFoldElems; ++e) acc[e] = lsum[e] = 0.f;
    for (int s0 = 0; s0 < S; s0 += kFoldSpans) {
      const int n = min(kFoldSpans, S - s0);
      if (s0 > 0) __syncthreads();                 // the last weights' reads
      if (row_warp)
        for (int s = lane; s < n; s += 32) {
          const size_t j = pr + warp + (size_t)(s0 + s) * gk;
          const bool held = s0 == 0 && s < 32;
          ws[warp * kFoldSpans + s] =
              __fmul_rn(expf((held ? mv : __ldcg(m + j)) - mx),
                        held ? lv : __ldcg(l + j));
        }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kFoldElems; ++e) {
        const int i = e0 + e * kDecThreads + t;
        if (i < n_el) {
          const int r = i / hd, d = i - r * hd;
          const float* wr = ws + r * kFoldSpans;
          int s = 0;
          if (s0 == 0) {
#pragma unroll
            for (int p = 0; p < kFoldPre; ++p)
              if (p < n) {
                acc[e] = __fmaf_rn(ov[e][p], wr[p], acc[e]);
                lsum[e] = __fadd_rn(lsum[e], wr[p]);
              }
            s = kFoldPre;
          }
          const float* op = o + ((pr + (size_t)s0 * gk + r) * hd + d);
          for (; s < n; ++s) {
            acc[e] = __fmaf_rn(__ldcg(op + (size_t)s * gk * hd), wr[s],
                               acc[e]);
            lsum[e] = __fadd_rn(lsum[e], wr[s]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kFoldElems; ++e) {
      const int i = e0 + e * kDecThreads + t;
      if (i < n_el) {
        o_out[orow * hd + i] = acc[e] / fmaxf(lsum[e], 1e-30f);
        const int r = i / hd;
        if (i == r * hd) {
          m_out[orow + r] = mxs[r];
          l_out[orow + r] = lsum[e];
        }
      }
    }
    if (e0 + kFoldElems * kDecThreads < n_el) __syncthreads();  // next round
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// e^x (fp32: accurate expf) or 2^x (bf16: ex2.approx, scores in log2 units)
template <bool kLog2>
__device__ __forceinline__ float dec_exp(float x) {
  return kLog2 ? fast_exp2(x) : expf(x);
}

// A lane's 8 dims of one key slot, from its own pieces of a stage, in fp32
template <typename T>
__device__ __forceinline__ void dec_unpack(const uint4* slot, int lane,
                                           float (&x)[kDecDims]) {
  constexpr int P = kDecDims * (int)sizeof(T) / 16;
#pragma unroll
  for (int p = 0; p < P; ++p)
    Vec<T>::unpack(slot[p * 32 + lane], x + p * Vec<T>::N);
}

// Copy one batch of a page into a warp's stage: key slot s of this lane is
// the page row (sb * keys a batch) + s * kpi + sub, at element offset
// page_off + slot_off[s] of the pools (the lane's dims, chunk * 8 .. + 8,
// included); a slot at or past the page's `lim` rows, and dims past hd, are
// zeros.  kVec: cp.async 16-byte pieces (hd a multiple of a piece, 16-byte
// aligned pools); otherwise synchronous element loads.
template <typename T, bool kVec, int SL>
__device__ __forceinline__ void dec_issue(uint4* stage,
                                          const T* __restrict__ k_pages,
                                          const T* __restrict__ v_pages,
                                          size_t page_off,
                                          const int (&slot_off)[SL], int lim,
                                          int kpi, int sub, int d_lane,
                                          int lane, int hd) {
  constexpr int P = kDecDims * (int)sizeof(T) / 16;
  constexpr int E = 16 / (int)sizeof(T);
  using Bits = typename std::conditional<sizeof(T) == 2, unsigned short,
                                         unsigned int>::type;
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const bool row_ok = s * kpi + sub < lim;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int idx = (s * P + p) * 32 + lane;
      const size_t off = page_off + slot_off[s] + p * E;
      if (kVec) {
        const bool ok = row_ok && d_lane + p * E < hd;
        cp_async16(smem_u32(stage + idx), k_pages + (ok ? off : 0),
                   ok ? 16 : 0);
        cp_async16(smem_u32(stage + 8 * 32 + idx), v_pages + (ok ? off : 0),
                   ok ? 16 : 0);
      } else {
        const Bits* kb = reinterpret_cast<const Bits*>(k_pages) + off;
        const Bits* vb = reinterpret_cast<const Bits*>(v_pages) + off;
        alignas(16) Bits kx[E], vx[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool ok = row_ok && d_lane + p * E + e < hd;
          kx[e] = ok ? kb[e] : Bits(0);
          vx[e] = ok ? vb[e] : Bits(0);
        }
        stage[idx] = *reinterpret_cast<const uint4*>(kx);
        stage[8 * 32 + idx] = *reinterpret_cast<const uint4*>(vx);
      }
    }
  }
}

// Sum a lane's V score shares over the lanes of their key by a
// reduce-scatter: at level k (lanes 2^k apart) a lane keeps half of the c
// scores it holds (the upper half if its bit k is set) and adds its
// partner's share of that half, while c >= 2; past that, a plain exchange.
// Afterwards s[0 .. max(V >> L, 1)) are complete.
template <int V, int L, int k = 0>
__device__ __forceinline__ void dec_scatter(float (&s)[V], int lane) {
  if constexpr (k < L) {
    constexpr int c = V >> k;
    if constexpr (c >= 2) {
      const bool hi = (lane >> k) & 1;
#pragma unroll
      for (int i = 0; i < c / 2; ++i) {
        const float send = hi ? s[i] : s[i + c / 2];
        const float keep = hi ? s[i + c / 2] : s[i];
        s[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << k);
      }
    } else {
      s[0] += __shfl_xor_sync(0xffffffffu, s[0], 1 << k);
    }
    dec_scatter<V, L, k + 1>(s, lane);
  }
}

// q (B, Hkv, gk, hd) with row r = g*K + qi; out (B, Hkv, S, gk, hd) fp32,
// m/l (B, Hkv, S, gk) fp32.  Grid (S * row tiles * C, Hkv, B) in clusters
// of C blocks along x: the C blocks of a cluster share one (span, tile), their
// 8 * C warps taking its pages round-robin.  kFold (S > 1): out/m/l are
// scratch and the tile's last block folds them into fo (B, Hkv, gk, hd),
// fm/fl (B, Hkv, gk); arrivals[(b * Hkv + h) * tiles + tile] counts the
// blocks done, 0 between launches.  (An instantiation of its own: compiled
// with the fold's code, the walk ran ~30% slower on an H100.)  Span `split`
// walks page-walk indices j = split*pps + jj, jj < pps; indices >= MB (a
// ragged last span) read page 0 and are always masked (their key positions
// are >= MB*ps >= length).  With the guard, the walk stops at the resident
// pages: a dead page would leave every state unchanged.  LPK lanes cover a
// key row (16 up to hd 128, 32 up to 256).
template <typename T, int LPK, bool kFold>
__global__ void __launch_bounds__(kDecThreads, 1)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ fo, float* __restrict__ fm,
                    float* __restrict__ fl, int* __restrict__ arrivals,
                    int Hkv, int gk, int K, int hd, int N, int ps, int MB,
                    int S, int pps, int window, int guard, int vec,
                    float scale) {
  constexpr int P = kDecDims * (int)sizeof(T) / 16;
  constexpr int SL = 8 / P;                          // key slots of a batch
  constexpr int V = kDecRows * SL;                   // scores of a batch
  constexpr int KPI = 32 / LPK;                      // keys a slot, a warp
  constexpr int L = LPK == 16 ? 4 : 5;               // shuffle levels
  // a score's lane share is summed over the LPK lanes of its key by a
  // reduce-scatter: level k (lane bit k) halves the scores a lane holds while
  // it holds two or more, so after it a lane holds CF of them, complete
  constexpr int CF = (V >> L) > 0 ? (V >> L) : 1;
  // lane bit 4 of an fp32 key row of 32 lanes adds nothing left to halve:
  // those lanes hold copies, and a sum over lanes skips them
  constexpr bool kBit4Copies = LPK == 32 && (V >> 4) < 2;
  constexpr bool kLog2 = std::is_same<T, __nv_bfloat16>::value;
  // how far a score may pass the running max before the state is rescaled
  // (p <= 2^8 either way)
  constexpr float kSlack = kLog2 ? 8.f : 8.f * kLn2;
  static_assert(kDecRows == 4 && CF <= SL, "lane bits 0 and 1 pick the row");
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), crank = (int)cluster.block_rank();
  const int tiles = (gk + kDecRows - 1) / kDecRows;
  const int unit = blockIdx.x / C;                   // (span, row tile)
  const int split = unit / tiles;
  const int row0 = (unit - split * tiles) * kDecRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = crank * kDecWarps + warp, n_warps = C * kDecWarps;
  const int chunk = lane & (LPK - 1), sub = lane / LPK;
  constexpr int kb = SL * KPI;                       // keys per batch
  const int nb = (ps + kb - 1) / kb;                 // batches per page
  const int length = lengths[b];
  const float su = scale * (kLog2 ? kLog2e : 1.f);
  // the scores this lane holds after the reduce-scatter: r*SL + sl for
  // sl = my_sl .. my_sl + CF - 1 of row my_r (lane bits 0 and 1 pick the
  // row); row r's are also held by lane rep(r)
  int base = 0;
#pragma unroll
  for (int k = 0; k < L; ++k)
    if ((V >> k) >= 2) base += ((lane >> k) & 1) * (V >> (k + 1));
  const int my_r = base / SL, my_sl = base - my_r * SL;
  auto rep = [](int r) { return (r >> 1) | ((r & 1) << 1); };

  // page numbers of 32 of the warp's pages at a time, one a lane; the first
  // 32 are asked for before anything waits
  auto fill = [&](int wp0) {
    const int jj = gwarp + n_warps * (wp0 + lane);
    const int j = split * pps + jj;
    const int pg =
        (jj < pps && j < MB) ? __ldg(block_tables + (size_t)b * MB + j) : 0;
    return min(max(pg, 0), N - 1);                // -1 pads alias page 0
  };
  int pbase = 0, pcache = fill(0);
  auto page_of = [&](int wp) {
    if (wp >= pbase + 32) {
      pbase = wp;
      pcache = fill(wp);
    }
    return __shfl_sync(0xffffffffu, pcache, wp - pbase);
  };

  // this lane's 8 dims of each row of the tile
  float qr[kDecRows][kDecDims];
  const T* qb = q + ((size_t)b * Hkv + h) * gk * hd;
#pragma unroll
  for (int r = 0; r < kDecRows; ++r)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      constexpr int E = Vec<T>::N;
      const int d0 = chunk * kDecDims + p * E;
      const T* qp = qb + (size_t)(row0 + r) * hd + d0;
      if (vec && row0 + r < gk && d0 < hd) {   // hd is a multiple of E
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(qp), qr[r] + p * E);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          qr[r][p * E + e] =
              (row0 + r < gk && d0 + e < hd) ? to_float(qp[e]) : 0.f;
      }
    }
  // running state: m of every row (uniform over the warp; at most kSlack
  // below the row's largest score so far, mt over this lane's scores), acc
  // of every row over this lane's dims and its keys, l of row my_r over its
  // scores, both relative to m
  float m[kDecRows], acc[kDecRows][kDecDims], l_mine = 0.f;
  float m_mine = kNegInf, mt = kNegInf;
#pragma unroll
  for (int r = 0; r < kDecRows; ++r) {
    m[r] = kNegInf;
#pragma unroll
    for (int e = 0; e < kDecDims; ++e) acc[r][e] = 0.f;
  }

  // this warp's pages: jj = gwarp + n_warps * wp, wp < n_w
  int n_walk = pps;
  if (guard)
    n_walk = min(max((length + ps - 1) / ps - split * pps, 0), pps);
  const int n_w = n_walk > gwarp ? (n_walk - gwarp + n_warps - 1) / n_warps
                                 : 0;
  const int n_items = n_w * nb;

  extern __shared__ __align__(16) unsigned char dec_smem[];
  uint4* ring = reinterpret_cast<uint4*>(dec_smem) +
                (size_t)warp * kDecStages * kDecStageVecs;
  float* pw = reinterpret_cast<float*>(dec_smem + kDecRingBytes) +
              (warp * 2 + sub) * 32;
  // this lane's element offset in a page of each key slot of a batch
  const int row_stride = Hkv * hd;               // between a page's rows
  int slot_off[SL];
#pragma unroll
  for (int sl = 0; sl < SL; ++sl)
    slot_off[sl] = ((sl * KPI + sub) * Hkv + h) * hd + chunk * kDecDims;
  auto issue = [&](int it) {
    const int wp = nb == 1 ? it : it / nb, sb = it - wp * nb;
    uint4* stage = ring + (it % kDecStages) * kDecStageVecs;
    const size_t page_off =
        ((size_t)page_of(wp) * ps + sb * kb) * row_stride;
    if (vec)
      dec_issue<T, true, SL>(stage, k_pages, v_pages, page_off, slot_off,
                             ps - sb * kb, KPI, sub, chunk * kDecDims, lane,
                             hd);
    else
      dec_issue<T, false, SL>(stage, k_pages, v_pages, page_off, slot_off,
                              ps - sb * kb, KPI, sub, chunk * kDecDims, lane,
                              hd);
  };

#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (i < n_items) issue(i);
    cp_async_commit();
  }
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kDecStages - 2>();               // this lane's copies of it
    if (it + kDecStages - 1 < n_items) issue(it + kDecStages - 1);
    cp_async_commit();
    const uint4* st = ring + (it % kDecStages) * kDecStageVecs;
    const int wp = nb == 1 ? it : it / nb, sb = it - wp * nb;
    const int t0 = sb * kb + sub;                  // page row of slot 0
    const int kpos0 = (split * pps + gwarp + n_warps * wp) * ps + t0;

    // s[r*SL + sl]: this lane's 8-dim share of row r . key of slot sl
    float s[V];
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) {
      float kf[kDecDims];
      dec_unpack<T>(st + sl * P * 32, lane, kf);
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kDecDims; ++e) dot = fmaf(qr[r][e], kf[e], dot);
        s[r * SL + sl] = dot;
      }
    }
    dec_scatter<V, L>(s, lane);                    // s[0 .. CF) complete

    // mask (validity doubles as causality: every paged key sits at a
    // position < length <= length + qi), scale, this lane's max
    unsigned valid = 0;
    bool grow = false;
#pragma unroll
    for (int i = 0; i < CF; ++i) {
      const int kpos = kpos0 + (my_sl + i) * KPI;
      bool ok = t0 + (my_sl + i) * KPI < ps && kpos < length;
      if (window) ok = ok && kpos > length + (row0 + my_r) % K - window;
      s[i] = ok ? s[i] * su : kNegInf;
      valid |= (unsigned)ok << i;
      mt = fmaxf(mt, s[i]);
      grow = grow || s[i] > m_mine + kSlack;
    }
    // online softmax, lazily: the state moves to a new max only when a score
    // passes the old one by more than kSlack (always at a row's first key);
    // on a dead batch nothing moves and p is exactly 0
    if (__any_sync(0xffffffffu, grow)) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < CF; ++i) mx = fmaxf(mx, s[i]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)      // over the lanes of the row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float alpha_mine = 1.f;
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) {
        const float mn = fmaxf(m[r], __shfl_sync(0xffffffffu, mx, rep(r)));
        const float alpha = mn == m[r] ? 1.f : dec_exp<kLog2>(m[r] - mn);
        m[r] = mn;
#pragma unroll
        for (int e = 0; e < kDecDims; ++e) acc[r][e] *= alpha;
        if (r == my_r) {
          m_mine = mn;
          alpha_mine = alpha;
        }
      }
      l_mine *= alpha_mine;
    }
    // hand p back to every lane of the key through the warp's buffer
    __syncwarp();                                  // the last batch's reads
#pragma unroll
    for (int i = 0; i < CF; ++i) {
      const float p = (valid >> i) & 1u ? dec_exp<kLog2>(s[i] - m_mine) : 0.f;
      l_mine += p;
      pw[my_r * SL + my_sl + i] = p;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(pw)[i];
      s[4 * i] = x.x;
      s[4 * i + 1] = x.y;
      s[4 * i + 2] = x.z;
      s[4 * i + 3] = x.w;
    }
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) {
      float vf[kDecDims];
      dec_unpack<T>(st + 8 * 32 + sl * P * 32, lane, vf);
#pragma unroll
      for (int r = 0; r < kDecRows; ++r)
#pragma unroll
        for (int e = 0; e < kDecDims; ++e)
          acc[r][e] = fmaf(s[r * SL + sl], vf[e], acc[r][e]);
    }
  }
  cp_async_wait<0>();

  // move the state to each row's largest score (a row with no key keeps
  // (0, NEG_INF, 0))
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
#pragma unroll
  for (int r = 0; r < kDecRows; ++r) {
    const float mr = __shfl_sync(0xffffffffu, mt, rep(r));
    const float f = mr == m[r] ? 1.f : dec_exp<kLog2>(m[r] - mr);
    m[r] = mr;
#pragma unroll
    for (int e = 0; e < kDecDims; ++e) acc[r][e] *= f;
    if (r == my_r) l_mine *= f;
  }

  // the warp's state: l of each row summed over its lanes, acc over the
  // warp's keys (the KPI key groups)
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    if (!(kBit4Copies && o == 16))
      l_mine += __shfl_xor_sync(0xffffffffu, l_mine, o);
  float l[kDecRows];
#pragma unroll
  for (int r = 0; r < kDecRows; ++r)
    l[r] = __shfl_sync(0xffffffffu, l_mine, rep(r));
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < kDecRows; ++r)
#pragma unroll
      for (int e = 0; e < kDecDims; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  __syncthreads();                                 // every ring is drained
  float* ms = reinterpret_cast<float*>(dec_smem);  // [warp][row]
  float* ls = ms + kDecWarps * kDecRows;
  float* as = ls + kDecWarps * kDecRows;           // [warp][row][hd]
  // the block's state, [row] m and l then [row][hd] acc, for the cluster
  float* bs = as + kDecWarps * kDecRows * hd;
  if (sub == 0)
#pragma unroll
    for (int r = 0; r < kDecRows; ++r)
#pragma unroll
      for (int e = 0; e < kDecDims; ++e) {
        const int d = chunk * kDecDims + e;
        if (d < hd) as[(warp * kDecRows + r) * hd + d] = acc[r][e];
      }
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < kDecRows; ++r) {
      ms[warp * kDecRows + r] = m[r];
      ls[warp * kDecRows + r] = l[r];
    }
  __syncthreads();

  // merge the block's warps in warp order, then (C > 1) the cluster's
  // blocks in rank order: m = max_w m_w, c_w = exp(m_w - m), l = sum_w c_w
  // l_w, acc = sum_w c_w acc_w; out = acc / max(l, 1e-30).  A warp or block
  // that saw no key, (0, NEG_INF, 0), contributes nothing.
  const int rows = min(kDecRows, gk - row0);
  const size_t orow = (((size_t)b * Hkv + h) * S + split) * gk + row0;
  auto write = [&](int r, int d, float mx, float lsum, float a) {
    out[(orow + r) * hd + d] = a / fmaxf(lsum, 1e-30f);
    if (d == 0) {
      m_out[orow + r] = (kLog2 && mx != kNegInf) ? mx * kLn2 : mx;
      l_out[orow + r] = lsum;
    }
  };
  for (int i = threadIdx.x; i < rows * hd; i += kDecThreads) {
    const int r = i / hd, d = i - r * hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, ms[w * kDecRows + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float c = dec_exp<kLog2>(ms[w * kDecRows + r] - mx);
      lsum += c * ls[w * kDecRows + r];
      a += c * as[(w * kDecRows + r) * hd + d];
    }
    if (C == 1) {
      write(r, d, mx, lsum, a);
    } else {
      bs[2 * kDecRows + r * hd + d] = a;
      if (d == 0) {
        bs[r] = mx;
        bs[kDecRows + r] = lsum;
      }
    }
  }
  if (C > 1) {
    // the cluster: rank c merges every C-th block of elements, reading each
    // block's state through distributed shared memory
    cluster.sync();
    for (int i = crank * kDecThreads + threadIdx.x; i < rows * hd;
         i += C * kDecThreads) {
      const int r = i / hd, d = i - r * hd;
      float bm[kDecMaxCluster], bl[kDecMaxCluster], ba[kDecMaxCluster];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kDecMaxCluster; ++c)
        if (c < C) {
          const float* rb = cluster.map_shared_rank(bs, c);
          bm[c] = rb[r];
          bl[c] = rb[kDecRows + r];
          ba[c] = rb[2 * kDecRows + r * hd + d];
          mx = fmaxf(mx, bm[c]);
        }
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int c = 0; c < kDecMaxCluster; ++c)
        if (c < C) {
          const float w = dec_exp<kLog2>(bm[c] - mx);
          lsum += w * bl[c];
          a += w * ba[c];
        }
      write(r, d, mx, lsum, a);
    }
    cluster.sync();                // every block's state stays readable
  }
  if (!kFold) return;

  // the split-KV fold: this block's share of the span's partial is written
  // (the barrier orders every thread's stores before thread 0's fence,
  // which makes them visible device-wide before the block counts itself
  // in).  The block that closes the tile (S spans x C ranks) folds the
  // tile's S partials, then resets the counter for the next launch.
  int* arrived = arrivals + ((size_t)b * Hkv + h) * tiles + row0 / kDecRows;
  // past the fold's buffers in the (now free) dynamic shared memory
  int* closes = reinterpret_cast<int*>(dec_smem + kFoldSmemBytes);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *closes = atomicAdd(arrived, 1) == S * C - 1;
    if (*closes) __threadfence();  // the others' partials, before reading
  }
  __syncthreads();
  if (!*closes) return;
  fold_tile(out, m_out, l_out, fo, fm, fl, (size_t)b * Hkv + h, S, gk, hd,
            row0, rows, reinterpret_cast<float*>(dec_smem));
  if (threadIdx.x == 0) *arrived = 0;
}


// ---------------------------------------------------------------------------
// split-KV reduce as a launch of its own: one block per (4-row tile, kv head,
// request), the decode launch's fold over given partials
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kDecThreads)
decode_reduce_kernel(const float* o, const float* m, const float* l,
                     float* __restrict__ o_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int Hkv, int S, int gk,
                     int hd) {
  __shared__ float ws[kFoldSmemBytes / sizeof(float)];
  const int row0 = blockIdx.x * kDecRows;
  fold_tile(o, m, l, o_out, m_out, l_out, (size_t)blockIdx.z * Hkv + blockIdx.y,
            S, gk, hd, row0, min(kDecRows, gk - row0), ws);
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

// The decode launch in clusters of `cluster` blocks along x
cudaLaunchConfig_t dec_config(cudaLaunchAttribute* attr, dim3 grid,
                              int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = kDecSmemBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int LPK, bool kFold>
cudaError_t launch_decode(const void* q, const void* k_pages,
                          const void* v_pages, const int* block_tables,
                          const int* lengths, float* out, float* m, float* l,
                          float* fo, float* fm, float* fl, int* arrivals,
                          int B, int Hkv, int gk, int K, int hd, int N, int ps,
                          int MB, int S, int pps, int window, int guard,
                          int vec, float scale, cudaStream_t stream) {
  static size_t allowed = 0;
  // clusters of 2, 4, 8 blocks that fit the card at once (asked once): a
  // span gets the largest cluster with which the whole grid is one wave, so
  // a short grid (one long request, one rank's heads) fills more SMs; the
  // choice depends on the shapes only, never on the guard
  static int fits[kDecMaxCluster + 1] = {};
  auto kernel = paged_decode_kernel<T, LPK, kFold>;
  cudaError_t e = allow_smem(kernel, kDecSmemBytes, &allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const int units = S * ((gk + kDecRows - 1) / kDecRows) * Hkv * B;
  int cluster = 1;
  for (int c = 2; c <= kDecMaxCluster; c *= 2) {
    if (!fits[c]) {
      const cudaLaunchConfig_t cfg =
          dec_config(attr, dim3(c), c, stream);
      int n = 0;
      e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (e != cudaSuccess) return e;
      fits[c] = n > 0 ? n : -1;
    }
    if (units <= fits[c]) cluster = c;
  }
  const cudaLaunchConfig_t cfg = dec_config(
      attr, dim3(units / (Hkv * B) * cluster, Hkv, B), cluster, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, (const T*)k_pages,
                         (const T*)v_pages, block_tables, lengths, out, m, l,
                         fo, fm, fl, arrivals, Hkv, gk, K, hd, N, ps, MB, S,
                         pps, window, guard, vec, scale);
  if (e != cudaSuccess) return e;
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

// hd <= 256 (the wrapper checks it); vec: hd a multiple of 8 (bf16) or 4
// (fp32) values and q and both pools 16-byte aligned (cp.async pieces,
// 16-byte q loads).  arrivals != null (S > 1): out/m/l are scratch, the
// folded state goes to fo/fm/fl, and arrivals holds B * Hkv * ceil(gk / 4)
// counters, all 0.
int paged_decode(int dtype, const void* q, const void* k_pages,
                 const void* v_pages, const void* block_tables,
                 const void* lengths, void* out, void* m, void* l, void* fo,
                 void* fm, void* fl, void* arrivals, int B, int Hkv, int gk,
                 int K, int hd, int N, int ps, int MB, int S, int pps,
                 int window, int guard, int vec, float scale, void* stream) {
  if (gk < 1 || hd < 1 || hd > kDecMaxHd || (arrivals && S < 2))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto bt = (const int*)block_tables;
  auto ln = (const int*)lengths;
  auto launch = [&](auto tag, auto lpk) {
    using T = typename decltype(tag)::type;
    constexpr int kLpk = decltype(lpk)::value;
    auto go = [&](auto fold) {
      return (int)launch_decode<T, kLpk, decltype(fold)::value>(
          q, k_pages, v_pages, bt, ln, (float*)out, (float*)m, (float*)l,
          (float*)fo, (float*)fm, (float*)fl, (int*)arrivals, B, Hkv, gk, K,
          hd, N, ps, MB, S, pps, window, guard, vec, scale, st);
    };
    return arrivals ? go(std::true_type()) : go(std::false_type());
  };
  using f32 = std::common_type<float>;
  using bf16 = std::common_type<__nv_bfloat16>;
  using lpk16 = std::integral_constant<int, 16>;
  using lpk32 = std::integral_constant<int, 32>;
  const bool wide = hd > 16 * kDecDims;    // 32 lanes a key row past hd 128
  if (dtype == 0) return wide ? launch(f32(), lpk32()) : launch(f32(), lpk16());
  if (dtype == 1)
    return wide ? launch(bf16(), lpk32()) : launch(bf16(), lpk16());
  return (int)cudaErrorInvalidValue;
}

int decode_reduce(const void* o, const void* m, const void* l, void* o_out,
                  void* m_out, void* l_out, int B, int Hkv, int S, int gk,
                  int hd, void* stream) {
  if (gk < 1 || hd < 1) return (int)cudaErrorInvalidValue;
  decode_reduce_kernel<<<dim3((gk + kDecRows - 1) / kDecRows, Hkv, B),
                         kDecThreads, 0, (cudaStream_t)stream>>>(
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
