// The bf16 flash-attention tile loop on Hopper's tensor cores, shared by the
// dense flash-prefill kernel (flash_prefill.cu, replacing
// repro/kernels/flash_prefill.py::_flash_kernel) and the paged prefill kernel
// (paged_attention.cu, replacing
// repro/kernels/flash_prefill_paged.py::_prefill_kernel).  native.py hashes
// this header into both sources' build keys.
//
// What bounds both kernels on the card is operations: 4 * hd FLOPs per
// attended (query, key) pair against one read of q, k and v, at 989 TFLOP/s
// bf16 on the tensor cores.  The design (FlashAttention-2's, written with
// PTX): a block of 4 warps owns 64 query rows, 16 per warp (the paged
// kernel), or 128, 32 per warp (the dense one up to hd 128: each K and V
// fragment then feeds two mma), and walks 64-key tiles.
//   - Q, K and V stay bf16 in shared memory.  Rows are padded to an odd
//     number of 16-byte chunks (hd rounded up to 16, plus 8), so the 8 rows an
//     ldmatrix phase reads fall in 8 distinct 16-byte bank groups: conflict-
//     free for every hd that is a multiple of 16 (80 and 200 included), where
//     an XOR swizzle over 8 chunks would not divide the row.  At hd 128 a
//     64-row block takes 68 KB (a two-stage K/V ring; Q passes through it
//     into registers), so three fit on an SM; a 128-row block, 102 KB (Q
//     keeps a tile), two.
//   - cp.async.cg 16-byte copies fill the next K/V stage while the current
//     one is computed; a zero source size zero-fills rows past the keys and
//     columns past hd.  One barrier per stage.  (hd not a multiple of 8, or an
//     unaligned base, takes synchronous element loads into the same layout.)
//   - S = Q K^T with mma.sync m16n8k16 (bf16 in, fp32 sums) from ldmatrix
//     fragments; S stays in registers.
//   - The online softmax runs in registers in log2 units (scale * log2(e)
//     folded into one multiply, ex2.approx): a row's max and sum are reduced
//     over its quad with two shuffles.  In a tile that some row does not
//     wholly attend, a masked key gets -1e30 in the max and its p is
//     multiplied by the mask (a bit per score), so a fully masked row stays
//     (0, -1e30, 0); a tile every row attends skips the mask.  l sums the
//     fp32 p; m is written in natural units.
//   - O += P V: P is rounded to bf16 in registers and used as the A fragment
//     directly; V comes through ldmatrix.trans; O is fp32 in registers,
//     rescaled by alpha once per tile.
//   - Exact instantiations for hd rounding up to 64, 128 or 256: guards in
//     the unrolled loops would cut them into basic blocks that ptxas does
//     not interleave.  Other widths run the next larger one, guarded.
// The rounding this adds to the fp32 reference is P to bf16 before P V.
// mma.sync does not reach half of the bf16 peak: the remaining headroom is
// Hopper's wgmma fed by TMA loads under mbarriers (warp-specialised).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTcThreads = 128;          // 4 warps
constexpr int kTcRows = 64;              // query rows of an m-tile row of warps
constexpr int kTcKeys = 64;              // keys of a tile
constexpr float kTcNegInf = -1e30f;      // finite: an empty row stays NaN-free
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the card's per-block shared-memory limit (H100: 227 KB)
constexpr size_t kTcMaxSmemBytes = 232448;

// hd rounded up to the mma depth, and the padded smem row stride (elements)
__host__ __device__ constexpr int tc_hd16(int hd) { return (hd + 15) & ~15; }
__host__ __device__ constexpr int tc_stride(int hd) { return tc_hd16(hd) + 8; }

// Q stays in registers (one 16-row m-tile a warp, up to hd 128) or in smem
__host__ __device__ constexpr bool tc_q_in_regs(int KD, int kM) {
  return kM == 1 && KD <= 8;
}

// Shared-memory bytes of a block whose warps own kM m-tiles (64 * kM rows):
// two stages of 64-key K and V tiles, and a Q tile of 64 * kM rows unless Q
// is held in registers (it is then staged in the second K/V stage before the
// first tile); every row tc_stride(hd) bf16 values.  kM 1: 68 KB at hd 128
// (three blocks an SM), 165 KB at hd 256; kM 2: 102 KB at hd 128 (two).
// Every instantiation asserts at compile time that its widest hd fits.
__host__ __device__ constexpr size_t tc_smem_bytes(int hd, int kM) {
  const bool q_regs = tc_q_in_regs(tc_hd16(hd) <= 128 ? 8 : 16, kM);
  return (size_t)(4 + (q_regs ? 0 : kM)) * kTcRows * tc_stride(hd) *
         sizeof(__nv_bfloat16);
}

// Blocks an SM an instantiation is built for (its register budget)
__host__ __device__ constexpr int tc_min_blocks(int KD, int kM) {
  return KD > 8 ? 1 : (kM == 1 ? 3 : 2);
}

// Call launch(KD, kExact) (std::integral_constant arguments) with the
// instantiation that takes head_dim hd: exact ones for hd rounding up to 64,
// 128 or 256 (guards in the unrolled loops would cut them into basic blocks
// that ptxas does not interleave), the next larger one, guarded, for other
// widths up to 256.
template <int KD>
using tc_kd = std::integral_constant<int, KD>;

template <typename Launch>
cudaError_t tc_dispatch_hd(int hd, Launch launch) {
  using kd4 = tc_kd<4>;
  using kd8 = tc_kd<8>;
  using kd16 = tc_kd<16>;
  using std::false_type;
  using std::true_type;
  switch (tc_hd16(hd) / 16) {
    case 4: return launch(kd4(), true_type());
    case 8: return launch(kd8(), true_type());
    case 16: return launch(kd16(), true_type());
    case 1: case 2: case 3: return launch(kd4(), false_type());
    case 5: case 6: case 7: return launch(kd8(), false_type());
    case 9: case 10: case 11: case 12: case 13: case 14: case 15:
      return launch(kd16(), false_type());
    default:
      return cudaErrorInvalidValue;  // hd > 256: the wrappers refuse it
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the SFU (ex2.approx, relative error ~2^-22); -1e30 gives +0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copy `rows` rows (64 or 128) into padded bf16 smem tiles: row r of dst0
// (and of dst1, when kTwo) comes from src + off(r); off(r) < 0 and columns
// past hd are zeros.  vec: hd % 8 == 0 and 16-byte aligned bases, so
// cp.async 16-byte chunks; otherwise synchronous element loads into the same
// layout.  kd: hd rounded up to 16, over 16; a thread copies rows / 64 * kd
// chunks (a compile-time count when kd is).
template <bool kTwo, typename Off>
__device__ __forceinline__ void tc_load(__nv_bfloat16* dst0,
                                        const __nv_bfloat16* src0,
                                        __nv_bfloat16* dst1,
                                        const __nv_bfloat16* src1, int rows,
                                        int hd, int kd, bool vec, Off off) {
  const int S = 16 * kd + 8, nch = 2 * kd;
#pragma unroll
  for (int it = 0; it < rows / kTcRows * kd; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    const int r = i / nch, col = (i - r * nch) * 8;
    const long long o = off(r);
    const bool in = o >= 0 && col < hd;
    if (vec) {
      const int n = in ? 16 : 0;
      cp_async16(smem_u32(dst0 + r * S + col), in ? src0 + o + col : src0, n);
      if (kTwo)
        cp_async16(smem_u32(dst1 + r * S + col), in ? src1 + o + col : src1,
                   n);
    } else {
      for (int s = 0; s < (kTwo ? 2 : 1); ++s) {
        const __nv_bfloat16* src = s ? src1 : src0;
        __align__(16) __nv_bfloat16 e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = (in && col + j < hd) ? src[o + col + j]
                                      : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>((s ? dst1 : dst0) + r * S + col) =
            *reinterpret_cast<const uint4*>(e);
      }
    }
  }
}

// One tile's online-softmax step over this thread's scores s (element c of
// s[n] is row r0 + 8 (c >> 1), key k0 + 8n + 2 (lane & 3) + (c & 1)), in
// log2 units.  kMasked: some score of the block's tile may be masked, so
// each gets valid(row, key), -1e30 in the max and p multiplied by the mask;
// otherwise the scale is fused into the exponent.  Leaves p in s, the rows'
// alpha in alpha, and updates m and the thread's partial l.
template <bool kMasked, typename Valid>
__device__ __forceinline__ void tc_softmax(float (&s)[8][4], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2],
                                           float scale_log2, int r0, int k0,
                                           int lane, const Valid& valid) {
  uint32_t mask = 0;
  float mx[2] = {kTcNegInf, kTcNegInf};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (kMasked) {
        const bool ok =
            valid(r0 + (c >> 1) * 8, k0 + n * 8 + (lane & 3) * 2 + (c & 1));
        mask |= (ok ? 1u : 0u) << (n * 4 + c);
        s[n][c] = ok ? s[n][c] * scale_log2 : kTcNegInf;
      }
      mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], kMasked ? mx[i] : mx[i] * scale_log2);
    alpha[i] = fast_exp2(m[i] - m_new);
    m[i] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float mi = m[c >> 1];
      float p;
      if (kMasked)
        p = ((mask >> (n * 4 + c)) & 1u) ? fast_exp2(s[n][c] - mi) : 0.f;
      else
        p = fast_exp2(fmaf(s[n][c], scale_log2, -mi));
      s[n][c] = p;
      psum[c >> 1] += p;
    }
  l[0] = l[0] * alpha[0] + psum[0];
  l[1] = l[1] * alpha[1] + psum[1];
}

// The tile loop of one block: 64 * kM query rows over key tiles
// [t_begin, t_end); warp w owns rows 16 kM w .. 16 kM (w + 1) - 1.
//   q_off(r)      element offset of query row r in q, < 0: no row
//   kv_off(key)   element offset of key `key` in k and v, < 0: no key
//   valid(r, key) whether row r attends key
//   full(k0)      whether every row of the block attends all 64 keys from k0
//                 (the tile then skips the mask)
//   store_o(r, d, x0, x1)  the normalised output of row r, columns d, d + 1
//   store_ml(r, m, l)      row r's max (natural units) and denominator
// KD is the largest hd / 16 the instantiation takes (4, 8 or 16), exactly
// the one it takes when kExact (no guards in the unrolled loops).  kM 2
// makes each K and V fragment feed two m-tiles (half the ldmatrix traffic
// per mma, twice the independent mma a warp has in flight).  With kM 1 up
// to KD 8, Q's fragments are held in registers.  smem holds
// tc_smem_bytes(hd, kM) bytes.
template <int KD, int kM, bool kExact, typename QOff, typename KVOff,
          typename Valid, typename Full, typename StoreO, typename StoreML>
__device__ __forceinline__ void flash_tc_block(
    __nv_bfloat16* smem, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    int hd, bool vec, float scale_log2, int t_begin, int t_end, QOff q_off,
    KVOff kv_off, Valid valid, Full full, StoreO store_o, StoreML store_ml) {
  static_assert(tc_smem_bytes(16 * KD, kM) <= kTcMaxSmemBytes,
                "the block's tiles exceed the card's shared memory");
  constexpr bool kQReg = tc_q_in_regs(KD, kM);
  const int kd = kExact ? KD : tc_hd16(hd) / 16;
  const int S = 16 * kd + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* kv_s = smem;  // stage s: K, then V, 64 rows each
  __nv_bfloat16* q_s = smem + (kQReg ? 2 : 4) * kTcKeys * S;
  // ldmatrix row addresses of this lane (elements): the A fragment of Q, the
  // B fragments of K (two 8-key blocks) and of V^T (two 8-column blocks)
  const int a_off = (warp * 16 * kM + (lane & 15)) * S + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * S + (lane >> 4) * 8;
  // this thread's rows: r0 + 16 mi and r0 + 16 mi + 8 of m-tile mi
  const int r0 = warp * 16 * kM + (lane >> 2);

  float o[kM][2 * KD][4];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[mi][n][c] = 0.f;
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mi][i] = kTcNegInf;
      l[mi][i] = 0.f;
    }
  uint32_t qf[kQReg ? KD : 1][4];

  auto load_kv = [&](int t, int st) {
    __nv_bfloat16* k_s = kv_s + st * 2 * kTcKeys * S;
    const int k0 = t * kTcKeys;
    tc_load<true>(k_s, k, k_s + kTcKeys * S, v, kTcKeys, hd, kd, vec,
                  [&](int r) { return kv_off(k0 + r); });
  };
  if (t_begin < t_end) {
    tc_load<false>(q_s, q, q_s, q, kTcRows * kM, hd, kd, vec, q_off);
    load_kv(t_begin, 0);
    cp_async_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with stage st ^ 1
    if (kQReg && t == t_begin) {
#pragma unroll
      for (int kk = 0; kk < (kQReg ? KD : 1); ++kk)
        if (kk < kd) ldsm_x4(qf[kk], smem_u32(q_s + a_off + kk * 16));
      __syncthreads();  // Q is in registers: its smem is stage 1 again
    }
    if (t + 1 < t_end) load_kv(t + 1, st ^ 1);
    cp_async_commit();
    const __nv_bfloat16* k_s = kv_s + st * 2 * kTcKeys * S;
    const __nv_bfloat16* v_s = k_s + kTcKeys * S;
    const int k0 = t * kTcKeys;

    // S = Q K^T: s[mi][n] is keys 8n..8n+7 of m-tile mi's 16 rows
    float s[kM][8][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mi][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk < kd) {
        uint32_t a[kM][4];
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          if (kQReg) {
#pragma unroll
            for (int c = 0; c < 4; ++c) a[mi][c] = qf[kQReg ? kk : 0][c];
          } else {
            ldsm_x4(a[mi], smem_u32(q_s + a_off + mi * 16 * S + kk * 16));
          }
        }
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          uint32_t b[4];
          ldsm_x4(b, smem_u32(k_s + b_off + n2 * 16 * S + kk * 16));
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) {
            mma_bf16(s[mi][2 * n2], a[mi], b[0], b[1]);
            mma_bf16(s[mi][2 * n2 + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }

    const bool whole = full(k0);
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
      float alpha[2];
      if (whole)
        tc_softmax<false>(s[mi], m[mi], l[mi], alpha, scale_log2,
                          r0 + 16 * mi, k0, lane, valid);
      else
        tc_softmax<true>(s[mi], m[mi], l[mi], alpha, scale_log2,
                         r0 + 16 * mi, k0, lane, valid);
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n)
        if (n < 2 * kd) {
          o[mi][n][0] *= alpha[0];
          o[mi][n][1] *= alpha[0];
          o[mi][n][2] *= alpha[1];
          o[mi][n][3] *= alpha[1];
        }
    }

    // O += P V, P in bf16 as the A fragment, 16 keys a step
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[kM][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        a[mi][0] = pack_bf16(s[mi][2 * j][0], s[mi][2 * j][1]);
        a[mi][1] = pack_bf16(s[mi][2 * j][2], s[mi][2 * j][3]);
        a[mi][2] = pack_bf16(s[mi][2 * j + 1][0], s[mi][2 * j + 1][1]);
        a[mi][3] = pack_bf16(s[mi][2 * j + 1][2], s[mi][2 * j + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        if (dp < kd) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(v_s + v_off + j * 16 * S + dp * 16));
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) {
            mma_bf16(o[mi][2 * dp], a[mi], b[0], b[1]);
            mma_bf16(o[mi][2 * dp + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
    float lm[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[mi][i] += __shfl_xor_sync(0xffffffffu, l[mi][i], 1);
      l[mi][i] += __shfl_xor_sync(0xffffffffu, l[mi][i], 2);
      lm[i] = fmaxf(l[mi][i], 1e-30f);
    }
    const int r = r0 + 16 * mi;
#pragma unroll
    for (int n = 0; n < 2 * KD; ++n) {
      if (n < 2 * kd) {
        const int d = n * 8 + (lane & 3) * 2;
        store_o(r, d, o[mi][n][0] / lm[0], o[mi][n][1] / lm[0]);
        store_o(r + 8, d, o[mi][n][2] / lm[1], o[mi][n][3] / lm[1]);
      }
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        store_ml(r + 8 * i,
                 m[mi][i] == kTcNegInf ? kTcNegInf : m[mi][i] * kLn2,
                 l[mi][i]);
    }
  }
}

}  // namespace
