// The building blocks of the port's tensor-core attention kernels on
// Hopper: cp.async, ldmatrix, mma.sync.m16n8k16 bf16, the hi + lo split of
// probabilities and the quad reductions, used by K1
// (reprogramming_attention.cu) and by the backbone's attention kernels K4
// (attention.cu) and K5 (block_attention.cu); and, for K4 and K5, bf16 tiles
// of one head's 64-wide rows in shared memory, the softmax on the
// accumulators, and the two strips of their one backward algorithm.
//
// A tile row is one head's 64 bf16 (128 bytes), stored unpadded with its
// eight 16-byte pieces XOR-swizzled by the row's index mod 8: the eight rows
// that one 8 x 8 matrix of an ldmatrix reads, and the four rows one warp's
// cp.async writes, fall in distinct banks.
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane l holds, of a 16 x 8 f32
// accumulator, rows g = l / 4 and g + 8 and columns 2 (l % 4) and + 1.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "dropout_bits.cuh"

namespace hop_tiles {

constexpr int ROW_BYTES = 128;     // a tile row: one head's 64 bf16

// byte offset of 16-byte piece c (0..7) of row r in a swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * ROW_BYTES + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// 16 bytes from device to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, n) of one head, row i at src + i * ld elements, into a swizzled
// tile: 16-byte pieces shared out over `threads` threads, this one `tid`
__device__ __forceinline__ void load_rows(unsigned char* tile, const __nv_bfloat16* src, int ld,
                                          int n, int tid, int threads) {
  for (int idx = tid; idx < n * 8; idx += threads) {
    const int r = idx >> 3, c = idx & 7;
    cp_async16(tile + swz(r, c), src + r * ld + c * 8);
  }
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and gets elements (l / 4, 2 (l % 4) .. + 1) of each (transposed:
// (2 (l % 4) .. + 1, l / 4))
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A fragment (16 rows x 16 columns) of rows r0 .. r0 + 15, k step ks, of a
// tile whose rows past `last` are not loaded: their lanes read row `last`
// (the rows' results are never kept).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const unsigned char* tile, int r0,
                                       int last, int ks, int lane) {
  ldmatrix_x4(a, tile + swz(min(r0 + (lane & 15), last), ks * 2 + (lane >> 4)));
}

// B fragments of S = X K^T for keys j0 .. j0 + 15 (rows of the K tile), k
// step ks: b[0], b[1] for keys j0 .. + 7, b[2], b[3] for keys + 8 .. + 15.
// Keys past `last` read row `last`; their scores are masked.
__device__ __forceinline__ void k_frag(uint32_t (&b)[4], const unsigned char* tile, int j0,
                                       int last, int ks, int lane) {
  ldmatrix_x4(b, tile + swz(min(j0 + (lane & 7) + ((lane >> 4) << 3), last),
                            ks * 2 + ((lane >> 3) & 1)));
}

// B fragments of O = P V for keys j0 .. j0 + 15 (rows of the V tile) and
// columns 16 np .. + 15: b[0], b[1] for columns 16 np .. + 7, b[2],
// b[3] for + 8 .. + 15. Keys past `last` read row `last` (finite values
// that meet probabilities of 0).
__device__ __forceinline__ void v_frag(uint32_t (&b)[4], const unsigned char* tile, int j0,
                                       int last, int np, int lane) {
  ldmatrix_x4_trans(b, tile + swz(min(j0 + (lane & 7) + (((lane >> 3) & 1) << 3), last),
                                  np * 2 + (lane >> 4)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two packed bf16 pairs hi and lo with hi + lo = (x, y) to 2^-17:
// the bf16 rounding and the rounding of the remainder; x in the low half
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A fragments (hi and lo) of the 16 x 16 probabilities of keys 16 kk ..
// + 15 from two 16 x 8 accumulator tiles p0 (keys .. + 7) and p1 (+ 8 ..)
__device__ __forceinline__ void p_frags(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&p0)[4],
                                        const float (&p1)[4]) {
  split_pair(p0[0], p0[1], hi[0], lo[0]);
  split_pair(p0[2], p0[3], hi[1], lo[1]);
  split_pair(p1[0], p1[1], hi[2], lo[2]);
  split_pair(p1[2], p1[3], hi[3], lo[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp2 on the accumulators, in place, the first half of the softmax. s holds
// a lane's part of a 16-row strip of scores over NT tiles of 8 keys, key
// col0 + 8 n + 2 (lane % 4) (+ 1); row a is the lane's row g, row b is g + 8.
// Each row's keys are [lo, hi): s becomes exp2(s * scale_log2 - m) there and
// 0 elsewhere, m the row's max (0 for a row with no keys, lo == hi); mx_a,
// mx_b get m and l_a, l_b the row's sum. The max and the sum of a row take
// two shuffles each in its quad.
template <int NT>
__device__ __forceinline__ void exp2_rows(float (&s)[NT][4], int col0, int lo_a, int hi_a,
                                          int lo_b, int hi_b, float scale_log2, int t4,
                                          float& mx_a, float& mx_b, float& l_a, float& l_b) {
  mx_a = -INFINITY;
  mx_b = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = col0 + n * 8 + 2 * t4 + (c & 1);
      const bool in = c < 2 ? (j >= lo_a && j < hi_a) : (j >= lo_b && j < hi_b);
      s[n][c] = in ? s[n][c] * scale_log2 : -INFINITY;
    }
    mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  if (mx_a == -INFINITY) mx_a = 0.f;   // a row without keys: every e is 0
  if (mx_b == -INFINITY) mx_b = 0.f;
  l_a = 0.f;
  l_b = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = exp2f(s[n][0] - mx_a);
    s[n][1] = exp2f(s[n][1] - mx_a);
    s[n][2] = exp2f(s[n][2] - mx_b);
    s[n][3] = exp2f(s[n][3] - mx_b);
    l_a += s[n][0] + s[n][1];
    l_b += s[n][2] + s[n][3];
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
}

// Softmax on the accumulators, in place (s and the rows as exp2_rows'). The
// result is p * keep / (1 - rate): the dropout bits of dropout_bits.cuh at
// the row's key rk and the key's index col - lo (inside its sample); a row
// with no keys gets 0 throughout. exp is exp2 of scores times scale *
// log2(e).
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], int col0, int lo_a, int hi_a,
                                             int lo_b, int hi_b, uint32_t rk_a, uint32_t rk_b,
                                             float scale_log2, uint32_t thresh, float inv_keep,
                                             int t4) {
  float mx_a, mx_b, l_a, l_b;
  exp2_rows<NT>(s, col0, lo_a, hi_a, lo_b, hi_b, scale_log2, t4, mx_a, mx_b, l_a, l_b);
  const float w_a = l_a > 0.f ? 1.f / l_a : 0.f, w_b = l_b > 0.f ? 1.f / l_b : 0.f;
  // the sum is over the undropped probabilities; the dropped ones meet V
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float p = s[n][c] * (c < 2 ? w_a : w_b);
      if (thresh != 0u && p != 0.f) {
        const int j = col0 + n * 8 + 2 * t4 + (c & 1);
        const uint32_t key = uint32_t(j - (c < 2 ? lo_a : lo_b));
        p = hop_dropout::bits(c < 2 ? rk_a : rk_b, key) >= thresh ? p * inv_keep : 0.f;
      }
      s[n][c] = p;
    }
  }
}

// ---- the backward of K4 and K5 ---------------------------------------------
//
// One algorithm for both. A "group" is Rg rows of stacked samples of T rows
// each (K5: nb samples of one head; K4: one sample, Rg = T), row r of the
// group at global query row g0 + r, its Q, K, V and dO rows in four swizzled
// tiles. A strip is 16 rows of the group; its rows belong to at most two
// samples, whose rows (keys of a query strip, queries of a key strip) lie in
// the 16-row tiles `sample_span` gives. A block per (group, head)
// (`bwd_group`) stages the four tiles once; two phases, each a warp a strip:
//   1. query strips: S = Q K^T, the softmax (undropped p; each row's
//      log2-sum-exp2 to `lse`), dP = dO V^T, dP o keep, delta = rowsum(dP o
//      keep o p) (to `delta`), dS = p (dP o keep - delta) scale, dQ = dS K;
//   2. key strips (after the block's barrier): S^T = K Q^T and dP^T = V dO^T
//      per 16-query tile, p = exp2(S^T scale log2(e) - lse), p o keep and dS^T
//      on the accumulators, dV += (p o keep)^T dO and dK += dS^T Q.
// Seven products where the function needs five: the transposed tiles are
// recomputed in the layout whose accumulators are the next product's A
// fragments, so P and dS never leave the registers; each enters its product
// as hi + lo bf16 (p_frags). Every dq, dk, dv row has one owner (the warp of
// its strip) and one summation order: no atomics, bitwise repeatable. Rows
// and keys past the group's last read its last row (clamped ldmatrix
// addresses); their p and dS are 0, so a pad query adds exactly 0 to dK and
// dV, and a pad row's results are never stored.

constexpr int STRIP = 16;   // rows of a strip, keys or queries of a tile

struct Span {
  int c0;       // first row of the tiles (a multiple of 16)
  int ntiles;   // 16-row tiles
};

// The rows of the samples that rows [r0, r0 + 16) of a group of Rg rows
// belong to, widened to whole tiles. (Keys of a query strip, or queries of a
// key strip.)
__host__ __device__ __forceinline__ Span sample_span(int r0, int Rg, int T) {
  const int first = (r0 / T) * T;
  const int end = r0 + STRIP < Rg ? r0 + STRIP : Rg;
  const int last = ((end - 1) / T) * T + T;
  const int c0 = first / STRIP * STRIP;
  return {c0, (last + STRIP - 1) / STRIP - first / STRIP};
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// acc = X Y^T for the 16 rows of X from r0 against the span's rows of Y (2
// ntiles accumulator tiles of 8; tiles past the span's are left 0), both
// swizzled tiles of a group whose rows past `last` read as its last. X is the
// A operand (a_frag), Y the B operand (k_frag): S = Q K^T, dP = dO V^T.
template <int NTILE>
__device__ __forceinline__ void span_products(float (&acc)[2 * NTILE][4],
                                              const unsigned char* X, const unsigned char* Y,
                                              int r0, const Span span, int last, int lane) {
#pragma unroll
  for (int n = 0; n < 2 * NTILE; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    a_frag(a, X, r0, last, ks, lane);
#pragma unroll
    for (int t = 0; t < NTILE; ++t) {
      if (t < span.ntiles) {
        uint32_t b[4];
        k_frag(b, Y, span.c0 + t * STRIP, last, ks, lane);
        mma_bf16(acc[2 * t], a, b[0], b[1]);
        mma_bf16(acc[2 * t + 1], a, b[2], b[3]);
      }
    }
  }
}

// Phase 1, first half: the undropped probabilities of the query strip at
// group row r0 over its key tiles (at most NTILE) into s (2 NTILE tiles of 8
// keys), and each row's log2-sum-exp2 of its scaled scores to lse[row] (rows
// of the group only).
template <int NTILE>
__device__ __forceinline__ void bwd_strip_probs(float (&s)[2 * NTILE][4],
                                                const unsigned char* Qs,
                                                const unsigned char* Ks, int r0, int Rg, int T,
                                                float scale_log2, float* lse, int lane) {
  const Span span = sample_span(r0, Rg, T);
  span_products<NTILE>(s, Qs, Ks, r0, span, Rg - 1, lane);
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int lo_a = ra < Rg ? ra / T * T : 0, lo_b = rb < Rg ? rb / T * T : 0;
  float mx_a, mx_b, l_a, l_b;
  exp2_rows<2 * NTILE>(s, span.c0, lo_a, ra < Rg ? lo_a + T : 0, lo_b, rb < Rg ? lo_b + T : 0,
                       scale_log2, lane & 3, mx_a, mx_b, l_a, l_b);
  const float w_a = l_a > 0.f ? 1.f / l_a : 0.f, w_b = l_b > 0.f ? 1.f / l_b : 0.f;
#pragma unroll
  for (int n = 0; n < 2 * NTILE; ++n) {
    s[n][0] *= w_a;
    s[n][1] *= w_a;
    s[n][2] *= w_b;
    s[n][3] *= w_b;
  }
  if ((lane & 3) == 0) {
    if (ra < Rg) lse[ra] = mx_a + log2f(l_a);
    if (rb < Rg) lse[rb] = mx_b + log2f(l_b);
  }
}

// Phase 1, second half: from the strip's probabilities s (bwd_strip_probs),
// dP = dO V^T over the same key tiles, dP o keep (the bits of the row's key
// at the key's index inside its sample, where p != 0), each row's delta and
// dropout key to delta[row] and rkey[row], dS = p (dP o keep - delta)
// scale, and dQ = dS K (dS as hi + lo
// A fragments, K by ldmatrix.trans), stored to the strip's rows of the group
// at dq (the group's first row of this head, row stride ld).
template <int NTILE, typename Out>
__device__ __forceinline__ void bwd_strip_dq(float (&s)[2 * NTILE][4], const unsigned char* Ks,
                                             const unsigned char* Vs, const unsigned char* Gs,
                                             float* delta, uint32_t* rkey, Out* dq, int ld,
                                             int r0, int Rg,
                                             int T, long long g0, uint32_t hk, float scale,
                                             uint32_t thresh, float inv_keep, int lane) {
  const Span span = sample_span(r0, Rg, T);
  const int last = Rg - 1, t4 = lane & 3;
  float dp[2 * NTILE][4];
  span_products<NTILE>(dp, Gs, Vs, r0, span, last, lane);
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int lo_a = ra < Rg ? ra / T * T : 0, lo_b = rb < Rg ? rb / T * T : 0;
  const uint32_t rk_a = hop_dropout::row_key(hk, uint32_t(g0 + ra));
  const uint32_t rk_b = hop_dropout::row_key(hk, uint32_t(g0 + rb));
  float d_a = 0.f, d_b = 0.f;
#pragma unroll
  for (int n = 0; n < 2 * NTILE; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (thresh != 0u && s[n][c] != 0.f) {
        const int j = span.c0 + n * 8 + 2 * t4 + (c & 1);
        const uint32_t key = uint32_t(j - (c < 2 ? lo_a : lo_b));
        dp[n][c] *= hop_dropout::bits(c < 2 ? rk_a : rk_b, key) >= thresh ? inv_keep : 0.f;
      }
    }
    d_a += s[n][0] * dp[n][0] + s[n][1] * dp[n][1];
    d_b += s[n][2] * dp[n][2] + s[n][3] * dp[n][3];
  }
  d_a = quad_sum(d_a);
  d_b = quad_sum(d_b);
  if (t4 == 0) {
    if (ra < Rg) {
      delta[ra] = d_a;
      rkey[ra] = rk_a;
    }
    if (rb < Rg) {
      delta[rb] = d_b;
      rkey[rb] = rk_b;
    }
  }
#pragma unroll
  for (int n = 0; n < 2 * NTILE; ++n) {
    dp[n][0] = s[n][0] * (dp[n][0] - d_a) * scale;
    dp[n][1] = s[n][1] * (dp[n][1] - d_a) * scale;
    dp[n][2] = s[n][2] * (dp[n][2] - d_b) * scale;
    dp[n][3] = s[n][3] * (dp[n][3] - d_b) * scale;
  }
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < NTILE; ++t) {
    if (t < span.ntiles) {
      uint32_t hi[4], lo[4];
      p_frags(hi, lo, dp[2 * t], dp[2 * t + 1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        v_frag(bk, Ks, span.c0 + t * STRIP, last, np, lane);
        mma_bf16(o[2 * np], hi, bk[0], bk[1]);
        mma_bf16(o[2 * np], lo, bk[0], bk[1]);
        mma_bf16(o[2 * np + 1], hi, bk[2], bk[3]);
        mma_bf16(o[2 * np + 1], lo, bk[2], bk[3]);
      }
    }
  }
  Out* dst = dq + 2 * t4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (ra < Rg) store_pair(dst + ra * ld + n * 8, o[n][0], o[n][1]);
    if (rb < Rg) store_pair(dst + rb * ld + n * 8, o[n][2], o[n][3]);
  }
}

// Phase 2: the key strip at group row j0 (its keys as rows) over the query
// tiles of its samples (at most NTILE), with every row's lse and delta of
// phase 1 in lse[], delta[] and rkey[]. Per 16-query tile: S^T = K Q^T and dP^T = V
// dO^T (the strip's K and V rows as A fragments, Q and dO rows as B), then
// per element, where the query and the key belong to one sample, p =
// exp2(S^T scale_log2 - lse[query]), the keep factor of the query's row key
// at the key's index inside its sample, p o keep (in S^T's place) and dS^T =
// p (dP^T o keep - delta[query]) scale (in dP^T's place), 0 elsewhere; then
// dV += (p o keep)^T dO and dK += dS^T Q, both as hi + lo A fragments, dO and
// Q by ldmatrix.trans. dk and dv as dq in bwd_strip_dq.
template <int NTILE, typename Out>
__device__ __forceinline__ void bwd_key_strip(const unsigned char* Qs, const unsigned char* Ks,
                                              const unsigned char* Vs, const unsigned char* Gs,
                                              const float* lse, const float* delta,
                                              const uint32_t* rkey, Out* dk, Out* dv, int ld,
                                              int j0, int Rg, int T, float scale_log2,
                                              float scale, uint32_t thresh, float inv_keep,
                                              int lane) {
  const Span span = sample_span(j0, Rg, T);     // the queries of the strip's samples
  const int last = Rg - 1, t4 = lane & 3;
  const int ja = j0 + (lane >> 2), jb = ja + 8;  // the lane's two keys
  const int sa = ja < Rg ? ja / T : -1, sb = jb < Rg ? jb / T : -1;
  const uint32_t ka = uint32_t(ja - sa * T), kb = uint32_t(jb - sb * T);
  float ok[8][4], ov[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    ok[n][0] = ok[n][1] = ok[n][2] = ok[n][3] = 0.f;
    ov[n][0] = ov[n][1] = ov[n][2] = ov[n][3] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < NTILE; ++t) {
    if (t < span.ntiles) {
      const int q0 = span.c0 + t * STRIP;
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = dpt[n][0] = dpt[n][1] = dpt[n][2] =
            dpt[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ak[4], av[4], bq[4], bg[4];
        a_frag(ak, Ks, j0, last, ks, lane);
        a_frag(av, Vs, j0, last, ks, lane);
        k_frag(bq, Qs, q0, last, ks, lane);
        k_frag(bg, Gs, q0, last, ks, lane);
        mma_bf16(st[0], ak, bq[0], bq[1]);
        mma_bf16(st[1], ak, bq[2], bq[3]);
        mma_bf16(dpt[0], av, bg[0], bg[1]);
        mma_bf16(dpt[1], av, bg[2], bg[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {     // the lane's query column
          const int qc = q0 + n * 8 + 2 * t4 + c;
          const bool qin = qc < Rg;
          const int sq = qin ? qc / T : -2;
          const float l = qin ? lse[qc] : 0.f, dl = qin ? delta[qc] : 0.f;
          const uint32_t rk = qin && thresh != 0u ? rkey[qc] : 0u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {   // keys ja (r = 0) and jb
            const int e = 2 * r + c;
            float p = (r == 0 ? sa : sb) == sq ? exp2f(st[n][e] * scale_log2 - l) : 0.f;
            float kf = 1.f;
            if (thresh != 0u && p != 0.f)
              kf = hop_dropout::bits(rk, r == 0 ? ka : kb) >= thresh ? inv_keep : 0.f;
            st[n][e] = p * kf;
            dpt[n][e] = p * (dpt[n][e] * kf - dl) * scale;
          }
        }
      }
      uint32_t hi[4], lo[4];
      p_frags(hi, lo, st[0], st[1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        v_frag(b, Gs, q0, last, np, lane);
        mma_bf16(ov[2 * np], hi, b[0], b[1]);
        mma_bf16(ov[2 * np], lo, b[0], b[1]);
        mma_bf16(ov[2 * np + 1], hi, b[2], b[3]);
        mma_bf16(ov[2 * np + 1], lo, b[2], b[3]);
      }
      p_frags(hi, lo, dpt[0], dpt[1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        v_frag(b, Qs, q0, last, np, lane);
        mma_bf16(ok[2 * np], hi, b[0], b[1]);
        mma_bf16(ok[2 * np], lo, b[0], b[1]);
        mma_bf16(ok[2 * np + 1], hi, b[2], b[3]);
        mma_bf16(ok[2 * np + 1], lo, b[2], b[3]);
      }
    }
  }
  const int ra = j0 + (lane >> 2), rb = ra + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (ra < Rg) {
      store_pair(dk + ra * ld + col, ok[n][0], ok[n][1]);
      store_pair(dv + ra * ld + col, ov[n][0], ov[n][1]);
    }
    if (rb < Rg) {
      store_pair(dk + rb * ld + col, ok[n][2], ok[n][3]);
      store_pair(dv + rb * ld + col, ov[n][2], ov[n][3]);
    }
  }
}

// The whole backward of one group of head h: Rg rows (of a full group of
// `cap` rows) from global row g0, in a block of warps that take strips w, w +
// warps, ... in each phase. Shared memory: the four tiles of `cap` rows, then
// 3 cap words of statistics (log2-sum-exp2, delta and dropout key per row). Q and K
// come as one copy group, dO and V as a second that lands while each warp's
// first strip's probabilities are formed; one __syncthreads() between the
// phases.
template <int NTILE, typename Out>
__device__ __forceinline__ void bwd_group(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, const __nv_bfloat16* dout,
                                          Out* dq, Out* dk, Out* dv, int Rg, int cap, int T,
                                          int H, int h, long long g0, float scale_log2,
                                          float scale, uint32_t seed, uint32_t thresh,
                                          float inv_keep, unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int ld = H * (ROW_BYTES / 2);
  const long long off = g0 * ld + h * (ROW_BYTES / 2);
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + cap * ROW_BYTES;
  unsigned char* Vs = Ks + cap * ROW_BYTES;
  unsigned char* Gs = Vs + cap * ROW_BYTES;
  float* lse = reinterpret_cast<float*>(Gs + cap * ROW_BYTES);
  float* delta = lse + cap;
  uint32_t* rkey = reinterpret_cast<uint32_t*>(delta + cap);
  load_rows(Qs, q + off, ld, Rg, threadIdx.x, blockDim.x);
  load_rows(Ks, k + off, ld, Rg, threadIdx.x, blockDim.x);
  cp_async_commit();
  load_rows(Gs, dout + off, ld, Rg, threadIdx.x, blockDim.x);
  load_rows(Vs, v + off, ld, Rg, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const uint32_t hk = hop_dropout::head_key(seed, h);
  const int nstrips = (Rg + STRIP - 1) / STRIP;
  // phase 1: query strips -> lse, delta, dq
  float s[2 * NTILE][4];
  if (warp < nstrips)
    bwd_strip_probs<NTILE>(s, Qs, Ks, warp * STRIP, Rg, T, scale_log2, lse, lane);
  cp_async_wait<0>();
  __syncthreads();
  for (int strip = warp; strip < nstrips; strip += nwarps) {
    if (strip != warp)
      bwd_strip_probs<NTILE>(s, Qs, Ks, strip * STRIP, Rg, T, scale_log2, lse, lane);
    bwd_strip_dq<NTILE>(s, Ks, Vs, Gs, delta, rkey, dq + off, ld, strip * STRIP, Rg, T, g0,
                        hk, scale, thresh, inv_keep, lane);
  }
  __syncthreads();
  // phase 2: key strips -> dk, dv
  for (int strip = warp; strip < nstrips; strip += nwarps)
    bwd_key_strip<NTILE>(Qs, Ks, Vs, Gs, lse, delta, rkey, dk + off, dv + off, ld,
                         strip * STRIP, Rg, T, scale_log2, scale, thresh, inv_keep, lane);
}

// bytes of shared memory bwd_group takes for a full group of `cap` rows
__host__ __device__ constexpr int bwd_group_smem(int cap) {
  return cap * (4 * ROW_BYTES + 3 * 4);
}

}  // namespace hop_tiles
