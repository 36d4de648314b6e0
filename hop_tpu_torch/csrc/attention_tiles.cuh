// The building blocks of the port's tensor-core attention kernels on
// Hopper: cp.async, ldmatrix, mma.sync.m16n8k16 bf16, the hi + lo split of
// probabilities and the quad reductions, used by K1
// (reprogramming_attention.cu) and by the backbone's attention forwards K4
// (attention.cu) and K5 (block_attention.cu); and, for K4 and K5, bf16 tiles
// of one head's 64-wide rows in shared memory and the softmax on the
// accumulators.
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

// Softmax on the accumulators, in place. s holds a lane's part of a 16-row
// strip of scores over NT tiles of 8 keys, key col0 + 8 n + 2 (lane % 4)
// (+ 1); row a is the lane's row g, row b is g + 8. Each row's keys are
// [lo, hi): the others get probability 0, and a row with none (lo == hi)
// gets 0 throughout. The result is p * keep / (1 - rate): the dropout bits
// of dropout_bits.cuh at the row's key rk and the key's index col - lo
// (inside its sample). The max and the sum of a row take two shuffles in
// its quad; exp is exp2 of scores times scale * log2(e).
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], int col0, int lo_a, int hi_a,
                                             int lo_b, int hi_b, uint32_t rk_a, uint32_t rk_b,
                                             float scale_log2, uint32_t thresh, float inv_keep,
                                             int t4) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
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
  float l_a = 0.f, l_b = 0.f;
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

}  // namespace hop_tiles
