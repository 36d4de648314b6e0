// Reprogramming cross-attention (kernel K1) for Hopper, sm_90a: the forward
// with attention dropout and its log-sum-exp, and the backward.
//
// Replaces the TPU kernels `_fwd_kernel` (:110-127) and `_bwd_kernel`
// (:130-177) of hop_tpu/ops/pallas_reprogramming.py. The forward computes
//   p[b, h, l, s] = softmax_s(q[b, l, h, :] . k[h, s, :] * scale)
//   out[b, l, h, :] = sum_s p * keep(b, h, l, s) / (1 - rate) * v[h, s, :]
// for q (B, L, H, E=128) bf16, k and v (H, S, E) bf16 shared by the whole
// batch, out (B, L, H, E) f32, and optionally lse[b, l, h] = log sum_s
// exp(scores) (f32) for the backward. keep() is the hash of
// dropout_bits.cuh: a function of global coordinates, so the backward
// redraws the forward's mask with another tiling. Softmax, accumulation and
// the gradients are f32.
//
// Forward, on the tensor cores. The TPU kept all of K and V resident in VMEM
// and tiled the batch by samples. Here the keys are shared by the batch, so
// for one head the queries are ONE (B * L, E) matrix with row stride H * E,
// cut into 64-row tiles whatever L is (the ragged last tile is masked by
// row):
//   * a block is (row tile, head, key split): 4 warps, each owning 16 query
//     rows whose bf16 fragments stay in registers for the whole walk over S;
//     two blocks share an SM (about 200 registers a thread: the Q fragments,
//     64 output and 32 score accumulators), so one block's softmax runs under
//     the other's products. On an H100 at the HOP shape 64-row blocks take
//     0.34 ms where 128-row blocks of 8 warps, one to an SM, took 0.38, and
//     three blocks an SM (168 registers, spills) 0.36;
//   * K and V stream through shared memory as bf16 in 64-key tiles, brought
//     by 16-byte cp.async two stages deep (the next tile loads under this
//     tile's products); rows are padded to 272 bytes so that the eight rows
//     of an ldmatrix land in eight different bank groups;
//   * both products are mma.sync.m16n8k16 bf16 with f32 accumulators. The
//     scores never leave the accumulator fragments: the online softmax
//     (running max and sum, rescale of the output accumulators) works on
//     registers, a row's four threads agreeing on the max by two shuffles;
//     exp is exp2 on scores pre-multiplied by scale * log2(e);
//   * p * keep / (1 - rate) meets V at f32 accuracy: it enters the tensor
//     cores as hi + lo, its bf16 rounding and the rounding of the remainder
//     (two MMAs), V being bf16-exact. 80 GFLOP of MMA at the HOP shape;
//   * keys past S in the last tile score -inf and their K/V rows are zero;
//   * when row tiles x heads would not fill the card (B = 1: 8 blocks), S is
//     split across blocks; each writes its (max, sum, unnormalised out) to a
//     workspace and reprog_attn_combine_kernel adds the splits in order. The
//     split count comes from the wrapper and depends on the shape alone.
// What bounds it: operations, 53.5 GFLOP of bf16 products at (B=256, L=34,
// H=8, S=1500) against 27 MB of traffic; on the card the rate at which warps
// start mma.sync, with the softmax, the hi/lo split and the dropout hash on
// the same warps.
// wgmma on 64-row tiles with TMA loads is the further step.
//
// Backward (flash-attention-2 shape). The TPU summed dk and dv over batch
// blocks in a VMEM accumulator, relying on its sequential grid; GPU blocks
// run in parallel and in no order, so the sum is re-cut instead:
//   * dq kernel: one block per (68-row tile of the (B * L, E) query matrix,
//     head). It first forms delta = rowsum(dO * O) for its rows (and stores
//     it for the next kernel), then walks the key tiles, recomputes
//     p = exp(s - lse) and the mask,
//     ds = p * (dO v^T * keep / (1 - rate) - delta) and adds ds k;
//   * dk/dv kernel: one block per (head, 64-key tile) that walks ALL B*L
//     query rows in chunks of 64, in a fixed order, accumulating
//     dv += (p * keep / (1 - rate))^T dO and dk += ds^T q in registers.
// Each output element is owned by one block and summed in one order: dk and
// dv are deterministic, with no atomics and no cross-block reduction.
// What bounds the backward: the scalar f32 FMAs of its seven products
// (scores recomputed in both kernels: 187 GFLOP at the HOP shape); K/V and
// Q/dO tiles are re-read from L2 by every block. Its tensor-core form is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_bits.cuh"

namespace {

constexpr int E = 128;            // head dim
constexpr int MAX_ROWS = 68;      // query rows per block of the dq kernel
constexpr int TILE_S = 64;        // keys per tile
constexpr int THREADS = 256;
constexpr int KSTRIDE = E + 1;    // padded K row: conflict-free column reads
// scores: thread -> key j = tid % 64, rows tid / 64 + 4 i
constexpr int S_GROUPS = THREADS / TILE_S;          // 4
constexpr int S_ROWS = MAX_ROWS / S_GROUPS;         // 17
// output: thread -> column e = tid % 128, rows tid / 128 + 2 i
constexpr int O_GROUPS = THREADS / E;               // 2
constexpr int O_ROWS = MAX_ROWS / O_GROUPS;         // 34
constexpr int WARPS = THREADS / 32;

static_assert(MAX_ROWS % S_GROUPS == 0 && MAX_ROWS % O_GROUPS == 0, "rows");

// forward: 4 warps x 16 query rows, bf16 K and V tiles two stages deep
constexpr int FWD_WARPS = 4;
constexpr int FWD_THREADS = FWD_WARPS * 32;
constexpr int FWD_ROWS = FWD_WARPS * 16;     // query rows per block
constexpr int FWD_STAGES = 2;
constexpr int KV_LD = E + 8;                 // padded bf16 row, 272 bytes
constexpr int KV_TILE_ELEMS = TILE_S * KV_LD;
constexpr size_t FWD_SMEM_BYTES =
    size_t(FWD_STAGES) * 2 * KV_TILE_ELEMS * sizeof(__nv_bfloat16);
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(E % 16 == 0 && TILE_S % 16 == 0, "m16n8k16 tiles");
static_assert((TILE_S * E / 8) % FWD_THREADS == 0, "16-byte pieces per thread");

// dq kernel: Q, dO, K tile, V tile, ds tile, lse, delta, row keys
constexpr size_t DQ_SMEM_BYTES =
    (2 * MAX_ROWS * E + 2 * TILE_S * KSTRIDE + MAX_ROWS * TILE_S + 3 * MAX_ROWS) *
    sizeof(float);

// dk/dv kernel: one block per (64-key tile, head), query rows in chunks of 64
constexpr int KV_TILE = 64;       // keys per block
constexpr int ROW_CHUNK = 64;     // query rows per step of the block's loop
constexpr int PSTRIDE = KV_TILE + 1;
constexpr size_t KV_SMEM_BYTES =
    (2 * KV_TILE * KSTRIDE + 2 * ROW_CHUNK * KSTRIDE + 2 * ROW_CHUNK * PSTRIDE +
     3 * ROW_CHUNK) * sizeof(float);
static_assert(KV_TILE == 64 && ROW_CHUNK == 64 && THREADS == 256,
              "the dk/dv thread maps assume 8 warps over 64 x 64 tiles");

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dropout: the probability scaled by 1 / (1 - rate) when kept, else 0
__device__ __forceinline__ float drop(float p, uint32_t rk, uint32_t s,
                                      uint32_t thresh, float inv_keep) {
  if (thresh == 0u) return p;
  return hop_dropout::bits(rk, s) >= thresh ? p * inv_keep : 0.f;
}

// --- the forward's building blocks: cp.async, ldmatrix, mma.sync ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and gets elements (l / 4, 2 (l % 4) .. + 1) of each (transposed:
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

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
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
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Block (x, y, z) = (64-row tile of the (R = B * L, E) query matrix of head
// y, head, key split z): key tiles [z * tiles_per_split, ...). Lane l of a
// warp holds, in the m16n8 accumulator layout, rows g = l / 4 and g + 8 of
// the warp's 16 and columns 2 (l % 4), + 1 of every 8-wide tile. With one
// split it writes out and lse; with more, the unnormalised sums to part_o
// (split, R, H, E) and (max, sum) in the exp2 domain to part_ml (split, R, H, 2).
__global__ void __launch_bounds__(FWD_THREADS, 2)
reprog_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       float* __restrict__ out, float* __restrict__ lse,
                       float* __restrict__ part_o, float* __restrict__ part_ml,
                       int R, int H, int S, int tiles_per_split, float scale_log2,
                       uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [stage][K, V][key][KV_LD]
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int h = blockIdx.y;
  const int row_a = blockIdx.x * FWD_ROWS + warp * 16 + g, row_b = row_a + 8;
  const bool ok_a = row_a < R, ok_b = row_b < R;
  const int n_tiles = (S + TILE_S - 1) / TILE_S;
  const int tile0 = blockIdx.z * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);

  const __nv_bfloat16* kh = k + size_t(h) * S * E;
  const __nv_bfloat16* vh = v + size_t(h) * S * E;
  auto load_tile = [&](int tile, int stage) {
    __nv_bfloat16* Ks = kv + stage * 2 * KV_TILE_ELEMS;
    __nv_bfloat16* Vs = Ks + KV_TILE_ELEMS;
    const int s0 = tile * TILE_S;
#pragma unroll
    for (int i = 0; i < TILE_S * E / 8 / FWD_THREADS; ++i) {
      const int c = tid + i * FWD_THREADS;
      const int key = c / (E / 8), piece = c % (E / 8);
      const bool ok = s0 + key < S;
      const size_t src = ok ? size_t(s0 + key) * E + piece * 8 : 0;
      cp_async16(Ks + key * KV_LD + piece * 8, kh + src, ok);
      cp_async16(Vs + key * KV_LD + piece * 8, vh + src, ok);
    }
    cp_async_commit();
  };
  load_tile(tile0, 0);

  // the warp's Q fragments, straight from device memory: a[0], a[2] are row
  // g, a[1], a[3] row g + 8; columns 16 ks + 2 t4 (+ 8 for a[2], a[3])
  uint32_t qf[E / 16][4];
  {
    const uint32_t* qa =
        reinterpret_cast<const uint32_t*>(q + (size_t(ok_a ? row_a : 0) * H + h) * E);
    const uint32_t* qb =
        reinterpret_cast<const uint32_t*>(q + (size_t(ok_b ? row_b : 0) * H + h) * E);
#pragma unroll
    for (int ks = 0; ks < E / 16; ++ks) {
      qf[ks][0] = ok_a ? __ldg(qa + ks * 8 + t4) : 0u;
      qf[ks][1] = ok_b ? __ldg(qb + ks * 8 + t4) : 0u;
      qf[ks][2] = ok_a ? __ldg(qa + ks * 8 + 4 + t4) : 0u;
      qf[ks][3] = ok_b ? __ldg(qb + ks * 8 + 4 + t4) : 0u;
    }
  }

  const uint32_t hk = hop_dropout::head_key(seed, h);
  const uint32_t rk_a = hop_dropout::row_key(hk, uint32_t(row_a));
  const uint32_t rk_b = hop_dropout::row_key(hk, uint32_t(row_b));

  float acc[E / 8][4];
#pragma unroll
  for (int n = 0; n < E / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;   // running max, scores * scale * log2(e)
  float l_a = 0.f, l_b = 0.f;               // this thread's share of the running sum

  // ldmatrix row addresses of this lane inside a tile
  const int k_row = lane % 8 + (lane / 16) * 8, k_col = (lane / 8 % 2) * 8;   // K: x4
  const int v_row = lane % 8 + (lane / 8 % 2) * 8, v_col = (lane / 16) * 8;   // V: x4.trans

  for (int tile = tile0; tile < tile1; ++tile) {
    const int stage = (tile - tile0) % FWD_STAGES;
    if (tile + 1 < tile1) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's K and V have landed for every thread
    const __nv_bfloat16* Ks = kv + stage * 2 * KV_TILE_ELEMS;
    const __nv_bfloat16* Vs = Ks + KV_TILE_ELEMS;
    const int s0 = tile * TILE_S;

    // scores: sc[n] is the 16 x 8 tile of keys s0 + 8 n ..
    float sc[TILE_S / 8][4];
#pragma unroll
    for (int n = 0; n < TILE_S / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < E / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < TILE_S / 16; ++np) {
        uint32_t b[4];  // keys 16 np .. + 7: b[0], b[1]; keys + 8: b[2], b[3]
        ldmatrix_x4(b, Ks + (np * 16 + k_row) * KV_LD + ks * 16 + k_col);
        mma_bf16(sc[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }
    const bool ragged = s0 + TILE_S > S;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < TILE_S / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[n][c] *= scale_log2;
        if (ragged && s0 + n * 8 + 2 * t4 + (c & 1) >= S) sc[n][c] = -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
    }
    // online softmax: every tile holds a key, so the new max is finite
    const float new_a = fmaxf(m_a, quad_max(mx_a)), new_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = exp2f(m_a - new_a), al_b = exp2f(m_b - new_b);  // 0 at first
    m_a = new_a;
    m_b = new_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int n = 0; n < E / 8; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }
    // the sum is over the undropped probabilities; the dropped ones meet V
#pragma unroll
    for (int n = 0; n < TILE_S / 8; ++n) {
      const uint32_t key = uint32_t(s0 + n * 8 + 2 * t4);
      const float p0 = exp2f(sc[n][0] - m_a), p1 = exp2f(sc[n][1] - m_a);
      const float p2 = exp2f(sc[n][2] - m_b), p3 = exp2f(sc[n][3] - m_b);
      l_a += p0 + p1;
      l_b += p2 + p3;
      sc[n][0] = drop(p0, rk_a, key, thresh, inv_keep);
      sc[n][1] = drop(p1, rk_a, key + 1, thresh, inv_keep);
      sc[n][2] = drop(p2, rk_b, key, thresh, inv_keep);
      sc[n][3] = drop(p3, rk_b, key + 1, thresh, inv_keep);
    }
    // out += P . V: two adjacent score tiles are one 16 x 16 A fragment
#pragma unroll
    for (int kk = 0; kk < TILE_S / 16; ++kk) {
      uint32_t p_hi[4], p_lo[4];
      split_pair(sc[2 * kk][0], sc[2 * kk][1], p_hi[0], p_lo[0]);
      split_pair(sc[2 * kk][2], sc[2 * kk][3], p_hi[1], p_lo[1]);
      split_pair(sc[2 * kk + 1][0], sc[2 * kk + 1][1], p_hi[2], p_lo[2]);
      split_pair(sc[2 * kk + 1][2], sc[2 * kk + 1][3], p_hi[3], p_lo[3]);
#pragma unroll
      for (int np = 0; np < E / 16; ++np) {
        uint32_t b[4];  // columns 16 np .. + 7: b[0], b[1]; columns + 8: b[2], b[3]
        ldmatrix_x4_trans(b, Vs + (kk * 16 + v_row) * KV_LD + np * 16 + v_col);
        mma_bf16(acc[2 * np], p_hi, b[0], b[1]);
        mma_bf16(acc[2 * np], p_lo, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], p_hi, b[2], b[3]);
        mma_bf16(acc[2 * np + 1], p_lo, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const bool whole = gridDim.z == 1;
  const float w_a = whole ? 1.f / l_a : 1.f, w_b = whole ? 1.f / l_b : 1.f;
  float* dst = whole ? out : part_o + size_t(blockIdx.z) * R * H * E;
  float* dst_a = dst + (size_t(row_a) * H + h) * E + 2 * t4;
  float* dst_b = dst + (size_t(row_b) * H + h) * E + 2 * t4;
#pragma unroll
  for (int n = 0; n < E / 8; ++n) {
    if (ok_a)
      *reinterpret_cast<float2*>(dst_a + n * 8) = make_float2(acc[n][0] * w_a, acc[n][1] * w_a);
    if (ok_b)
      *reinterpret_cast<float2*>(dst_b + n * 8) = make_float2(acc[n][2] * w_b, acc[n][3] * w_b);
  }
  if (t4 == 0) {
    if (whole) {
      if (lse != nullptr) {
        if (ok_a) lse[size_t(row_a) * H + h] = (m_a + log2f(l_a)) * LN2;
        if (ok_b) lse[size_t(row_b) * H + h] = (m_b + log2f(l_b)) * LN2;
      }
    } else {
      float* ml = part_ml + size_t(blockIdx.z) * R * H * 2;
      if (ok_a)
        *reinterpret_cast<float2*>(ml + (size_t(row_a) * H + h) * 2) = make_float2(m_a, l_a);
      if (ok_b)
        *reinterpret_cast<float2*>(ml + (size_t(row_b) * H + h) * 2) = make_float2(m_b, l_b);
    }
  }
}

// out, lse of one (query row, head) from its key splits, added in split
// order: one block per (row, head), one thread per column
__global__ void __launch_bounds__(E)
reprog_attn_combine_kernel(const float* __restrict__ part_o,
                           const float* __restrict__ part_ml, float* __restrict__ out,
                           float* __restrict__ lse, long long RH, int n_split) {
  const long long rh = blockIdx.x;
  const int e = threadIdx.x;
  float m = -INFINITY;
  for (int z = 0; z < n_split; ++z) m = fmaxf(m, part_ml[(z * RH + rh) * 2]);
  float l = 0.f, o = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float w = exp2f(part_ml[(z * RH + rh) * 2] - m);
    l += part_ml[(z * RH + rh) * 2 + 1] * w;
    o += part_o[(z * RH + rh) * E + e] * w;
  }
  out[rh * E + e] = o / l;
  if (lse != nullptr && e == 0) lse[rh] = (m + log2f(l)) * LN2;
}

// dq = scale * sum_s ds[r, s] k[s], ds = p * (dp * keep / (1 - rate) - delta),
// one block per (MAX_ROWS-row tile of the BL query rows, head); also stores
// delta for the dk/dv kernel
__global__ void __launch_bounds__(THREADS)
reprog_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, float* __restrict__ dq,
                          int BL, int H, int S, float scale,
                          uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // (MAX_ROWS, E)
  float* dOs = Qs + MAX_ROWS * E;            // (MAX_ROWS, E)
  float* Ks = dOs + MAX_ROWS * E;            // (TILE_S, KSTRIDE)
  float* Vs = Ks + TILE_S * KSTRIDE;         // (TILE_S, KSTRIDE)
  float* Ds = Vs + TILE_S * KSTRIDE;         // (MAX_ROWS, TILE_S): ds
  float* lse_s = Ds + MAX_ROWS * TILE_S;
  float* dl_s = lse_s + MAX_ROWS;
  uint32_t* rk_s = reinterpret_cast<uint32_t*>(dl_s + MAX_ROWS);

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  // 32-bit row arithmetic (B * L is checked to fit): with row0 a size_t this
  // kernel took 8.3 ms for 4.4 at the HOP shape on an H100
  const int row0 = blockIdx.x * MAX_ROWS;
  const int rows = min(MAX_ROWS, BL - row0);
  const uint32_t hk = hop_dropout::head_key(seed, h);
  const int warp = tid / 32, lane = tid % 32;

  // block row r is global query row row0 + r, at offset (row * H + h) * E
  for (int idx = tid; idx < MAX_ROWS * E; idx += THREADS) {
    const int r = idx / E, e = idx % E;
    float qv = 0.f, dv = 0.f;
    if (r < rows) {
      const size_t off = (size_t(row0 + r) * H + h) * E + e;
      qv = __bfloat162float(q[off]);
      dv = __bfloat162float(dout[off]);
    }
    Qs[idx] = qv;
    dOs[idx] = dv;
  }
  __syncthreads();
  // delta = rowsum(dO * O), one warp per row
  for (int r = warp; r < MAX_ROWS; r += WARPS) {
    float part = 0.f;
    const size_t row = size_t(row0 + r);
    if (r < rows) {
      const float* orow = out + (row * H + h) * E;
      for (int e = lane; e < E; e += 32) part += dOs[r * E + e] * orow[e];
    }
    const float dsum = warp_sum(part);
    if (lane == 0) {
      dl_s[r] = dsum;
      lse_s[r] = r < rows ? lse[row * H + h] : 0.f;
      rk_s[r] = hop_dropout::row_key(hk, uint32_t(row));
      if (r < rows) delta[row * H + h] = dsum;
    }
  }

  const int sj = tid % TILE_S, sg = tid / TILE_S;
  const int oe = tid % E, og = tid / E;
  float acc[O_ROWS];
#pragma unroll
  for (int i = 0; i < O_ROWS; ++i) acc[i] = 0.f;

  const __nv_bfloat16* kh = k + size_t(h) * S * E;
  const __nv_bfloat16* vh = v + size_t(h) * S * E;

  for (int s0 = 0; s0 < S; s0 += TILE_S) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < TILE_S * E; idx += THREADS) {
      const int j = idx / E, e = idx % E;
      const bool ok = s0 + j < S;
      const size_t off = size_t(s0 + j) * E + e;
      Ks[j * KSTRIDE + e] = ok ? __bfloat162float(kh[off]) : 0.f;
      Vs[j * KSTRIDE + e] = ok ? __bfloat162float(vh[off]) : 0.f;
    }
    __syncthreads();

    {
      float sc[S_ROWS], dp[S_ROWS];
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i) sc[i] = dp[i] = 0.f;
      const float* krow = Ks + sj * KSTRIDE;
      const float* vrow = Vs + sj * KSTRIDE;
#pragma unroll 2
      for (int e = 0; e < E; ++e) {
        const float kv = krow[e], vv = vrow[e];
#pragma unroll
        for (int i = 0; i < S_ROWS; ++i) {
          const int r = sg + S_GROUPS * i;
          sc[i] += Qs[r * E + e] * kv;
          dp[i] += dOs[r * E + e] * vv;
        }
      }
      const bool ok = s0 + sj < S;
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i) {
        const int r = sg + S_GROUPS * i;
        float ds = 0.f;
        if (ok && r < rows) {
          const float p = expf(sc[i] * scale - lse_s[r]);
          ds = p * (drop(dp[i], rk_s[r], s0 + sj, thresh, inv_keep) - dl_s[r]);
        }
        Ds[r * TILE_S + sj] = ds;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < TILE_S; ++j) {
      const float kv = Ks[j * KSTRIDE + oe];
#pragma unroll
      for (int i = 0; i < O_ROWS; ++i) acc[i] += Ds[(og + O_GROUPS * i) * TILE_S + j] * kv;
    }
  }

#pragma unroll
  for (int i = 0; i < O_ROWS; ++i) {
    const int r = og + O_GROUPS * i;
    if (r < rows) dq[(size_t(row0 + r) * H + h) * E + oe] = acc[i] * scale;
  }
}

// dk, dv of one (64-key tile, head): walks every query row of the batch in
// chunks of ROW_CHUNK, in order; needs delta from the dq kernel
__global__ void __launch_bounds__(THREADS)
reprog_attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int BL, int H, int S, float scale,
                            uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ float smem[];
  float* Ks = smem;                          // (KV_TILE, KSTRIDE)
  float* Vs = Ks + KV_TILE * KSTRIDE;        // (KV_TILE, KSTRIDE)
  float* Qs = Vs + KV_TILE * KSTRIDE;        // (ROW_CHUNK, KSTRIDE)
  float* dOs = Qs + ROW_CHUNK * KSTRIDE;     // (ROW_CHUNK, KSTRIDE)
  float* Ps = dOs + ROW_CHUNK * KSTRIDE;     // (ROW_CHUNK, PSTRIDE): dropped p
  float* Ds = Ps + ROW_CHUNK * PSTRIDE;      // (ROW_CHUNK, PSTRIDE): ds
  float* lse_s = Ds + ROW_CHUNK * PSTRIDE;
  float* dl_s = lse_s + ROW_CHUNK;
  uint32_t* rk_s = reinterpret_cast<uint32_t*>(dl_s + ROW_CHUNK);

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * KV_TILE;
  const int h = blockIdx.y;
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t hk = hop_dropout::head_key(seed, h);

  const __nv_bfloat16* kh = k + size_t(h) * S * E;
  const __nv_bfloat16* vh = v + size_t(h) * S * E;
  for (int idx = tid; idx < KV_TILE * E; idx += THREADS) {
    const int j = idx / E, e = idx % E;
    const bool ok = j0 + j < S;
    const size_t off = size_t(j0 + j) * E + e;
    Ks[j * KSTRIDE + e] = ok ? __bfloat162float(kh[off]) : 0.f;
    Vs[j * KSTRIDE + e] = ok ? __bfloat162float(vh[off]) : 0.f;
  }

  // phase A: thread -> keys lane + 32 c (c < 2), rows warp + 8 i (i < 8)
  // phase B: thread -> columns lane + 32 c (c < 4), keys warp + 8 i (i < 8)
  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int r0 = 0; r0 < BL; r0 += ROW_CHUNK) {
    __syncthreads();  // K/V loaded / previous chunk fully consumed
    for (int idx = tid; idx < ROW_CHUNK * E; idx += THREADS) {
      const int r = idx / E, e = idx % E;
      float qv = 0.f, gv = 0.f;
      if (r0 + r < BL) {
        const size_t off = (size_t(r0 + r) * H + h) * E + e;
        qv = __bfloat162float(q[off]);
        gv = __bfloat162float(dout[off]);
      }
      Qs[r * KSTRIDE + e] = qv;
      dOs[r * KSTRIDE + e] = gv;
    }
    for (int r = tid; r < ROW_CHUNK; r += THREADS) {
      const bool ok = r0 + r < BL;
      lse_s[r] = ok ? lse[size_t(r0 + r) * H + h] : 0.f;
      dl_s[r] = ok ? delta[size_t(r0 + r) * H + h] : 0.f;
      rk_s[r] = hop_dropout::row_key(hk, uint32_t(r0 + r));
    }
    __syncthreads();

    // phase A: scores and dO v^T for the chunk, then the dropped p and ds
    {
      float sc[8][2], dp[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) sc[i][0] = sc[i][1] = dp[i][0] = dp[i][1] = 0.f;
      const float* k0 = Ks + lane * KSTRIDE;
      const float* k1 = Ks + (lane + 32) * KSTRIDE;
      const float* v0 = Vs + lane * KSTRIDE;
      const float* v1 = Vs + (lane + 32) * KSTRIDE;
#pragma unroll 2
      for (int e = 0; e < E; ++e) {
        const float ka = k0[e], kb = k1[e], va = v0[e], vb = v1[e];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float qv = Qs[(warp + 8 * i) * KSTRIDE + e];
          const float gv = dOs[(warp + 8 * i) * KSTRIDE + e];
          sc[i][0] += qv * ka;
          sc[i][1] += qv * kb;
          dp[i][0] += gv * va;
          dp[i][1] += gv * vb;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        const bool row_ok = r0 + r < BL;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          float pd = 0.f, ds = 0.f;
          if (row_ok) {
            // keys past S meet zero K/V rows; their dk/dv are never stored
            const float p = expf(sc[i][c] * scale - lse_s[r]);
            pd = drop(p, rk_s[r], j0 + j, thresh, inv_keep);
            ds = p * (drop(dp[i][c], rk_s[r], j0 + j, thresh, inv_keep) - dl_s[r]);
          }
          Ps[r * PSTRIDE + j] = pd;
          Ds[r * PSTRIDE + j] = ds;
        }
      }
    }
    __syncthreads();

    // phase B: dv += pd^T dO, dk += ds^T q over the chunk's rows
#pragma unroll 2
    for (int r = 0; r < ROW_CHUNK; ++r) {
      float gv[4], qv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gv[c] = dOs[r * KSTRIDE + lane + 32 * c];
        qv[c] = Qs[r * KSTRIDE + lane + 32 * c];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pd = Ps[r * PSTRIDE + warp + 8 * i];
        const float ds = Ds[r * PSTRIDE + warp + 8 * i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc_dv[i][c] += pd * gv[c];
          acc_dk[i][c] += ds * qv[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = j0 + warp + 8 * i;
    if (j < S) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const size_t off = (size_t(h) * S + j) * E + lane + 32 * c;
        dk[off] = acc_dk[i][c] * scale;
        dv[off] = acc_dv[i][c];
      }
    }
  }
}

bool bad_shape(int B, int L, int H, int S) {
  return B < 1 || L < 1 || (long long)B * L > 0x7fffffffLL - 2 * FWD_ROWS || H < 1 ||
         H > 65535 || S < 1;
}

}  // namespace

// n_split > 1 cuts the key tiles into n_split runs of ceil(tiles / n_split)
// (every run must hold a tile) and needs the workspaces part_o
// (n_split, B, L, H, E) and part_ml (n_split, B, L, H, 2) f32; with
// n_split == 1 they may be NULL.
extern "C" int hop_reprog_attn_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, void* part_o,
                                   void* part_ml, int n_split, int B, int L,
                                   int H, int S, float scale, uint32_t seed,
                                   uint32_t thresh, float inv_keep,
                                   void* stream) {
  if (bad_shape(B, L, H, S)) return int(cudaErrorInvalidValue);
  const int n_tiles = (S + TILE_S - 1) / TILE_S;
  if (n_split < 1 || n_split > n_tiles || n_split > 65535)
    return int(cudaErrorInvalidValue);
  const int per_split = (n_tiles + n_split - 1) / n_split;
  if ((n_split - 1) * per_split >= n_tiles) return int(cudaErrorInvalidValue);
  if (n_split > 1 && (part_o == nullptr || part_ml == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      reprog_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(FWD_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const int R = B * L;
  const dim3 grid((R + FWD_ROWS - 1) / FWD_ROWS, H, n_split);
  reprog_attn_fwd_kernel<<<grid, FWD_THREADS, FWD_SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), R, H, S, per_split, scale * LOG2E, seed, thresh,
      inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return int(err);
  reprog_attn_combine_kernel<<<unsigned(R) * H, E, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<float*>(out), static_cast<float*>(lse), (long long)R * H, n_split);
  return int(cudaGetLastError());
}

// delta (B, L, H) f32 is scratch the wrapper allocates
extern "C" int hop_reprog_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int L, int H,
                                   int S, float scale, uint32_t seed,
                                   uint32_t thresh, float inv_keep,
                                   void* stream) {
  if (bad_shape(B, L, H, S)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      reprog_attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(DQ_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(
      reprog_attn_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(KV_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* gb = static_cast<const __nv_bfloat16*>(dout);
  reprog_attn_bwd_dq_kernel<<<dim3((B * L + MAX_ROWS - 1) / MAX_ROWS, H), THREADS,
                              DQ_SMEM_BYTES, st>>>(
      qb, kb, vb, static_cast<const float*>(out), gb,
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(dq), B * L, H, S, scale, seed, thresh, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  reprog_attn_bwd_dkdv_kernel<<<dim3((S + KV_TILE - 1) / KV_TILE, H), THREADS,
                                KV_SMEM_BYTES, st>>>(
      qb, kb, vb, gb, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), B * L, H, S, scale, seed, thresh, inv_keep);
  return int(cudaGetLastError());
}
