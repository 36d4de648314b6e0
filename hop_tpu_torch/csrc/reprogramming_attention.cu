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
// Backward (flash-attention-2 shape), on the tensor cores. The TPU summed dk
// and dv over batch blocks in a VMEM accumulator, relying on its sequential
// grid; GPU blocks run in parallel and in no order, so the sum is re-cut. Both
// kernels are the forward's block: 4 warps x 16 rows of a 64-row tile, bf16
// tiles by cp.async two stages deep, every product mma.sync.m16n8k16 bf16 with
// f32 accumulators, p = exp2(s * scale * log2(e) - lse * log2(e)) from the
// saved log-sum-exp (no running max), the mask redrawn from the hash:
//   * dq kernel: one block per (64-row tile of the (B * L, E) query matrix,
//     head), any L, the ragged last tile masked by row. Q and dO sit in
//     shared memory (fragments by ldmatrix; with them in registers beside the
//     64 dq and the 32 + 32 score and dP accumulators a thread would spill).
//     It first forms delta = rowsum(dO * O) for its rows (and stores it for
//     the next kernel), then walks the key tiles: S = Q K^T and dP = dO V^T
//     leave their accumulators only as dS = p * (dP * keep / (1 - rate) -
//     delta), the A fragment (hi + lo bf16, two MMAs) of dq += dS K, with K
//     read transposed by ldmatrix as the forward reads V;
//   * dk/dv kernel: one block per (64-key tile, head, run of query rows),
//     K and V of the tile in shared memory, Q and dO streaming through in
//     64-row chunks. It computes the transposed scores S^T = K Q^T and
//     dP^T = V dO^T, so Pd^T = (p * keep / (1 - rate))^T and dS^T are born in
//     the accumulator layout and are the A fragments (hi + lo) of
//     dv += Pd^T dO and dk += dS^T Q; 32 query rows a step, so that the two
//     16 x 128 outputs and the step's scores fit the registers. 24 key tiles x
//     8 heads would leave SMs idle and walk all 8704 rows each: the rows are
//     cut into runs (a count the wrapper derives from the shape alone), each
//     run's dk and dv go to a workspace, and reprog_attn_bwd_combine_kernel
//     adds them in run order and scales dk.
// Each output element is summed in one order: dk and dv are deterministic,
// with no atomics and no "last block finishes" counters.
// What bounds the backward: operations. The function needs five products
// (133.7 GFLOP at the HOP shape, 0.135 ms at the bf16 peak); the kernels run
// ten MMA units of 26.7 GFLOP (S and dP in both, and hi + lo doubles dq, dk
// and dv), at the rate mma.sync starts with exp2, the hi/lo split and one
// hash a score element on the same warps in each kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "dropout_bits.cuh"

namespace {

constexpr int E = 128;            // head dim
constexpr int TILE_S = 64;        // keys per tile

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

// backward: the forward's block (4 warps x 16 rows of a 64-row tile, 64-row
// bf16 tiles padded to KV_LD in shared memory, two cp.async stages)
constexpr int BWD_ROWS = FWD_ROWS;
// dq kernel: the block's Q and dO tiles, then [stage][K, V] tiles
constexpr size_t DQ_SMEM_BYTES =
    size_t(2 + FWD_STAGES * 2) * KV_TILE_ELEMS * sizeof(__nv_bfloat16);
// dk/dv kernel: the block's K and V tiles, then [stage][Q, dO] tiles, then
// [stage][lse * log2(e), delta, row key] of the stage's 64 query rows
constexpr size_t DKDV_TILES_BYTES = DQ_SMEM_BYTES;
constexpr size_t DKDV_SMEM_BYTES =
    DKDV_TILES_BYTES + size_t(FWD_STAGES) * 3 * BWD_ROWS * sizeof(float);
constexpr int Q_HALF = 32;   // query rows of one step of the dk/dv kernel
static_assert(BWD_ROWS == TILE_S && BWD_ROWS % Q_HALF == 0, "one tile shape");

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dropout: p scaled by 1 / (1 - rate) when (row key, key s) is kept, else 0
__device__ __forceinline__ float drop(float p, uint32_t rk, uint32_t s,
                                      uint32_t thresh, float inv_keep) {
  if (thresh == 0u) return p;
  return hop_dropout::bits(rk, s) >= thresh ? p * inv_keep : 0.f;
}

// the tile layer shared with K4 and K5 (attention_tiles.cuh): cp.async,
// ldmatrix, mma.sync, the hi + lo split and the quad reductions
using hop_tiles::cp_async16;
using hop_tiles::cp_async_commit;
using hop_tiles::cp_async_wait;
using hop_tiles::ldmatrix_x4;
using hop_tiles::ldmatrix_x4_trans;
using hop_tiles::mma_bf16;
using hop_tiles::quad_max;
using hop_tiles::quad_sum;
using hop_tiles::split_pair;

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

// 64 rows of 128 bf16 from a matrix whose row r lies at base + r * stride, into
// a padded tile; rows from `rows` on are zero. Every thread of the block calls.
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base, long long stride,
                                          int rows) {
#pragma unroll
  for (int i = 0; i < TILE_S * E / 8 / FWD_THREADS; ++i) {
    const int c = threadIdx.x + i * FWD_THREADS;
    const int row = c / (E / 8), piece = c % (E / 8);
    const bool ok = row < rows;
    cp_async16(tile + row * KV_LD + piece * 8,
               base + (ok ? row * stride + piece * 8 : 0), ok);
  }
}

// acc (16 x 128) += a (16 x 16 NK: 2 NK score tiles in the accumulator
// layout, fed as hi + lo bf16) . tile (16 NK rows x 128, row-major bf16 in
// shared memory, read transposed by ldmatrix): the shape of the forward's
// second product, here dq += dS K, dv += Pd^T dO and dk += dS^T Q.
template <int NK>
__device__ __forceinline__ void mma_from_acc(float (&acc)[E / 8][4],
                                             const float (&a)[2 * NK][4],
                                             const __nv_bfloat16* tile, int lane) {
  const int v_row = lane % 8 + (lane / 8 % 2) * 8, v_col = (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t hi[4], lo[4];
    split_pair(a[2 * kk][0], a[2 * kk][1], hi[0], lo[0]);
    split_pair(a[2 * kk][2], a[2 * kk][3], hi[1], lo[1]);
    split_pair(a[2 * kk + 1][0], a[2 * kk + 1][1], hi[2], lo[2]);
    split_pair(a[2 * kk + 1][2], a[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < E / 16; ++np) {
      uint32_t b[4];  // columns 16 np .. + 7: b[0], b[1]; columns + 8: b[2], b[3]
      ldmatrix_x4_trans(b, tile + (kk * 16 + v_row) * KV_LD + np * 16 + v_col);
      mma_bf16(acc[2 * np], hi, b[0], b[1]);
      mma_bf16(acc[2 * np], lo, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// c (16 x 8 NT) = a_tile[16 rows from a_row0][128] . b_tile[8 NT rows][128]^T,
// both row-major bf16 tiles in shared memory: the scores Q K^T and dO V^T of
// the dq kernel, K Q^T and V dO^T of the dk/dv kernel
template <int NT>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const __nv_bfloat16* a_tile,
                                         const __nv_bfloat16* b_tile, int lane) {
  static_assert(NT % 2 == 0, "ldmatrix.x4 brings two 8-row B tiles");
  const int a_row = lane % 8 + (lane / 8 % 2) * 8, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = (lane / 8 % 2) * 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < E / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, a_tile + a_row * KV_LD + ks * 16 + a_col);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];  // rows 16 np .. + 7: b[0], b[1]; rows + 8: b[2], b[3]
      ldmatrix_x4(b, b_tile + (np * 16 + b_row) * KV_LD + ks * 16 + b_col);
      mma_bf16(c[2 * np], a, b[0], b[1]);
      mma_bf16(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// dq = scale * sum_s ds[r, s] k[s], ds = p * (dp * keep / (1 - rate) - delta),
// p = exp2(s * scale * log2(e) - lse * log2(e)): block (x, y) = (64-row tile of
// the (R = B * L, E) query matrix of head y, head); warp w owns rows 16 w ..
// Also stores delta = rowsum(dO * O) for the dk/dv kernel. The scores and
// dp = dO V^T leave their accumulators only as the dS fragment (hi + lo bf16)
// of dq += dS K.
__global__ void __launch_bounds__(FWD_THREADS, 2)
reprog_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, float* __restrict__ dq,
                          int R, int H, int S, float scale, uint32_t seed,
                          uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + KV_TILE_ELEMS;
  __nv_bfloat16* kv = dOs + KV_TILE_ELEMS;     // [stage][K, V][key][KV_LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int h = blockIdx.y;
  // 32-bit row arithmetic (B * L is checked to fit): a size_t row index
  // doubled the time of this kernel's scalar predecessor
  const int row0 = blockIdx.x * BWD_ROWS;
  const int rows = min(BWD_ROWS, R - row0);
  const int row_a = row0 + warp * 16 + g, row_b = row_a + 8;
  const bool ok_a = row_a < R, ok_b = row_b < R;
  const int n_tiles = (S + TILE_S - 1) / TILE_S;
  const long long q_stride = (long long)H * E;

  const __nv_bfloat16* kh = k + size_t(h) * S * E;
  const __nv_bfloat16* vh = v + size_t(h) * S * E;
  auto load_tile = [&](int tile, int stage) {
    __nv_bfloat16* Ks = kv + stage * 2 * KV_TILE_ELEMS;
    const int s0 = tile * TILE_S;
    load_rows(Ks, kh + size_t(s0) * E, E, S - s0);
    load_rows(Ks + KV_TILE_ELEMS, vh + size_t(s0) * E, E, S - s0);
    cp_async_commit();
  };
  load_rows(Qs, q + (size_t(row0) * H + h) * E, q_stride, rows);
  load_rows(dOs, dout + (size_t(row0) * H + h) * E, q_stride, rows);
  load_tile(0, 0);   // one group with the Q and dO tiles

  // delta of the warp's 16 rows, each lane four columns; lane (g, t4) keeps
  // rows g and g + 8, and waits for its own copies of dO first
  cp_async_wait<0>();
  __syncthreads();
  float dl_a = 0.f, dl_b = 0.f;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + warp * 16 + r;
    float part = 0.f;
    if (row < R) {
      const float4 o = *reinterpret_cast<const float4*>(
          out + (size_t(row) * H + h) * E + 4 * lane);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(
          dOs + (warp * 16 + r) * KV_LD + 4 * lane);
      const float2 d01 = __bfloat1622float2(d2[0]), d23 = __bfloat1622float2(d2[1]);
      part = d01.x * o.x + d01.y * o.y + d23.x * o.z + d23.y * o.w;
    }
    const float dsum = warp_sum(part);
    if (r == g) dl_a = dsum;
    if (r == g + 8) dl_b = dsum;
    if (lane == 0 && row < R) delta[size_t(row) * H + h] = dsum;
  }
  const float lse_a = ok_a ? lse[size_t(row_a) * H + h] * LOG2E : 0.f;
  const float lse_b = ok_b ? lse[size_t(row_b) * H + h] * LOG2E : 0.f;
  const float scale_log2 = scale * LOG2E;

  const uint32_t hk = hop_dropout::head_key(seed, h);
  const uint32_t rk_a = hop_dropout::row_key(hk, uint32_t(row_a));
  const uint32_t rk_b = hop_dropout::row_key(hk, uint32_t(row_b));

  float acc[E / 8][4];
#pragma unroll
  for (int n = 0; n < E / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % FWD_STAGES;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's K and V have landed for every thread
    const __nv_bfloat16* Ks = kv + stage * 2 * KV_TILE_ELEMS;
    const __nv_bfloat16* Vs = Ks + KV_TILE_ELEMS;
    const int s0 = tile * TILE_S;

    // sc[n], dp[n]: the 16 x 8 tiles of keys s0 + 8 n ..
    float sc[TILE_S / 8][4], dp[TILE_S / 8][4];
    mma_rows<TILE_S / 8>(sc, Qs + warp * 16 * KV_LD, Ks, lane);
    mma_rows<TILE_S / 8>(dp, dOs + warp * 16 * KV_LD, Vs, lane);
    const bool ragged = s0 + TILE_S > S;
#pragma unroll
    for (int n = 0; n < TILE_S / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t key = uint32_t(s0 + n * 8 + 2 * t4 + (c & 1));
        const bool lower = c >= 2;
        const float p = exp2f(sc[n][c] * scale_log2 - (lower ? lse_b : lse_a));
        const float ds = p * (drop(dp[n][c], lower ? rk_b : rk_a, key, thresh, inv_keep) -
                              (lower ? dl_b : dl_a));
        // keys past S: their K rows are zero, but p may overflow there
        sc[n][c] = ragged && key >= uint32_t(S) ? 0.f : ds;
      }
    }
    mma_from_acc<TILE_S / 16>(acc, sc, Ks, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float* dst_a = dq + (size_t(row_a) * H + h) * E + 2 * t4;
  float* dst_b = dq + (size_t(row_b) * H + h) * E + 2 * t4;
#pragma unroll
  for (int n = 0; n < E / 8; ++n) {
    if (ok_a)
      *reinterpret_cast<float2*>(dst_a + n * 8) =
          make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (ok_b)
      *reinterpret_cast<float2*>(dst_b + n * 8) =
          make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// dk, dv of one (64-key tile x, head y) over run z of the query rows: chunks
// [z * chunks_per_run, ...) of 64 rows, in order. Warp w owns keys 16 w .. of
// the tile. The transposed scores S^T = K Q^T and dP^T = V dO^T are born in
// the accumulator layout, so Pd^T and dS^T are the A fragments (hi + lo bf16)
// of dv += Pd^T dO and dk += dS^T Q, 32 query rows a step (the registers hold
// both 16 x 128 outputs). With one run it writes dk (scaled) and dv; with
// more, run z's sums to part (run, 2, H, S, E), dk unscaled first, dv second.
// Needs delta from the dq kernel.
__global__ void __launch_bounds__(FWD_THREADS, 2)
reprog_attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            float* __restrict__ part, int R, int H, int S,
                            int chunks_per_run, float scale, uint32_t seed,
                            uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + KV_TILE_ELEMS;
  __nv_bfloat16* qd = Vs + KV_TILE_ELEMS;      // [stage][Q, dO][row][KV_LD]
  float* row_f = reinterpret_cast<float*>(smem_raw + DKDV_TILES_BYTES);
  // [stage][lse * log2(e), delta, row key][row]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int h = blockIdx.y;
  const int s0 = blockIdx.x * TILE_S;
  const int n_chunks = (R + BWD_ROWS - 1) / BWD_ROWS;
  const int chunk0 = blockIdx.z * chunks_per_run;
  const int chunk1 = min(n_chunks, chunk0 + chunks_per_run);
  const long long q_stride = (long long)H * E;
  const uint32_t hk = hop_dropout::head_key(seed, h);

  auto load_chunk = [&](int chunk, int stage) {
    __nv_bfloat16* Qs = qd + stage * 2 * KV_TILE_ELEMS;
    const int r0 = chunk * BWD_ROWS;
    const int rows = min(BWD_ROWS, R - r0);
    load_rows(Qs, q + (size_t(r0) * H + h) * E, q_stride, rows);
    load_rows(Qs + KV_TILE_ELEMS, dout + (size_t(r0) * H + h) * E, q_stride, rows);
    cp_async_commit();
    if (tid < BWD_ROWS) {
      float* f = row_f + stage * 3 * BWD_ROWS;
      const bool ok = tid < rows;
      f[tid] = ok ? lse[size_t(r0 + tid) * H + h] * LOG2E : 0.f;
      f[BWD_ROWS + tid] = ok ? delta[size_t(r0 + tid) * H + h] : 0.f;
      reinterpret_cast<uint32_t*>(f)[2 * BWD_ROWS + tid] =
          hop_dropout::row_key(hk, uint32_t(r0 + tid));
    }
  };
  load_rows(Ks, k + (size_t(h) * S + s0) * E, E, S - s0);
  load_rows(Vs, v + (size_t(h) * S + s0) * E, E, S - s0);
  load_chunk(chunk0, 0);   // one group with the K and V tiles

  float acc_dk[E / 8][4], acc_dv[E / 8][4];
#pragma unroll
  for (int n = 0; n < E / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[n][c] = acc_dv[n][c] = 0.f;
  const float scale_log2 = scale * LOG2E;
  const uint32_t key_a = uint32_t(s0 + warp * 16 + g), key_b = key_a + 8;

  for (int chunk = chunk0; chunk < chunk1; ++chunk) {
    const int stage = (chunk - chunk0) % FWD_STAGES;
    if (chunk + 1 < chunk1) {
      load_chunk(chunk + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's Q, dO and row values are there for every thread
    const __nv_bfloat16* Qs = qd + stage * 2 * KV_TILE_ELEMS;
    const __nv_bfloat16* dOs = Qs + KV_TILE_ELEMS;
    const float* f = row_f + stage * 3 * BWD_ROWS;
    const uint32_t* rk = reinterpret_cast<const uint32_t*>(f) + 2 * BWD_ROWS;

#pragma unroll 1
    for (int half = 0; half < BWD_ROWS / Q_HALF; ++half) {
      const int qr = half * Q_HALF;
      // st[n], dpt[n]: keys (g, g + 8) x query rows qr + 8 n + 2 t4, + 1
      float st[Q_HALF / 8][4], dpt[Q_HALF / 8][4];
      mma_rows<Q_HALF / 8>(st, Ks + warp * 16 * KV_LD, Qs + qr * KV_LD, lane);
      mma_rows<Q_HALF / 8>(dpt, Vs + warp * 16 * KV_LD, dOs + qr * KV_LD, lane);
#pragma unroll
      for (int n = 0; n < Q_HALF / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = qr + n * 8 + 2 * t4 + (c & 1);
          const float p = exp2f(st[n][c] * scale_log2 - f[r]);
          const float keep = drop(1.f, rk[r], c >= 2 ? key_b : key_a, thresh, inv_keep);
          st[n][c] = p * keep;                                    // Pd^T
          dpt[n][c] = p * (dpt[n][c] * keep - f[BWD_ROWS + r]);   // dS^T
        }
      }
      mma_from_acc<Q_HALF / 16>(acc_dv, st, dOs + qr * KV_LD, lane);
      mma_from_acc<Q_HALF / 16>(acc_dk, dpt, Qs + qr * KV_LD, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // keys past S met zero K and V rows; their sums are not stored
  const bool whole = gridDim.z == 1;
  const size_t hse = size_t(H) * S * E;
  float* dk_out = whole ? dk : part + size_t(blockIdx.z) * 2 * hse;
  float* dv_out = whole ? dv : dk_out + hse;
  const float w = whole ? scale : 1.f;
  const size_t off_a = (size_t(h) * S + key_a) * E + 2 * t4;
  const size_t off_b = (size_t(h) * S + key_b) * E + 2 * t4;
#pragma unroll
  for (int n = 0; n < E / 8; ++n) {
    if (key_a < uint32_t(S)) {
      *reinterpret_cast<float2*>(dk_out + off_a + n * 8) =
          make_float2(acc_dk[n][0] * w, acc_dk[n][1] * w);
      *reinterpret_cast<float2*>(dv_out + off_a + n * 8) =
          make_float2(acc_dv[n][0], acc_dv[n][1]);
    }
    if (key_b < uint32_t(S)) {
      *reinterpret_cast<float2*>(dk_out + off_b + n * 8) =
          make_float2(acc_dk[n][2] * w, acc_dk[n][3] * w);
      *reinterpret_cast<float2*>(dv_out + off_b + n * 8) =
          make_float2(acc_dv[n][2], acc_dv[n][3]);
    }
  }
}

// dk = scale * sum of the runs' dk, dv = sum of the runs' dv, in run order:
// one thread per four floats of (2, H, S, E)
__global__ void reprog_attn_bwd_combine_kernel(const float* __restrict__ part,
                                               float* __restrict__ dk,
                                               float* __restrict__ dv, long long hse,
                                               int n_runs, float scale) {
  const long long i = (long long)(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i * 4 >= 2 * hse) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < n_runs; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(part + r * 2 * hse + i * 4);
    s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
  }
  if (i * 4 < hse) {
    s.x *= scale; s.y *= scale; s.z *= scale; s.w *= scale;
    *reinterpret_cast<float4*>(dk + i * 4) = s;
  } else {
    *reinterpret_cast<float4*>(dv + i * 4 - hse) = s;
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

// delta (B, L, H) f32 is scratch the wrapper allocates. n_runs > 1 cuts the
// 64-row chunks of the B * L query rows into n_runs runs of
// ceil(chunks / n_runs) for the dk/dv kernel (every run must hold a chunk)
// and needs the workspace part (n_runs, 2, H, S, E) f32; with n_runs == 1 it
// may be NULL.
extern "C" int hop_reprog_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, void* part, int n_runs,
                                   int B, int L, int H, int S, float scale,
                                   uint32_t seed, uint32_t thresh, float inv_keep,
                                   void* stream) {
  if (bad_shape(B, L, H, S)) return int(cudaErrorInvalidValue);
  const int R = B * L;
  const int n_chunks = (R + BWD_ROWS - 1) / BWD_ROWS;
  if (n_runs < 1 || n_runs > n_chunks || n_runs > 65535)
    return int(cudaErrorInvalidValue);
  const int per_run = (n_chunks + n_runs - 1) / n_runs;
  if ((n_runs - 1) * per_run >= n_chunks) return int(cudaErrorInvalidValue);
  if (n_runs > 1 && part == nullptr) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      reprog_attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(DQ_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(
      reprog_attn_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(DKDV_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* gb = static_cast<const __nv_bfloat16*>(dout);
  reprog_attn_bwd_dq_kernel<<<dim3(n_chunks, H), FWD_THREADS, DQ_SMEM_BYTES, st>>>(
      qb, kb, vb, static_cast<const float*>(out), gb,
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(dq), R, H, S, scale, seed, thresh, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  reprog_attn_bwd_dkdv_kernel<<<dim3((S + TILE_S - 1) / TILE_S, H, n_runs), FWD_THREADS,
                                DKDV_SMEM_BYTES, st>>>(
      qb, kb, vb, gb, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(part), R, H, S, per_run, scale, seed,
      thresh, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_runs == 1) return int(err);
  const long long hse = (long long)H * S * E;
  reprog_attn_bwd_combine_kernel<<<unsigned((2 * hse / 4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dk), static_cast<float*>(dv),
      hse, n_runs, scale);
  return int(cudaGetLastError());
}
