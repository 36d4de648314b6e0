// Self-attention of the frozen backbone with samples stacked under a
// block-diagonal mask (kernel K5) for Hopper, sm_90a: forward with attention
// dropout, and the backward that recomputes the probabilities.
//
// Replaces the TPU kernels `_fwd_kernel` (:127-148) and `_bwd_kernel`
// (:150-192) of hop_tpu/ops/pallas_block_attention.py, with `_block_mask`
// (:101-108) and `_probs` (:110-114). The function is kernel K4's
// (attention.cu): per (sample, head), out = dropout(softmax(q k^T scale)) v
// for q, k, v (B, T, H, D=64) bf16, here with out, dq, dk, dv in f32. What
// defines K5 is the formulation: nb <= 8 samples of one head are stacked to
// M = nb * T rows, scores are formed against the M stacked keys, and the
// block-diagonal mask (row / T == col / T) removes the cross-sample products
// before the f32 softmax.
//
// Since a head's row of sample b, step t lies at ((b * T + t) * H + h) * D,
// the stacked (M, 64) matrix of a group is a strided matrix in device memory
// as it stands (row stride H * D): nothing is transposed or copied to stack.
//
// Why stack on this card: the tensor cores take 16-row tiles, and T=34 is
// not a multiple of 16, but nb = 8 samples are M = 272 = 17 * 16 rows
// exactly. A block is one (group, head); each of its warps owns a 16-row
// strip of queries and runs bf16 m16n16k16 tiles (nvcuda::wmma, mma.sync)
// with f32 accumulators. The strip's rows belong to at most two samples, so
// only the key tiles that hold those samples' keys (at most MAX_TILES) are
// computed; the mask is applied inside those tiles and the all-masked tiles
// are skipped, not computed and discarded. The TPU program kept the whole
// (272, 272) f32 score matrix of a head resident and looped over the heads.
//
// Forward, per strip: S = Q K^T into the warp's shared-memory strip, masked
// f32 softmax with two lanes a row, dropout by the hash of dropout_bits.cuh
// with the key's index INSIDE ITS SAMPLE as the key coordinate (so K4 and K5
// draw one mask), then O = P V. The tensor cores want bf16 operands: each f32
// probability goes in as hi + lo, its bf16 rounding and the rounding of the
// remainder (two mma per tile), so no accuracy is given up to bf16. A ragged
// last group (fewer than nb samples, or rows past the end of the batch) is
// masked by row: tiles that reach past the last row of the batch are staged
// through shared memory with zeros, their rows get probability 0 and are
// never stored.
//
// Backward, one kernel, two phases around one __syncthreads():
//   1. query strips, as the forward: p, then dP = dO V^T tile by tile, once
//      for delta = rowsum(dP o keep o p) and once more for dS = p (dP o keep
//      - delta) scale, dQ = dS K (dS as hi + lo); each row's log-sum-exp and
//      delta go to shared memory;
//   2. key strips, in two passes over the query tiles of the strip's
//      samples: S^T = K Q^T is recomputed, p = exp(s - lse), and
//      dV += (p o keep)^T dO accumulates in fragments; then again with
//      dP^T = V dO^T for dK += dS^T Q.
// Every dq, dk, dv row has one owner and one summation order: no atomics,
// results repeat bit for bit. The function needs five products; the two
// phases run nine (dP twice in phase 1; S twice and dP once more in phase 2):
// a 17-warp block leaves a thread 96 registers, which hold one strip's
// accumulators but not two, and recomputing a 16 x 16 x 64 tile product
// measured cheaper on an H100 than spilling them.
//
// What bounds it: bytes (0.9 / 2.3 GFLOP against 67 / 134 MB at B=256, T=34,
// H=12: 0.020 / 0.040 ms at 3.35 TB/s). Operand tiles are read straight from
// device memory into fragments, each by the few warps whose samples it
// belongs to (L1/L2 serve the re-reads); no intermediate reaches device
// memory. A block of 17 warps uses 222 KB of shared memory (13 KB a warp), so
// one block runs per SM; wgmma, TMA and a leaner strip layout are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "dropout_bits.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int D = 64;                       // head dim
constexpr int STRIP = 16;                   // rows of a strip, keys of a tile
constexpr int NB_MAX = 8;                   // samples a group stacks at most
constexpr int MAX_ROWS = 272;               // rows of a group at most
constexpr int MAX_STRIPS = MAX_ROWS / STRIP;
constexpr int MAX_TILES = 6;                // key tiles a strip needs at most
constexpr int COLS = MAX_TILES * STRIP;
constexpr int SA = COLS + 4;                // f32 score strip: row stride
constexpr int SB = COLS + 8;                // bf16 hi / lo strips: row stride
constexpr int ST = D + 8;                   // staged 16 x 64 bf16 tile: row stride
constexpr int SO = D + 4;                   // staged 16 x 64 f32 result: row stride
constexpr int SCR = 20;                     // 16 x 16 f32 scratch tile: row stride
constexpr int HL = 24;                      // 16 x 16 bf16 hi / lo tile: row stride
constexpr int A_BYTES = STRIP * SA * 4;     // 6400
constexpr int B_BYTES = 2 * STRIP * SB * 2; // 6656
constexpr int WARP_BYTES = A_BYTES + B_BYTES;
constexpr int TILE_BYTES = STRIP * ST * 2;  // 2304
constexpr int SCR_BYTES = STRIP * SCR * 4;  // 1280
constexpr int HL_BYTES = STRIP * HL * 2;    // 768
constexpr unsigned FULL = 0xffffffffu;

static_assert(MAX_ROWS % STRIP == 0, "a full group is whole strips");
static_assert(A_BYTES % 32 == 0 && B_BYTES % 32 == 0 && TILE_BYTES % 32 == 0 &&
              SCR_BYTES % 32 == 0 && HL_BYTES % 32 == 0, "wmma wants 32-byte aligned tiles");
static_assert(STRIP * SO * 4 <= WARP_BYTES && 2 * TILE_BYTES <= B_BYTES &&
              TILE_BYTES + SCR_BYTES <= B_BYTES &&
              4 * TILE_BYTES + SCR_BYTES + 2 * HL_BYTES <= WARP_BYTES,
              "a warp's scratch layouts fit its region");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// dropout factor of one probability: 1 / (1 - rate) when kept, else 0
__device__ __forceinline__ float keep_factor(uint32_t rk, uint32_t s, uint32_t thresh,
                                             float inv_keep) {
  if (thresh == 0u) return 1.f;
  return hop_dropout::bits(rk, s) >= thresh ? inv_keep : 0.f;
}

// x as hi + lo: its bf16 rounding and the rounding of the remainder
__device__ __forceinline__ void split(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(x);
  lo = __float2bfloat16(x - __bfloat162float(hi));
}

struct Rows {
  const bf16* p;
  int ld;
};

// The 16 x 64 tile of one head whose first row is stacked row `row` of the
// whole batch (R rows, row stride ldg): straight from device memory when all
// 16 rows exist, else a copy in `stage` with zeros past the last row.
__device__ __forceinline__ Rows tile_rows(const bf16* head, long long row, long long R,
                                          int ldg, bf16* stage, int lane) {
  if (row + STRIP <= R) return {head + row * ldg, ldg};
  __syncwarp();
  for (int piece = lane; piece < STRIP * (D / 8); piece += 32) {
    const int r = piece / (D / 8), c = piece % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row + r < R) val = *reinterpret_cast<const uint4*>(head + (row + r) * ldg + c * 8);
    *reinterpret_cast<uint4*>(stage + r * ST + c * 8) = val;
  }
  __syncwarp();
  return {stage, ST};
}

struct Span {
  int c0;       // first column (a multiple of 16)
  int ntiles;   // 16-column tiles
};

// The columns that hold the samples which rows [r0, r0 + 16) of a group of Rg
// rows belong to, widened to whole tiles. (Keys of a query strip, or queries
// of a key strip.)
__host__ __device__ __forceinline__ Span sample_span(int r0, int Rg, int T) {
  const int first = (r0 / T) * T;
  const int end = r0 + STRIP < Rg ? r0 + STRIP : Rg;
  const int last = ((end - 1) / T) * T + T;
  const int c0 = first / STRIP * STRIP;
  return {c0, (last + STRIP - 1) / STRIP - first / STRIP};
}

// acc[n] (n < 4) += (hi + lo) (16 x 16, rows of `ld`) x rows[:, 16 n : 16 n + 16]
__device__ __forceinline__ void mma_split(FragC (&acc)[4], const bf16* hi, const bf16* lo,
                                          int ld, const Rows rows) {
  FragA a_hi, a_lo;
  wmma::load_matrix_sync(a_hi, hi, ld);
  wmma::load_matrix_sync(a_lo, lo, ld);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    FragBr b;
    wmma::load_matrix_sync(b, rows.p + n * 16, rows.ld);
    wmma::mma_sync(acc[n], a_hi, b, acc[n]);
    wmma::mma_sync(acc[n], a_lo, b, acc[n]);
  }
}

// scr (16 x 16 f32, rows of SCR) = X Y^T for two 16 x 64 tiles
__device__ __forceinline__ void rows_dot_rows_t(float* scr, const Rows x, const Rows y) {
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA a;
    FragBc b;
    wmma::load_matrix_sync(a, x.p + kk * 16, x.ld);
    wmma::load_matrix_sync(b, y.p + kk * 16, y.ld);
    wmma::mma_sync(acc, a, b, acc);
  }
  __syncwarp();
  wmma::store_matrix_sync(scr, acc, SCR, wmma::mem_row_major);
  __syncwarp();
}

// acc (16 x 64 f32) to rows [r0, r0 + 16) of dst (row stride ldg); rows at or
// past Rg belong to no sample of this group and are not stored
__device__ __forceinline__ void store_rows(float* dst, FragC (&acc)[4], int r0, int Rg,
                                           int ldg, float* stage, int lane) {
  if (r0 + STRIP <= Rg) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(dst + n * 16, acc[n], ldg, wmma::mem_row_major);
    return;
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], SO, wmma::mem_row_major);
  __syncwarp();
  for (int idx = lane; idx < STRIP * (D / 4); idx += 32) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    if (r0 + r < Rg)
      *reinterpret_cast<float4*>(dst + size_t(r) * ldg + c * 4) =
          *reinterpret_cast<const float4*>(stage + r * SO + c * 4);
  }
  __syncwarp();
}

// S = X Y^T for the strip whose 16 rows of X start at stacked row `row`, over
// the span's tiles of Y, into A (rows of SA floats)
__device__ __forceinline__ void strip_scores(float* A, const bf16* xh, const bf16* yh,
                                             long long g0, int r0, const Span span,
                                             long long R, int ldg, bf16* stage, int lane) {
  FragA xa[4];
  {
    const Rows xr = tile_rows(xh, g0 + r0, R, ldg, stage, lane);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(xa[kk], xr.p + kk * 16, xr.ld);
  }
  for (int t = 0; t < span.ntiles; ++t) {
    const Rows yr = tile_rows(yh, g0 + span.c0 + t * STRIP, R, ldg, stage, lane);
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragBc yb;
      wmma::load_matrix_sync(yb, yr.p + kk * 16, yr.ld);
      wmma::mma_sync(acc, xa[kk], yb, acc);
    }
    wmma::store_matrix_sync(A + t * STRIP, acc, SA, wmma::mem_row_major);
  }
  __syncwarp();
}

// What one lane knows of its row of a strip: lanes 2 r and 2 r + 1 share row r
struct RowInfo {
  int row, half;
  bool valid;       // the row belongs to a sample of this group
  int lo, hi;       // its sample's keys, as columns of the strip
  uint32_t rk;      // dropout key of the row
};

__device__ __forceinline__ RowInfo row_info(int lane, int r0, int Rg, int T, const Span span,
                                            uint32_t hk, long long g0) {
  RowInfo ri;
  ri.row = lane >> 1;
  ri.half = lane & 1;
  const int gr = r0 + ri.row;
  ri.valid = gr < Rg;
  ri.lo = (ri.valid ? gr / T : 0) * T - span.c0;
  ri.hi = ri.lo + T;
  ri.rk = hop_dropout::row_key(hk, uint32_t(g0 + gr));
  return ri;
}

// Masked f32 softmax of the strip's scores in place: A[row][j] becomes the
// probability (0 at keys of other samples and in rows of no sample). Returns
// the row's log-sum-exp of the scaled scores (0 for a row of no sample).
__device__ __forceinline__ float strip_softmax(float* A, const RowInfo ri, int ncols,
                                               float scale) {
  float* srow = A + ri.row * SA;
  float mx = -INFINITY;
  if (ri.valid)
    for (int j = ri.half; j < ncols; j += 2)
      if (j >= ri.lo && j < ri.hi) mx = fmaxf(mx, srow[j] * scale);
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
  float sum = 0.f;
  if (ri.valid)
    for (int j = ri.half; j < ncols; j += 2)
      if (j >= ri.lo && j < ri.hi) {
        const float e = expf(srow[j] * scale - mx);
        srow[j] = e;
        sum += e;
      }
  sum += __shfl_xor_sync(FULL, sum, 1);
  const float inv = ri.valid ? 1.f / sum : 0.f;
  for (int j = ri.half; j < ncols; j += 2)
    srow[j] = (ri.valid && j >= ri.lo && j < ri.hi) ? srow[j] * inv : 0.f;
  return ri.valid ? mx + logf(sum) : 0.f;
}

__global__ void __launch_bounds__(MAX_STRIPS * 32)
block_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, float* __restrict__ out, int B, int T,
                      int H, int nb, float scale, uint32_t seed, uint32_t thresh,
                      float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int h = blockIdx.y;
  const int b0 = blockIdx.x * nb;
  const int Rg = min(nb, B - b0) * T;           // rows of this group
  const long long R = (long long)B * T;         // stacked rows of the batch
  const long long g0 = (long long)b0 * T;       // the group's first
  const int ldg = H * D;
  const uint32_t hk = hop_dropout::head_key(seed, h);
  const bf16 *qh = q + h * D, *kh = k + h * D, *vh = v + h * D;

  float* A = reinterpret_cast<float*>(smem + warp * WARP_BYTES);   // scores
  bf16* Phi = reinterpret_cast<bf16*>(smem + warp * WARP_BYTES + A_BYTES);
  bf16* Plo = Phi + STRIP * SB;

  const int nstrips = (Rg + STRIP - 1) / STRIP;
  for (int strip = warp; strip < nstrips; strip += nwarps) {
    const int r0 = strip * STRIP;
    const Span span = sample_span(r0, Rg, T);
    const int ncols = span.ntiles * STRIP;
    // the probabilities do not exist yet: their strips stage operand tiles
    strip_scores(A, qh, kh, g0, r0, span, R, ldg, Phi, lane);

    const RowInfo ri = row_info(lane, r0, Rg, T, span, hk, g0);
    strip_softmax(A, ri, ncols, scale);
    for (int j = ri.half; j < ncols; j += 2) {
      float p = A[ri.row * SA + j];
      if (p != 0.f) p *= keep_factor(ri.rk, uint32_t(j - ri.lo), thresh, inv_keep);
      split(p, Phi[ri.row * SB + j], Plo[ri.row * SB + j]);
    }
    __syncwarp();

    FragC acc[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
    for (int t = 0; t < span.ntiles; ++t) {
      // the scores are dead: their strip stages V tiles
      const Rows vr = tile_rows(vh, g0 + span.c0 + t * STRIP, R, ldg,
                                reinterpret_cast<bf16*>(A), lane);
      mma_split(acc, Phi + t * STRIP, Plo + t * STRIP, SB, vr);
    }
    store_rows(out + (g0 + r0) * ldg + h * D, acc, r0, Rg, ldg, A, lane);
    __syncwarp();   // the warp's next strip reuses the region
  }
}

__global__ void __launch_bounds__(MAX_STRIPS * 32)
block_attn_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      float* __restrict__ dq, float* __restrict__ dk,
                      float* __restrict__ dv, int B, int T, int H, int nb, float scale,
                      uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int h = blockIdx.y;
  const int b0 = blockIdx.x * nb;
  const int Rg = min(nb, B - b0) * T;
  const long long R = (long long)B * T;
  const long long g0 = (long long)b0 * T;
  const int ldg = H * D;
  const uint32_t hk = hop_dropout::head_key(seed, h);
  const bf16 *qh = q + h * D, *kh = k + h * D, *vh = v + h * D, *gh = dout + h * D;

  unsigned char* W = smem + warp * WARP_BYTES;
  // per query row of the group: log-sum-exp of its scaled scores, and delta
  float* lse_s = reinterpret_cast<float*>(smem + nwarps * WARP_BYTES);
  float* delta_s = lse_s + MAX_ROWS;
  const int nstrips = (Rg + STRIP - 1) / STRIP;

  // ---- phase 1: query strips -> lse, delta, dq ----------------------------
  for (int strip = warp; strip < nstrips; strip += nwarps) {
    const int r0 = strip * STRIP;
    const Span span = sample_span(r0, Rg, T);
    float* A = reinterpret_cast<float*>(W);                   // p, then dS
    bf16* stage = reinterpret_cast<bf16*>(W + A_BYTES);       // operand tiles
    float* scr = reinterpret_cast<float*>(W + A_BYTES + TILE_BYTES);
    bf16* Shi = reinterpret_cast<bf16*>(W + A_BYTES);         // dS as hi + lo
    bf16* Slo = Shi + STRIP * SB;

    strip_scores(A, qh, kh, g0, r0, span, R, ldg, stage, lane);
    const RowInfo ri = row_info(lane, r0, Rg, T, span, hk, g0);
    const float lse = strip_softmax(A, ri, span.ntiles * STRIP, scale);
    if (ri.half == 0) lse_s[r0 + ri.row] = lse;
    __syncwarp();

    // dP = dO V^T goes tile by tile through the scratch tile, where a lane
    // reads 8 columns of its row: once for delta = sum_j dP keep p, and once
    // more (recomputed, not kept: six fragments would not fit the registers)
    // for dS = p (dP keep - delta) scale, which takes p's place
    FragA ga[4];
    {
      const Rows gr = tile_rows(gh, g0 + r0, R, ldg, stage, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(ga[kk], gr.p + kk * 16, gr.ld);
    }
    float delta = 0.f;
    for (int pass = 0; pass < 2; ++pass) {
      float part = 0.f;
      for (int t = 0; t < span.ntiles; ++t) {
        const Rows vr = tile_rows(vh, g0 + span.c0 + t * STRIP, R, ldg, stage, lane);
        FragC dp;
        wmma::fill_fragment(dp, 0.f);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          FragBc vb;
          wmma::load_matrix_sync(vb, vr.p + kk * 16, vr.ld);
          wmma::mma_sync(dp, ga[kk], vb, dp);
        }
        __syncwarp();
        wmma::store_matrix_sync(scr, dp, SCR, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = t * STRIP + ri.half * 8 + c;
          const float p = A[ri.row * SA + j];
          float dpk = 0.f;      // dP keep, where p is not 0
          if (p != 0.f)
            dpk = scr[ri.row * SCR + ri.half * 8 + c] *
                  keep_factor(ri.rk, uint32_t(j - ri.lo), thresh, inv_keep);
          if (pass == 0)
            part += dpk * p;
          else
            A[ri.row * SA + j] = p * (dpk - delta) * scale;
        }
      }
      if (pass == 0) {
        delta = part + __shfl_xor_sync(FULL, part, 1);
        if (ri.half == 0) delta_s[r0 + ri.row] = delta;
      }
    }
    __syncwarp();
    for (int j = ri.half; j < span.ntiles * STRIP; j += 2)
      split(A[ri.row * SA + j], Shi[ri.row * SB + j], Slo[ri.row * SB + j]);
    __syncwarp();

    // dQ = dS K; dS as f32 is dead: its strip stages K tiles and the result
    FragC acc[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
    for (int t = 0; t < span.ntiles; ++t) {
      const Rows kr = tile_rows(kh, g0 + span.c0 + t * STRIP, R, ldg,
                                reinterpret_cast<bf16*>(A), lane);
      mma_split(acc, Shi + t * STRIP, Slo + t * STRIP, SB, kr);
    }
    store_rows(dq + (g0 + r0) * ldg + h * D, acc, r0, Rg, ldg, A, lane);
    __syncwarp();
  }
  __syncthreads();

  // ---- phase 2: key strips -> dk, dv ---------------------------------------
  for (int strip = warp; strip < nstrips; strip += nwarps) {
    const int j0 = strip * STRIP;
    const Span span = sample_span(j0, Rg, T);     // the strip's samples' queries
    bf16* kst = reinterpret_cast<bf16*>(W);
    bf16* vst = reinterpret_cast<bf16*>(W + TILE_BYTES);
    bf16* qst = reinterpret_cast<bf16*>(W + 2 * TILE_BYTES);
    bf16* gst = reinterpret_cast<bf16*>(W + 3 * TILE_BYTES);
    float* scr = reinterpret_cast<float*>(W + 4 * TILE_BYTES);
    bf16* thi = reinterpret_cast<bf16*>(W + 4 * TILE_BYTES + SCR_BYTES);
    bf16* tlo = thi + STRIP * HL;

    const int krow = lane >> 1, half = lane & 1;
    const int gj = j0 + krow;                     // this lane's key, as a group row
    const bool kvalid = gj < Rg;
    const int samp = kvalid ? gj / T : -1;
    const uint32_t kidx = uint32_t(gj - samp * T);    // its index inside its sample

    // two passes over the strip's query tiles, dV then dK: one set of
    // accumulators at a time fits the registers of a 17-warp block
    for (int pass = 0; pass < 2; ++pass) {
      // (staged again: the last store may have used their staging area)
      const Rows kr = tile_rows(kh, g0 + j0, R, ldg, kst, lane);
      const Rows vr = tile_rows(vh, g0 + j0, R, ldg, vst, lane);
      FragC acc[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
      for (int t = 0; t < span.ntiles; ++t) {
        const int qb = span.c0 + t * STRIP;       // the tile's first query, as a group row
        const Rows qr = tile_rows(qh, g0 + qb, R, ldg, qst, lane);
        const Rows gr = tile_rows(gh, g0 + qb, R, ldg, gst, lane);
        // S^T = K Q^T: (16 keys, 16 queries) through the scratch tile; a lane
        // holds 8 queries of its key row
        float p[8], pd[8];      // p and p o keep
        rows_dot_rows_t(scr, kr, qr);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int gq = qb + half * 8 + c;
          p[c] = pd[c] = 0.f;
          if (kvalid && gq < Rg && gq / T == samp) {
            p[c] = expf(scr[krow * SCR + half * 8 + c] * scale - lse_s[gq]);
            pd[c] = p[c] * keep_factor(hop_dropout::row_key(hk, uint32_t(g0 + gq)), kidx,
                                       thresh, inv_keep);
          }
        }
        if (pass == 0) {        // dV += (p o keep)^T dO
#pragma unroll
          for (int c = 0; c < 8; ++c)
            split(pd[c], thi[krow * HL + half * 8 + c], tlo[krow * HL + half * 8 + c]);
        } else {                // dK += dS^T Q, dS = p (dP keep - delta) scale
          rows_dot_rows_t(scr, vr, gr);       // dP^T = V dO^T
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int gq = qb + half * 8 + c;
            float ds = 0.f;
            if (p[c] != 0.f)
              ds = (scr[krow * SCR + half * 8 + c] * pd[c] - p[c] * delta_s[gq]) * scale;
            split(ds, thi[krow * HL + half * 8 + c], tlo[krow * HL + half * 8 + c]);
          }
        }
        __syncwarp();
        mma_split(acc, thi, tlo, HL, pass == 0 ? gr : qr);
        __syncwarp();
      }
      store_rows((pass == 0 ? dv : dk) + (g0 + j0) * ldg + h * D, acc, j0, Rg, ldg,
                 reinterpret_cast<float*>(W), lane);
    }
    __syncwarp();
  }
}

// the checks of ops/block_attention.py `_check`, again
bool bad_shape(int B, int T, int H, int nb) {
  if (B < 1 || T < 1 || H < 1 || H > 65535 || nb < 1 || nb > NB_MAX || nb * T > MAX_ROWS)
    return true;
  for (int r0 = 0; r0 < nb * T; r0 += STRIP)
    if (sample_span(r0, nb * T, T).ntiles > MAX_TILES) return true;
  return false;
}

int block_warps(int T, int nb) { return (nb * T + STRIP - 1) / STRIP; }

}  // namespace

extern "C" int hop_block_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                  int B, int T, int H, int nb, float scale, uint32_t seed,
                                  uint32_t thresh, float inv_keep, void* stream) {
  if (bad_shape(B, T, H, nb)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_STRIPS * WARP_BYTES);
  if (err != cudaSuccess) return int(err);
  const int warps = block_warps(T, nb);
  block_attn_fwd_kernel<<<dim3((B + nb - 1) / nb, H), warps * 32, warps * WARP_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<float*>(out), B, T, H, nb, scale, seed, thresh, inv_keep);
  return int(cudaGetLastError());
}

extern "C" int hop_block_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, void* dq, void* dk, void* dv, int B,
                                  int T, int H, int nb, float scale, uint32_t seed,
                                  uint32_t thresh, float inv_keep, void* stream) {
  if (bad_shape(B, T, H, nb)) return int(cudaErrorInvalidValue);
  constexpr int STATS_BYTES = 2 * MAX_ROWS * int(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_STRIPS * WARP_BYTES + STATS_BYTES);
  if (err != cudaSuccess) return int(err);
  const int warps = block_warps(T, nb);
  block_attn_bwd_kernel<<<dim3((B + nb - 1) / nb, H), warps * 32,
                          warps * WARP_BYTES + STATS_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), B, T, H, nb, scale, seed, thresh, inv_keep);
  return int(cudaGetLastError());
}
