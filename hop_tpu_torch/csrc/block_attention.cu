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
// exactly. A block is one (group, head); a warp owns 16-row strips of
// queries. A strip's rows belong to at most two samples, so only the key
// tiles that hold those samples' keys (at most MAX_TILES) are computed; the
// mask is applied inside those tiles and the all-masked tiles are skipped,
// not computed and discarded. The TPU program kept the whole (272, 272) f32
// score matrix of a head resident and looped over the heads. The dropout
// is the hash of dropout_bits.cuh with the key's index INSIDE ITS SAMPLE as
// the key coordinate, so K4 and K5 draw one mask. The tensor cores want bf16
// operands: each f32 probability (and dS) goes in as hi + lo, its bf16
// rounding and the rounding of the remainder (two mma per tile), so no
// accuracy is given up to bf16. A ragged last group (fewer than nb samples)
// is masked by row: rows past the group's last get probability 0 and are
// never stored.
//
// Forward (redesigned for the H100): the group's Q, K and V rows of one head
// (Rg x 64 bf16 each, 34.8 KB at Rg = 272) come once into shared memory by
// cp.async, unpadded with XOR-swizzled 16-byte pieces (attention_tiles.cuh),
// Q and K as one copy group and V as a second. Nine warps take two strips
// each, and 104 KB of tiles let two blocks share an SM, so one block's copies
// run under the other's products. Per strip, everything stays in registers:
//   * S = Q K^T on mma.sync.m16n8k16 bf16 with f32 accumulators, fragments by
//     ldmatrix from the tiles (no warp re-reads a tile from L2): at most
//     2 * NTILE accumulator tiles of 8 keys, NTILE = key_tiles(T, nb) a
//     template argument (5 at T=34, nb=8: 40 registers);
//   * the mask, the f32 softmax and the dropout on the accumulators, a row in
//     the four lanes of a quad (two shuffles for its max and its sum);
//   * O = P V, P as hi + lo A fragments from the accumulators, V by
//     ldmatrix.trans: 8 tiles of 8 columns, 32 registers;
//   * O stored from the fragments as float2, a full 32-byte sector per row.
// The first strip's probabilities are formed while V lands. Registers: two
// blocks of 9 warps an SM leave a thread 112 (65536 / 576, in steps of 8);
// the peak is P (40) + O (32) + the hi / lo and V fragments (12) + indices.
//
// Backward, one kernel on bf16 m16n16k16 tiles (nvcuda::wmma, f32
// accumulators), two phases around one __syncthreads():
//   1. query strips, one a warp: p (scores through a shared-memory strip),
//      then dP = dO V^T tile by tile, once
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
// H=12: 0.020 / 0.040 ms at 3.35 TB/s); no intermediate reaches device
// memory. The backward is still the first design: operand tiles read
// straight from device memory into wmma fragments by the few warps whose
// samples they belong to (L1/L2 serve the re-reads), a block of 17 warps
// with 222 KB of shared memory (13 KB a warp), one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_tiles.cuh"
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
constexpr int FWD_MAX_WARPS = (MAX_STRIPS + 1) / 2;   // forward: two strips a warp
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

// ---- forward: the group's tiles in shared memory, P in registers ----------

// S and the dropped probabilities of the 16-row strip at group row r0, over
// the strip's key tiles (at most NTILE): Q and K fragments by ldmatrix from
// the group's tiles (rows past the group's last read as its last, never
// kept), mma.m16n8k16 into 2 NTILE accumulator tiles of 8 keys, then the
// block-diagonal mask, softmax and dropout on the accumulators. Key tiles
// past the strip's own are not computed; the mask zeroes their columns.
template <int NTILE>
__device__ __forceinline__ void strip_probs(float (&s)[2 * NTILE][4], const unsigned char* Qs,
                                            const unsigned char* Ks, int r0, int Rg, int T,
                                            long long g0, uint32_t hk, float scale_log2,
                                            uint32_t thresh, float inv_keep, int lane) {
  using namespace hop_tiles;
  const Span span = sample_span(r0, Rg, T);
  const int last = Rg - 1;
#pragma unroll
  for (int n = 0; n < 2 * NTILE; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    a_frag(a, Qs, r0, last, ks, lane);
#pragma unroll
    for (int t = 0; t < NTILE; ++t) {
      if (t < span.ntiles) {
        uint32_t bk[4];
        k_frag(bk, Ks, span.c0 + t * STRIP, last, ks, lane);
        mma_bf16(s[2 * t], a, bk[0], bk[1]);
        mma_bf16(s[2 * t + 1], a, bk[2], bk[3]);
      }
    }
  }
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int lo_a = ra < Rg ? ra / T * T : 0, lo_b = rb < Rg ? rb / T * T : 0;
  softmax_rows<2 * NTILE>(s, span.c0, lo_a, ra < Rg ? lo_a + T : 0, lo_b,
                          rb < Rg ? lo_b + T : 0, hop_dropout::row_key(hk, uint32_t(g0 + ra)),
                          hop_dropout::row_key(hk, uint32_t(g0 + rb)), scale_log2, thresh,
                          inv_keep, lane & 3);
}

// O = P V for the strip at group row r0: P as hi + lo A fragments straight
// from the accumulators, V by ldmatrix.trans; the strip's rows of the group
// stored as float2 from the fragments (a full 32-byte sector a row and
// instruction) at out_h, the group's first row of this head (row stride ld).
template <int NTILE>
__device__ __forceinline__ void strip_out(const float (&s)[2 * NTILE][4],
                                          const unsigned char* Vs, float* out_h, int r0,
                                          int Rg, int T, int ld, int lane) {
  using namespace hop_tiles;
  const Span span = sample_span(r0, Rg, T);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < NTILE; ++t) {
    if (t < span.ntiles) {
      uint32_t hi[4], lo[4];
      p_frags(hi, lo, s[2 * t], s[2 * t + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        v_frag(bv, Vs, span.c0 + t * STRIP, Rg - 1, np, lane);
        mma_bf16(o[2 * np], hi, bv[0], bv[1]);
        mma_bf16(o[2 * np], lo, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], hi, bv[2], bv[3]);
        mma_bf16(o[2 * np + 1], lo, bv[2], bv[3]);
      }
    }
  }
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  float* dst = out_h + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (ra < Rg) *reinterpret_cast<float2*>(dst + ra * ld + n * 8) = make_float2(o[n][0], o[n][1]);
    if (rb < Rg) *reinterpret_cast<float2*>(dst + rb * ld + n * 8) = make_float2(o[n][2], o[n][3]);
  }
}

// Block (x, h) is group x (samples x nb ..) of head h. Its Q, K and V rows
// (Rg x 64 bf16 each, Rg = 272 for a full group at T=34) come by cp.async
// into three swizzled tiles, Q and K as one group, V as a second. Warp w
// takes strips w, w + warps, ...: its first strip's probabilities are formed
// while V lands, the rest in turn. NTILE = key_tiles(T, nb).
template <int NTILE>
__global__ void __launch_bounds__(FWD_MAX_WARPS * 32, 2)
block_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, float* __restrict__ out, int B, int T,
                      int H, int nb, float scale_log2, uint32_t seed, uint32_t thresh,
                      float inv_keep) {
  using namespace hop_tiles;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int h = blockIdx.y;
  const int b0 = blockIdx.x * nb;
  const int Rg = min(nb, B - b0) * T;           // rows of this group
  const long long g0 = (long long)b0 * T;       // the group's first stacked row
  const int ld = H * D;
  const long long off = g0 * ld + h * D;
  const int cap = nb * T * ROW_BYTES;           // a full group's tile
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + cap;
  unsigned char* Vs = Ks + cap;
  load_rows(Qs, q + off, ld, Rg, threadIdx.x, blockDim.x);
  load_rows(Ks, k + off, ld, Rg, threadIdx.x, blockDim.x);
  cp_async_commit();
  load_rows(Vs, v + off, ld, Rg, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const uint32_t hk = hop_dropout::head_key(seed, h);
  const int nstrips = (Rg + STRIP - 1) / STRIP;
  float s[2 * NTILE][4];
  if (warp < nstrips)
    strip_probs<NTILE>(s, Qs, Ks, warp * STRIP, Rg, T, g0, hk, scale_log2, thresh, inv_keep,
                       lane);
  cp_async_wait<0>();
  __syncthreads();
  for (int strip = warp; strip < nstrips; strip += nwarps) {
    if (strip != warp)
      strip_probs<NTILE>(s, Qs, Ks, strip * STRIP, Rg, T, g0, hk, scale_log2, thresh,
                         inv_keep, lane);
    strip_out<NTILE>(s, Vs, out + off, strip * STRIP, Rg, T, ld, lane);
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

// strips of a full group: the backward's warps
int block_warps(int T, int nb) { return (nb * T + STRIP - 1) / STRIP; }

// 16-key tiles a strip of a full group of nb samples needs at most (ops/
// block_attention.py `key_tiles`): the forward's template argument
int key_tiles(int T, int nb) {
  int most = 0;
  for (int r0 = 0; r0 < nb * T; r0 += STRIP) {
    const int n = sample_span(r0, nb * T, T).ntiles;
    most = n > most ? n : most;
  }
  return most;
}

// The forward's launch: {groups, heads, warps a block (two strips each),
// dynamic shared bytes (Q, K and V tiles of a full group)}. Two blocks of
// the largest group share an SM's 228 KB (1 KB of it reserved a block).
static_assert(2 * (3 * MAX_ROWS * hop_tiles::ROW_BYTES + 1024) <= 228 * 1024,
              "two forward blocks an SM");
void fwd_plan(int B, int T, int H, int nb, int (&plan)[4]) {
  plan[0] = (B + nb - 1) / nb;
  plan[1] = H;
  plan[2] = (block_warps(T, nb) + 1) / 2;
  plan[3] = 3 * nb * T * hop_tiles::ROW_BYTES;
}

template <int NTILE>
cudaError_t launch_fwd(const int (&plan)[4], const void* q, const void* k, const void* v,
                       void* out, int B, int T, int H, int nb, float scale_log2, uint32_t seed,
                       uint32_t thresh, float inv_keep, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(block_attn_fwd_kernel<NTILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan[3]);
  if (err != cudaSuccess) return err;
  block_attn_fwd_kernel<NTILE><<<dim3(plan[0], plan[1]), plan[2] * 32, plan[3], stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<float*>(out), B, T, H, nb, scale_log2, seed, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hop_block_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                  int B, int T, int H, int nb, float scale, uint32_t seed,
                                  uint32_t thresh, float inv_keep, void* stream) {
  if (bad_shape(B, T, H, nb)) return int(cudaErrorInvalidValue);
  int plan[4];
  fwd_plan(B, T, H, nb, plan);
  const float scale_log2 = scale * 1.4426950408889634f;
  using Launch = cudaError_t (*)(const int(&)[4], const void*, const void*, const void*, void*,
                                 int, int, int, int, float, uint32_t, uint32_t, float,
                                 cudaStream_t);
  constexpr Launch by_tiles[MAX_TILES] = {launch_fwd<1>, launch_fwd<2>, launch_fwd<3>,
                                          launch_fwd<4>, launch_fwd<5>, launch_fwd<6>};
  return int(by_tiles[key_tiles(T, nb) - 1](plan, q, k, v, out, B, T, H, nb, scale_log2, seed,
                                            thresh, inv_keep, static_cast<cudaStream_t>(stream)));
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
