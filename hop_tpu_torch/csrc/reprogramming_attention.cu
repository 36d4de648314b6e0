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
// Forward. The TPU kept all of K and V resident in VMEM. On Hopper they are
// 3 MB each at S=1500, far above a block's 227 KB of shared memory, so:
//   * one block per (batch block, head); a batch block is nb = 68 / L
//     samples, i.e. 68 query rows at L=34, held in shared memory as f32;
//   * the block walks S in tiles of 64 keys, keeps each tile's scores in
//     shared memory and folds them into a running max and sum per row
//     (online softmax), so the (B, H, L, S) score tensor never reaches device
//     memory; the dropout mask multiplies the probabilities that meet V,
//     not the sum that normalises them;
//   * the ragged last key tile is masked with -inf, and rows past B in the
//     last batch block are zero and never stored.
//
// Backward (flash-attention-2 shape). The TPU summed dk and dv over batch
// blocks in a VMEM accumulator, relying on its sequential grid; GPU blocks
// run in parallel and in no order, so the sum is re-cut instead:
//   * dq kernel: one block per (batch block, head), as the forward. It first
//     forms delta = rowsum(dO * O) for its rows (and stores it for the next
//     kernel), then walks the key tiles, recomputes p = exp(s - lse) and the
//     mask, ds = p * (dO v^T * keep / (1 - rate) - delta) and adds ds k;
//   * dk/dv kernel: one block per (head, 64-key tile) that walks ALL B*L
//     query rows in chunks of 64, in a fixed order, accumulating
//     dv += (p * keep / (1 - rate))^T dO and dk += ds^T q in registers.
// Each output element is owned by one block and summed in one order: dk and
// dv are deterministic, with no atomics and no cross-block reduction.
//
// What bounds it: the scalar f32 FMAs of the products (the forward's two:
// 53.5 GFLOP at B=256, L=34, H=8, S=1500; the backward's seven, scores
// recomputed in both kernels: 187 GFLOP). K/V and Q/dO tiles are re-read
// from L2 by every block. Tensor-core products (mma.sync, wgmma) and TMA
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_bits.cuh"

namespace {

constexpr int E = 128;            // head dim
constexpr int MAX_ROWS = 68;      // query rows per block (nb * L)
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
static_assert(TILE_S == 64, "softmax phase reads two keys per lane");

constexpr size_t FWD_SMEM_FLOATS = MAX_ROWS * E            // Q
                                   + TILE_S * KSTRIDE      // K tile
                                   + TILE_S * E            // V tile
                                   + MAX_ROWS * TILE_S     // scores / probs
                                   + 3 * MAX_ROWS;         // max, sum, rescale
constexpr size_t FWD_SMEM_BYTES = FWD_SMEM_FLOATS * sizeof(float);

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

__global__ void __launch_bounds__(THREADS)
reprog_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       float* __restrict__ out, float* __restrict__ lse,
                       int B, int L, int H, int S, float scale,
                       uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + MAX_ROWS * E;
  float* Vs = Ks + TILE_S * KSTRIDE;
  float* Ps = Vs + TILE_S * E;
  float* m_s = Ps + MAX_ROWS * TILE_S;
  float* l_s = m_s + MAX_ROWS;
  float* c_s = l_s + MAX_ROWS;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int nb = MAX_ROWS / L;
  const int b0 = blockIdx.x * nb;
  // rows of this block that hold a real query; block row r is global query
  // row b0 * L + r
  const int rows = min(nb, B - b0) * L;
  const uint32_t hk = hop_dropout::head_key(seed, h);

  for (int idx = tid; idx < MAX_ROWS * E; idx += THREADS) {
    const int r = idx / E, e = idx % E;
    float val = 0.f;
    if (r < rows) {
      const int b = b0 + r / L, l = r % L;
      val = __bfloat162float(q[((size_t(b) * L + l) * H + h) * E + e]);
    }
    Qs[idx] = val;
  }
  for (int r = tid; r < MAX_ROWS; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int sj = tid % TILE_S, sg = tid / TILE_S;
  const int oe = tid % E, og = tid / E;
  float acc[O_ROWS];
#pragma unroll
  for (int i = 0; i < O_ROWS; ++i) acc[i] = 0.f;

  const __nv_bfloat16* kh = k + size_t(h) * S * E;
  const __nv_bfloat16* vh = v + size_t(h) * S * E;
  const int warp = tid / 32, lane = tid % 32;

  for (int s0 = 0; s0 < S; s0 += TILE_S) {
    __syncthreads();  // Q loaded / previous tile fully consumed
    for (int idx = tid; idx < TILE_S * E; idx += THREADS) {
      const int j = idx / E, e = idx % E;
      const bool ok = s0 + j < S;
      const size_t off = size_t(s0 + j) * E + e;
      Ks[j * KSTRIDE + e] = ok ? __bfloat162float(kh[off]) : 0.f;
      Vs[j * E + e] = ok ? __bfloat162float(vh[off]) : 0.f;
    }
    __syncthreads();

    // scores of this tile: Ps[r, j] = scale * Q[r] . K[j], -inf past S
    {
      float sc[S_ROWS];
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i) sc[i] = 0.f;
      const float* krow = Ks + sj * KSTRIDE;
#pragma unroll 4
      for (int e = 0; e < E; ++e) {
        const float kv = krow[e];
#pragma unroll
        for (int i = 0; i < S_ROWS; ++i) sc[i] += Qs[(sg + S_GROUPS * i) * E + e] * kv;
      }
      const bool ok = s0 + sj < S;
#pragma unroll
      for (int i = 0; i < S_ROWS; ++i)
        Ps[(sg + S_GROUPS * i) * TILE_S + sj] = ok ? sc[i] * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax, one warp per row: new max, rescale factor, probs, sum;
    // the sum is over the undropped probabilities, the stored probs are the
    // dropped ones
    for (int r = warp; r < MAX_ROWS; r += WARPS) {
      float* prow = Ps + r * TILE_S;
      const float a = prow[lane], b = prow[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));  // finite: tile has a key
      const float pa = expf(a - m_new), pb = expf(b - m_new);
      const uint32_t rk = hop_dropout::row_key(hk, uint32_t(b0 * L + r));
      prow[lane] = drop(pa, rk, s0 + lane, thresh, inv_keep);
      prow[lane + 32] = drop(pb, rk, s0 + lane + 32, thresh, inv_keep);
      const float tile_sum = warp_sum(pa + pb);
      if (lane == 0) {
        const float c = expf(m_old - m_new);  // 0 on the first tile
        c_s[r] = c;
        l_s[r] = l_s[r] * c + tile_sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // out rows: acc = acc * rescale + P . V
#pragma unroll
    for (int i = 0; i < O_ROWS; ++i) acc[i] *= c_s[og + O_GROUPS * i];
#pragma unroll 2
    for (int j = 0; j < TILE_S; ++j) {
      const float vv = Vs[j * E + oe];
#pragma unroll
      for (int i = 0; i < O_ROWS; ++i) acc[i] += Ps[(og + O_GROUPS * i) * TILE_S + j] * vv;
    }
  }

#pragma unroll
  for (int i = 0; i < O_ROWS; ++i) {
    const int r = og + O_GROUPS * i;
    if (r < rows) {
      const int b = b0 + r / L, l = r % L;
      out[((size_t(b) * L + l) * H + h) * E + oe] = acc[i] / l_s[r];
      if (lse != nullptr && oe == 0)
        lse[(size_t(b) * L + l) * H + h] = m_s[r] + logf(l_s[r]);
    }
  }
}

// dq = scale * sum_s ds[r, s] k[s], ds = p * (dp * keep / (1 - rate) - delta),
// one block per (batch block, head); also stores delta for the dk/dv kernel
__global__ void __launch_bounds__(THREADS)
reprog_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, float* __restrict__ dq,
                          int B, int L, int H, int S, float scale,
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
  const int nb = MAX_ROWS / L;
  const int b0 = blockIdx.x * nb;
  const int rows = min(nb, B - b0) * L;
  const uint32_t hk = hop_dropout::head_key(seed, h);
  const int warp = tid / 32, lane = tid % 32;

  // block row r is global query row b0 * L + r, at offset (row * H + h) * E
  for (int idx = tid; idx < MAX_ROWS * E; idx += THREADS) {
    const int r = idx / E, e = idx % E;
    float qv = 0.f, dv = 0.f;
    if (r < rows) {
      const size_t off = ((size_t(b0) * L + r) * H + h) * E + e;
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
    const size_t row = size_t(b0) * L + r;
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
    if (r < rows) dq[((size_t(b0) * L + r) * H + h) * E + oe] = acc[i] * scale;
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
  return B < 1 || L < 1 || L > MAX_ROWS || H < 1 || H > 65535 || S < 1;
}

}  // namespace

extern "C" int hop_reprog_attn_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int L, int H,
                                   int S, float scale, uint32_t seed,
                                   uint32_t thresh, float inv_keep,
                                   void* stream) {
  if (bad_shape(B, L, H, S)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      reprog_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(FWD_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const int nb = MAX_ROWS / L;
  const dim3 grid((B + nb - 1) / nb, H);
  reprog_attn_fwd_kernel<<<grid, THREADS, FWD_SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), B, L, H, S, scale, seed, thresh, inv_keep);
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
  const int nb = MAX_ROWS / L;
  reprog_attn_bwd_dq_kernel<<<dim3((B + nb - 1) / nb, H), THREADS, DQ_SMEM_BYTES, st>>>(
      qb, kb, vb, static_cast<const float*>(out), gb,
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(dq), B, L, H, S, scale, seed, thresh, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  reprog_attn_bwd_dkdv_kernel<<<dim3((S + KV_TILE - 1) / KV_TILE, H), THREADS,
                                KV_SMEM_BYTES, st>>>(
      qb, kb, vb, gb, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), B * L, H, S, scale, seed, thresh, inv_keep);
  return int(cudaGetLastError());
}
