// Reprogramming cross-attention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` of hop_tpu/ops/pallas_reprogramming.py
// (:110-127, `fused_reprogramming_attention` at rate 0). It computes
//   out[b, l, h, :] = softmax_s(q[b, l, h, :] . k[h, s, :] * scale) v[h, s, :]
// for q (B, L, H, E=128) bf16, k and v (H, S, E) bf16 shared by the whole
// batch, out (B, L, H, E) f32. Softmax and accumulation are f32.
//
// The TPU kept all of K and V resident in VMEM. On Hopper they are 3 MB each
// at S=1500, far above a block's 227 KB of shared memory, so:
//   * one block per (batch block, head); a batch block is nb = 68 / L samples,
//     i.e. 68 query rows at L=34, held in shared memory as f32;
//   * the block walks S in tiles of 64 keys, keeps each tile's scores in
//     shared memory and folds them into a running max and sum per row (online
//     softmax), so the (B, H, L, S) score tensor never reaches device memory;
//   * the ragged last key tile is masked with -inf, and rows past B in the
//     last batch block are zero and never stored;
//   * there is no cross-block reduction, hence no atomics.
// What bounds it: the scalar f32 FMAs of the two products (53.5 GFLOP at
// B=256, L=34, H=8, S=1500); K/V tiles are re-read from L2 by every batch
// block. Tensor-core products (mma.sync, wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

constexpr size_t SMEM_FLOATS = MAX_ROWS * E            // Q
                               + TILE_S * KSTRIDE      // K tile
                               + TILE_S * E            // V tile
                               + MAX_ROWS * TILE_S     // scores / probs
                               + 3 * MAX_ROWS;         // max, sum, rescale
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
reprog_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       float* __restrict__ out,
                       int B, int L, int H, int S, float scale) {
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
  // rows of this block that hold a real query
  const int rows = min(nb, B - b0) * L;

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

    // online softmax, one warp per row: new max, rescale factor, probs, sum
    for (int r = warp; r < MAX_ROWS; r += WARPS) {
      float* prow = Ps + r * TILE_S;
      const float a = prow[lane], b = prow[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));  // finite: tile has a key
      const float pa = expf(a - m_new), pb = expf(b - m_new);
      prow[lane] = pa;
      prow[lane + 32] = pb;
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
    }
  }
}

}  // namespace

extern "C" int hop_reprog_attn_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int L, int H, int S,
                                   float scale, void* stream) {
  if (B < 1 || L < 1 || L > MAX_ROWS || H < 1 || H > 65535 || S < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      reprog_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const int nb = MAX_ROWS / L;
  const dim3 grid((B + nb - 1) / nb, H);
  reprog_attn_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), B, L, H, S, scale);
  return int(cudaGetLastError());
}
