// Self-attention of the frozen backbone, one (sample, head) at a time
// (kernel K4) for Hopper, sm_90a: forward with attention dropout, and the
// backward that recomputes the probabilities.
//
// Replaces the TPU kernels `_fwd_kernel` (:126-135) and `_bwd_kernel`
// (:137-161) of hop_tpu/ops/pallas_attention.py. For q, k, v (B, T, H, D=64)
// bf16 in the layout the QKV projections emit:
//   p[b, h, i, j] = softmax_j(q[b, i, h, :] . k[b, j, h, :] * scale)
//   out[b, i, h, :] = sum_j p * keep(h, b * T + i, j) / (1 - rate) * v[b, j, h, :]
// out (B, T, H, D) bf16. keep() is the hash of dropout_bits.cuh, a function of
// global coordinates: the backward redraws the forward's mask, and kernel K5
// (block_attention.cu) draws the same one.
//
// The TPU program took NB <= 8 samples and ran (NB * H) batched 34 x 34
// products after transposing heads forward in VMEM. Here a head's row is 128
// contiguous bytes at offset ((b * T + t) * H + h) * D, so each (sample, head)
// loads its own rows in 16-byte pieces: no transpose exists on either side.
//
// What bounds it: bytes. 0.9 GFLOP forward and 2.3 GFLOP backward at B=256,
// T=34, H=12 are microseconds of the card's arithmetic, against 53 and 94 MB
// of operands and results (0.016 and 0.028 ms at 3.35 TB/s). Every operand
// byte is read once and no intermediate reaches device memory.
//
// Forward, on the tensor cores: one warp owns one (sample, head); a block of
// FWD_WARPS warps holds FWD_WARPS heads of one sample, whose rows lie side by
// side (512 bytes a time step at H >= 4). Its three T x 64 operand tiles stay
// bf16, brought by cp.async into shared memory without padding (16-byte
// pieces XOR-swizzled, attention_tiles.cuh): 13 KB a warp at T=34, four
// blocks of 4 warps an SM, 768 blocks at B=256 on 528 slots. Q and K are one
// copy group, V a second that lands while the first row tile's scores are
// formed. Per 16-row tile of queries (34 rows: 3 tiles, the rows past T read
// as row T - 1 and never stored):
//   * S = Q K^T on mma.sync.m16n8k16 bf16 with f32 accumulators, fragments by
//     ldmatrix: 4 k steps x ceil(T / 8) key tiles of 8 (5 at T=34; keys past
//     T masked to -inf before the max);
//   * the softmax and the dropout factor on the accumulators: a row lies in
//     the four lanes of a quad, so its max and its sum take two shuffles;
//   * O = P V with P, f32, as hi + lo bf16 A fragments straight from the
//     accumulators (two MMAs a tile: P keeps f32 accuracy, as K5's does) and
//     V through ldmatrix.trans, ceil(T / 16) k steps x 8 tiles of D;
//   * O rounded to bf16 and stored from the fragments.
// The key-tile count is a template argument (one instance per ceil(T / 8)),
// so every loop is unrolled and the fragments stay in registers.
//
// Backward: one block per (sample, head), grid (B, H). It recomputes p from
// q, k, v (no log-sum-exp is saved), redraws the mask, and forms
//   dV = (p o keep)^T dO,  dP = dO V^T o keep,
//   dS = p o (dP - rowsum(dP o p)) * scale,  dQ = dS K,  dK = dS^T Q.
// A block owns the dq, dk, dv rows of its (sample, head): nothing is summed
// across blocks, and the results repeat bit for bit. Its products are still
// scalar f32 FMAs on register tiles of 4 rows (operand rows read as float4
// from f32 rows padded to 68 floats, conflict-free).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "dropout_bits.cuh"

namespace {

constexpr int D = 64;             // head dim
constexpr int MAX_T = 64;         // rows of a sample
constexpr int FWD_WARPS = 4;      // forward: (sample, head) problems a block, heads of one sample
constexpr int THREADS = 160;      // backward: 5 warps, 306 score and 144 output tasks at T=34
constexpr int WARPS = THREADS / 32;
constexpr int DS = D + 4;         // operand row stride (floats): float4-aligned, conflict-free
constexpr int D4 = D / 4;         // float4 pieces of a row
constexpr int PER_LANE = MAX_T / 32;  // keys a lane holds of one score row
// the forward's three tiles a warp at the longest T, within the 227 KB a
// block may opt in to
static_assert(FWD_WARPS * 3 * MAX_T * hop_tiles::ROW_BYTES <= 227 * 1024, "forward tiles");

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dropout factor of one probability: 1 / (1 - rate) when kept, else 0
__device__ __forceinline__ float keep_factor(uint32_t rk, uint32_t s, uint32_t thresh,
                                             float inv_keep) {
  if (thresh == 0u) return 1.f;
  return hop_dropout::bits(rk, s) >= thresh ? inv_keep : 0.f;
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4 v) {
  acc.x += s * v.x;
  acc.y += s * v.y;
  acc.z += s * v.z;
  acc.w += s * v.w;
}

// rows [0, T) of one (sample, head) as f32 into dst (rows of DS floats), in
// 16-byte pieces of 8 bf16; rows [T, TP) are zero
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src,
                                          size_t row0, int T, int TP, int H, int h) {
  for (int idx = threadIdx.x; idx < TP * (D / 8); idx += THREADS) {
    const int r = idx / (D / 8), c = idx % (D / 8);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (r < T) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + ((row0 + r) * H + h) * D + c * 8);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(p2[0]), b = __bfloat1622float2(p2[1]);
      const float2 cc = __bfloat1622float2(p2[2]), d = __bfloat1622float2(p2[3]);
      lo = make_float4(a.x, a.y, b.x, b.y);
      hi = make_float4(cc.x, cc.y, d.x, d.y);
    }
    float4* out = reinterpret_cast<float4*>(dst + r * DS + c * 8);
    out[0] = lo;
    out[1] = hi;
  }
}

// four f32 values as bf16 to dst (8-byte aligned)
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// out[i][j] = A[i] . Bm[j] for i < TP (4 rows a task), j < T; both operands
// rows of DS floats, out rows of TP floats
__device__ __forceinline__ void rows_dot_rows(float* out, const float* A, const float* Bm,
                                              int T, int TP, float scale) {
  for (int task = threadIdx.x; task < (TP / 4) * T; task += THREADS) {
    const int i0 = (task / T) * 4, j = task % T;
    const float4* brow = reinterpret_cast<const float4*>(Bm + j * DS);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int e = 0; e < D4; ++e) {
      const float4 bv = brow[e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[r] += dot4(reinterpret_cast<const float4*>(A + (i0 + r) * DS)[e], bv);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) out[(i0 + r) * TP + j] = acc[r] * scale;
  }
}

// one task of dst[i][:] = sum_j W[i][j] M[j][:] for 4 rows i and 4 columns:
// W rows of TP floats, M rows of DS floats; stores rows < T as bf16
__device__ __forceinline__ void weights_times_rows(__nv_bfloat16* dst, const float* W,
                                                   const float* M, int task, int T, int TP,
                                                   size_t row0, int H, int h) {
  const int i0 = (task / D4) * 4, d4 = task % D4;
  float4 acc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < T; ++j) {
    const float4 mv = reinterpret_cast<const float4*>(M + j * DS)[d4];
#pragma unroll
    for (int r = 0; r < 4; ++r) fma4(acc[r], W[(i0 + r) * TP + j], mv);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (i0 + r < T) store4(dst + ((row0 + i0 + r) * H + h) * D + d4 * 4, acc[r]);
}

// ---- forward: one warp a (sample, head), bf16 tensor-core tiles -----------

// Warp w of block x owns (sample b, head h): x = b * groups + h / FWD_WARPS,
// w = h % FWD_WARPS. NT = ceil(T / 8), the 8-key tiles of a sample. Its Q,
// K and V rows (T x 64 bf16 each) come by cp.async into the warp's three
// swizzled tiles, Q and K first, V as a second group that lands while the
// first row tile's scores are formed. Per 16-row tile of queries: S = Q K^T
// (4 k steps x NT n tiles of mma.m16n8k16), the masked softmax and the
// dropout on the accumulators (softmax_rows), then O = P V with P as hi +
// lo bf16 A fragments ((NT + 1) / 2 k steps x 8 n tiles x 2), O rounded to
// bf16 and stored from the fragments. No block-wide barrier: a warp past the
// last head leaves at once.
template <int NT>
__global__ void __launch_bounds__(FWD_WARPS * 32, 4)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int T,
                int H, int groups, float scale_log2, uint32_t seed, uint32_t thresh,
                float inv_keep) {
  using namespace hop_tiles;
  constexpr int KS = (NT + 1) / 2;   // 16-key steps of P V
  extern __shared__ __align__(128) unsigned char tiles[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / groups;
  const int h = (blockIdx.x - b * groups) * FWD_WARPS + warp;
  if (h >= H) return;
  const int tile = T * ROW_BYTES;
  unsigned char* Qs = tiles + warp * 3 * tile;
  unsigned char* Ks = Qs + tile;
  unsigned char* Vs = Ks + tile;
  const int ld = H * D;
  const long long row0 = (long long)b * T;      // global query row of the sample's first
  const long long off = row0 * ld + h * D;
  load_rows(Qs, q + off, ld, T, lane, 32);
  load_rows(Ks, k + off, ld, T, lane, 32);
  cp_async_commit();
  load_rows(Vs, v + off, ld, T, lane, 32);
  cp_async_commit();
  cp_async_wait<1>();
  __syncwarp();

  const int g = lane >> 2, t4 = lane & 3, last = T - 1;
  const uint32_t hk = hop_dropout::head_key(seed, h);
  for (int m0 = 0; m0 < T; m0 += 16) {
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      a_frag(a, Qs, m0, last, ks, lane);
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        uint32_t bk[4];
        k_frag(bk, Ks, np * 16, last, ks, lane);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        if (2 * np + 1 < NT) mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    const int ra = m0 + g, rb = ra + 8;
    softmax_rows<NT>(s, 0, 0, T, 0, T, hop_dropout::row_key(hk, uint32_t(row0 + ra)),
                     hop_dropout::row_key(hk, uint32_t(row0 + rb)), scale_log2, thresh,
                     inv_keep, t4);
    if (m0 == 0) {
      cp_async_wait<0>();
      __syncwarp();
    }
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t hi[4], lo[4];
      p_frags(hi, lo, s[2 * kk], s[2 * kk + 1 < NT ? 2 * kk + 1 : 2 * kk]);
      if (2 * kk + 1 == NT) hi[2] = hi[3] = lo[2] = lo[3] = 0u;   // keys past the last tile
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        v_frag(bv, Vs, kk * 16, last, np, lane);
        mma_bf16(o[2 * np], hi, bv[0], bv[1]);
        mma_bf16(o[2 * np], lo, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], hi, bv[2], bv[3]);
        mma_bf16(o[2 * np + 1], lo, bv[2], bv[3]);
      }
    }
    __nv_bfloat16* dst = out + off + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (ra < T)
        *reinterpret_cast<__nv_bfloat162*>(dst + ra * ld + n * 8) =
            __floats2bfloat162_rn(o[n][0], o[n][1]);
      if (rb < T)
        *reinterpret_cast<__nv_bfloat162*>(dst + rb * ld + n * 8) =
            __floats2bfloat162_rn(o[n][2], o[n][3]);
    }
  }
}

// ---- backward: one block a (sample, head), scalar f32 FMAs -----------------

__global__ void __launch_bounds__(THREADS)
attn_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int T, int H, float scale, uint32_t seed,
                uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const int TP = (T + 3) & ~3;
  float* Qs = smem;                 // (TP, DS)
  float* Ks = Qs + TP * DS;
  float* Vs = Ks + TP * DS;
  float* Gs = Vs + TP * DS;         // dO
  float* Ps = Gs + TP * DS;         // (TP, TP): scores, then p o keep
  float* Ss = Ps + TP * TP;         // (TP, TP): dO V^T, then dS

  const int h = blockIdx.y;
  const size_t row0 = size_t(blockIdx.x) * T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(Qs, q, row0, T, TP, H, h);
  load_tile(Ks, k, row0, T, TP, H, h);
  load_tile(Vs, v, row0, T, TP, H, h);
  load_tile(Gs, dout, row0, T, TP, H, h);
  __syncthreads();
  rows_dot_rows(Ps, Qs, Ks, T, TP, scale);
  rows_dot_rows(Ss, Gs, Vs, T, TP, 1.f);
  __syncthreads();

  // per row: p, dP = (dO V^T) o keep, dS = p (dP - sum_j dP p) scale; leaves
  // p o keep in Ps and dS in Ss
  const uint32_t hk = hop_dropout::head_key(seed, h);
  for (int r = warp; r < T; r += WARPS) {
    float* prow = Ps + r * TP;
    float* srow = Ss + r * TP;
    float p[PER_LANE], dp[PER_LANE], kf[PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      const int j = lane + 32 * c;
      p[c] = j < T ? prow[j] : -INFINITY;
      mx = fmaxf(mx, p[c]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      p[c] = expf(p[c] - mx);
      sum += p[c];
    }
    const float inv = 1.f / warp_sum(sum);
    const uint32_t rk = hop_dropout::row_key(hk, uint32_t(row0 + r));
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      const int j = lane + 32 * c;
      p[c] *= inv;
      kf[c] = j < T ? keep_factor(rk, j, thresh, inv_keep) : 0.f;
      dp[c] = j < T ? srow[j] * kf[c] : 0.f;
      part += dp[c] * p[c];
    }
    const float delta = warp_sum(part);
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      const int j = lane + 32 * c;
      if (j < T) {
        prow[j] = p[c] * kf[c];
        srow[j] = p[c] * (dp[c] - delta) * scale;
      }
    }
  }
  __syncthreads();

  // dQ = dS K by tasks of (4 query rows, 4 columns); dK = dS^T Q and
  // dV = (p o keep)^T dO by tasks of (4 key rows, 4 columns)
  const int tasks = (TP / 4) * D4;
  for (int task = threadIdx.x; task < 2 * tasks; task += THREADS) {
    if (task < tasks) {
      weights_times_rows(dq, Ss, Ks, task, T, TP, row0, H, h);
      continue;
    }
    const int j0 = ((task - tasks) / D4) * 4, d4 = (task - tasks) % D4;
    float4 acc_k[4], acc_v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_k[r] = acc_v[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < T; ++i) {
      const float4 qv = reinterpret_cast<const float4*>(Qs + i * DS)[d4];
      const float4 gv = reinterpret_cast<const float4*>(Gs + i * DS)[d4];
      const float4 pd = *reinterpret_cast<const float4*>(Ps + i * TP + j0);
      const float4 ds = *reinterpret_cast<const float4*>(Ss + i * TP + j0);
      fma4(acc_v[0], pd.x, gv);
      fma4(acc_v[1], pd.y, gv);
      fma4(acc_v[2], pd.z, gv);
      fma4(acc_v[3], pd.w, gv);
      fma4(acc_k[0], ds.x, qv);
      fma4(acc_k[1], ds.y, qv);
      fma4(acc_k[2], ds.z, qv);
      fma4(acc_k[3], ds.w, qv);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (j0 + r < T) {
        const size_t off = ((row0 + j0 + r) * H + h) * D + d4 * 4;
        store4(dk + off, acc_k[r]);
        store4(dv + off, acc_v[r]);
      }
  }
}

size_t bwd_smem(int T) {
  const size_t TP = (T + 3) & ~3;
  return (4 * TP * DS + 2 * TP * TP) * sizeof(float);
}

bool bad_shape(int B, int T, int H) {
  return B < 1 || T < 1 || T > MAX_T || H < 1 || H > 65535;
}

// The forward's launch: {blocks, warps a block, dynamic shared bytes}.
void fwd_plan(int B, int T, int H, int (&plan)[3]) {
  const int warps = H < FWD_WARPS ? H : FWD_WARPS;
  plan[0] = B * ((H + FWD_WARPS - 1) / FWD_WARPS);
  plan[1] = warps;
  plan[2] = warps * 3 * T * hop_tiles::ROW_BYTES;
}

template <int NT>
cudaError_t launch_fwd(const int (&plan)[3], const void* q, const void* k, const void* v,
                       void* out, int T, int H, float scale_log2, uint32_t seed,
                       uint32_t thresh, float inv_keep, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan[2]);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<NT><<<plan[0], plan[1] * 32, plan[2], stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, H,
      (H + FWD_WARPS - 1) / FWD_WARPS, scale_log2, seed, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hop_attn_fwd(const void* q, const void* k, const void* v, void* out, int B,
                            int T, int H, float scale, uint32_t seed, uint32_t thresh,
                            float inv_keep, void* stream) {
  if (bad_shape(B, T, H)) return int(cudaErrorInvalidValue);
  int plan[3];
  fwd_plan(B, T, H, plan);
  const float scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = cudaError_t (*)(const int(&)[3], const void*, const void*, const void*, void*,
                                 int, int, float, uint32_t, uint32_t, float, cudaStream_t);
  constexpr Launch by_tiles[MAX_T / 8] = {launch_fwd<1>, launch_fwd<2>, launch_fwd<3>,
                                          launch_fwd<4>, launch_fwd<5>, launch_fwd<6>,
                                          launch_fwd<7>, launch_fwd<8>};
  return int(by_tiles[(T + 7) / 8 - 1](plan, q, k, v, out, T, H, scale_log2, seed, thresh,
                                       inv_keep, st));
}

extern "C" int hop_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                            void* dq, void* dk, void* dv, int B, int T, int H, float scale,
                            uint32_t seed, uint32_t thresh, float inv_keep, void* stream) {
  if (bad_shape(B, T, H)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bwd_smem(MAX_T)));
  if (err != cudaSuccess) return int(err);
  attn_bwd_kernel<<<dim3(B, H), THREADS, bwd_smem(T), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, H, scale, seed, thresh, inv_keep);
  return int(cudaGetLastError());
}
