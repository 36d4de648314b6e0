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
// Backward (redesigned for the H100 as the forward was): K5's algorithm with
// a sample as a group of one (attention_tiles.cuh, "the backward of K4 and
// K5"): a block per (sample, head), grid (B, H), a warp per 16-row strip
// (3 at T=34). Its Q, K, V and dO rows come by cp.async into four swizzled
// bf16 tiles (17.8 KB with the statistics at T=34), Q and K as one copy
// group, dO and V as a second that lands while the first strips'
// probabilities are formed. Phase 1 over query strips (S, the undropped
// softmax and each row's log2-sum-exp2, dP, delta, dS and dQ on
// mma.sync.m16n8k16 accumulators), one __syncthreads(), phase 2 over key
// strips (S^T and dP^T recomputed with the keys as rows, p o keep and dS^T on
// the accumulators, dV and dK). P and dS enter their products as hi + lo
// bf16 A fragments; the results are rounded to bf16 once. Every dq, dk, dv
// row has one owner and one summation order: the results repeat bit for bit.
// A warp a strip, not the forward's warp a (sample, head): one warp's serial
// chain of 2 ceil(T / 16) strips is the whole time at B=1, and five small
// blocks an SM (128 registers a thread) overlap one block's copies with
// another's products. The strip count ceil(T / 16) is a template argument.

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
// the forward's three tiles a warp at the longest T, within the 227 KB a
// block may opt in to
static_assert(FWD_WARPS * 3 * MAX_T * hop_tiles::ROW_BYTES <= 227 * 1024, "forward tiles");

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

// ---- backward: a block a (sample, head), a warp a strip ------------------

template <int NTILE>
__global__ void __launch_bounds__(MAX_T / hop_tiles::STRIP * 32, 4)
attn_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int T, int H, float scale_log2, float scale,
                uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(128) unsigned char tiles[];
  hop_tiles::bwd_group<NTILE>(q, k, v, dout, dq, dk, dv, T, T, T, H, blockIdx.y,
                              (long long)blockIdx.x * T, scale_log2, scale, seed, thresh,
                              inv_keep, tiles);
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

// The backward's launch: grid (B, H), a warp a strip, the four tiles and the
// statistics of T rows.
template <int NTILE>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                       void* dk, void* dv, int B, int T, int H, float scale_log2, float scale,
                       uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const int smem = hop_tiles::bwd_group_smem(T);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel<NTILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  attn_bwd_kernel<NTILE><<<dim3(B, H), NTILE * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, H, scale_log2, scale, seed, thresh, inv_keep);
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
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const void*, void*,
                                 void*, void*, int, int, int, float, float, uint32_t, uint32_t,
                                 float, cudaStream_t);
  constexpr Launch by_strips[MAX_T / hop_tiles::STRIP] = {launch_bwd<1>, launch_bwd<2>,
                                                          launch_bwd<3>, launch_bwd<4>};
  return int(by_strips[(T + hop_tiles::STRIP - 1) / hop_tiles::STRIP - 1](
      q, k, v, dout, dq, dk, dv, B, T, H, scale * 1.4426950408889634f, scale, seed, thresh,
      inv_keep, static_cast<cudaStream_t>(stream)));
}
