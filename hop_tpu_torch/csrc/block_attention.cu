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
// Backward (redesigned for the H100 as the forward was): a block per (group,
// head) stages the group's Q, K, V and dO rows of its head once by cp.async
// (Rg x 64 bf16 each, 139 KB at Rg = 272, one block an SM), Q and K as one
// copy group, dO and V as a second that lands while each warp's first
// strip's probabilities are formed. A warp per 16-row strip (17 at T=34, nb =
// 8; at most 16 warps, so warp 0 takes two), two phases around one
// __syncthreads() (attention_tiles.cuh, "the backward of K4 and K5", which
// K4 shares):
//   1. query strips: S, the undropped softmax and each row's log2-sum-exp2,
//      dP, delta, dS on the mma.sync.m16n8k16 accumulators, dQ = dS K; each
//      row's statistics to shared memory;
//   2. key strips: per 16-query tile of the strip's samples, S^T = K Q^T and
//      dP^T = V dO^T recomputed with the keys as rows, p, p o keep and dS^T on
//      the accumulators from those statistics, dV += (p o keep)^T dO, dK +=
//      dS^T Q.
// Only the key tiles (phase 1) or query tiles (phase 2) of the strip's
// samples are computed, NTILE = key_tiles(T, nb) of them at most, a template
// argument as in the forward. P and dS enter their products as hi + lo bf16
// A fragments made in place, so nothing is given up to a bf16 rounding. Every
// operand is read from device memory once and from the shared tiles by
// ldmatrix; no intermediate leaves the registers but 3 Rg words of
// statistics. Every dq, dk, dv row has one owner and one summation order: no
// atomics, results repeat bit for bit. Registers: a block of 17 warps put 5
// on one of the SM's four schedulers, which left a thread 96 registers and
// spilled; 16 warps leave 128 (phase 1 holds S and dP, 2 x 40 at NTILE = 5;
// phase 2 dK and dV, 2 x 32).
//
// What bounds it: bytes (0.9 / 2.3 GFLOP against 67 / 134 MB at B=256, T=34,
// H=12: 0.020 / 0.040 ms at 3.35 TB/s). The backward's products are 4.5
// GFLOP with the hi + lo pairs, 11 as a strip's key tiles compute them (at
// T=34 a strip spans two samples, 80 keys for a row's 34): 0.011 ms at the
// tensor cores' peak, which mma.sync does not reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "dropout_bits.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hop_tiles::sample_span;
using hop_tiles::Span;
using hop_tiles::STRIP;

constexpr int D = 64;                       // head dim
constexpr int NB_MAX = 8;                   // samples a group stacks at most
constexpr int MAX_ROWS = 272;               // rows of a group at most
constexpr int MAX_STRIPS = MAX_ROWS / STRIP;
constexpr int MAX_TILES = 6;                // key tiles a strip needs at most
constexpr int FWD_MAX_WARPS = (MAX_STRIPS + 1) / 2;   // forward: two strips a warp
// backward: a warp a strip, at most 16: a scheduler (SM quarter) then holds
// 4 warps and a thread 128 registers, where 17 warps left 96 and spilled
constexpr int BWD_MAX_WARPS = 16;

static_assert(MAX_ROWS % STRIP == 0, "a full group is whole strips");

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
  span_products<NTILE>(s, Qs, Ks, r0, span, Rg - 1, lane);
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

// Block (x, h) is group x of head h, as in the forward (`bwd_group`: at
// T=34, nb = 8 warp 0 takes two of the 17 strips, the others one).
template <int NTILE>
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32, 1)
block_attn_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                      int B, int T, int H, int nb, float scale_log2, float scale,
                      uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b0 = blockIdx.x * nb;
  hop_tiles::bwd_group<NTILE>(q, k, v, dout, dq, dk, dv, min(nb, B - b0) * T, nb * T, T, H,
                              blockIdx.y, (long long)b0 * T, scale_log2, scale, seed, thresh,
                              inv_keep, smem);
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
// block_attention.py `key_tiles`): the template argument of both kernels
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

// The backward's launch: {groups, heads}, a warp a strip of a full group (at
// most BWD_MAX_WARPS), the group's four tiles and its statistics (141 KB at
// the largest group).
static_assert(hop_tiles::bwd_group_smem(MAX_ROWS) <= 227 * 1024, "backward tiles");
template <int NTILE>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                       void* dk, void* dv, int B, int T, int H, int nb, float scale_log2,
                       float scale, uint32_t seed, uint32_t thresh, float inv_keep,
                       cudaStream_t stream) {
  const int smem = hop_tiles::bwd_group_smem(nb * T);
  cudaError_t err = cudaFuncSetAttribute(block_attn_bwd_kernel<NTILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int warps = min(block_warps(T, nb), BWD_MAX_WARPS);
  block_attn_bwd_kernel<NTILE><<<dim3((B + nb - 1) / nb, H), warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), B, T, H, nb, scale_log2, scale, seed, thresh, inv_keep);
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
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const void*, void*,
                                 void*, void*, int, int, int, int, float, float, uint32_t,
                                 uint32_t, float, cudaStream_t);
  constexpr Launch by_tiles[MAX_TILES] = {launch_bwd<1>, launch_bwd<2>, launch_bwd<3>,
                                          launch_bwd<4>, launch_bwd<5>, launch_bwd<6>};
  return int(by_tiles[key_tiles(T, nb) - 1](q, k, v, dout, dq, dk, dv, B, T, H, nb,
                                            scale * 1.4426950408889634f, scale, seed, thresh,
                                            inv_keep, static_cast<cudaStream_t>(stream)));
}
