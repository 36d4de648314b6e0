// What the GRU kernels for Hopper share: K2 (gru_fused.cu, projection and
// recurrence behind one entry), K3 (gru_stack.cu, the recurrence alone from gate
// streams) and K6 (gru_seq.cu, one batch-major direction, forward only).
//
//   * gru_recurrence_tile: the forward recurrence of one (batch tile,
//     direction) from precomputed gate streams, T looped inside the block
//     with h in shared memory (K2's second phase, K3 forward, K3 lean
//     forward, K6), W_hh read from L2 at every step or, where it fits, from
//     a copy in shared memory; gru_streams_fwd_kernel runs it over a grid;
//   * gru_bwd_recurrence_kernel: the serial part of a GRU layer's backward,
//     the dh carry walked in the reverse of the forward's order (K2 and K3
//     backward);
//   * gru_gemm_kernel / gemm(): a tiled f32 GEMM over strided operands with
//     ordered split-K (K2's dx, dW_ih, dW_hh; K3's dW_hh);
//   * gru_colsum_kernel: ordered column sums (the bias gradients).
// None uses atomics; every sum has one order for a given shape, so results
// repeat bit for bit. Everything is in an unnamed namespace: each .cu that
// includes this header gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BT = 8;  // batch rows per block of the recurrences

// Unroll depth of a recurrence's loop over weight rows: the rows come from
// L2 (the weights fit no SM), and 16 rows of loads in flight per thread hide
// its latency better than 4 (K3's forward at the head: 1.14 against 1.36 ms
// on an H100); deeper gains nothing.
constexpr int KU = 16;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// gate streams are f32 or bf16; all arithmetic is f32
__device__ __forceinline__ float ld_stream(const float* p) { return *p; }
__device__ __forceinline__ float ld_stream(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_stream(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_stream(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The forward recurrence of batch rows b0..b0+RT-1 of one direction:
//   hr, hz, hnb = h W[g] + bias[g];  r = sigmoid(xr + hr);  z = sigmoid(xz + hz)
//   n = tanh(xn + r * hnb);  h' = (1 - z) n + z h
// Thread threadIdx.x = j owns hidden unit j (blockDim.x >= H) of RT rows; the
// threads of one threadIdx.y share `hs`. Element (t, b, j) of a gate stream
// lies at t * sxt + b * sxb + j, of an output at t * sot + b * sob + j; the
// pointers are already offset to the direction. W is (3, H, H) laid out
// [gate][k][j], bias (3, H), h0 (B, H). Without WS, W is read from L2 at
// every step, coalesced along j (a direction's 1.47 MB at H=350 fit no SM);
// with WS, `w_s` is the block's copy of W in shared memory, staged by the
// caller before the call, and W is not read. `reverse` walks t from T-1 down
// to 0; outputs land at their natural time index. With RES the gates r, z, n
// and hnb (with its bias) are written too. hs is shared memory of H * RT
// floats, laid out [k][row] so that one k's rows are one (RT = 2) or two
// (RT = 8) vector loads. Every thread of the block must make the call: it
// holds block barriers.
template <bool RES, typename TX, bool WS, int RT>
__device__ __forceinline__ void gru_recurrence_tile(
    const TX* __restrict__ xr, const TX* __restrict__ xz, const TX* __restrict__ xn,
    long long sxt, long long sxb, const float* __restrict__ W,
    const float* __restrict__ bias, const float* __restrict__ h0,
    float* __restrict__ out, float* __restrict__ r_out, float* __restrict__ z_out,
    float* __restrict__ n_out, float* __restrict__ hnb_out, long long sot,
    long long sob, int T, int B, int H, int b0, bool reverse, float* hs,
    const float* w_s) {
  static_assert(RT == 2 || RT % 4 == 0, "rows of a k are float2 or float4 loads");
  const int j = threadIdx.x;
  const bool active = j < H;
  float bh[3] = {0.f, 0.f, 0.f};
  if (active) {
#pragma unroll
    for (int g = 0; g < 3; ++g) bh[g] = bias[g * H + j];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      hs[j * RT + r] = b0 + r < B ? h0[size_t(b0 + r) * H + j] : 0.f;
  }
  __syncthreads();

  const float* u0 = (WS ? w_s : W) + j;
  const float* u1 = u0 + size_t(H) * H;
  const float* u2 = u0 + size_t(2) * H * H;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    float hn[RT];
    if (active) {
      // the step's stream values do not depend on h: load them first
      float vr[RT], vz[RT], vn[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const bool ok = b0 + r < B;
        const long long o = t * sxt + (long long)(b0 + r) * sxb + j;
        vr[r] = ok ? ld_stream(xr + o) : 0.f;
        vz[r] = ok ? ld_stream(xz + o) : 0.f;
        vn[r] = ok ? ld_stream(xn + o) : 0.f;
      }
      float gr[RT], gz[RT], gn[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        gr[r] = bh[0]; gz[r] = bh[1]; gn[r] = bh[2];
      }
#pragma unroll KU
      for (int k = 0; k < H; ++k) {
        const float c0 = WS ? u0[size_t(k) * H] : __ldg(u0 + size_t(k) * H);
        const float c1 = WS ? u1[size_t(k) * H] : __ldg(u1 + size_t(k) * H);
        const float c2 = WS ? u2[size_t(k) * H] : __ldg(u2 + size_t(k) * H);
        float hv[RT];
        if constexpr (RT == 2) {
          const float2 ha = *reinterpret_cast<const float2*>(hs + k * RT);
          hv[0] = ha.x; hv[1] = ha.y;
        } else {
#pragma unroll
          for (int q = 0; q < RT / 4; ++q) {
            const float4 ha = *reinterpret_cast<const float4*>(hs + k * RT + 4 * q);
            hv[4 * q] = ha.x; hv[4 * q + 1] = ha.y; hv[4 * q + 2] = ha.z;
            hv[4 * q + 3] = ha.w;
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          gr[r] += hv[r] * c0;
          gz[r] += hv[r] * c1;
          gn[r] += hv[r] * c2;
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float rg = sigmoidf(vr[r] + gr[r]);
        const float zg = sigmoidf(vz[r] + gz[r]);
        const float ng = tanhf(vn[r] + rg * gn[r]);
        hn[r] = (1.f - zg) * ng + zg * hs[j * RT + r];
        if (b0 + r < B) {
          const long long o = t * sot + (long long)(b0 + r) * sob + j;
          out[o] = hn[r];
          if (RES) {
            r_out[o] = rg;
            z_out[o] = zg;
            n_out[o] = ng;
            hnb_out[o] = gn[r];
          }
        }
      }
    }
    __syncthreads();  // every thread has read h_{t-1}
    if (active) {
#pragma unroll
      for (int r = 0; r < RT; ++r) hs[j * RT + r] = hn[r];
    }
    __syncthreads();  // h_t in place
  }
}

// The shared-memory variant of the recurrence: W of a direction staged once
// per block, RT = 2 rows a thread and blockDim.y row groups that share the
// copy, so that a narrow layer (the discriminator's H = 64) is not left with
// two warps a block and a long serial chain a step.
constexpr int WS_RT = 2;
constexpr int WS_THREADS = 256;
constexpr size_t SMEM_BLOCK_MAX = 232448;   // 227 KB, a block's most on sm_90

inline int ws_row_groups(int H) { return std::max(1, WS_THREADS / ((H + 31) / 32 * 32)); }
inline size_t ws_h_floats(int H) {
  return (size_t(ws_row_groups(H)) * WS_RT * H + 3) / 4 * 4;
}
inline size_t ws_smem_bytes(int H) {
  return (ws_h_floats(H) + size_t(3) * H * H) * sizeof(float);
}
// does a direction's W_hh with the block's h tiles fit a block's shared memory
inline bool whh_in_shared(int H) { return ws_smem_bytes(H) <= SMEM_BLOCK_MAX; }

// The forward recurrence over a grid of (batch tile, direction) from gate
// streams whose element (d, t, b, j) lies at d * sxd + t * sxt + b * sxb + j;
// w (D, 3, H, H), b (D, 3, H), h0 (B, H); outputs (D, T, B, H). K3's forward
// and lean forward (WS false) and K2's second phase (either).
template <bool RES, typename TX, bool WS, int RT>
__global__ void gru_streams_fwd_kernel(const TX* __restrict__ xr,
                                       const TX* __restrict__ xz,
                                       const TX* __restrict__ xn, long long sxd,
                                       long long sxt, long long sxb,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b,
                                       const float* __restrict__ h0,
                                       float* __restrict__ out,
                                       float* __restrict__ r_out,
                                       float* __restrict__ z_out,
                                       float* __restrict__ n_out,
                                       float* __restrict__ hnb_out, int T, int B,
                                       int H) {
  extern __shared__ __align__(16) float smem[];
  const int d = blockIdx.y;
  const long long xo = d * sxd;
  const long long oo = (long long)d * T * B * H;
  const float* wd = w + size_t(d) * 3 * H * H;
  // The tile's rows and its h: without WS one tile a block, at the start of
  // shared memory, so that the row index and every address derived from it
  // stay uniform over the block (with them derived from threadIdx.y K3's
  // forward at the head's shape took 1.30 ms for 1.12 on an H100). With WS
  // blockDim.y tiles share the block's copy of W; blockDim.x is whole warps,
  // so threadIdx.y is one value a warp, and the shuffle tells the compiler.
  int b0 = blockIdx.x * RT;
  float* hs = smem;
  const float* w_s = nullptr;
  if constexpr (WS) {
    const int group = __shfl_sync(0xffffffffu, int(threadIdx.y), 0);
    b0 = (blockIdx.x * blockDim.y + group) * RT;
    hs = smem + size_t(group) * RT * H;
    float* stage = smem + (size_t(blockDim.y) * RT * H + 3) / 4 * 4;
    const int n_threads = blockDim.x * blockDim.y;
    for (int idx = threadIdx.y * blockDim.x + threadIdx.x; idx < 3 * H * H;
         idx += n_threads)
      stage[idx] = wd[idx];
    w_s = stage;  // visible after the tile's first barrier
  }
  gru_recurrence_tile<RES, TX, WS, RT>(
      xr + xo, xz + xo, xn + xo, sxt, sxb, wd, b + size_t(d) * 3 * H, h0, out + oo,
      RES ? r_out + oo : nullptr, RES ? z_out + oo : nullptr,
      RES ? n_out + oo : nullptr, RES ? hnb_out + oo : nullptr, (long long)B * H, H, T,
      B, H, b0, d == 1, hs, w_s);
}

// `small_h`: take the shared-memory variant where W fits (K2's second phase);
// without it every shape runs the 8-row tile that reads W from L2 (K3).
template <bool RES, typename TX>
cudaError_t launch_streams_fwd(const void* xr, const void* xz, const void* xn,
                               long long sxd, long long sxt, long long sxb,
                               const void* w, const void* b, const void* h0, void* out,
                               void* r, void* z, void* n, void* hnb, int T, int B,
                               int H, int D, bool small_h, cudaStream_t st) {
  const bool ws = small_h && whh_in_shared(H);
  auto* kernel = ws ? gru_streams_fwd_kernel<RES, TX, true, WS_RT>
                    : gru_streams_fwd_kernel<RES, TX, false, BT>;
  const size_t smem = ws ? ws_smem_bytes(H) : size_t(BT) * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int groups = ws ? ws_row_groups(H) : 1;
  const int rows = groups * (ws ? WS_RT : BT);
  kernel<<<dim3((B + rows - 1) / rows, D), dim3((H + 31) / 32 * 32, groups), smem, st>>>(
      static_cast<const TX*>(xr), static_cast<const TX*>(xz),
      static_cast<const TX*>(xn), sxd, sxt, sxb, static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(h0),
      static_cast<float*>(out), static_cast<float*>(r), static_cast<float*>(z),
      static_cast<float*>(n), static_cast<float*>(hnb), T, B, H);
  return cudaGetLastError();
}

// The serial part of a GRU layer's backward, one block per (batch tile,
// direction): walks t in the reverse of the forward's order with the dh
// carry in registers; per step forms the gate gradients
//   dn = g (1 - z)(1 - n^2), dz = g (hprev - n) z (1 - z), dr = dn hnb r (1 - r)
// (g = the upstream gradient plus the carry), carries dh = g z + d_hid W^T
// and writes the two gate-gradient streams (T, B, D, 3, H):
//   d_in  = (dr, dz, dn)      what the input projection sees, in TX
//   d_hid = (dr, dz, dn * r)  what the hidden projection sees, f32
// g, r, z, n, hnb, hprev are (D, T, B, H) f32; whh_t (D, 3, H, H) holds
// W_hh^T so that thread j reads row k of it coalesced:
// whh_t[d, g, k, j] = whh[d, g, j, k]. dh0 (D, B, H) gets the carry after the
// last step. Shared memory: 3 * H * BT floats, [gate][k][row].
template <typename TX>
__global__ void gru_bwd_recurrence_kernel(const float* __restrict__ g,
                                          const float* __restrict__ r_in,
                                          const float* __restrict__ z_in,
                                          const float* __restrict__ n_in,
                                          const float* __restrict__ hnb_in,
                                          const float* __restrict__ hprev,
                                          const float* __restrict__ whh_t,
                                          TX* __restrict__ d_in,
                                          float* __restrict__ d_hid,
                                          float* __restrict__ dh0,
                                          int T, int B, int H, int D) {
  extern __shared__ __align__(16) float smem[];
  float* gh = smem;          // (3, H, BT): this step's d_hid of the tile

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const bool active = j < H;
  const float* Wt = whh_t + size_t(d) * 3 * H * H;

  float dh[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) dh[r] = 0.f;

  for (int s = 0; s < T; ++s) {
    // the forward walked d=0 up and d=1 down in t; the backward reverses it
    const int tt = d == 0 ? T - 1 - s : s;
    float dhz[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int b = b0 + r;
      float dr = 0.f, dz = 0.f, dnh = 0.f, keep = 0.f;
      if (active && b < B) {
        const size_t idx = ((size_t(d) * T + tt) * B + b) * H + j;
        const float gt = g[idx] + dh[r];
        const float rv = r_in[idx], zv = z_in[idx], nv = n_in[idx];
        const float dn = gt * (1.f - zv) * (1.f - nv * nv);
        dz = gt * (hprev[idx] - nv) * zv * (1.f - zv);
        dr = dn * hnb_in[idx] * rv * (1.f - rv);
        dnh = dn * rv;
        keep = gt * zv;
        const size_t o = ((size_t(tt) * B + b) * D + d) * 3 * H + j;
        st_stream(d_in + o, dr);
        st_stream(d_in + o + H, dz);
        st_stream(d_in + o + 2 * H, dn);
        d_hid[o] = dr;
        d_hid[o + H] = dz;
        d_hid[o + 2 * H] = dnh;
      }
      dhz[r] = keep;
      if (active) {
        gh[(0 * H + j) * BT + r] = dr;
        gh[(1 * H + j) * BT + r] = dz;
        gh[(2 * H + j) * BT + r] = dnh;
      }
    }
    __syncthreads();  // the tile's d_hid is in shared memory
    if (active) {
      // the three gates' rows k side by side: three loads in flight per k
      const float* w = Wt + j;
#pragma unroll KU
      for (int k = 0; k < H; ++k) {
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const float wv = __ldg(w + (size_t(gate) * H + k) * H);
          const float* ghk = gh + (gate * H + k) * BT;
          const float4 ga = *reinterpret_cast<const float4*>(ghk);
          const float4 gb = *reinterpret_cast<const float4*>(ghk + 4);
          const float gv[BT] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
          for (int r = 0; r < BT; ++r) dhz[r] += gv[r] * wv;
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) dh[r] = dhz[r];
    }
    __syncthreads();  // every thread has read this step's d_hid
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < BT; ++r)
      if (b0 + r < B) dh0[(size_t(d) * B + b0 + r) * H + j] = dh[r];
  }
}

template <typename TX>
cudaError_t launch_bwd_recurrence(const float* g, const float* r, const float* z,
                                  const float* n, const float* hnb,
                                  const float* hprev, const float* whh_t, TX* d_in,
                                  float* d_hid, float* dh0, int T, int B, int H,
                                  int D, cudaStream_t st) {
  const size_t smem = size_t(3) * BT * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_recurrence_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int threads = (H + 31) / 32 * 32;
  gru_bwd_recurrence_kernel<TX><<<dim3((B + BT - 1) / BT, D), threads, smem, st>>>(
      g, r, z, n, hnb, hprev, whh_t, d_in, d_hid, dh0, T, B, H, D);
  return cudaGetLastError();
}

// C[m, n] = sum_k A[m, k] B[k, n] over one 64 x 64 output tile and one
// slice of K per block, k in order. A[m, k] = A[m * sam + k * sak],
// B[k, n] = B[k * sbk + n * sbn], C[m, n] = C[m * scm + n]. Matrix z of a
// batch has its operands offset by (z / zdiv) * hi + (z % zdiv) * lo; block
// z of the grid is slice z % ksplit of matrix z / ksplit. With ksplit > 1
// a block writes its partial tile, packed (M, N), to part[z] instead of C.
constexpr int GM = 64, GN = 64, GK = 16, GEMM_THREADS = 256;
// blocks a GEMM should have to fill the card: two waves of two blocks on
// each of an H100's 132 SMs
constexpr int TARGET_BLOCKS = 4 * 132;
constexpr int MIN_SLICE = 256;   // K per block at the least

struct ZOff {
  long long hi, lo;
  __host__ __device__ __forceinline__ long long at(int z, int zdiv) const {
    return (z / zdiv) * hi + (z % zdiv) * lo;
  }
};

__global__ void __launch_bounds__(GEMM_THREADS)
gru_gemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                float* __restrict__ C, float* __restrict__ part, int M, int N,
                int K, int ksplit, long long sam, long long sak, long long sbk,
                long long sbn, long long scm, int zdiv, ZOff za, ZOff zb,
                ZOff zc) {
  __shared__ float As[GK][GM + 4];
  __shared__ float Bs[GK][GN + 4];
  const int zm = blockIdx.z / ksplit, slice = blockIdx.z % ksplit;
  A += za.at(zm, zdiv);
  Bm += zb.at(zm, zdiv);
  const int chunk = ((K + ksplit - 1) / ksplit + GK - 1) / GK * GK;
  const int kbeg = slice * chunk, kend = min(K, kbeg + chunk);
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += GK) {
    // load along whichever axis is contiguous in memory
#pragma unroll
    for (int e = 0; e < GM * GK / GEMM_THREADS; ++e) {
      const int idx = tid + e * GEMM_THREADS;
      const int m = sam == 1 ? idx % GM : idx / GK;
      const int k = sam == 1 ? idx / GM : idx % GK;
      const bool ok = m0 + m < M && k0 + k < kend;
      As[k][m] = ok ? A[(m0 + m) * sam + (k0 + k) * sak] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < GN * GK / GEMM_THREADS; ++e) {
      const int idx = tid + e * GEMM_THREADS;
      const int n = sbn == 1 ? idx % GN : idx / GK;
      const int k = sbn == 1 ? idx / GN : idx % GK;
      const bool ok = n0 + n < N && k0 + k < kend;
      Bs[k][n] = ok ? Bm[(k0 + k) * sbk + (n0 + n) * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[k][tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += a[i] * b[c];
    }
    __syncthreads();
  }
  float* out = ksplit == 1 ? C + zc.at(zm, zdiv) : part + size_t(blockIdx.z) * M * N;
  const long long stride = ksplit == 1 ? scm : N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (m < M && n < N) out[m * stride + n] = acc[i][c];
    }
  }
}

// C[m, n] of matrix z = sum over its slices, in slice order
__global__ void gru_splitk_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ C, int M, int N,
                                         int ksplit, long long scm, int zdiv,
                                         ZOff zc, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int zm = idx / (M * N), mn = idx % (M * N);
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += part[(size_t(zm) * ksplit + k) * M * N + mn];
  C[zc.at(zm, zdiv) + (mn / N) * scm + mn % N] = s;
}

// out[c] = sum_r src[r * cols + c], rows in a fixed order: 32 columns per
// block, 8 row slices per column summed in slice order
__global__ void gru_colsum_kernel(const float* __restrict__ src,
                                  float* __restrict__ out, int rows, int cols) {
  __shared__ float part[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  const int slice = threadIdx.x / 32;
  float s = 0.f;
  if (c < cols)
    for (int r = slice; r < rows; r += 8) s += src[size_t(r) * cols + c];
  part[slice][threadIdx.x % 32] = s;
  __syncthreads();
  if (slice == 0 && c < cols) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) total += part[i][threadIdx.x];
    out[c] = total;
  }
}

inline cudaError_t colsum(const float* src, float* out, int rows, int cols,
                          cudaStream_t st) {
  gru_colsum_kernel<<<(cols + 31) / 32, 256, 0, st>>>(src, out, rows, cols);
  return cudaGetLastError();
}

// slices of K for a GEMM of nz matrices (M, N, K): enough blocks to fill
// the card, each with at least MIN_SLICE of K
inline int gemm_splits(int M, int N, int K, int nz) {
  const long long blocks = (long long)((N + GN - 1) / GN) * ((M + GM - 1) / GM) * nz;
  const long long want = (TARGET_BLOCKS + blocks - 1) / blocks;
  return int(std::max(1LL, std::min(want, (long long)(K + MIN_SLICE - 1) / MIN_SLICE)));
}

// floats of workspace gemm() needs for these shapes (0: none)
inline size_t gemm_workspace(int M, int N, int K, int nz) {
  const int ks = gemm_splits(M, N, K, nz);
  return ks == 1 ? 0 : size_t(nz) * ks * M * N;
}

inline cudaError_t gemm(const float* A, const float* Bm, float* C, float* part,
                        int M, int N, int K, long long sam, long long sak,
                        long long sbk, long long sbn, long long scm, int nz,
                        int zdiv, ZOff za, ZOff zb, ZOff zc, cudaStream_t st) {
  const int ks = gemm_splits(M, N, K, nz);
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, nz * ks);
  gru_gemm_kernel<<<grid, GEMM_THREADS, 0, st>>>(A, Bm, C, part, M, N, K, ks, sam,
                                                 sak, sbk, sbn, scm, zdiv, za, zb, zc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ks == 1) return err;
  const int total = nz * M * N;
  gru_splitk_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(part, C, M, N, ks, scm,
                                                                zdiv, zc, total);
  return cudaGetLastError();
}

// dwhh[d, gate] (H, H) = hprev[d]^T (H, T*B) . d_hid[:, d, gate] (T*B, H):
// the hidden weights' gradient of K2 and K3, 3 * D matrices in one launch
inline cudaError_t dwhh_gemm(const float* hprev, const float* d_hid, float* dwhh,
                             float* part, int T, int B, int H, int D,
                             cudaStream_t st) {
  const long long TB = (long long)T * B, G = 3LL * D * H;
  return gemm(hprev, d_hid, dwhh, part, H, H, int(TB), 1, H, G, 1, H, 3 * D, 3,
              ZOff{TB * H, 0}, ZOff{3LL * H, H}, ZOff{3LL * H * H, (long long)H * H},
              st);
}

}  // namespace
