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
//   * gru_mma_gemm_kernel / gemm(): an f32 GEMM on the tensor cores at f32
//     accuracy (each operand split into TF32 hi + lo, three mma.sync.m16n8k8
//     a product), operands staged as they lie by cp.async, ordered split-K
//     (K2's dx, dW_ih, dW_hh; K3's dW_hh); its pieces (cp.async, split_tf32,
//     mma_tf32) also serve K2's forward projection;
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

// --- the tensor-core pieces: cp.async, the TF32 split, mma.sync ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V floats (4, 2 or 1) from device to shared memory, or zeros when !ok
template <int V>
__device__ __forceinline__ void cp_async_floats(float* dst, const float* src, bool ok) {
  const int bytes = ok ? 4 * V : 0;
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  else if constexpr (V == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x as hi + lo in TF32 (10 mantissa bits each): hi is x rounded to nearest
// (ties away from zero) by integer arithmetic on its bits, lo the exact
// remainder x - hi, whose low 13 mantissa bits the tensor core ignores:
// hi + lo = x to 2^-21. (Three full-rate integer and float operations;
// cvt.rna.tf32.f32 for both halves made K2's projection 0.90 ms where this
// makes it 0.74 ms at the head's first layer on an H100.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- the backward's GEMM: f32 in and out, 3xTF32 on the tensor cores ---
//
// C[m, n] = sum over segments s < nseg and k < K of A_s[m, k] B_s[k, n], for
// each matrix z of a batch. The operands are read as they lie, in one of the
// two layouts the backward has:
//   KROWS:  A_s[m, k] = A[s * a_seg + m * lda + k], B_s[k, n] = B[s * b_seg + n * ldb + k]
//           (both operands' rows run along k)
//   !KROWS: A_s[m, k] = A[s * a_seg + k * lda + m], B_s[k, n] = B[s * b_seg + k * ldb + n]
//           (k is both operands' row index)
// and C[m, n] = C[m * ldc + n]; matrix z has its operands offset by
// (z / zdiv) * hi + (z % zdiv) * lo. dx = d_in . W_ih^T is KROWS with one
// segment per (direction, gate): W_ih (D, 3, I, H) is read in place, k = h
// contiguous, which is the col-major B fragment's own order. dW_ih = x^T d_in
// and dW_hh = hprev^T d_hid are !KROWS: the tiles are staged as they lie,
// [k][m] and [k][n], and the A fragment is read transposed from shared memory.
// Rows are padded so that a fragment read hits 32 banks: a row along k by 4
// floats (lane (g, t4) reads word 36 g + t4), a row along m or n by 8 (word
// 8 t4 + g).
//
// A block owns one BM x BN output tile and one slice of the 32-deep k tiles
// (segments laid end to end), summed in order; with ksplit > 1 it writes its
// partial tile, packed (M, N), to part[blockIdx.z] and
// gru_splitk_reduce_kernel adds the slices in slice order: no atomics.
// 8 warps, 2 (M) x 4 (N); the 128 x 128 tile is the projection's
// (gru_fused.cu), the 64 x 64 tile serves the discriminator's narrow shapes,
// where a 128-wide tile would be mostly padding.
constexpr int MK = 32;              // depth of an operand tile
constexpr int MMA_THREADS = 256;
constexpr int MMA_STAGES = 3;
constexpr int SM_COUNT = 132;       // an H100's
// K of one block. The tensor cores truncate where an f32 add rounds, and the
// loss grows with the length of one accumulator chain (2e-5 relative at
// K = 2000, as measured on the projection); a slice's chain ends at
// MAX_SLICE, and the slices meet in ordinary f32 adds.
constexpr int MIN_SLICE = 256;
constexpr int MAX_SLICE = 2304;

struct ZOff {
  long long hi, lo;
  __host__ __device__ __forceinline__ long long at(int z, int zdiv) const {
    return (z / zdiv) * hi + (z % zdiv) * lo;
  }
};

// One batched product: nz matrices. gemm() fills part, ksplit and per_slice.
struct Gemm {
  const float* A;
  const float* B;
  float* C;
  int M, N, K, nseg;
  bool krows;
  long long lda, ldb, ldc, a_seg, b_seg;
  int nz, zdiv;
  ZOff za, zb, zc;
  float* part;
  int ksplit, per_slice;   // slices of a matrix, k tiles of a slice
};

template <int BM, int BN, bool KROWS>
struct MmaTile {
  static constexpr int LDA = KROWS ? MK + 4 : BM + 8;
  static constexpr int LDB = KROWS ? MK + 4 : BN + 8;
  static constexpr int A_FLOATS = (KROWS ? BM : MK) * LDA;
  static constexpr int STAGE_FLOATS = A_FLOATS + (KROWS ? BN : MK) * LDB;
  static constexpr size_t SMEM_BYTES = size_t(MMA_STAGES) * STAGE_FLOATS * sizeof(float);
  static constexpr int BLOCKS_PER_SM = BM * BN >= 128 * 128 ? 2 : 3;
};

// One operand's BX x MK tile (rows x0 .., depth k0 ..) from device to shared
// memory in pieces of V floats, as it lies: [x][k] with KROWS, else [k][x];
// what lies past X or K is zero-filled.
template <int BX, bool KROWS, int V>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long ld,
                                           int x0, int X, int k0, int K) {
  constexpr int LD = KROWS ? MK + 4 : BX + 8;
  constexpr int ROW = (KROWS ? MK : BX) / V;   // pieces of a staged row
  static_assert(BX * MK / V % MMA_THREADS == 0, "whole pieces per thread");
#pragma unroll
  for (int i = 0; i < BX * MK / V / MMA_THREADS; ++i) {
    const int c = threadIdx.x + i * MMA_THREADS;
    const int row = c / ROW, col = c % ROW * V;
    const int x = x0 + (KROWS ? row : col), k = k0 + (KROWS ? col : row);
    const bool ok = x < X && k < K;
    const long long at = KROWS ? x * ld + k : k * ld + x;
    cp_async_floats<V>(dst + row * LD + col, ok ? src + at : src, ok);
  }
}

template <int BM, int BN, bool KROWS, int V>
__global__ void __launch_bounds__(MMA_THREADS, MmaTile<BM, BN, KROWS>::BLOCKS_PER_SM)
gru_mma_gemm_kernel(const Gemm p) {
  using Tile = MmaTile<BM, BN, KROWS>;
  constexpr int LDA = Tile::LDA, LDB = Tile::LDB;
  constexpr int MI = BM / 2 / 16, NI = BN / 4 / 8;   // MMA tiles of a warp
  static_assert(BM % 32 == 0 && BN % 32 == 0, "2 x 4 warps of 16 x 8 MMA tiles");
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = (warp / 4) * (BM / 2), wn = (warp % 4) * (BN / 4);
  const int zm = blockIdx.z / p.ksplit, slice = blockIdx.z % p.ksplit;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* Az = p.A + p.za.at(zm, p.zdiv);
  const float* Bz = p.B + p.zb.at(zm, p.zdiv);
  const int seg_tiles = (p.K + MK - 1) / MK;
  const int kt0 = slice * p.per_slice;
  const int n_k = min(p.nseg * seg_tiles, kt0 + p.per_slice) - kt0;

  auto load = [&](int kt, int stage) {
    float* As = smem + stage * Tile::STAGE_FLOATS;
    const int seg = kt / seg_tiles, k0 = (kt - seg * seg_tiles) * MK;
    stage_tile<BM, KROWS, V>(As, Az + seg * p.a_seg, p.lda, m0, p.M, k0, p.K);
    stage_tile<BN, KROWS, V>(As + Tile::A_FLOATS, Bz + seg * p.b_seg, p.ldb, n0, p.N, k0,
                             p.K);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < n_k) load(kt0 + s, s);
    cp_async_commit();
  }
  // fragment strides: to the next row (m or n) and to the next k
  constexpr int A_ROW = KROWS ? LDA : 1, A_K = KROWS ? 1 : LDA;
  constexpr int B_ROW = KROWS ? LDB : 1, B_K = KROWS ? 1 : LDB;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is free for every warp
    if (kt + MMA_STAGES - 1 < n_k)
      load(kt0 + kt + MMA_STAGES - 1, (kt + MMA_STAGES - 1) % MMA_STAGES);
    cp_async_commit();
    const float* As = smem + (kt % MMA_STAGES) * Tile::STAGE_FLOATS;
    const float* Bs = As + Tile::A_FLOATS;
    // tiles past a segment's K are zero-filled: whole 8-deep steps only
    const int k_left = p.K - (kt0 + kt) % seg_tiles * MK;
    const int k_steps = (min(MK, k_left) + 7) / 8;
    for (int k8 = 0; k8 < k_steps; ++k8) {
      const int kb = k8 * 8;
      // a[0], a[2]: row g, columns t4 and t4 + 4; a[1], a[3]: row g + 8
      uint32_t a_hi[MI][4], a_lo[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* ar = As + (wm + mi * 16 + g) * A_ROW + (kb + t4) * A_K;
        split_tf32(ar[0], a_hi[mi][0], a_lo[mi][0]);
        split_tf32(ar[8 * A_ROW], a_hi[mi][1], a_lo[mi][1]);
        split_tf32(ar[4 * A_K], a_hi[mi][2], a_lo[mi][2]);
        split_tf32(ar[8 * A_ROW + 4 * A_K], a_hi[mi][3], a_lo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        // b0: (k = t4, n = g); b1: (k = t4 + 4, n = g)
        const float* br = Bs + (wn + ni * 8 + g) * B_ROW + (kb + t4) * B_K;
        uint32_t b_hi[2], b_lo[2];
        split_tf32(br[0], b_hi[0], b_lo[0]);
        split_tf32(br[4 * B_K], b_hi[1], b_lo[1]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          // the small terms first
          mma_tf32(acc[mi][ni], a_lo[mi], b_hi[0], b_hi[1]);
          mma_tf32(acc[mi][ni], a_hi[mi], b_lo[0], b_lo[1]);
          mma_tf32(acc[mi][ni], a_hi[mi], b_hi[0], b_hi[1]);
        }
      }
    }
  }

  // acc[..][0], [1]: row g, columns 2 t4, + 1; [2], [3]: row g + 8
  const bool whole = p.ksplit == 1;
  float* out = whole ? p.C + p.zc.at(zm, p.zdiv)
                     : p.part + size_t(blockIdx.z) * p.M * p.N;
  const long long ld = whole ? p.ldc : p.N;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t4;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + 8 * half;
        if (row >= p.M) continue;
        float* dst = out + row * ld + col;
        if (col < p.N) dst[0] = acc[mi][ni][2 * half];
        if (col + 1 < p.N) dst[1] = acc[mi][ni][2 * half + 1];
      }
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

// The tile and the K slices of nz products (M, N) over n_kt k tiles, from
// the shape alone. The 128 x 128 tile where both sides fill it and its
// blocks can fill the card, else the 64 x 64 tile. A slice is at most
// MAX_SLICE deep (the accumulator chain, above) and at least MIN_SLICE.
// Where the tiles alone do not fill one wave of blocks, the slice count is
// the smallest one whose blocks fill their last wave to 90%, else the one
// that fills it most.
struct GemmPlan {
  bool big;
  int ksplit, per_slice;
};

inline GemmPlan gemm_plan(int M, int N, int K, int nseg, int nz) {
  const int n_kt = nseg * ((K + MK - 1) / MK);
  const int lo = (n_kt * MK + MAX_SLICE - 1) / MAX_SLICE;
  const int hi = std::max(lo, std::min(64, n_kt * MK / MIN_SLICE));
  auto tiles = [&](int b) {
    return (long long)((M + b - 1) / b) * ((N + b - 1) / b) * nz;
  };
  const bool big = M >= 128 && N >= 128 && tiles(128) * hi >= SM_COUNT;
  const long long t = big ? tiles(128) : tiles(64);
  const long long slots = (long long)SM_COUNT * (big ? 2 : 3);
  int best = lo;
  if (t < slots) {
    double best_fill = 0.;
    for (int ks = lo; ks <= hi && best_fill < 0.9; ++ks) {
      const long long blocks = t * ks, waves = (blocks + slots - 1) / slots;
      const double fill = double(blocks) / double(waves * slots);
      if (fill > best_fill) {
        best = ks;
        best_fill = fill;
      }
    }
  }
  const int per_slice = (n_kt + best - 1) / best;
  return {big, (n_kt + per_slice - 1) / per_slice, per_slice};
}

// floats of workspace gemm() needs for these shapes (0: none)
inline size_t gemm_workspace(int M, int N, int K, int nseg, int nz) {
  const int ks = gemm_plan(M, N, K, nseg, nz).ksplit;
  return ks == 1 ? 0 : size_t(nz) * ks * M * N;
}

template <int BM, int BN, bool KROWS, int V>
cudaError_t launch_mma_gemm(const Gemm& q, cudaStream_t st) {
  using Tile = MmaTile<BM, BN, KROWS>;
  auto* kernel = gru_mma_gemm_kernel<BM, BN, KROWS, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid((q.N + BN - 1) / BN, (q.M + BM - 1) / BM, q.nz * q.ksplit);
  kernel<<<grid, MMA_THREADS, Tile::SMEM_BYTES, st>>>(q);
  return cudaGetLastError();
}

template <bool KROWS>
cudaError_t launch_mma_gemm_tile(bool big, int v, const Gemm& q, cudaStream_t st) {
#define HOP_GEMM(V)                                                    \
  return big ? launch_mma_gemm<128, 128, KROWS, V>(q, st)              \
             : launch_mma_gemm<64, 64, KROWS, V>(q, st);
  if (v == 4) HOP_GEMM(4)
  if (v == 2) HOP_GEMM(2)
  HOP_GEMM(1)
#undef HOP_GEMM
}

// `part`: gemm_workspace floats (may be NULL when that is 0)
inline cudaError_t gemm(Gemm q, float* part, cudaStream_t st) {
  const GemmPlan plan = gemm_plan(q.M, q.N, q.K, q.nseg, q.nz);
  if ((long long)q.nz * plan.ksplit > 65535 || (q.M + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  q.part = part;
  q.ksplit = plan.ksplit;
  q.per_slice = plan.per_slice;
  // pieces of 4, 2 or 1 floats: what the pointers, every row start, every
  // offset and the ragged edge along a row allow
  const size_t floats = size_t(q.lda | q.ldb | q.a_seg | q.b_seg | q.za.hi | q.za.lo |
                               q.zb.hi | q.zb.lo | (q.krows ? q.K : q.M | q.N));
  const size_t a = reinterpret_cast<size_t>(q.A) | reinterpret_cast<size_t>(q.B) |
                   floats * 4;
  const int v = a % 16 == 0 ? 4 : a % 8 == 0 ? 2 : 1;
  cudaError_t err = q.krows ? launch_mma_gemm_tile<true>(plan.big, v, q, st)
                            : launch_mma_gemm_tile<false>(plan.big, v, q, st);
  if (err != cudaSuccess || q.ksplit == 1) return err;
  const int total = q.nz * q.M * q.N;
  gru_splitk_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      part, q.C, q.M, q.N, q.ksplit, q.ldc, q.zdiv, q.zc, total);
  return cudaGetLastError();
}

// dw[d, gate] (rows, H) = a[d]^T (rows, T*B) . stream[:, d, gate] (T*B, H)
// for a gate-gradient stream (T, B, D, 3, H): the weight gradients of K2 and
// K3, 3 * D matrices in one launch. `a` is (T*B, rows) with element
// (d, tb, m) at d * a_dir + tb * rows + m: x (a_dir 0) or hprev.
inline Gemm dw_gemm(const float* a, long long a_dir, int rows, const float* stream,
                    float* dw, int T, int B, int H, int D) {
  const long long G = 3LL * D * H;
  return Gemm{a, stream, dw, rows, H, T * B, 1, false, rows, G, H, 0, 0, 3 * D, 3,
              ZOff{a_dir, 0}, ZOff{3LL * H, H},
              ZOff{3LL * rows * H, (long long)rows * H}};
}

inline size_t dw_gemm_workspace(int rows, int T, int B, int H, int D) {
  return gemm_workspace(rows, H, T * B, 1, 3 * D);
}

}  // namespace
