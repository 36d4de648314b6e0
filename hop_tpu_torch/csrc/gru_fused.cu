// Fused bidirectional GRU layer forward (kernel K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_make_fwd_kernel` of hop_tpu/ops/pallas_gru_fused.py
// (:113-144, `gru_fused_layer` without residuals). One layer, both
// directions, with the gate input projections x . W_ih computed inside the
// recurrence, gates ordered r, z, n as in torch.nn.GRU:
//   r = sigmoid(x W_ih[r] + b_ih[r] + h W_hh[r] + b_hh[r])
//   z = sigmoid(x W_ih[z] + b_ih[z] + h W_hh[z] + b_hh[z])
//   n = tanh(x W_ih[n] + b_ih[n] + r * (h W_hh[n] + b_hh[n]))
//   h' = (1 - z) n + z h
// x (T, B, I), W_ih (D, 3, I, H), W_hh (D, 3, H, H), biases (D, 3, 1, H),
// h0 (B, H), out (D, T, B, H); all f32, f32 accumulation, no TF32.
//
// The TPU grid (D, batch tiles, T) ran in order and carried h from one time
// step to the next in VMEM scratch. A GPU grid carries nothing between
// blocks, so T is a loop inside the block:
//   * one block per (batch tile of 8 rows, direction); at B=256 that is 64
//     blocks;
//   * one thread per hidden unit j (blockDim = H rounded up to a warp); each
//     step it accumulates the six projections of column j for the tile's 8
//     rows, from x_t and h_{t-1} held in shared memory;
//   * W_ih (4.2 MB at I=992) and W_hh (1.47 MB) of a direction do not fit
//     shared memory; they are read through L2 (50 MB), coalesced along j;
//   * the backward direction walks t from T-1 down to 0 and writes its
//     outputs at their natural time index.
// What bounds it: each block re-reads its direction's weights from L2 at
// every step (5.7 MB per step at I=992), and the FMAs of the tile (22.5
// MFLOP per step) run on one SM; 64 blocks leave half the 132 SMs idle.
// Splitting H across a cluster with the weights in distributed shared
// memory, and tensor-core products, are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 8;  // batch rows per block

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void gru_fused_fwd_kernel(const float* __restrict__ x,
                                     const float* __restrict__ wih,
                                     const float* __restrict__ bih,
                                     const float* __restrict__ whh,
                                     const float* __restrict__ bhh,
                                     const float* __restrict__ h0,
                                     float* __restrict__ out,
                                     int T, int B, int I, int H) {
  extern __shared__ float smem[];
  float* xs = smem;          // (BT, I): x at the current step
  float* hs = xs + BT * I;   // (BT, H): h_{t-1}

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const int nthreads = blockDim.x;
  const bool active = j < H;

  const float* Wi = wih + size_t(d) * 3 * I * H;
  const float* Wh = whh + size_t(d) * 3 * H * H;
  float bi[3] = {0.f, 0.f, 0.f}, bh[3] = {0.f, 0.f, 0.f};
  if (active) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      bi[g] = bih[(d * 3 + g) * H + j];
      bh[g] = bhh[(d * 3 + g) * H + j];
    }
  }

  for (int idx = j; idx < BT * H; idx += nthreads) {
    const int b = b0 + idx / H;
    hs[idx] = b < B ? h0[size_t(b) * H + idx % H] : 0.f;
  }

  for (int t = 0; t < T; ++t) {
    const int tt = d == 0 ? t : T - 1 - t;
    // rows b0..b0+BT-1 of x[tt] are one contiguous run of BT * I floats
    const float* xt = x + (size_t(tt) * B + b0) * I;
    const int valid = min(BT, B - b0) * I;
    for (int idx = j; idx < BT * I; idx += nthreads) xs[idx] = idx < valid ? xt[idx] : 0.f;
    __syncthreads();  // x_t in place; h_{t-1} written by every thread

    float hn[BT];
    if (active) {
      float ar[BT], az[BT], an[BT], gr[BT], gz[BT], gn[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        ar[r] = bi[0]; az[r] = bi[1]; an[r] = bi[2];
        gr[r] = bh[0]; gz[r] = bh[1]; gn[r] = bh[2];
      }
      const float* w0 = Wi + j;
      const float* w1 = Wi + size_t(I) * H + j;
      const float* w2 = Wi + size_t(2) * I * H + j;
#pragma unroll 4
      for (int i = 0; i < I; ++i) {
        const float a0 = __ldg(w0 + size_t(i) * H);
        const float a1 = __ldg(w1 + size_t(i) * H);
        const float a2 = __ldg(w2 + size_t(i) * H);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float xv = xs[r * I + i];
          ar[r] += xv * a0;
          az[r] += xv * a1;
          an[r] += xv * a2;
        }
      }
      const float* u0 = Wh + j;
      const float* u1 = Wh + size_t(H) * H + j;
      const float* u2 = Wh + size_t(2) * H * H + j;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float c0 = __ldg(u0 + size_t(k) * H);
        const float c1 = __ldg(u1 + size_t(k) * H);
        const float c2 = __ldg(u2 + size_t(k) * H);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float hv = hs[r * H + k];
          gr[r] += hv * c0;
          gz[r] += hv * c1;
          gn[r] += hv * c2;
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float rg = sigmoidf(ar[r] + gr[r]);
        const float zg = sigmoidf(az[r] + gz[r]);
        const float ng = tanhf(an[r] + rg * gn[r]);
        hn[r] = (1.f - zg) * ng + zg * hs[r * H + j];
      }
    }
    __syncthreads();  // every thread has read x_t and h_{t-1}
    if (active) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        hs[r * H + j] = hn[r];
        if (b0 + r < B) out[((size_t(d) * T + tt) * B + b0 + r) * H + j] = hn[r];
      }
    }
  }
}

}  // namespace

extern "C" int hop_gru_fused_fwd(const void* x, const void* wih, const void* bih,
                                 const void* whh, const void* bhh, const void* h0,
                                 void* out, int T, int B, int I, int H, int D,
                                 void* stream) {
  if (T < 1 || B < 1 || I < 1 || H < 1 || H > 1024 || D < 1 || D > 2)
    return int(cudaErrorInvalidValue);
  const size_t smem = size_t(BT) * (I + H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int threads = (H + 31) / 32 * 32;
  const dim3 grid((B + BT - 1) / BT, D);
  gru_fused_fwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wih),
      static_cast<const float*>(bih), static_cast<const float*>(whh),
      static_cast<const float*>(bhh), static_cast<const float*>(h0),
      static_cast<float*>(out), T, B, I, H);
  return int(cudaGetLastError());
}
