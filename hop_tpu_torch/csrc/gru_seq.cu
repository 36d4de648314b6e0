// Batch-tiled GRU sequence kernel (kernel K6) for Hopper, sm_90a: the
// forward-only recurrence of ONE direction from a batch-major projection.
//
// Replaces the TPU kernel `_gru_seq_kernel` (:36-52, called by
// `pallas_gru_layer` :54-100) of hop_tpu/ops/pallas_gru.py:
//   hr, hz, hn = h W[g];  r = sigmoid(xr + hr + b[r]);  z = sigmoid(xz + hz + b[z])
//   n = tanh(xn + r * (hn + b[n]));  h' = (1 - z) n + z h
// x_proj (B, T, 3H) f32 with b_ih already added, gates r, z, n side by side
// in the last axis; w_t (3, H, H) laid out [gate][k][j] (W_hh of torch's
// (3H, H) layout, each gate transposed); b_hh (3H,); h0 (B, H); out
// (B, T, H) f32.
//
// The TPU kernel already tiled the batch over its grid and kept all T steps
// of a tile in one program, h and W_hh on chip; its grid ran the tiles one
// after another. Here the tiles are blocks that run side by side: one block
// per 8 batch rows loops over T with h in shared memory
// (gru_recurrence_tile in gru_common.cuh, shared with K3's forward), the
// three gate streams being three offsets into x_proj (computed by the host
// and passed as three pointers: derived inside the kernel from one
// __restrict__ base they compiled to a kernel twice as slow). W_hh (1.47 MB at
// H=350) does not fit an SM and is re-read from L2 at each step. The
// reverse direction is an index (t runs from T-1 down, outputs land at
// their natural time), where the TPU wrapper flipped x_proj and the output
// in HBM. Any B: the ragged last tile is masked in the kernel.
// What bounds it: operations. 6.4 GFLOP of f32 FMAs at (B=256, T=34, H=350)
// against 49 MB of traffic. At B=1 a single block does all the work: the
// 34 steps of 350 dependent weight rows are latency, not throughput.

#include "gru_common.cuh"

namespace {

__global__ void gru_seq_fwd_kernel(const float* __restrict__ xr,
                                   const float* __restrict__ xz,
                                   const float* __restrict__ xn, long long sxt,
                                   long long sxb, const float* __restrict__ w_t,
                                   const float* __restrict__ b_hh,
                                   const float* __restrict__ h0,
                                   float* __restrict__ out, long long sot,
                                   long long sob, int T, int B, int H,
                                   int reverse) {
  extern __shared__ __align__(16) float smem[];
  gru_recurrence_tile<false, float, false, BT>(xr, xz, xn, sxt, sxb, w_t, b_hh, h0, out,
                                               nullptr, nullptr, nullptr, nullptr, sot,
                                               sob, T, B, H, blockIdx.x * BT,
                                               reverse != 0, smem, nullptr);
}

}  // namespace

extern "C" int hop_gru_seq_fwd(const void* x_proj, const void* w_t, const void* b_hh,
                               const void* h0, void* out, int T, int B, int H,
                               int reverse, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > 1024) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(BT) * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_seq_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int threads = (H + 31) / 32 * 32;
  // the three gate streams are three offsets into a row of x_proj
  const auto* x = static_cast<const float*>(x_proj);
  gru_seq_fwd_kernel<<<(B + BT - 1) / BT, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, x + H, x + 2 * H, 3LL * H, 3LL * H * T, static_cast<const float*>(w_t),
      static_cast<const float*>(b_hh), static_cast<const float*>(h0),
      static_cast<float*>(out), H, (long long)H * T, T, B, H, reverse);
  return int(cudaGetLastError());
}
