// GRU sequence kernel (kernel K6) for Hopper, sm_90a: the forward-only
// recurrence of ONE direction from a batch-major projection.
//
// Replaces the TPU kernel `_gru_seq_kernel` (:36-52, called by
// `pallas_gru_layer` :54-100) of hop_tpu/ops/pallas_gru.py:
//   hr, hz, hn = h W[g];  r = sigmoid(xr + hr + b[r]);  z = sigmoid(xz + hz + b[z])
//   n = tanh(xn + r * (hn + b[n]));  h' = (1 - z) n + z h
// x_proj (B, T, 3H) f32 with b_ih already added, gates r, z, n side by side
// in the last axis; w_t (3, H, H) laid out [gate][k][j] (W_hh of torch's
// (3H, H) layout, each gate transposed); b_hh (3H,); h0 (B, H); out
// (B, T, H) f32. H <= RC_MAX_H (352).
//
// The TPU kernel tiled the batch over its grid and kept all T steps of a
// tile in one program, h and W_hh on chip; its grid ran the tiles one after
// another, and its wrapper flipped x_proj and the output in HBM for the
// reverse direction. Here the direction's recurrence is K2's and K3's
// (launch_fwd_recurrence in gru_common.cuh), fed by strides: the three gate
// streams are three offsets into x_proj (t stride 3H, b stride 3HT), the
// output is batch-major (t stride H, b stride HT), and `reverse` walks t from
// T-1 down with outputs at their natural time index. W_hh stays on the chip
// for the whole loop, the per-step product on the tensor cores (3xTF32
// mma.sync): at H <= 64 one block of 8 rows holds it in its warps'
// registers; else a cluster of 8 blocks, each holding an eighth of W_hh in
// shared memory (185 KB at H = 350) and exchanging its slice of h through
// distributed shared memory, 24 rows a cluster at one direction (B = 256:
// 11 clusters on 88 SMs), 8 for a batch of at most 8.
// What bounds it: operations, 6.4 GFLOP of f32 work at (B=256, T=34, H=350)
// against 49 MB of traffic (0.095 ms); run as three TF32 MMAs a product at
// mma.sync's rate it takes 0.53 ms on an H100 at 700 W (40 rows a cluster:
// 0.75; the kernel that re-read W_hh from L2 at every step: 1.16), and at
// B=1, a chain of 34 serial steps, 0.30 ms (1.12).

#include "gru_common.cuh"

extern "C" int hop_gru_seq_fwd(const void* x_proj, const void* w_t, const void* b_hh,
                               const void* h0, void* out, int T, int B, int H,
                               int reverse, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > RC_MAX_H) return int(cudaErrorInvalidValue);
  // the three gate streams are three offsets into a row of x_proj
  const auto* x = static_cast<const float*>(x_proj);
  return int(launch_fwd_recurrence<false, float>(
      x, x + H, x + 2 * H, 0, 3LL * H, 3LL * H * T, w_t, b_hh, h0, out, nullptr, nullptr,
      nullptr, nullptr, 0, H, (long long)H * T, T, B, H, 1, reverse ? 1 : 0,
      static_cast<cudaStream_t>(stream)));
}
