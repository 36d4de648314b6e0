// Fused bidirectional GRU layer (kernel K2) for Hopper, sm_90a: the forward,
// optionally with the residuals of the backward, and the backward.
//
// Replaces the TPU kernels `_make_fwd_kernel` (:113-144, `_fwd_call`
// :147-195) and `_make_bwd_kernel` (:202-310, `_bwd_call` :313-373) of
// hop_tpu/ops/pallas_gru_fused.py. One layer, both directions, with the gate
// input projections x . W_ih computed inside the recurrence, gates ordered
// r, z, n as in torch.nn.GRU:
//   r = sigmoid(x W_ih[r] + b_ih[r] + h W_hh[r] + b_hh[r])
//   z = sigmoid(x W_ih[z] + b_ih[z] + h W_hh[z] + b_hh[z])
//   n = tanh(x W_ih[n] + b_ih[n] + r * hnb),  hnb = h W_hh[n] + b_hh[n]
//   h' = (1 - z) n + z h
// x (T, B, I), W_ih (D, 3, I, H), W_hh (D, 3, H, H), biases (D, 3, 1, H),
// h0 (B, H), out (D, T, B, H); all f32, f32 accumulation, no TF32.
//
// Forward. The TPU grid (D, batch tiles, T) ran in order and carried h from
// one time step to the next in VMEM scratch. A GPU grid carries nothing
// between blocks, so T is a loop inside the block:
//   * one block per (batch tile of 8 rows, direction); at B=256 that is 64
//     blocks;
//   * one thread per hidden unit j (blockDim = H rounded up to a warp); each
//     step it accumulates the six projections of column j for the tile's 8
//     rows, from x_t and h_{t-1} held in shared memory;
//   * W_ih (4.2 MB at I=992) and W_hh (1.47 MB) of a direction do not fit
//     shared memory; they are read through L2 (50 MB), coalesced along j;
//   * the backward direction walks t from T-1 down to 0 and writes its
//     outputs at their natural time index;
//   * for training it also writes r, z, n and hnb (D, T, B, H), the
//     residuals `_fwd_call(..., with_residuals=True)` writes.
// What bounds it: each block re-reads its direction's weights from L2 at
// every step (5.7 MB per step at I=992), and the FMAs of the tile (22.5
// MFLOP per step) run on one SM; 64 blocks leave half the 132 SMs idle.
//
// Backward. The TPU did everything in one reversed traversal and summed the
// weight gradients over its sequential batch tiles in VMEM; GPU tiles run in
// parallel, so the work is split into what is serial and what is not:
// (the kernels of (a), (b) and (c) are in gru_common.cuh: K3's backward
// runs (a), the dW_hh product of (b) and (c) too)
//   (a) gru_bwd_recurrence_kernel: one block per (batch tile, direction),
//       walking t in the reverse of the forward's order with the dh carry in
//       registers. Per step it forms the gate gradients, carries dh through
//       W_hh^T (read transposed, coalesced along j) and writes the two
//       gate-gradient streams (T, B, D, 3, H): d_in = (dr, dz, dn) that the
//       input projection sees and d_hid = (dr, dz, dn * r) that the hidden
//       projection sees. 12.8 GFLOP of the ~98 at I=992 are here.
//   (b) gru_gemm_kernel, a tiled f32 GEMM (64 x 64 tiles, 4 x 4 per thread)
//       for dx = d_in . W_ih^T (K = D * 3 * H, so the sum over directions
//       is inside), dW_ih = x^T d_in and dW_hh = hprev^T d_hid (K = T * B).
//       Each block owns one output tile and one slice of K, summed in
//       order. Where the output tiles are too few to fill the card (the
//       discriminator's dW: 6 tiles over K = 7168) K is cut into slices
//       whose partial tiles go to a workspace, and gru_splitk_reduce_kernel
//       adds them in slice order;
//   (c) gru_colsum_kernel: the bias gradients, column sums of the streams
//       over T * B in a fixed order.
// No atomics, and every sum has one order for a given shape: the
// gradients are bitwise the same from run to run.
// What bounds the backward: the scalar f32 FMAs of the GEMMs (85 of the
// ~98 GFLOP at I=992), and in (a), as in the forward, the re-read of a
// direction's W_hh (1.47 MB) from L2 at every step by 64 blocks.

#include "gru_common.cuh"

namespace {

__global__ void gru_fused_fwd_kernel(const float* __restrict__ x,
                                     const float* __restrict__ wih,
                                     const float* __restrict__ bih,
                                     const float* __restrict__ whh,
                                     const float* __restrict__ bhh,
                                     const float* __restrict__ h0,
                                     float* __restrict__ out,
                                     float* __restrict__ r_out,
                                     float* __restrict__ z_out,
                                     float* __restrict__ n_out,
                                     float* __restrict__ hnb_out,
                                     int T, int B, int I, int H) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;          // (BT, I): x at the current step
  float* hs = xs + BT * I;   // (BT, H): h_{t-1}

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const int nthreads = blockDim.x;
  const bool active = j < H;
  const bool residuals = r_out != nullptr;

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

    float hn[BT], rs[BT], zs[BT], ns[BT], hbs[BT];
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
        rs[r] = rg;
        zs[r] = zg;
        ns[r] = ng;
        hbs[r] = gn[r];
      }
    }
    __syncthreads();  // every thread has read x_t and h_{t-1}
    if (active) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        hs[r * H + j] = hn[r];
        if (b0 + r < B) {
          const size_t o = ((size_t(d) * T + tt) * B + b0 + r) * H + j;
          out[o] = hn[r];
          if (residuals) {
            r_out[o] = rs[r];
            z_out[o] = zs[r];
            n_out[o] = ns[r];
            hnb_out[o] = hbs[r];
          }
        }
      }
    }
  }
}

// the three GEMMs of the backward: (M, N, K, nz) of dx, dW_ih and dW_hh
struct BwdGemms {
  int m[3], n[3], k[3], nz[3];
  BwdGemms(int T, int B, int I, int H, int D) {
    const int TB = T * B, G = 3 * D * H;
    const int v[3][4] = {{TB, I, G, 1}, {I, H, TB, 3 * D}, {H, H, TB, 3 * D}};
    for (int i = 0; i < 3; ++i) {
      m[i] = v[i][0]; n[i] = v[i][1]; k[i] = v[i][2]; nz[i] = v[i][3];
    }
  }
  size_t workspace() const {
    size_t w = 0;
    for (int i = 0; i < 3; ++i) w = std::max(w, gemm_workspace(m[i], n[i], k[i], nz[i]));
    return w;
  }
};

}  // namespace

extern "C" int hop_gru_fused_fwd(const void* x, const void* wih, const void* bih,
                                 const void* whh, const void* bhh, const void* h0,
                                 void* out, void* r_out, void* z_out, void* n_out,
                                 void* hnb_out, int T, int B, int I, int H, int D,
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
      static_cast<float*>(out), static_cast<float*>(r_out),
      static_cast<float*>(z_out), static_cast<float*>(n_out),
      static_cast<float*>(hnb_out), T, B, I, H);
  return int(cudaGetLastError());
}

// floats of workspace hop_gru_fused_bwd needs for these shapes (0: none)
extern "C" long long hop_gru_fused_bwd_workspace(int T, int B, int I, int H, int D) {
  return (long long)BwdGemms(T, B, I, H, D).workspace();
}

// g, r, z, n, hnb, hprev (D, T, B, H); x (T, B, I); wih_t (D, 3, H, I) and
// whh_t (D, 3, H, H) are W_ih and W_hh with their last two axes swapped.
// d_in, d_hid (T, B, D, 3, H) and `work` (hop_gru_fused_bwd_workspace floats,
// may be NULL when that is 0) are scratch. Writes dx (T, B, I) summed over
// the directions, dwih (D, 3, I, H), dbih (D, 3, 1, H), dwhh (D, 3, H, H),
// dbhh (D, 3, 1, H) and dh0 (D, B, H), one slice per direction.
extern "C" int hop_gru_fused_bwd(const void* g, const void* x, const void* r,
                                 const void* z, const void* n, const void* hnb,
                                 const void* hprev, const void* wih_t,
                                 const void* whh_t, void* d_in, void* d_hid,
                                 void* work, void* dx, void* dwih, void* dbih,
                                 void* dwhh, void* dbhh, void* dh0, int T, int B,
                                 int I, int H, int D, void* stream) {
  if (T < 1 || B < 1 || I < 1 || H < 1 || H > 1024 || D < 1 || D > 2)
    return int(cudaErrorInvalidValue);
  if (BwdGemms(T, B, I, H, D).workspace() > 0 && work == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* din = static_cast<float*>(d_in);
  auto* dhid = static_cast<float*>(d_hid);
  auto* part = static_cast<float*>(work);
  cudaError_t err = launch_bwd_recurrence<float>(
      static_cast<const float*>(g), static_cast<const float*>(r),
      static_cast<const float*>(z), static_cast<const float*>(n),
      static_cast<const float*>(hnb), static_cast<const float*>(hprev),
      static_cast<const float*>(whh_t), din, dhid, static_cast<float*>(dh0), T, B, H,
      D, st);
  if (err != cudaSuccess) return int(err);

  const long long TB = (long long)T * B, G = 3LL * D * H;  // G: stream row width
  const ZOff none{0, 0};
  // dx (TB, I) = d_in (TB, D*3*H) . wih_t viewed (D*3*H, I)
  err = gemm(din, static_cast<const float*>(wih_t), static_cast<float*>(dx), part,
             int(TB), I, int(G), G, 1, I, 1, I, 1, 1, none, none, none, st);
  if (err != cudaSuccess) return int(err);
  // dwih[d, gate] (I, H) = x^T (I, TB) . d_in[:, d, gate] (TB, H)
  err = gemm(static_cast<const float*>(x), din, static_cast<float*>(dwih), part, I,
             H, int(TB), 1, I, G, 1, H, 3 * D, 3, none, ZOff{3LL * H, H},
             ZOff{3LL * I * H, (long long)I * H}, st);
  if (err != cudaSuccess) return int(err);
  err = dwhh_gemm(static_cast<const float*>(hprev), dhid, static_cast<float*>(dwhh),
                  part, T, B, H, D, st);
  if (err != cudaSuccess) return int(err);
  // bias gradients: column sums of the streams, (D*3*H) columns each
  err = colsum(din, static_cast<float*>(dbih), int(TB), int(G), st);
  if (err != cudaSuccess) return int(err);
  return int(colsum(dhid, static_cast<float*>(dbhh), int(TB), int(G), st));
}
