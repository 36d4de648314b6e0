// Time-grid GRU recurrence (kernel K3) for Hopper, sm_90a: the forward with
// the residuals of the backward, the lean forward (h only), and the backward.
//
// Replaces the TPU kernels `_fwd_kernel` (:46-71), `_fwd_kernel_lean`
// (:73-97; both called by `_fwd_call` :129-161) and `_bwd_kernel` (:168-223,
// `_bwd_call` :225-263) of hop_tpu/ops/pallas_gru_stack.py. The big input
// projection x . W_ih (+ b_ih) is a plain matrix product outside; the kernels
// take its three per-gate streams and run what is serial in T:
//   hr, hz, hnb = h W[g] + b[g]
//   r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hnb)
//   h' = (1 - z) n + z h
// xr, xz, xn (D, T, B, H) f32 or bf16, given by the strides of D, T and B
// with unit stride on H (so they may be views of one (T, B, D, 3, H) product);
// w (D, 3, H, H) with gate g mapping h -> h @ w[d, g]; b (D, 3, 1, H);
// h0 (B, H) shared by the directions; outputs (D, T, B, H) f32 in natural
// time order (direction 1 walks t from T-1 down: an index, not a copy). hnb
// is saved WITH b[n], as the reference multiplies r into (W_hn h + b_hn).
// All arithmetic and the h path are f32.
//
// Forward. The TPU put T on a sequential grid with the whole batch per step
// and carried h in VMEM scratch. Here batch rows are independent and T is a
// loop inside the kernel, W resident on the chip for all of it
// (launch_fwd_recurrence in gru_common.cuh chooses by H alone, for this
// entry as for K2's second phase and K6), the per-step product on the tensor
// cores (3xTF32 mma.sync): at a narrow layer (H <= 64: the discriminator's)
// one block of 8 warps owns 8 rows and holds W in registers, a warp a 16-unit
// tile and a half of K; else (the head's H = 350, 1.47 MB) a cluster of 8
// blocks owns 40 rows (24 at one direction, 8 for a batch of at most 8), each
// block keeps an eighth of W in shared memory and computes its 44 hidden
// units, and the blocks exchange their slices of h through distributed
// shared memory. Any B: the ragged last tile is masked.
// What bounds it: operations. 12.8 GFLOP of f32 work at the head's shape
// (D=2, T=34, B=256, H=350) against 100 MB (lean) or 198 MB (residuals) of
// traffic; as three TF32 MMAs a product on 112 SMs at mma.sync's rate it
// takes 0.72-0.77 ms on an H100 at 700 W, 4x that bound. At the
// discriminator's (T=28, H=64) the one-block kernel takes 0.027 ms, a chain
// of 28 steps of ~1700 clocks against a bound of 0.005 ms.
//
// Backward. The TPU ran one reversed pass that also added dW and db into a
// resident block over its sequential grid. Here: gru_bwd_resident_kernel
// (serial in T; W resident in one block for H <= 64, else across a cluster,
// the carry's product on the tensor cores) writes dxr, dxz, dxn into one
// (T, B, D, 3, H) buffer in the streams' dtype and the f32 hidden-side
// stream (dr, dz, dn * r); then K2's backward GEMM (gru_common.cuh: 3xTF32
// on the tensor cores, ordered split-K) gives dW[g] = hprev^T . d_hid[g] over
// T * B rows, and ordered column sums give db. No atomics: the gradients
// repeat bit for bit. dh0 comes out per direction and is summed outside, as
// on the TPU.
// What bounds it: operations, 25.6 GFLOP of f32 work, half serial in the
// recurrence (1.09 of the 1.6 ms at the head on an H100), half in the dW
// product (0.34 ms).

#include "gru_common.cuh"

namespace {

bool bad_shape(int T, int B, int H, int D) {
  return T < 1 || B < 1 || H < 1 || H > RC_MAX_H || D < 1 || D > 2;
}

}  // namespace

// xr, xz, xn: element (d, t, b, j) at d * sxd + t * sxt + b * sxb + j, bf16
// when `bf16` is non-zero, else f32. r, z, n, hnb NULL: the lean forward.
extern "C" int hop_gru_stack_fwd(const void* xr, const void* xz, const void* xn,
                                 long long sxd, long long sxt, long long sxb,
                                 int bf16, const void* w, const void* b,
                                 const void* h0, void* out, void* r, void* z,
                                 void* n, void* hnb, int T, int B, int H, int D,
                                 void* stream) {
  if (bad_shape(T, B, H, D)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = r != nullptr;
  if (res && (z == nullptr || n == nullptr || hnb == nullptr))
    return int(cudaErrorInvalidValue);
  // outputs (D, T, B, H)
  const long long sot = (long long)B * H, sod = sot * T;
#define HOP_FWD(RES, TX)                                                                \
  launch_fwd_recurrence<RES, TX>(xr, xz, xn, sxd, sxt, sxb, w, b, h0, out, r, z, n, hnb, \
                                 sod, sot, H, T, B, H, D, 0, st)
  cudaError_t err;
  if (bf16)
    err = res ? HOP_FWD(true, __nv_bfloat16) : HOP_FWD(false, __nv_bfloat16);
  else
    err = res ? HOP_FWD(true, float) : HOP_FWD(false, float);
#undef HOP_FWD
  return int(err);
}

// Which recurrence kernel runs at this H, forward and backward alike, as
// launch_fwd_recurrence and launch_bwd_recurrence choose it: 0 one block, 1
// a cluster, or minus the CUDA error where no kernel takes H.
extern "C" int hop_gru_recurrence_variant(int H) {
  if (H < 1 || H > RC_MAX_H) return -int(cudaErrorInvalidValue);
  return H <= RC_NARROW_H ? 0 : 1;
}

// Batch rows of a forward cluster at (B, D) (fwd_row_tiles), or minus the
// CUDA error for a shape no forward takes.
extern "C" int hop_gru_fwd_cluster_rows(int B, int D) {
  if (B < 1 || D < 1 || D > 2) return -int(cudaErrorInvalidValue);
  return 8 * fwd_row_tiles(B, D);
}

// Clusters of the wide layer's recurrence (forward: backward == 0, its
// instance of RC_NT row tiles) that the card holds at once at this H, or
// minus the CUDA error; 0 where the layer is narrow enough to run without
// clusters.
extern "C" int hop_gru_active_clusters(int H, int backward) {
  if (H < 1 || H > RC_MAX_H) return -int(cudaErrorInvalidValue);
  if (H <= RC_NARROW_H) return 0;
  int count = 0;
  const cudaError_t err =
      backward ? active_clusters(gru_bwd_resident_kernel<RC_CL, RC_MT, RC_NT, float>,
                                 rc_threads(RC_NT), bwd_resident_smem<RC_CL, RC_NT>(H),
                                 RC_CL, &count)
               : active_clusters(gru_fwd_cluster_kernel<true, float, RC_NT>,
                                 rc_threads(RC_NT), fwd_cluster_smem(H, RC_NT),
                                 RC_CL, &count);
  return err == cudaSuccess ? count : -int(err);
}

// floats of workspace hop_gru_stack_bwd needs for these shapes (0: none)
extern "C" long long hop_gru_stack_bwd_workspace(int T, int B, int H, int D) {
  return (long long)dw_gemm_workspace(H, T, B, H, D);
}

// g, r, z, n, hnb, hprev (D, T, B, H) f32 contiguous; w (D, 3, H, H) as the
// forward takes it. Writes dx (T, B, D, 3, H), bf16 when `bf16`
// is non-zero, else f32: dx[:, :, d, 0] is dxr, 1 dxz, 2 dxn; dw (D, 3, H, H),
// db (D, 3, 1, H) and dh0 (D, B, H), one slice per direction. d_hid
// (T, B, D, 3, H) f32 and `work` (hop_gru_stack_bwd_workspace floats, may be
// NULL when that is 0) are scratch.
extern "C" int hop_gru_stack_bwd(const void* g, const void* r, const void* z,
                                 const void* n, const void* hnb, const void* hprev,
                                 const void* w, void* dx, int bf16, void* d_hid,
                                 void* work, void* dw, void* db, void* dh0, int T,
                                 int B, int H, int D, void* stream) {
  if (bad_shape(T, B, H, D)) return int(cudaErrorInvalidValue);
  if (dw_gemm_workspace(H, T, B, H, D) > 0 && work == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* rf = static_cast<const float*>(r);
  const auto* zf = static_cast<const float*>(z);
  const auto* nf = static_cast<const float*>(n);
  const auto* hf = static_cast<const float*>(hnb);
  const auto* pf = static_cast<const float*>(hprev);
  const auto* wf = static_cast<const float*>(w);
  auto* dhid = static_cast<float*>(d_hid);
  auto* dh0f = static_cast<float*>(dh0);
  cudaError_t err =
      bf16 ? launch_bwd_recurrence<__nv_bfloat16>(gf, rf, zf, nf, hf, pf, wf,
                                                  static_cast<__nv_bfloat16*>(dx),
                                                  dhid, dh0f, T, B, H, D, st)
           : launch_bwd_recurrence<float>(gf, rf, zf, nf, hf, pf, wf,
                                          static_cast<float*>(dx), dhid, dh0f, T, B,
                                          H, D, st);
  if (err != cudaSuccess) return int(err);
  err = gemm(dw_gemm(pf, (long long)T * B * H, H, dhid, static_cast<float*>(dw), T, B, H,
                     D),
             static_cast<float*>(work), st);
  if (err != cudaSuccess) return int(err);
  return int(colsum(dhid, static_cast<float*>(db), T * B, 3 * D * H, st));
}
