// Fused bidirectional GRU layer (kernel K2) for Hopper, sm_90a: the forward,
// optionally with the residuals of the backward, and the backward.
//
// Replaces the TPU kernels `_make_fwd_kernel` (:113-144, `_fwd_call`
// :147-195) and `_make_bwd_kernel` (:202-310, `_bwd_call` :313-373) of
// hop_tpu/ops/pallas_gru_fused.py. One layer, both directions, from the
// layer's input and weights, gates ordered r, z, n as in torch.nn.GRU:
//   r = sigmoid(x W_ih[r] + b_ih[r] + h W_hh[r] + b_hh[r])
//   z = sigmoid(x W_ih[z] + b_ih[z] + h W_hh[z] + b_hh[z])
//   n = tanh(x W_ih[n] + b_ih[n] + r * hnb),  hnb = h W_hh[n] + b_hh[n]
//   h' = (1 - z) n + z h
// x (T, B, I), W_ih (D, 3, I, H), W_hh (D, 3, H, H), biases (D, 3, 1, H),
// h0 (B, H), out (D, T, B, H); all f32 at f32 accuracy.
//
// Forward. The TPU computed x_t . W_ih inside its sequential grid over T to
// keep the projected gates out of HBM. That product does not depend on h, and
// on this card the projected gates are 73 MB (T=34, B=256, H=350: 0.04 ms of
// device-memory traffic) while a projection inside the serial loop re-reads
// W_ih from L2 at every step on the few SMs the recurrence can fill. So one
// entry, hop_gru_fused_fwd, runs two phases on the caller's stream:
//   A. gru_proj_kernel: xp (T, B, D, 3, H) = x . W_ih + b_ih, one product of
//      M = T * B rows, on the tensor cores at f32 accuracy: each f32 operand
//      is split into TF32 hi + lo and a product is three mma.sync.m16n8k8
//      (a_lo b_hi + a_hi b_lo + a_hi b_hi) into f32 accumulators. 128 x 128
//      block tiles that never straddle a (direction, gate) boundary (H = 350
//      is ragged: masked), 32-deep operand tiles copied as they lie by
//      cp.async three stages deep, the bias added in the epilogue;
//   B. the recurrence from xp by its strides (gru_common.cuh, the kernels K3
//      and K6 run), T looped inside the kernel with W_hh resident on the chip
//      and the per-step product on the tensor cores (3xTF32); the backward
//      direction walks t from T-1 down and writes at the natural time index;
//      with residuals it also writes r, z, n and hnb (D, T, B, H). At a
//      narrow layer (H <= 64: the discriminator's) gru_fwd_block_kernel: one
//      block of 8 warps owns 8 batch rows and holds W_hh in registers, each
//      warp a 16-unit tile and one half of K; else (the head's H = 350,
//      1.47 MB) gru_fwd_cluster_kernel: a cluster of 8 blocks owns 40 batch
//      rows (8 for a batch of at most 8), each block holds an eighth of W_hh
//      in shared memory for the whole loop and computes its 44 hidden units'
//      products, the slices of h exchanged through distributed shared memory.
// What bounds it: operations, 49.1 GFLOP of f32 work at (T=34, B=256, I=992,
// H=350, D=2); phase A runs three times its 36.3 GFLOP as TF32 MMAs (0.73
// ms on an H100, 30% of the TF32 peak: mma.sync with the operand split on the
// same warps), phase B three times its 12.8 GFLOP on 112 of the 132 SMs
// (0.74-0.77 ms on an H100 at 700 W: mma.sync starts one TF32 m16n8k8 per
// ~14 clocks a tensor core, and a step's 48 x 9 MMAs a warp are 70% of it;
// at the discriminator's H = 64 the one-block kernel, 0.027 ms). The tensor cores' f32
// accumulation truncates: with one accumulator chain over K, xp agreed with
// an f64 product to 7e-5 where a cuBLAS f32 product agrees to 1.4e-5 (|xp|
// up to 8, I = 992), and the layer's outputs with the plain version's to
// 3e-5 at I = 992 but 2.7e-4 at I = 4320 (|xp| up to 20): so above
// I = 1024 each 8-deep step of K is a chain of its own, added to the tile's
// sum in f32 (2.6e-5 at I = 4320).
//
// Backward. The TPU did everything in one reversed traversal and summed the
// weight gradients over its sequential batch tiles in VMEM; GPU tiles run in
// parallel, so the work is split into what is serial and what is not:
// (the kernels of (a), (b) and (c) are in gru_common.cuh: K3's backward
// runs (a), the dW_hh product of (b) and (c) too)
//   (a) gru_bwd_resident_kernel: walks t in the reverse of the forward's
//       order with the dh carry in registers. Per step it forms the gate
//       gradients, carries dh through W_hh (its rows as they lie: no
//       transposed copy) on the tensor cores (3xTF32) and writes the two
//       gate-gradient streams (T, B, D, 3, H): d_in = (dr, dz, dn) that the
//       input projection sees and d_hid = (dr, dz, dn * r) that the hidden
//       projection sees. W_hh stays in shared memory for the whole loop: in
//       one block of 8 rows at a narrow layer (H <= 64), across a cluster of
//       8 blocks and 40 rows at the head's H = 350, the blocks exchanging
//       their slices of d_hid through distributed shared memory. 12.8 GFLOP
//       of the ~98 at I=992 are here.
//   (b) gru_mma_gemm_kernel, one f32 GEMM on the tensor cores at f32
//       accuracy (phase A's 3xTF32 mma.sync tile, operands staged as they lie
//       by cp.async three stages deep), for the three products:
//       dx = d_in . W_ih^T, its K running over the D * 3 (direction, gate)
//       segments of H so that the sum over directions is inside and W_ih
//       (D, 3, I, H) is read in place (k contiguous: the col-major B
//       fragment's own order); dW_ih = x^T d_in and dW_hh = hprev^T d_hid
//       over K = T * B, 3 * D matrices a launch, x and hprev staged [k][m] and
//       read transposed from shared memory. 128 x 128 tiles at the head's
//       shapes, 64 x 64 at the discriminator's. Each block owns one output
//       tile and one slice of K, summed in order; a slice is at most 2304
//       deep (the tensor cores truncate where an f32 add rounds: a longer
//       chain would cost the 1e-4 the gradients hold), and where the output
//       tiles do not fill the card (dW_ih: 144 tiles, dW_hh: 54, the
//       discriminator's: 6-12) there are more slices; the partial tiles go
//       to a workspace and gru_splitk_reduce_kernel adds them in slice order;
//   (c) gru_colsum_kernel: the bias gradients, column sums of the streams
//       over T * B in a fixed order.
// No atomics, and every sum has one order for a given shape: the
// gradients are bitwise the same from run to run.
// What bounds the backward: operations, 98.1 GFLOP of f32 work at I=992.
// The three products (85 GFLOP, run three times over as TF32 MMAs) take
// 0.93 + 1.18 ms of the layer's 4.4 on an H100: 26-30% of the TF32 peak, as
// phase A, less where the blocks come out in a ragged last wave (dx: 544
// blocks on 264 slots). The rest is (a), 1.09 ms: as in the forward's phase
// B, mma.sync's rate for three TF32 MMAs a product, and the operand split and
// the slice exchange that do not overlap it.

#include "gru_common.cuh"

namespace {

// --- phase A: xp = x . W_ih + b_ih on the tensor cores at f32 accuracy ---

constexpr int PM = 128, PN = 128, PK = 32;   // block tile
constexpr int P_THREADS = 256;               // 8 warps, 2 (M) x 4 (N), 64 x 32 each
constexpr int P_STAGES = 3;
constexpr int P_LDA = PK + 4;    // A rows [m][k]: fragment reads hit 32 banks
constexpr int P_LDB = PN + 8;    // B rows [k][n]: likewise
constexpr int P_STAGE_FLOATS = PM * P_LDA + PK * P_LDB;
constexpr size_t P_SMEM_BYTES = size_t(P_STAGES) * P_STAGE_FLOATS * sizeof(float);
// the deepest K summed in one accumulator chain (below)
constexpr int P_MAX_CHAIN = 1024;

// d = a . b + 0: mma_tf32 into a fresh accumulator
__device__ __forceinline__ void mma_tf32_from_zero(float (&d)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// xp[m, z, n] = sum_i x[m, i] wih[z, i, n] + bih[z, n] for m < M = T * B,
// z < G = D * 3 (direction, gate), n < H: block (x, y, z) owns the 128 x 128
// tile (y, x) of matrix z, so no tile straddles a (direction, gate) boundary;
// xp is (M, G, H). Operands are copied as they lie (x rows along i, W_ih rows
// along n) by cp.async in pieces of VA and VB floats (what their alignment
// allows), three stages deep; tiles past M, I or H are zero-filled. Each f32
// operand is split into TF32 hi + lo in registers and a product is three
// MMAs, a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first, summed in
// f32: f32 accuracy from the tensor cores ("3xTF32"). The tensor cores
// truncate where an f32 add rounds, and the loss grows with the length of one
// accumulator chain: one chain over all of K lost 3e-5 on the layer's outputs
// at I = 992 but 2.7e-4 at I = 4320 (the LLaMA backbone's head). With FOLD
// (I > P_MAX_CHAIN) the three MMAs of each 8-deep step of K start from zero
// and their sum is added to the tile's accumulators in ordinary f32 adds:
// 2.6e-5 at I = 4320 (8e-6 from an f64 product), for ~19% more time in the
// kernel (64 more f32 adds a thread a step); without, one chain, as at TED's
// widths.
template <int VA, int VB, bool FOLD>
__global__ void __launch_bounds__(P_THREADS, 2)
gru_proj_kernel(const float* __restrict__ x, const float* __restrict__ wih,
                const float* __restrict__ bih, float* __restrict__ xp, int M, int I,
                int H, int G) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * PM, n0 = blockIdx.x * PN;
  const float* wz = wih + size_t(z) * I * H;
  const int n_k = (I + PK - 1) / PK;

  auto load = [&](int kt, int stage) {
    float* As = smem + stage * P_STAGE_FLOATS;
    float* Bs = As + PM * P_LDA;
    const int k0 = kt * PK;
#pragma unroll
    for (int i = 0; i < PM * PK / VA / P_THREADS; ++i) {
      const int c = tid + i * P_THREADS;
      const int row = c / (PK / VA), kc = c % (PK / VA) * VA;
      const bool ok = m0 + row < M && k0 + kc < I;
      cp_async_floats<VA>(As + row * P_LDA + kc,
                          ok ? x + size_t(m0 + row) * I + k0 + kc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < PK * PN / VB / P_THREADS; ++i) {
      const int c = tid + i * P_THREADS;
      const int kr = c / (PN / VB), nc = c % (PN / VB) * VB;
      const bool ok = k0 + kr < I && n0 + nc < H;
      cp_async_floats<VB>(Bs + kr * P_LDB + nc,
                          ok ? wz + size_t(k0 + kr) * H + n0 + nc : wz, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

#pragma unroll
  for (int s = 0; s < P_STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<P_STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is free for every warp
    if (kt + P_STAGES - 1 < n_k) load(kt + P_STAGES - 1, (kt + P_STAGES - 1) % P_STAGES);
    cp_async_commit();
    const float* As = smem + (kt % P_STAGES) * P_STAGE_FLOATS;
    const float* Bs = As + PM * P_LDA;
    const int k_steps = (min(PK, I - kt * PK) + 7) / 8;
    for (int k8 = 0; k8 < k_steps; ++k8) {
      const int kb = k8 * 8;
      // a[0], a[2]: row g, columns t4 and t4 + 4; a[1], a[3]: row g + 8
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float* ar = As + (wm + mi * 16 + g) * P_LDA + kb + t4;
        split_tf32(ar[0], a_hi[mi][0], a_lo[mi][0]);
        split_tf32(ar[8 * P_LDA], a_hi[mi][1], a_lo[mi][1]);
        split_tf32(ar[4], a_hi[mi][2], a_lo[mi][2]);
        split_tf32(ar[8 * P_LDA + 4], a_hi[mi][3], a_lo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // b0: (k = t4, n = g); b1: (k = t4 + 4, n = g)
        const float* br = Bs + (kb + t4) * P_LDB + wn + ni * 8 + g;
        uint32_t b_hi[2], b_lo[2];
        split_tf32(br[0], b_hi[0], b_lo[0]);
        split_tf32(br[4 * P_LDB], b_hi[1], b_lo[1]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          if (FOLD) {
            // this 8-deep step of K in a chain of its own, added to the
            // tile's sum in f32 (rounded to nearest)
            float part[4];
            mma_tf32_from_zero(part, a_lo[mi], b_hi[0], b_hi[1]);
            mma_tf32(part, a_hi[mi], b_lo[0], b_lo[1]);
            mma_tf32(part, a_hi[mi], b_hi[0], b_hi[1]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[c];
          } else {
            mma_tf32(acc[mi][ni], a_lo[mi], b_hi[0], b_hi[1]);
            mma_tf32(acc[mi][ni], a_hi[mi], b_lo[0], b_lo[1]);
            mma_tf32(acc[mi][ni], a_hi[mi], b_hi[0], b_hi[1]);
          }
        }
      }
    }
  }

  // acc[..][0], [1]: row g, columns 2 t4, + 1; [2], [3]: row g + 8
  const size_t ldc = size_t(G) * H;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t4;
    const float b0 = col < H ? bih[size_t(z) * H + col] : 0.f;
    const float b1 = col + 1 < H ? bih[size_t(z) * H + col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + 8 * half;
        if (row >= M) continue;
        float* dst = xp + size_t(row) * ldc + size_t(z) * H + col;
        if (col < H) dst[0] = acc[mi][ni][2 * half] + b0;
        if (col + 1 < H) dst[1] = acc[mi][ni][2 * half + 1] + b1;
      }
    }
  }
}

// pieces of 4, 2 or 1 floats: what the pointer and every row start allow
int piece_floats(const void* p, size_t row_floats, size_t matrix_floats) {
  const size_t a = reinterpret_cast<size_t>(p) | row_floats * 4 | matrix_floats * 4;
  return a % 16 == 0 ? 4 : a % 8 == 0 ? 2 : 1;
}

template <int VA, bool FOLD>
cudaError_t launch_proj_vb(int vb, dim3 grid, cudaStream_t st, const float* x,
                           const float* wih, const float* bih, float* xp, int M, int I,
                           int H, int G) {
#define HOP_PROJ(VB)                                                                  \
  {                                                                                   \
    cudaError_t err = cudaFuncSetAttribute(gru_proj_kernel<VA, VB, FOLD>,             \
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                           int(P_SMEM_BYTES));                        \
    if (err != cudaSuccess) return err;                                               \
    gru_proj_kernel<VA, VB, FOLD><<<grid, P_THREADS, P_SMEM_BYTES, st>>>(x, wih, bih, \
                                                                         xp, M, I, H, G); \
    return cudaGetLastError();                                                        \
  }
  if (vb == 4) HOP_PROJ(4)
  if (vb == 2) HOP_PROJ(2)
  HOP_PROJ(1)
#undef HOP_PROJ
}

cudaError_t launch_proj(const float* x, const float* wih, const float* bih, float* xp,
                        int M, int I, int H, int G, cudaStream_t st) {
  const dim3 grid((H + PN - 1) / PN, (M + PM - 1) / PM, G);
  const int va = piece_floats(x, I, 0);
  const int vb = piece_floats(wih, H, size_t(I) * H);
  if (I > P_MAX_CHAIN) {
    if (va == 4) return launch_proj_vb<4, true>(vb, grid, st, x, wih, bih, xp, M, I, H, G);
    if (va == 2) return launch_proj_vb<2, true>(vb, grid, st, x, wih, bih, xp, M, I, H, G);
    return launch_proj_vb<1, true>(vb, grid, st, x, wih, bih, xp, M, I, H, G);
  }
  if (va == 4) return launch_proj_vb<4, false>(vb, grid, st, x, wih, bih, xp, M, I, H, G);
  if (va == 2) return launch_proj_vb<2, false>(vb, grid, st, x, wih, bih, xp, M, I, H, G);
  return launch_proj_vb<1, false>(vb, grid, st, x, wih, bih, xp, M, I, H, G);
}

// dx (T*B, I) = sum over (direction, gate) z of d_in[:, z] (T*B, H) . W_ih[z]^T
// (H, I): one product whose K runs over the 3 D segments, W_ih read in place
Gemm dx_gemm(const float* d_in, const float* wih, float* dx, int T, int B, int I, int H,
             int D) {
  const long long G = 3LL * D * H;
  const ZOff none{0, 0};
  return Gemm{d_in, wih, dx, T * B, I, H, 3 * D, true, G, H, I, H,
              (long long)I * H, 1, 1, none, none, none};
}

// floats of workspace the backward's three products need
size_t bwd_workspace(int T, int B, int I, int H, int D) {
  return std::max({gemm_workspace(T * B, I, H, 3 * D, 1), dw_gemm_workspace(I, T, B, H, D),
                   dw_gemm_workspace(H, T, B, H, D)});
}

}  // namespace

// xp (T, B, D, 3, H) f32 is scratch the wrapper allocates; r_out .. hnb_out
// NULL: the lean forward
extern "C" int hop_gru_fused_fwd(const void* x, const void* wih, const void* bih,
                                 const void* whh, const void* bhh, const void* h0,
                                 void* xp, void* out, void* r_out, void* z_out,
                                 void* n_out, void* hnb_out, int T, int B, int I,
                                 int H, int D, void* stream) {
  if (T < 1 || B < 1 || I < 1 || H < 1 || H > RC_MAX_H || D < 1 || D > 2 ||
      (long long)T * B > 65535LL * PM || xp == nullptr)
    return int(cudaErrorInvalidValue);
  const bool res = r_out != nullptr;
  if (res && (z_out == nullptr || n_out == nullptr || hnb_out == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gates = static_cast<const float*>(xp);
  cudaError_t err = launch_proj(static_cast<const float*>(x),
                                static_cast<const float*>(wih),
                                static_cast<const float*>(bih), static_cast<float*>(xp),
                                T * B, I, H, 3 * D, st);
  if (err != cudaSuccess) return int(err);
  // element (d, t, b, gate, j) of xp: three gate pointers, strides of d, t, b;
  // out and the residuals (D, T, B, H)
  const long long sxd = 3LL * H, sxb = sxd * D, sxt = sxb * B;
  const long long sot = (long long)B * H, sod = sot * T;
#define HOP_REC(RES)                                                                  \
  launch_fwd_recurrence<RES, float>(gates, gates + H, gates + 2 * H, sxd, sxt, sxb,  \
                                    whh, bhh, h0, out, r_out, z_out, n_out, hnb_out, \
                                    sod, sot, H, T, B, H, D, 0, st)
  err = res ? HOP_REC(true) : HOP_REC(false);
#undef HOP_REC
  return int(err);
}

// floats of workspace hop_gru_fused_bwd needs for these shapes (0: none)
extern "C" long long hop_gru_fused_bwd_workspace(int T, int B, int I, int H, int D) {
  return (long long)bwd_workspace(T, B, I, H, D);
}

// g, r, z, n, hnb, hprev (D, T, B, H); x (T, B, I); wih (D, 3, I, H) as the
// forward takes it; whh (D, 3, H, H) likewise.
// d_in, d_hid (T, B, D, 3, H) and `work` (hop_gru_fused_bwd_workspace floats,
// may be NULL when that is 0) are scratch. Writes dx (T, B, I) summed over
// the directions, dwih (D, 3, I, H), dbih (D, 3, 1, H), dwhh (D, 3, H, H),
// dbhh (D, 3, 1, H) and dh0 (D, B, H), one slice per direction.
extern "C" int hop_gru_fused_bwd(const void* g, const void* x, const void* r,
                                 const void* z, const void* n, const void* hnb,
                                 const void* hprev, const void* wih,
                                 const void* whh, void* d_in, void* d_hid,
                                 void* work, void* dx, void* dwih, void* dbih,
                                 void* dwhh, void* dbhh, void* dh0, int T, int B,
                                 int I, int H, int D, void* stream) {
  if (T < 1 || B < 1 || I < 1 || H < 1 || H > RC_MAX_H || D < 1 || D > 2)
    return int(cudaErrorInvalidValue);
  if (bwd_workspace(T, B, I, H, D) > 0 && work == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* din = static_cast<float*>(d_in);
  auto* dhid = static_cast<float*>(d_hid);
  auto* part = static_cast<float*>(work);
  cudaError_t err = launch_bwd_recurrence<float>(
      static_cast<const float*>(g), static_cast<const float*>(r),
      static_cast<const float*>(z), static_cast<const float*>(n),
      static_cast<const float*>(hnb), static_cast<const float*>(hprev),
      static_cast<const float*>(whh), din, dhid, static_cast<float*>(dh0), T, B, H,
      D, st);
  if (err != cudaSuccess) return int(err);

  err = gemm(dx_gemm(din, static_cast<const float*>(wih), static_cast<float*>(dx), T, B,
                     I, H, D),
             part, st);
  if (err != cudaSuccess) return int(err);
  err = gemm(dw_gemm(static_cast<const float*>(x), 0, I, din, static_cast<float*>(dwih),
                     T, B, H, D),
             part, st);
  if (err != cudaSuccess) return int(err);
  err = gemm(dw_gemm(static_cast<const float*>(hprev), (long long)T * B * H, H, dhid,
                     static_cast<float*>(dwhh), T, B, H, D),
             part, st);
  if (err != cudaSuccess) return int(err);
  const int TB = T * B, G = 3 * D * H;  // the streams' rows and row width
  // bias gradients: column sums of the streams, (D*3*H) columns each
  err = colsum(din, static_cast<float*>(dbih), TB, G, st);
  if (err != cudaSuccess) return int(err);
  return int(colsum(dhid, static_cast<float*>(dbhh), TB, G, st));
}
