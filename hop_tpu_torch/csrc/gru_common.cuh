// What the GRU kernels for Hopper share: K2 (gru_fused.cu, projection and
// recurrence behind one entry), K3 (gru_stack.cu, the recurrence alone from gate
// streams) and K6 (gru_seq.cu, one batch-major direction, forward only).
//
//   * gru_fwd_block_kernel / gru_fwd_cluster_kernel: the forward recurrence
//     from precomputed gate streams, T looped inside the kernel with W_hh
//     resident in shared memory for the whole loop and the per-step product
//     h W_hh on the tensor cores (3xTF32 mma.sync), one body in two
//     instances: one block for a narrow layer (H <= 64: the discriminator's),
//     a cluster of 8 blocks for a wide one (the head's H = 350); K2's second
//     phase, K3's forwards and K6 all launch them (launch_fwd_recurrence);
//   * gru_bwd_resident_kernel: the serial part of a GRU layer's backward, the
//     dh carry walked in the reverse of the forward's order (K2 and K3
//     backward), W_hh resident in one block (narrow) or a cluster (wide), the
//     per-step product on the tensor cores;
//   * gru_mma_gemm_kernel / gemm(): an f32 GEMM on the tensor cores at f32
//     accuracy (each operand split into TF32 hi + lo, three mma.sync.m16n8k8
//     a product), operands staged as they lie by cp.async, ordered split-K
//     (K2's dx, dW_ih, dW_hh; K3's dW_hh); its pieces (cp.async, split_tf32,
//     mma_tf32) also serve K2's forward projection;
//   * gru_colsum_kernel: ordered column sums (the bias gradients).
// Which recurrence kernel runs is a function of H alone, one rule for the
// forward and the backward: one block up to RC_NARROW_H, a cluster up to
// RC_MAX_H. None uses atomics; every sum has one order for a given shape, so
// results repeat bit for bit. Everything is in an unnamed namespace: each .cu
// that includes this header gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int SM_COUNT = 132;       // an H100's

// The forward's gate functions from one fast exponential: __expf is
// ex2.approx of x log2(e) (2 ulp, plus the product's rounding: 1e-6 relative
// at |x| = 20), __fdividef one reciprocal (0 for a denominator past 2^126,
// where the sigmoid is 0 to f32 anyway); tanh(x) = 2 sigmoid(2x) - 1 is off
// by about 2e-7 absolute near 0. expf, a division and tanhf took 1400 of a
// 3700-clock step of the one-block forward on an H100, these ~800; the layer
// stays within 1e-6 of the plain version's f32 torch.sigmoid and torch.tanh.
__device__ __forceinline__ float sigmoid_g(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_g(float x) { return 2.f * sigmoid_g(2.f * x) - 1.f; }

// gate streams are f32 or bf16; all arithmetic is f32
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void st_stream(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_stream(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// --- the recurrences: W_hh resident in one block or across a cluster ---
//
// A direction's W_hh at the head's H = 350 is 1.47 MB: it fits no block, and
// a kernel that re-reads it from L2 at every step in every block moves 3.2 GB
// of L2 traffic a launch. Here a thread-block cluster of RC_CL = 8 blocks
// owns (direction, RC_ROWS = 40 batch rows) and splits the hidden units: block
// c holds units [c SL, c SL + SL), SL = ceil(H / 8) (44 at H = 350), and with
// them its eighth of W_hh (185 KB) in shared memory, read from device memory
// once, before the loop over T. Each step a block computes its units' part
// of the product on the tensor cores at f32 accuracy (3xTF32, as the GEMM
// below: W on the A side, so M is the units and N the batch rows; warp
// (mi, ni) of 3 x 5 owns 16 units x 8 rows), does the elementwise part on the
// accumulators where they lie, and leaves what its peers need of it (the
// forward: its slice of h; the backward: its slice of d_hid) in its own
// shared memory. The K axis runs over the peers: a block pulls one peer's
// slice at a time through distributed shared memory (16-byte
// ld.shared::cluster into registers while the previous slice is multiplied,
// then into a staging buffer: 4-byte remote loads from the MMA loop itself
// ran at about one request a clock, 34 us a step), block c starting at its
// own slice and walking the ranks upwards, so that no two blocks pull from
// the same peer at once. W never leaves the SM and nothing is re-read from
// L2. Cluster barriers order the exchange.
//
// 40 rows a cluster because an H100 holds 15 such clusters at once
// (cudaOccupancyMaxActiveClusters; a block with this much shared memory has
// an SM to itself, and one GPC is short of two clusters): B = 256 in two
// directions is 14 clusters, one wave, where 32 rows would be 16 and two
// waves. A row of the staged operands is padded to 4 (mod 8) floats so that a
// fragment read (lane (g, t4) reads word g * ld + t4) hits 32 banks. SL is no
// multiple of 8, so a slice's last 8-deep k step runs past it: there the B
// operand reads the zero padding of its row and the A operand reads on into
// finite neighbours (the next peer's columns, or the row's zero padding).
constexpr int RC_CL = 8;                      // blocks of a cluster
constexpr int RC_MT = 3, RC_NT = 5;           // warps: 16-unit tiles x 8-row tiles
constexpr int RC_ROWS = 8 * RC_NT;            // batch rows of a cluster
// A batch of at most 8 rows (one window of a clip) runs the same kernels with
// one row tile: every MMA of the four others would multiply masked rows, and
// a step is bound by the MMAs (mma.sync starts one TF32 m16n8k8 per ~14 clocks
// a tensor core: 15 warps' 48 x 9 of them are 17 of the forward's 22 us a
// step at 40 rows). Its 3 MMA warps are joined by 5 that only stage W_hh and
// move slices.
constexpr int RC_SMALL_B = 8;
__host__ __device__ constexpr int rc_threads(int nt) {
  return 32 * RC_MT * nt < 256 ? 256 : 32 * RC_MT * nt;
}
constexpr int RC_MAX_SL = 44;                 // most hidden units of a block
constexpr int RC_MAX_H = RC_CL * RC_MAX_SL;

__host__ __device__ constexpr int pad4mod8(int x) { return (x + 3) / 8 * 8 + 4; }
// the row of a slice buffer K deep: whole 8-deep k steps, so that the product
// needs no mask (what lies past K is zero, written once), then 4 (mod 8)
__host__ __device__ constexpr int slice_ld(int K) { return (K + 7) / 8 * 8 + 4; }

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Float4 `idx` (idx = thread + i * THREADS < n_vec) of the buffer at this
// block's shared address `a`, read from block `rank` of the cluster
template <int NV, int THREADS>
__device__ __forceinline__ void pull_slice(float4 (&regs)[NV], uint32_t a, int rank,
                                           int n_vec) {
  uint32_t base;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(base) : "r"(a), "r"(rank));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (idx < n_vec)
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(regs[i].x), "=f"(regs[i].y), "=f"(regs[i].z), "=f"(regs[i].w)
                   : "r"(base + 16 * idx));
  }
}
template <int NV, int THREADS>
__device__ __forceinline__ void put_slice(float* stage, const float4 (&regs)[NV],
                                          int n_vec) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (idx < n_vec) reinterpret_cast<float4*>(stage)[idx] = regs[i];
  }
}

// One slice's part of a warp's product: acc[gt] (16 units x 8 rows) +=
// A_gt (16 x K) . S^T (K x 8) as 3xTF32, the three terms (lo hi, hi lo,
// hi hi) in accumulators of their own, so that a k step adds one dependent
// MMA to each chain, not three (a dependent mma.sync costs ~27 clocks, and at
// a narrow layer or one sample the chain is the step); `mma_sum` adds them,
// the small terms first. `a` points at the slice's first
// column of the A rows (lane's t4 added), rows ra and rb (the fragment's two,
// as offsets), row group gt at gt * a_gate; `s` at the lane's row of the
// staged slice (t4 added); K deep in whole k steps: the staged rows are zero
// past K.
template <int GT>
__device__ __forceinline__ void mma_slice(float (&acc)[GT][3][4], const float* a, int ra,
                                          int rb, int a_gate, const float* s, int K) {
  const int n_ks = (K + 7) / 8;
  float av[GT][4], bv[2];
  auto load = [&](int ks) {
#pragma unroll
    for (int gt = 0; gt < GT; ++gt) {
      const float* q = a + gt * a_gate + ks * 8;
      av[gt][0] = q[ra];
      av[gt][1] = q[rb];
      av[gt][2] = q[ra + 4];
      av[gt][3] = q[rb + 4];
    }
    bv[0] = s[ks * 8];
    bv[1] = s[ks * 8 + 4];
  };
  load(0);
#pragma unroll 2
  for (int ks = 0; ks < n_ks; ++ks) {
    uint32_t a_hi[GT][4], a_lo[GT][4], b_hi[2], b_lo[2];
#pragma unroll
    for (int gt = 0; gt < GT; ++gt)
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(av[gt][q], a_hi[gt][q], a_lo[gt][q]);
    split_tf32(bv[0], b_hi[0], b_lo[0]);
    split_tf32(bv[1], b_hi[1], b_lo[1]);
    if (ks + 1 < n_ks) load(ks + 1);
#pragma unroll
    for (int gt = 0; gt < GT; ++gt) {
      mma_tf32(acc[gt][0], a_lo[gt], b_hi[0], b_hi[1]);
      mma_tf32(acc[gt][1], a_hi[gt], b_lo[0], b_lo[1]);
      mma_tf32(acc[gt][2], a_hi[gt], b_hi[0], b_hi[1]);
    }
  }
}
__device__ __forceinline__ float mma_sum(const float (&acc)[3][4], int q) {
  return (acc[0][q] + acc[1][q]) + acc[2][q];
}

template <typename... Params, typename... Args>
cudaError_t launch_in_clusters(void (*kernel)(Params...), dim3 grid, int threads,
                               size_t smem, int cluster, cudaStream_t st,
                               Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// clusters of `cluster` blocks of `kernel` that the card holds at once
template <typename... Params>
cudaError_t active_clusters(void (*kernel)(Params...), int threads, size_t smem,
                            int cluster, int* count) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * SM_COUNT);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

constexpr int RC_NARROW_H = 64;   // the widest layer of the one-block instances

// The forward recurrence:
//   hr, hz, hnb = h W[g] + bias[g];  r = sigmoid(xr + hr);  z = sigmoid(xz + hz)
//   n = tanh(xn + r * hnb);  h' = (1 - z) n + z h
// Element (d, t, b, j) of a gate stream lies at d * sxd + t * sxt + b * sxb + j,
// of an output at d * sod + t * sot + b * sob + j; w (D, 3, H, H) laid out
// [gate][k][j], bias (D, 3, H), h0 (B, H). Direction d walks t from T-1 down
// to 0 where d ^ flip is odd (K2 and K3: flip 0, direction 1 reversed; K6: one
// direction, flip = reverse); outputs land at their natural time index. With
// RES the gates r, z, n and hnb (with its bias) are written too. Two kernels,
// by H alone (launch_fwd_recurrence): the cluster for a wide layer, one block
// for a narrow one.
#define HOP_FWD_PARAMS                                                                \
  const TX *__restrict__ xr, const TX *__restrict__ xz, const TX *__restrict__ xn,  \
      long long sxd, long long sxt, long long sxb, const float *__restrict__ w,      \
      const float *__restrict__ bias, const float *__restrict__ h0,                 \
      float *__restrict__ out, float *__restrict__ r_out, float *__restrict__ z_out, \
      float *__restrict__ n_out, float *__restrict__ hnb_out, long long sod,        \
      long long sot, long long sob, int T, int B, int H, int flip
#define HOP_FWD_ARGS                                                                   \
  xr, xz, xn, sxd, sxt, sxb, w, bias, h0, out, r_out, z_out, n_out, hnb_out, sod, sot, \
      sob, T, B, H, flip

// The wide layer (RC_NARROW_H < H <= RC_MAX_H), one cluster of RC_CL blocks
// per (direction, 8 NT rows). Warp (mi, ni) of 3 x NT owns units mi x rows ni
// of all three gates, so the gate math runs on the accumulators where they
// lie, and carries its h in registers. Shared memory: As (3, SL, LDA),
// As[gate][u][k] = w[gate][k][c SL + u] (the A operand, staged transposed once
// by 4-byte cp.async that all stay in flight); hb (2, ROWS, LDH), the block's
// slice of h, double-buffered so that one cluster barrier a step is enough
// (step s reads every peer's hb[s & 1] and writes its own hb[(s + 1) & 1]);
// stage (ROWS, LDH), the peer's slice being multiplied. Three accumulator
// chains over K (8 x 6 k steps at H = 350), one per 3xTF32 term; the bias is
// added after.
inline size_t fwd_cluster_smem(int H, int nt) {
  const int SL = (H + RC_CL - 1) / RC_CL;
  const int LDA = pad4mod8(RC_CL * SL + (8 - SL % 8) % 8);
  return (size_t(3) * SL * LDA + size_t(3) * 8 * nt * slice_ld(SL)) * sizeof(float);
}

template <bool RES, typename TX, int NT>
__global__ void __launch_bounds__(rc_threads(NT), 1)
gru_fwd_cluster_kernel(HOP_FWD_PARAMS) {
  constexpr int ROWS = 8 * NT, THREADS = rc_threads(NT);
  constexpr int NV = (ROWS * slice_ld(RC_MAX_SL) / 4 + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) float smem[];
  const int SL = (H + RC_CL - 1) / RC_CL;
  const int LDH = slice_ld(SL);
  const int LDA = pad4mod8(RC_CL * SL + (8 - SL % 8) % 8);
  float* As = smem;
  float* hb = As + 3 * SL * LDA;
  float* stage = hb + 2 * ROWS * LDH;
  const int n_vec = ROWS * LDH / 4;
  const int c = int(cluster_rank());
  const int d = blockIdx.y, b0 = (blockIdx.x / RC_CL) * ROWS;
  const bool back = ((d ^ flip) & 1) != 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int mi = warp / NT, ni = warp % NT;
  const bool worker = warp < RC_MT * NT;   // the other warps only move data
  const float* wd = w + size_t(d) * 3 * H * H;

  for (int idx = tid; idx < 3 * SL * LDA + 3 * ROWS * LDH; idx += THREADS)
    smem[idx] = 0.f;
  __syncthreads();
  // W's rows (gate, k) by warps, a row's units by lanes: coalesced reads
  for (int row = warp; row < 3 * H; row += THREADS / 32) {
    const int gate = row / H, k = row - gate * H;
    for (int u = lane; u < SL && c * SL + u < H; u += 32)
      cp_async_floats<1>(As + (gate * SL + u) * LDA + k,
                         wd + size_t(row) * H + c * SL + u, true);
  }
  cp_async_commit();

  // the thread's four elements: accumulator q is unit ue[q / 2], row re[q % 2]
  const int ue[2] = {mi * 16 + gq, mi * 16 + gq + 8};
  const int re[2] = {ni * 8 + 2 * t4, ni * 8 + 2 * t4 + 1};
  bool ok[4];
  float hreg[4], bh[3][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int u = ue[q / 2], j = c * SL + u, b = b0 + re[q % 2];
    ok[q] = worker && u < SL && j < H && b < B;
    hreg[q] = ok[q] ? h0[size_t(b) * H + j] : 0.f;
    if (worker && u < SL) hb[re[q % 2] * LDH + u] = hreg[q];
  }
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int j = c * SL + ue[v];
    const bool has = ue[v] < SL && j < H;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
      bh[gate][v] = has ? bias[(size_t(d) * 3 + gate) * H + j] : 0.f;
  }
  // the A fragment's two rows (clamped: rows past SL are computed and dropped)
  const int ra = min(ue[0], SL - 1) * LDA, rb = min(ue[1], SL - 1) * LDA;
  const float* srow = stage + (ni * 8 + gq) * LDH + t4;
  const long long xo = d * sxd, oo = d * sod;
  cp_async_wait<0>();
  cluster_arrive();
  cluster_wait();   // every block's W and h0 slice are in place

  for (int s = 0; s < T; ++s) {
    const int t = back ? T - 1 - s : s;
    const uint32_t hcur = smem_addr(hb + (s & 1) * ROWS * LDH);
    float* hnext = hb + ((s + 1) & 1) * ROWS * LDH;
    float4 regs[NV];
    pull_slice<NV, THREADS>(regs, hcur, c, n_vec);
    // the step's stream values do not depend on h: load them first
    float vr[4], vz[4], vn[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long o =
          xo + t * sxt + (long long)(b0 + re[q % 2]) * sxb + c * SL + ue[q / 2];
      vr[q] = ok[q] ? to_f32(xr[o]) : 0.f;
      vz[q] = ok[q] ? to_f32(xz[o]) : 0.f;
      vn[q] = ok[q] ? to_f32(xn[o]) : 0.f;
    }
    float acc[3][3][4];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[gate][term][q] = 0.f;
    for (int i = 0; i < RC_CL; ++i) {
      const int p = (c + i) % RC_CL;
      __syncthreads();   // every warp is done with the staged slice
      put_slice<NV, THREADS>(stage, regs, n_vec);
      __syncthreads();
      if (i + 1 < RC_CL) pull_slice<NV, THREADS>(regs, hcur, (p + 1) % RC_CL, n_vec);
      if (worker) mma_slice<3>(acc, As + p * SL + t4, ra, rb, SL * LDA, srow, SL);
    }

    float rg[4], zg[4], ng[4], hnb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = q / 2;
      hnb[q] = mma_sum(acc[2], q) + bh[2][v];
      rg[q] = sigmoid_g(vr[q] + mma_sum(acc[0], q) + bh[0][v]);
      zg[q] = sigmoid_g(vz[q] + mma_sum(acc[1], q) + bh[1][v]);
      ng[q] = tanh_g(vn[q] + rg[q] * hnb[q]);
      hreg[q] = ok[q] ? (1.f - zg[q]) * ng[q] + zg[q] * hreg[q] : 0.f;
      if (worker && ue[v] < SL) hnext[re[q % 2] * LDH + ue[v]] = hreg[q];
    }
    cluster_arrive();   // the block's slice of h_t is written, h_{t-1} is read
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (ok[q]) {
        const long long o =
            oo + t * sot + (long long)(b0 + re[q % 2]) * sob + c * SL + ue[q / 2];
        out[o] = hreg[q];
        if (RES) {
          r_out[o] = rg[q];
          z_out[o] = zg[q];
          n_out[o] = ng[q];
          hnb_out[o] = hnb[q];
        }
      }
    }
    cluster_wait();
  }
}

// The narrow layer (H <= RC_NARROW_H: the discriminator's 64), one block per
// (direction, 8 rows), no cluster. The whole W_hh of a direction is 48 KB at
// H = 64, and its A fragments are spread over the registers of 8 warps: warp
// (mi, kh) of 4 x 2 holds units mi (16) x half kh of K (32), 48 floats a
// thread, read from device memory once, straight into registers (staging it
// through shared memory by 4-byte copies took 17k clocks a block; holding all
// of K in 4 warps spilled at 255 registers). A step: each warp multiplies
// its half on the tensor cores (3xTF32: 4 dependent k steps of 9 MMAs, two
// warps a scheduler), the pair (mi, 0), (mi, 1) swaps half of its sums
// through shared memory under a barrier of its own, and each warp of the pair
// finishes one of the two units of its accumulator rows (the sum over K is
// half 0 + half 1 in that order): the gate math on 2 elements a thread, h
// carried in registers, h_t into the double-buffered tile hb that is the next
// step's B operand, one block barrier a step. The streams do not depend on h:
// each step loads the next step's while it multiplies. On an H100 at 700 W:
// 0.027 ms at (D=2, T=28, B=256), a step ~1700 clocks (by clock64(): the
// product 620, the swap 200, the gate math and h 300-400, the stores
// 170-280, the next streams' loads 230), the prologue ~4000; bound 0.005.
constexpr int NB_MT = RC_NARROW_H / 16;      // unit tiles
constexpr int NB_WARPS = 2 * NB_MT;          // x two halves of K
constexpr int NB_KS = RC_NARROW_H / 16;      // 8-deep k steps of a half
constexpr int NB_LDH = slice_ld(RC_NARROW_H);

__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

template <bool RES, typename TX>
__global__ void __launch_bounds__(32 * NB_WARPS, 1)
gru_fwd_block_kernel(HOP_FWD_PARAMS) {
  __shared__ __align__(16) float hb[2][8][NB_LDH];
  __shared__ float xb[NB_MT][2][3][2][32];   // [mi][to half][gate][row][lane]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int mi = warp % NB_MT, kh = warp / NB_MT;
  const int d = blockIdx.y, b0 = blockIdx.x * 8;
  const bool back = ((d ^ flip) & 1) != 0;
  const float* wd = w + size_t(d) * 3 * H * H;

  for (int idx = tid; idx < 2 * 8 * NB_LDH; idx += 32 * NB_WARPS)
    (&hb[0][0][0])[idx] = 0.f;
  // the A fragments: element q of k step ks is unit ue[q % 2], k = (kh NB_KS +
  // ks) 8 + t4 + 4 (q / 2); zero past H
  const int ue[2] = {mi * 16 + gq, mi * 16 + gq + 8};
  float wa[3][NB_KS][4];
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int ks = 0; ks < NB_KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int u = ue[q % 2], k = (kh * NB_KS + ks) * 8 + t4 + 4 * (q / 2);
        wa[gate][ks][q] = u < H && k < H ? wd[(size_t(gate) * H + k) * H + u] : 0.f;
      }
  // the thread's two elements: unit uo of rows re[i] (kh is no index into a
  // register array: a runtime index puts the array in local memory)
  const int uo = mi * 16 + gq + 8 * kh;
  const int re[2] = {2 * t4, 2 * t4 + 1};
  bool ok[2];
  float hreg[2], bh[3];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ok[i] = uo < H && b0 + re[i] < B;
    hreg[i] = ok[i] ? h0[size_t(b0 + re[i]) * H + uo] : 0.f;
  }
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
    bh[gate] = uo < H ? bias[(size_t(d) * 3 + gate) * H + uo] : 0.f;
  const long long xo = d * sxd, oo = d * sod;
  TX pr[2], pz[2], pn[2];   // the stream values of the step ahead, as they lie
  auto load_streams = [&](int tt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (ok[i]) {
        const long long o = xo + tt * sxt + (long long)(b0 + re[i]) * sxb + uo;
        pr[i] = xr[o];
        pz[i] = xz[o];
        pn[i] = xn[o];
      }
    }
  };
  load_streams(back ? T - 1 : 0);
  __syncthreads();   // the tiles' zeros are in place
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (uo < H) hb[0][re[i]][uo] = hreg[i];
  __syncthreads();   // h0 is in place

  for (int s = 0; s < T; ++s) {
    const int t = back ? T - 1 - s : s;
    float vr[2], vz[2], vn[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      vr[i] = ok[i] ? to_f32(pr[i]) : 0.f;
      vz[i] = ok[i] ? to_f32(pz[i]) : 0.f;
      vn[i] = ok[i] ? to_f32(pn[i]) : 0.f;
    }
    if (s + 1 < T) load_streams(back ? T - 2 - s : s + 1);

    // the B fragment: row gq of h, k = t4 (+ 4) of each k step of the half
    const float* sb = &hb[s & 1][gq][kh * NB_KS * 8 + t4];
    float acc[3][3][4];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[gate][term][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NB_KS; ++ks) {
      uint32_t b_hi[2], b_lo[2];
      split_tf32(sb[ks * 8], b_hi[0], b_lo[0]);
      split_tf32(sb[ks * 8 + 4], b_hi[1], b_lo[1]);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(wa[gate][ks][q], a_hi[q], a_lo[q]);
        mma_tf32(acc[gate][0], a_lo, b_hi[0], b_hi[1]);
        mma_tf32(acc[gate][1], a_hi, b_lo[0], b_lo[1]);
        mma_tf32(acc[gate][2], a_hi, b_hi[0], b_hi[1]);
      }
    }
    // accumulator q is unit ue[q / 2], row re[q % 2]: this warp keeps unit
    // ue[kh] and gives its partner its sums of the other
    float keep[3][2];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float lo = mma_sum(acc[gate], i), hi = mma_sum(acc[gate], 2 + i);
        keep[gate][i] = kh == 0 ? lo : hi;
        xb[mi][1 - kh][gate][i][lane] = kh == 0 ? hi : lo;
      }
    pair_barrier(1 + mi);
    float hs[3][2];   // the sums over K of the thread's elements: half 0 + half 1
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float other = xb[mi][kh][gate][i][lane];
        hs[gate][i] = kh == 0 ? keep[gate][i] + other : other + keep[gate][i];
      }

    float rg[2], zg[2], ng[2], hnb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hnb[i] = hs[2][i] + bh[2];
      rg[i] = sigmoid_g(vr[i] + hs[0][i] + bh[0]);
      zg[i] = sigmoid_g(vz[i] + hs[1][i] + bh[1]);
      ng[i] = tanh_g(vn[i] + rg[i] * hnb[i]);
      hreg[i] = ok[i] ? (1.f - zg[i]) * ng[i] + zg[i] * hreg[i] : 0.f;
      if (uo < H) hb[(s + 1) & 1][re[i]][uo] = hreg[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (ok[i]) {
        const long long o = oo + t * sot + (long long)(b0 + re[i]) * sob + uo;
        out[o] = hreg[i];
        if (RES) {
          r_out[o] = rg[i];
          z_out[o] = zg[i];
          n_out[o] = ng[i];
          hnb_out[o] = hnb[i];
        }
      }
    }
    __syncthreads();   // h_t is written and h_{t-1} and xb read by every warp
  }
}

// Row tiles of 8 a forward cluster owns, from (B, D) alone: one for a batch
// of at most RC_SMALL_B rows; FWD_ONE_DIR_NT at one direction (K6, and K3 at
// D = 1), where five would leave B = 256 in 7 clusters on 56 of 132 SMs
// (0.75 against 0.53 ms for K6 at B = 256, H = 350 on an H100); else RC_NT
// (both directions of B = 256 in 14 clusters, one wave).
constexpr int FWD_ONE_DIR_NT = 3;
__host__ __device__ constexpr int fwd_row_tiles(int B, int D) {
  return B <= RC_SMALL_B ? 1 : D == 1 ? FWD_ONE_DIR_NT : RC_NT;
}

template <bool RES, typename TX, int NT>
cudaError_t launch_fwd_cluster(HOP_FWD_PARAMS, int D, cudaStream_t st) {
  const int tiles = (B + 8 * NT - 1) / (8 * NT);
  return launch_in_clusters(gru_fwd_cluster_kernel<RES, TX, NT>, dim3(RC_CL * tiles, D),
                            rc_threads(NT), fwd_cluster_smem(H, NT), RC_CL, st,
                            HOP_FWD_ARGS);
}

// Which forward runs is a function of H alone, as for the backward: H <=
// RC_NARROW_H one block of 8 rows, else (H <= RC_MAX_H) the cluster, its rows
// by fwd_row_tiles. The pointers' element types are TX (streams) and float.
template <bool RES, typename TX>
cudaError_t launch_fwd_recurrence(const void* xr_, const void* xz_, const void* xn_,
                                  long long sxd, long long sxt, long long sxb,
                                  const void* w_, const void* b_, const void* h0_,
                                  void* out_, void* r_, void* z_, void* n_, void* hnb_,
                                  long long sod, long long sot, long long sob, int T,
                                  int B, int H, int D, int flip, cudaStream_t st) {
  const auto* xr = static_cast<const TX*>(xr_);
  const auto* xz = static_cast<const TX*>(xz_);
  const auto* xn = static_cast<const TX*>(xn_);
  const auto* w = static_cast<const float*>(w_);
  const auto* bias = static_cast<const float*>(b_);
  const auto* h0 = static_cast<const float*>(h0_);
  auto* out = static_cast<float*>(out_);
  auto* r_out = static_cast<float*>(r_);
  auto* z_out = static_cast<float*>(z_);
  auto* n_out = static_cast<float*>(n_);
  auto* hnb_out = static_cast<float*>(hnb_);
  if (H <= RC_NARROW_H) {
    gru_fwd_block_kernel<RES, TX><<<dim3((B + 7) / 8, D), 32 * NB_WARPS, 0, st>>>(
        HOP_FWD_ARGS);
    return cudaGetLastError();
  }
  if (H > RC_MAX_H) return cudaErrorInvalidValue;
  switch (fwd_row_tiles(B, D)) {
    case 1: return launch_fwd_cluster<RES, TX, 1>(HOP_FWD_ARGS, D, st);
    case FWD_ONE_DIR_NT:
      return launch_fwd_cluster<RES, TX, FWD_ONE_DIR_NT>(HOP_FWD_ARGS, D, st);
    default: return launch_fwd_cluster<RES, TX, RC_NT>(HOP_FWD_ARGS, D, st);
  }
}
#undef HOP_FWD_PARAMS
#undef HOP_FWD_ARGS

// The serial part of a GRU layer's backward: walks t in the reverse of the
// forward's order with the dh carry in registers; per step forms the gate
// gradients
//   dn = g (1 - z)(1 - n^2), dz = g (hprev - n) z (1 - z), dr = dn hnb r (1 - r)
// (g = the upstream gradient plus the carry), carries
//   dh[b, j] = g z + sum over gate, k of d_hid[b, gate, k] whh[gate][j][k]
// and writes the two gate-gradient streams (T, B, D, 3, H):
//   d_in  = (dr, dz, dn)      what the input projection sees, in TX
//   d_hid = (dr, dz, dn * r)  what the hidden projection sees, f32
// g, r, z, n, hnb, hprev are (D, T, B, H) f32; whh (D, 3, H, H) as the forward
// takes it; dh0 (D, B, H) gets the carry after the last step.
//
// A cluster of CL blocks owns (direction, 8 NT rows); block c holds units
// [c SL, c SL + SL), SL = ceil(H / CL) <= 16 MT; warp (mi, ni) of MT x NT owns
// 16 units x 8 rows and does their elementwise part on its accumulators. Two
// instances: the head's <8, 3, 5> on the scaffolding above, and <1, 4, 1> for
// a narrow layer (H <= 64, the discriminator's), whose whole W fits one
// block: no cluster, 8 rows and 4 warps a block. Shared memory: Ws (SL, LDA),
// the A operand, Ws[u][p K3 + gate SL + kl] = whh[gate][c SL + u][p SL + kl]
// (K3 = 3 SL; W_hh's rows as they lie: no transposed copy); buf (R, LDB),
// this step's d_hid of the block's units, [row][gate SL + u], which the peers
// pull; stage (R, LDB), the slice being multiplied (CL > 1). Three accumulator
// chains over K (one per 3xTF32 term), the peers from the block's own rank
// upwards. Barriers of a step (CL > 1): "buf is written"
// (arrive + wait) before the pulls, "buf is read" (arrive after the last
// pull has landed, wait before the next step writes buf).
template <int CL, int NT>
inline size_t bwd_resident_smem(int H) {
  const int SL = (H + CL - 1) / CL, K3 = 3 * SL, R = 8 * NT;
  const int LDA = pad4mod8(CL * K3 + (8 - K3 % 8) % 8);
  return (size_t(SL) * LDA + size_t(CL > 1 ? 2 : 1) * R * slice_ld(K3)) * sizeof(float);
}

template <int CL, int MT, int NT, typename TX>
__global__ void __launch_bounds__(CL > 1 ? rc_threads(NT) : 32 * MT * NT, 1)
gru_bwd_resident_kernel(const float* __restrict__ g, const float* __restrict__ r_in,
                        const float* __restrict__ z_in, const float* __restrict__ n_in,
                        const float* __restrict__ hnb_in,
                        const float* __restrict__ hprev, const float* __restrict__ whh,
                        TX* __restrict__ d_in, float* __restrict__ d_hid,
                        float* __restrict__ dh0, int T, int B, int H, int D) {
  constexpr int R = 8 * NT, THREADS = CL > 1 ? rc_threads(NT) : 32 * MT * NT;
  constexpr int NV = (R * slice_ld(3 * RC_MAX_SL) / 4 + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) float smem[];
  const int SL = (H + CL - 1) / CL, K3 = 3 * SL;
  const int LDB = slice_ld(K3);
  const int LDA = pad4mod8(CL * K3 + (8 - K3 % 8) % 8);
  float* Ws = smem;
  float* buf = Ws + SL * LDA;
  float* stage = CL > 1 ? buf + R * LDB : buf;
  const int n_vec = R * LDB / 4;
  const int c = CL == 1 ? 0 : int(cluster_rank());
  const int d = blockIdx.y, b0 = (blockIdx.x / CL) * R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int mi = warp / NT, ni = warp % NT;
  const bool worker = warp < MT * NT;   // the other warps only move data

  const float* Wd = whh + size_t(d) * 3 * H * H;
  for (int idx = tid; idx < SL * LDA; idx += THREADS) {
    const int u = idx / LDA, col = idx - u * LDA;
    float v = 0.f;
    if (col < CL * K3) {
      const int p = col / K3, rem = col - p * K3, gate = rem / SL, kl = rem - gate * SL;
      const int j = c * SL + u, k = p * SL + kl;
      if (j < H && k < H) v = Wd[(size_t(gate) * H + j) * H + k];
    }
    Ws[idx] = v;
  }
  for (int idx = tid; idx < (CL > 1 ? 2 : 1) * R * LDB; idx += THREADS) buf[idx] = 0.f;
  __syncthreads();

  // the thread's four elements: accumulator q is unit ue[q / 2], row re[q % 2]
  const int ue[2] = {mi * 16 + gq, mi * 16 + gq + 8};
  const int re[2] = {ni * 8 + 2 * t4, ni * 8 + 2 * t4 + 1};
  bool ok[4];
  float dh[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ok[q] = worker && ue[q / 2] < SL && c * SL + ue[q / 2] < H && b0 + re[q % 2] < B;
    dh[q] = 0.f;
  }
  float pg[4], pr[4], pz[4], pn[4], ph[4], pp[4];
  auto load_step = [&](int tt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (ok[q]) {
        const size_t idx =
            ((size_t(d) * T + tt) * B + b0 + re[q % 2]) * H + c * SL + ue[q / 2];
        pg[q] = g[idx];
        pr[q] = r_in[idx];
        pz[q] = z_in[idx];
        pn[q] = n_in[idx];
        ph[q] = hnb_in[idx];
        pp[q] = hprev[idx];
      }
    }
  };
  // the forward walked d=0 up and d=1 down in t; the backward reverses it
  load_step(d == 0 ? T - 1 : 0);
  const int ra = min(ue[0], SL - 1) * LDA, rb = min(ue[1], SL - 1) * LDA;
  const float* srow = stage + (ni * 8 + gq) * LDB + t4;
  const uint32_t buf_a = smem_addr(buf);

  for (int s = 0; s < T; ++s) {
    const int tt = d == 0 ? T - 1 - s : s;
    if (CL > 1 && s > 0) cluster_wait();   // every peer has pulled the last step's buf
    float keep[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float dr = 0.f, dz = 0.f, dnh = 0.f;
      keep[q] = 0.f;
      if (ok[q]) {
        const float gt = pg[q] + dh[q];
        const float rv = pr[q], zv = pz[q], nv = pn[q];
        const float dn = gt * (1.f - zv) * (1.f - nv * nv);
        dz = gt * (pp[q] - nv) * zv * (1.f - zv);
        dr = dn * ph[q] * rv * (1.f - rv);
        dnh = dn * rv;
        keep[q] = gt * zv;
        const size_t o =
            ((size_t(tt) * B + b0 + re[q % 2]) * D + d) * 3 * H + c * SL + ue[q / 2];
        st_stream(d_in + o, dr);
        st_stream(d_in + o + H, dz);
        st_stream(d_in + o + 2 * H, dn);
        d_hid[o] = dr;
        d_hid[o + H] = dz;
        d_hid[o + 2 * H] = dnh;
      }
      if (worker && ue[q / 2] < SL) {
        float* bp = buf + re[q % 2] * LDB + ue[q / 2];
        bp[0] = dr;
        bp[SL] = dz;
        bp[2 * SL] = dnh;
      }
    }
    if constexpr (CL > 1) {
      cluster_arrive();
      cluster_wait();   // every block's buf (and, at s = 0, Ws) is written
    } else {
      __syncthreads();
    }
    if (s + 1 < T) load_step(d == 0 ? T - 2 - s : s + 1);

    float acc[1][3][4];
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[0][term][q] = 0.f;
    if constexpr (CL > 1) {
      float4 regs[NV];
      pull_slice<NV, THREADS>(regs, buf_a, c, n_vec);
      for (int i = 0; i < CL; ++i) {
        const int p = (c + i) % CL;
        __syncthreads();   // every warp is done with the staged slice
        put_slice<NV, THREADS>(stage, regs, n_vec);
        __syncthreads();
        if (i + 1 < CL)
          pull_slice<NV, THREADS>(regs, buf_a, (p + 1) % CL, n_vec);
        else
          cluster_arrive();   // this block has pulled every peer's buf
        if (worker) mma_slice<1>(acc, Ws + p * K3 + t4, ra, rb, 0, srow, K3);
      }
    } else {
      mma_slice<1>(acc, Ws + t4, ra, rb, 0, srow, K3);
      __syncthreads();   // every warp has read buf
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) dh[q] = keep[q] + mma_sum(acc[0], q);
  }
  if (CL > 1) cluster_wait();   // no block leaves while a peer may pull its buf
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (ok[q])
      dh0[(size_t(d) * B + b0 + re[q % 2]) * H + c * SL + ue[q / 2]] = dh[q];
}

// Which backward runs is a function of the shape alone: H <= RC_NARROW_H the
// one-block instance, else the cluster with one row tile (B <= RC_SMALL_B)
// or five.
template <typename TX>
cudaError_t launch_bwd_recurrence(const float* g, const float* r, const float* z,
                                  const float* n, const float* hnb,
                                  const float* hprev, const float* whh, TX* d_in,
                                  float* d_hid, float* dh0, int T, int B, int H,
                                  int D, cudaStream_t st) {
  if (H <= RC_NARROW_H) {
    auto* kernel = gru_bwd_resident_kernel<1, 4, 1, TX>;
    const size_t smem = bwd_resident_smem<1, 1>(H);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3((B + 7) / 8, D), 128, smem, st>>>(g, r, z, n, hnb, hprev, whh, d_in,
                                                    d_hid, dh0, T, B, H, D);
    return cudaGetLastError();
  }
  if (H > RC_MAX_H) return cudaErrorInvalidValue;
  if (B <= RC_SMALL_B)
    return launch_in_clusters(gru_bwd_resident_kernel<RC_CL, RC_MT, 1, TX>,
                              dim3(RC_CL, D), rc_threads(1),
                              bwd_resident_smem<RC_CL, 1>(H), RC_CL, st, g, r, z, n, hnb,
                              hprev, whh, d_in, d_hid, dh0, T, B, H, D);
  const int tiles = (B + RC_ROWS - 1) / RC_ROWS;
  return launch_in_clusters(gru_bwd_resident_kernel<RC_CL, RC_MT, RC_NT, TX>,
                            dim3(RC_CL * tiles, D), rc_threads(RC_NT),
                            bwd_resident_smem<RC_CL, RC_NT>(H), RC_CL, st, g, r, z, n,
                            hnb, hprev, whh, d_in, d_hid, dh0, T, B, H, D);
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
