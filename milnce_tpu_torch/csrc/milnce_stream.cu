// Streamed MIL-NCE logsumexp kernels for Hopper (sm_90a), f32.
//
// Replaces the two Pallas TPU kernels of milnce_tpu/ops/milnce_pallas.py:
//   _fwd_kernel (B1)  -> lse_fwd
//   _bwd_kernel (B2)  -> lse_bwd_rows + lse_bwd_cols
//
// The whole MIL-NCE stream is one primitive applied twice.  For A (R, D),
// B (C, D) row-major f32:
//   lse_r   = logsumexp_j A_r . B_j                       (lse_fwd)
//   w_rj    = exp(A_r . B_j - lse_r) * g_r
//   dA_r    = sum_j w_rj B_j                              (lse_bwd_rows)
//   dB_j    = sum_r w_rj A_r                              (lse_bwd_cols)
// The rows of the loss run A = v against B = t_all (R = B, C = Bg*K), the
// columns A = t against B = v_all (R = B*K, C = Bg); each kernel is
// launched once for each per training step.
//
// What bounds them on the card: operations.  At the recipe shape (B =
// 128, Bg = 8192, K = 5, D = 512) the forward pair is 10.74 GFLOP over
// ~100 MB of inputs and each backward launch 10.74 GFLOP (logits
// recomputed plus one product), far above the H100's f32 ridge (~20 FLOP
// per byte at 67 TFLOP/s and 3.35 TB/s).  Every design keeps the logits
// out of device memory.  The TPU kernel's sequential grid over chunks does
// not carry over: Hopper blocks run in no order, so a block loops over
// column tiles itself.  lse_fwd and lse_bwd_rows split the column loop
// over grid.y to fill the 132 SMs when R is small; each split writes a
// partial (max, sum) or partial dA and the wrapper combines the splits in
// a second pass.  lse_bwd_cols owns whole column tiles and loops over
// every row tile, so it writes dB directly.  No atomics.  Columns past C
// take the logit -BIG (the JAX stream's finite sentinel) in the forward;
// rows past R and columns past C get weight 0.
//
// lse_fwd and lse_bwd_cols share logits_tile: a 64 x 64 tile from
// 16-deep shared stages of A and B, transposed on the way in, 4 x 4
// outputs a thread, two barriers a stage, no prefetch; lse_bwd_cols keeps
// its (64, D) accumulator in shared memory.
//
// lse_bwd_rows (namespace rows below) is built for the FMA units to set
// the pace:
//   - dA in registers, not shared memory: a block owns 32 rows and holds
//     their (32, D) dA in its 256 threads, 8 rows x 4 DV depths each, with
//     D a compile-time bound (instances for D <= 256, 512 and 768) and a
//     runtime tail; no read-modify-write of an accumulator per chunk.
//   - operands read once per use: the block's (32, D) A tile stays in
//     shared memory across its whole column loop; each 256-column tile of
//     B is streamed once per product, in B's own row-major layout (Bt is
//     read by addressing, never copied transposed).
//   - loads overlap math: 16-byte cp.async.cg copies into a ring of three
//     stages, commit / wait_group, one barrier per stage.
//   - 8-row micro-tiles whose rows are uniform over a warp, so A and the
//     weights are broadcast reads and each 16-byte load of B feeds 16 FMAs
//     (dA) or 10.7 with the A loads counted (logits); XOR swizzles make
//     the remaining 16-byte loads and stores conflict-free.
//   - 256-column tiles give the column loop's split fine enough grain to
//     put one block on each SM in one wave at R = 128 and R = 640.
//
// Plain SIMT f32 FMAs: no tensor cores (wgmma would need TF32 or bf16,
// which the f32 reference does not allow), no TMA.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;    // rows of a logits tile
constexpr int BN = 64;    // columns of a logits tile
constexpr int BK = 16;    // depth of one shared-memory stage
constexpr int BD = 64;    // width of one chunk of the output rows
constexpr int NT = 256;   // threads per block, viewed as 16 x 16
constexpr int LD = 68;    // row stride of the 64-wide shared tiles: a
                          // multiple of 4 (128-bit loads) that staggers
                          // the transposing stores over the banks
constexpr float BIG = 1e30f;

struct __align__(16) Stage {
  float a[BK][LD];        // A tile, transposed (depth-major)
  float b[BK][LD];        // B tile, transposed
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4x4(float acc[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// S = A[row0 : row0 + 64] . B[col0 : col0 + 64]^T.  Thread (ty, tx) =
// (tid / 16, tid % 16) owns rows 4 ty + i and columns 4 tx + j (i, j < 4).
// Rows past R, columns past C and depth past D read zeros.
__device__ __forceinline__ void logits_tile(const float* __restrict__ A,
                                            const float* __restrict__ B,
                                            int R, int C, int D, int row0,
                                            int col0, Stage& st,
                                            float acc[4][4]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int l = tid; l < BM * BK; l += NT) {
      const int r = l / BK, k = l % BK, gr = row0 + r, gk = k0 + k;
      st.a[k][r] = (gr < R && gk < D) ? A[(size_t)gr * D + gk] : 0.f;
      const int gc = col0 + r;
      st.b[k][r] = (gc < C && gk < D) ? B[(size_t)gc * D + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k)
      fma4x4(acc, ld4(&st.a[k][4 * ty]), ld4(&st.b[k][4 * tx]));
    __syncthreads();
  }
}

// Reductions over the 16 lanes that share a row group (half a warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (ceil(R / BM), nsplit); split y covers column tiles
// [y * tps, min((y + 1) * tps, ceil(C / BN))).
__global__ void __launch_bounds__(NT)
lse_fwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ part_m, float* __restrict__ part_s,
               int R, int C, int D, int tps) {
  __shared__ Stage st;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int row0 = blockIdx.x * BM, split = blockIdx.y;
  const int ntiles = (C + BN - 1) / BN;
  const int t_end = min(ntiles, (split + 1) * tps);
  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, s[i] = 0.f;
  for (int t = split * tps; t < t_end; ++t) {
    const int col0 = t * BN;
    float acc[4][4];
    logits_tile(A, B, R, C, D, row0, col0, st, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col0 + 4 * tx + j >= C) acc[i][j] = -BIG;
        mx = fmaxf(mx, acc[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      float ts = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) ts += expf(acc[i][j] - mn);
      s[i] = s[i] * expf(m[i] - mn) + row_sum(ts);
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 4 * ty + i;
      if (r < R) {
        part_m[(size_t)split * R + r] = m[i];
        part_s[(size_t)split * R + r] = s[i];
      }
    }
  }
}

// Weight of logit (4 ty + i, 4 tx + j) of the tile; zero past R and C.
__device__ __forceinline__ void weights(float acc[4][4],
                                        const float* __restrict__ lse,
                                        const float* __restrict__ g, int R,
                                        int C, int row0, int col0) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    const float l = r < R ? lse[r] : 0.f, gr = r < R ? g[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + 4 * tx + j;
      acc[i][j] = (r < R && c < C) ? expf(acc[i][j] - l) * gr : 0.f;
    }
  }
}

// grid (ceil(C / BN)).  Each block owns BN columns of B and loops over
// every row tile of A.  Dynamic shared memory: the (BN, D) dB
// accumulator, the weights tile (w[r][c]) and one (BM, BD) chunk of A.
__global__ void __launch_bounds__(NT)
lse_bwd_cols_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    float* __restrict__ dB, int R, int C, int D) {
  __shared__ Stage st;
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  float (*w)[LD] = reinterpret_cast<float (*)[LD]>(dyn);            // [BM][LD]
  float (*ac)[LD] = reinterpret_cast<float (*)[LD]>(dyn + BM * LD);  // [BM][LD]
  float* accs = dyn + 2 * BM * LD;                                   // [BN][D]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int col0 = blockIdx.x * BN;
  for (int l = tid; l < BN * D; l += NT) accs[l] = 0.f;
  for (int row0 = 0; row0 < R; row0 += BM) {
    float acc[4][4];
    logits_tile(A, B, R, C, D, row0, col0, st, acc);
    weights(acc, lse, g, R, C, row0, col0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&w[4 * ty + i][4 * tx]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    for (int d0 = 0; d0 < D; d0 += BD) {
      for (int l = tid; l < BM * BD; l += NT) {
        const int r = l / BD, dd = l % BD, gr = row0 + r, gd = d0 + dd;
        ac[r][dd] = (gr < R && gd < D) ? A[(size_t)gr * D + gd] : 0.f;
      }
      __syncthreads();                        // also publishes w
      // thread owns columns c = 4 ty + i and depths d = 4 tx + j
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll 8
      for (int r = 0; r < BM; ++r)
        fma4x4(o, ld4(&w[r][4 * ty]), ld4(&ac[r][4 * tx]));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + 4 * tx + j;
          if (d < D) accs[(4 * ty + i) * D + d] += o[i][j];
        }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int l = tid; l < BN * D; l += NT) {
    const int c = l / D;
    if (col0 + c < C) dB[(size_t)col0 * D + l] = accs[l];
  }
}

// lse_bwd_cols's dynamic shared memory: two 64 x LD tiles and a 64 x D
// accumulator.
size_t bwd_smem_bytes(int D) {
  return sizeof(float) * ((size_t)2 * 64 * LD + (size_t)64 * D);
}

// ---------------------------------------------------------------- lse_bwd_rows
// dA (R, D) = sum_j w_rj B_j, w_rj = exp(A_r . B_j - lse_r) g_r.
//
// grid (ceil(R / RB_M), nsplit), RB_T threads, one block per SM.  A block
// owns RB_M = 32 rows of A for its whole life: the (32, D) A tile sits in
// shared memory and the (32, D) dA accumulator in registers, 8 rows by
// 4 DV depths a thread.  It walks the column tiles [y tps, (y + 1) tps)
// of its split, RB_N = 256 columns each, and streams each tile of B twice
// through one ring of RB_STAGES shared-memory stages filled by cp.async:
// RB_K-deep slabs of all 256 columns for the logits S = A B^T, then
// NB-row slabs of full depth for dA += W B.  One barrier per stage;
// the copies of stage s + RB_STAGES - 1 run under the FMAs of stage s.
namespace rows {

// ROWS_SKIP (default 0), a bit mask for timing the kernel's parts
// (milnce_tpu_torch/ops/rows_probe.py): 1 skips the logits FMAs, 2 the dA
// FMAs, 4 the copies of B.  Any bit set gives wrong results.
#ifndef ROWS_SKIP
#define ROWS_SKIP 0
#endif
constexpr int RB_M = 32;       // rows of A a block owns
constexpr int RB_N = 256;      // columns of one tile of B
constexpr int RB_K = 32;       // depth of one logits slab
constexpr int RB_T = 256;      // threads
constexpr int RB_STAGES = 3;   // depth of the cp.async ring
constexpr int W_RG = RB_N * 8 + 4;      // floats per row group of Ws

template <int DMAX>
struct Inst {
  static constexpr int DV = DMAX / 256;   // float4s of dA per thread and row
  static constexpr int LDA = DMAX + 4;    // row stride of the A tile
  static constexpr int NB = DMAX <= 256 ? 32 : 8;  // rows of B a dA slab
  static constexpr int STAGE =            // floats in one ring stage
      RB_N * RB_K > NB * DMAX ? RB_N * RB_K : NB * DMAX;
  // the A tile, the weights tile, the ring, lse and g of the block's rows
  static constexpr size_t SMEM = sizeof(float) *
      ((size_t)RB_M * LDA + 4 * W_RG + RB_STAGES * STAGE + 2 * RB_M);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

// Four floats of row ``row`` of the row-major (nrows, D) matrix ``m``, at
// depths k .. k + 3, into 16-byte aligned shared ``dst``; zeros past the
// last row and past D.  VEC (D % 4 == 0 and ``m`` 16-byte aligned): one
// 16-byte cp.async.cg; otherwise four 4-byte copies, zero-filled past D.
template <bool VEC>
__device__ __forceinline__ void copy4(float* dst, const float* __restrict__ m,
                                      int row, int nrows, int k, int D) {
  if (row >= nrows || k >= D) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float* src = m + (size_t)row * D + k;
  if (VEC) {
    cp16(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool ok = k + e < D;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst + e)), "l"(ok ? src + e : m),
                 "r"(ok ? 4 : 0) : "memory");
  }
}

// Offset of float4 ``h`` (0 or 1) of the weights of rows rg + 4 i (i < 8)
// for tile column ``n``.  Row groups sit W_RG floats apart, so the 4 row
// groups of a warp read 4 distinct bank groups; an XOR swizzle on bit 2
// of n spreads the stores of 8 neighbouring columns over 8.
__device__ __forceinline__ int w_at(int rg, int n, int h) {
  return rg * W_RG + n * 8 + 4 * (h ^ ((n >> 2) & 1));
}

// Offset of float4 ``q`` (< 8) of column c in a logits slab (B's
// row-major layout, RB_K = 32 floats, one 128-byte line, a column): an
// XOR swizzle of q with c % 8, so 8 neighbouring columns read at one depth
// hit 8 distinct bank groups.
__device__ __forceinline__ int s_at(int c, int q) {
  static_assert(RB_K == 32, "the swizzle assumes 128-byte columns");
  return c * RB_K + 4 * (q ^ (c & 7));
}

// Lane l of warp w is (rg, x) = (l / 8, l % 8).  In both products the
// thread owns rows rg + 4 i (i < 8): of the logits, columns 32 w + x + 8 j
// (j < 4) of the tile; of dA, depths 4 (8 w + x) + 256 v + e (v < DV,
// e < 4).  A warp's 16-byte loads of A and of the weights then touch 4
// distinct addresses in 4 bank groups, its loads of B 8 neighbouring
// float4s: each is one shared-memory wavefront, broadcast over the rest
// of the warp.  Per 16-byte load, the dA product does 16 FMAs at D = 512
// (8 rows x 4 depths, 2 weight and 2 B loads per 8 x 8) and the logits
// product 10.7 (8 x 4 outputs x 4 depths per 12 loads).
template <int DMAX, bool VEC>
__global__ void __launch_bounds__(RB_T, 1)
lse_bwd_rows_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    float* __restrict__ part_dA, int R, int C, int D,
                    int tps) {
  using I = Inst<DMAX>;
  constexpr int DV = I::DV, LDA = I::LDA, NB = I::NB;
  extern __shared__ float4 dyn4[];
  float* As = reinterpret_cast<float*>(dyn4);   // [RB_M][LDA]
  float* Ws = As + RB_M * LDA;                  // [4][W_RG], w_at
  float* ring = Ws + 4 * W_RG;                  // [RB_STAGES][STAGE]
  float* ls = ring + RB_STAGES * I::STAGE;      // [RB_M]
  float* gs = ls + RB_M;                        // [RB_M]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, x = lane & 7;
  const int cx = 32 * warp + x;                 // first logits column
  const int dx = 4 * (8 * warp + x);            // first dA depth
  const int row0 = blockIdx.x * RB_M;
  const int t_first = blockIdx.y * tps;
  const int ntile = min((C + RB_N - 1) / RB_N, t_first + tps) - t_first;
  const int n_k = (D + RB_K - 1) / RB_K;        // logits slabs a tile
  const int per_tile = n_k + RB_N / NB;         // and dA slabs a tile
  const int d4 = (D + 3) / 4;

  if (tid < RB_M) {
    const int r = row0 + tid;
    ls[tid] = r < R ? lse[r] : 0.f;
    gs[tid] = r < R ? g[r] : 0.f;
  }
  // The A tile, zero past R and from D to the last slab's depth; its
  // copies join the first stage's group.
  const int a4 = n_k * (RB_K / 4);
  for (int l = tid; l < RB_M * a4; l += RB_T) {
    const int r = l / a4, q = l - r * a4;
    copy4<VEC>(As + r * LDA + 4 * q, A, row0 + r, R, 4 * q, D);
  }

  // The next slab to copy: tile it, part ip, ring stage is_.
  int it = 0, ip = 0, is_ = 0;
  auto issue_next = [&]() {
    if (it < ntile && !(ROWS_SKIP & 4)) {
      float* st = ring + is_ * I::STAGE;
      const int col0 = (t_first + it) * RB_N;
      // whole 16-byte chunks inside C and D: copies without checks
      const bool fast = VEC && col0 + RB_N <= C;
      if (ip < n_k) {         // B[col0 : +256, RB_K ip : +RB_K], swizzled
        constexpr int Q = RB_K / 4;
        const int k0 = ip * RB_K;
        if (fast && k0 + RB_K <= D) {
          const float* src =
              B + (size_t)(col0 + tid / Q) * D + k0 + 4 * (tid % Q);
#pragma unroll
          for (int m = 0; m < RB_N * Q / RB_T; ++m)
            cp16(st + s_at(tid / Q + m * (RB_T / Q), tid % Q),
                 src + (size_t)m * (RB_T / Q) * D);
        } else {
#pragma unroll
          for (int m = 0; m < RB_N * Q / RB_T; ++m) {
            const int l = tid + m * RB_T, c = l / Q, q = l % Q;
            copy4<VEC>(st + s_at(c, q), B, col0 + c, C, k0 + 4 * q, D);
          }
        }
      } else {                // B[col0 + n0 : +NB, 0 : D], stride DMAX
        const int n0 = (ip - n_k) * NB;
        constexpr int Q = DMAX / 4;
#pragma unroll
        for (int m = 0; m < NB * Q / RB_T; ++m) {
          const int l = tid + m * RB_T, n = l / Q, q = l % Q;
          if (q < d4) {
            float* dst = st + n * DMAX + 4 * q;
            if (fast)
              cp16(dst, B + (size_t)(col0 + n0 + n) * D + 4 * q);
            else
              copy4<VEC>(dst, B, col0 + n0 + n, C, 4 * q, D);
          }
        }
      }
    }
    if (++ip == per_tile) ip = 0, ++it;
    if (++is_ == RB_STAGES) is_ = 0;
  };

  float acc[8][4];            // logits of the current tile
  float out[8][4 * DV];       // dA
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * DV; ++e) out[i][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < RB_STAGES - 1; ++s) {
    issue_next();
    cp_commit();
  }
  // The slab to compute: tile ct, part cp, ring stage cs.
  for (int ct = 0, cp = 0, cs = 0; ct < ntile;) {
    cp_wait<RB_STAGES - 2>();
    __syncthreads();          // stage cs has landed, the one before is free
    issue_next();
    cp_commit();
    const float* st = ring + cs * I::STAGE;
    if (cp < n_k) {
      if (cp == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      const float* a_k = As + rg * LDA + cp * RB_K;
#pragma unroll
      for (int q = 0; q < (ROWS_SKIP & 1 ? 0 : RB_K / 4); ++q) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ld4(st + s_at(cx + 8 * j, q));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = ld4(a_k + 4 * i * LDA + 4 * q);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
          }
        }
      }
      if (cp == n_k - 1) {    // the tile's weights, zero past R and C
        const int col0 = (t_first + ct) * RB_N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = cx + 8 * j;
          float w[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = rg + 4 * i;
            w[i] = (row0 + r < R && col0 + n < C)
                       ? expf(acc[i][j] - ls[r]) * gs[r] : 0.f;
          }
          *reinterpret_cast<float4*>(Ws + w_at(rg, n, 0)) =
              make_float4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<float4*>(Ws + w_at(rg, n, 1)) =
              make_float4(w[4], w[5], w[6], w[7]);
        }
      }                       // the next stage's barrier publishes Ws
    } else {
      const int n0 = (cp - n_k) * NB;
#pragma unroll
      for (int n = 0; n < (ROWS_SKIP & 2 ? 0 : NB); ++n) {
        const float4 w0 = ld4(Ws + w_at(rg, n0 + n, 0));
        const float4 w1 = ld4(Ws + w_at(rg, n0 + n, 1));
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int v = 0; v < DV; ++v) {
          const float4 b = ld4(st + n * DMAX + dx + 256 * v);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            out[i][4 * v + 0] = fmaf(wv[i], b.x, out[i][4 * v + 0]);
            out[i][4 * v + 1] = fmaf(wv[i], b.y, out[i][4 * v + 1]);
            out[i][4 * v + 2] = fmaf(wv[i], b.z, out[i][4 * v + 2]);
            out[i][4 * v + 3] = fmaf(wv[i], b.w, out[i][4 * v + 3]);
          }
        }
      }
    }
    if (++cp == per_tile) cp = 0, ++ct;
    if (++cs == RB_STAGES) cs = 0;
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + rg + 4 * i;
    if (r >= R) continue;
    float* dst = part_dA + ((size_t)blockIdx.y * R + r) * D;
#pragma unroll
    for (int v = 0; v < DV; ++v) {
      const int d = dx + 256 * v;
      if ((D & 3) == 0 && d + 4 <= D) {
        *reinterpret_cast<float4*>(dst + d) =
            make_float4(out[i][4 * v], out[i][4 * v + 1], out[i][4 * v + 2],
                        out[i][4 * v + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) dst[d + e] = out[i][4 * v + e];
      }
    }
  }
}

template <int DMAX, bool VEC>
int launch(const float* A, const float* B, const float* lse, const float* g,
           float* part_dA, int R, int C, int D, int nsplit, int tps,
           cudaStream_t stream) {
  const size_t smem = Inst<DMAX>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      lse_bwd_rows_kernel<DMAX, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + RB_M - 1) / RB_M, nsplit);
  lse_bwd_rows_kernel<DMAX, VEC><<<grid, RB_T, smem, stream>>>(
      A, B, lse, g, part_dA, R, C, D, tps);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch(const float* A, const float* B, const float* lse, const float* g,
           float* part_dA, int R, int C, int D, int nsplit, int tps, int vec,
           cudaStream_t stream) {
  return vec ? launch<DMAX, true>(A, B, lse, g, part_dA, R, C, D, nsplit, tps,
                                  stream)
             : launch<DMAX, false>(A, B, lse, g, part_dA, R, C, D, nsplit,
                                   tps, stream);
}

}  // namespace rows

}  // namespace

extern "C" {

// Dynamic shared memory lse_bwd_cols needs at depth D (bytes); the
// wrapper refuses a D whose need passes the card's limit.
size_t milnce_bwd_smem(int D) { return bwd_smem_bytes(D); }

int milnce_lse_fwd(const float* A, const float* B, float* part_m,
                   float* part_s, int R, int C, int D, int nsplit, int tps,
                   void* stream) {
  dim3 grid((R + BM - 1) / BM, nsplit);
  lse_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(A, B, part_m, part_s,
                                                       R, C, D, tps);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the lse_bwd_rows instance for depths up to
// ``dmax`` (bytes), 0 for a dmax that has no instance.
size_t milnce_bwd_rows_smem(int dmax) {
  switch (dmax) {
    case 256: return rows::Inst<256>::SMEM;
    case 512: return rows::Inst<512>::SMEM;
    case 768: return rows::Inst<768>::SMEM;
    default: return 0;
  }
}

// part_dA (nsplit, R, D); ``dmax`` picks the instance (256, 512 or 768,
// at least D); ``vec``: D % 4 == 0 and A, B 16-byte aligned.
int milnce_lse_bwd_rows(const float* A, const float* B, const float* lse,
                        const float* g, float* part_dA, int R, int C, int D,
                        int dmax, int nsplit, int tps, int vec, void* stream) {
  if (D > dmax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dmax) {
    case 256:
      return rows::launch<256>(A, B, lse, g, part_dA, R, C, D, nsplit, tps,
                               vec, s);
    case 512:
      return rows::launch<512>(A, B, lse, g, part_dA, R, C, D, nsplit, tps,
                               vec, s);
    case 768:
      return rows::launch<768>(A, B, lse, g, part_dA, R, C, D, nsplit, tps,
                               vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int milnce_lse_bwd_cols(const float* A, const float* B, const float* lse,
                        const float* g, float* dB, int R, int C, int D,
                        void* stream) {
  const size_t smem = bwd_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      lse_bwd_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + BN - 1) / BN);
  lse_bwd_cols_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      A, B, lse, g, dB, R, C, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
