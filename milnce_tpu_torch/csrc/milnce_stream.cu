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
// What bounds it on the card: operations.  At the recipe shape (B = 128,
// Bg = 8192, K = 5, D = 512) the forward is ~10.7 GFLOP over ~100 MB of
// inputs, far above the H100's f32 ridge (~20 FLOP per byte at 67 TFLOP/s
// and 3.35 TB/s).  The design keeps every logit out of device memory: a
// 64 x 64 logits tile is computed from shared-memory stages of A and B,
// then folded straight into running (max, sum) pairs (forward) or into
// weights that feed a second tile product whose accumulator lives in
// shared memory (backward).  Each thread owns 4 x 4 outputs of every
// product and reads its operands as 128-bit shared loads, two loads per
// 16 FMAs, so the FMA units and not the shared-memory port set the pace.
// The TPU kernel's sequential grid over chunks does not carry over:
// Hopper blocks run in no order, so a block loops over column tiles
// itself.  lse_fwd and lse_bwd_rows split the column loop over grid.y to
// fill the 132 SMs when R is small (R = 128 gives only 2 row tiles); each
// split writes a partial (max, sum) or partial dA and the wrapper combines
// the splits in a second pass.  lse_bwd_cols owns whole column tiles and
// loops over every row tile, so it writes dB directly.  No atomics.
// Columns past C take the logit -BIG (the JAX stream's finite sentinel),
// rows past R and columns past C get weight 0.
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

// grid (ceil(R / BM), nsplit).  Dynamic shared memory: the (BM, D) dA
// accumulator, the weights tile transposed (wt[n][r]) and one (BN, BD)
// chunk of B.
__global__ void __launch_bounds__(NT)
lse_bwd_rows_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    float* __restrict__ part_dA, int R, int C, int D,
                    int tps) {
  __shared__ Stage st;
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  float (*wt)[LD] = reinterpret_cast<float (*)[LD]>(dyn);          // [BN][LD]
  float (*bc)[LD] = reinterpret_cast<float (*)[LD]>(dyn + BN * LD);  // [BN][LD]
  float* accs = dyn + 2 * BN * LD;                                   // [BM][D]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int row0 = blockIdx.x * BM, split = blockIdx.y;
  const int ntiles = (C + BN - 1) / BN;
  const int t_end = min(ntiles, (split + 1) * tps);
  for (int l = tid; l < BM * D; l += NT) accs[l] = 0.f;
  for (int t = split * tps; t < t_end; ++t) {
    const int col0 = t * BN;
    float acc[4][4];
    logits_tile(A, B, R, C, D, row0, col0, st, acc);
    weights(acc, lse, g, R, C, row0, col0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&wt[4 * tx + j][4 * ty]) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    for (int d0 = 0; d0 < D; d0 += BD) {
      for (int l = tid; l < BN * BD; l += NT) {
        const int n = l / BD, dd = l % BD, gc = col0 + n, gd = d0 + dd;
        bc[n][dd] = (gc < C && gd < D) ? B[(size_t)gc * D + gd] : 0.f;
      }
      __syncthreads();                        // also publishes wt
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < BN; ++n)
        fma4x4(o, ld4(&wt[n][4 * ty]), ld4(&bc[n][4 * tx]));
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
  for (int l = tid; l < BM * D; l += NT) {
    const int r = l / D;
    if (row0 + r < R)
      part_dA[((size_t)split * R + row0) * D + l] = accs[l];
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

// Both backward kernels use the same dynamic shared memory: two 64 x LD
// tiles and a 64 x D accumulator.
size_t bwd_smem_bytes(int D) {
  return sizeof(float) * ((size_t)2 * 64 * LD + (size_t)64 * D);
}

}  // namespace

extern "C" {

// Dynamic shared memory the backward kernels need at depth D (bytes);
// the wrapper refuses a D whose need passes the card's limit.
size_t milnce_bwd_smem(int D) { return bwd_smem_bytes(D); }

int milnce_lse_fwd(const float* A, const float* B, float* part_m,
                   float* part_s, int R, int C, int D, int nsplit, int tps,
                   void* stream) {
  dim3 grid((R + BM - 1) / BM, nsplit);
  lse_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(A, B, part_m, part_s,
                                                       R, C, D, tps);
  return (int)cudaGetLastError();
}

int milnce_lse_bwd_rows(const float* A, const float* B, const float* lse,
                        const float* g, float* part_dA, int R, int C, int D,
                        int nsplit, int tps, void* stream) {
  const size_t smem = bwd_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      lse_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + BM - 1) / BM, nsplit);
  lse_bwd_rows_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      A, B, lse, g, part_dA, R, C, D, tps);
  return (int)cudaGetLastError();
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
