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
// tiles itself, and where its own tiles are too few to fill the 132 SMs
// the loop is split over grid.y; each split writes a partial (max, sum)
// or a partial gradient and the wrapper combines the splits in a second
// pass.  No atomics.  The forward skips columns past C by a branch (the
// JAX stream gives them the logit -BIG, which adds exp(-BIG - m) = 0);
// in the backward rows past R and columns past C get weight 0.
//
// All three are modes of one kernel family (namespace rows below), built
// for the FMA units to set the pace.  A block owns rows of one operand and
// streams the other: lse_fwd and lse_bwd_rows own rows of A and stream B,
// lse_bwd_cols owns rows of B (columns of the logits) and streams A.  The
// logits of an (owned, streamed) pair are the same dot product either way.
// The forward keeps a running (max, sum) per owned row; the backward turns
// the logits into weights and adds a second product, the weighted sum of
// streamed rows, where only the weight's lse and g follow the owned row
// (rows) or the streamed row (cols).  "rows" names the family in every
// mode: the namespace, the ROWS_* constants and switches and
// ops/rows_probe.py serve lse_fwd and lse_bwd_cols too.
//   - operands read once per use: the block's owned tile stays in shared
//     memory for its whole life; each tile of the streamed operand is
//     streamed once per product in its own row-major layout, never copied
//     transposed.
//   - loads overlap math: 16-byte cp.async.cg copies into a ring of three
//     stages, commit / wait_group, one barrier per stage.
//   - micro-tiles whose rows are uniform over groups of lanes, so the owned
//     tile (and the backward's weights) are broadcast reads; XOR swizzles
//     make the remaining 16-byte loads and stores conflict-free.
//   - the split of the streamed loop gives the grid one block per SM in one
//     wave when the owned tiles alone are fewer than the SMs.
//
// lse_fwd (lse_fwd_kernel) has no gradient to hold: 256 threads each
// keep an 8 x 4 logits micro-tile (10.7 FMAs a 16-byte shared load) and an
// online (max, sum) for each of its 8 owned rows over the streamed rows it
// sees, one rescale exp a row and one exp a logit per tile.  Lanes and
// warps combine their pairs once, when the block ends.  A block owns 64
// rows of A and streams 128-row tiles of B (32 rows and 256-row tiles at
// D <= 768, whose A tile leaves less room).  An 8 x 8 micro-tile (64 x 256,
// 16 FMAs a load) is faster per tile but fills the card less evenly: a
// step's launches are 320 such tiles, 3 a block on 108 or 110 SMs, against
// 640 of 64 x 128, 5 a block on 128 or 130 (PERF.md has the times).
//
// lse_bwd_rows and lse_bwd_cols (lse_bwd_kernel):
//   - the gradient in registers, not shared memory: the block holds its
//     (32, D) rows in its 256 threads, 8 rows x 4 DV depths each, with D a
//     compile-time bound (instances for D <= 256, 512 and 768) and a
//     runtime tail; no read-modify-write of an accumulator per chunk.
//   - the streamed tile is SN = 256 rows for lse_bwd_rows, 128 for
//     lse_bwd_cols, whose R = 128 and 640 it covers without padding.
//   - each 16-byte load of the streamed operand feeds 16 FMAs in the
//     gradient product and, with the owned tile's loads counted, 10.7 (SN
//     = 256) or 8 (SN = 128) in the logits.
//
// The deep mode (every mode, any D > 768): the owned tile no longer fits
// beside the ring at full depth, nor the backward's gradient in registers.
// So the owned operand is streamed too: each logits stage holds an RB_K-deep
// slab of the owned rows (from global memory and L2, swizzled as the
// streamed slab is) beside the streamed slab, and the forward's online
// (max, sum) runs as in the held mode.  The backward writes its gradient
// one depth slab of at most 768 at a time, one slab a grid z-index: each
// block recomputes the full-depth logits for its slab, so the logits FMAs
// grow by ceil(D / 768) and the product's are those of the 768 instance.
// Instances: DMAX = 768 with DEEP set.
//
// Plain SIMT f32 FMAs: no tensor cores (wgmma would need TF32 or bf16,
// which the f32 reference does not allow), no TMA.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------ lse_bwd_rows, lse_bwd_cols
// One kernel, two modes (the forward's kernel follows it).  O (NO, D) is the owned operand, S (NS, D) the
// streamed one; the kernel writes part (nsplit, NO, D):
//   part[y]_o = sum_s w_os S_s over the streamed tiles of split y,
//   w_os = exp(O_o . S_s - lse_x) g_x, x = o (OWN_COLS false: lse_bwd_rows,
//   O = A, S = B) or x = s (OWN_COLS true: lse_bwd_cols, O = B, S = A).
//
// grid (ceil(NO / RB_M), nsplit), RB_T threads, one block per SM.  A block
// owns RB_M = 32 rows of O for its whole life: the (32, D) O tile sits in
// shared memory and the (32, D) accumulator in registers, 8 rows by 4 DV
// depths a thread.  It walks the streamed tiles [y tps, (y + 1) tps) of
// its split, SN rows of S each, and streams each tile twice through one
// ring of RB_STAGES shared-memory stages filled by cp.async: RB_K-deep
// slabs of all SN rows for the logits, then NB-row slabs of full depth for
// the product with the weights.  One barrier per stage; the copies of
// stage s + RB_STAGES - 1 run under the FMAs of stage s.
namespace rows {

// ROWS_SKIP (default 0), a bit mask for timing the kernel's parts
// (milnce_tpu_torch/ops/rows_probe.py): 1 skips the logits FMAs, 2 the
// gradient FMAs (in lse_fwd: the running (max, sum) update, whose place a
// plain sum of the logits takes so that their FMAs stay live), 4 the
// copies of the streamed operand.  Any bit set gives wrong results.
#ifndef ROWS_SKIP
#define ROWS_SKIP 0
#endif
constexpr int RB_M = 32;       // rows of O a block owns
constexpr int RB_K = 32;       // depth of one logits slab
constexpr int RB_T = 256;      // threads
constexpr int RB_STAGES = 3;   // depth of the cp.async ring

// floats per row group of the weights tile of SN streamed rows
__host__ __device__ constexpr int w_rg(int sn) { return sn * 8 + 4; }

// DEEP: the owned operand streamed beside S in each logits stage (its slab
// after S's), the gradient written DMAX depths a grid z-index.
template <int DMAX, int SN, bool DEEP = false>
struct Inst {
  static constexpr int DV = DMAX / 256;   // float4s of output per thread and row
  static constexpr int LDA = DMAX + 4;    // row stride of the O tile
  static constexpr int NB = DMAX <= 256 ? 32 : 8;  // rows of S a product slab
  static constexpr int LOGITS = (SN + (DEEP ? RB_M : 0)) * RB_K;
  static constexpr int STAGE =            // floats in one ring stage
      LOGITS > NB * DMAX ? LOGITS : NB * DMAX;
  static constexpr int OWNED = DEEP ? 0 : RB_M * LDA;  // the held O tile
  // the O tile, the weights tile, the ring, lse and g of the block's rows
  // (read by lse_bwd_rows only)
  static constexpr size_t SMEM = sizeof(float) *
      ((size_t)OWNED + 4 * w_rg(SN) + RB_STAGES * STAGE + 2 * RB_M);
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

// Offset of float4 ``h`` (0 or 1) of the weights of owned rows rg + 4 i
// (i < 8) for streamed row ``n``.  Row groups sit w_rg(SN) floats apart (4
// banks mod 32), so the 4 row groups of a warp read 4 distinct bank
// groups; an XOR swizzle on bit 2 of n spreads the stores of 8
// neighbouring streamed rows over 8.
template <int SN>
__device__ __forceinline__ int w_at(int rg, int n, int h) {
  return rg * w_rg(SN) + n * 8 + 4 * (h ^ ((n >> 2) & 1));
}

// Offset of float4 ``q`` (< 8) of streamed row c in a logits slab (S's
// row-major layout, RB_K = 32 floats, one 128-byte line, a row): an XOR
// swizzle of q with c % 8, so 8 neighbouring rows read at one depth hit 8
// distinct bank groups.
__device__ __forceinline__ int s_at(int c, int q) {
  static_assert(RB_K == 32, "the swizzle assumes 128-byte rows");
  return c * RB_K + 4 * (q ^ (c & 7));
}

// The block's owned tile: rows row0 .. row0 + M - 1 of O into Os (row
// stride LDA), zero past NO and from D to the last slab's depth n_k RB_K.
template <bool VEC, int M>
__device__ __forceinline__ void load_owned(float* Os, int LDA,
                                           const float* __restrict__ O,
                                           int row0, int NO, int n_k, int D) {
  const int a4 = n_k * (RB_K / 4);
  for (int l = threadIdx.x; l < M * a4; l += RB_T) {
    const int r = l / a4, q = l - r * a4;
    copy4<VEC>(Os + r * LDA + 4 * q, O, row0 + r, NO, 4 * q, D);
  }
}

// The deep mode's slab of the owned rows: O[row0 : +M, k0 : +RB_K] into st,
// swizzled (s_at) as the streamed slab is, zero past NO and D.
template <bool VEC, int M>
__device__ __forceinline__ void copy_owned_slab(float* st,
                                                const float* __restrict__ O,
                                                int row0, int NO, int k0,
                                                int D) {
  constexpr int Q = RB_K / 4;
  for (int l = threadIdx.x; l < M * Q; l += RB_T)
    copy4<VEC>(st + s_at(l / Q, l % Q), O, row0 + l / Q, NO, k0 + 4 * (l % Q),
               D);
}

// One logits slab: S[col0 : +SN, k0 : +RB_K] into ring stage st, swizzled
// (s_at).  ``fast``: the SN rows lie inside NS and VEC holds, so whole
// 16-byte chunks inside D go without checks.
template <bool VEC, int SN>
__device__ __forceinline__ void copy_logits_slab(float* st,
                                                 const float* __restrict__ S,
                                                 int col0, int NS, int k0,
                                                 int D, bool fast) {
  constexpr int Q = RB_K / 4;
  const int tid = threadIdx.x;
  if (fast && k0 + RB_K <= D) {
    const float* src = S + (size_t)(col0 + tid / Q) * D + k0 + 4 * (tid % Q);
#pragma unroll
    for (int m = 0; m < SN * Q / RB_T; ++m)
      cp16(st + s_at(tid / Q + m * (RB_T / Q), tid % Q),
           src + (size_t)m * (RB_T / Q) * D);
  } else {
#pragma unroll
    for (int m = 0; m < SN * Q / RB_T; ++m) {
      const int l = tid + m * RB_T, c = l / Q, q = l % Q;
      copy4<VEC>(st + s_at(c, q), S, col0 + c, NS, k0 + 4 * q, D);
    }
  }
}

// Two lane layouts.  The product: lane l of warp w is (rg, x) = (l / 8,
// l % 8); the thread owns rows rg + 4 i (i < 8) and depths 4 (8 w + x) +
// 256 v + e (v < DV, e < 4).  The logits: lane l is (lrg, lx) = (l / XL,
// l % XL), XL = SN / 32, with RG = 32 / XL row groups; the thread owns
// rows lrg + RG i (i < 32 / RG) and streamed rows (SN / 8) w + lx + XL j
// (j < 4) of the tile, so SN = 256 gives 8 x 4 logits a thread (12 loads
// per 128 FMAs) and SN = 128 gives 4 x 4 (8 loads per 64 FMAs).  A warp's
// 16-byte loads of the O tile and of the weights then touch 4 or 8
// distinct addresses in distinct bank groups (LDA is 4 mod 32), its loads
// of S XL neighbouring float4s: each is one shared-memory wavefront,
// broadcast over the rest of the warp.  The product does 16 FMAs per
// 16-byte load at D = 512 (8 rows x 4 depths, 2 weight and 2 S loads per
// 8 x 8).
//
// DEEP: the O slab of each logits stage sits at SN * RB_K in the stage, read
// through s_at; the block's gradient covers depths z0 .. z0 + DZ - 1 of D,
// z0 = DMAX blockIdx.z.
template <int DMAX, bool VEC, bool OWN_COLS, int SN, bool DEEP>
__global__ void __launch_bounds__(RB_T, 1)
lse_bwd_kernel(const float* __restrict__ O, const float* __restrict__ S,
               const float* __restrict__ lse, const float* __restrict__ g,
               float* __restrict__ part, int NO, int NS, int D, int tps) {
  using I = Inst<DMAX, SN, DEEP>;
  constexpr int DV = I::DV, LDA = I::LDA, NB = I::NB;
  constexpr int XL = SN / 32, RG = 32 / XL, MI = RB_M / RG;
  extern __shared__ float4 dyn4[];
  float* Os = reinterpret_cast<float*>(dyn4);   // [RB_M][LDA], held mode
  float* Ws = Os + I::OWNED;                    // [4][w_rg(SN)], w_at
  float* ring = Ws + 4 * w_rg(SN);              // [RB_STAGES][STAGE]
  float* ls = ring + RB_STAGES * I::STAGE;      // [RB_M]
  float* gs = ls + RB_M;                        // [RB_M]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, x = lane & 7;       // the product's layout
  const int lrg = lane / XL;                    // the logits' layout
  const int cx = (SN / 8) * warp + lane % XL;   // first logits column
  const int dx = 4 * (8 * warp + x);            // first output depth
  const int row0 = blockIdx.x * RB_M;
  const int t_first = blockIdx.y * tps;
  const int ntile = min((NS + SN - 1) / SN, t_first + tps) - t_first;
  const int n_k = (D + RB_K - 1) / RB_K;        // logits slabs a tile
  const int per_tile = n_k + SN / NB;           // and product slabs a tile
  const int z0 = DEEP ? DMAX * blockIdx.z : 0;  // the gradient's depths
  const int DZ = DEEP ? min(DMAX, D - z0) : D;
  const int d4 = (DZ + 3) / 4;

  if (!OWN_COLS && tid < RB_M) {
    const int r = row0 + tid;
    ls[tid] = r < NO ? lse[r] : 0.f;
    gs[tid] = r < NO ? g[r] : 0.f;
  }
  // The O tile; its copies join the first stage's group.
  if (!DEEP) load_owned<VEC, RB_M>(Os, LDA, O, row0, NO, n_k, D);

  // The next slab to copy: tile it, part ip, ring stage is_.
  int it = 0, ip = 0, is_ = 0;
  auto issue_next = [&]() {
    if (it < ntile && !(ROWS_SKIP & 4)) {
      float* st = ring + is_ * I::STAGE;
      const int col0 = (t_first + it) * SN;
      // whole 16-byte chunks inside NS and D: copies without checks
      const bool fast = VEC && col0 + SN <= NS;
      if (ip < n_k) {
        copy_logits_slab<VEC, SN>(st, S, col0, NS, ip * RB_K, D, fast);
        if (DEEP)
          copy_owned_slab<VEC, RB_M>(st + SN * RB_K, O, row0, NO, ip * RB_K,
                                     D);
      } else {                // S[col0 + n0 : +NB, z0 : z0 + DZ], stride DMAX
        const int n0 = (ip - n_k) * NB;
        constexpr int Q = DMAX / 4;
#pragma unroll
        for (int m = 0; m < NB * Q / RB_T; ++m) {
          const int l = tid + m * RB_T, n = l / Q, q = l % Q;
          if (q < d4) {
            float* dst = st + n * DMAX + 4 * q;
            if (fast)
              cp16(dst, S + (size_t)(col0 + n0 + n) * D + z0 + 4 * q);
            else
              copy4<VEC>(dst, S, col0 + n0 + n, NS, z0 + 4 * q, D);
          }
        }
      }
    }
    if (++ip == per_tile) ip = 0, ++it;
    if (++is_ == RB_STAGES) is_ = 0;
  };

  float acc[MI][4];           // logits of the current tile
  float out[8][4 * DV];       // the gradient
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4 * DV; ++e) out[i][e] = 0.f;

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
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      const float* a_k = Os + lrg * LDA + cp * RB_K;
#pragma unroll
      for (int q = 0; q < (ROWS_SKIP & 1 ? 0 : RB_K / 4); ++q) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ld4(st + s_at(cx + XL * j, q));
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float4 a = DEEP ? ld4(st + SN * RB_K + s_at(lrg + RG * i, q))
                                : ld4(a_k + RG * i * LDA + 4 * q);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
          }
        }
      }
      if (cp == n_k - 1) {    // the tile's weights, zero past NO and NS
        const int col0 = (t_first + ct) * SN;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = cx + XL * j;
          const bool n_ok = col0 + n < NS;
          // lse_bwd_cols: lse and g of the streamed row, 0 past NS
          float ln = 0.f, gn = 0.f;
          if (OWN_COLS && n_ok) ln = __ldg(lse + col0 + n), gn = __ldg(g + col0 + n);
          float w[MI];
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const int r = lrg + RG * i;
            w[i] = (row0 + r < NO && n_ok)
                       ? (OWN_COLS ? expf(acc[i][j] - ln) * gn
                                   : expf(acc[i][j] - ls[r]) * gs[r])
                       : 0.f;
          }
          if constexpr (MI == 8) {   // rows rg + 4 i: the product's own
            *reinterpret_cast<float4*>(Ws + w_at<SN>(lrg, n, 0)) =
                make_float4(w[0], w[1], w[2], w[3]);
            *reinterpret_cast<float4*>(Ws + w_at<SN>(lrg, n, 1)) =
                make_float4(w[4], w[5], w[6], w[7]);
          } else {                   // row r is product row (r % 4) + 4 (r / 4)
#pragma unroll
            for (int i = 0; i < MI; ++i) {
              const int r = lrg + RG * i;
              Ws[w_at<SN>(r & 3, n, r >> 4) + ((r >> 2) & 3)] = w[i];
            }
          }
        }
      }                       // the next stage's barrier publishes Ws
    } else {
      const int n0 = (cp - n_k) * NB;
#pragma unroll
      for (int n = 0; n < (ROWS_SKIP & 2 ? 0 : NB); ++n) {
        const float4 w0 = ld4(Ws + w_at<SN>(rg, n0 + n, 0));
        const float4 w1 = ld4(Ws + w_at<SN>(rg, n0 + n, 1));
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
    if (r >= NO) continue;
    float* dst = part + ((size_t)blockIdx.y * NO + r) * D + z0;
#pragma unroll
    for (int v = 0; v < DV; ++v) {
      const int d = dx + 256 * v;
      if ((D & 3) == 0 && d + 4 <= DZ) {
        *reinterpret_cast<float4*>(dst + d) =
            make_float4(out[i][4 * v], out[i][4 * v + 1], out[i][4 * v + 2],
                        out[i][4 * v + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < DZ) dst[d + e] = out[i][4 * v + e];
      }
    }
  }
}

// ------------------------------------------------------------------ lse_fwd
// The forward mode: A (R, D) owned, B (C, D) streamed; the kernel writes
// part_m, part_s (nsplit, R), the (max, sum) of exp(A_r . B_j - max) over
// the streamed tiles of split y.
//
// grid (ceil(R / FM), nsplit), RB_T threads, one block per SM.  The block's
// (FM, D) A tile sits in shared memory for its whole life; it walks the
// streamed tiles [y tps, (y + 1) tps) of its split, SN rows of B each,
// through the backward's ring of RB_STAGES stages of RB_K-deep slabs, one
// barrier per stage.  Lane l of warp w is (lrg, lx) = (l / 8, l % 8), and
// the warps form (FM / 32) x WC: warp (wr, wc) = (w / WC, w % WC) owns rows
// 32 wr + lrg + 4 i (i < 8) and streamed rows 8 TN wc + lx + 8 j (j < TN)
// of each tile.  A warp's 16-byte loads touch 4 rows of the A tile (LDA is
// 4 mod 32: 4 distinct bank groups) and 8 neighbouring rows of B (s_at: 8
// distinct bank groups), each one wavefront broadcast over the warp.
// DEEP: no A tile; each stage holds B's slab, then A's (FM rows, s_at).
template <int DMAX, int FM, int SN, bool DEEP>
struct FwdInst {
  static constexpr int LDA = DMAX + 4;            // row stride of the A tile
  static constexpr int TN = FM * SN / (8 * RB_T); // logits columns a thread
  static constexpr int WC = SN / (8 * TN);        // warps across a tile
  static_assert(FM % 32 == 0 && (FM / 32) * WC * 32 == RB_T,
                "the warps must tile the block's logits");
  static constexpr int OWNED = DEEP ? 0 : FM * LDA;
  static constexpr int STAGE = (SN + (DEEP ? FM : 0)) * RB_K;
  // the A tile and the ring; the warps' partials reuse the ring at the end
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)OWNED + RB_STAGES * STAGE);
  static_assert(2 * WC * FM <= RB_STAGES * STAGE, "partials fit the ring");
};

// Merges the pair (mo, so) into (m, s): both are (max, sum of exp(x - max))
// over disjoint sets; (-inf, 0) is the empty set.
__device__ __forceinline__ void lse_merge(float& m, float& s, float mo,
                                          float so) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) {      // a NaN sum stays NaN
    s += so;
    return;
  }
  s = s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
}

template <int DMAX, bool VEC, int FM, int SN, bool DEEP>
__global__ void __launch_bounds__(RB_T, 1)
lse_fwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ part_m, float* __restrict__ part_s, int R,
               int C, int D, int tps) {
  using I = FwdInst<DMAX, FM, SN, DEEP>;
  constexpr int LDA = I::LDA, TN = I::TN, WC = I::WC;
  constexpr int STAGE = I::STAGE;
  extern __shared__ float4 dyn4[];
  float* As = reinterpret_cast<float*>(dyn4);   // [FM][LDA], held mode
  float* ring = As + I::OWNED;                  // [RB_STAGES][STAGE]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lrg = lane >> 3, lx = lane & 7;
  const int wc = warp % WC;
  const int ar = 32 * (warp / WC) + lrg;        // first owned row
  const int cx = 8 * TN * wc + lx;              // first streamed row
  const int row0 = blockIdx.x * FM;
  const int t_first = blockIdx.y * tps;
  const int ntile = min((C + SN - 1) / SN, t_first + tps) - t_first;
  const int n_k = (D + RB_K - 1) / RB_K;        // slabs a tile

  // The A tile; its copies join the first stage's group.
  if (!DEEP) load_owned<VEC, FM>(As, LDA, A, row0, R, n_k, D);

  // The next slab to copy: tile it, slab ip, ring stage is_.
  int it = 0, ip = 0, is_ = 0;
  auto issue_next = [&]() {
    if (it < ntile && !(ROWS_SKIP & 4)) {
      const int col0 = (t_first + it) * SN;
      copy_logits_slab<VEC, SN>(ring + is_ * STAGE, B, col0, C, ip * RB_K, D,
                                VEC && col0 + SN <= C);
      if (DEEP)
        copy_owned_slab<VEC, FM>(ring + is_ * STAGE + SN * RB_K, A, row0, R,
                                 ip * RB_K, D);
    }
    if (++ip == n_k) ip = 0, ++it;
    if (++is_ == RB_STAGES) is_ = 0;
  };

  float acc[8][TN];           // logits of the current tile
  float m[8], s[8];           // running (max, sum) of the thread's rows
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = -INFINITY, s[i] = 0.f;

#pragma unroll
  for (int st = 0; st < RB_STAGES - 1; ++st) {
    issue_next();
    cp_commit();
  }
  // The slab to compute: tile ct, slab cp, ring stage cs.
  for (int ct = 0, cp = 0, cs = 0; ct < ntile;) {
    cp_wait<RB_STAGES - 2>();
    __syncthreads();          // stage cs has landed, the one before is free
    issue_next();
    cp_commit();
    const float* st = ring + cs * STAGE;
    if (cp == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    const float* a_k = As + ar * LDA + cp * RB_K;
#pragma unroll
    for (int q = 0; q < (ROWS_SKIP & 1 ? 0 : RB_K / 4); ++q) {
      float4 b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ld4(st + s_at(cx + 8 * j, q));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = DEEP ? ld4(st + SN * RB_K + s_at(ar + 4 * i, q))
                              : ld4(a_k + 4 * i * LDA + 4 * q);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
    if (cp == n_k - 1 && (ROWS_SKIP & 2)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i] += acc[i][j];
    } else if (cp == n_k - 1) {
      // The tile's logits into each row's (max, sum); columns past C are
      // skipped, and a thread may have none left in the last tile.  fmaxf
      // drops a NaN logit from the max, so it reaches the sum through its
      // exp; while every logit is -inf the exps are taken about 0.
      const int n0 = (t_first + ct) * SN + cx;
      if (n0 < C) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (n0 + 8 * j < C) mx = fmaxf(mx, acc[i][j]);
          const float mn = fmaxf(m[i], mx);
          const float base = mn == -INFINITY ? 0.f : mn;
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (n0 + 8 * j < C) t += expf(acc[i][j] - base);
          s[i] = s[i] * expf(m[i] - base) + t;
          m[i] = mn;
        }
      }
    }
    if (++cp == n_k) cp = 0, ++ct;
    if (++cs == RB_STAGES) cs = 0;
  }
  cp_wait<0>();

  // Combine once: the 8 lanes of a row group, then the WC warps of a row.
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      lse_merge(m[i], s[i], __shfl_xor_sync(0xffffffffu, m[i], o),
                __shfl_xor_sync(0xffffffffu, s[i], o));
  __syncthreads();            // every warp is done with the ring
  float* red_m = ring;        // [WC][FM]
  float* red_s = ring + WC * FM;
  if (lx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red_m[wc * FM + ar + 4 * i] = m[i];
      red_s[wc * FM + ar + 4 * i] = s[i];
    }
  }
  __syncthreads();
  if (tid < FM && row0 + tid < R) {
    float mm = -INFINITY, ss = 0.f;
#pragma unroll
    for (int w = 0; w < WC; ++w)
      lse_merge(mm, ss, red_m[w * FM + tid], red_s[w * FM + tid]);
    part_m[(size_t)blockIdx.y * R + row0 + tid] = mm;
    part_s[(size_t)blockIdx.y * R + row0 + tid] = ss;
  }
}

template <int DMAX, bool VEC, int FM, int SN, bool DEEP>
int launch_fwd_inst(const float* A, const float* B, float* part_m,
                    float* part_s, int R, int C, int D, int nsplit, int tps,
                    cudaStream_t stream) {
  const auto kernel = lse_fwd_kernel<DMAX, VEC, FM, SN, DEEP>;
  const size_t smem = FwdInst<DMAX, FM, SN, DEEP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + FM - 1) / FM, nsplit);
  kernel<<<grid, RB_T, smem, stream>>>(A, B, part_m, part_s, R, C, D, tps);
  return (int)cudaGetLastError();
}

// The forward's instances, (DMAX, FM, SN, DEEP) for each depth bound: 64
// owned rows by 128-row tiles (8 x 4 logits a thread), 32 by 256 at D <=
// 768 and in the deep mode (any D).
#define ROWS_FWD_INSTANCES(X)                                        \
  X(256, 64, 128, false) X(512, 64, 128, false) X(768, 32, 256, false) \
  X(768, 32, 256, true)

struct Launch {
  const float *O, *S, *lse, *g;
  float* part;
  int NO, NS, D, nsplit, tps;
  cudaStream_t stream;
};

template <int DMAX, bool VEC, bool OWN_COLS, int SN, bool DEEP = false>
int launch_inst(const Launch& a) {
  const auto kernel = lse_bwd_kernel<DMAX, VEC, OWN_COLS, SN, DEEP>;
  const size_t smem = Inst<DMAX, SN, DEEP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.NO + RB_M - 1) / RB_M, a.nsplit,
            DEEP ? (a.D + DMAX - 1) / DMAX : 1);
  kernel<<<grid, RB_T, smem, a.stream>>>(a.O, a.S, a.lse, a.g, a.part, a.NO,
                                         a.NS, a.D, a.tps);
  return (int)cudaGetLastError();
}

// ``dmax`` picks the instance (256, 512 or 768, at least D; 768 in the
// ``deep`` mode, any D); ``vec``: D % 4 == 0 and O, S 16-byte aligned.
template <bool OWN_COLS, int SN>
int launch(const Launch& a, int dmax, int deep, int vec) {
  if (deep) {
    if (dmax != 768) return (int)cudaErrorInvalidValue;
    return vec ? launch_inst<768, true, OWN_COLS, SN, true>(a)
               : launch_inst<768, false, OWN_COLS, SN, true>(a);
  }
  if (a.D > dmax) return (int)cudaErrorInvalidValue;
  switch (dmax) {
    case 256:
      return vec ? launch_inst<256, true, OWN_COLS, SN>(a)
                 : launch_inst<256, false, OWN_COLS, SN>(a);
    case 512:
      return vec ? launch_inst<512, true, OWN_COLS, SN>(a)
                 : launch_inst<512, false, OWN_COLS, SN>(a);
    case 768:
      return vec ? launch_inst<768, true, OWN_COLS, SN>(a)
                 : launch_inst<768, false, OWN_COLS, SN>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int SN>
size_t smem_bytes(int dmax, int deep) {
  if (deep) return dmax == 768 ? Inst<768, SN, true>::SMEM : 0;
  switch (dmax) {
    case 256: return Inst<256, SN>::SMEM;
    case 512: return Inst<512, SN>::SMEM;
    case 768: return Inst<768, SN>::SMEM;
    default: return 0;
  }
}

}  // namespace rows

}  // namespace

extern "C" {

// Dynamic shared memory of the forward instance (dmax, fm, sn, deep)
// (bytes), 0 for one that has no instance.
size_t milnce_fwd_smem(int dmax, int fm, int sn, int deep) {
#define ROWS_FWD_SMEM(DM, M, N, DP)                          \
  if (dmax == DM && fm == M && sn == N && (deep != 0) == DP) \
    return rows::FwdInst<DM, M, N, DP>::SMEM;
  ROWS_FWD_INSTANCES(ROWS_FWD_SMEM)
#undef ROWS_FWD_SMEM
  return 0;
}

// One forward launch for A (R, D), B (C, D): part_m, part_s (nsplit, R) on
// the instance (dmax, fm, sn, deep), D <= dmax unless ``deep``; ``vec``: D
// % 4 == 0 and A, B 16-byte aligned.
int milnce_lse_fwd(const float* A, const float* B, float* part_m,
                   float* part_s, int R, int C, int D, int dmax, int fm,
                   int sn, int deep, int nsplit, int tps, int vec,
                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (D > dmax && !deep) return (int)cudaErrorInvalidValue;
#define ROWS_FWD_LAUNCH(DM, M, N, DP)                                     \
  if (dmax == DM && fm == M && sn == N && (deep != 0) == DP)             \
    return vec ? rows::launch_fwd_inst<DM, true, M, N, DP>(              \
                     A, B, part_m, part_s, R, C, D, nsplit, tps, s)      \
               : rows::launch_fwd_inst<DM, false, M, N, DP>(             \
                     A, B, part_m, part_s, R, C, D, nsplit, tps, s);
  ROWS_FWD_INSTANCES(ROWS_FWD_LAUNCH)
#undef ROWS_FWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the backward instance for depths up to ``dmax``
// (gradient slabs of ``dmax`` when ``deep``) and streamed tiles of ``sn``
// rows (bytes), 0 for one that has no instance.  Both modes share it.
size_t milnce_bwd_rows_smem(int dmax, int sn, int deep) {
  return sn == 128 ? rows::smem_bytes<128>(dmax, deep)
                   : sn == 256 ? rows::smem_bytes<256>(dmax, deep) : 0;
}

// One backward launch for A (R, D), B (C, D): part (nsplit, R, D) of dA
// (own_cols 0, lse_bwd_rows, sn 256) or part (nsplit, C, D) of dB
// (own_cols 1, lse_bwd_cols, sn 128), lse and g of length R; ``deep``: the
// deep mode, gradient slabs of dmax = 768 over grid z.
int milnce_lse_bwd(const float* A, const float* B, const float* lse,
                   const float* g, float* part, int R, int C, int D,
                   int own_cols, int dmax, int sn, int deep, int nsplit,
                   int tps, int vec, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!own_cols) {
    if (sn != 256) return (int)cudaErrorInvalidValue;
    return rows::launch<false, 256>({A, B, lse, g, part, R, C, D, nsplit, tps,
                                     s}, dmax, deep, vec);
  }
  if (sn != 128) return (int)cudaErrorInvalidValue;
  return rows::launch<true, 128>({B, A, lse, g, part, C, R, D, nsplit, tps,
                                  s}, dmax, deep, vec);
}

}  // extern "C"
