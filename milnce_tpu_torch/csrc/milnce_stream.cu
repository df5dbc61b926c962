// Streamed MIL-NCE logsumexp kernels for Hopper (sm_90a), f32 arithmetic
// on f32 or bf16 gathered operands.
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
// Every kernel has two deep paths, and on both each logit is the same
// number: D is cut into nz = ceil(D / 512) depth parts of equal width kw, a
// multiple of RB_K (the last takes the remainder), each part's product is
// one chain of FMAs in depth order from 0, and the logit is the parts'
// chains summed in rank order, ((0 + P0) + P1) + ...  So the forward's and
// the backward's logits are equal bit for bit, exp(x - lse) cancels the
// forward's rounding of the dominant logit, and each chain is at most 512
// long (one chain over all of D drifts from float64 by ~|x| eps sqrt(D)).
//
// The cluster path, up to D = 4096, in every mode.  What bounds it:
// operations, 2 R C D FLOPs a forward and 4 R C D a backward launch
// (0.321 and 0.641 ms for a step's pair at the deep recipe, B 128, Bg
// 8192, K 5, D 1024).  Its design does each of those FMAs once: a
// thread-block cluster of nz blocks (grid z, cluster (1, 1, nz)) owns the
// same rows and walks the same streamed tiles, block z on part z.  A block
// holds its part of 32 owned rows in shared memory at the 512 instance's
// row stride (in the backward its part of the gradient in registers too,
// the 512 instance's layout) and streams only its part of S, in tiles of
// 256 rows (128 in lse_bwd_cols).  For each tile it computes the partial
// logits over its part, writes them to its own tile of shared memory, and
// after a cluster barrier reads the nz partials through distributed shared
// memory and sums them in rank order; a second barrier (arrive now, wait
// before the next tile's partials are written) keeps a partial tile until
// every block has read it.  The backward needs every logit of the tile in
// every block (each runs the product over its part); the forward sums only
// a share, and runs the (max, sum) of only that share, so that each block
// reads one tile's worth of partials whatever nz is.  The forward's tile
// is 32 x 256, as at D <= 768: 1-2 % faster than the held 512 instance's
// 64 x 128 (measured, PERF.md), which streams B's rows half as often but
// exchanges as many partials.
//
// The slab path, past D = 4096 (more than 8 blocks, the portable cluster's
// limit): the owned operand streamed beside the streamed one in each logits
// stage (an RB_K-deep slab of the owned rows from global memory and L2,
// swizzled as the streamed slab is), the parts' chains summed at the
// parts' ends.  The backward writes the gradient one depth slab of at most
// 768 at a time, one slab a grid z-index; each block recomputes the
// full-depth logits for its slab, so the logits FMAs grow by ceil(D / 768)
// and the product's are those of the 768 instance.  Both paths run at any
// D > 768 on request (the plan), for timing one against the other.
//
// Plain SIMT f32 FMAs: no tensor cores (wgmma would need TF32 or bf16,
// which the f32 reference does not allow), no TMA.
//
// The bf16 mode (a bf16 model, JAX model.dtype = bfloat16), in every path:
// the gathered operand B arrives bf16, as the TPU kernels take their chunks
// (milnce_pallas.py pads v_all / t_all uncast and upcasts each chunk in the
// kernel); A, lse and g stay f32.  Every kernel is a template on B's element
// type TB: a copy of B widens it to f32 on the way into shared memory (one
// 8-byte load of 4 elements, stored as a float4), so the tiles, swizzles,
// plans and products are the f32 mode's, and every sum stays f32 (no bf16
// tensor-core product: A is f32).  Each stage holds the numbers the f32
// mode's holds for B widened, and the FMAs run in the same order, so every
// output equals the f32 mode's on the widened B bit for bit.  Where B is
// streamed (lse_fwd, lse_bwd_rows) its fast copies (whole 4-element chunks
// inside C and D) are staged in registers, as cp.async stages the f32
// mode's: right after a stage's barrier each thread issues its 8-byte loads
// of the slab bound for the ring stage just freed (fetch_logits,
// fetch_product: 8 or 4 a logits slab, NB DMAX / 4 / RB_T a product slab),
// runs the current stage's FMAs while they are in flight, then widens and
// stores them (land_logits, land_product) before the next barrier.  The
// other copies stay synchronous: copy4 past the streamed rows (a ragged
// last tile) or past D (the last logits slab where D % 32 != 0; every copy
// where D % 4 != 0), and the bf16 owned B of lse_bwd_cols (load_owned once
// a block on the held and cluster paths, copy_owned_slab a stage on the
// slab path).
// lse_bwd_cols writes dB in bf16, each f32 sum rounded once
// (milnce_pallas.py rounds once a chunk), when its plan has one split; with
// more, the splits' f32 partials are summed and rounded by the wrapper.
// The cluster path's exchange of partial logits stays f32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

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

// The modes of every kernel (``mode`` of milnce_lse_fwd and milnce_lse_bwd):
// the owned rows held at full depth, the cluster path, the slab path.
enum Mode { HELD = 0, CLUSTER_PATH = 1, SLAB_PATH = 2 };
constexpr int CLUSTER_DMAX = 512;  // the widest depth part of a cluster block
constexpr int CLUSTER_MAX = 8;     // blocks in a portable cluster

// floats per row group of the weights tile of SN streamed rows
__host__ __device__ constexpr int w_rg(int sn) { return sn * 8 + 4; }

// SLAB: the owned operand streamed beside S in each logits stage (its slab
// after S's), the gradient written DMAX depths a grid z-index, and a
// (RB_M, SN) tile of the finished parts' sums of logits follows lse and g.
// CLUSTER: the O tile holds the block's depth part (at most DMAX), and a
// (RB_M, SN) tile of partial logits follows lse and g.
template <int DMAX, int SN, bool SLAB = false, bool CLUSTER = false>
struct Inst {
  static_assert(!(SLAB && CLUSTER), "one deep path at a time");
  static constexpr int DV = DMAX / 256;   // float4s of output per thread and row
  static constexpr int LDA = DMAX + 4;    // row stride of the O tile
  static constexpr int NB = DMAX <= 256 ? 32 : 8;  // rows of S a product slab
  static constexpr int LOGITS = (SN + (SLAB ? RB_M : 0)) * RB_K;
  static constexpr int STAGE =            // floats in one ring stage
      LOGITS > NB * DMAX ? LOGITS : NB * DMAX;
  static constexpr int OWNED = SLAB ? 0 : RB_M * LDA;  // the held O tile
  static constexpr int PART =             // partial or finished logits
      SLAB || CLUSTER ? RB_M * SN : 0;
  // the O tile, the weights tile, the ring, lse and g of the block's rows
  // (read by lse_bwd_rows only), the partial logits
  static constexpr size_t SMEM = sizeof(float) *
      ((size_t)OWNED + 4 * w_rg(SN) + RB_STAGES * STAGE + 2 * RB_M + PART);
};

// The cluster path's barrier in two halves: arrive (release: this block's
// shared-memory writes and reads before it are done) and wait (acquire:
// every block of the cluster has arrived).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

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

// The bf16 element type of a gathered operand (T = bf16 below): widened to
// f32 when it is copied into shared memory, so every tile, swizzle and
// product downstream is the f32 one.
using bf16 = __nv_bfloat16;

// Four bf16 bits (two 32-bit words) widened to four floats.
__device__ __forceinline__ float4 widen4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Four bf16 elements at p (8 bytes) as their bits, and those bits
// widened into four floats at 16-byte aligned shared dst.
__device__ __forceinline__ uint2 ldg8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ void st_widened(float* dst, uint2 u) {
  *reinterpret_cast<float4*>(dst) = widen4(u);
}

__device__ __forceinline__ float widen1(const bf16* p) {
  return __uint_as_float(
      (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}

// A gradient's f32 sums stored as the output element type: f32 as they are,
// bf16 each rounded once to nearest.  put4 writes four at a 4-element
// aligned ``p`` (one 16-byte store of f32, one 8-byte store of bf16).
__device__ __forceinline__ void put1(float* p, float x) { *p = x; }

__device__ __forceinline__ void put1(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void put4(float* p, float x0, float x1, float x2,
                                     float x3) {
  *reinterpret_cast<float4*>(p) = make_float4(x0, x1, x2, x3);
}

__device__ __forceinline__ void put4(bf16* p, float x0, float x1, float x2,
                                     float x3) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x2, x3);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// Four whole elements at ``src`` into 16-byte aligned shared ``dst``: f32
// by one 16-byte cp.async.cg; bf16 by one 8-byte load, widened and stored
// (a synchronous copy: the stage it fills is read after the next barrier).
__device__ __forceinline__ void copy4_fast(float* dst, const float* src) {
  cp16(dst, src);
}

__device__ __forceinline__ void copy4_fast(float* dst, const bf16* src) {
  st_widened(dst, ldg8(src));
}

// Four elements of row ``row`` of the row-major (nrows, D) matrix ``m``, at
// depths k .. k + 3, as floats into 16-byte aligned shared ``dst``; zeros
// past the last row and past D.  VEC (D % 4 == 0 and ``m`` aligned to four
// elements' bytes): copy4_fast; otherwise element by element, zero-filled
// past D (f32: four 4-byte cp.async copies).
template <bool VEC, typename T>
__device__ __forceinline__ void copy4(float* dst, const T* __restrict__ m,
                                      int row, int nrows, int k, int D) {
  if (row >= nrows || k >= D) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const T* src = m + (size_t)row * D + k;
  if (VEC) {
    copy4_fast(dst, src);
    return;
  }
  if constexpr (std::is_same_v<T, bf16>) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = k + e < D ? widen1(src + e) : 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = k + e < D;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(dst + e)), "l"(ok ? src + e : m),
                   "r"(ok ? 4 : 0) : "memory");
    }
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

// The slab paths' logits, summed as the cluster path sums them: at the end
// of a depth part (of pk slabs; ``kp`` counts the part's slabs done, ``cp``
// the tile's, of n_k) the thread's chains acc (MI rows of 4 logits) are
// added to its float4s i RB_T + tid of the finished parts' tile Ps, ((0 +
// P0) + P1) + ..., and restart at 0; at the tile's last slab acc takes the
// sum, the tile's logits.  Ps, not registers: the backward's gradient
// leaves none.
template <int MI>
__device__ __forceinline__ void add_part(float (&acc)[MI][4], float4* Ps,
                                         int& kp, int cp, int n_k, int pk) {
  const bool last = cp == n_k - 1;
  if (++kp < pk && !last) return;
  kp = 0;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    float4 t = cp < pk ? make_float4(0.f, 0.f, 0.f, 0.f) : Ps[i * RB_T + tid];
    t.x += acc[i][0], t.y += acc[i][1];
    t.z += acc[i][2], t.w += acc[i][3];
    if (last) {
      acc[i][0] = t.x, acc[i][1] = t.y;
      acc[i][2] = t.z, acc[i][3] = t.w;
    } else {
      Ps[i * RB_T + tid] = t;
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
  }
}

// The block's owned tile: rows row0 .. row0 + M - 1 of O, depths k0 ..
// k0 + n_k RB_K - 1, into Os (row stride LDA), zero past NO and past D.
template <bool VEC, int M, typename T>
__device__ __forceinline__ void load_owned(float* Os, int LDA,
                                           const T* __restrict__ O,
                                           int row0, int NO, int n_k, int D,
                                           int k0 = 0) {
  const int a4 = n_k * (RB_K / 4);
  for (int l = threadIdx.x; l < M * a4; l += RB_T) {
    const int r = l / a4, q = l - r * a4;
    copy4<VEC>(Os + r * LDA + 4 * q, O, row0 + r, NO, k0 + 4 * q, D);
  }
}

// The deep mode's slab of the owned rows: O[row0 : +M, k0 : +RB_K] into st,
// swizzled (s_at) as the streamed slab is, zero past NO and D.
template <bool VEC, int M, typename T>
__device__ __forceinline__ void copy_owned_slab(float* st,
                                                const T* __restrict__ O,
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
template <bool VEC, int SN, typename T>
__device__ __forceinline__ void copy_logits_slab(float* st,
                                                 const T* __restrict__ S,
                                                 int col0, int NS, int k0,
                                                 int D, bool fast) {
  constexpr int Q = RB_K / 4;
  const int tid = threadIdx.x;
  if (fast && k0 + RB_K <= D) {
    const T* src = S + (size_t)(col0 + tid / Q) * D + k0 + 4 * (tid % Q);
#pragma unroll
    for (int m = 0; m < SN * Q / RB_T; ++m)
      copy4_fast(st + s_at(tid / Q + m * (RB_T / Q), tid % Q),
                 src + (size_t)m * (RB_T / Q) * D);
  } else {
#pragma unroll
    for (int m = 0; m < SN * Q / RB_T; ++m) {
      const int l = tid + m * RB_T, c = l / Q, q = l % Q;
      copy4<VEC>(st + s_at(c, q), S, col0 + c, NS, k0 + 4 * q, D);
    }
  }
}

// The fast copies of a bf16 streamed operand, in two halves: fetch issues
// the thread's 8-byte loads of a slab into registers r right after the
// stage barrier, land widens them and stores them into the slab's ring
// stage after the current stage's FMAs, which run while the loads are in
// flight.  Each lands where copy4_fast would have stored it.
// A logits slab, S[col0 : +SN, k0 : +RB_K], every chunk inside NS and D.
template <int SN, int N>
__device__ __forceinline__ void fetch_logits(uint2 (&r)[N],
                                             const bf16* __restrict__ S,
                                             int col0, int k0, int D) {
  constexpr int Q = RB_K / 4;
  const int tid = threadIdx.x;
  const bf16* src = S + (size_t)(col0 + tid / Q) * D + k0 + 4 * (tid % Q);
#pragma unroll
  for (int m = 0; m < SN * Q / RB_T; ++m)
    r[m] = ldg8(src + (size_t)m * (RB_T / Q) * D);
}

template <int SN, int N>
__device__ __forceinline__ void land_logits(const uint2 (&r)[N], float* st) {
  constexpr int Q = RB_K / 4;
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < SN * Q / RB_T; ++m)
    st_widened(st + s_at(tid / Q + m * (RB_T / Q), tid % Q), r[m]);
}

// A product slab, S[n0 : +NB, z0 : z0 + 4 d4], every row inside NS, at
// row stride DMAX in the stage.
template <int DMAX, int NB, int N>
__device__ __forceinline__ void fetch_product(uint2 (&r)[N],
                                              const bf16* __restrict__ S,
                                              int n0, int z0, int d4, int D) {
  constexpr int Q = DMAX / 4;
#pragma unroll
  for (int m = 0; m < NB * Q / RB_T; ++m) {
    const int l = threadIdx.x + m * RB_T, n = l / Q, q = l % Q;
    if (q < d4) r[m] = ldg8(S + (size_t)(n0 + n) * D + z0 + 4 * q);
  }
}

template <int DMAX, int NB, int N>
__device__ __forceinline__ void land_product(const uint2 (&r)[N], float* st,
                                             int d4) {
  constexpr int Q = DMAX / 4;
#pragma unroll
  for (int m = 0; m < NB * Q / RB_T; ++m) {
    const int l = threadIdx.x + m * RB_T, n = l / Q, q = l % Q;
    if (q < d4) st_widened(st + n * DMAX + 4 * q, r[m]);
  }
}

// What a thread's registers hold between fetch and land.
enum Staged { NOTHING = 0, LOGITS_SLAB = 1, PRODUCT_SLAB = 2 };

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
// SLAB: the O slab of each logits stage sits at SN * RB_K in the stage,
// read through s_at; the block's gradient covers depths z0 .. z0 + DZ - 1 of
// D, z0 = DMAX blockIdx.z; the logits are the chains of the depth parts of
// kw depths summed in rank order (add_part).  CLUSTER: block z of the
// cluster holds and computes depths z0 .. z0 + DZ - 1, z0 = kw blockIdx.z
// (kw, the part width, a multiple of RB_K); thread tid writes its partial
// logits acc[i] to float4 i RB_T + tid of its partial tile and reads the
// same float4 of every block's tile.
//
// TB, the gathered operand's element type (float or bf16): the streamed S
// in lse_bwd_rows, the owned O in lse_bwd_cols, widened to f32 as it is
// copied (copy4); every product and sum stays f32.  ``part`` is f32 but
// for lse_bwd_cols with TB = bf16 and one split (gridDim.y 1), where it is
// dB in bf16, each f32 sum rounded once.
template <int DMAX, bool VEC, bool OWN_COLS, int SN, bool SLAB,
          bool CLUSTER = false, typename TB = float>
__global__ void __launch_bounds__(RB_T, 1)
lse_bwd_kernel(const std::conditional_t<OWN_COLS, TB, float>* __restrict__ O,
               const std::conditional_t<OWN_COLS, float, TB>* __restrict__ S,
               const float* __restrict__ lse, const float* __restrict__ g,
               void* __restrict__ part, int NO, int NS, int D, int tps,
               int kw, float* __restrict__ sums) {
  using I = Inst<DMAX, SN, SLAB, CLUSTER>;
  constexpr int DV = I::DV, LDA = I::LDA, NB = I::NB;
  constexpr int XL = SN / 32, RG = 32 / XL, MI = RB_M / RG;
  extern __shared__ float4 dyn4[];
  float* Os = reinterpret_cast<float*>(dyn4);   // [RB_M][LDA], not SLAB
  float* Ws = Os + I::OWNED;                    // [4][w_rg(SN)], w_at
  float* ring = Ws + 4 * w_rg(SN);              // [RB_STAGES][STAGE]
  float* ls = ring + RB_STAGES * I::STAGE;      // [RB_M]
  float* gs = ls + RB_M;                        // [RB_M]
  float4* Ps = reinterpret_cast<float4*>(gs + RB_M);  // [MI][RB_T], deep
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, x = lane & 7;       // the product's layout
  const int lrg = lane / XL;                    // the logits' layout
  const int cx = (SN / 8) * warp + lane % XL;   // first logits column
  const int dx = 4 * (8 * warp + x);            // first output depth
  const int row0 = blockIdx.x * RB_M;
  const int t_first = blockIdx.y * tps;
  const int ntile = min((NS + SN - 1) / SN, t_first + tps) - t_first;
  // the gradient's depths z0 .. z0 + DZ - 1; the logits' kz .. kz + n_k RB_K
  const int z0 = SLAB ? DMAX * blockIdx.z : CLUSTER ? kw * blockIdx.z : 0;
  const int DZ = SLAB ? min(DMAX, D - z0) : CLUSTER ? min(kw, D - z0) : D;
  const int kz = CLUSTER ? z0 : 0;
  const int n_k = ((CLUSTER ? DZ : D) + RB_K - 1) / RB_K;  // logits slabs
  const int per_tile = n_k + SN / NB;           // and product slabs a tile
  const int pk = SLAB ? kw / RB_K : n_k;        // logits slabs a depth part
  const int d4 = (DZ + 3) / 4;

  if (!OWN_COLS && tid < RB_M) {
    const int r = row0 + tid;
    ls[tid] = r < NO ? lse[r] : 0.f;
    gs[tid] = r < NO ? g[r] : 0.f;
  }
  // The O tile; its copies join the first stage's group.
  if (!SLAB) load_owned<VEC, RB_M>(Os, LDA, O, row0, NO, n_k, D, kz);

  // A bf16 S (lse_bwd_rows): its fast copies staged in registers (fetch
  // in issue_next, land after the stage's FMAs).
  constexpr bool STAGED = !OWN_COLS && std::is_same_v<TB, bf16>;
  constexpr int LQ = SN * (RB_K / 4) / RB_T, PQ = NB * (DMAX / 4) / RB_T;
  uint2 staged[STAGED ? (LQ > PQ ? LQ : PQ) : 1];
  int staged_what = NOTHING;
  float* staged_st = ring;

  // The next slab to copy: tile it, part ip, ring stage is_.
  int it = 0, ip = 0, is_ = 0;
  auto issue_next = [&]() {
    if (it < ntile && !(ROWS_SKIP & 4)) {
      float* st = ring + is_ * I::STAGE;
      const int col0 = (t_first + it) * SN;
      // whole 16-byte chunks inside NS and D: copies without checks
      const bool fast = VEC && col0 + SN <= NS;
      if (ip < n_k) {
        const int k0 = kz + ip * RB_K;
        if (STAGED && fast && k0 + RB_K <= D) {
          if constexpr (STAGED) fetch_logits<SN>(staged, S, col0, k0, D);
          staged_what = LOGITS_SLAB, staged_st = st;
        } else {
          copy_logits_slab<VEC, SN>(st, S, col0, NS, k0, D, !STAGED && fast);
        }
        if (SLAB)
          copy_owned_slab<VEC, RB_M>(st + SN * RB_K, O, row0, NO, ip * RB_K,
                                     D);
      } else {                // S[col0 + n0 : +NB, z0 : z0 + DZ], stride DMAX
        const int n0 = (ip - n_k) * NB;
        constexpr int Q = DMAX / 4;
        if (STAGED && fast) {
          if constexpr (STAGED)
            fetch_product<DMAX, NB>(staged, S, col0 + n0, z0, d4, D);
          staged_what = PRODUCT_SLAB, staged_st = st;
        } else {
#pragma unroll
          for (int m = 0; m < NB * Q / RB_T; ++m) {
            const int l = tid + m * RB_T, n = l / Q, q = l % Q;
            if (q < d4) {
              float* dst = st + n * DMAX + 4 * q;
              if (!STAGED && fast)
                copy4_fast(dst, S + (size_t)(col0 + n0 + n) * D + z0 + 4 * q);
              else
                copy4<VEC>(dst, S, col0 + n0 + n, NS, z0 + 4 * q, D);
            }
          }
        }
      }
    }
    if (++ip == per_tile) ip = 0, ++it;
    if (++is_ == RB_STAGES) is_ = 0;
  };
  // The staged slab into its stage (read after the next barrier).
  auto land = [&]() {
    if constexpr (STAGED) {
      if (staged_what == LOGITS_SLAB)
        land_logits<SN>(staged, staged_st);
      else if (staged_what == PRODUCT_SLAB)
        land_product<DMAX, NB>(staged, staged_st, d4);
      staged_what = NOTHING;
    }
  };

  float acc[MI][4];           // logits of the current tile
  float psum[MI] = {};        // CLUSTER, lse_bwd_rows: sum_j p_rj a row
  float out[8][4 * DV];       // the gradient
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4 * DV; ++e) out[i][e] = 0.f;

#pragma unroll
  for (int s = 0; s < RB_STAGES - 1; ++s) {
    issue_next();
    land();
    cp_commit();
  }
  // The slab to compute: tile ct, part cp, ring stage cs; kp, SLAB: the
  // logits slabs done of the current depth part.
  for (int ct = 0, cp = 0, cs = 0, kp = 0; ct < ntile;) {
    cp_wait<RB_STAGES - 2>();
    __syncthreads();          // stage cs has landed, the one before is free
    issue_next();             // into the one before (STAGED: fetched)
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
          const float4 a = SLAB ? ld4(st + SN * RB_K + s_at(lrg + RG * i, q))
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
      if constexpr (SLAB) add_part(acc, Ps, kp, cp, n_k, pk);
      if constexpr (CLUSTER) {
        if (cp == n_k - 1) {  // the cluster's logits, summed in rank order
          if (ct > 0) cluster_wait();  // every block read the last tile's
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            Ps[i * RB_T + tid] =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
          }
          cluster_arrive();
          cluster_wait();
          const auto cluster = cooperative_groups::this_cluster();
          for (int z = 0; z < (int)gridDim.z; ++z) {
            const float4* src = cluster.map_shared_rank(Ps, z);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
              const float4 p = src[i * RB_T + tid];
              acc[i][0] += p.x, acc[i][1] += p.y;
              acc[i][2] += p.z, acc[i][3] += p.w;
            }
          }
          cluster_arrive();     // waited for before the next tile's partials
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
            if constexpr (CLUSTER && !OWN_COLS) {  // p_rj, and its row sum
              const float p = (row0 + r < NO && n_ok)
                                  ? expf(acc[i][j] - ls[r]) : 0.f;
              psum[i] += p;
              w[i] = (row0 + r < NO && n_ok) ? p * gs[r] : 0.f;
            } else {
              w[i] = (row0 + r < NO && n_ok)
                         ? (OWN_COLS ? expf(acc[i][j] - ln) * gn
                                     : expf(acc[i][j] - ls[r]) * gs[r])
                         : 0.f;
            }
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
    land();                   // STAGED: the fetched slab, under this one
    if (++cp == per_tile) cp = 0, ++ct;
    if (++cs == RB_STAGES) cs = 0;
  }
  cp_wait<0>();
  // no block leaves while another may still read its partial tile
  if constexpr (CLUSTER)
    if (ntile > 0) cluster_wait();
  // lse_bwd_rows on the cluster path: sums[y]_r = sum_j p_rj over the
  // split's columns (the blocks of a cluster hold the same p; block 0
  // writes), so that the caller can divide the weights by their row sum
  if constexpr (CLUSTER && !OWN_COLS) {
    if (sums != nullptr) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int o = 1; o < XL; o <<= 1)   // the XL lanes of a row group
          psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], o);
      __syncthreads();        // every warp is done with the ring
      float* red = ring;      // [RB_T / 32][RB_M]
      if (lane % XL == 0) {
#pragma unroll
        for (int i = 0; i < MI; ++i) red[warp * RB_M + lrg + RG * i] = psum[i];
      }
      __syncthreads();
      if (blockIdx.z == 0 && tid < RB_M && row0 + tid < NO) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < RB_T / 32; ++w) t += red[w * RB_M + tid];
        sums[(size_t)blockIdx.y * NO + row0 + tid] = t;
      }
    }
  }

  // the block's rows of the gradient into ``rows`` ((NO, D), f32 or bf16),
  // each f32 sum stored once: dB as bf16 where B is bf16 and one split
  // covers its columns (lse_bwd_cols), else this split's f32 partial
  const auto store = [&](auto* rows) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + rg + 4 * i;
      if (r >= NO) continue;
      auto* dst = rows + (size_t)r * D + z0;
#pragma unroll
      for (int v = 0; v < DV; ++v) {
        const int d = dx + 256 * v;
        if ((D & 3) == 0 && d + 4 <= DZ) {
          put4(dst + d, out[i][4 * v], out[i][4 * v + 1], out[i][4 * v + 2],
               out[i][4 * v + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (d + e < DZ) put1(dst + d + e, out[i][4 * v + e]);
        }
      }
    }
  };
  if constexpr (OWN_COLS && std::is_same_v<TB, bf16>) {
    if (gridDim.y == 1) {
      store(static_cast<bf16*>(part));
      return;
    }
  }
  store(static_cast<float*>(part) + (size_t)blockIdx.y * NO * D);
}

// ------------------------------------------------------------------ lse_fwd
// The forward mode: A (R, D) owned, B (C, D) streamed; the kernel writes
// part_m, part_s (nsplit, R), the (max, sum) of exp(A_r . B_j - max) over
// the streamed tiles of split y.
//
// grid (ceil(R / FM), nsplit, nz), RB_T threads, one block per SM.  The
// block's (FM, D) A tile sits in shared memory for its whole life; it walks
// the streamed tiles [y tps, (y + 1) tps) of its split, SN rows of B each,
// through the backward's ring of RB_STAGES stages of RB_K-deep slabs, one
// barrier per stage.  Lane l of warp w is (lrg, lx) = (l / 8, l % 8), and
// the warps form (FM / 32) x WC: warp (wr, wc) = (w / WC, w % WC) owns rows
// 32 wr + lrg + 4 i (i < 8) and streamed rows 8 TN wc + lx + 8 j (j < TN)
// of each tile.  A warp's 16-byte loads touch 4 rows of the A tile (LDA is
// 4 mod 32: 4 distinct bank groups) and 8 neighbouring rows of B (s_at: 8
// distinct bank groups), each one wavefront broadcast over the warp.
// SLAB: no A tile; each stage holds B's slab, then A's (FM rows, s_at); the
// logits are the chains of the depth parts of kw depths summed in rank
// order (add_part).  CLUSTER: clusters of (1, 1, nz) blocks; block z
// holds depths kw z .. kw z + DZ - 1 of its FM rows and streams the same
// depths of B; thread tid writes its partial logits acc[i] to float4 i RB_T
// + tid of its (FM, SN) partial tile, and after the cluster barrier sums
// the same float4 of every block's tile in rank order for its rows i with
// i % nz == z, whose (max, sum) only this block runs and writes.
template <int DMAX, int FM, int SN, int MODE>
struct FwdInst {
  static constexpr int LDA = DMAX + 4;            // row stride of the A tile
  static constexpr int TN = FM * SN / (8 * RB_T); // logits columns a thread
  static constexpr int WC = SN / (8 * TN);        // warps across a tile
  static_assert(FM % 32 == 0 && (FM / 32) * WC * 32 == RB_T,
                "the warps must tile the block's logits");
  static_assert(MODE == HELD || TN == 4,
                "a thread's partial logits are float4s of one row");
  static_assert(MODE != CLUSTER_PATH || DMAX == CLUSTER_DMAX,
                "a cluster block's part fits the A tile");
  static constexpr int OWNED = MODE == SLAB_PATH ? 0 : FM * LDA;
  static constexpr int STAGE = (SN + (MODE == SLAB_PATH ? FM : 0)) * RB_K;
  static constexpr int PART = MODE == HELD ? 0 : FM * SN;
  // the A tile, the ring (the warps' partials reuse it at the end) and the
  // partial (CLUSTER) or finished parts' (SLAB) logits
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)OWNED + RB_STAGES * STAGE + PART);
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

// TB, B's element type (float or bf16), widened to f32 as it is copied.
template <int DMAX, bool VEC, int FM, int SN, int MODE, typename TB = float>
__global__ void __launch_bounds__(RB_T, 1)
lse_fwd_kernel(const float* __restrict__ A, const TB* __restrict__ B,
               float* __restrict__ part_m, float* __restrict__ part_s, int R,
               int C, int D, int tps, int kw) {
  using I = FwdInst<DMAX, FM, SN, MODE>;
  constexpr bool SLAB = MODE == SLAB_PATH, CLUSTER = MODE == CLUSTER_PATH;
  constexpr int LDA = I::LDA, TN = I::TN, WC = I::WC;
  constexpr int STAGE = I::STAGE;
  extern __shared__ float4 dyn4[];
  float* As = reinterpret_cast<float*>(dyn4);   // [FM][LDA], not SLAB
  float* ring = As + I::OWNED;                  // [RB_STAGES][STAGE]
  float4* Ps = reinterpret_cast<float4*>(ring + RB_STAGES * STAGE);  // deep
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lrg = lane >> 3, lx = lane & 7;
  const int wc = warp % WC;
  const int ar = 32 * (warp / WC) + lrg;        // first owned row
  const int cx = 8 * TN * wc + lx;              // first streamed row
  const int row0 = blockIdx.x * FM;
  const int t_first = blockIdx.y * tps;
  const int ntile = min((C + SN - 1) / SN, t_first + tps) - t_first;
  // the logits' depths kz .. kz + n_k RB_K - 1: CLUSTER, the block's part
  const int kz = CLUSTER ? kw * blockIdx.z : 0;
  const int n_k = ((CLUSTER ? min(kw, D - kz) : D) + RB_K - 1) / RB_K;
  const int pk = SLAB ? kw / RB_K : n_k;        // slabs a depth part
  // CLUSTER: this block's rows of the thread, i % nz == z (all elsewhere)
  const int nz = gridDim.z, zr = blockIdx.z;

  // The A tile; its copies join the first stage's group.
  if (!SLAB) load_owned<VEC, FM>(As, LDA, A, row0, R, n_k, D, kz);

  // A bf16 B: its fast copies staged in registers (fetch in issue_next,
  // land after the stage's FMAs).
  constexpr bool STAGED = std::is_same_v<TB, bf16>;
  uint2 staged[STAGED ? SN * (RB_K / 4) / RB_T : 1];
  bool fetched = false;
  float* staged_st = ring;

  // The next slab to copy: tile it, slab ip, ring stage is_.
  int it = 0, ip = 0, is_ = 0;
  auto issue_next = [&]() {
    if (it < ntile && !(ROWS_SKIP & 4)) {
      float* st = ring + is_ * STAGE;
      const int col0 = (t_first + it) * SN, k0 = kz + ip * RB_K;
      const bool fast = VEC && col0 + SN <= C;
      if (STAGED && fast && k0 + RB_K <= D) {
        if constexpr (STAGED) fetch_logits<SN>(staged, B, col0, k0, D);
        fetched = true, staged_st = st;
      } else {
        copy_logits_slab<VEC, SN>(st, B, col0, C, k0, D, !STAGED && fast);
      }
      if (SLAB)
        copy_owned_slab<VEC, FM>(st + SN * RB_K, A, row0, R, ip * RB_K, D);
    }
    if (++ip == n_k) ip = 0, ++it;
    if (++is_ == RB_STAGES) is_ = 0;
  };
  // The staged slab into its stage (read after the next barrier).
  auto land = [&]() {
    if constexpr (STAGED) {
      if (fetched) land_logits<SN>(staged, staged_st);
      fetched = false;
    }
  };

  float acc[8][TN];           // logits of the current tile
  float m[8], s[8];           // running (max, sum) of the thread's rows
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = -INFINITY, s[i] = 0.f;

#pragma unroll
  for (int st = 0; st < RB_STAGES - 1; ++st) {
    issue_next();
    land();
    cp_commit();
  }
  // The slab to compute: tile ct, slab cp, ring stage cs; kp, SLAB: the
  // slabs done of the current depth part.
  for (int ct = 0, cp = 0, cs = 0, kp = 0; ct < ntile;) {
    cp_wait<RB_STAGES - 2>();
    __syncthreads();          // stage cs has landed, the one before is free
    issue_next();             // into the one before (STAGED: fetched)
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
        const float4 a = SLAB ? ld4(st + SN * RB_K + s_at(ar + 4 * i, q))
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
    if constexpr (SLAB) add_part(acc, Ps, kp, cp, n_k, pk);
    if constexpr (CLUSTER) {
      if (cp == n_k - 1) {    // the cluster's logits, summed in rank order
        if (ct > 0) cluster_wait();  // every block read the last tile's
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          Ps[i * RB_T + tid] =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        }
        cluster_arrive();
        cluster_wait();
        const auto cluster = cooperative_groups::this_cluster();
        for (int z = 0; z < nz; ++z) {
          const float4* src = cluster.map_shared_rank(Ps, z);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i % nz != zr) continue;
            const float4 p = src[i * RB_T + tid];
            acc[i][0] += p.x, acc[i][1] += p.y;
            acc[i][2] += p.z, acc[i][3] += p.w;
          }
        }
        cluster_arrive();     // waited for before the next tile's partials
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
          if (CLUSTER && i % nz != zr) continue;
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
    land();                   // STAGED: the fetched slab, under this one
    if (++cp == n_k) cp = 0, ++ct;
    if (++cs == RB_STAGES) cs = 0;
  }
  cp_wait<0>();
  // no block leaves while another may still read its partial tile
  if constexpr (CLUSTER)
    if (ntile > 0) cluster_wait();

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
  // row tid is row i = (tid % 32) / 4 of its threads: CLUSTER, this block's
  // if i % nz == z
  if (tid < FM && row0 + tid < R &&
      (!CLUSTER || ((tid & 31) >> 2) % nz == zr)) {
    float mm = -INFINITY, ss = 0.f;
#pragma unroll
    for (int w = 0; w < WC; ++w)
      lse_merge(mm, ss, red_m[w * FM + tid], red_s[w * FM + tid]);
    part_m[(size_t)blockIdx.y * R + row0 + tid] = mm;
    part_s[(size_t)blockIdx.y * R + row0 + tid] = ss;
  }
}

// The cluster path's launch configuration: ``grid``, its z the cluster's
// nz blocks, clusters of (1, 1, nz); ``attr`` holds the cluster's
// dimensions.
cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(RB_T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of ``kernel`` (its shared memory ``smem`` opted in to)
// of nz blocks the card holds at once (cudaOccupancyMaxActiveClusters), or
// minus a CUDA error.
int max_clusters(const void* kernel, size_t smem, int nz) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(1, 1, nz), smem, 0,
                                                &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Whether the deep paths take parts of kw depths at depth D: a multiple of
// RB_K, and on the cluster path at most CLUSTER_DMAX wide and at most
// CLUSTER_MAX of them.
bool parts_ok(int mode, int D, int kw) {
  if (mode == HELD) return true;
  if (kw < RB_K || kw % RB_K) return false;
  return mode != CLUSTER_PATH ||
         (kw <= CLUSTER_DMAX && (D + kw - 1) / kw <= CLUSTER_MAX);
}

struct FwdLaunch {
  const float* A;
  const void* B;              // float or bf16 (TB)
  float *part_m, *part_s;
  int R, C, D, nsplit, tps, kw;
  cudaStream_t stream;
};

// One forward launch; the cluster path's (cudaLaunchKernelEx) returns its
// error if refused: nothing falls back to the slab path.
template <int DMAX, bool VEC, int FM, int SN, int MODE, typename TB>
int launch_fwd_inst(const FwdLaunch& a) {
  const auto kernel = lse_fwd_kernel<DMAX, VEC, FM, SN, MODE, TB>;
  const size_t smem = FwdInst<DMAX, FM, SN, MODE>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nz = MODE == CLUSTER_PATH ? (a.D + a.kw - 1) / a.kw : 1;
  const dim3 grid((a.R + FM - 1) / FM, a.nsplit, nz);
  const TB* B = static_cast<const TB*>(a.B);
  if (MODE == CLUSTER_PATH) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(grid, smem, a.stream, &attr);
    err = cudaLaunchKernelEx(&cfg, kernel, a.A, B, a.part_m, a.part_s, a.R,
                             a.C, a.D, a.tps, a.kw);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<grid, RB_T, smem, a.stream>>>(a.A, B, a.part_m, a.part_s, a.R,
                                           a.C, a.D, a.tps, a.kw);
  }
  return (int)cudaGetLastError();
}

// The forward's instances, (DMAX, FM, SN, MODE) for each depth bound: 64
// owned rows by 128-row tiles (8 x 4 logits a thread), 32 by 256 at D <=
// 768, on the slab path (any D) and on the cluster path (parts of at most
// 512; 1-2 % faster there than 64 by 128, PERF.md).  Each for B in f32
// and in bf16.
#define ROWS_FWD_INSTANCES(X)                                              \
  X(256, 64, 128, HELD) X(512, 64, 128, HELD) X(768, 32, 256, HELD)        \
  X(768, 32, 256, SLAB_PATH) X(512, 32, 256, CLUSTER_PATH)

struct Launch {
  const void *O, *S;          // the gathered one (O in cols, S in rows) TB
  const float *lse, *g;
  void* part;                 // f32, or dB in bf16 (bf16 B, one split)
  float* sums;
  int NO, NS, D, nsplit, tps, kw;
  cudaStream_t stream;
};

// The kernel's operand pointers for mode OWN_COLS and element type TB.
template <bool OWN_COLS, typename TB>
using OwnedT = std::conditional_t<OWN_COLS, TB, float>;
template <bool OWN_COLS, typename TB>
using StreamedT = std::conditional_t<OWN_COLS, float, TB>;

template <int DMAX, bool VEC, bool OWN_COLS, int SN, bool SLAB, typename TB>
int launch_inst(const Launch& a) {
  const auto kernel = lse_bwd_kernel<DMAX, VEC, OWN_COLS, SN, SLAB, false, TB>;
  const size_t smem = Inst<DMAX, SN, SLAB>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.NO + RB_M - 1) / RB_M, a.nsplit,
            SLAB ? (a.D + DMAX - 1) / DMAX : 1);
  kernel<<<grid, RB_T, smem, a.stream>>>(
      static_cast<const OwnedT<OWN_COLS, TB>*>(a.O),
      static_cast<const StreamedT<OWN_COLS, TB>*>(a.S), a.lse, a.g, a.part,
      a.NO, a.NS, a.D, a.tps, a.kw, nullptr);
  return (int)cudaGetLastError();
}

// The cluster path: parts of kw depths, nz = ceil(D / kw) of them (checked
// by parts_ok).  A refused launch returns its error; nothing falls back to
// the slab path.
template <bool VEC, bool OWN_COLS, int SN, typename TB>
int launch_cluster(const Launch& a) {
  const auto kernel =
      lse_bwd_kernel<CLUSTER_DMAX, VEC, OWN_COLS, SN, false, true, TB>;
  const size_t smem = Inst<CLUSTER_DMAX, SN, false, true>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3((a.NO + RB_M - 1) / RB_M, a.nsplit, (a.D + a.kw - 1) / a.kw), smem,
      a.stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const OwnedT<OWN_COLS, TB>*>(a.O),
                           static_cast<const StreamedT<OWN_COLS, TB>*>(a.S),
                           a.lse, a.g, a.part, a.NO, a.NS, a.D, a.tps, a.kw,
                           a.sums);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ``deep`` picks the mode; ``dmax`` the held instance (256, 512 or 768, at
// least D), 512 on the cluster path, 768 on the slab path (any D); ``vec``:
// D % 4 == 0 and O, S aligned to four elements' bytes.
template <bool OWN_COLS, int SN, typename TB>
int launch(const Launch& a, int dmax, int deep, int vec) {
  if (deep == CLUSTER_PATH) {
    if (dmax != CLUSTER_DMAX) return (int)cudaErrorInvalidValue;
    return vec ? launch_cluster<true, OWN_COLS, SN, TB>(a)
               : launch_cluster<false, OWN_COLS, SN, TB>(a);
  }
  if (deep == SLAB_PATH) {
    if (dmax != 768) return (int)cudaErrorInvalidValue;
    return vec ? launch_inst<768, true, OWN_COLS, SN, true, TB>(a)
               : launch_inst<768, false, OWN_COLS, SN, true, TB>(a);
  }
  if (deep != HELD || a.D > dmax) return (int)cudaErrorInvalidValue;
  switch (dmax) {
    case 256:
      return vec ? launch_inst<256, true, OWN_COLS, SN, false, TB>(a)
                 : launch_inst<256, false, OWN_COLS, SN, false, TB>(a);
    case 512:
      return vec ? launch_inst<512, true, OWN_COLS, SN, false, TB>(a)
                 : launch_inst<512, false, OWN_COLS, SN, false, TB>(a);
    case 768:
      return vec ? launch_inst<768, true, OWN_COLS, SN, false, TB>(a)
                 : launch_inst<768, false, OWN_COLS, SN, false, TB>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int SN>
size_t smem_bytes(int dmax, int deep) {
  if (deep == CLUSTER_PATH)
    return dmax == CLUSTER_DMAX ? Inst<CLUSTER_DMAX, SN, false, true>::SMEM
                                : 0;
  if (deep == SLAB_PATH) return dmax == 768 ? Inst<768, SN, true>::SMEM : 0;
  if (deep != HELD) return 0;
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

// Dynamic shared memory of the forward instance (dmax, fm, sn, mode)
// (bytes), 0 for one that has no instance.  The bf16 mode's is the same:
// B is widened to f32 as it is copied.
size_t milnce_fwd_smem(int dmax, int fm, int sn, int mode) {
#define ROWS_FWD_SMEM(DM, M, N, MODE)                         \
  if (dmax == DM && fm == M && sn == N && mode == rows::MODE) \
    return rows::FwdInst<DM, M, N, rows::MODE>::SMEM;
  ROWS_FWD_INSTANCES(ROWS_FWD_SMEM)
#undef ROWS_FWD_SMEM
  return 0;
}

// How many clusters of nz blocks of the forward's cluster path the current
// card keeps resident at once; minus a CUDA error if the query fails.  The
// f32 instance's; the bf16 one has the same shared memory and one block
// an SM as well.
int milnce_fwd_clusters(int nz) {
#define ROWS_FWD_CLUSTERS(DM, M, N, MODE)                                   \
  if (rows::MODE == rows::CLUSTER_PATH)                                    \
    return rows::max_clusters(                                             \
        (const void*)rows::lse_fwd_kernel<DM, true, M, N, rows::MODE>,     \
        rows::FwdInst<DM, M, N, rows::MODE>::SMEM, nz);
  ROWS_FWD_INSTANCES(ROWS_FWD_CLUSTERS)
#undef ROWS_FWD_CLUSTERS
  return 0;
}

// One forward launch for A (R, D) f32, B (C, D) f32 or, with ``bf16``,
// bf16: part_m, part_s (nsplit, R) on the instance (dmax, fm, sn, mode):
// mode 0 held, D <= dmax; 1 the cluster path and 2 the slab path, any D,
// their logits summed over depth parts of ``kw``; ``vec``: D % 4 == 0, A
// 16-byte and B four elements' bytes aligned.
int milnce_lse_fwd(const float* A, const void* B, float* part_m,
                   float* part_s, int R, int C, int D, int dmax, int fm,
                   int sn, int mode, int kw, int nsplit, int tps, int vec,
                   int bf16, void* stream) {
  if ((mode == rows::HELD && D > dmax) || !rows::parts_ok(mode, D, kw))
    return (int)cudaErrorInvalidValue;
  const rows::FwdLaunch a = {A, B, part_m, part_s, R, C, D, nsplit, tps, kw,
                             (cudaStream_t)stream};
#define ROWS_FWD_LAUNCH_T(DM, M, N, MODE, T)                              \
  return vec ? rows::launch_fwd_inst<DM, true, M, N, rows::MODE, T>(a)   \
             : rows::launch_fwd_inst<DM, false, M, N, rows::MODE, T>(a);
#define ROWS_FWD_LAUNCH(DM, M, N, MODE)                                   \
  if (dmax == DM && fm == M && sn == N && mode == rows::MODE) {          \
    if (bf16) {                                                          \
      ROWS_FWD_LAUNCH_T(DM, M, N, MODE, rows::bf16)                      \
    }                                                                    \
    ROWS_FWD_LAUNCH_T(DM, M, N, MODE, float)                             \
  }
  ROWS_FWD_INSTANCES(ROWS_FWD_LAUNCH)
#undef ROWS_FWD_LAUNCH
#undef ROWS_FWD_LAUNCH_T
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the backward instance in mode ``deep`` (0 held,
// D <= dmax; 1 the cluster path, parts of at most dmax = 512; 2 the slab
// path, gradient slabs of dmax = 768) for streamed tiles of ``sn`` rows
// (bytes), 0 for one that has no instance.  Both modes and both element
// types share it.
size_t milnce_bwd_rows_smem(int dmax, int sn, int deep) {
  return sn == 128 ? rows::smem_bytes<128>(dmax, deep)
                   : sn == 256 ? rows::smem_bytes<256>(dmax, deep) : 0;
}

// How many clusters of nz blocks the cluster path's instance for own_cols
// (sn 256 without, 128 with) can keep resident on the current card at once;
// minus a CUDA error if the query fails.  The f32 instance's, as in
// milnce_fwd_clusters.
int milnce_bwd_clusters(int own_cols, int nz) {
  using rows::CLUSTER_DMAX, rows::Inst, rows::lse_bwd_kernel;
  return own_cols
             ? rows::max_clusters(
                   (const void*)lse_bwd_kernel<CLUSTER_DMAX, true, true, 128,
                                               false, true>,
                   Inst<CLUSTER_DMAX, 128, false, true>::SMEM, nz)
             : rows::max_clusters(
                   (const void*)lse_bwd_kernel<CLUSTER_DMAX, true, false, 256,
                                               false, true>,
                   Inst<CLUSTER_DMAX, 256, false, true>::SMEM, nz);
}

// One backward launch for A (R, D) f32, B (C, D) f32 or, with ``bf16``,
// bf16: part (nsplit, R, D) f32 of dA (own_cols 0, lse_bwd_rows, sn 256)
// or part (nsplit, C, D) of dB (own_cols 1, lse_bwd_cols, sn 128), f32,
// but bf16 (C, D) where B is bf16 and nsplit is 1, lse and g of
// length R, in mode ``deep`` (0 held, 1 the cluster path, 2 the slab
// path, gradient slabs of dmax = 768 over grid z; both deep paths sum the
// logits over depth parts of ``kw``).  ``sums`` (nsplit, R), written by
// lse_bwd_rows on the cluster path only (else NULL): each split's sum
// over its columns of exp(A_r . B_j - lse_r).
int milnce_lse_bwd(const float* A, const void* B, const float* lse,
                   const float* g, void* part, float* sums, int R, int C,
                   int D, int own_cols, int dmax, int sn, int deep, int kw,
                   int nsplit, int tps, int vec, int bf16,
                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!rows::parts_ok(deep, D, kw)) return (int)cudaErrorInvalidValue;
  if (sums && (own_cols || deep != rows::CLUSTER_PATH))
    return (int)cudaErrorInvalidValue;
  if (!own_cols) {
    if (sn != 256) return (int)cudaErrorInvalidValue;
    const rows::Launch a = {A, B, lse, g, part, sums, R, C, D, nsplit, tps,
                            kw, s};
    return bf16 ? rows::launch<false, 256, rows::bf16>(a, dmax, deep, vec)
                : rows::launch<false, 256, float>(a, dmax, deep, vec);
  }
  if (sn != 128) return (int)cudaErrorInvalidValue;
  const rows::Launch a = {B, A, lse, g, part, nullptr, C, R, D, nsplit, tps,
                          kw, s};
  return bf16 ? rows::launch<true, 128, rows::bf16>(a, dmax, deep, vec)
              : rows::launch<true, 128, float>(a, dmax, deep, vec);
}

}  // extern "C"
