// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the
// causal / sliding-window GQA attention that fa_fwd_wgmma computes
// (flash_attention_sm90.cu), from q, k, v, the output o, its gradient dO
// and the row log-sum-exp LSE the forward saved.  It replaces no Pallas
// kernel: the JAX package trains through jax.value_and_grad of the jnp
// chunked attention layers.flash_attention (src/repro/models/layers.py:128,
// src/repro/train/step.py:131), the function flash_attention_pallas
// (src/repro/kernels/flash_attention.py:82) computes, and this is that
// gradient.  Its plain version is kernels/ref.py's flash_attention_bwd_ref.
//
// The function, FlashAttention-2's backward, all in float32:
//   D_i = sum_e dO_ie O_ie                   (O as the forward stored it)
//   P_ij = exp(scale q_i . k_j - LSE_i)      where (i, j) is visible, else 0
//   dV_j = sum_i P_ij dO_i
//   dP_ij = dO_i . v_j;  dS_ij = P_ij (dP_ij - D_i)
//   dK_j = scale sum_i dS_ij q_i;  dQ_i = scale sum_j dS_ij k_j
// Visible is the forward's mask: the query row and the key inside Sq and
// Sk, kpos <= qpos when causal (top-left aligned), kpos > qpos - window with
// a window.  A masked pair has P = 0 exactly (the forward's -1e30 scores
// give exp(-1e30 - LSE) = 0 in float32 too), so a row with no visible key
// gets dQ = 0 and adds nothing to dK and dV.  KV head g's dK and dV sum
// its H / KV query heads inside one CTA, in float32, rounded once; K and V
// are never expanded.  Two kernels and no atomics: two launches on the
// same inputs are bitwise equal.
//
// Both dtypes run fa_bwd_dq_wgmma<hd, hd_v, F32>, then
// fa_bwd_dkdv_wgmma<hd, hd_v, F32>, on the tensor cores (wgmma) fed by
// TMA.  The arithmetic keeps the forward's rule, products exact or within
// float32's own rounding and only sums on the tensor core:
//   * bf16 (F32 = false, fa_backward_bf16): S = q k^T and dP = dO v^T are
//     bf16 wgmmas into float32: each product of two bf16 values is exact in
//     float32.
//   * float32 (F32 = true, fa_backward_f32): the wrapper splits q, k, v and
//     dO into three bf16 planes each with split_bf16x3_kernel (bit-exact,
//     flash_attention_sm90.cu), stacked on the batch axis, (3B, S, heads,
//     hd), as the forward takes them.  Each float32 product is the
//     forward's six plane passes (sm90_common.cuh's PASSES, smallest first,
//     hi * hi last), each within 2^-23 |x y| of the exact product.  S takes
//     them in the forward's order into one accumulator, as the forward
//     forms S, so the recomputed P matches the forward's within float32
//     rounding; dP = dO v^T the same.  o and dO are read in float32 for D
//     only.
//   * P and dS are formed in float32 on the CUDA cores from the
//     accumulator's registers (the forward's predicate and expf; masked
//     pairs exactly 0).
//   * dV += P^T dO, dK += dS^T q and dQ += dS k take P or dS split exactly
//     into three bf16 terms (split3: hi + mid + lo == x for |x| >= 1e-30),
//     with A from registers: bf16 one wgmma per term, smallest term first,
//     so every product is that of the float32 operand, exact in float32;
//     float32 the six passes of the terms against the B operand's planes.
//   * The tensor core's sums are not IEEE round-to-nearest (they lean
//     toward zero, flash_attention_sm90.cu's note), and dK / dV sum over G
//     x Sq query rows (8 x 4,096 at TinyLlama's training shape): one
//     accumulator over all of them would drift past half a bf16 ulp.  So,
//     as the float32 forward does with p v, each tile's products go into a
//     fresh accumulator (16 to 64 rows of the sum, in column chunks of at
//     most 64: MERGE_W), merged into the running dQ, dK or dV on the CUDA
//     cores in IEEE float32.  No tensor-core sum is longer than one tile;
//     dK and dQ take `scale` once at the store, and each output is rounded
//     once (to bf16 for bf16 inputs).
//   * D: bf16 sums the bf16 o * dO (exact products) over each row's quad
//     of lanes; float32 sums o * dO in float32 FMAs, sixteen lanes a row
//     (lane t columns t, t + 16, ...), then adds in a half-warp tree.
//
// Design (shapes as fa_fwd_wgmma's: q (B, Sq, H, hd), k (B, Sk, KV, hd), v
// (B, Sk, KV, hd_v), o and dO (B, Sq, H, hd_v)).  A CTA holds one tile of
// `rows` rows resident (BwdCfg: 128, two consumer warpgroups of 64 rows,
// wgmma's M, or 64, one) and one producer warpgroup; with two consumer
// warpgroups setmaxnreg shrinks the producer to 40 registers a thread (as
// the forward's).  One producer lane issues TMA loads through 4-D tensor
// maps over (B, S, heads, hd) (float32: (3B, ...), plane a of batch b at
// a * B + b), so query head h reads KV head h / G in place, and TMA's zero
// fill covers ragged Sq and Sk; tiles land swizzled in boxes chosen per
// head dim as the forward's (row_bytes), each plane of a tile its own set
// of boxes.
//   * fa_bwd_dq_wgmma, grid (ceil(Sq / rows), H, B), heaviest causal tiles
//     first: Q and dO of its rows once, then a ring of K / V tiles of BK
//     keys.  D for its rows is summed from o and dO first (written for the
//     next kernel).  Per tile: S = Q K^T and dP = dO V^T (A and B from
//     shared memory, K-major), P and dS on the S accumulator's registers,
//     whose pairs of columns are the A fragment of the next wgmma, then dQ
//     += dS K with K the MN-major (transposed) B operand.
//   * fa_bwd_dkdv_wgmma, grid (ceil(Sk / rows), KV, B): K and V of its keys
//     once, then a ring of Q / dO tiles of BQ queries over the G query
//     heads and the query tiles that can see its keys; a second producer
//     warp copies each tile's LSE and D into the stage (TMA cannot: ragged
//     Sq).  Per tile, with the keys as M: S^T = K Q^T and dP^T = V dO^T (Q
//     and dO the K-major B operand), P^T and dS^T on the registers, in the
//     A-fragment layout, then dV += P^T dO and dK += dS^T Q with dO and Q
//     the MN-major B operand.  dK and dV stay in registers; the G heads
//     are summed there.
//   * A warpgroup that can see no pair of a tile (the causal diagonal, a
//     window) skips its products.
//   * Registers bound the ring tiles; a float32 thread holds what a bf16
//     one does (the planes live in shared memory; the terms of P and dS
//     are reused against each plane).  ptxas allocates every thread of a
//     two-warpgroup CTA within the 168 registers of __launch_bounds__(384,
//     1) (setmaxnreg's 232 does not raise it), 255 with one consumer
//     warpgroup, and a dK / dV thread holds (hd + hd_v) / 2 floats of
//     accumulator, plus S^T and dP^T (BQ / 2 each), three bf16 terms (3 BQ
//     / 4) and a merge chunk (<= 32): BQ at most 64 at hd + hd_v <= 160, 32
//     at hd 112 / 128, 16 at MLA's (192, 128); dQ's BK at most 64, 32 at hd
//     192.  The dK / dV kernel still spills (right, and off the training
//     path): bf16 at hd 112, 128 and (192, 128), float32 at hd 128 and
//     (192, 128); float32 at hd 64 keeps one register in local memory
//     around an edge tile's mask test (nvcc -Xptxas=-v, PERF.md).
//   * Shared memory bounds the float32 tiles, three planes of each.  BwdCfg
//     derives each kernel's rows, ring tile and depth from the 227 KB
//     budget: 128 rows where they fit beside two stages of the register
//     plan's tile, else 64; the widest tile (halved at most twice) that
//     fits two stages; three stages where they fit.  So hd 16 / 32: 128
//     rows, tiles of 64, three stages; hd 64 (the training shape): 128
//     rows, 64, two stages (193 KB); hd 80: 64 rows, 64, two; hd 112: 64,
//     32, three; hd 128: 64, 32, two; (192, 128): 64, 16, three.  bf16
//     keeps 128 rows, the register plan's tile and three stages.
//
// Bound.  The gradient needs 5 products per visible pair (S recomputed,
// dP, dV, dK and dQ), 2 (3 hd + 2 hd_v) flops a pair: at the training
// shape (B 4, S 4096, H 32, KV 4, hd 64, causal) 0.69 TFLOP, 0.695 ms at
// the bf16 tensor-core rate (989 TFLOP/s), against ~0.2 GB of bf16 inputs
// and outputs (0.06 ms): bound by operations.  The bf16 design issues 13
// units of tensor-core work a pair against those 5 (S and dP in both
// kernels, three terms for each of dV, dK and dQ), 2.6 x the bound, and
// pays that rather than round P and dS to bf16 (another function).
// float32: the function's products at six bf16 passes each, a bound of
// 4.170 ms (989 / 6 TFLOP/s) against ~0.4 GB of float32 inputs and
// outputs; the design issues 42 units a pair (S and dP six passes each in
// both kernels, six each for dV, dK and dQ), 8.4 x the function's 5, 5.84
// ms at 989 TFLOP/s, plus the four splits (~0.28 ms, bound by bytes).
// What it leaves: a warpgroup's softmax-gradient math and its wgmmas do not
// overlap (the other warpgroup fills the gap, where there is one), each
// merge waits for its chunk's products, no persistent scheduler, one CTA
// per SM.

#include <type_traits>

#include "sm90_common.cuh"  // mbarriers, TMA, wgmma, split3, PASSES, maps

namespace {

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

constexpr int WG_ROWS = 64;        // rows per consumer warpgroup (M)
constexpr int PRODUCER_WARPS = 4;  // one warpgroup, for setmaxnreg
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int MERGE_W = 64;        // widest fresh accumulator, columns

// Columns of one fresh-accumulator product for an output of width n: 64
// where n is a multiple of 64 (one 128-byte box a chunk), else all of it
// (16 / 32 / 80 / 112, one chunk).
constexpr int merge_w(int n) { return n % MERGE_W == 0 ? MERGE_W : n; }

// Shared memory of either kernel: 1024 bytes of slack to align the tiles
// to the swizzle atom; `planes` bf16 planes of its resident tiles (`rows`
// rows of the q/k width plus rows of the v width: Q and dO for dQ, K and V
// for dK / dV) and of `stages` ring stages of `tile` rows of both widths
// (K and V; Q and dO), with `stat` bytes a ring row (dK / dV: LSE and D);
// then 1 + 2 * stages mbarriers.  width = hd + hd_v.
constexpr int bwd_smem(int planes, int width, int rows, int tile, int stages,
                       int stat) {
  return 1024 + planes * 2 * width * (rows + stages * tile) +
         stages * stat * tile + 8 * (1 + 2 * stages);
}

// One kernel's resident rows, ring tile and ring depth (the note at the
// top): bf16 128 rows, the register plan's tile `tile_max`, three stages;
// float32 (three planes of every tile) from the shared-memory budget.
struct Tiling {
  int rows, tile, stages;
};
constexpr bool f32_fits(int width, int rows, int tile, int stages, int stat) {
  return bwd_smem(3, width, rows, tile, stages, stat) <= SMEM_MAX;
}
constexpr Tiling f32_tiling(int width, int tile_max, int stat, int rows) {
  const int tile = f32_fits(width, rows, tile_max, 2, stat) ? tile_max
                   : f32_fits(width, rows, tile_max / 2, 2, stat)
                       ? tile_max / 2
                       : tile_max / 4;
  return {rows, tile, f32_fits(width, rows, tile, 3, stat) ? 3 : 2};
}
constexpr Tiling tiling(bool f32, int width, int tile_max, int stat) {
  return !f32 ? Tiling{128, tile_max, 3}
              : f32_tiling(width, tile_max, stat,
                           f32_fits(width, 128, tile_max, 2, stat) ? 128
                                                                   : 64);
}

template <int HD, int HDV, bool F32>
struct BwdCfg {
  static constexpr int PLANES = F32 ? 3 : 1;  // bf16 planes per operand
  // Q and K rows: the q/k width; dO and V rows: the v width.
  static constexpr int ROWB = row_bytes(HD);
  static constexpr int CHUNK = ROWB / 2;  // bf16 columns per TMA box
  static constexpr int NCHUNK = HD / CHUNK;
  static constexpr int KPC = CHUNK / 16;  // k16 steps per box
  static constexpr int ROWB_V = row_bytes(HDV);
  static constexpr int CHUNK_V = ROWB_V / 2;
  static constexpr int NCHUNK_V = HDV / CHUNK_V;
  static constexpr int KPC_V = CHUNK_V / 16;
  static constexpr int W = HD + HDV;
  // The register plan (the note at the top): dK / dV's queries per tile
  // (S^T's N) and dQ's keys per tile, at most.
  static constexpr int BQ_MAX = W <= 160 ? 64 : W <= 256 ? 32 : 16;
  static constexpr int BK_MAX = HD <= 128 ? 64 : 32;
  static constexpr Tiling DQ = tiling(F32, W, BK_MAX, 0);
  static constexpr Tiling KV = tiling(F32, W, BQ_MAX, 8);
  static constexpr int DQ_ROWS = DQ.rows, BK = DQ.tile;
  static constexpr int DQ_STAGES = DQ.stages;
  static constexpr int KV_ROWS = KV.rows, BQ = KV.tile;
  static constexpr int KV_STAGES = KV.stages;
  // Consumer warps (16 rows each) and threads of each kernel.
  static constexpr int DQ_WARPS = DQ_ROWS / 16, KV_WARPS = KV_ROWS / 16;
  static constexpr int DQ_THREADS = 32 * (DQ_WARPS + PRODUCER_WARPS);
  static constexpr int KV_THREADS = 32 * (KV_WARPS + PRODUCER_WARPS);
  static constexpr int MW = merge_w(HD), MW_V = merge_w(HDV);
  // Bytes of one plane of each tile.  dQ: Q and dO of DQ_ROWS rows, then
  // the ring of K and V tiles (stage: the K planes, then the V planes).
  static constexpr int DQ_Q = DQ_ROWS * HD * 2, DQ_DO = DQ_ROWS * HDV * 2;
  static constexpr int DQ_K = BK * HD * 2, DQ_V = BK * HDV * 2;
  static constexpr int DQ_STAGE = PLANES * (DQ_K + DQ_V);
  static constexpr int DQ_SMEM = bwd_smem(PLANES, W, DQ_ROWS, BK, DQ_STAGES,
                                          0);
  // dK / dV: K and V of KV_ROWS keys, then the ring of Q and dO tiles,
  // then each stage's LSE and D (2 BQ floats).
  static constexpr int KV_K = KV_ROWS * HD * 2, KV_V = KV_ROWS * HDV * 2;
  static constexpr int KV_Q = BQ * HD * 2, KV_DO = BQ * HDV * 2;
  static constexpr int KV_STAGE = PLANES * (KV_Q + KV_DO);
  static constexpr int KV_SMEM = bwd_smem(PLANES, W, KV_ROWS, BQ, KV_STAGES,
                                          8);
  static_assert(HD % CHUNK == 0 && HDV % CHUNK_V == 0,
                "head dims must be whole TMA boxes");
  static_assert(MW % CHUNK == 0 && MW_V % CHUNK_V == 0,
                "merge chunks must be whole TMA boxes");
  static_assert(BK >= 16 && BQ >= 16, "ring tiles of at least one k16 step");
  static_assert(DQ_SMEM <= SMEM_MAX && KV_SMEM <= SMEM_MAX,
                "shared memory per CTA");
};

// The register budget of a consumer thread: with two consumer warpgroups
// the producer hands its registers over (setmaxnreg); with one, every
// thread may take 255 and nothing moves.
template <int ROWS>
__device__ __forceinline__ void producer_regs() {
  if constexpr (ROWS == 128)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
}
template <int ROWS>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (ROWS == 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
}

// P (or P^T) and dS (dS^T) of one 64-row accumulator tile in place: s
// holds the scores q . k, dp the products dO . v; P = exp(scale s - lse)
// where the pair is visible, else 0, and dS = P (dp - D).  Register j of
// the m64nN accumulator holds row lane / 4 + 8 ((j >> 1) & 1) (+ 16 warp)
// and column 8 (j >> 2) + 2 (lane & 3) + (j & 1).  pos(j) gives (qpos,
// kpos) of register j; stat(j) its (LSE, D).  Only a tile that crosses a
// mask edge tests pairs: a masked score becomes -inf, whose P is exactly 0
// (and dS = 0 times a finite dp - D), so the common tile's loop carries no
// predicate.
template <int NF, typename Pos, typename Stat>
__device__ __forceinline__ void softmax_grad(float (&s)[NF], float (&dp)[NF],
                                             bool edge, Pos pos, Stat stat,
                                             float scale, int Sq, int Sk,
                                             int causal, int window) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int2 qk = pos(j);
      if (!visible(qk.x, qk.y, Sq, Sk, causal, window)) s[j] = -INFINITY;
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const float2 ld = stat(j);
    const float p = expf(s[j] * scale - ld.x);
    s[j] = p;
    dp[j] = p * (dp[j] - ld.y);
  }
}

// x's three bf16 terms in the A-fragment layout: registers 8kk .. 8kk + 7
// of an accumulator, as four bf16 pairs, are the A fragment of its columns
// 16kk .. 16kk + 15.
template <int NF>
__device__ __forceinline__ void split_terms(const float (&x)[NF],
                                            uint32_t (&t)[3][NF / 2]) {
#pragma unroll
  for (int j = 0; j < NF / 2; ++j)
    split3(x[2 * j], x[2 * j + 1], t[0][j], t[1][j], t[2][j]);
}

// acc = a K-major product of shared-memory tiles into one accumulator
// over K = k (16 k-steps a box of kpc): A `a_rows` rows at a, B `b_rows`
// rows at b, both `rowb` swizzled bytes a row.  bf16: one pass; float32:
// the six plane passes, smallest first, planes a_plane / b_plane bytes
// apart, the left operand's plane pass_a against the right's pass_b: S =
// Q K^T as the forward forms it, and with SWAP (A the right operand) S^T
// = K Q^T from the same products in the same order.  The first wgmma
// overwrites acc.
template <bool F32, bool SWAP, int K, int KPC, int NF>
__device__ __forceinline__ void planes_ss(float (&acc)[NF], uint32_t a,
                                          int a_rows, int a_plane,
                                          uint32_t b, int b_rows,
                                          int b_plane, int rowb) {
#pragma unroll
  for (int t = 0; t < (F32 ? PASSES : 1); ++t) {
    const int pa = SWAP ? pass_b(t) : pass_a(t);
    const int pb = SWAP ? pass_a(t) : pass_b(t);
    const uint32_t at = a + (F32 ? pa : 0) * a_plane;
    const uint32_t bt = b + (F32 ? pb : 0) * b_plane;
#pragma unroll
    for (int j = 0; j < K / 16; ++j) {
      const int c = j / KPC, off = (j % KPC) * 32;
      wgmma_ss(acc, kmajor(at + c * a_rows * rowb + off, rowb),
               kmajor(bt + c * b_rows * rowb + off, rowb), t > 0 || j > 0);
    }
  }
}

// acc += A B over K = 16 * KSTEPS rows of B, A the three terms of `t` and
// B a tile of `rows` rows at b (MN-major, rowb swizzled bytes a row; its
// planes `plane` bytes apart), its output columns in chunks of W: each
// chunk's products go into a fresh accumulator, then added to acc on the
// CUDA cores.  bf16: one pass a term, smallest term first; float32: the
// six passes, term pass_a against B plane pass_b.  N = the output width
// (acc holds N / 2 floats).
template <int N, int W, int KSTEPS, int CHUNK_COLS, bool F32, int TF>
__device__ __forceinline__ void merged_product(float (&acc)[N / 2],
                                               const uint32_t (&t)[3][TF],
                                               uint32_t b, int rows,
                                               int rowb, int plane) {
#pragma unroll
  for (int ch = 0; ch < N / W; ++ch) {
    const uint32_t bc = b + (ch * W / CHUNK_COLS) * rows * rowb;
    float tile[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j) tile[j] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < (F32 ? PASSES : 3); ++u) {
      const int term = F32 ? pass_a(u) : 2 - u;
      const uint32_t bp = bc + (F32 ? pass_b(u) : 0) * plane;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_rs(tile, t[term] + 4 * kk,
                 mnmajor(bp + kk * 16 * rowb, rows, rowb));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(tile);
#pragma unroll
    for (int j = 0; j < W / 2; ++j) acc[ch * W / 2 + j] += tile[j];
  }
}

// Stores rows r0 and r0 + 8 (those < n) of a 64-row accumulator of width W
// to a (., heads, W) tensor of T (bf16 or float32) at base (row stride rs),
// times mul.
template <int W, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 2],
                                           T* base, int64_t rs, int r0, int n,
                                           int lane, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
    T* out = base + (int64_t)row * rs + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < W / 8; ++c) {
      const float x = acc[4 * c + 2 * r] * mul;
      const float y = acc[4 * c + 2 * r + 1] * mul;
      if constexpr (std::is_same_v<T, float>)
        *reinterpret_cast<float2*>(out + 8 * c) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) =
            __floats2bfloat162_rn(x, y);
    }
  }
}

// (LSE, D) of this thread's rows r0 and r0 + 8, D also written to Dout
// (B, H, Sq).  bf16: the quad's four lanes sum alternate column pairs of
// o * dO (exact products), then add in a fixed tree.  float32: the warp's
// 16 rows two at a time, sixteen lanes a row: lane t sums columns t, t +
// 16, ... in float32 FMAs, then the half-warp adds in a fixed tree (xor 8,
// 4, 2, 1); each thread takes its rows' sums by shuffle.
template <int HDV, bool F32, typename T>
__device__ __forceinline__ void row_stats(float2 (&ld)[2], const T* o,
                                          const T* dO, const float* lse,
                                          float* Dout, int b, int h, int Sq,
                                          int H, int wrow, int lane) {
  const int64_t stat = ((int64_t)b * H + h) * Sq;
  const int r0 = wrow + lane / 4;
  float d[2] = {0.0f, 0.0f};
  if constexpr (F32) {
    const int tx = lane % 16;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int row = wrow + 2 * p + lane / 16;
      float part = 0.0f;
      if (row < Sq) {
        const int64_t at = (((int64_t)b * Sq + row) * H + h) * HDV + tx;
#pragma unroll
        for (int c = 0; c < HDV / 16; ++c)
          part = fmaf(dO[at + 16 * c], o[at + 16 * c], part);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (row < Sq && tx == 0) Dout[stat + row] = part;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = lane / 4 + 8 * r;  // the row within the warp
        const float x = __shfl_sync(0xffffffffu, part, 16 * (j & 1));
        if (j / 2 == p) d[r] = x;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      float part = 0.0f;
      if (row < Sq) {
        const int64_t at = (((int64_t)b * Sq + row) * H + h) * HDV +
                           2 * (lane & 3);
#pragma unroll
        for (int c = 0; c < HDV / 8; ++c) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(o + at + 8 * c));
          const float2 y = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dO + at + 8 * c));
          part = fmaf(y.x, x.x, part);
          part = fmaf(y.y, x.y, part);
        }
      }
      d[r] = quad_sum(part);
      if (row < Sq && (lane & 3) == 0) Dout[stat + row] = d[r];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    ld[r] = make_float2(row < Sq ? lse[stat + row] : 0.0f, d[r]);
  }
}

template <bool F32>
using out_t = std::conditional_t<F32, float, __nv_bfloat16>;

// dQ and D.  Maps: q (B, Sq, H, hd) and dO (B, Sq, H, hd_v) in boxes of
// DQ_ROWS rows; k (B, Sk, KV, hd), v (B, Sk, KV, hd_v) in boxes of BK rows
// (float32: the planes, batch 3B).  o and dO (B, Sq, H, hd_v) in the
// dtype, lse (B, H, Sq) -> D (B, H, Sq), dq.
template <int HD, int HDV, bool F32>
__global__ void __launch_bounds__(BwdCfg<HD, HDV, F32>::DQ_THREADS, 1)
    fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const out_t<F32>* __restrict__ o,
                    const out_t<F32>* __restrict__ dO,
                    const float* __restrict__ lse, float* __restrict__ Dout,
                    out_t<F32>* __restrict__ dq, int B, int Sq, int Sk, int H,
                    int KV, float scale, int causal, int window) {
  using C = BwdCfg<HD, HDV, F32>;
  constexpr int BK = C::BK, ROWS = C::DQ_ROWS, STAGES = C::DQ_STAGES;
  constexpr int P = C::PLANES, CW = C::DQ_WARPS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;  // swizzle-atom aligned
  const uint32_t s_do = s_q + P * C::DQ_Q;
  const uint32_t s_kv = s_do + P * C::DQ_DO;  // stage s: K, then V planes
  const uint32_t q_bar = s_kv + STAGES * C::DQ_STAGE;
  const uint32_t full_bar = q_bar + 8;               // [STAGES]
  const uint32_t empty_bar = full_bar + 8 * STAGES;  // [STAGES]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * ROWS;
  const int q_valid = min(ROWS, Sq - q0);
  int kt_hi = (Sk + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (q0 + q_valid - 1) / BK + 1);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CW) {  // producer
    producer_regs<ROWS>();
    if (warp == CW && lane == 0) {
      mbar_expect_tx(q_bar, P * (C::DQ_Q + C::DQ_DO));
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int c = 0; c < C::NCHUNK; ++c)
          tma_load(s_q + a * C::DQ_Q + c * ROWS * C::ROWB, &tm_q, q_bar,
                   c * C::CHUNK, h, q0, a * B + b);
#pragma unroll
        for (int c = 0; c < C::NCHUNK_V; ++c)
          tma_load(s_do + a * C::DQ_DO + c * ROWS * C::ROWB_V, &tm_do, q_bar,
                   c * C::CHUNK_V, h, q0, a * B + b);
      }
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, C::DQ_STAGE);
        const uint32_t s_k = s_kv + s * C::DQ_STAGE;
        const uint32_t s_v = s_k + P * C::DQ_K;
#pragma unroll
        for (int a = 0; a < P; ++a) {
#pragma unroll
          for (int c = 0; c < C::NCHUNK; ++c)
            tma_load(s_k + a * C::DQ_K + c * BK * C::ROWB, &tm_k,
                     full_bar + 8 * s, c * C::CHUNK, kvh, kt * BK, a * B + b);
#pragma unroll
          for (int c = 0; c < C::NCHUNK_V; ++c)
            tma_load(s_v + a * C::DQ_V + c * BK * C::ROWB_V, &tm_v,
                     full_bar + 8 * s, c * C::CHUNK_V, kvh, kt * BK,
                     a * B + b);
        }
      }
    }
    return;
  }

  consumer_regs<ROWS>();
  const int wg = warp / 4;
  const int row_lo = q0 + WG_ROWS * wg;
  const int r0 = row_lo + 16 * (warp % 4) + lane / 4;
  float2 ld[2];
  row_stats<HDV, F32>(ld, o, dO, lse, Dout, b, h, Sq, H, q0 + 16 * warp,
                      lane);

  float acc[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.0f;
  const uint32_t s_qa = s_q + wg * WG_ROWS * C::ROWB;
  const uint32_t s_doa = s_do + wg * WG_ROWS * C::ROWB_V;
  mbar_wait(q_bar, 0);

  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int s = i % STAGES;
    const uint32_t s_k = s_kv + s * C::DQ_STAGE;
    const uint32_t s_v = s_k + P * C::DQ_K;
    const int k0 = kt * BK;
    mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
    const bool any = row_lo < Sq && (!causal || k0 <= row_lo + WG_ROWS - 1) &&
                     (window <= 0 || k0 + BK - 1 > row_lo - window);
    if (any) {
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = dp[j] = 0.0f;
      wgmma_fence();
      planes_ss<F32, false, HD, C::KPC>(sc, s_qa, ROWS, C::DQ_Q, s_k, BK,
                                        C::DQ_K, C::ROWB);
      planes_ss<F32, false, HDV, C::KPC_V>(dp, s_doa, ROWS, C::DQ_DO, s_v,
                                           BK, C::DQ_V, C::ROWB_V);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);

      const bool edge = k0 + BK > Sk || row_lo + WG_ROWS > Sq ||
                        (causal && k0 + BK - 1 > row_lo) ||
                        (window > 0 && k0 <= row_lo + WG_ROWS - 1 - window);
      softmax_grad(
          sc, dp, edge,
          [&](int j) {
            return make_int2(r0 + 8 * ((j >> 1) & 1),
                             k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1));
          },
          [&](int j) { return ld[(j >> 1) & 1]; }, scale, Sq, Sk, causal,
          window);
      uint32_t t[3][BK / 4];
      split_terms(dp, t);
      // dQ += dS K, K the MN-major B operand (BK rows).
      merged_product<HD, C::MW, BK / 16, C::CHUNK, F32>(acc, t, s_k, BK,
                                                        C::ROWB, C::DQ_K);
      pin(t[0]);
      pin(t[1]);
      pin(t[2]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // this warp is done
  }
  store_rows<HD>(acc, dq + ((int64_t)b * Sq * H + h) * HD, (int64_t)H * HD,
                 r0, Sq, lane, scale);
}

// dK and dV.  Maps: k, v in boxes of KV_ROWS rows; q, dO in boxes of BQ
// rows (float32: the planes).  lse and D (B, H, Sq) -> dk (B, Sk, KV, hd),
// dv (B, Sk, KV, hd_v).
template <int HD, int HDV, bool F32>
__global__ void __launch_bounds__(BwdCfg<HD, HDV, F32>::KV_THREADS, 1)
    fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ Din,
                      out_t<F32>* __restrict__ dk,
                      out_t<F32>* __restrict__ dv, int B, int Sq, int Sk,
                      int H, int KV, float scale, int causal, int window) {
  using C = BwdCfg<HD, HDV, F32>;
  constexpr int BQ = C::BQ, ROWS = C::KV_ROWS, STAGES = C::KV_STAGES;
  constexpr int P = C::PLANES, CW = C::KV_WARPS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_k = (raw + 1023u) & ~1023u;  // swizzle-atom aligned
  const uint32_t s_v = s_k + P * C::KV_K;
  const uint32_t s_ring = s_v + P * C::KV_V;  // stage s: Q, then dO planes
  const uint32_t s_stat = s_ring + STAGES * C::KV_STAGE;  // [STAGES][2][BQ]
  const uint32_t kv_bar = s_stat + STAGES * 8 * BQ;
  const uint32_t full_bar = kv_bar + 8;              // [STAGES]
  const uint32_t empty_bar = full_bar + 8 * STAGES;  // [STAGES]
  // The generic address of the stats (the producer's stores, the
  // consumers' loads).
  float* const stat_ptr =
      reinterpret_cast<float*>(smem_raw + (s_stat - raw));

  const int kt = blockIdx.x;  // causal: key tile 0 sees the most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int k0 = kt * ROWS;
  // Query tiles holding a query that may see a key of this tile.
  const int qt_lo = causal ? k0 / BQ : 0;
  int qt_hi = (Sq + BQ - 1) / BQ;
  if (window > 0) qt_hi = min(qt_hi, (k0 + ROWS + window - 2) / BQ + 1);
  const int nqt = max(0, qt_hi - qt_lo);
  const int n_it = G * nqt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      // The TMA lane's arrive (with the bytes) and the stats warp's 32.
      mbar_init(full_bar + 8 * s, 33);
      mbar_init(empty_bar + 8 * s, CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CW) {  // producer
    producer_regs<ROWS>();
    if (warp == CW && lane == 0) {  // TMA
      mbar_expect_tx(kv_bar, P * (C::KV_K + C::KV_V));
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int c = 0; c < C::NCHUNK; ++c)
          tma_load(s_k + a * C::KV_K + c * ROWS * C::ROWB, &tm_k, kv_bar,
                   c * C::CHUNK, kvh, k0, a * B + b);
#pragma unroll
        for (int c = 0; c < C::NCHUNK_V; ++c)
          tma_load(s_v + a * C::KV_V + c * ROWS * C::ROWB_V, &tm_v, kv_bar,
                   c * C::CHUNK_V, kvh, k0, a * B + b);
      }
      for (int i = 0; i < n_it; ++i) {
        const int s = i % STAGES;
        const int h = kvh * G + i / nqt, q0 = (qt_lo + i % nqt) * BQ;
        mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, C::KV_STAGE);
        const uint32_t s_q = s_ring + s * C::KV_STAGE;
        const uint32_t s_do = s_q + P * C::KV_Q;
#pragma unroll
        for (int a = 0; a < P; ++a) {
#pragma unroll
          for (int c = 0; c < C::NCHUNK; ++c)
            tma_load(s_q + a * C::KV_Q + c * BQ * C::ROWB, &tm_q,
                     full_bar + 8 * s, c * C::CHUNK, h, q0, a * B + b);
#pragma unroll
          for (int c = 0; c < C::NCHUNK_V; ++c)
            tma_load(s_do + a * C::KV_DO + c * BQ * C::ROWB_V, &tm_do,
                     full_bar + 8 * s, c * C::CHUNK_V, h, q0, a * B + b);
        }
      }
    } else if (warp == CW + 1) {  // LSE and D into the stage
      for (int i = 0; i < n_it; ++i) {
        const int s = i % STAGES;
        const int h = kvh * G + i / nqt, q0 = (qt_lo + i % nqt) * BQ;
        const int64_t stat = ((int64_t)b * H + h) * Sq;
        mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        float* st = stat_ptr + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < Sq;
          st[r] = in ? lse[stat + q0 + r] : 0.0f;
          st[BQ + r] = in ? Din[stat + q0 + r] : 0.0f;
        }
        mbar_arrive(full_bar + 8 * s);
      }
    }
    return;
  }

  consumer_regs<ROWS>();
  const int wg = warp / 4;
  const int key_lo = k0 + WG_ROWS * wg;
  const int r0 = key_lo + 16 * (warp % 4) + lane / 4;
  const uint32_t s_ka = s_k + wg * WG_ROWS * C::ROWB;
  const uint32_t s_va = s_v + wg * WG_ROWS * C::ROWB_V;
  float dk_acc[HD / 2], dv_acc[HDV / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) dk_acc[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < HDV / 2; ++j) dv_acc[j] = 0.0f;
  mbar_wait(kv_bar, 0);

  for (int i = 0; i < n_it; ++i) {
    const int s = i % STAGES;
    const int q0 = (qt_lo + i % nqt) * BQ;
    const uint32_t s_q = s_ring + s * C::KV_STAGE;
    const uint32_t s_do = s_q + P * C::KV_Q;
    mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
    const bool any = key_lo < Sk && q0 < Sq &&
                     (!causal || q0 + BQ - 1 >= key_lo) &&
                     (window <= 0 || q0 < key_lo + WG_ROWS - 1 + window);
    if (any) {
      // S^T = K Q^T and dP^T = V dO^T: the keys as M, queries as N (in
      // float32 the products that form S and dP, in their order).
      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] = dpt[j] = 0.0f;
      wgmma_fence();
      planes_ss<F32, true, HD, C::KPC>(st, s_ka, ROWS, C::KV_K, s_q, BQ,
                                       C::KV_Q, C::ROWB);
      planes_ss<F32, true, HDV, C::KPC_V>(dpt, s_va, ROWS, C::KV_V, s_do, BQ,
                                          C::KV_DO, C::ROWB_V);
      wgmma_commit();
      wgmma_wait_all();
      pin(st);
      pin(dpt);

      const bool edge = q0 + BQ > Sq || key_lo + WG_ROWS > Sk ||
                        (causal && q0 < key_lo + WG_ROWS - 1) ||
                        (window > 0 && q0 + BQ - 1 >= key_lo + window);
      const float* stq = stat_ptr + s * 2 * BQ;  // LSE, then D
      softmax_grad(
          st, dpt, edge,
          [&](int j) {
            return make_int2(q0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1),
                             r0 + 8 * ((j >> 1) & 1));
          },
          [&](int j) {
            const int c = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
            return make_float2(stq[c], stq[BQ + c]);
          },
          scale, Sq, Sk, causal, window);
      {
        // dV += P^T dO, dO the MN-major B operand (BQ rows).
        uint32_t t[3][BQ / 4];
        split_terms(st, t);
        merged_product<HDV, C::MW_V, BQ / 16, C::CHUNK_V, F32>(
            dv_acc, t, s_do, BQ, C::ROWB_V, C::KV_DO);
        pin(t[0]);
        pin(t[1]);
        pin(t[2]);
      }
      {
        // dK += dS^T Q, Q the MN-major B operand.
        uint32_t t[3][BQ / 4];
        split_terms(dpt, t);
        merged_product<HD, C::MW, BQ / 16, C::CHUNK, F32>(
            dk_acc, t, s_q, BQ, C::ROWB, C::KV_Q);
        pin(t[0]);
        pin(t[1]);
        pin(t[2]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // this warp is done
  }
  const int64_t krow = (int64_t)KV * HD, vrow = (int64_t)KV * HDV;
  store_rows<HD>(dk_acc, dk + (int64_t)b * Sk * krow + (int64_t)kvh * HD,
                 krow, r0, Sk, lane, scale);
  store_rows<HDV>(dv_acc, dv + (int64_t)b * Sk * vrow + (int64_t)kvh * HDV,
                  vrow, r0, Sk, lane, 1.0f);
}

// The two kernels of one instantiation.  q, k, v and dO_tma are what TMA
// reads (bf16: the inputs; float32: their split_bf16x3 planes, (3, B, S,
// heads, hd)); o and dO are the dtype's, for D.
template <int HD, int HDV, bool F32>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const void* dO_tma, const void* lse, void* D,
           void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
           float scale, int causal, int window, cudaStream_t stream) {
  using C = BwdCfg<HD, HDV, F32>;
  using T = out_t<F32>;
  if (Sq == 0) {  // no query: dK = dV = 0 exactly
    cudaError_t e = cudaMemsetAsync(dk, 0, (size_t)B * Sk * KV * HD *
                                               sizeof(T), stream);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(dv, 0, (size_t)B * Sk * KV * HDV * sizeof(T),
                          stream);
    return (int)e;
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const CUtensorMapSwizzle sw = swizzle_of(C::ROWB);
  const CUtensorMapSwizzle sw_v = swizzle_of(C::ROWB_V);
  const int NB = C::PLANES * B;  // float32: the planes on the batch axis
  // dQ's maps (Q / dO in DQ_ROWS rows, K / V in BK), then dK / dV's (K / V
  // in KV_ROWS rows, Q / dO in BQ).
  CUtensorMap a_q, a_k, a_v, a_do, b_q, b_k, b_v, b_do;
  if (!make_map(enc, &a_q, q, NB, Sq, H, HD, C::CHUNK, C::DQ_ROWS, sw) ||
      !make_map(enc, &a_k, k, NB, Sk, KV, HD, C::CHUNK, C::BK, sw) ||
      !make_map(enc, &a_v, v, NB, Sk, KV, HDV, C::CHUNK_V, C::BK, sw_v) ||
      !make_map(enc, &a_do, dO_tma, NB, Sq, H, HDV, C::CHUNK_V, C::DQ_ROWS,
                sw_v) ||
      !make_map(enc, &b_q, q, NB, Sq, H, HD, C::CHUNK, C::BQ, sw) ||
      !make_map(enc, &b_k, k, NB, Sk, KV, HD, C::CHUNK, C::KV_ROWS, sw) ||
      !make_map(enc, &b_v, v, NB, Sk, KV, HDV, C::CHUNK_V, C::KV_ROWS,
                sw_v) ||
      !make_map(enc, &b_do, dO_tma, NB, Sq, H, HDV, C::CHUNK_V, C::BQ, sw_v))
    return ERR_TENSOR_MAP;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dq_wgmma<HD, HDV, F32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dkdv_wgmma<HD, HDV, F32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::KV_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  fa_bwd_dq_wgmma<HD, HDV, F32><<<
      dim3((Sq + C::DQ_ROWS - 1) / C::DQ_ROWS, H, B), C::DQ_THREADS,
      C::DQ_SMEM, stream>>>(a_q, a_k, a_v, a_do, static_cast<const T*>(o),
                            static_cast<const T*>(dO),
                            static_cast<const float*>(lse),
                            static_cast<float*>(D), static_cast<T*>(dq), B, Sq,
                            Sk, H, KV, scale, causal, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkdv_wgmma<HD, HDV, F32><<<
      dim3((Sk + C::KV_ROWS - 1) / C::KV_ROWS, KV, B), C::KV_THREADS,
      C::KV_SMEM, stream>>>(b_q, b_k, b_v, b_do,
                            static_cast<const float*>(lse),
                            static_cast<const float*>(D), static_cast<T*>(dk),
                            static_cast<T*>(dv), B, Sq, Sk, H, KV, scale,
                            causal, window);
  return (int)cudaGetLastError();
}

// The head dims and (q/k, v) pairs of the forward kernel
// (flash_attention_sm90.cu's HEAD_DIMS and HEAD_DIM_PAIRS; the wrapper
// holds one list for both sources).
#define HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(112) X(128)
#define HEAD_DIM_PAIRS(X) X(192, 128)

// T the inputs' dtype: bf16, or float (given as its planes); both take the
// wgmma kernels, and a head dim outside the lists is refused.
template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dO, const void* dO_tma, const void* lse, void* D,
             void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
             int KV, int hd, int hd_v, float scale, int causal, int window,
             void* stream) {
  constexpr bool F32 = std::is_same_v<T, float>;
  if (B == 0 || Sk == 0 || KV == 0) return 0;
  if (H <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(HD, HDV)                                                        \
  if (hd == HD && hd_v == HDV)                                               \
    return launch<HD, HDV, F32>(q, k, v, o, dO, dO_tma, lse, D, dq, dk, dv, \
                                B, Sq, Sk, H, KV, scale, causal, window, st);
#define SAME(HD) CASE(HD, HD)
  HEAD_DIMS(SAME)
  HEAD_DIM_PAIRS(CASE)
#undef SAME
#undef CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches its dQ kernel,
// then its dK / dV kernel, on the given stream, does not synchronize, and
// returns cudaGetLastError() (the error that refused a launch), or
// ERR_NO_ENCODER / ERR_TENSOR_MAP (negative).
//
// fa_backward_bf16: bf16 q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV,
// hd_v), o and dO (B, Sq, H, hd_v), contiguous and 16-byte aligned;
// float32 lse (B, H, Sq) from the forward and scratch D (B, H, Sq); bf16
// outputs dq, dk, dv of q's, k's and v's shapes.  hd == hd_v one of
// HEAD_DIMS, or (hd, hd_v) one of HEAD_DIM_PAIRS; window <= 0 means no
// window.  fa_bwd_dq_wgmma<hd, hd_v, false>, then
// fa_bwd_dkdv_wgmma<hd, hd_v, false>.
extern "C" int fa_backward_bf16(const void* q, const void* k, const void* v,
                                const void* o, const void* dO,
                                const void* lse, void* D, void* dq, void* dk,
                                void* dv, int B, int Sq, int Sk, int H,
                                int KV, int hd, int hd_v, float scale,
                                int causal, int window, void* stream) {
  return backward<__nv_bfloat16>(q, k, v, o, dO, dO, lse, D, dq, dk, dv, B,
                                 Sq, Sk, H, KV, hd, hd_v, scale, causal,
                                 window, stream);
}

// fa_backward_f32: the same for float32 inputs, q, k and v given as
// split_bf16x3's planes (3, B, S, heads, hd) bf16, o and dO float32 (B,
// Sq, H, hd_v) and dO also as its planes (dO_planes); float32 outputs.
// fa_bwd_dq_wgmma<hd, hd_v, true>, then fa_bwd_dkdv_wgmma<hd, hd_v, true>.
extern "C" int fa_backward_f32(const void* q, const void* k, const void* v,
                               const void* o, const void* dO,
                               const void* dO_planes, const void* lse,
                               void* D, void* dq, void* dk, void* dv, int B,
                               int Sq, int Sk, int H, int KV, int hd,
                               int hd_v, float scale, int causal, int window,
                               void* stream) {
  return backward<float>(q, k, v, o, dO, dO_planes, lse, D, dq, dk, dv, B,
                         Sq, Sk, H, KV, hd, hd_v, scale, causal, window,
                         stream);
}
