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
// bf16 (fa_backward_bf16): fa_bwd_dq_wgmma, then fa_bwd_dkdv_wgmma, on the
// tensor cores (wgmma) fed by TMA.  The arithmetic keeps the forward's
// rule, products exact and only sums on the tensor core:
//   * S = q k^T and dP = dO v^T are bf16 wgmmas into float32: each product
//     of two bf16 values is exact in float32.
//   * P and dS are formed in float32 on the CUDA cores from the
//     accumulator's registers (the forward's predicate and expf; masked
//     pairs exactly 0).
//   * dV += P^T dO, dK += dS^T q and dQ += dS k take P or dS split exactly
//     into three bf16 terms (split3: hi + mid + lo == x for |x| >= 1e-30),
//     one wgmma per term with A from registers, smallest term first, so
//     every product is that of the float32 operand, exact in float32.
//   * The tensor core's sums are not IEEE round-to-nearest (they lean
//     toward zero, flash_attention_sm90.cu's note), and dK / dV sum over G
//     x Sq query rows (8 x 4,096 at TinyLlama's training shape): one
//     accumulator over all of them would drift past half a bf16 ulp.  So,
//     as the float32 forward does with p v, each tile's three-term
//     products go into a fresh accumulator (16 to 64 rows of the sum, in
//     column chunks of at most 64: MERGE_W), merged into the running dQ,
//     dK or dV on the CUDA cores in IEEE float32.  No tensor-core sum is
//     longer than one tile; dK and dQ take `scale` once at the store, and
//     each output is rounded once to bf16.
// float32 (fa_backward_f32): fa_bwd_dq, then fa_bwd_dkdv, float32 math on
// the CUDA cores (64 x 64 shared-memory tiles), held to float64 within
// 2e-5 of max |grad|; a six-plane wgmma design for it is ROADMAP Queue 1
// item 6.
//
// Design of the bf16 kernels (shapes as fa_fwd_wgmma's: q (B, Sq, H, hd),
// k (B, Sk, KV, hd), v (B, Sk, KV, hd_v), o and dO (B, Sq, H, hd_v)).  A CTA
// is 384 threads: two consumer warpgroups of 64 rows each (wgmma's M) and
// one producer warpgroup, which setmaxnreg shrinks to 40 registers a
// thread (as the forward's).  One producer lane issues TMA loads
// through 4-D tensor maps over (B, S, heads, hd), so query head h reads KV
// head h / G in place, and TMA's zero fill covers ragged Sq and Sk; tiles
// land swizzled in boxes chosen per head dim as the forward's (row_bytes).
//   * fa_bwd_dq_wgmma, grid (ceil(Sq / 128), H, B), heaviest causal tiles
//     first: Q and dO of its 128 rows once, then a ring of K / V tiles of BK
//     keys.  D for its rows is summed from the bf16 o and dO first (written
//     for the next kernel).  Per tile: S = Q K^T and dP = dO V^T (A and B
//     from shared memory, K-major), P and dS on the S accumulator's
//     registers, whose pairs of columns are the A fragment of the next
//     wgmma, then dQ += dS K with K the MN-major (transposed) B operand.
//   * fa_bwd_dkdv_wgmma, grid (ceil(Sk / 128), KV, B): K and V of its 128
//     keys once, then a ring of Q / dO tiles of BQ queries over the G query
//     heads and the query tiles that can see its keys; a second producer
//     warp copies each tile's LSE and D into the stage.  Per tile, with
//     the keys as M: S^T = K Q^T and dP^T = V dO^T (Q and dO the K-major B
//     operand), P^T and dS^T on the registers, in the A-fragment layout,
//     then dV += P^T dO and dK += dS^T Q with dO and Q the MN-major B
//     operand.  dK and dV stay in registers; the G heads are summed there.
//   * A warpgroup that can see no pair of a tile (the causal diagonal, a
//     window) skips its products.
//   * Registers bound the tiles.  ptxas allocates a consumer thread within
//     the 168 registers __launch_bounds__(384, 1) leaves, and a dK / dV
//     thread holds (hd + hd_v) / 2 floats of accumulator, plus S^T and
//     dP^T (BQ / 2 each), three bf16 terms (3 BQ / 4) and a merge chunk
//     (<= 32): BwdCfg takes BQ 64 at hd + hd_v <= 160, 32 at hd 112 / 128,
//     16 at MLA's (192, 128) (the last two still spill a little: right,
//     and off the training path); dQ's BK is 64, 32 at hd 192.
//
// Bound.  The gradient needs 4 products per visible pair (S recomputed,
// dP, dV, dK) and dQ one more, 2 (3 hd + 2 hd_v) flops a pair: at the
// training shape (B 4, S 4096, H 32, KV 4, hd 64, causal) 0.69 TFLOP,
// 0.695 ms at the bf16 tensor-core rate (989 TFLOP/s), against ~0.2 GB of
// bf16 inputs and outputs (0.06 ms): bound by operations.  The bf16 design
// issues 13 units of tensor-core work a pair against those 5 (S and dP in
// both kernels, three terms for each of dV, dK and dQ), 2.6 x the bound,
// and pays that rather than round P and dS to bf16 (another function).
// What it leaves: a warpgroup's softmax-gradient math and its wgmmas do not
// overlap (the other warpgroup fills the gap), each merge waits for its
// chunk's products, no persistent scheduler, one CTA per SM.

#include <type_traits>

#include "sm90_common.cuh"  // mbarriers, TMA, wgmma, split3, tensor maps

namespace {

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// ---------------------------------------------------------------------------
// bf16: wgmma / TMA
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;        // rows per consumer warpgroup (M)
constexpr int CTA_ROWS = 128;      // rows of the CTA's own tile (two groups)
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
constexpr int PRODUCER_WARPS = 4;  // one warpgroup, for setmaxnreg
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int WG_THREADS = 32 * (CONSUMER_WARPS + PRODUCER_WARPS);
constexpr int STAGES = 3;          // ring depth of both kernels
constexpr int MERGE_W = 64;        // widest fresh accumulator, columns

// Columns of one fresh-accumulator product for an output of width n: 64
// where n is a multiple of 64 (one 128-byte box a chunk), else all of it
// (16 / 32 / 80 / 112, one chunk).
constexpr int merge_w(int n) { return n % MERGE_W == 0 ? MERGE_W : n; }

template <int HD, int HDV>
struct BwdCfg {
  // Q and K rows: the q/k width; dO and V rows: the v width.
  static constexpr int ROWB = row_bytes(HD);
  static constexpr int CHUNK = ROWB / 2;  // bf16 columns per TMA box
  static constexpr int NCHUNK = HD / CHUNK;
  static constexpr int KPC = CHUNK / 16;  // k16 steps per box
  static constexpr int ROWB_V = row_bytes(HDV);
  static constexpr int CHUNK_V = ROWB_V / 2;
  static constexpr int NCHUNK_V = HDV / CHUNK_V;
  static constexpr int KPC_V = CHUNK_V / 16;
  // dK / dV: queries per tile (S^T's N) from the registers (the note at
  // the top); dQ: keys per tile.
  static constexpr int BQ = HD + HDV <= 160 ? 64 : HD + HDV <= 256 ? 32 : 16;
  static constexpr int BK = HD <= 128 ? 64 : 32;
  static constexpr int MW = merge_w(HD), MW_V = merge_w(HDV);
  // dQ: Q and dO of 128 rows, then the ring of K and V tiles.
  static constexpr int DQ_Q = CTA_ROWS * HD * 2, DQ_DO = CTA_ROWS * HDV * 2;
  static constexpr int DQ_K = BK * HD * 2, DQ_V = BK * HDV * 2;
  static constexpr int DQ_STAGE = DQ_K + DQ_V;
  static constexpr int DQ_SMEM =
      1024 + DQ_Q + DQ_DO + STAGES * DQ_STAGE + 8 * (1 + 2 * STAGES);
  // dK / dV: K and V of 128 keys, then the ring of Q and dO tiles, then
  // each stage's LSE and D (2 BQ floats).
  static constexpr int KV_K = CTA_ROWS * HD * 2, KV_V = CTA_ROWS * HDV * 2;
  static constexpr int KV_Q = BQ * HD * 2, KV_DO = BQ * HDV * 2;
  static constexpr int KV_STAGE = KV_Q + KV_DO;
  static constexpr int KV_SMEM = 1024 + KV_K + KV_V +
                                 STAGES * (KV_STAGE + 8 * BQ) +
                                 8 * (1 + 2 * STAGES);
  static_assert(HD % CHUNK == 0 && HDV % CHUNK_V == 0,
                "head dims must be whole TMA boxes");
  static_assert(MW % CHUNK == 0 && MW_V % CHUNK_V == 0,
                "merge chunks must be whole TMA boxes");
  static_assert(DQ_SMEM <= SMEM_MAX && KV_SMEM <= SMEM_MAX,
                "shared memory per CTA");
};

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

// acc += A B over K = 16 * KSTEPS rows of B, A the three terms of `t`
// (smallest first) and B a tile of `rows` rows at b (MN-major, rowb
// swizzled bytes a row), its output columns in chunks of W: each chunk's
// products go into a fresh accumulator, then added to acc on the CUDA
// cores.  N = the output width (acc holds N / 2 floats).
template <int N, int W, int KSTEPS, int CHUNK_COLS, int TF>
__device__ __forceinline__ void merged_product(float (&acc)[N / 2],
                                               const uint32_t (&t)[3][TF],
                                               uint32_t b, int rows,
                                               int rowb) {
#pragma unroll
  for (int ch = 0; ch < N / W; ++ch) {
    const uint32_t bc = b + (ch * W / CHUNK_COLS) * rows * rowb;
    float tile[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j) tile[j] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int term = 2; term >= 0; --term)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_rs(tile, t[term] + 4 * kk,
                 mnmajor(bc + kk * 16 * rowb, rows, rowb));
    wgmma_commit();
    wgmma_wait_all();
    pin(tile);
#pragma unroll
    for (int j = 0; j < W / 2; ++j) acc[ch * W / 2 + j] += tile[j];
  }
}

// Stores rows r0 and r0 + 8 (those < n) of a 64-row accumulator of width W
// to a (., heads, W) bf16 tensor at base (row stride rs), times mul.
template <int W>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 2],
                                           __nv_bfloat16* base, int64_t rs,
                                           int r0, int n, int lane,
                                           float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* out = base + (int64_t)row * rs + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < W / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) = __floats2bfloat162_rn(
          acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
  }
}

// dQ and D.  Maps: q (B, Sq, H, hd) and dO (B, Sq, H, hd_v) in boxes of
// 128 rows; k (B, Sk, KV, hd), v (B, Sk, KV, hd_v) in boxes of BK rows.
// o and dO (B, Sq, H, hd_v) bf16, lse (B, H, Sq) -> D (B, H, Sq), dq.
template <int HD, int HDV>
__global__ void __launch_bounds__(WG_THREADS, 1)
    fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dO,
                    const float* __restrict__ lse, float* __restrict__ Dout,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                    int KV, float scale, int causal, int window) {
  using C = BwdCfg<HD, HDV>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;  // swizzle-atom aligned
  const uint32_t s_do = s_q + C::DQ_Q;
  const uint32_t s_kv = s_do + C::DQ_DO;  // stage s: K, then V
  const uint32_t q_bar = s_kv + STAGES * C::DQ_STAGE;
  const uint32_t full_bar = q_bar + 8;               // [STAGES]
  const uint32_t empty_bar = full_bar + 8 * STAGES;  // [STAGES]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * CTA_ROWS;
  const int q_valid = min(CTA_ROWS, Sq - q0);
  int kt_hi = (Sk + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (q0 + q_valid - 1) / BK + 1);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(q_bar, C::DQ_Q + C::DQ_DO);
#pragma unroll
      for (int c = 0; c < C::NCHUNK; ++c)
        tma_load(s_q + c * CTA_ROWS * C::ROWB, &tm_q, q_bar, c * C::CHUNK, h,
                 q0, b);
#pragma unroll
      for (int c = 0; c < C::NCHUNK_V; ++c)
        tma_load(s_do + c * CTA_ROWS * C::ROWB_V, &tm_do, q_bar,
                 c * C::CHUNK_V, h, q0, b);
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, C::DQ_STAGE);
        const uint32_t s_k = s_kv + s * C::DQ_STAGE;
        const uint32_t s_v = s_k + C::DQ_K;
#pragma unroll
        for (int c = 0; c < C::NCHUNK; ++c)
          tma_load(s_k + c * BK * C::ROWB, &tm_k, full_bar + 8 * s,
                   c * C::CHUNK, kvh, kt * BK, b);
#pragma unroll
        for (int c = 0; c < C::NCHUNK_V; ++c)
          tma_load(s_v + c * BK * C::ROWB_V, &tm_v, full_bar + 8 * s,
                   c * C::CHUNK_V, kvh, kt * BK, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      CONSUMER_REGS));
  const int wg = warp / 4;
  const int row_lo = q0 + WG_ROWS * wg;
  const int r0 = row_lo + 16 * (warp % 4) + lane / 4;
  const int64_t stat = ((int64_t)b * H + h) * Sq;

  // D and LSE of rows r0 and r0 + 8: the quad's four lanes sum alternate
  // column pairs of o * dO (bf16, exact products), then add in a fixed tree.
  float2 ld[2];
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
    part = quad_sum(part);
    ld[r] = make_float2(row < Sq ? lse[stat + row] : 0.0f, part);
    if (row < Sq && (lane & 3) == 0) Dout[stat + row] = part;
  }

  float acc[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.0f;
  const uint32_t s_qa = s_q + wg * WG_ROWS * C::ROWB;
  const uint32_t s_doa = s_do + wg * WG_ROWS * C::ROWB_V;
  mbar_wait(q_bar, 0);

  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int s = i % STAGES;
    const uint32_t s_k = s_kv + s * C::DQ_STAGE;
    const uint32_t s_v = s_k + C::DQ_K;
    const int k0 = kt * BK;
    mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
    const bool any = row_lo < Sq && (!causal || k0 <= row_lo + WG_ROWS - 1) &&
                     (window <= 0 || k0 + BK - 1 > row_lo - window);
    if (any) {
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = dp[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const int c = j / C::KPC, off = (j % C::KPC) * 32;
        wgmma_ss(sc, kmajor(s_qa + c * CTA_ROWS * C::ROWB + off, C::ROWB),
                 kmajor(s_k + c * BK * C::ROWB + off, C::ROWB), j > 0);
      }
#pragma unroll
      for (int j = 0; j < HDV / 16; ++j) {
        const int c = j / C::KPC_V, off = (j % C::KPC_V) * 32;
        wgmma_ss(dp,
                 kmajor(s_doa + c * CTA_ROWS * C::ROWB_V + off, C::ROWB_V),
                 kmajor(s_v + c * BK * C::ROWB_V + off, C::ROWB_V), j > 0);
      }
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
      merged_product<HD, C::MW, BK / 16, C::CHUNK>(acc, t, s_k, BK, C::ROWB);
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

// dK and dV.  Maps: k, v in boxes of 128 rows; q, dO in boxes of BQ rows.
// lse and D (B, H, Sq) -> dk (B, Sk, KV, hd), dv (B, Sk, KV, hd_v).
template <int HD, int HDV>
__global__ void __launch_bounds__(WG_THREADS, 1)
    fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ Din,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                      int KV, float scale, int causal, int window) {
  using C = BwdCfg<HD, HDV>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_k = (raw + 1023u) & ~1023u;  // swizzle-atom aligned
  const uint32_t s_v = s_k + C::KV_K;
  const uint32_t s_ring = s_v + C::KV_V;  // stage s: Q, then dO
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
  const int k0 = kt * CTA_ROWS;
  // Query tiles holding a query that may see a key of this tile.
  const int qt_lo = causal ? k0 / BQ : 0;
  int qt_hi = (Sq + BQ - 1) / BQ;
  if (window > 0) qt_hi = min(qt_hi, (k0 + CTA_ROWS + window - 2) / BQ + 1);
  const int nqt = max(0, qt_hi - qt_lo);
  const int n_it = G * nqt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      // The TMA lane's arrive (with the bytes) and the stats warp's 32.
      mbar_init(full_bar + 8 * s, 33);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {  // TMA
      mbar_expect_tx(kv_bar, C::KV_K + C::KV_V);
#pragma unroll
      for (int c = 0; c < C::NCHUNK; ++c)
        tma_load(s_k + c * CTA_ROWS * C::ROWB, &tm_k, kv_bar, c * C::CHUNK,
                 kvh, k0, b);
#pragma unroll
      for (int c = 0; c < C::NCHUNK_V; ++c)
        tma_load(s_v + c * CTA_ROWS * C::ROWB_V, &tm_v, kv_bar,
                 c * C::CHUNK_V, kvh, k0, b);
      for (int i = 0; i < n_it; ++i) {
        const int s = i % STAGES;
        const int h = kvh * G + i / nqt, q0 = (qt_lo + i % nqt) * BQ;
        mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, C::KV_STAGE);
        const uint32_t s_q = s_ring + s * C::KV_STAGE;
        const uint32_t s_do = s_q + C::KV_Q;
#pragma unroll
        for (int c = 0; c < C::NCHUNK; ++c)
          tma_load(s_q + c * BQ * C::ROWB, &tm_q, full_bar + 8 * s,
                   c * C::CHUNK, h, q0, b);
#pragma unroll
        for (int c = 0; c < C::NCHUNK_V; ++c)
          tma_load(s_do + c * BQ * C::ROWB_V, &tm_do, full_bar + 8 * s,
                   c * C::CHUNK_V, h, q0, b);
      }
    } else if (warp == CONSUMER_WARPS + 1) {  // LSE and D into the stage
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

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      CONSUMER_REGS));
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
    const uint32_t s_do = s_q + C::KV_Q;
    mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
    const bool any = key_lo < Sk && q0 < Sq &&
                     (!causal || q0 + BQ - 1 >= key_lo) &&
                     (window <= 0 || q0 < key_lo + WG_ROWS - 1 + window);
    if (any) {
      // S^T = K Q^T and dP^T = V dO^T: the keys as M, queries as N.
      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] = dpt[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const int c = j / C::KPC, off = (j % C::KPC) * 32;
        wgmma_ss(st, kmajor(s_ka + c * CTA_ROWS * C::ROWB + off, C::ROWB),
                 kmajor(s_q + c * BQ * C::ROWB + off, C::ROWB), j > 0);
      }
#pragma unroll
      for (int j = 0; j < HDV / 16; ++j) {
        const int c = j / C::KPC_V, off = (j % C::KPC_V) * 32;
        wgmma_ss(dpt,
                 kmajor(s_va + c * CTA_ROWS * C::ROWB_V + off, C::ROWB_V),
                 kmajor(s_do + c * BQ * C::ROWB_V + off, C::ROWB_V), j > 0);
      }
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
        merged_product<HDV, C::MW_V, BQ / 16, C::CHUNK_V>(dv_acc, t, s_do, BQ,
                                                          C::ROWB_V);
        pin(t[0]);
        pin(t[1]);
        pin(t[2]);
      }
      {
        // dK += dS^T Q, Q the MN-major B operand.
        uint32_t t[3][BQ / 4];
        split_terms(dpt, t);
        merged_product<HD, C::MW, BQ / 16, C::CHUNK>(dk_acc, t, s_q, BQ,
                                                     C::ROWB);
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

template <int HD, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dO, const void* lse, void* D, void* dq, void* dk,
                 void* dv, int B, int Sq, int Sk, int H, int KV, float scale,
                 int causal, int window, cudaStream_t stream) {
  using C = BwdCfg<HD, HDV>;
  if (Sq == 0) {  // no query: dK = dV = 0 exactly
    cudaError_t e = cudaMemsetAsync(dk, 0, (size_t)B * Sk * KV * HD * 2,
                                    stream);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(dv, 0, (size_t)B * Sk * KV * HDV * 2, stream);
    return (int)e;
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const CUtensorMapSwizzle sw = swizzle_of(C::ROWB);
  const CUtensorMapSwizzle sw_v = swizzle_of(C::ROWB_V);
  // dQ's maps (Q / dO in 128 rows, K / V in BK), then dK / dV's (K / V in
  // 128 rows, Q / dO in BQ).
  CUtensorMap a_q, a_k, a_v, a_do, b_q, b_k, b_v, b_do;
  if (!make_map(enc, &a_q, q, B, Sq, H, HD, C::CHUNK, CTA_ROWS, sw) ||
      !make_map(enc, &a_k, k, B, Sk, KV, HD, C::CHUNK, C::BK, sw) ||
      !make_map(enc, &a_v, v, B, Sk, KV, HDV, C::CHUNK_V, C::BK, sw_v) ||
      !make_map(enc, &a_do, dO, B, Sq, H, HDV, C::CHUNK_V, CTA_ROWS, sw_v) ||
      !make_map(enc, &b_q, q, B, Sq, H, HD, C::CHUNK, C::BQ, sw) ||
      !make_map(enc, &b_k, k, B, Sk, KV, HD, C::CHUNK, CTA_ROWS, sw) ||
      !make_map(enc, &b_v, v, B, Sk, KV, HDV, C::CHUNK_V, CTA_ROWS, sw_v) ||
      !make_map(enc, &b_do, dO, B, Sq, H, HDV, C::CHUNK_V, C::BQ, sw_v))
    return ERR_TENSOR_MAP;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dq_wgmma<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::DQ_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dkdv_wgmma<HD, HDV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::KV_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  using bf16 = __nv_bfloat16;
  fa_bwd_dq_wgmma<HD, HDV><<<dim3((Sq + CTA_ROWS - 1) / CTA_ROWS, H, B),
                             WG_THREADS, C::DQ_SMEM, stream>>>(
      a_q, a_k, a_v, a_do, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<float*>(D), static_cast<bf16*>(dq), Sq, Sk, H, KV, scale,
      causal, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkdv_wgmma<HD, HDV><<<dim3((Sk + CTA_ROWS - 1) / CTA_ROWS, KV, B),
                               WG_THREADS, C::KV_SMEM, stream>>>(
      b_q, b_k, b_v, b_do, static_cast<const float*>(lse),
      static_cast<const float*>(D), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, KV, scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
// Tiles are 64 x 64; a CTA is 16 x 16 threads, thread (ty, tx) owning rows
// ty + 16a (a < 4) and columns tx + 16c, so a warp reads at most two rows
// of the row operand (a broadcast) and sixteen consecutive words of the
// column operand.  Every tile is float32 in shared memory with an odd row
// stride (width + 1), so a column read down sixteen rows also hits sixteen
// banks.  It does 14 hd flops a pair (S and dP are recomputed in both
// kernels), reading two shared-memory words per FMA pair in its inner
// loops: it is bound by shared-memory bandwidth, 11x its 4.170 ms bound
// (six bf16 plane passes at 989 / 6 TFLOP/s) at the training shape.

constexpr int BR = 64;         // rows of every tile (queries or keys)
constexpr int THREADS = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int TR = BR / 16;    // rows (and score columns) per thread

// Rows r0 .. r0 + BR - 1 of a (rows, W) slab whose row i starts at
// src + i * stride, into dst (row stride W + 1); rows at or past n are
// zero.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int r0, int n) {
  for (int idx = threadIdx.x; idx < BR * W; idx += THREADS) {
    const int r = idx / W, c = idx % W;
    dst[r * (W + 1) + c] = r0 + r < n ? src[(int64_t)(r0 + r) * stride + c]
                                      : 0.0f;
  }
}

// s[a][b] = Q_i . K_j and dp[a][b] = dO_i . V_j for i = ty + 16a and
// j = tx + 16b of the 64 x 64 tile pair.
template <int HD, int HDV>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       const float* dOs, const float* Vs,
                                       int ty, int tx, float s[TR][TR],
                                       float dp[TR][TR]) {
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int b = 0; b < TR; ++b) s[a][b] = dp[a][b] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float x[TR], y[TR];
#pragma unroll
    for (int a = 0; a < TR; ++a) x[a] = Qs[(ty + 16 * a) * (HD + 1) + d];
#pragma unroll
    for (int b = 0; b < TR; ++b) y[b] = Ks[(tx + 16 * b) * (HD + 1) + d];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < TR; ++b) s[a][b] = fmaf(x[a], y[b], s[a][b]);
  }
#pragma unroll 4
  for (int e = 0; e < HDV; ++e) {
    float x[TR], y[TR];
#pragma unroll
    for (int a = 0; a < TR; ++a) x[a] = dOs[(ty + 16 * a) * (HDV + 1) + e];
#pragma unroll
    for (int b = 0; b < TR; ++b) y[b] = Vs[(tx + 16 * b) * (HDV + 1) + e];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int b = 0; b < TR; ++b) dp[a][b] = fmaf(x[a], y[b], dp[a][b]);
  }
}

// P and dS of the tile pair (query rows q0.., keys k0..) from s and dp;
// P into Ps when it is given, dS into dSs (both row stride BR + 1, query
// rows first).
__device__ __forceinline__ void tile_grad(
    const float s[TR][TR], const float dp[TR][TR], const float* Ls,
    const float* Dsm, float* Ps, float* dSs, int ty, int tx, int q0, int k0,
    int Sq, int Sk, float scale, int causal, int window) {
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < TR; ++b) {
      const int j = tx + 16 * b;
      const float p = visible(q0 + i, k0 + j, Sq, Sk, causal, window)
                          ? expf(s[a][b] * scale - Ls[i])
                          : 0.0f;
      if (Ps != nullptr) Ps[i * (BR + 1) + j] = p;
      dSs[i * (BR + 1) + j] = p * (dp[a][b] - Dsm[i]);
    }
  }
}

template <int HD, int HDV>
constexpr int dq_smem() {
  return 4 * (BR * (HD + 1) * 2 + BR * (HDV + 1) * 2 + BR * (BR + 1) +
              2 * BR);
}
template <int HD, int HDV>
constexpr int dkdv_smem() {
  return dq_smem<HD, HDV>() + 4 * BR * (BR + 1);
}

// q (B, Sq, H, HD), k (B, Sk, KV, HD), v (B, Sk, KV, HDV), o and dO (B, Sq,
// H, HDV), lse (B, H, Sq) -> dq (B, Sq, H, HD) and D (B, H, Sq).
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dO, const float* __restrict__ lse,
              float* __restrict__ Dout, float* __restrict__ dq, int Sq,
              int Sk, int H, int KV, float scale, int causal, int window) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BR * (HD + 1);
  float* dOs = Ks + BR * (HD + 1);
  float* Vs = dOs + BR * (HDV + 1);
  float* dSs = Vs + BR * (HDV + 1);
  float* Ls = dSs + BR * (BR + 1);
  float* Dsm = Ls + BR;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BR;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t qrow = (int64_t)H * HD, orow = (int64_t)H * HDV;
  const float* qb = q + (int64_t)b * Sq * qrow + (int64_t)h * HD;
  const float* ob = o + (int64_t)b * Sq * orow + (int64_t)h * HDV;
  const float* dob = dO + (int64_t)b * Sq * orow + (int64_t)h * HDV;
  const int64_t stat = ((int64_t)b * H + h) * Sq;

  load_tile<HD>(Qs, qb, qrow, q0, Sq);
  load_tile<HDV>(dOs, dob, orow, q0, Sq);
  if (threadIdx.x < BR)
    Ls[threadIdx.x] = q0 + threadIdx.x < Sq ? lse[stat + q0 + threadIdx.x]
                                            : 0.0f;
  __syncthreads();
  // D = rowsum(dO * O): each thread sums its columns of its rows, then the
  // sixteen threads of a row (one half-warp) add in a fixed tree.
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int i = ty + 16 * a;
    float part = 0.0f;
    if (q0 + i < Sq)
#pragma unroll
      for (int c = 0; c < HDV / 16; ++c)
        part = fmaf(dOs[i * (HDV + 1) + tx + 16 * c],
                    ob[(int64_t)(q0 + i) * orow + tx + 16 * c], part);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0) {
      Dsm[i] = part;
      if (q0 + i < Sq) Dout[stat + q0 + i] = part;
    }
  }

  int kt_hi = (Sk + BR - 1) / BR;
  if (causal) kt_hi = min(kt_hi, (min(q0 + BR, Sq) - 1) / BR + 1);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BR : 0;
  const int64_t krow = (int64_t)KV * HD, vrow = (int64_t)KV * HDV;
  const float* kb = k + (int64_t)b * Sk * krow + (int64_t)kvh * HD;
  const float* vb = v + (int64_t)b * Sk * vrow + (int64_t)kvh * HDV;

  float acc[TR][HD / 16];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[a][c] = 0.0f;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();  // the last tile's readers are done (and Dsm is set)
    load_tile<HD>(Ks, kb, krow, k0, Sk);
    load_tile<HDV>(Vs, vb, vrow, k0, Sk);
    __syncthreads();
    float s[TR][TR], dp[TR][TR];
    scores<HD, HDV>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
    tile_grad(s, dp, Ls, Dsm, nullptr, dSs, ty, tx, q0, k0, Sq, Sk, scale,
              causal, window);
    __syncthreads();
    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < BR; ++j) {
      float x[TR];
#pragma unroll
      for (int a = 0; a < TR; ++a) x[a] = dSs[(ty + 16 * a) * (BR + 1) + j];
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const float y = Ks[j * (HD + 1) + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < TR; ++a) acc[a][c] = fmaf(x[a], y, acc[a][c]);
      }
    }
  }
  float* dqb = dq + (int64_t)b * Sq * qrow + (int64_t)h * HD;
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c)
      dqb[(int64_t)row * qrow + tx + 16 * c] = acc[a][c] * scale;
  }
}

// The same tensors, lse and D (B, H, Sq) -> dk (B, Sk, KV, HD) and dv (B,
// Sk, KV, HDV).
template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ Din,
                float* __restrict__ dk, float* __restrict__ dv, int Sq,
                int Sk, int H, int KV, float scale, int causal, int window) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BR * (HD + 1);
  float* dOs = Ks + BR * (HD + 1);
  float* Vs = dOs + BR * (HDV + 1);
  float* dSs = Vs + BR * (HDV + 1);
  float* Ls = dSs + BR * (BR + 1);
  float* Dsm = Ls + BR;
  float* Ps = Dsm + BR;

  const int kt = blockIdx.x;  // causal: key tile 0 sees the most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int k0 = kt * BR;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t krow = (int64_t)KV * HD, vrow = (int64_t)KV * HDV;
  load_tile<HD>(Ks, k + (int64_t)b * Sk * krow + (int64_t)kvh * HD, krow, k0,
                Sk);
  load_tile<HDV>(Vs, v + (int64_t)b * Sk * vrow + (int64_t)kvh * HDV, vrow,
                 k0, Sk);

  // Query tiles holding a query that may see a key of this tile.
  const int qt_lo = causal ? k0 / BR : 0;
  int qt_hi = (Sq + BR - 1) / BR;
  if (window > 0) qt_hi = min(qt_hi, (k0 + BR + window - 2) / BR + 1);
  const int64_t qrow = (int64_t)H * HD, orow = (int64_t)H * HDV;

  float dk_acc[TR][HD / 16], dv_acc[TR][HDV / 16];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dk_acc[a][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < HDV / 16; ++c) dv_acc[a][c] = 0.0f;
  }
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qb = q + (int64_t)b * Sq * qrow + (int64_t)h * HD;
    const float* dob = dO + (int64_t)b * Sq * orow + (int64_t)h * HDV;
    const int64_t stat = ((int64_t)b * H + h) * Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BR;
      __syncthreads();  // the last tile's readers are done
      load_tile<HD>(Qs, qb, qrow, q0, Sq);
      load_tile<HDV>(dOs, dob, orow, q0, Sq);
      if (threadIdx.x < BR) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < Sq ? lse[stat + row] : 0.0f;
        Dsm[threadIdx.x] = row < Sq ? Din[stat + row] : 0.0f;
      }
      __syncthreads();
      float s[TR][TR], dp[TR][TR];
      scores<HD, HDV>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
      tile_grad(s, dp, Ls, Dsm, Ps, dSs, ty, tx, q0, k0, Sq, Sk, scale,
                causal, window);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's query rows.
#pragma unroll 4
      for (int i = 0; i < BR; ++i) {
        float pj[TR], sj[TR];
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          pj[a] = Ps[i * (BR + 1) + ty + 16 * a];
          sj[a] = dSs[i * (BR + 1) + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < HDV / 16; ++c) {
          const float y = dOs[i * (HDV + 1) + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < TR; ++a)
            dv_acc[a][c] = fmaf(pj[a], y, dv_acc[a][c]);
        }
#pragma unroll
        for (int c = 0; c < HD / 16; ++c) {
          const float y = Qs[i * (HD + 1) + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < TR; ++a)
            dk_acc[a][c] = fmaf(sj[a], y, dk_acc[a][c]);
        }
      }
    }
  }
  float* dkb = dk + (int64_t)b * Sk * krow + (int64_t)kvh * HD;
  float* dvb = dv + (int64_t)b * Sk * vrow + (int64_t)kvh * HDV;
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= Sk) continue;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c)
      dkb[(int64_t)row * krow + tx + 16 * c] = dk_acc[a][c] * scale;
#pragma unroll
    for (int c = 0; c < HDV / 16; ++c)
      dvb[(int64_t)row * vrow + tx + 16 * c] = dv_acc[a][c];
  }
}

template <int HD, int HDV>
int launch_cuda_cores(const void* q, const void* k, const void* v,
                      const void* o, const void* dO, const void* lse, void* D,
                      void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                      int H, int KV, float scale, int causal, int window,
                      cudaStream_t stream) {
  constexpr int SM_DQ = dq_smem<HD, HDV>();
  constexpr int SM_DKDV = dkdv_smem<HD, HDV>();
  static_assert(SM_DKDV <= SMEM_MAX, "tiles exceed the shared-memory budget");
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dq<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SM_DQ);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dkdv<HD, HDV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SM_DKDV);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dO);
  const float* tl = static_cast<const float*>(lse);
  float* tD = static_cast<float*>(D);
  if (Sq > 0) {
    fa_bwd_dq<HD, HDV><<<dim3((Sq + BR - 1) / BR, H, B), THREADS, SM_DQ,
                         stream>>>(tq, tk, tv, static_cast<const float*>(o),
                                   tdo, tl, tD, static_cast<float*>(dq), Sq,
                                   Sk, H, KV, scale, causal, window);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  fa_bwd_dkdv<HD, HDV><<<dim3((Sk + BR - 1) / BR, KV, B), THREADS, SM_DKDV,
                         stream>>>(tq, tk, tv, tdo, tl, tD,
                                   static_cast<float*>(dk),
                                   static_cast<float*>(dv), Sq, Sk, H, KV,
                                   scale, causal, window);
  return (int)cudaGetLastError();
}

// bf16 takes the wgmma kernels, float32 the CUDA-core ones.
template <int HD, int HDV, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const void* lse, void* D, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int H, int KV, float scale,
           int causal, int window, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>)
    return launch_cuda_cores<HD, HDV>(q, k, v, o, dO, lse, D, dq, dk, dv, B,
                                      Sq, Sk, H, KV, scale, causal, window,
                                      stream);
  else
    return launch_wgmma<HD, HDV>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Sq,
                                 Sk, H, KV, scale, causal, window, stream);
}

// The head dims and (q/k, v) pairs of the forward kernel
// (flash_attention_sm90.cu's HEAD_DIMS and HEAD_DIM_PAIRS; the wrapper
// holds one list for both sources).
#define HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(112) X(128)
#define HEAD_DIM_PAIRS(X) X(192, 128)

template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dO, const void* lse, void* D, void* dq, void* dk,
             void* dv, int B, int Sq, int Sk, int H, int KV, int hd,
             int hd_v, float scale, int causal, int window, void* stream) {
  if (B == 0 || Sk == 0 || KV == 0) return 0;
  if (H <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(HD, HDV)                                                       \
  if (hd == HD && hd_v == HDV)                                              \
    return launch<HD, HDV, T>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Sq, Sk, \
                              H, KV, scale, causal, window, st);
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
// ERR_NO_ENCODER / ERR_TENSOR_MAP (negative, bf16 only).
//
// fa_backward_bf16: bf16 q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV,
// hd_v), o and dO (B, Sq, H, hd_v), contiguous and 16-byte aligned;
// float32 lse (B, H, Sq) from the forward and scratch D (B, H, Sq); bf16
// outputs dq, dk, dv of q's, k's and v's shapes.  hd == hd_v one of
// HEAD_DIMS, or (hd, hd_v) one of HEAD_DIM_PAIRS; window <= 0 means no
// window.  fa_bwd_dq_wgmma, then fa_bwd_dkdv_wgmma.
extern "C" int fa_backward_bf16(const void* q, const void* k, const void* v,
                                const void* o, const void* dO,
                                const void* lse, void* D, void* dq, void* dk,
                                void* dv, int B, int Sq, int Sk, int H,
                                int KV, int hd, int hd_v, float scale,
                                int causal, int window, void* stream) {
  return backward<__nv_bfloat16>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Sq,
                                 Sk, H, KV, hd, hd_v, scale, causal, window,
                                 stream);
}

// fa_backward_f32: the same with float32 q, k, v, o, dO and outputs:
// fa_bwd_dq, then fa_bwd_dkdv.
extern "C" int fa_backward_f32(const void* q, const void* k, const void* v,
                               const void* o, const void* dO, const void* lse,
                               void* D, void* dq, void* dk, void* dv, int B,
                               int Sq, int Sk, int H, int KV, int hd,
                               int hd_v, float scale, int causal, int window,
                               void* stream) {
  return backward<float>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Sq, Sk, H,
                         KV, hd, hd_v, scale, causal, window, stream);
}
