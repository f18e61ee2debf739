// Flash attention forward for Hopper (sm_90a): causal / sliding-window GQA
// attention with an online softmax, float32 statistics and accumulator,
// its products on the tensor cores (wgmma).  Replaces the TPU Pallas
// kernel flash_attention_pallas (src/repro/kernels/flash_attention.py:82,
// body _fa_kernel) for bf16 q/k/v (fa_fwd_wgmma<HD, HDV, false>,
// fa_forward_bf16) and for float32 q/k/v (fa_fwd_wgmma<HD, HDV, true>,
// fa_forward_f32, fed the bf16 planes of split_bf16x3_kernel).  HD is the
// head dim of q and k, HDV that of v and o: equal for every model but
// DeepSeek-V2's MLA, whose prefill attends with q/k 192 (nope 128 + rope
// 64) against v 128, as the JAX package's layers.flash_attention does
// with hd_v = v.shape[-1] (the Pallas body itself ties hd_v to hd).
//
// The function is the Pallas body's; its products are exact or within
// float32's own rounding, and only its sums are the tensor core's:
//   * bf16 inputs, S = q k^T.  A bf16 x bf16 product is exact in float32
//     (8 + 8 significant bits), so a bf16 wgmma accumulating in float32
//     sums the body's exact products of the upcast inputs.  Scores are
//     dot * scale, as the body.
//   * O += p v with p in float32 (the JAX package's default, ATTN_P_BF16 =
//     False).  p splits exactly into three bf16 terms, hi = bf16(p), mid =
//     bf16(p - hi), lo = bf16(p - hi - mid) (round to nearest, exact
//     float32 subtractions: 24 bits = 8 + 8 + 8), for every p >= 1e-30;
//     below that lo may be subnormal and the tensor cores may flush it,
//     which moves l >= 1 by far less than a float32 ulp.  Each term times
//     a bf16 v is exact in float32, so for bf16 v three wgmmas into one
//     float32 accumulator sum exactly the float32 p @ v's products.
//   * float32 inputs.  split_bf16x3_kernel writes each of q, k and v as
//     three bf16 planes the same way (exact for |x| from about 2^-110,
//     below which lo is a bf16 subnormal, up to bf16's largest finite
//     value, about 3.39e38).  A float32 product x y is then the sum of the
//     nine plane products x_a y_b, each exact in float32.  The kernel
//     issues six of them, dropping mid*lo, lo*mid and lo*lo (each at most
//     2^-24 |x y|): each product it forms is within 2^-23 |x y| of the
//     exact one, about float32's own rounding of a product (unit roundoff
//     2^-24); six bf16 passes is also how a TPU forms a float32 product at
//     Precision.HIGHEST.  Both S = q k^T and each tile's p v take the six
//     passes, smallest terms first and hi * hi last, so the small terms
//     are summed among themselves before the large ones round them.  Six
//     passes, not nine, ship: they hold every check of chip_smoke.py
//     phase 2b (2e-5 against the plain version, and against float64).
//   * The sums are not IEEE float32 round-to-nearest: the tensor core
//     adds in its own order and rounding.  Measured on an H100 against the
//     float64 function, on random inputs the output leans slightly toward
//     smaller magnitude (far under a bf16 ulp), and on a model's
//     ill-conditioned rows (near-tied scores, cancelling outputs) it is
//     closer than the float32 plain version is (chip_smoke.py phase 5b).
//     So the float32 kernel does as the Pallas body does: each key tile's
//     p v goes into a fresh accumulator, merged as acc * alpha + tile on
//     the CUDA cores (IEEE), and no tensor-core sum runs longer than one
//     tile.  This source is built without --use_fast_math so the splits
//     round as written.
//   * Masked scores are -1e30 and m starts at -1e30, as the body (a row
//     whose first tile is fully masked sums junk that alpha = 0 wipes once
//     a real key arrives); keys past Sk score -inf (weight exactly 0); the
//     output is acc / max(l, 1e-30), rounded once to bf16 for bf16 inputs.
//     Causality is top-left aligned (qpos >= kpos), the window test
//     kpos > qpos - window.
//   * Given a float32 lse pointer (training), the store also writes each
//     row's log-sum-exp m + log(l), in natural log as the softmax's expf,
//     which flash_attention_bwd_sm90.cu recomputes P from; serving passes
//     null and the kernel's work and output are the same either way.
//
// Design.  One CTA of 384 threads per 128-row query tile, grid
// (ceil(Sq/128), H, B), heaviest causal tiles first.  Warps 0-7 are two
// consumer warpgroups of 64 query rows each; warps 8-11 are the producer,
// whose registers setmaxnreg moves to the consumers: one lane issues TMA
// loads of Q (once) and of each K/V tile into a ring of STAGES stages
// guarded by full/empty mbarriers.  TMA reads the tensors in
// place through 4-D tensor maps over (B, S, heads, hd) (float32: over
// (3B, S, heads, hd), the planes stacked on the batch axis), so query
// head h reads KV head h / (H / KV) with no transpose and no expanded
// K/V; its zero fill covers ragged Sq and Sk.  Tiles land swizzled in
// TMA boxes, the layout wgmma's descriptors name: 64-column boxes of
// 128-byte rows where hd is a multiple of 64 (hd 128 two of them), one
// 32-column box of 64-byte rows at hd 32, and otherwise 16-column boxes of
// 32-byte rows (hd 16 one, hd 80 five, hd 112 seven), one k16 step each.
// Q and K tiles are laid out by the q/k width, V tiles by the v width
// (MLA: three 64-column boxes of Q and K, two of V).
// Per K/V tile a consumer warpgroup runs S = Q K^T as HD/16 wgmmas per
// pass (A and B from shared memory, K-major), the online softmax on the
// accumulator's registers (row max and sum are quad shuffles; mask tests
// only on tiles that cross the diagonal, the window edge or Sk), splits
// p into its three bf16 terms directly in the A-fragment layout (the S
// accumulator's pair of columns per register is the A fragment's), and
// runs P V as BK/16 wgmmas of N = HDV per pass with A from registers and
// B the V tile read MN-major (transposed).  No p tile passes through
// shared memory.  The output is stored from registers, rows past Sq
// skipped.
// The float32 kernel holds three planes of Q and of each K and V tile, so
// its tiles are smaller.  Cfg takes the tile and the ring depth from the
// shared-memory budget: bf16 BK 128 at hd <= 64, else 64, three stages;
// float32 BK 64 and three stages at hd 16 / 32 / 64 (193 KB at hd 64),
// BK 32 and three stages at hd 80 / 112 (151 / 211 KB), BK 32 and two
// stages at hd 128 (193 KB), and BK 32 with one stage at MLA's (192, 128)
// (205 KB: Q alone is 144 KB), where a tile's loads do not overlap its
// products.  bf16 at (192, 128): BK 64, three stages (169 KB).
//
// Bound.  Operations: the function needs 2 * B * H * (hd + hd_v) *
// (visible pairs) flops, 0.275 TFLOP at the prefill shape (B 4, S 4096,
// H 32, hd 64, causal), 0.278 ms at 989 TFLOP/s (bf16 dense), against
// ~0.13 GB of bf16 q/k/v/o (0.04 ms); MLA's prefill (B 4, S 4096, H 128,
// 192 / 128) 2.75 TFLOP, 2.780 ms, against ~2.7 GB (0.8 ms).  bf16: the
// split triples p @ v, so the kernel issues (hd + 3 hd_v) / (hd + hd_v)
// times the function's tensor-core work (2x at equal widths, 1.8x at
// MLA's); rounding p is the p_bf16 route's function (below), not this
// one's.  float32:
// six passes on both products, 6x the function's work, a floor of 1.668
// ms at 989 / 6 TFLOP/s against ~0.30 GB of float32 q/k/v/o (0.09 ms);
// the split pass moves 10 bytes per element (0.1 ms for q at that shape).
// What it leaves: softmax and wgmma of one warpgroup do not overlap (the
// other warpgroup fills the gap), no persistent scheduler, one CTA per SM.
//
// The p_bf16 route (fa_fwd_wgmma<HD, HDV, F32, true>: fa_forward_bf16_pbf16,
// fa_forward_f32_pbf16) computes JAX's other function, flags.ATTN_P_BF16 =
// True (src/repro/models/layers.py:109): per key chunk of its
// layers.flash_attention (1,024 keys, min(1024, Sk)), p = exp(s - m_b)
// against the chunk's own row max m_b, rounded to bf16, times bf16(v),
// summed in float32; l_b the float32 sum of the unrounded p; the chunks
// merged as JAX merges them (m = max(m, m_b), acc * alpha + o_b * beta,
// l * alpha + l_b * beta).  The rounding is against the chunk's max, not a
// running max over the kernel's tiles, or the kernel would round other p
// than JAX's.  So each chunk takes two passes over its tiles: S alone for
// m_b, reduced with fmaxf and nothing else, then S again, p, and P V as
// ONE bf16 term of p in a fresh accumulator for the chunk (p is bf16
// already; float32 inputs: against v's hi plane, exactly bf16(v), the
// only V plane loaded).  Tensor-core work per visible pair: bf16 2 hd +
// hd_v against the float32-p route's hd + 3 hd_v (1.5x the function's
// work at equal widths against 2x); float32 12 hd + hd_v against 6 hd + 6
// hd_v.  The chunk's sum of p v runs up to 1,024 keys in one tensor-core
// accumulator: its drift is far below the bf16 rounding of p that sets the
// route's distance from the float32-p function.  Given mstat (training)
// the second pass also compares each score with m_b (its S is the first
// pass's bit for bit) and stores each row's (m_b, first and last maximal
// key, their count) per chunk, (-1e30, 0, 0, 0) where the row sees no key,
// for the backward's split of the max's cotangent over tied keys; serving
// skips that test.
// Measured on the card (attention_rate.py, PERF.md) against designs that
// overlap more: S in 64-key halves with the next half's S in flight while
// one is reduced (two S buffers, wgmma_wait<1>) and P V beside the next
// S, with the statistics a second compiled copy of the chunk loop, ran no
// faster in bf16 and a third slower in float32 (its 24-wgmma S issued
// ahead and the doubled code); a ring of up to six stages ran no faster.
// What was slow was the first pass's per-element search for the first
// maximal key (a compare and branch on every score).  The producer still
// loads each K tile twice, once a pass: keeping a chunk's K resident for
// the second pass is not built.  Spills (nvcc -Xptxas=-v through
// attention_rate.py --ptxas; PERF.md): none but float32's at (192, 128).

#include <algorithm>
#include <type_traits>

#include "sm90_common.cuh"  // mbarriers, TMA, wgmma, split3, tensor maps

namespace {

constexpr int BQ = 128;            // query rows per CTA
constexpr int WG_ROWS = 64;        // query rows per consumer warpgroup
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
// The producer is a whole warpgroup (one lane issues every load) so that
// setmaxnreg can hand its registers to the consumers: 168 a thread at
// launch (65,536 over 384 threads), then 40 for the producer and 232 for
// the consumers, who hold S, O and p's three bf16 terms (float32 inputs:
// and one tile's P V).
constexpr int PRODUCER_WARPS = 4;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int THREADS = 32 * (CONSUMER_WARPS + PRODUCER_WARPS);
constexpr float MASKED = -1e30f;

// The float32 kernel's plane products (PASSES, pass_a, pass_b) are
// sm90_common.cuh's, shared with the float32 backward.

// Keys of one of JAX's key chunks (layers.flash_attention's k_chunk,
// min(1024, Sk)): the p_bf16 route rounds p against each chunk's row max.
constexpr int CHUNK_KEYS = 1024;

// Shared memory of one CTA: 1024 bytes of slack to align the tiles to the
// swizzle atom, then `planes` planes of Q (q/k width hd), the ring of
// `stages` stages of K (hd, `planes` planes) and V (v width hdv, `vplanes`
// planes) tiles of `bk` keys, and 1 + 2 * stages mbarriers.
constexpr int smem_bytes(int hd, int hdv, int planes, int vplanes, int bk,
                         int stages) {
  return 1024 + planes * BQ * hd * 2 +
         stages * bk * (planes * hd + vplanes * hdv) * 2 +
         8 * (1 + 2 * stages);
}


// HD: the q/k head dim (Q and K tiles, S = Q K^T); HDV: the v head dim (V
// tiles, P V, O).  HDV == HD gives every model's layout but MLA's.
template <int HD, int HDV, bool F32, bool PB>
struct Cfg {
  // bf16 planes per operand: float32 q, k and v come as three; the p_bf16
  // route reads only v's hi plane, bf16(v).
  static constexpr int PLANES = F32 ? 3 : 1;
  static constexpr int V_PLANES = F32 && !PB ? 3 : 1;
  // Keys per tile and the K/V ring depth, from the shared-memory budget:
  // the widest tile the registers allow (S holds BK / 2 floats a thread
  // beside the HDV / 2 of O, and float32's HDV / 2 of one tile's P V),
  // with three stages if they fit, else half the tile with three, else
  // half the tile with two, else with one.
  static constexpr int BK_MAX = F32 ? 64 : (HD <= 64 && HDV <= 64 ? 128 : 64);
  static constexpr bool FULL3 =
      smem_bytes(HD, HDV, PLANES, V_PLANES, BK_MAX, 3) <= SMEM_MAX;
  static constexpr bool HALF3 =
      smem_bytes(HD, HDV, PLANES, V_PLANES, BK_MAX / 2, 3) <= SMEM_MAX;
  static constexpr bool HALF2 =
      smem_bytes(HD, HDV, PLANES, V_PLANES, BK_MAX / 2, 2) <= SMEM_MAX;
  static constexpr int BK = FULL3 ? BK_MAX : BK_MAX / 2;
  static constexpr int STAGES = FULL3 || HALF3 ? 3 : HALF2 ? 2 : 1;
  // Q and K: rows of the q/k width.
  static constexpr int ROWB = row_bytes(HD);
  static constexpr int CHUNK = ROWB / 2;  // bf16 columns per TMA box
  static constexpr int NCHUNK = HD / CHUNK;
  static constexpr int KPC = CHUNK / 16;  // k16 steps per chunk
  // V: rows of the v width.
  static constexpr int ROWB_V = row_bytes(HDV);
  static constexpr int CHUNK_V = ROWB_V / 2;
  static constexpr int NCHUNK_V = HDV / CHUNK_V;
  static constexpr int Q_BYTES = BQ * HD * 2;  // one plane of Q
  static constexpr int K_BYTES = BK * HD * 2;  // one plane of a K tile
  static constexpr int V_BYTES = BK * HDV * 2;  // one plane of a V tile
  static constexpr int K_STAGE_BYTES = PLANES * K_BYTES;  // a K-only step
  static constexpr int STAGE_BYTES = K_STAGE_BYTES + V_PLANES * V_BYTES;
  static constexpr int SMEM = smem_bytes(HD, HDV, PLANES, V_PLANES, BK,
                                         STAGES);
  static constexpr int TPC = CHUNK_KEYS / BK;  // key tiles per JAX chunk
  static_assert(HD % CHUNK == 0 && HDV % CHUNK_V == 0,
                "head dims must be whole TMA boxes");
  static_assert(BK == 32 || BK == 64 || BK == 128, "S = Q K^T is n32/64/128");
  static_assert(SMEM <= SMEM_MAX, "shared memory per CTA");
};


// Accumulator layout of wgmma m64nN (per thread of a warpgroup): register
// j holds row 16 * warp + lane / 4 + 8 * ((j >> 1) & 1) and column
// 8 * (j >> 2) + 2 * (lane & 3) + (j & 1).  Registers 8kk..8kk+7 of S, as
// four bf16 pairs, are exactly the A fragment of keys 16kk..16kk+15.
//
// F32 = false: bf16 q, k (B, S, heads, HD), v (B, S, heads, HDV) and
// bf16 o (B, Sq, H, HDV).  F32 = true: q, k, v as bf16 planes (3B, S,
// heads, HD or HDV), plane a of batch b at batch index a * B + b, and
// float32 o.  PB (the p_bf16 route): p rounded to bf16 against each JAX
// key chunk's row max, one bf16 term of p times bf16(v); given a non-null
// mstat (B, H, Sq, NC, 4) float32, each row's (chunk max, first and last
// key at it, their count) per chunk, (-1e30, 0, 0, 0) where the row sees no
// key of the chunk, for the backward.
template <int HD, int HDV, bool F32, bool PB>
__global__ void __launch_bounds__(THREADS, 1)
    fa_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 std::conditional_t<F32, float, __nv_bfloat16>* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ mstat, int B,
                 int Sq, int Sk, int H, int KV, float scale, int causal,
                 int window, int NC) {
  using C = Cfg<HD, HDV, F32, PB>;
  constexpr int BK = C::BK;
  constexpr int PLANES = C::PLANES;
  constexpr int STAGES = C::STAGES;
  constexpr int TPC = C::TPC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;  // swizzle-atom aligned
  const uint32_t s_kv = s_q + PLANES * C::Q_BYTES;  // stage s: K, then V
  const uint32_t q_bar = s_kv + STAGES * C::STAGE_BYTES;
  const uint32_t full_bar = q_bar + 8;                // [STAGES]
  const uint32_t empty_bar = full_bar + 8 * STAGES;   // [STAGES]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int q_valid = min(BQ, Sq - q0);
  // Key tiles that hold a key some row of this CTA may see.
  int kt_hi = (Sk + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (q0 + q_valid - 1) / BK + 1);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  // PB: the JAX key chunks those tiles fall in; chunk c's tiles are
  // [max(kt_lo, c TPC), min(kt_hi, (c + 1) TPC)).
  const int c_lo = kt_lo / TPC, c_hi = (kt_hi - 1) / TPC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

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
      mbar_expect_tx(q_bar, PLANES * C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < PLANES; ++a)
#pragma unroll
        for (int c = 0; c < C::NCHUNK; ++c)
          tma_load(s_q + a * C::Q_BYTES + c * BQ * C::ROWB, &tm_q, q_bar,
                   c * C::CHUNK, h, q0, a * B + b);
      // Ring step i: tile kt's K planes and, unless `k_only`, its V planes.
      auto load = [&](int i, int kt, bool k_only) {
        const int s = i % STAGES;
        mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s,
                       k_only ? C::K_STAGE_BYTES : C::STAGE_BYTES);
        const uint32_t s_k = s_kv + s * C::STAGE_BYTES;
        const uint32_t s_v = s_k + C::K_STAGE_BYTES;
#pragma unroll
        for (int a = 0; a < PLANES; ++a)
#pragma unroll
          for (int c = 0; c < C::NCHUNK; ++c)
            tma_load(s_k + a * C::K_BYTES + c * BK * C::ROWB, &tm_k,
                     full_bar + 8 * s, c * C::CHUNK, kvh, kt * BK, a * B + b);
        if (k_only) return;
#pragma unroll
        for (int a = 0; a < C::V_PLANES; ++a)
#pragma unroll
          for (int c = 0; c < C::NCHUNK_V; ++c)
            tma_load(s_v + a * C::V_BYTES + c * BK * C::ROWB_V, &tm_v,
                     full_bar + 8 * s, c * C::CHUNK_V, kvh, kt * BK,
                     a * B + b);
      };
      if constexpr (PB) {
        // Per chunk: its tiles' K alone (the max pass), then K and V.
        for (int c = c_lo, i = 0; c <= c_hi; ++c) {
          const int t0 = max(kt_lo, c * TPC), t1 = min(kt_hi, (c + 1) * TPC);
          for (int kt = t0; kt < t1; ++kt) load(i++, kt, true);
          for (int kt = t0; kt < t1; ++kt) load(i++, kt, false);
        }
      } else {
        for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i)
          load(i, kt, false);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows row_lo .. row_lo + 63; this
  // thread owns rows r0 and r0 + 8 of them.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      CONSUMER_REGS));
  const int wg = warp / 4;
  const int row_lo = q0 + WG_ROWS * wg;
  const int r0 = row_lo + 16 * (warp % 4) + lane / 4;
  const uint32_t s_qa = s_q + wg * WG_ROWS * C::ROWB;
  float acc[HDV / 2];
#pragma unroll
  for (int j = 0; j < HDV / 2; ++j) acc[j] = 0.0f;
  float m[2] = {MASKED, MASKED};
  float l[2] = {0.0f, 0.0f};
  mbar_wait(q_bar, 0);

  // The key of register j of a tile at k0.
  auto kpos_of = [&](int k0, int j) {
    return k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
  };
  // Scaled, masked scores of the tile at k0 (stage at s_k): S = Q K^T over
  // hd in k16 steps (float32: per plane pass, smallest first, all into one
  // accumulator), times scale; keys past Sk -inf, masked pairs -1e30.
  auto scores = [&](float (&sc)[BK / 2], uint32_t s_k, int k0) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < (F32 ? PASSES : 1); ++t) {
      const uint32_t qa = s_qa + (F32 ? pass_a(t) : 0) * C::Q_BYTES;
      const uint32_t kb = s_k + (F32 ? pass_b(t) : 0) * C::K_BYTES;
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const int c = j / C::KPC;
        const int off = (j % C::KPC) * 32;  // 16 bf16 along the swizzled row
        wgmma_ss(sc, kmajor(qa + c * BQ * C::ROWB + off, C::ROWB),
                 kmajor(kb + c * BK * C::ROWB + off, C::ROWB), t > 0 || j > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] *= scale;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > row_lo) ||
                      (window > 0 && k0 <= row_lo + WG_ROWS - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = r0 + 8 * ((j >> 1) & 1);
        const int kpos = kpos_of(k0, j);
        if (kpos >= Sk)
          sc[j] = -INFINITY;
        else if ((causal && r < kpos) || (window > 0 && kpos <= r - window))
          sc[j] = MASKED;
      }
    }
  };

  if constexpr (PB) {
    // JAX's _attend_block per key chunk: a max pass for each row's chunk
    // max m_b (fmaxf only), then p = exp(s - m_b) in float32, l_b its
    // float32 sum, and the chunk's p v as one bf16 term of p times bf16(v)
    // (float32: v's hi plane, exactly bf16(v)) into a fresh accumulator,
    // merged as JAX merges chunks: acc * alpha + o_b * beta on the CUDA
    // cores.  Given mstat the second pass also counts each row's keys at
    // m_b: its S is the first pass's bit for bit (the same wgmmas, then
    // the same multiply by scale).
    const bool stat = mstat != nullptr;
    for (int c = c_lo, i = 0; c <= c_hi; ++c) {
      const int t0 = max(kt_lo, c * TPC), t1 = min(kt_hi, (c + 1) * TPC);
      if (t0 >= t1) continue;
      float mb[2] = {-INFINITY, -INFINITY};
      for (int kt = t0; kt < t1; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
        float sc[BK / 2];
        scores(sc, s_kv + s * C::STAGE_BYTES, kt * BK);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * s);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          mb[(j >> 1) & 1] = fmaxf(mb[(j >> 1) & 1], sc[j]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) mb[r] = quad_max(mb[r]);
      float lb[2] = {0.0f, 0.0f};
      float cacc[HDV / 2];
#pragma unroll
      for (int j = 0; j < HDV / 2; ++j) cacc[j] = 0.0f;
      // stat: per row (count << 20) | (first << 10) | last of the keys at
      // m_b, chunk-relative (a chunk's 1,024 keys in 10 bits each).
      uint32_t tie[2] = {0u, 0u};
      for (int kt = t0; kt < t1; ++kt, ++i) {
        const int s = i % STAGES;
        const uint32_t s_k = s_kv + s * C::STAGE_BYTES;
        const uint32_t s_v = s_k + C::K_STAGE_BYTES;
        mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
        float sc[BK / 2];
        scores(sc, s_k, kt * BK);
        if (stat) {
          // Each row's keys at m_b in this tile as a bit mask (bit 2 g + e:
          // register 4 g + 2 r + e), no branch an element; then the
          // tile's count, first and last key into tie[r].
          uint32_t hit[2] = {0u, 0u};
#pragma unroll
          for (int j = 0; j < BK / 2; ++j)
            if (sc[j] == mb[(j >> 1) & 1])
              hit[(j >> 1) & 1] |= 1u << (2 * (j >> 2) + (j & 1));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (hit[r] == 0u || mb[r] <= MASKED) continue;
            const int lo = __ffs(hit[r]) - 1, hi = 31 - __clz(hit[r]);
            const uint32_t base = kt * BK - c * CHUNK_KEYS + 2 * (lane & 3);
            const uint32_t kf = base + 8 * (lo >> 1) + (lo & 1);
            const uint32_t kl = base + 8 * (hi >> 1) + (hi & 1);
            const uint32_t n = (tie[r] >> 20) + __popc(hit[r]);
            const uint32_t first = (tie[r] >> 20) ? (tie[r] >> 10) & 0x3FFu
                                                  : kf;
            tie[r] = (n << 20) | (first << 10) | kl;
          }
        }
        uint32_t pb[BK / 4];  // bf16(p), in the A-fragment layout
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) {
          const int r = j & 1;  // registers 2j, 2j + 1: row (2j >> 1) & 1
          const float p0 = expf(sc[2 * j] - mb[r]);
          const float p1 = expf(sc[2 * j + 1] - mb[r]);
          lb[r] += p0;
          lb[r] += p1;
          pb[j] = as_u32(__floats2bfloat162_rn(p0, p1));
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(cacc, pb + 4 * kk,
                   mnmajor(s_v + kk * 16 * C::ROWB_V, BK, C::ROWB_V));
        wgmma_commit();
        wgmma_wait_all();
        pin(cacc);
        pin(pb);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * s);
      }
      float alpha[2], beta[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mb[r]);
        alpha[r] = expf(m[r] - m_new);
        beta[r] = expf(mb[r] - m_new);
        l[r] = l[r] * alpha[r] + quad_sum(lb[r]) * beta[r];
        m[r] = m_new;
        if (stat) {
          // The quad's counts added, its first and last keys kept.
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            const uint32_t o = __shfl_xor_sync(0xffffffffu, tie[r], off);
            const uint32_t na = tie[r] >> 20, nb = o >> 20;
            if (na == 0)
              tie[r] = o;
            else if (nb != 0)
              tie[r] = ((na + nb) << 20) |
                       (min((tie[r] >> 10) & 0x3FFu, (o >> 10) & 0x3FFu)
                        << 10) |
                       max(tie[r] & 0x3FFu, o & 0x3FFu);
          }
          const int row = r0 + 8 * r;
          if ((lane & 3) == 0 && row < Sq) {
            const uint32_t n = tie[r] >> 20;
            const float base = (float)(c * CHUNK_KEYS);
            *reinterpret_cast<float4*>(
                mstat + ((((int64_t)b * H + h) * Sq + row) * NC + c) * 4) =
                n ? make_float4(mb[r], base + ((tie[r] >> 10) & 0x3FFu),
                                base + (tie[r] & 0x3FFu), (float)n)
                  : make_float4(MASKED, 0.0f, 0.0f, 0.0f);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < HDV / 2; ++j)
        acc[j] = acc[j] * alpha[(j >> 1) & 1] + cacc[j] * beta[(j >> 1) & 1];
    }
    // Chunks this tile visits none of: (-1e30, 0, 0, 0).
    if (stat && (lane & 3) == 0)
      for (int c = 0; c < NC; ++c) {
        if (max(kt_lo, c * TPC) < min(kt_hi, (c + 1) * TPC)) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row >= Sq) continue;
          *reinterpret_cast<float4*>(
              mstat + ((((int64_t)b * H + h) * Sq + row) * NC + c) * 4) =
              make_float4(MASKED, 0.0f, 0.0f, 0.0f);
        }
      }
  } else {
    for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
      const int s = i % STAGES;
      const uint32_t s_k = s_kv + s * C::STAGE_BYTES;
      const uint32_t s_v = s_k + PLANES * C::K_BYTES;
      mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);

      float sc[BK / 2];
      scores(sc, s_k, kt * BK);

      // Online softmax on the accumulator's registers.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sc[j] = expf(sc[j] - m[(j >> 1) & 1]);
        sum[(j >> 1) & 1] += sc[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);

      // p's three bf16 terms (hi, mid, lo), each in the A-fragment layout.
      uint32_t p[3][BK / 4];
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        split3(sc[2 * j], sc[2 * j + 1], p[0][j], p[1][j], p[2][j]);
      if constexpr (!F32) {
        // O = O * alpha + P V, the three terms into the one accumulator.
#pragma unroll
        for (int j = 0; j < HDV / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv =
              mnmajor(s_v + kk * 16 * C::ROWB_V, BK, C::ROWB_V);
          wgmma_rs(acc, p[2] + 4 * kk, dv);
          wgmma_rs(acc, p[1] + 4 * kk, dv);
          wgmma_rs(acc, p[0] + 4 * kk, dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
      } else {
        // This tile's P V, plane passes smallest first, into a fresh
        // accumulator; then O = O * alpha + tile on the CUDA cores.
        float tile[HDV / 2];
#pragma unroll
        for (int j = 0; j < HDV / 2; ++j) tile[j] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < PASSES; ++t) {
          const uint32_t vb = s_v + pass_b(t) * C::V_BYTES;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs(tile, p[pass_a(t)] + 4 * kk,
                     mnmajor(vb + kk * 16 * C::ROWB_V, BK, C::ROWB_V));
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(tile);
#pragma unroll
        for (int j = 0; j < HDV / 2; ++j)
          acc[j] = acc[j] * alpha[(j >> 1) & 1] + tile[j];
      }
      pin(p[0]);
      pin(p[1]);
      pin(p[2]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // this warp is done
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    // The row's log-sum-exp for the backward (natural log: p = expf(s -
    // m)); every lane of the quad holds the row's m and l.
    if (lse != nullptr && (lane & 3) == 0)
      lse[((int64_t)b * H + h) * Sq + row] = m[r] + logf(l[r]);
    auto* out = o + (((int64_t)b * Sq + row) * H + h) * HDV + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < HDV / 8; ++c) {
      const float x = acc[4 * c + 2 * r] / den;
      const float y = acc[4 * c + 2 * r + 1] / den;
      if constexpr (F32)
        *reinterpret_cast<float2*>(out + 8 * c) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) =
            __floats2bfloat162_rn(x, y);
    }
  }
}

// float32 x (n elements) -> bf16 planes hi, mid, lo at planes, planes +
// stride and planes + 2 stride: hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), rounded to nearest, the subtractions exact
// (ref.split_bf16x3).  Four elements a thread, x 16-byte and each plane
// 8-byte aligned (stride % 4 == 0); the last n % 4 elements one a thread.
// Bound by bytes: 4 read and 6 written per element.
__device__ __forceinline__ void split1(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = __fsub_rn(x, __bfloat162float(hi));
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
}

__global__ void split_bf16x3_kernel(const float* __restrict__ x,
                                    __nv_bfloat16* __restrict__ planes,
                                    int64_t n, int64_t stride) {
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; 4 * i + 4 <= n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    __nv_bfloat16 t[3][4];
    split1(v.x, t[0][0], t[1][0], t[2][0]);
    split1(v.y, t[0][1], t[1][1], t[2][1]);
    split1(v.z, t[0][2], t[1][2], t[2][2]);
    split1(v.w, t[0][3], t[1][3], t[2][3]);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      *reinterpret_cast<uint2*>(planes + a * stride + 4 * i) =
          *reinterpret_cast<const uint2*>(t[a]);
  }
  const int64_t j = (n & ~int64_t{3}) + first;
  if (j < n)
    split1(x[j], planes[j], planes[stride + j], planes[2 * stride + j]);
}

// ---------------------------------------------------------------------------
// Host side: launch
// ---------------------------------------------------------------------------


template <int HD, int HDV, bool F32, bool PB>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* mstat, int B, int Sq, int Sk, int H, int KV, float scale,
           int causal, int window, cudaStream_t stream) {
  using C = Cfg<HD, HDV, F32, PB>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const CUtensorMapSwizzle sw = swizzle_of(C::ROWB);
  // float32: the planes stacked on the batch axis, (3B, S, heads, hd).
  const int NB = C::PLANES * B;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, NB, Sq, H, HD, C::CHUNK, BQ, sw) ||
      !make_map(enc, &tk, k, NB, Sk, KV, HD, C::CHUNK, C::BK, sw) ||
      !make_map(enc, &tv, v, C::V_PLANES * B, Sk, KV, HDV, C::CHUNK_V, C::BK,
                swizzle_of(C::ROWB_V)))
    return ERR_TENSOR_MAP;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_wgmma<HD, HDV, F32, PB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_wgmma<HD, HDV, F32, PB><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv,
      static_cast<std::conditional_t<F32, float, __nv_bfloat16>*>(o), lse,
      mstat, B, Sq, Sk, H, KV, scale, causal, window,
      (Sk + CHUNK_KEYS - 1) / CHUNK_KEYS);
  return (int)cudaGetLastError();
}

// The head dims both entries take with q/k and v of one width, one
// instantiation of each kernel per dim: every multiple of 16 the model zoo
// uses (the smoke configs 16, TinyLlama 64, StableLM-3B 80, Zamba2-7B's
// shared attention 112, the others 128).  The wrapper's HEAD_DIMS
// (kernels/flash_attention.py) is this list; tests/test_torch_attention.py
// holds the two equal.
#define HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(112) X(128)
// The (q/k, v) pairs of unequal widths they take, one instantiation each:
// DeepSeek-V2's MLA, nope 128 + rope 64 against v 128.  The wrapper's
// HEAD_DIM_PAIRS is this list (held equal by the same test).
#define HEAD_DIM_PAIRS(X) X(192, 128)

template <bool F32, bool PB>
int forward(const void* q, const void* k, const void* v, void* o, void* lse,
            void* mstat, int B, int Sq, int Sk, int H, int KV, int hd,
            int hd_v, float scale, int causal, int window, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == hd_v) {
    switch (hd) {
#define CASE(HD)                                                           \
  case HD:                                                                 \
    return launch<HD, HD, F32, PB>(q, k, v, o, static_cast<float*>(lse),   \
                                   static_cast<float*>(mstat), B, Sq, Sk, H, \
                                   KV, scale, causal, window, st);
      HEAD_DIMS(CASE)
#undef CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
#define PAIR(HD, HDV)                                                      \
  if (hd == HD && hd_v == HDV)                                             \
    return launch<HD, HDV, F32, PB>(q, k, v, o, static_cast<float*>(lse),  \
                                    static_cast<float*>(mstat), B, Sq, Sk, H, \
                                    KV, scale, causal, window, st);
  HEAD_DIM_PAIRS(PAIR)
#undef PAIR
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronize, and returns cudaGetLastError(), the error
// that refused the launch, or ERR_NO_ENCODER / ERR_TENSOR_MAP (negative).
//
// fa_forward_bf16: bf16 q (B, Sq, H, hd), k (B, Sk, KV, hd) and v (B, Sk,
// KV, hd_v), contiguous and 16-byte aligned; bf16 o (B, Sq, H, hd_v); hd
// == hd_v one of HEAD_DIMS, or (hd, hd_v) one of HEAD_DIM_PAIRS (above);
// window <= 0 means no window.  lse: null, or float32 (B, H, Sq) that
// receives each row's log-sum-exp m + log(l) of the scaled, masked scores
// (for the backward, flash_attention_bwd_sm90.cu); o is the same either
// way.
extern "C" int fa_forward_bf16(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int Sq, int Sk,
                               int H, int KV, int hd, int hd_v, float scale,
                               int causal, int window, void* stream) {
  return forward<false, false>(q, k, v, o, lse, nullptr, B, Sq, Sk, H, KV,
                               hd, hd_v, scale, causal, window, stream);
}

// fa_forward_f32: the same for float32 inputs, given as split_bf16x3's
// planes: q (3, B, Sq, H, hd), k (3, B, Sk, KV, hd), v (3, B, Sk, KV,
// hd_v) bf16; float32 o (B, Sq, H, hd_v).
extern "C" int fa_forward_f32(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Sk,
                              int H, int KV, int hd, int hd_v, float scale,
                              int causal, int window, void* stream) {
  return forward<true, false>(q, k, v, o, lse, nullptr, B, Sq, Sk, H, KV,
                              hd, hd_v, scale, causal, window, stream);
}

// fa_forward_bf16_pbf16 / fa_forward_f32_pbf16: the p_bf16 route
// (fa_fwd_wgmma<hd, hd_v, F32, true>), JAX's ATTN_P_BF16 function, with
// the inputs of fa_forward_bf16 / fa_forward_f32.  mstat: null, or (given
// lse) float32 (B, H, Sq, ceil(Sk / 1024), 4) that receives each row's
// (chunk max, first and last maximal key, their count) per JAX key chunk
// (ref.chunk_max_stats), which fa_backward_*_pbf16
// (flash_attention_bwd_sm90.cu) reads.
extern "C" int fa_forward_bf16_pbf16(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     void* mstat, int B, int Sq, int Sk,
                                     int H, int KV, int hd, int hd_v,
                                     float scale, int causal, int window,
                                     void* stream) {
  return forward<false, true>(q, k, v, o, lse, mstat, B, Sq, Sk, H, KV, hd,
                              hd_v, scale, causal, window, stream);
}

extern "C" int fa_forward_f32_pbf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    void* mstat, int B, int Sq, int Sk, int H,
                                    int KV, int hd, int hd_v, float scale,
                                    int causal, int window, void* stream) {
  return forward<true, true>(q, k, v, o, lse, mstat, B, Sq, Sk, H, KV, hd,
                             hd_v, scale, causal, window, stream);
}

// split_bf16x3: float32 x (n elements, contiguous, 16-byte aligned) ->
// bf16 planes at planes + a * stride (a = 0, 1, 2), stride >= n a multiple
// of 4, planes 8-byte aligned.
extern "C" int split_bf16x3(const void* x, void* planes, long long n,
                            long long stride, void* stream) {
  if (n <= 0) return 0;
  if (stride < n || stride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(planes) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int threads = 256;
  // Enough CTAs to fill the card several times; the loop covers the rest.
  const int blocks = (int)std::min<long long>(
      ((n + 3) / 4 + threads - 1) / threads, 132 * 16);
  split_bf16x3_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(planes), n,
      stride);
  return (int)cudaGetLastError();
}
