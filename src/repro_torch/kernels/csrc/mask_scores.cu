// MIG mask scorers for Hopper (sm_90a): CC, fragmentation, MCC and MECC
// scores over a flat (N,) array of int32 free-block masks, and the fused
// MCC/MECC picks of the replay.  Each kernel replaces one TPU Pallas
// kernel of the JAX package (named above it).
//
// What bounds them on this card.  A scorer reads 4 B and writes 4 B per
// mask.  At a fleet-scale N of 1M that is 8 MB, 2.5 us at 3.35 TB/s, so
// the bytes bound them there.  At the replay's fleet of 1,860 GPUs it is
// about 15 KB, a few nanoseconds of bandwidth: one launch (about a
// microsecond back to back on the card, more from the host) bounds them
// there, and so does every other device op the replay issues per arrival
// around the score.
//
// One streaming kernel, four tables.  Each score is a function of the
// mask's low num_blocks bits alone, and a mask has at most 8 blocks, so
// each has at most 256 distinct values per model.  Each CTA first builds,
// in shared memory, the score of every mask t < 2^num_blocks from the
// model's slot templates, threads t each filling one entry: CC (the slots
// that fit t, tested without a predicate per slot), fragmentation (Alg.
// 4's greedy chain over a shared-memory copy of each profile's slots, the
// quotients c / size computed once per CTA), or for MCC/MECC cc[t] and
// cnt[t] (the slots of each profile that fit t, packed 4 bits per
// profile) and then the requested profile's Alg. 6 / Alg. 7 score (the
// arithmetic of kernels/ref.py).  Per mask m the score is then one
// lookup, table[m & full]: exact, because every slot mask lies inside
// full and Alg. 4's popcount reads only the low num_blocks bits, so bits
// above them (bit 31 too) change no value.  No per-mask walk over the
// templates is left.  The score kernel streams 16-byte loads and stores
// over at most two CTAs per SM (fewer CTAs, fewer builds), and each
// thread loads its first four int4s before the build, which hides their
// latency; a ragged head or tail, or a misaligned view, goes one mask at
// a time through the same table.  At the replay's N = 1,860 one CTA
// covers the masks, and the build's latency, not the bytes, sets the
// time (PERF.md).
//
// The picks: one launch per replay arrival.  mrt_mcc_pick / mrt_ecc_pick
// compute the replay's whole kernel-path pick in one launch: the host
// headroom test (one float32 add and compare per resource), the score,
// -1 where the host blocks, and the first maximizer among scores >= 0
// (else -1).  Each thread takes 4 GPUs and issues all their loads (the
// host rows gathered) before the tables are built, so the build hides
// the loads' latency.  Each score is packed with its index into a 64-bit
// key (order-preserving score bits high, ~index low) and reduced by warp
// shuffles and across the CTA.  Up to 2,048 GPUs (the replay's fleet is
// 1,860) one CTA of 512 threads covers the fleet and writes the pick, so
// an arrival costs one launch, with no memset, host sync or other op.
// Larger fleets reduce across CTAs by atomicMax into two zeroed words
// that the caller allocates for this launch alone, and the last CTA
// (ticket counter after a __threadfence) writes the pick; no state
// outlives a launch.
//
// Exactness.  The results must equal the plain PyTorch versions
// (kernels/ref.py) bit for bit: the sums use __fmul_rn/__fadd_rn (never
// contracted into an FMA) and the division uses __fdiv_rn (IEEE
// round-to-nearest), and the library is built with -fmad=false and
// without fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#define MRT_MAX_SLOTS 32
#define MRT_MAX_PROFILES 8
#define MRT_MAX_MASKS 256      // 2^8: DeviceModel has at most 8 blocks

// Slot templates of one device model.  Slots are ordered by profile:
// profile p owns slots [prof_start[p], prof_start[p + 1]).
struct MrtModel {
  int num_blocks;
  int num_profiles;
  int num_slots;
  int slot_mask[MRT_MAX_SLOTS];
  int prof_start[MRT_MAX_PROFILES + 1];
  int prof_size[MRT_MAX_PROFILES];
  int slot_shift[MRT_MAX_SLOTS];   // 4 * (profile of slot s)
};

__device__ __forceinline__ int fits_slot(int m, int sm) {
  return (m & sm) == sm;
}

// ---------------------------------------------------------------------------
// The tables
// ---------------------------------------------------------------------------

#define MRT_MAX_BLOCKS 8       // so at most 8 slots (starts) per profile

// What a table holds: the score of one scorer, each a 4-byte word (int
// for CC and MCC, float32 bits for FRAG and ECC).
enum MrtKind { MRT_CC, MRT_FRAG, MRT_MCC, MRT_ECC };

struct MrtTables {
  int cc[MRT_MAX_MASKS];
  unsigned cnt[MRT_MAX_MASKS];    // 4 bits per profile: cnt[t] >> 4p & 15
  int score[MRT_MAX_MASKS];       // the lookup table
};

// The slots of the model that fit mask t.  Each slot's test is
// (~t & sm) - 1 < 0 (sm is below 2^8), one bit with no predicate, so the
// tests are independent and only their sum is a chain; the loop stops at
// the model's slot count.
__device__ __forceinline__ int fit_count(int t, const MrtModel& md) {
  int cc = 0;
#pragma unroll
  for (int s = 0; s < MRT_MAX_SLOTS; ++s) {
    if (s >= md.num_slots) break;
    cc += (int)((unsigned)((~t & md.slot_mask[s]) - 1) >> 31);
  }
  return cc;
}

// CC's table: tb.score[t] = fit_count(t).  Ends with __syncthreads().
__device__ void build_cc_table(MrtTables& tb, const MrtModel& md) {
  const int nm = 1 << md.num_blocks;
  for (int t = threadIdx.x; t < nm; t += blockDim.x)
    tb.score[t] = fit_count(t, md);
  __syncthreads();
}

// Alg. 4's table: tb.score[t] = the fragmentation of t as float32 bits.
// Per profile in order: the popcount gate, a greedy take of each of its
// slots, then popcount(free) / size if the gate passed (the JAX function
// reads only the low num_blocks bits, as t has).  The CTA first puts each
// profile's slot masks at slot[p][k] and every quotient c / size_p
// (__fdiv_rn, c <= 8) at quot[p][c] in shared memory, so thread t's chain
// reads both at compile-time offsets and waits on no template load and no
// division.  Needs blockDim.x >= 8 * 8 + 8 * 9.  Ends with __syncthreads().
__device__ void build_frag_table(MrtTables& tb, const MrtModel& md) {
  __shared__ int slot[MRT_MAX_PROFILES][MRT_MAX_BLOCKS];
  __shared__ float quot[MRT_MAX_PROFILES][MRT_MAX_BLOCKS + 1];
  const int i = threadIdx.x;
  if (i < MRT_MAX_PROFILES * MRT_MAX_BLOCKS) {
    const int p = i / MRT_MAX_BLOCKS, k = i % MRT_MAX_BLOCKS;
    const int s0 = md.prof_start[p];
    const int ns = p < md.num_profiles ? md.prof_start[p + 1] - s0 : 0;
    slot[p][k] = k < ns ? md.slot_mask[s0 + k] : 0;
  } else if (i < MRT_MAX_PROFILES * (2 * MRT_MAX_BLOCKS + 1)) {
    const int j = i - MRT_MAX_PROFILES * MRT_MAX_BLOCKS;
    const int p = j / (MRT_MAX_BLOCKS + 1), c = j % (MRT_MAX_BLOCKS + 1);
    quot[p][c] = p < md.num_profiles
                     ? __fdiv_rn((float)c, (float)md.prof_size[p]) : 0.0f;
  }
  __syncthreads();
  const int nm = 1 << md.num_blocks;
  for (int t = threadIdx.x; t < nm; t += blockDim.x) {
    int free_m = t;
    float frag = 0.0f;
#pragma unroll
    for (int p = 0; p < MRT_MAX_PROFILES; ++p) {
      if (p >= md.num_profiles) break;
      const int ns = md.prof_start[p + 1] - md.prof_start[p];
      const bool applies = __popc(free_m) >= md.prof_size[p];
#pragma unroll
      for (int k = 0; k < MRT_MAX_BLOCKS; ++k) {
        if (k >= ns) break;
        const int sm = slot[p][k];
        if (fits_slot(free_m, sm)) free_m &= ~sm;
      }
      frag = __fadd_rn(frag, applies ? quot[p][__popc(free_m)] : 0.0f);
    }
    tb.score[t] = __float_as_int(frag);
  }
  __syncthreads();
}

// MCC's / MECC's table: tb.score[t] = the requested profile's Alg. 6 (ECC
// = false) or Alg. 7 (ECC = true) score of every mask t, from the slot
// templates, in two passes over the masks: cc[t] and cnt[t] (the slots of
// each profile that fit t, at most 8 < 16, one 4-bit field per profile),
// then the scores.  The templates are read from the kernel's parameters,
// in loops over the compile-time maxima with the model's counts as
// guards, so they are constant-bank operands and no pass waits on a load
// of them; the profile's slots and the weights are loaded into registers
// while the first pass runs.  Ends with __syncthreads().
template <bool ECC>
__device__ void build_tables(MrtTables& tb, const MrtModel& md, int profile,
                             const float* __restrict__ weights) {
  const int nm = 1 << md.num_blocks;
  const int s0 = md.prof_start[profile];
  const int ns = md.prof_start[profile + 1] - s0;
  int psm[MRT_MAX_BLOCKS];
#pragma unroll
  for (int k = 0; k < MRT_MAX_BLOCKS; ++k)
    psm[k] = k < ns ? md.slot_mask[s0 + k] : 0;
  float w[MRT_MAX_PROFILES];
#pragma unroll
  for (int p = 0; p < MRT_MAX_PROFILES; ++p)
    w[p] = ECC && p < md.num_profiles ? weights[p] : 0.0f;
  for (int t = threadIdx.x; t < nm; t += blockDim.x) {
    int cc = 0;
    unsigned cnt = 0;
#pragma unroll
    for (int s = 0; s < MRT_MAX_SLOTS; ++s) {
      const int f = (s < md.num_slots) & fits_slot(t, md.slot_mask[s]);
      cc += f;
      if (ECC) cnt += (unsigned)f << md.slot_shift[s];
    }
    tb.cc[t] = cc;
    if (ECC) tb.cnt[t] = cnt;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nm; t += blockDim.x) {
    // Alg. 6: the best post-placement CC; Alg. 7: the first slot that
    // maximizes it (strict >, so the first maximizer is kept).
    int best_cc = -1;
    int best_after = t;
#pragma unroll
    for (int k = 0; k < MRT_MAX_BLOCKS; ++k) {
      if (k >= ns) break;
      if (!fits_slot(t, psm[k])) continue;
      const int cc = tb.cc[t & ~psm[k]];
      if (cc > best_cc) {
        best_cc = cc;
        best_after = t & ~psm[k];
      }
    }
    if (ECC) {
      // sum_p w[p] * |S(after, p)| in profile order, float32, no FMA.
      const unsigned cnt = tb.cnt[best_after];
      float ecc = 0.0f;
#pragma unroll
      for (int p = 0; p < MRT_MAX_PROFILES; ++p)
        if (p < md.num_profiles)
          ecc = __fadd_rn(ecc, __fmul_rn(w[p], (float)((cnt >> (4 * p)) & 15u)));
      tb.score[t] = __float_as_int(best_cc >= 0 ? ecc : -1.0f);
    } else {
      tb.score[t] = best_cc;
    }
  }
  __syncthreads();
}

// KIND's table in tb.score.
template <int KIND>
__device__ __forceinline__ void build_table(MrtTables& tb, const MrtModel& md,
                                            int profile,
                                            const float* __restrict__ weights) {
  if constexpr (KIND == MRT_CC) build_cc_table(tb, md);
  else if constexpr (KIND == MRT_FRAG) build_frag_table(tb, md);
  else build_tables<KIND == MRT_ECC>(tb, md, profile, weights);
}

#define MRT_THREADS 256
#define MRT_SCORE_ITEMS 4       // int4s per thread loaded before the build
#define MRT_CTAS_PER_SM 2
#define MRT_PICK_THREADS 512
#define MRT_PICK_ITEMS 4
static_assert(MRT_THREADS >= MRT_MAX_PROFILES * (2 * MRT_MAX_BLOCKS + 1),
              "build_frag_table fills its shared tables in one pass");

__device__ __forceinline__ int4 lookup4(const MrtTables& tb, int4 m, int full) {
  return make_int4(tb.score[m.x & full], tb.score[m.y & full],
                   tb.score[m.z & full], tb.score[m.w & full]);
}

// KIND's score per mask: Eq. 1 CC (int32), Alg. 4 fragmentation
// (float32), or Alg. 6 (MCC, int32) / Alg. 7 (ECC, float32) of the
// profile, -1 where it does not fit.  Replaces cc_pallas
// (repro/kernels/cc_score.py), frag_pallas (frag_score.py) and
// mcc_score_pallas / ecc_score_pallas (policy_score.py).  vec: masks and
// out are 16-byte aligned, so the first n / 4 * 4 masks go as int4.  A
// grid-stride loop over a grid of at most MRT_CTAS_PER_SM CTAs per SM
// (fewer CTAs, fewer table builds); each thread's first MRT_SCORE_ITEMS
// int4s are loaded before the table is built, so the loads' latency
// hides behind the build.
template <int KIND>
__global__ void __launch_bounds__(MRT_THREADS)
score_kernel(const int* __restrict__ masks, const float* __restrict__ weights,
             int* __restrict__ out, int64_t n, int profile, int vec,
             MrtModel md) {
  __shared__ MrtTables tb;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = vec ? n / 4 : 0;
  const int4* __restrict__ m4 = reinterpret_cast<const int4*>(masks);
  int4* __restrict__ o4 = reinterpret_cast<int4*>(out);
  int4 first[MRT_SCORE_ITEMS];
#pragma unroll
  for (int k = 0; k < MRT_SCORE_ITEMS; ++k) {
    const int64_t v = tid + k * stride;
    first[k] = v < n4 ? __ldcs(m4 + v) : make_int4(0, 0, 0, 0);
  }
  build_table<KIND>(tb, md, profile, weights);
  const int full = (1 << md.num_blocks) - 1;
#pragma unroll
  for (int k = 0; k < MRT_SCORE_ITEMS; ++k) {
    const int64_t v = tid + k * stride;
    if (v < n4) __stcs(o4 + v, lookup4(tb, first[k], full));
  }
  for (int64_t v = tid + MRT_SCORE_ITEMS * stride; v < n4; v += stride)
    __stcs(o4 + v, lookup4(tb, __ldcs(m4 + v), full));
  for (int64_t i = n4 * 4 + tid; i < n; i += stride)
    out[i] = tb.score[masks[i] & full];
}

// ---------------------------------------------------------------------------
// The fused picks
// ---------------------------------------------------------------------------

// Order-preserving 32-bit image of a score: unsigned order of the image is
// the score's order.  -0.0 is canonicalised to +0.0, as torch.argmax treats
// them as equal.  The image of every score >= 0 has its top bit set.
template <bool ECC>
__device__ __forceinline__ unsigned score_bits(int s) {
  if (ECC) {
    unsigned u = (unsigned)s;
    if (u == 0x80000000u) u = 0u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (unsigned)s ^ 0x80000000u;
}

// A reduced key's pick: its index if its score is >= 0, else -1.
__device__ __forceinline__ int64_t key_pick(unsigned long long k) {
  return (k >> 63) ? (int64_t)(uint32_t)~(uint32_t)k : (int64_t)-1;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// The first maximizer of score where the host has headroom (-1 where it
// has not), among scores >= 0, else -1: one int64 in pick[0].  Each thread
// takes MRT_PICK_ITEMS GPUs, all loaded (host rows gathered, headroom
// tested) before the tables are built; cap_g and host_used rows are read
// as 8-byte aligned float pairs.  One CTA writes pick directly; several
// reduce through scratch, two zeroed 64-bit words (max key, ticket) of
// this launch's own.
template <bool ECC>
__global__ void __launch_bounds__(MRT_PICK_THREADS)
pick_kernel(const int* __restrict__ free_m, const int64_t* __restrict__ gpu_host,
            const float* __restrict__ host_used, const float* __restrict__ cap_g,
            const float* __restrict__ need, const float* __restrict__ weights,
            int64_t n, int profile, MrtModel md,
            unsigned long long* scratch, int64_t* __restrict__ pick) {
  __shared__ MrtTables tb;
  __shared__ unsigned long long warp_best[MRT_PICK_THREADS / 32];
  const int64_t base = (int64_t)blockIdx.x * (MRT_PICK_THREADS * MRT_PICK_ITEMS)
                       + threadIdx.x;
  const float2* __restrict__ cap2 = reinterpret_cast<const float2*>(cap_g);
  const float2* __restrict__ used2 = reinterpret_cast<const float2*>(host_used);
  int m[MRT_PICK_ITEMS];
  int64_t h[MRT_PICK_ITEMS];
  float2 cap[MRT_PICK_ITEMS];
  bool ok[MRT_PICK_ITEMS];
#pragma unroll
  for (int k = 0; k < MRT_PICK_ITEMS; ++k) {
    const int64_t i = base + k * MRT_PICK_THREADS;
    const bool in = i < n;
    m[k] = in ? free_m[i] : 0;
    h[k] = in ? gpu_host[i] : 0;
    cap[k] = in ? cap2[i] : make_float2(0.0f, 0.0f);
  }
  const float need0 = need[0], need1 = need[1];
#pragma unroll
  for (int k = 0; k < MRT_PICK_ITEMS; ++k) {
    const float2 u = used2[h[k]];
    ok[k] = __fadd_rn(u.x, need0) <= cap[k].x
            && __fadd_rn(u.y, need1) <= cap[k].y;
  }
  build_tables<ECC>(tb, md, profile, weights);
  const int full = (1 << md.num_blocks) - 1;
  const int blocked = ECC ? __float_as_int(-1.0f) : -1;
  unsigned long long best = 0;
#pragma unroll
  for (int k = 0; k < MRT_PICK_ITEMS; ++k) {
    const int64_t i = base + k * MRT_PICK_THREADS;
    if (i >= n) continue;
    const int s = ok[k] ? tb.score[m[k] & full] : blocked;
    const unsigned long long key =
        ((unsigned long long)score_bits<ECC>(s) << 32) | (unsigned)~(uint32_t)i;
    best = key > best ? key : best;
  }
  best = warp_max(best);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp != 0) return;
  best = warp_max(lane < MRT_PICK_THREADS / 32 ? warp_best[lane] : 0ull);
  if (lane != 0) return;
  if (gridDim.x == 1) {
    pick[0] = key_pick(best);
    return;
  }
  atomicMax(&scratch[0], best);
  __threadfence();
  unsigned* ticket = reinterpret_cast<unsigned*>(&scratch[1]);
  if (atomicAdd(ticket, 1u) != gridDim.x - 1) return;
  // Last CTA: every other CTA's atomicMax is ordered before its ticket.
  __threadfence();
  pick[0] = key_pick(atomicOr(&scratch[0], 0ull));
}

static inline unsigned mrt_blocks(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// CTAs for the score kernels: enough that each thread's prefetched int4s
// cover n, capped at MRT_CTAS_PER_SM per SM of the current device.
static unsigned mrt_grid(int64_t n) {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = (int64_t)(dev < 64 ? sms[dev] : 132) * MRT_CTAS_PER_SM;
  const int64_t per_cta = (int64_t)MRT_THREADS * 4 * MRT_SCORE_ITEMS;
  const int64_t want = (n + per_cta - 1) / per_cta;
  return (unsigned)(want < cap ? want : cap);
}

static inline int mrt_aligned16(const void* a, const void* b) {
  return ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
}

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronize, and returns cudaGetLastError().
extern "C" {

int mrt_cc(const int* masks, int* out, int64_t n, MrtModel md, void* stream) {
  if (n > 0)
    score_kernel<MRT_CC><<<mrt_grid(n), MRT_THREADS, 0,
                           (cudaStream_t)stream>>>(
        masks, nullptr, out, n, 0, mrt_aligned16(masks, out), md);
  return (int)cudaGetLastError();
}

int mrt_frag(const int* masks, float* out, int64_t n, MrtModel md,
             void* stream) {
  if (n > 0)
    score_kernel<MRT_FRAG><<<mrt_grid(n), MRT_THREADS, 0,
                             (cudaStream_t)stream>>>(
        masks, nullptr, reinterpret_cast<int*>(out), n, 0,
        mrt_aligned16(masks, out), md);
  return (int)cudaGetLastError();
}

int mrt_mcc(const int* masks, int* out, int64_t n, int profile, MrtModel md,
            void* stream) {
  if (n > 0)
    score_kernel<MRT_MCC><<<mrt_grid(n), MRT_THREADS, 0,
                            (cudaStream_t)stream>>>(
        masks, nullptr, out, n, profile, mrt_aligned16(masks, out), md);
  return (int)cudaGetLastError();
}

int mrt_ecc(const int* masks, const float* weights, float* out, int64_t n,
            int profile, MrtModel md, void* stream) {
  if (n > 0)
    score_kernel<MRT_ECC><<<mrt_grid(n), MRT_THREADS, 0,
                            (cudaStream_t)stream>>>(
        masks, weights, reinterpret_cast<int*>(out), n, profile,
        mrt_aligned16(masks, out), md);
  return (int)cudaGetLastError();
}

// scratch: for n > MRT_PICK_THREADS * MRT_PICK_ITEMS, two zeroed 64-bit
// words on the device for this launch alone (unused, may be null, below).
int mrt_mcc_pick(const int* free_m, const int64_t* gpu_host,
                 const float* host_used, const float* cap_g, const float* need,
                 int64_t n, int profile, MrtModel md, void* scratch,
                 int64_t* pick, void* stream) {
  if (n > 0)
    pick_kernel<false><<<mrt_blocks(n, MRT_PICK_THREADS * MRT_PICK_ITEMS),
                        MRT_PICK_THREADS, 0,
                         (cudaStream_t)stream>>>(
        free_m, gpu_host, host_used, cap_g, need, nullptr, n, profile, md,
        (unsigned long long*)scratch, pick);
  return (int)cudaGetLastError();
}

int mrt_ecc_pick(const int* free_m, const int64_t* gpu_host,
                 const float* host_used, const float* cap_g, const float* need,
                 const float* weights, int64_t n, int profile, MrtModel md,
                 void* scratch, int64_t* pick, void* stream) {
  if (n > 0)
    pick_kernel<true><<<mrt_blocks(n, MRT_PICK_THREADS * MRT_PICK_ITEMS),
                        MRT_PICK_THREADS, 0,
                        (cudaStream_t)stream>>>(
        free_m, gpu_host, host_used, cap_g, need, weights, n, profile, md,
        (unsigned long long*)scratch, pick);
  return (int)cudaGetLastError();
}

}  // extern "C"
