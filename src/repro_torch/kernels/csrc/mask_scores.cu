// MIG mask scorers for Hopper (sm_90a): CC, fragmentation, MCC and MECC
// scores over a flat (N,) array of int32 free-block masks.  Each kernel
// replaces one TPU Pallas kernel of the JAX package (named above it).
//
// Design.  One thread per mask; the ragged edge is masked by the thread
// index, so N need not be a multiple of anything (the Pallas (64, 128)
// tile was a TPU register shape).  The device model's slot templates
// (<= MRT_MAX_SLOTS masks, grouped by profile) travel by value as a kernel
// argument, and the requested profile is a runtime argument: one kernel
// serves every model and profile, with no per-profile specialization and
// no host dispatch.  MECC's weights are read from a (num_profiles,) float32
// device tensor, so per-event weights never cross to the host.
//
// Bound.  Each kernel reads 4 B and writes 4 B per mask: at the replay's
// fleet of 1,860 GPUs that is about 15 KB, which the H100 moves in a few
// nanoseconds, far below the few microseconds a launch costs.  These
// kernels are launch-bound on the main path; a later change fuses the
// scoring with the host-headroom mask and the first-maximizer argmax so
// one launch replaces several.
//
// Exactness.  The float32 results must equal the plain PyTorch versions
// (kernels/ref.py) bit for bit: the sums use __fmul_rn/__fadd_rn (never
// contracted into an FMA) and the division uses __fdiv_rn (IEEE
// round-to-nearest), and the library is built with -fmad=false and
// without fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#define MRT_MAX_SLOTS 32
#define MRT_MAX_PROFILES 8

// Slot templates of one device model.  Slots are ordered by profile:
// profile p owns slots [prof_start[p], prof_start[p + 1]).
struct MrtModel {
  int num_blocks;
  int num_profiles;
  int num_slots;
  int slot_mask[MRT_MAX_SLOTS];
  int prof_start[MRT_MAX_PROFILES + 1];
  int prof_size[MRT_MAX_PROFILES];
};

__device__ __forceinline__ int fits_slot(int m, int sm) {
  return (m & sm) == sm;
}

__device__ __forceinline__ int cc_of(int m, const MrtModel& md) {
  int cc = 0;
  for (int s = 0; s < md.num_slots; ++s) cc += fits_slot(m, md.slot_mask[s]);
  return cc;
}

// Eq. 1 CC: the slot templates fully free in the mask.  Replaces
// cc_pallas (repro/kernels/cc_score.py).
__global__ void cc_kernel(const int* __restrict__ masks, int* __restrict__ out,
                          int64_t n, MrtModel md) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = cc_of(masks[i], md);
}

// Alg. 4 fragmentation: per profile in order, greedily take every
// fitting slot, then add popcount(free) / size if the profile applied.
// Replaces frag_pallas (repro/kernels/frag_score.py).
__global__ void frag_kernel(const int* __restrict__ masks,
                            float* __restrict__ out, int64_t n, MrtModel md) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int full = (1 << md.num_blocks) - 1;
  int free_m = masks[i];
  float frag = 0.0f;
  for (int p = 0; p < md.num_profiles; ++p) {
    const int size = md.prof_size[p];
    const bool applies = __popc(free_m & full) >= size;
    for (int s = md.prof_start[p]; s < md.prof_start[p + 1]; ++s) {
      const int sm = md.slot_mask[s];
      if (fits_slot(free_m, sm)) free_m &= ~sm;
    }
    const float q = __fdiv_rn((float)__popc(free_m & full), (float)size);
    frag = __fadd_rn(frag, applies ? q : 0.0f);
  }
  out[i] = frag;
}

// Alg. 6: the best post-placement CC over the profile's fitting slots,
// -1 if none fits.  Replaces mcc_score_pallas
// (repro/kernels/policy_score.py).
__global__ void mcc_kernel(const int* __restrict__ masks, int* __restrict__ out,
                           int64_t n, int profile, MrtModel md) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int m = masks[i];
  int best = -1;
  for (int s = md.prof_start[profile]; s < md.prof_start[profile + 1]; ++s) {
    const int sm = md.slot_mask[s];
    if (fits_slot(m, sm)) best = max(best, cc_of(m & ~sm, md));
  }
  out[i] = best;
}

// Alg. 7: sum_p w[p] * (slots of p free after the default placement of
// the profile), -1 if none fits.  Replaces ecc_score_pallas
// (repro/kernels/policy_score.py).
__global__ void ecc_kernel(const int* __restrict__ masks,
                           const float* __restrict__ weights,
                           float* __restrict__ out, int64_t n, int profile,
                           MrtModel md) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int m = masks[i];
  // The default policy's start: the first slot maximizing the
  // post-placement CC (strict >, so the first maximizer is kept).
  int best_cc = -1;
  int best_after = m;
  for (int s = md.prof_start[profile]; s < md.prof_start[profile + 1]; ++s) {
    const int sm = md.slot_mask[s];
    if (!fits_slot(m, sm)) continue;
    const int after = m & ~sm;
    const int cc = cc_of(after, md);
    if (cc > best_cc) {
      best_cc = cc;
      best_after = after;
    }
  }
  // sum_p w[p] * |S(after, p)| in profile order, float32, no FMA.
  float ecc = 0.0f;
  for (int p = 0; p < md.num_profiles; ++p) {
    int count = 0;
    for (int s = md.prof_start[p]; s < md.prof_start[p + 1]; ++s)
      count += fits_slot(best_after, md.slot_mask[s]);
    ecc = __fadd_rn(ecc, __fmul_rn(weights[p], (float)count));
  }
  out[i] = best_cc >= 0 ? ecc : -1.0f;
}

static inline unsigned mrt_blocks(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

#define MRT_THREADS 256

// Plain C entry points (loaded with ctypes).  Each launches on the given
// stream, does not synchronize, and returns cudaGetLastError().
extern "C" {

int mrt_cc(const int* masks, int* out, int64_t n, MrtModel md, void* stream) {
  if (n > 0)
    cc_kernel<<<mrt_blocks(n, MRT_THREADS), MRT_THREADS, 0,
                (cudaStream_t)stream>>>(masks, out, n, md);
  return (int)cudaGetLastError();
}

int mrt_frag(const int* masks, float* out, int64_t n, MrtModel md,
             void* stream) {
  if (n > 0)
    frag_kernel<<<mrt_blocks(n, MRT_THREADS), MRT_THREADS, 0,
                  (cudaStream_t)stream>>>(masks, out, n, md);
  return (int)cudaGetLastError();
}

int mrt_mcc(const int* masks, int* out, int64_t n, int profile, MrtModel md,
            void* stream) {
  if (n > 0)
    mcc_kernel<<<mrt_blocks(n, MRT_THREADS), MRT_THREADS, 0,
                 (cudaStream_t)stream>>>(masks, out, n, profile, md);
  return (int)cudaGetLastError();
}

int mrt_ecc(const int* masks, const float* weights, float* out, int64_t n,
            int profile, MrtModel md, void* stream) {
  if (n > 0)
    ecc_kernel<<<mrt_blocks(n, MRT_THREADS), MRT_THREADS, 0,
                 (cudaStream_t)stream>>>(masks, weights, out, n, profile, md);
  return (int)cudaGetLastError();
}

}  // extern "C"
