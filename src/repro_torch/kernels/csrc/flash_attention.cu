// Flash attention forward for Hopper (sm_90a) on float32 inputs: causal /
// sliding-window GQA attention with an online softmax, float32 statistics
// and accumulator.  Replaces the TPU Pallas kernel flash_attention_pallas
// (repro/kernels/flash_attention.py, body _fa_kernel) for float32 q/k/v and
// computes the same function as the chunked reference
// repro/models/layers.flash_attention.  bf16 inputs go to fa_fwd_wgmma
// (flash_attention_sm90.cu), which runs on the tensor cores; a bf16 wgmma
// here would round float32 q and k, a different function.
//
// Layout.  q (B, Sq, H, HD), k and v (B, Sk, KV, HD), o (B, Sq, H, HD), all
// contiguous, read in place: no transpose to (B*H, S, HD) and no expanded
// K/V.  Query head h reads KV head h / (H / KV), as the Pallas kv_index.
//
// Design.  One CTA of 256 threads per (64-row query tile, head, batch),
// heaviest (last) causal tiles first.  The query tile is loaded once into
// shared memory (transposed, so a thread reads four rows with one 16-byte
// load); each 64-key K tile (transposed) and V tile (row-major) is staged
// through shared memory.  Thread (ty, tx) of a 16 x 16 grid owns score
// rows 4ty..4ty+3 and key columns 4tx..4tx+3, and output rows 4ty..4ty+3
// and columns tx*HD/16 onwards, so the running max m, sum l and rescale
// alpha of its rows stay in its registers for the whole key loop; row
// reductions are shuffles across the 16 lanes that share ty.  The
// probability tile goes through shared memory to the p @ v product.
//
// Semantics kept from _fa_kernel: scores are float32 dot products times
// 1/sqrt(HD); masked scores are -1e30 (not -inf), m starts at -1e30 and l
// at 0, so a row whose first visited tile is fully masked accumulates junk
// that alpha = 0 wipes once a real key arrives; the output is
// acc / max(l, 1e-30).  Causality is top-left aligned (qpos >= kpos, both
// from 0), the window test kpos > qpos - window.  Key tiles wholly outside
// the causal or window bound are skipped.  Sq and Sk need not be multiples
// of 64: keys past Sk score -inf (weight exactly 0), rows past Sq are
// computed on zeros and not written.
//
// Bound.  At the prefill shape (B 4, S 4096, H 32, HD 64, causal) the work
// is ~275 GFLOP against ~0.26 GB of float32 q/k/v/o: operation-bound.  The
// products run as float32 FMAs on the CUDA cores (67 TFLOP/s peak), since
// float32 inputs have no exact tensor-core route.  This kernel keeps its
// simple tiling; the speed work went to the bf16 kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int LDT = BK + 4;   // row stride of the transposed tiles (floats)
constexpr float MASKED = -1e30f;

// Stage rows [0, 64) of a (rows, HD) tile whose rows are row_stride
// elements apart into shared memory, zero past rows_valid.  TRANSPOSE
// stores dst[d * LDT + r], else dst[r * HD + d].
template <int HD, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row_stride,
                                          int rows_valid) {
  constexpr int PER_ROW = HD / 4;
  for (int c = threadIdx.x; c < 64 * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int d0 = (c % PER_ROW) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows_valid)
      x = *reinterpret_cast<const float4*>(src + r * row_stride + d0);
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (TRANSPOSE)
        dst[(d0 + i) * LDT + r] = xv[i];
      else
        dst[r * HD + d0 + i] = xv[i];
    }
  }
}

// Max and sum over the 16 lanes that share a thread row (ty).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq,
                  int Sk, int H, int KV, float scale, int causal,
                  int window) {
  constexpr int CPT = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][LDT]
  float* Kt = Qt + HD * LDT;                    // [HD][LDT]
  float* Vs = Kt + HD * LDT;                    // [BK][HD]
  float* Pt = Vs + BK * HD;                     // [BK][LDT]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int q_valid = min(BQ, Sq - q0);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<HD, true>(Qt, q + (((int64_t)b * Sq + q0) * H + h) * HD,
                      (int64_t)H * HD, q_valid);

  float acc[4][CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  // Key tiles that hold a key some row of this tile may see.
  int kt_hi = (Sk + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (q0 + q_valid - 1) / BK + 1);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    const int k_valid = min(BK, Sk - k0);
    const int64_t kv_off = (((int64_t)b * Sk + k0) * KV + kvh) * HD;
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD, true>(Kt, k + kv_off, (int64_t)KV * HD, k_valid);
    load_tile<HD, false>(Vs, v + kv_off, (int64_t)KV * HD, k_valid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LDT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (kpos >= Sk)
          x = -INFINITY;
        else if ((causal && qpos < kpos) ||
                 (window > 0 && kpos <= qpos - window))
          x = MASKED;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Pt[(tx * 4 + j) * LDT + ty * 4 + i] = p;
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + row_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Pt[j * LDT + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; c += 2) {
        const float2 w =
            *reinterpret_cast<const float2*>(&Vs[j * HD + tx * CPT + c]);
        vv[c] = w.x;
        vv[c + 1] = w.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* out = o + (((int64_t)b * Sq + row) * H + h) * HD + tx * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[c] = acc[i][c] / den;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, float scale, int causal, int window,
           cudaStream_t stream) {
  const int smem = (2 * HD * LDT + BK * HD + BK * LDT) * (int)sizeof(float);
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV,
      scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes) for float32 tensors; window <= 0
// means no window.  Launches on the given stream, does not synchronize, and
// returns cudaGetLastError() (or the error that refused the launch).
extern "C" int fa_forward_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int Sq, int Sk, int H, int KV,
                              int hd, float scale, int causal, int window,
                              void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal, window,
                        st);
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal, window,
                        st);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal, window,
                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
