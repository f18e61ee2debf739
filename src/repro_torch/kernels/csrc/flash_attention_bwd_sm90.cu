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
// are never expanded.
//
// Design: two kernels, no atomics, so two launches on the same inputs are
// bitwise equal.
//   * fa_bwd_dq, grid (query tiles, H, B), heaviest causal tiles first:
//     loads its Q and dO tile, computes D for its rows (written for the
//     next kernel), then walks the key tiles its rows may see: per tile it
//     recomputes S and dP, forms dS in shared memory and adds dS K to the
//     thread's dQ registers.
//   * fa_bwd_dkdv, grid (key tiles, KV, B), heaviest causal tiles first:
//     holds its K and V tile, walks the G query heads of its KV head and
//     the query tiles that may see its keys, recomputes S and dP per tile,
//     stores P and dS in shared memory and adds P^T dO and dS^T Q to the
//     thread's dV and dK registers.
// Tiles are 64 x 64; a CTA is 16 x 16 threads, thread (ty, tx) owning rows
// ty + 16a (a < 4) and columns tx + 16c, so a warp reads at most two rows
// of the row operand (a broadcast) and sixteen consecutive words of the
// column operand.  Every tile is float32 in shared memory with an odd row
// stride (width + 1), so a column read down sixteen rows also hits sixteen
// banks.  Inputs are converted at the load: one source and the same
// arithmetic serve bf16 (T = __nv_bfloat16) and float32 (T = float); the
// outputs are rounded once to T.
//
// Bound.  The gradient needs 4 products per visible pair (S recomputed,
// dP, dV, dK) and dQ one more, 10 * hd flops a pair at hd == hd_v; at the
// training shape (B 4, S 4096, H 32, KV 4, hd 64, causal) 0.69 TFLOP,
// 0.695 ms at the bf16 tensor-core rate (989 TFLOP/s).  This kernel runs
// on the CUDA cores (67 TFLOP/s float32 FMA peak) and does 14 * hd a pair
// (S and dP are recomputed in both kernels), reading two shared-memory
// words per FMA pair in its inner loops: it is bound by shared-memory
// bandwidth, far from that bound.  A wgmma / TMA design is ROADMAP Queue
// 1's next attention item.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;         // rows of every tile (queries or keys)
constexpr int THREADS = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int TR = BR / 16;    // rows (and score columns) per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows r0 .. r0 + BR - 1 of a (rows, W) slab whose row i starts at
// src + i * stride, into dst (row stride W + 1, float32); rows at or past
// n are zero.
template <int W, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int r0, int n) {
  for (int idx = threadIdx.x; idx < BR * W; idx += THREADS) {
    const int r = idx / W, c = idx % W;
    dst[r * (W + 1) + c] =
        r0 + r < n ? to_f(src[(int64_t)(r0 + r) * stride + c]) : 0.0f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
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
__device__ __forceinline__ void softmax_grad(
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
template <int HD, int HDV, typename T>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dO, const float* __restrict__ lse,
              float* __restrict__ Dout, T* __restrict__ dq, int Sq, int Sk,
              int H, int KV, float scale, int causal, int window) {
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
  const T* qb = q + (int64_t)b * Sq * qrow + (int64_t)h * HD;
  const T* ob = o + (int64_t)b * Sq * orow + (int64_t)h * HDV;
  const T* dob = dO + (int64_t)b * Sq * orow + (int64_t)h * HDV;
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
                    to_f(ob[(int64_t)(q0 + i) * orow + tx + 16 * c]), part);
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
  const T* kb = k + (int64_t)b * Sk * krow + (int64_t)kvh * HD;
  const T* vb = v + (int64_t)b * Sk * vrow + (int64_t)kvh * HDV;

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
    softmax_grad(s, dp, Ls, Dsm, nullptr, dSs, ty, tx, q0, k0, Sq, Sk, scale,
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
  T* dqb = dq + (int64_t)b * Sq * qrow + (int64_t)h * HD;
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c)
      dqb[(int64_t)row * qrow + tx + 16 * c] = from_f<T>(acc[a][c] * scale);
  }
}

// The same tensors, lse and D (B, H, Sq) -> dk (B, Sk, KV, HD) and dv (B,
// Sk, KV, HDV).
template <int HD, int HDV, typename T>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ Din,
                T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
                int KV, float scale, int causal, int window) {
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
    const T* qb = q + (int64_t)b * Sq * qrow + (int64_t)h * HD;
    const T* dob = dO + (int64_t)b * Sq * orow + (int64_t)h * HDV;
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
      softmax_grad(s, dp, Ls, Dsm, Ps, dSs, ty, tx, q0, k0, Sq, Sk, scale,
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
  T* dkb = dk + (int64_t)b * Sk * krow + (int64_t)kvh * HD;
  T* dvb = dv + (int64_t)b * Sk * vrow + (int64_t)kvh * HDV;
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= Sk) continue;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c)
      dkb[(int64_t)row * krow + tx + 16 * c] =
          from_f<T>(dk_acc[a][c] * scale);
#pragma unroll
    for (int c = 0; c < HDV / 16; ++c)
      dvb[(int64_t)row * vrow + tx + 16 * c] = from_f<T>(dv_acc[a][c]);
  }
}

template <int HD, int HDV, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const void* lse, void* D, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int H, int KV, float scale,
           int causal, int window, cudaStream_t stream) {
  constexpr int SM_DQ = dq_smem<HD, HDV>();
  constexpr int SM_DKDV = dkdv_smem<HD, HDV>();
  static_assert(SM_DKDV <= 232448, "tiles exceed the shared-memory budget");
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dq<HD, HDV, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SM_DQ);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dkdv<HD, HDV, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SM_DKDV);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dO);
  const float* tl = static_cast<const float*>(lse);
  float* tD = static_cast<float*>(D);
  if (Sq > 0) {
    fa_bwd_dq<HD, HDV, T><<<dim3((Sq + BR - 1) / BR, H, B), THREADS, SM_DQ,
                            stream>>>(
        tq, tk, tv, static_cast<const T*>(o), tdo, tl, tD,
        static_cast<T*>(dq), Sq, Sk, H, KV, scale, causal, window);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  fa_bwd_dkdv<HD, HDV, T><<<dim3((Sk + BR - 1) / BR, KV, B), THREADS,
                            SM_DKDV, stream>>>(
      tq, tk, tv, tdo, tl, tD, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, H, KV, scale, causal, window);
  return (int)cudaGetLastError();
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

// Plain C entry points (loaded with ctypes).  Each launches fa_bwd_dq, then
// fa_bwd_dkdv, on the given stream, does not synchronize, and returns
// cudaGetLastError() (the error that refused a launch).
//
// fa_backward_bf16: bf16 q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV,
// hd_v), o and dO (B, Sq, H, hd_v), contiguous; float32 lse (B, H, Sq)
// from the forward and scratch D (B, H, Sq); bf16 outputs dq, dk, dv of
// q's, k's and v's shapes.  hd == hd_v one of HEAD_DIMS, or (hd, hd_v) one
// of HEAD_DIM_PAIRS; window <= 0 means no window.
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

// fa_backward_f32: the same with float32 q, k, v, o, dO and outputs.
extern "C" int fa_backward_f32(const void* q, const void* k, const void* v,
                               const void* o, const void* dO, const void* lse,
                               void* D, void* dq, void* dk, void* dv, int B,
                               int Sq, int Sk, int H, int KV, int hd,
                               int hd_v, float scale, int causal, int window,
                               void* stream) {
  return backward<float>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Sq, Sk, H,
                         KV, hd, hd_v, scale, causal, window, stream);
}
