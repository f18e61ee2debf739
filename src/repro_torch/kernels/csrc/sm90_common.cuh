// Hopper (sm_90a) primitives of the attention kernels, included by the
// forward (flash_attention_sm90.cu) and the backward
// (flash_attention_bwd_sm90.cu): mbarriers, TMA tensor loads and their
// 4-D tensor maps, wgmma with its shared-memory descriptors, the exact
// three-term bf16 split of a float32 value and the six plane products of
// a float32 product.  Each source compiles it into
// its own library; kernels/_build.py hashes it with every source that
// includes it, so a change here rebuilds both.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
                   // through the runtime, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a CTA may take

// Swizzled row in bytes for a head dim: 128 (64-column TMA boxes) where it
// is a multiple of 64, 64 (one 32-column box) at 32, else 32 (16-column
// boxes: hd 16 one, hd 80 five, hd 112 seven); and the descriptor's
// layout type for it: 1 = 128B, 2 = 64B, 3 = 32B swizzle.
__host__ __device__ constexpr int row_bytes(int hd) {
  return hd % 64 == 0 ? 128 : hd % 32 == 0 ? 64 : 32;
}
__host__ __device__ constexpr int desc_layout(int rowb) {
  return rowb == 128 ? 1 : rowb == 64 ? 2 : 3;
}

// ---------------------------------------------------------------------------
// mbarrier, TMA and wgmma primitives (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of the given parity to complete.  A wait that lasts
// 2^34 clocks (seconds) traps, so a barrier fault ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 34))
      __trap();
  }
}

// One box of a 4-D tensor map, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are
// pending (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes to this point
// of the program (after wgmma_wait_all), so the compiler neither reads an
// accumulator early nor reuses an A fragment's register while in flight.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// A tile of `rows` rows in TMA boxes of rowb swizzled bytes a row (box c
// of the tile at c * rows * rowb).  K-major operand: the reduction runs
// along a row, 8-row groups 8 * rowb apart; the leading offset is unused.
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int rowb) {
  return smem_desc(addr, 16, 8 * rowb, desc_layout(rowb));
}

// MN-major operand (transposed): the output columns run along a swizzled
// row, boxes rows * rowb apart (leading offset), the reduction down the
// rows, 8-row groups 8 * rowb apart (stride offset).
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int rows,
                                            int rowb) {
  return smem_desc(addr, rows * rowb, 8 * rowb, desc_layout(rowb));
}

// wgmma m64nNk16, bf16 inputs, float32 accumulator, overloaded on the
// accumulator's size (N / 2 floats a thread).  wgmma_ss: A and B from
// shared memory, both K-major; the first of a chain overwrites D
// (accumulate = 0).  wgmma_rs: A from registers (four b32, two bf16 each,
// in the A-fragment layout), B MN-major (transposed), always accumulates.
//
// The operand lists are generated: ACC_n names the asm operands %0 ..
// %(n - 1), the accumulator's registers, and OUT_n binds them to d[0 ..
// n - 1]; the remaining operands follow at %n on.
#define ACC_8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define ACC_16 ACC_8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define ACC_24 ACC_16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define ACC_32 ACC_24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define ACC_40 ACC_32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define ACC_48 ACC_40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define ACC_56 ACC_48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define ACC_64 ACC_56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define OUT4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define OUT8(i) OUT4(i), OUT4(i + 4)
#define OUT_8 OUT8(0)
#define OUT_16 OUT_8, OUT8(8)
#define OUT_24 OUT_16, OUT8(16)
#define OUT_32 OUT_24, OUT8(24)
#define OUT_40 OUT_32, OUT8(32)
#define OUT_48 OUT_40, OUT8(40)
#define OUT_56 OUT_48, OUT8(48)
#define OUT_64 OUT_56, OUT8(56)
#define STR_(x) #x
#define STR(x) STR_(x)

// NF floats a thread (N = 2 NF); P0 .. P5 are the operand numbers NF ..
// NF + 5, spelled out because asm operand numbers are literal text.
#define WGMMA_SS(NF, N, P0, P1, P2)                                        \
  __device__ __forceinline__ void wgmma_ss(float(&d)[NF], uint64_t da,     \
                                           uint64_t db, int accumulate) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" STR(P2) ", 0;\n"     \
                 "wgmma.mma_async.sync.aligned.m64n" STR(N)                \
                 "k16.f32.bf16.bf16 {" ACC_##NF "}, %" STR(P0) ", %" STR(  \
                     P1) ", p, 1, 1, 0, 0;\n}\n"                           \
                 : OUT_##NF                                                \
                 : "l"(da), "l"(db), "r"(accumulate));                     \
  }
#define WGMMA_RS(NF, N, P0, P1, P2, P3, P4, P5)                              \
  __device__ __forceinline__ void wgmma_rs(float(&d)[NF], const uint32_t* a, \
                                           uint64_t db) {                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" STR(P5) ", 0;\n"       \
                 "wgmma.mma_async.sync.aligned.m64n" STR(N)                  \
                 "k16.f32.bf16.bf16 {" ACC_##NF "}, {%" STR(P0) ", %" STR(   \
                     P1) ", %" STR(P2) ", %" STR(P3) "}, %" STR(P4)          \
                 ", p, 1, 1, 1;\n}\n"                                        \
                 : OUT_##NF                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                   "r"(1));                                                  \
  }

WGMMA_SS(8, 16, 8, 9, 10)
WGMMA_SS(16, 32, 16, 17, 18)
WGMMA_SS(32, 64, 32, 33, 34)
WGMMA_SS(64, 128, 64, 65, 66)
WGMMA_RS(8, 16, 8, 9, 10, 11, 12, 13)
WGMMA_RS(16, 32, 16, 17, 18, 19, 20, 21)
WGMMA_RS(32, 64, 32, 33, 34, 35, 36, 37)
WGMMA_RS(40, 80, 40, 41, 42, 43, 44, 45)
WGMMA_RS(56, 112, 56, 57, 58, 59, 60, 61)
WGMMA_RS(64, 128, 64, 65, 66, 67, 68, 69)

// x -> (hi, mid, lo) bf16 terms, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), rounded to nearest, the float32 subtractions exact:
// hi + mid + lo == x exactly (24 significant bits = 8 + 8 + 8) for every
// |x| >= 1e-30 (below, lo may be subnormal and the tensor core may flush
// it).  Each term times a bf16 operand is exact in float32.  split3 does
// two neighbouring columns, packed as one A-fragment register per term
// (the lower column in the low half).
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);  // x in the low half
  const float2 hf = __bfloat1622float2(h);
  const float xr = __fsub_rn(x, hf.x), yr = __fsub_rn(y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(xr, yr);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(
      __floats2bfloat162_rn(__fsub_rn(xr, mf.x), __fsub_rn(yr, mf.y)));
}

// Plane products of a float32 product x y from the bf16 planes of x and
// y (and of a split3'd float32 value), smallest first: pass t multiplies
// plane pass_a(t) of the left operand by plane pass_b(t) of the right (0
// hi, 1 mid, 2 lo): mid*mid, lo*hi, hi*lo, mid*hi, hi*mid, hi*hi.
// mid*lo, lo*mid and lo*lo (each at most 2^-24 |x y|) are dropped, so each
// product formed is within 2^-23 |x y| of the exact one
// (flash_attention_sm90.cu's note).
constexpr int PASSES = 6;
__host__ __device__ constexpr int pass_a(int t) {
  return t == 0 || t == 3 ? 1 : t == 1 ? 2 : 0;
}
__host__ __device__ constexpr int pass_b(int t) {
  return t == 0 || t == 4 ? 1 : t == 2 ? 2 : 0;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = -2;  // cuTensorMapEncodeTiled refused a map

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, with the device's context bound to the
// calling thread: a thread whose first CUDA work this is (PyTorch's autograd
// worker running an attention backward first) has no current context yet,
// and cuTensorMapEncodeTiled then refuses the map; cudaSetDevice binds the
// device's primary context.  Null if either fails.
EncodeTiled encoder() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return nullptr;
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (B, S, heads, hd), contiguous, read in boxes of
// (chunk columns, 1 head, rows, 1 batch), swizzled, zero past its edges.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
              int S, int heads, int hd, int chunk, int rows,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)chunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

CUtensorMapSwizzle swizzle_of(int rowb) {
  return rowb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : rowb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
}

}  // namespace
