// Hopper (sm_90a) building blocks shared by the port's kernels (gmm.cu,
// gmm_any.cu, flash_dense.cu, flash_dense_bwd.cu, flash_sched.cu): mbarriers
// with a phase bit, TMA tensor loads and stores, 1-D bulk loads, the wgmma
// shared-memory descriptor and the wgmma instructions the kernels issue,
// register re-allocation between warpgroups, and the host-side encoding of
// tensor maps.
//
// Every shared-memory tile these kernels hand to wgmma is written by TMA
// with CU_TENSOR_MAP_SWIZZLE_128B: rows of 64 2-byte elements, bf16 or
// fp16 (128 bytes), the 16-byte chunks of row r stored at chunk ^ (r % 8),
// each tile 1024-byte aligned.
// Such a tile is described to wgmma by
//   * K-major (the reduction dimension contiguous, A of both kernels and B
//     of S = Q K^T): 8-row groups 1024 bytes apart (SBO); the next 16-wide
//     k step starts 32 bytes further on inside the 128-byte row;
//   * MN-major (the output dimension contiguous, B of gmm and of O = P V;
//     instruction flag trans-b = 1, or trans-a = 1 for an A operand, as the
//     dW kernel reads X^T): 8-row k groups 1024 bytes apart (SBO), 64-column
//     chunks of the output dimension LBO bytes apart (one TMA box each); the
//     next 16-deep k step starts 16 rows = 2048 bytes further on.
//
// The host encodes tensor maps with cuTensorMapEncodeTiled, fetched from the
// driver through the runtime (cudaGetDriverEntryPoint*), so no -lcuda is
// needed.  Launchers return a cudaError_t code, or ENCODE_ERROR_BASE + the
// CUresult when a tensor map cannot be encoded (error_string names it).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

namespace hopper {

// the launchers' dtype codes of the 2-byte types (SIMT_DTYPES in Python)
enum DType { BF16 = 1, F16 = 2 };

// ---------------------------------------------------------------- device ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory base rounded up to 1024 bytes (SWIZZLE_128B
// tiles and their wgmma descriptors assume that alignment)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed.  (No trap on a
// wait that never ends: a shared trap block would hold every warpgroup to
// the launch's register allocation, ignoring setmaxnreg.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// TMA: a box of the tensor map at the given coordinates (innermost first)
// into shared memory, completion reported to `bar` as transaction bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory, completion reported to `bar` as
// transaction bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// TMA: a box of shared memory out to the tensor map (elements outside the
// tensor are not written); tracked as a bulk async-group of this thread
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's bulk store groups are still reading shared
// memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma shared-memory descriptor of a SWIZZLE_128B tile at `p` (1024-byte
// aligned): start address, leading and stride byte offsets (16-byte units),
// layout type 1 (128-byte swizzle) in bits 62-63.  Adding n to the
// descriptor moves its start by 16 n bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that wgmma reads or writes asynchronously in place across
// this point, so that the compiler neither reads an accumulator before its
// wgmma_wait nor reuses an operand register while a wgmma may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 2-byte element types the kernels take, as the wgmma, TMA and
// conversion code below names them.  T = __half is fp16, anything else bf16.
template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

// two floats -> one register of two T (round to nearest), the first in the
// low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// one register of two T -> two floats (exact), the low half first
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (is_f16<T>)
    return __half22float2(*reinterpret_cast<__half2*>(&v));
  else
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

template <typename T>
__device__ __forceinline__ T cvt(float v) {
  if constexpr (is_f16<T>)
    return __float2half_rn(v);
  else
    return __float2bfloat16_rn(v);
}

// Accumulator layout of wgmma m64nN (fp32), value v of thread t of the
// warpgroup: row 16 (t / 32) + (t % 32) / 4 + 8 ((v / 2) % 2), column
// 8 (v / 4) + 2 (t % 4) + v % 2.  The A fragment of an RS wgmma (m64k16)
// has the same layout over its 16 columns: register i holds the pair
// (v = 2 i, 2 i + 1) of the accumulator of a 16-column slice.
//
// The wgmma wrappers below take the operands' element type T (default
// bf16) and emit .bf16 or .f16 with fp32 accumulators: the same instruction
// string but for that type name.  SS: A and B from shared memory, trans-a
// TRANS_A and trans-b TRANS_B (a transposed operand is allowed for both
// 16-bit types); RS: A from registers (four of two T each), trans-b only.
// The macros' operands: HOPPER_D<n> are d[0 .. n) read and written.

#define HOPPER_D8(i)                                                         \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),        \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define HOPPER_D32 HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
#define HOPPER_D40 HOPPER_D32, HOPPER_D8(32)
#define HOPPER_D64                                                           \
  HOPPER_D32, HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
#define HOPPER_D128                                                          \
  HOPPER_D64, HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88),    \
      HOPPER_D8(96), HOPPER_D8(104), HOPPER_D8(112), HOPPER_D8(120)

#define HOPPER_WGMMA_M64N256K16_SS(TY, TB, TA)                               \
  asm volatile(                                                              \
      "{\n.reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %130, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                               \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                             \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                             \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                             \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                             \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                             \
      " %56, %57, %58, %59, %60, %61, %62, %63,"                             \
      " %64, %65, %66, %67, %68, %69, %70, %71,"                             \
      " %72, %73, %74, %75, %76, %77, %78, %79,"                             \
      " %80, %81, %82, %83, %84, %85, %86, %87,"                             \
      " %88, %89, %90, %91, %92, %93, %94, %95,"                             \
      " %96, %97, %98, %99, %100, %101, %102, %103,"                         \
      " %104, %105, %106, %107, %108, %109, %110, %111,"                     \
      " %112, %113, %114, %115, %116, %117, %118, %119,"                     \
      " %120, %121, %122, %123, %124, %125, %126, %127},"                    \
      " %128, %129, p, 1, 1, %132, %131;\n}\n"                               \
      : HOPPER_D128                                                          \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA))

#define HOPPER_WGMMA_M64N128K16_SS(TY, TB, TA)                               \
  asm volatile(                                                              \
      "{\n.reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %66, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                               \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                             \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                             \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                             \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                             \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                             \
      " %56, %57, %58, %59, %60, %61, %62, %63},"                            \
      " %64, %65, p, 1, 1, %68, %67;\n}\n"                                   \
      : HOPPER_D64                                                           \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA))

#define HOPPER_WGMMA_M64N64K16_SS(TY, TB, TA)                                \
  asm volatile(                                                              \
      "{\n.reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                               \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                             \
      " %24, %25, %26, %27, %28, %29, %30, %31},"                            \
      " %32, %33, p, 1, 1, %36, %35;\n}\n"                                   \
      : HOPPER_D32                                                           \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB), "n"(TA))

#define HOPPER_WGMMA_M64N128K16_RS(TY, TB)                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %69, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                               \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                             \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                             \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                             \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                             \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                             \
      " %56, %57, %58, %59, %60, %61, %62, %63},"                            \
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                       \
      : HOPPER_D64                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),   \
        "n"(TB))

#define HOPPER_WGMMA_M64N80K16_RS(TY, TB)                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %45, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                               \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                             \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                             \
      " %32, %33, %34, %35, %36, %37, %38, %39},"                            \
      " {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"                       \
      : HOPPER_D40                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),   \
        "n"(TB))

#define HOPPER_WGMMA_M64N64K16_RS(TY, TB)                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %37, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                     \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                               \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                             \
      " %24, %25, %26, %27, %28, %29, %30, %31},"                            \
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                       \
      : HOPPER_D32                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),   \
        "n"(TB))

// D (64 x 256, fp32) (+)= A (64 x 16, smem) * B (16 x 256, smem)
template <int TRANS_B, int TRANS_A = 0, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float* d, uint64_t da,
                                                  uint64_t db, int scale_d) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N256K16_SS("f16", TRANS_B, TRANS_A);
  else
    HOPPER_WGMMA_M64N256K16_SS("bf16", TRANS_B, TRANS_A);
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) * B (16 x 128, smem)
template <int TRANS_B, int TRANS_A = 0, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da,
                                                  uint64_t db, int scale_d) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N128K16_SS("f16", TRANS_B, TRANS_A);
  else
    HOPPER_WGMMA_M64N128K16_SS("bf16", TRANS_B, TRANS_A);
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem) * B (16 x 64, smem)
template <int TRANS_B, int TRANS_A = 0, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N64K16_SS("f16", TRANS_B, TRANS_A);
  else
    HOPPER_WGMMA_M64N64K16_SS("bf16", TRANS_B, TRANS_A);
}

// D (64 x 128, fp32) (+)= A (64 x 16, registers) * B (16 x 128, smem)
template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a,
                                                  uint64_t db, int scale_d) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N128K16_RS("f16", TRANS_B);
  else
    HOPPER_WGMMA_M64N128K16_RS("bf16", TRANS_B);
}

// D (64 x 80, fp32) (+)= A (64 x 16, registers) * B (16 x 80, smem).  MN-
// major, the 80 columns cross from one 64-column swizzle atom into the
// next, LBO bytes on, as an n128's do.
template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n80k16_rs(float* d, const uint32_t* a,
                                                 uint64_t db, int scale_d) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N80K16_RS("f16", TRANS_B);
  else
    HOPPER_WGMMA_M64N80K16_RS("bf16", TRANS_B);
}

// D (64 x 64, fp32) (+)= A (64 x 16, registers) * B (16 x 64, smem)
template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                  uint64_t db, int scale_d) {
  if constexpr (is_f16<T>)
    HOPPER_WGMMA_M64N64K16_RS("f16", TRANS_B);
  else
    HOPPER_WGMMA_M64N64K16_RS("bf16", TRANS_B);
}

// ------------------------------------------------------------------ host ---

constexpr int ENCODE_ERROR_BASE = 10000;   // + CUresult
constexpr int NO_ENCODE_ERROR = 9999;      // entry point not found

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Makes the current device's primary context current in the calling
// thread.  cuTensorMapEncodeTiled does not do so itself: in a thread whose
// first CUDA call is a launcher's (PyTorch's autograd thread for the card,
// in the first backward) no context is current yet, and it fails with
// CUDA_ERROR_INVALID_CONTEXT.  cudaSetDevice makes the context current.
inline void bind_context() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
}

// A tensor map of `rank` dims of 2-byte elements, bf16 or fp16 by `dtype`
// (TMA only moves them, and its zero fill is +0.0 in both), sizes innermost
// first, byte strides of dims 1..rank-1, SWIZZLE_128B boxes of `box`, zero
// fill outside the tensor.  Returns 0 or an error code for the launcher to
// return.
inline int encode_tiled(CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box, int dtype) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return NO_ENCODE_ERROR;
  bind_context();
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  CUresult r = fn(map, dtype == F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR_BASE + static_cast<int>(r);
}

inline const char* error_string(int code) {
  static char buf[96];
  if (code == NO_ENCODE_ERROR)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (code >= ENCODE_ERROR_BASE) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d",
             code - ENCODE_ERROR_BASE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
