// Building blocks of the port's SIMT kernels (gmm_simt.cu, flash_simt.cu,
// flash_simt_bwd.cu): the element types they read and write, converted to
// and from fp32 in registers, vector loads of fp32 runs in shared memory,
// and the flash kernels' tile loads.
//
// These kernels take what the wgmma kernels do not: fp32 and fp16 operands
// (and bf16 at shapes the TMA boxes cannot describe).  Every product is
// plain fp32 FMA on the CUDA cores, never TF32, as the reference's fp32
// dot_general computes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

// the dtype codes the launchers take
enum DType { F32 = 0, BF16 = 1, F16 = 2 };

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float in(float x) { return x; }
  static __device__ __forceinline__ float out(float x) { return x; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float in(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half out(float x) {
    return __float2half_rn(x);
  }
};

// N consecutive fp32 values of shared memory into registers; p is aligned
// to min(N, 4) floats
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  if constexpr (N == 1) {
    r[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  } else {
    static_assert(N % 4 == 0, "lds: 1, 2 or a multiple of 4 floats");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(p + 4 * i);
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  }
}

// four consecutive elements of T from device memory as fp32; p is aligned
// to 4 elements
template <typename T>
__device__ __forceinline__ void ldg4(float (&r)[4], const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = Cvt<T>::in(e[i]);
  }
}

// The flash kernels' tile loads (flash_simt.cu, flash_simt_bwd.cu, 256
// threads): ROWS rows of `src` (row stride rs, unit column stride), rows at
// or past nvalid and columns at or past hd zero-filled, columns d < ncols.
// Each thread issues up to four reads before it stores any, so that they
// are in flight together.  With `vec` (hd, the row stride and the base
// aligned to 4 elements) a read takes 4 consecutive columns.
constexpr int TILE_THREADS = 256;

// dst[d * LD + r]: rows run fastest across threads (conflict-free stores)
template <typename T, int ROWS, int LD>
__device__ __forceinline__ void load_t(float* dst, const T* src, long long rs,
                                       int nvalid, int hd, int ncols,
                                       bool vec) {
  constexpr int NT = TILE_THREADS;
  if (vec) {
    const int total = ROWS * (ncols / 4);
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * NT) {
      float x[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT, r = i % ROWS, d = (i / ROWS) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) x[u][e] = 0.f;
        if (i < total && r < nvalid && d < hd) ldg4<T>(x[u], src + r * rs + d);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT, r = i % ROWS, d = (i / ROWS) * 4;
        if (i < total)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(d + e) * LD + r] = x[u][e];
      }
    }
  } else {
    const int total = ROWS * ncols;
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * NT) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT, r = i % ROWS, d = i / ROWS;
        x[u] = (i < total && r < nvalid && d < hd)
                   ? Cvt<T>::in(src[r * rs + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT;
        if (i < total) dst[(i / ROWS) * LD + i % ROWS] = x[u];
      }
    }
  }
}

// dst[r * LD + d]: columns run fastest (coalesced reads); LD % 4 == 0
template <typename T, int ROWS, int LD>
__device__ __forceinline__ void load_r(float* dst, const T* src, long long rs,
                                       int nvalid, int hd, int ncols,
                                       bool vec) {
  constexpr int NT = TILE_THREADS;
  if (vec) {
    const int n4 = ncols / 4, total = ROWS * n4;
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * NT) {
      float x[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT, r = i / n4, d = (i % n4) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) x[u][e] = 0.f;
        if (i < total && r < nvalid && d < hd) ldg4<T>(x[u], src + r * rs + d);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT, r = i / n4, d = (i % n4) * 4;
        if (i < total)
          *reinterpret_cast<float4*>(dst + r * LD + d) =
              make_float4(x[u][0], x[u][1], x[u][2], x[u][3]);
      }
    }
  } else {
    const int total = ROWS * ncols;
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * NT) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT, r = i / ncols, d = i % ncols;
        x[u] = (i < total && r < nvalid && d < hd)
                   ? Cvt<T>::in(src[r * rs + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT;
        if (i < total) dst[(i / ncols) * LD + i % ncols] = x[u];
      }
    }
  }
}

inline int set_smem(const void* fn, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

inline const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace simt
