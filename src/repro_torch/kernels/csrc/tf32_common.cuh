// Building blocks of the fp32 flash-attention kernels on the tensor cores
// (flash_f32.cu, flash_f32_bwd.cu): a three-term TF32 split of fp32
// operands for wgmma, the wgmma.m64nNk8 .tf32 instructions they issue,
// fp32 tensor maps, the pass that writes the split copies of an operand in
// device memory, and what a cluster pair of CTAs needs to trade partial
// products and to be launched (the forward and the backward at head dims
// 136-256).
//
// The split.  wgmma .tf32 reads 19 bits of each fp32 word (sign, exponent,
// 10 mantissa bits).  Write hi = x with its low 13 bits cleared and
// lo = x - hi, which is exact in fp32.  Then
//   a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b,
// whose error is about 2^-20 |a b|: the dropped lo_a lo_b and the 13 bits
// of lo that the tensor cores do not read both fall there.  A single TF32
// product (hi_a hi_b alone) is off by about 2^-11 and is never used.  The
// kernels clear the low bits of hi themselves, so the result does not
// depend on how the tensor cores treat the bits they drop.
//
// Operand layouts.  wgmma takes 32-bit operands K-major only (no transpose
// flag): A is (64 rows x k), B is (n rows x k), the reduction dimension k
// contiguous in both.  An operand that is stored with its output
// dimension contiguous (V for O += P V, dO for dV += P^T dO, Q for
// dK += dS^T Q, K for dQ += dS K) is read from a transposed copy
// (b, heads, hd, s_pad) written by split_kernel.
//
// P and dS from registers.  The fp32 accumulator of wgmma m64nN gives
// thread t of a warp columns 2 (t % 4) and 2 (t % 4) + 1 of each 8-column
// group, rows t / 4 and t / 4 + 8; the A fragment of a .tf32 m64k8 wants
// columns t % 4 and t % 4 + 4 (registers a0..a3: (row, t % 4),
// (row + 8, t % 4), (row, t % 4 + 4), (row + 8, t % 4 + 4)).  So the
// transposed copies store each 8-group of the reduction index permuted:
// position j of the group holds element 2 j (j < 4) or 2 (j - 4) + 1, and
// the accumulator's registers (v0, v2, v1, v3) of a group are the A
// fragment as they stand: no shuffle, no trip through shared memory.
//
// Shared-memory tiles.  K-major tiles with 32 fp32 (128 bytes) of k a row
// are written by TMA with SWIZZLE_128B (8-row groups 1024 bytes apart; a
// k step of 8 moves 32 bytes inside the row; the next 32 columns are the
// next box), the forward's V^T tiles too.  The backward's transposed stage
// tiles hold 16 of k a row (64 bytes) with SWIZZLE_64B (8-row groups 512
// bytes apart).

#pragma once

#include "hopper_common.cuh"

namespace tf32 {

using namespace hopper;

// ---------------------------------------------------------------- device ---

constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one MUFU instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// wgmma descriptor of a K-major SWIZZLE_64B tile at `p` (512-byte aligned):
// 8-row groups 512 bytes apart, layout type 2 in bits 62-63
__device__ __forceinline__ uint64_t smem_desc_sw64(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// A resident K-major operand of this warpgroup (rows row0 .. row0 + 63 of
// a SWIZZLE_128B tile whose 32-column boxes are `box` bytes apart; HDW / 8
// k steps): keeps hi of each element as this thread's A fragments and
// writes lo = x - hi over the element in place, then fences the async
// proxy and waits for the warpgroup (named barrier `bar`), so that wgmma
// reads the lo tile.  Two of a product's three terms then take A from
// registers (hi B_hi, hi B_lo) and one from shared memory (lo B_hi): the
// shared-memory bytes a k step reads fall from 2 A + 3 B tiles to A + 3 B.
// tq: the thread's index in the warpgroup.
template <int HDW>
__device__ __forceinline__ void split_resident(unsigned char* tile, int box,
                                               int row0,
                                               uint32_t (&hi)[HDW / 8][4],
                                               int tq, int bar) {
  const int lane = tq % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = row0 + 16 * (tq / 32) + g;
#pragma unroll
  for (int kk = 0; kk < HDW / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 8 * (i & 1);
      const int chunk = (kk % 4) * 2 + (i >> 1);
      float* p = reinterpret_cast<float*>(tile + (kk / 4) * box + row * 128 +
                                          ((chunk ^ g) * 16) + t * 4);
      const float x = *p;
      const float h = tf32_hi(x);
      *p = x - h;
      hi[kk][i] = __float_as_uint(h);
    }
  }
  fence_proxy_async();
  named_bar_sync(bar, 128);
}

// ------------------------------------------------- clusters of two CTAs ---
// (flash_f32.cu and flash_f32_bwd.cu at head dims 136-256: each CTA of a
// pair computes half of the head dim's reduction and the two trade their
// partial products through distributed shared memory)

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; after it the peer's barriers
// are initialised
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of `p` (this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float a, float b,
                                        float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// one arrival on a barrier of the peer CTA, releasing this thread's
// earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// mbar_wait that acquires the peer CTA's released writes
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// In a cluster pair: x (this thread's NV values, a multiple of 4, of its
// warpgroup's partial product over this CTA's half of the head dim) += the
// peer CTA's.  Step j's half goes into the peer's buffer j % 2 of this
// warpgroup once the peer has handed that buffer back (xempty, the arrive
// of its step j - 2), announced on the peer's xfull; then the peer's half
// is read from this CTA's own buffer, which is handed back unless no later
// step uses it (so that no arrive reaches a CTA that may have finished).
// Both CTAs add the same two partials (p0 + p1 = p1 + p0), so both hold
// the same bits.  xbuf: the warpgroup's two buffers of NV floats a thread,
// each NV / 4 float4 slices of 128 threads; total: the steps of the run.
template <int NV>
__device__ __forceinline__ void exchange(float* x, float* xbuf,
                                         uint64_t* xfull, uint64_t* xempty,
                                         int j, int total, int tq,
                                         uint32_t peer) {
  const int k = j & 1;
  float4* buf = reinterpret_cast<float4*>(xbuf) + k * (NV / 4) * 128;
  if (j >= 2) mbar_wait_cluster(&xempty[k], ((j >> 1) - 1) & 1);
  const uint32_t dst = peer_addr(buf + tq, peer);
#pragma unroll
  for (int i = 0; i < NV / 4; ++i)
    st_peer(dst + i * 128 * 16, x[4 * i], x[4 * i + 1], x[4 * i + 2],
            x[4 * i + 3]);
  mbar_arrive_peer(peer_addr(&xfull[k], peer));
  mbar_wait_cluster(&xfull[k], (j >> 1) & 1);
#pragma unroll
  for (int i = 0; i < NV / 4; ++i) {
    const float4 a = buf[i * 128 + tq];
    x[4 * i] += a.x; x[4 * i + 1] += a.y;
    x[4 * i + 2] += a.z; x[4 * i + 3] += a.w;
  }
  if (j + 2 < total) mbar_arrive_peer(peer_addr(&xempty[k], peer));
}

// The four accumulator registers of 8-column group kk, (v0, v1, v2, v3) =
// (row, 2t), (row, 2t + 1), (row + 8, 2t), (row + 8, 2t + 1), as hi and lo
// A fragments over the permuted group: (v0, v2, v1, v3).
__device__ __forceinline__ void split_frag(const float* acc, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const float a[4] = {acc[0], acc[2], acc[1], acc[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float h = tf32_hi(a[i]);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(a[i] - h);
  }
}

// wgmma.m64nNk8 with fp32 accumulators and .tf32 operands: Tf32<N>::ss (A
// and B from shared memory) and Tf32<N>::rs (A from registers)
template <int N>
struct Tf32;

template <>
struct Tf32<16> {
  // D (64 x 16, fp32) (+)= A (64 x 8, smem) * B (8 x 16, smem)
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D (64 x 16, fp32) (+)= A (64 x 8, registers) * B (8 x 16, smem)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Tf32<32> {
  // D (64 x 32, fp32) (+)= A (64 x 8, smem) * B (8 x 32, smem)
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D (64 x 32, fp32) (+)= A (64 x 8, registers) * B (8 x 32, smem)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Tf32<64> {
  // D (64 x 64, fp32) (+)= A (64 x 8, smem) * B (8 x 64, smem)
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D (64 x 64, fp32) (+)= A (64 x 8, registers) * B (8 x 64, smem)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Tf32<80> {
  // D (64 x 80, fp32) (+)= A (64 x 8, registers) * B (8 x 80, smem)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39},"
        " {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Tf32<128> {
  // D (64 x 128, fp32) (+)= A (64 x 8, registers) * B (8 x 128, smem)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

// ---------------------------------------------------------- split copies ---

struct SplitParams {
  const float* src;           // (b, s, heads, hd) by element strides
  long long sb, sh, ss;
  float *hi, *lo;             // (b, s, heads, hd) contiguous, or null
  float *thi, *tlo;           // (b, heads, hd, s_pad) permuted, or null
  int s, heads, hd, s_pad;
};

// Block (x, y): rows 32 x .. 32 x + 31 of head y % heads of batch y / heads.
// Writes hi and lo in the source's layout and, transposed, in the permuted
// layout (position j of each 8-group of rows holds row 2 j or
// 2 (j - 4) + 1).  Rows past s are written as zeros in the transposed
// copies, so a tile reaching past s multiplies zeros.  Head dims past 128
// go through the tile 128 columns at a time.
__global__ void __launch_bounds__(256) split_kernel(const SplitParams P) {
  __shared__ float tile[32][129];
  const int y = blockIdx.y;
  const int b = y / P.heads, h = y % P.heads;
  const int c0 = blockIdx.x * 32;
  const float* src = P.src + b * P.sb + h * P.sh;
  for (int d0 = 0; d0 < P.hd; d0 += 128) {
    const int w = min(128, P.hd - d0);
    if (d0 > 0) __syncthreads();   // the previous columns are written out
    for (int i = threadIdx.x; i < 32 * w; i += 256) {
      const int r = i / w, d = d0 + i % w;
      const int c = c0 + r;
      const float x = c < P.s ? src[c * P.ss + d] : 0.f;
      tile[r][d - d0] = x;
      if (c < P.s && P.hi != nullptr) {
        const long long o =
            ((static_cast<long long>(b) * P.s + c) * P.heads + h) * P.hd + d;
        P.hi[o] = tf32_hi(x);
        P.lo[o] = x - tf32_hi(x);
      }
    }
    if (P.thi == nullptr) continue;
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * w; i += 256) {
      const int d = i / 32, j = i % 32, p = j % 8;
      const float x = tile[(j & ~7) + (p < 4 ? 2 * p : 2 * p - 7)][d];
      const long long o =
          (static_cast<long long>(y) * P.hd + d0 + d) * P.s_pad + c0 + j;
      P.thi[o] = tf32_hi(x);
      P.tlo[o] = x - tf32_hi(x);
    }
  }
}

// ------------------------------------------------------------------ host ---

// `grid` CTAs of `kernel` (`threads` each, `bytes` of dynamic shared
// memory) in clusters of CL along x (CL 1: a plain launch)
template <int CL, typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), unsigned grid, int threads,
                    int bytes, cudaStream_t st, Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (CL == 1) {
    kernel<<<grid, threads, bytes, st>>>(args...);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

inline int split_launch(const SplitParams& P, int batch, cudaStream_t st) {
  const dim3 grid(P.s_pad / 32, batch * P.heads);
  split_kernel<<<grid, 256, 0, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// an fp32 4-D tensor map (sizes innermost first, element strides of dims
// 1..3), boxes of box0 x box1 x 1 x 1 with the given swizzle, zero fill
// outside the tensor
inline int encode_f32(CUtensorMap* map, const void* base, const long long* dims,
                      const long long* strides, int box0, int box1,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return NO_ENCODE_ERROR;
  bind_context();
  const cuuint64_t d[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1],
                           (cuuint64_t)dims[2], (cuuint64_t)dims[3]};
  const cuuint64_t s[3] = {(cuuint64_t)strides[0] * 4,
                           (cuuint64_t)strides[1] * 4,
                           (cuuint64_t)strides[2] * 4};
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                  const_cast<void*>(base), d, s, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR_BASE + static_cast<int>(r);
}

// (b, s, heads, hd) by element strides (batch, head, row): boxes of 32 hd
// x `rows` rows of one head, SWIZZLE_128B
inline int encode_rows(CUtensorMap* map, const void* base, int batch, int s,
                       int heads, int hd, long long sb, long long sh,
                       long long ss, int rows) {
  const long long dims[4] = {hd, s, heads, batch};
  const long long strides[3] = {ss, sh, sb};
  return encode_f32(map, base, dims, strides, 32, rows,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// a transposed copy (b, heads, hd, s_pad): boxes of `cols` positions x
// `rows` (the padded width) rows of one head, SWIZZLE_128B for 32
// positions, SWIZZLE_64B for 16
inline int encode_cols(CUtensorMap* map, const void* base, int batch,
                       int heads, int hd, int s_pad, int cols, int rows) {
  const long long dims[4] = {s_pad, hd, heads, batch};
  const long long strides[3] = {s_pad, static_cast<long long>(hd) * s_pad,
                                static_cast<long long>(heads) * hd * s_pad};
  return encode_f32(map, base, dims, strides, cols, rows,
                    cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace tf32
