// The copy of the dense flash entry's inputs to TMA's layout, for Hopper
// (sm_90a): q, k and v (the backward adds o, dO and o_lo), each a
// (b, s, heads, hd) tensor of any strides, into fresh contiguous
// (b, s, heads, hd_pad) tensors, hd_pad = hd rounded up to 8, the columns
// past hd zero.  flash_dense.cu, flash_f32.cu and their backwards then read
// the copies through TMA.
//
// Replaces no Pallas kernel: the reference's _flash_kernel
// (src/repro/kernels/flash_attention/flash_attention.py:51) reads any
// layout through its BlockSpecs.  TMA takes only strides and bases that
// are multiples of 16 bytes and head dims that are multiples of 8, so a
// call outside those goes through this copy first
// (kernels/flash_attention/flash_attention.py, _tma_pack).
//
// What bounds it on an H100: bytes, each input read once and each copy
// written once (3.35 TB/s).  One launch copies every tensor of a call
// (at most MAX_SEG, one dtype), so a call pays one launch, not a copy and
// a fill per tensor.  Each thread writes one 16-byte run of an output row
// (8 two-byte or 4 four-byte elements: hd_pad is a multiple of 8) with one
// vector store, and the threads of a warp write and read neighbouring
// runs of a row.  It reads the run in the widest words (2 to 16 bytes)
// that the input's base and strides keep aligned, where its last dim is
// contiguous: one element at a time, two-byte elements took twice the
// load instructions of four-byte ones for the same bytes and ran at
// about 1.7 TB/s against 2.6 on an H100.  Words that would cross the
// real head dim are read one element at a time, so nothing past a row is
// read.  A plain bit copy: the dtype is only the element size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SEG = 6;
constexpr int NT = 256;
// fields of one tensor in the launcher's table (int64 each): source,
// destination, b, s, heads, hd, and the source's strides in elements
// (batch, row, head, column)
constexpr int FIELDS = 10;

struct Seg {
  const char* src;
  char* dst;
  long long st[4];
  unsigned runs;   // the copy's 16-byte runs
  unsigned s, heads;
  int hd;
  int word;   // bytes of the loads (2-16); 0: one element at a time
};

struct Params {
  Seg seg[MAX_SEG];
  int hd_pad;
};

// The V elements of a run from column col0 of a row whose last dim is
// contiguous, in words W (K elements each) where a word lies wholly before
// hd, else one element at a time; zeros past hd.
template <typename T, int V, typename W>
__device__ __forceinline__ void load_run(const T* src, int col0, int hd,
                                         T (&e)[V]) {
  constexpr int K = sizeof(W) / sizeof(T);
#pragma unroll
  for (int j = 0; j < V; j += K) {
    const int col = col0 + j;
    if (col + K <= hd) {
      union {
        W w;
        T t[K];
      } u;
      u.w = *reinterpret_cast<const W*>(src + col);
#pragma unroll
      for (int m = 0; m < K; ++m) e[j + m] = u.t[m];
    } else {
#pragma unroll
      for (int m = 0; m < K; ++m) e[j + m] = col + m < hd ? src[col + m] : T(0);
    }
  }
}

// T: an unsigned integer of the element's size; V of them make 16 bytes.
// Block row blockIdx.y copies tensor blockIdx.y; the switch reads its
// fields at fixed offsets of the parameter block (an index in a register
// would copy the parameters to local memory).  32-bit index arithmetic:
// the launcher refuses a tensor of 2^31 runs or more.
template <typename T, int V>
__global__ void __launch_bounds__(NT) tma_pack_kernel(Params P) {
  Seg g;
  switch (blockIdx.y) {
    case 0: g = P.seg[0]; break;
    case 1: g = P.seg[1]; break;
    case 2: g = P.seg[2]; break;
    case 3: g = P.seg[3]; break;
    case 4: g = P.seg[4]; break;
    default: g = P.seg[5]; break;
  }
  const unsigned runs = P.hd_pad / V;   // 16-byte runs of an output row
  for (unsigned c = blockIdx.x * NT + threadIdx.x; c < g.runs;
       c += gridDim.x * NT) {
    const unsigned row = c / runs;
    const int col0 = static_cast<int>(c - row * runs) * V;
    const unsigned bs = row / g.heads;
    const unsigned bi = bs / g.s;
    const T* src = reinterpret_cast<const T*>(g.src) + bi * g.st[0] +
                   (bs - bi * g.s) * g.st[1] +
                   (row - bs * g.heads) * g.st[2];
    union {
      uint4 u;
      T e[V];
    } out;
    if (g.word == 16) {
      load_run<T, V, uint4>(src, col0, g.hd, out.e);
    } else if (g.word == 8) {
      load_run<T, V, uint2>(src, col0, g.hd, out.e);
    } else if (g.word == 4) {
      load_run<T, V, uint32_t>(src, col0, g.hd, out.e);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int col = col0 + j;
        out.e[j] = col < g.hd ? src[col * g.st[3]] : T(0);
      }
    }
    reinterpret_cast<uint4*>(g.dst)[c] = out.u;
  }
}

}  // namespace

// table: n x FIELDS int64 in host memory (see FIELDS); every destination a
// contiguous (b, s, heads, hd_pad) tensor, 16-byte aligned; elem_bytes 2
// or 4
extern "C" int tma_pack_launch(const long long* table, int n, int hd_pad,
                               int elem_bytes, void* stream) {
  if (n <= 0 || n > MAX_SEG || hd_pad <= 0 || hd_pad % 8 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{};
  P.hd_pad = hd_pad;
  const int V = 16 / elem_bytes;
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    const long long* t = table + i * FIELDS;
    Seg& g = P.seg[i];
    const long long runs = t[2] * t[3] * t[4] * (hd_pad / V);
    if (t[2] < 0 || t[3] < 0 || t[4] <= 0 || t[5] <= 0 || t[5] > hd_pad ||
        t[1] % 16 || runs >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    g.src = reinterpret_cast<const char*>(t[0]);
    g.dst = reinterpret_cast<char*>(t[1]);
    g.runs = static_cast<unsigned>(runs);
    g.s = static_cast<unsigned>(t[3]);
    g.heads = static_cast<unsigned>(t[4]);
    g.hd = static_cast<int>(t[5]);
    for (int j = 0; j < 4; ++j) g.st[j] = t[6 + j];
    // the widest word every row start is aligned to, where the last dim
    // is contiguous and a word holds more than one element
    long long bits = t[0] | 16;
    for (int j = 0; j < 3; ++j) bits |= t[6 + j] * elem_bytes;
    const int word = static_cast<int>(bits & -bits);
    g.word = t[9] == 1 && word > elem_bytes ? word : 0;
    most = runs > most ? runs : most;
  }
  if (most == 0) return static_cast<int>(cudaSuccess);
  const long long want = (most + NT - 1) / NT;
  const dim3 grid(static_cast<unsigned>(want < 8192 ? want : 8192), n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2)
    tma_pack_kernel<uint16_t, 8><<<grid, NT, 0, st>>>(P);
  else
    tma_pack_kernel<uint32_t, 4><<<grid, NT, 0, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tma_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
