// Dense causal / sliding-window flash-attention forward for Hopper (sm_90a).
//
// Replaces: _flash_kernel in src/repro/kernels/flash_attention/
// flash_attention.py (launched by flash_attention_bhsd through one
// pl.pallas_call over a (bh, q blocks, kv blocks) grid, kv innermost, the
// online-softmax state carried in VMEM scratch across kv steps).
//
// What bounds it on an H100: operations.  At the prefill of qwen3-4b
// (1 x 4096 tokens, 32 query heads, 8 KV heads, head_dim 128, causal) the
// function does 4 * 128 operations per live (row, column) pair, about
// 137 GFLOP, over about 84 MB of q, k, v and out: some 1,600 operations per
// byte against the card's ~295, so the tensor cores are the limit.  K and V
// are re-read once per 128-row q tile; they come from L2 (a head's K and V
// are 2 MB).  The kernel uses warp-level mma.sync (m16n8k16, bf16 in, fp32
// accumulate) fed by ldmatrix, with cp.async double-buffering the K/V
// sub-tiles; wgmma, TMA and a producer warp are later work.
//
// Design:
//   * The TPU's sequential kv grid axis cannot carry state across CTAs on
//     the card, so it becomes a loop inside the CTA: one CTA per
//     (lane, 128-row q tile), walking 64-column kv sub-tiles from the first
//     one the window reaches up to the causal diagonal.  Every sub-tile in
//     that range is live for some row of the tile; none outside it is.
//   * The causal triangle's longest q tiles sit at the bottom.  Block index
//     x maps to q tile nq - 1 - x / lanes, so the longest tiles are
//     dispatched first and the short ones fill the tail.
//   * The sub-tile machinery is flash_sched.cu's, shared through
//     flash_common.cuh: 8 warps x 16 rows, row state m / l / acc in
//     registers, fp32 math (bf16 products are exact in fp32; P is split
//     into bf16 hi + lo for P V).  The online softmax is updated per
//     64-column sub-tile where the TPU kernel updates it per 512-column
//     block, so the two agree within a tolerance, not bitwise; block_q and
//     block_k only name the TPU's blocking and do not change the result.
//   * NEG_INF is -1e30, not -inf.  A row whose columns in its first live
//     sub-tile are all masked (a window narrower than a tile) sees
//     p = exp(-1e30 - -1e30) = 1 there; the sub-tile that brings its first
//     real column wipes that with corr = exp(-1e30 - m) = 0, exactly as on
//     the TPU.  Every row of a dense causal or windowed grid has at least
//     its diagonal column, so no row is dead.
//   * GQA / MQA: KV head hh / (H / KVH), read in place; the broadcast is
//     never materialised.  Tensors are addressed through (batch, head, row)
//     strides, so the model layout (b, s, h, hd) is read without a copy.
//     The ragged tail (s not a multiple of the tile) is masked in the
//     kernel: K/V rows past s load as zeros and are masked, and only rows
//     below s are written.  Nothing is padded.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct DenseParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int lanes, nq, s, H, group, causal, window;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_dense_kernel(const DenseParams P) {
  constexpr int TILE = BK * (HD + 8);   // one K or V sub-tile (bf16)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: K at smem + 2 s TILE, V right after it
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int fr = lane / 4;         // fragment row within an 8-row half
  const int fc = (lane % 4) * 2;   // fragment column pair
  const int lm = lane / 8;         // ldmatrix: which 8x8 matrix
  const int lr = lane % 8;         // ldmatrix: which row of it

  // bottom (longest) q tiles first
  const int qt = P.nq - 1 - static_cast<int>(blockIdx.x) / P.lanes;
  const int lane_id = static_cast<int>(blockIdx.x) % P.lanes;
  const int b = lane_id / P.H;
  const int hh = lane_id % P.H;
  const int kvh = hh / P.group;
  const __nv_bfloat16* qb = P.q + b * P.q_sb + hh * P.q_sh;
  const __nv_bfloat16* kb = P.k + b * P.k_sb + kvh * P.k_sh;
  const __nv_bfloat16* vb = P.v + b * P.v_sb + kvh * P.v_sh;
  __nv_bfloat16* ob = P.o + b * P.o_sb + hh * P.o_sh;

  const int row0 = qt * BQ;
  const int qend = min(row0 + BQ, P.s);
  const int r_lo = row0 + warp * 16 + fr;
  const int r_hi = r_lo + 8;

  uint32_t qf[HD / 16][4];
  load_q<HD>(qf, qb, P.q_ss, r_lo, r_hi, qend, fc);

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  // live columns: from the window's reach of the first row (rounded down to
  // a sub-tile) to the diagonal of the last row (causal) or the end
  const int c_lo = P.window > 0 ? max(0, row0 - P.window + 1) / BK * BK : 0;
  const int c_hi = P.causal ? qend : P.s;

  load_kv<HD>(smem, smem + TILE, kb, vb, P.k_ss, P.v_ss, c_lo, P.s, tid);
  cp_async_commit();
  int st = 0;
  for (int col0 = c_lo; col0 < c_hi; col0 += BK) {
    // start loading the next sub-tile into the other stage
    if (col0 + BK < c_hi) {
      __nv_bfloat16* Kn = smem + 2 * (st ^ 1) * TILE;
      load_kv<HD>(Kn, Kn + TILE, kb, vb, P.k_ss, P.v_ss, col0 + BK, P.s, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this stage's group has landed
    __syncthreads();
    const __nv_bfloat16* Ks = smem + 2 * st * TILE;
    tile_step<HD>(Ks, Ks + TILE, qf, m, l, acc, col0, P.s, r_lo, r_hi,
                  P.causal, P.window, P.scale, fc, lm, lr);
    __syncthreads();   // every warp is done with this stage
    st ^= 1;
  }

  store_rows<HD>(ob, P.o_ss, acc, m, l, r_lo, r_hi, qend, fc);
}

template <int HD>
int launch_hd(const DenseParams& P, cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dense_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(P.lanes) * P.nq;
  flash_dense_kernel<HD><<<static_cast<unsigned>(grid), NTHREADS, bytes, st>>>(
      P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_dense_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int s,
    int H, int group, int hd, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    void* stream) {
  if (batch <= 0 || s <= 0 || H <= 0 || group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DenseParams P;
  P.q = static_cast<const __nv_bfloat16*>(q);
  P.k = static_cast<const __nv_bfloat16*>(k);
  P.v = static_cast<const __nv_bfloat16*>(v);
  P.o = static_cast<__nv_bfloat16*>(o);
  P.lanes = batch * H;
  P.nq = (s + BQ - 1) / BQ;
  P.s = s; P.H = H; P.group = group;
  P.causal = causal; P.window = window;
  P.q_sb = q_sb; P.q_sh = q_sh; P.q_ss = q_ss;
  P.k_sb = k_sb; P.k_sh = k_sh; P.k_ss = k_ss;
  P.v_sb = v_sb; P.v_sh = v_sh; P.v_ss = v_ss;
  P.o_sb = o_sb; P.o_sh = o_sh; P.o_ss = o_ss;
  P.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_hd<128>(P, st);
  if (hd == 64) return launch_hd<64>(P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
