// K15: one whole ViT block, replacing mfvit_tpu/ops/fused_block.py::
// fused_transformer_block (Pallas _block_kernel :36):
//
//   x2  = x + bf16(o . Wproj^T + bproj),  o = MHSA(LN1(x))   (K1's half)
//   out = x2 + bf16(GELU(LN2(x2) . W1^T + b1) . W2^T + b2)    (K2's half)
//
// The TPU kernel keeps x2 in VMEM between the halves. Here one image's
// qkv (197 x 1152 bf16 at ViT-S, 443 KiB) does not fit a block's 227 KiB
// of shared memory, so the attention core stays K1's: four launches on
// one stream, the first three K1's own device code (LN1 row statistics
// and the qkv GEMM with its bias in gemm_ln.cuh, then attn_core.cuh into
// the caller's (M, D) bf16 scratch o), and one new kernel, the block tail
// below, which runs everything after the attention core:
//
// - each block of eight warps owns BM full rows of the M = B*N tokens
//   (BM = 64 up to D = 384, 32 at D = 512) and stages its o rows in
//   shared memory;
// - proj: y = o . Wproj^T in fp32 (WMMA, Wproj streamed through shared
//   memory in K slices of 32), x2 = x + bf16(y + bproj) written into a
//   (BM, D) bf16 tile in shared memory: x2 never goes to device memory;
// - LN2 row statistics from that tile (one warp per row, the order of
//   gemm_ln.cuh's ln_stats_kernel), LN2(x2) rounded to bf16 over the o
//   tile, which is no longer needed;
// - the MLP over the hidden width in chunks of 128: h = bf16(GELU_erf(
//   LN2(x2) . W1[chunk]^T + b1[chunk])) into a (BM, 128) bf16 tile in
//   shared memory, then acc += h . W2[:, chunk]^T into fp32 accumulators
//   that hold the whole (BM, D) output tile in registers across the
//   chunks: the (M, 4D) hidden never goes to device memory;
// - out = x2 + bf16(acc + b2).
//
// Rounding points are K1's and K2's (gemm_ln.cuh's epilogues, eps 1e-6,
// exact erff). Every fp32 sum runs over k in the order of gemm_ln.cuh's K
// loop (WMMA 16x16x16 steps from k = 0 up, one accumulator per output, no
// split-K; the fc2 chunks continue the same accumulator), and the LN2
// statistics are summed as ln_stats_kernel sums them, so K15 equals the
// K1 -> K2 chain bit for bit.
//
// What bounds it on an H100: its GEMMs are compute-bound (193.7 GFLOP at
// ViT-S B=256, 0.196 ms at the bf16 peak; the bytes bound is 0.023 ms).
// Against K1 + K2 it drops about 387 MB of device-memory traffic at B=256
// (the x2 write and read, the LN2 statistics, the hidden write and read),
// about 0.116 ms. This first version uses WMMA with register-prefetched,
// single-buffered weight slices and one block of 8 warps per SM (153 KiB
// of shared memory at ViT-S), so, like gemm_ln, it runs far from the
// tensor-core peak; wgmma/TMA and warp specialisation are later work.
// Each block reads every weight of the block's second half once from L2.
// D > 512 is refused: the fp32 output tile in registers would pass 128
// floats a thread.
#include "attn_core.cuh"
#include "gemm_ln.cuh"

namespace {

constexpr int TAIL_THREADS = 256;  // eight warps
constexpr int HC = 128;            // hidden columns per MLP chunk

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct TailArgs {
  const bf16* x;      // (M, D) block input, the first residual
  const bf16* o;      // (M, D) attention core output
  const bf16* wproj;  // (D, D)
  const float* bproj;
  const float* ln2_s;
  const float* ln2_b;
  const bf16* w1;     // (Hd, D)
  const float* b1;
  const bf16* w2;     // (D, Hd)
  const float* b2;
  bf16* out;          // (M, D)
  int M, Hd;
};

// Warps are laid out WM x WN over a (BM, cols) output tile, each owning 32
// rows (two 16-row fragments) and cols / WN columns.
template <int BM, int D>
struct Tail {
  static constexpr int WM = BM / 32;
  static constexpr int WN = TAIL_THREADS / 32 / WM;
  static constexpr int FN = D / 16 / WN;    // fragments a warp holds across D
  static constexpr int FN1 = HC / 16 / WN;  // across one hidden chunk
  static constexpr int LDS = D + 8;         // bf16 pitch of the (BM, D) tiles
  static constexpr int LDH = HC + 8;        // bf16 pitch of the hidden tile
  static constexpr int NW = D > HC ? D : HC;  // most weight rows staged at once
  // shared memory, in bytes (each offset a multiple of 32, as WMMA needs)
  static constexpr int A_OFF = 0;  // the o rows, then LN2(x2)
  static constexpr int X2_OFF = A_OFF + BM * LDS * 2;
  static constexpr int H_OFF = X2_OFF + BM * LDS * 2;
  static constexpr int W_OFF = H_OFF + BM * LDH * 2;
  static constexpr int S_OFF = W_OFF + NW * LDA * 2;  // a 16x16 fp32 tile per warp
  static constexpr int SMEM = S_OFF + TAIL_THREADS / 32 * 256 * 4;
  static_assert(WM * 32 == BM && FN * 16 * WN == D && FN1 * 16 * WN == HC, "warp tiling");
};

// acc[2][FN] += As[wrow .. wrow+32, 0:K] . W[wcol .. wcol+16*FN, 0:K]^T:
// As in shared memory (bf16 pitch lda); the NR rows of W (row pitch ldw)
// streamed through Ws in K slices of BK, the next slice held in registers
// while the current one is multiplied. The k steps of each accumulator
// run in gemm_ln.cuh's order.
template <int NR, int FN>
__device__ __forceinline__ void smem_gemm(const bf16* As, int lda, const bf16* __restrict__ W,
                                          int ldw, int K, bf16* Ws, int wrow, int wcol,
                                          FragC (&acc)[2][FN]) {
  constexpr int BV = NR * (BK / 8) / TAIL_THREADS;  // 16-byte vectors per thread
  static_assert(BV * TAIL_THREADS == NR * (BK / 8), "W slice split");
  const int tid = threadIdx.x;
  uint4 br[BV];
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * TAIL_THREADS;
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      br[v] = *reinterpret_cast<const uint4*>(W + (size_t)i * ldw + k0 + kc);
    }
  };
  const int KT = K / BK;
  load(0);
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * TAIL_THREADS;
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(Ws + i * LDA + kc) = br[v];
    }
    __syncthreads();
    if (kt + 1 < KT) load((kt + 1) * BK);  // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA af[2];
      FragB bfr[FN];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wrow + i * 16) * lda + kt * BK + kk, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], Ws + (wcol + j * 16) * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // Ws is rewritten next
  }
}

template <int FN>
__device__ __forceinline__ void zero(FragC (&acc)[2][FN]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// Hand one 16x16 accumulator tile to f(row, col, v): the warp stages it in
// its fp32 scratch tile, and each lane gets 8 adjacent values of one row
// (row = lane / 2, col = 8 * (lane % 2)).
template <class F>
__device__ __forceinline__ void frag_epilogue(const FragC& acc, float* scratch, F&& f) {
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c = (lane & 1) * 8;
  float v[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = scratch[r * 16 + c + t];
  f(r, c, v);
  __syncwarp();  // the scratch tile is rewritten next
}

template <int BM, int D>
__global__ void __launch_bounds__(TAIL_THREADS) block_tail_kernel(const TailArgs p) {
  using T = Tail<BM, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + T::A_OFF);
  bf16* X2 = reinterpret_cast<bf16*>(smem + T::X2_OFF);
  bf16* Hs = reinterpret_cast<bf16*>(smem + T::H_OFF);
  bf16* Ws = reinterpret_cast<bf16*>(smem + T::W_OFF);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = reinterpret_cast<float*>(smem + T::S_OFF) + warp * 256;
  const int m0 = blockIdx.x * BM;
  const int wrow = (warp / T::WN) * 32, wn = warp % T::WN;
  const int wcol = wn * (D / T::WN), wcol1 = wn * (HC / T::WN);

  // the block's o rows (zeros past M)
  for (int g = threadIdx.x; g < BM * D / 8; g += TAIL_THREADS) {
    const int i = g / (D / 8), c = (g % (D / 8)) * 8;
    const int r = m0 + i;
    *reinterpret_cast<uint4*>(As + i * T::LDS + c) =
        r < p.M ? *reinterpret_cast<const uint4*>(p.o + (size_t)r * D + c)
                : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // proj + bias + residual: x2 (bf16) into shared memory
  {
    FragC acc[2][T::FN];
    zero(acc);
    smem_gemm<D, T::FN>(As, T::LDS, p.wproj, D, D, Ws, wrow, wcol, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        frag_epilogue(acc[i][j], scratch, [&](int rr, int cc, float* v) {
          const int row = wrow + i * 16 + rr, col = wcol + j * 16 + cc;
          const int r = m0 + row;
          float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (r < p.M) bf16x8_to_float(*reinterpret_cast<const uint4*>(p.x + (size_t)r * D + col), x);
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] += p.bproj[col + t];
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] = x[t] + round_bf16(v[t]);
          *reinterpret_cast<uint4*>(X2 + row * T::LDS + col) = float_to_bf16x8(v);
        });
  }
  __syncthreads();

  // LN2 row statistics and LN2(x2) (bf16) over the o rows, one warp a row
  for (int row = warp; row < BM; row += TAIL_THREADS / 32) {
    const bf16* xr = X2 + row * T::LDS;
    float s = 0.f;
    for (int k = lane * 8; k < D; k += 256) {
      float f[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(xr + k), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += f[j];
    }
    const float mean = warp_sum(s) / D;
    float var = 0.f;
    for (int k = lane * 8; k < D; k += 256) {
      float f[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(xr + k), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[j] - mean;
        var += d * d;
      }
    }
    var = warp_sum(var) / D;
    const float rstd = 1.0f / sqrtf(var + 1e-6f);
    for (int k = lane * 8; k < D; k += 256) {
      float f[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(xr + k), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = (f[j] - mean) * rstd * p.ln2_s[k + j] + p.ln2_b[k + j];
      *reinterpret_cast<uint4*>(As + row * T::LDS + k) = float_to_bf16x8(f);
    }
  }
  __syncthreads();

  // the MLP, 128 hidden columns at a time; fc2's accumulators span the chunks
  FragC acc2[2][T::FN];
  zero(acc2);
  for (int c0 = 0; c0 < p.Hd; c0 += HC) {
    FragC acc1[2][T::FN1];
    zero(acc1);
    smem_gemm<HC, T::FN1>(As, T::LDS, p.w1 + (size_t)c0 * D, D, D, Ws, wrow, wcol1, acc1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < T::FN1; ++j)
        frag_epilogue(acc1[i][j], scratch, [&](int rr, int cc, float* v) {
          const int row = wrow + i * 16 + rr, col = wcol1 + j * 16 + cc;
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] += p.b1[c0 + col + t];
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] = gelu_erf(v[t]);
          *reinterpret_cast<uint4*>(Hs + row * T::LDH + col) = float_to_bf16x8(v);
        });
    __syncthreads();
    smem_gemm<D, T::FN>(Hs, T::LDH, p.w2 + c0, p.Hd, HC, Ws, wrow, wcol, acc2);
  }

  // fc2 bias + residual
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      frag_epilogue(acc2[i][j], scratch, [&](int rr, int cc, float* v) {
        const int row = wrow + i * 16 + rr, col = wcol + j * 16 + cc;
        const int r = m0 + row;
        if (r >= p.M) return;
        float x[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(X2 + row * T::LDS + col), x);
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] += p.b2[col + t];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = x[t] + round_bf16(v[t]);
        *reinterpret_cast<uint4*>(p.out + (size_t)r * D + col) = float_to_bf16x8(v);
      });
}

template <int BM, int D>
int launch_tail(const TailArgs& p, cudaStream_t s) {
  using T = Tail<BM, D>;
  auto kern = block_tail_kernel<BM, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<(p.M + BM - 1) / BM, TAIL_THREADS, T::SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

MFV_API int mfv_fused_transformer_block(const void* x, const void* ln1_s, const void* ln1_b,
                                        const void* wqkv, const void* bqkv, const void* wproj,
                                        const void* bproj, const void* ln2_s, const void* ln2_b,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, void* stats, void* qkv, void* o,
                                        void* out, int B, int N, int D, int heads, int Hd,
                                        float scale, void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0 || Hd <= 0 || Hd % HC != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  GemmArgs p = gemm_args(x, M, 3 * D, D, wqkv, qkv);
  p.bias = static_cast<const float*>(bqkv);
  p.ln_g = static_cast<const float*>(ln1_s);
  p.ln_b = static_cast<const float*>(ln1_b);
  p.ln_eps = 1e-6f;
  p.ln_stats = static_cast<float2*>(stats);
  int e = gemm_ln<true, EPI_BIAS>(p, s);
  if (e) return e;
  e = attn_core<bf16>(qkv, o, B, N, heads, D / heads, scale, s);
  if (e) return e;
  TailArgs t;
  t.x = static_cast<const bf16*>(x);
  t.o = static_cast<const bf16*>(o);
  t.wproj = static_cast<const bf16*>(wproj);
  t.bproj = static_cast<const float*>(bproj);
  t.ln2_s = static_cast<const float*>(ln2_s);
  t.ln2_b = static_cast<const float*>(ln2_b);
  t.w1 = static_cast<const bf16*>(w1);
  t.b1 = static_cast<const float*>(b1);
  t.w2 = static_cast<const bf16*>(w2);
  t.b2 = static_cast<const float*>(b2);
  t.out = static_cast<bf16*>(out);
  t.M = M;
  t.Hd = Hd;
  switch (D) {
    case 128: return launch_tail<64, 128>(t, s);
    case 256: return launch_tail<64, 256>(t, s);
    case 384: return launch_tail<64, 384>(t, s);
    case 512: return launch_tail<32, 512>(t, s);
  }
  return (int)cudaErrorInvalidValue;
}
