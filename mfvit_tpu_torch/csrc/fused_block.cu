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
// The LN2 and MLP stages are mlp_tail.cuh's, shared with the MLP schedule
// variants T6 and T7 (mlp_variants.cu).
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
#include "mlp_tail.cuh"

namespace {

constexpr int TAIL_THREADS = 256;  // eight warps

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

template <int BM, int D>
__global__ void __launch_bounds__(TAIL_THREADS) block_tail_kernel(const TailArgs p) {
  using T = RowTile<BM, D, TAIL_THREADS / 32>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + T::A_OFF);
  bf16* X2 = reinterpret_cast<bf16*>(smem + T::X_OFF);
  bf16* Hs = reinterpret_cast<bf16*>(smem + T::H_OFF);
  bf16* Ws = reinterpret_cast<bf16*>(smem + T::W_OFF);
  const int tid = threadIdx.x, warp = tid >> 5;
  float* scratch = reinterpret_cast<float*>(smem + T::S_OFF) + warp * 256;
  const int m0 = blockIdx.x * BM;
  const int wrow = (warp / T::WN) * 32, wn = warp % T::WN;  // T::FM == 2
  const int wcol = wn * (D / T::WN), wcol1 = wn * (HC / T::WN);
  const BlockSync sync;

  // the block's o rows (zeros past M)
  load_rows<D>(p.o + (size_t)m0 * D, As, T::LDS, p.M - m0, BM, tid, TAIL_THREADS);
  __syncthreads();

  // proj + bias + residual: x2 (bf16) into shared memory
  {
    FragC acc[2][T::FN];
    zero(acc);
    smem_gemm<D, 2, T::FN, TAIL_THREADS>(As, T::LDS, p.wproj, D, D, Ws, tid, wrow, wcol, acc,
                                         sync);
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

  // LN2(x2) (bf16) over the o rows, which are no longer needed
  ln_tile<D>(X2, As, T::LDS, BM, warp, TAIL_THREADS / 32, p.ln2_s, p.ln2_b);
  __syncthreads();

  // the MLP, 128 hidden columns at a time; fc2's accumulators span the
  // chunks; then fc2's bias and the residual
  FragC acc2[2][T::FN];
  mlp_chunks<D, 2, T::FN, T::FN1, TAIL_THREADS>(As, T::LDS, Hs, T::LDH, Ws, scratch, p.w1, p.b1,
                                                 p.w2, p.Hd, tid, wrow, wcol, wcol1, acc2, sync);
  residual_out<D>(acc2, p.b2, X2, T::LDS, p.out + (size_t)m0 * D, p.M - m0, scratch, wrow, wcol);
}

template <int BM, int D>
int launch_tail(const TailArgs& p, cudaStream_t s) {
  using T = RowTile<BM, D, TAIL_THREADS / 32>;
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
