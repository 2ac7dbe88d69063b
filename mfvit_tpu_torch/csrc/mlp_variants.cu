// The first designs of the MLP schedule variants of the JAX harness's
// timing tools, T6, T7 and T3, which now run on K2's tail (mlp3d.cu,
// mlp_pipe.cu) and stay here as check-only entries (mfv_mlp3d_wmma,
// mfv_mlp3d_staged_wmma, mfv_mlp_pipe_mma) that the card's checks hold the
// new ones against; only they run mlp_tail.cuh's WMMA stage and the
// mma.sync loop below. Each computes K2's
// function (mfvit_tpu/ops/fused_mlp.py::fused_mlp_block),
//
//   out = x + bf16(bf16(GELU_erf(LN(x) . W1^T + b1)) . W2^T + b2),
//
// in one launch with the (M, 4D) hidden on chip, with K2's rounding points
// (LN with eps 1e-6 and fp32 statistics, rounded; fp32 sums and biases,
// rounded once; exact erff GELU, rounded; the residual added in bf16).
// Every fp32 sum walks k in gemm_ln.cuh's order (steps of 16 from k = 0,
// one accumulator, no split-K) and the LN statistics are summed as
// ln_stats_kernel sums them, so each equals the K2 kernel (fused_mlp.cu)
// bit for bit. They differ only in their schedule:
//
// - T6 mlp3d, first design (tools/bench_mlp3d.py::mlp3d, _mlp3d_kernel :39): the MLP
//   stage of mlp_tail.cuh (WMMA). A block of eight warps owns `cb`
//   images' rows, as a TPU grid step owns a (cb, N, D) block, and walks
//   them in BM-row tiles (64, or 32 at D = 512): with `flat` the cb * N
//   rows as one run, so a tile may straddle two images (the in-kernel
//   flatten); without it image by image, so no tile crosses an image and
//   the last tile of each is ragged (N = 197 = 3 * 64 + 5).
// - T7 mlp3d_staged, first design (_mlp3d_staged_kernel :138): T6's per-image tiles, with
//   fc1 of the next tile issued before the GELU and fc2 of this one. On
//   Hopper that is ping-pong between two warpgroups: each owns every
//   other tile (32 rows, 16 at D = 512) and alternates a tensor-core
//   phase (fc2 of the previous hidden chunk, then fc1 of the next) with a
//   CUDA-core phase (the GELU of the chunk, or the tile's epilogue and the
//   next tile's load and LN). Two named barriers hand the tensor cores
//   over: a warpgroup waits (bar.sync) on its own before its tensor-core
//   phase and arrives (bar.arrive) on the other's after it, so one
//   warpgroup's erff runs while the other's MMAs do.
// - T3 mlp_pipe, first design (tools/bench_pipelined.py::mlp_pipe, _mlp_kernel_pipe :43):
//   flat row tiles of `tm` rows (32 or 64), each in `splits` sub-tiles (1,
//   2 or 4, of 16 to 64 rows), with fc1 of sub-tile j+1 issued before the
//   GELU and fc2 of sub-tile j (splits=1, as the TPU kernel allows, is the
//   same kernel with nothing to overlap). On Hopper that is software pipelining
//   inside each warp: the same warps issue sub-tile j+1's fc1 mma.sync
//   into a second set of accumulators, then run sub-tile j's GELU from
//   registers, so the tensor pipe and the FMA/SFU pipes overlap through
//   instruction-level parallelism. The hidden width goes in chunks of 64
//   whose W1 and W2 slices each fill one shared-memory buffer by cp.async:
//   the next W1 chunk loads while fc2 runs, the next W2 chunk while fc1
//   runs. The last tile is masked: no row past M is read or written (the
//   TPU wrapper's zero padding is a layout, not part of the function).
//
// What bounds them on an H100: K2's GEMMs, 4 * M * D * Hd operations (119
// GFLOP at ViT-S B=256, 0.120 ms at the bf16 peak; x read and the output
// written once, 0.06 ms at 3.35 TB/s). Against K2 they drop the hidden's
// round trip through device memory (310 MB at B=256, about 0.09 ms) and
// K2's LN statistics pass. These first versions use WMMA (T6, T7) or
// mma.sync (T3) with one block an SM, far from the tensor-core peak (all
// three moved to wgmma and TMA on K2's tail). Each block reads every weight once
// from L2 per tile (T6, T7) or per row tile (T3). D must be 128, 256, 384
// or 512: the fp32 output tile lives in registers.
#include "mlp_tail.cuh"

namespace {

struct MlpArgs {
  const bf16* x;  // (M, D)
  const float* ln_s;
  const float* ln_b;
  const bf16* w1;  // (Hd, D)
  const float* b1;
  const bf16* w2;  // (D, Hd)
  const float* b2;
  bf16* out;  // (M, D)
  int N, Hd;  // rows per image (T6, T7), hidden width
};

template <class Kern>
int launch(Kern kern, int grid, int threads, int smem, const MlpArgs& p, cudaStream_t s,
           int a, int b) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, s>>>(p, a, b);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- T6 mlp3d

constexpr int T6_WARPS = 8;

template <int BM, int D>
__global__ void __launch_bounds__(T6_WARPS * 32) mlp3d_kernel(const MlpArgs p, int cb, int flat) {
  using T = RowTile<BM, D, T6_WARPS>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + T::A_OFF);
  bf16* Xs = reinterpret_cast<bf16*>(smem + T::X_OFF);
  bf16* Hs = reinterpret_cast<bf16*>(smem + T::H_OFF);
  bf16* Ws = reinterpret_cast<bf16*>(smem + T::W_OFF);
  const int tid = threadIdx.x, warp = tid >> 5;
  float* scratch = reinterpret_cast<float*>(smem + T::S_OFF) + warp * 256;
  const int wrow = (warp / T::WN) * 16 * T::FM, wn = warp % T::WN;
  const int wcol = wn * (D / T::WN), wcol1 = wn * (HC / T::WN);
  const BlockSync sync;
  // flat: the cb * N rows as one run; per image: cb runs of N rows
  const int run = flat ? cb * p.N : p.N, runs = flat ? 1 : cb;
  const size_t base = (size_t)blockIdx.x * cb * p.N;
  for (int s = 0; s < runs; ++s)
    for (int t0 = 0; t0 < run; t0 += BM) {
      const size_t r0 = base + (size_t)s * run + t0;
      const int nr = min(BM, run - t0);
      load_rows<D>(p.x + r0 * D, Xs, T::LDS, nr, BM, tid, T6_WARPS * 32);
      sync();
      ln_tile<D>(Xs, As, T::LDS, BM, warp, T6_WARPS, p.ln_s, p.ln_b);
      sync();
      FragC acc2[T::FM][T::FN];
      mlp_chunks<D, T::FM, T::FN, T::FN1, T6_WARPS * 32>(As, T::LDS, Hs, T::LDH, Ws, scratch,
                                                          p.w1, p.b1, p.w2, p.Hd, tid, wrow, wcol,
                                                          wcol1, acc2, sync);
      residual_out<D>(acc2, p.b2, Xs, T::LDS, p.out + r0 * D, nr, scratch, wrow, wcol);
      sync();  // Xs and As take the next tile
    }
}

template <int D>
int mlp3d_d(const MlpArgs& p, int B, int cb, int flat, cudaStream_t s) {
  constexpr int BM = D > 384 ? 32 : 64;
  return launch(mlp3d_kernel<BM, D>, B / cb, T6_WARPS * 32, RowTile<BM, D, T6_WARPS>::SMEM, p, s,
                cb, flat);
}

// --------------------------------------------------------- T7 mlp3d_staged


template <int BMW, int D>
__global__ void __launch_bounds__(2 * WG) mlp3d_staged_kernel(const MlpArgs p, int cb, int) {
  using T = RowTile<BMW, D, WG / 32>;
  extern __shared__ __align__(128) unsigned char smem_all[];
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG, warp = tid >> 5;
  unsigned char* smem = smem_all + wg * T::SMEM;  // each warpgroup's own tiles
  bf16* As = reinterpret_cast<bf16*>(smem + T::A_OFF);
  bf16* Xs = reinterpret_cast<bf16*>(smem + T::X_OFF);
  bf16* Hs = reinterpret_cast<bf16*>(smem + T::H_OFF);
  bf16* Ws = reinterpret_cast<bf16*>(smem + T::W_OFF);
  float* scratch = reinterpret_cast<float*>(smem + T::S_OFF) + warp * 256;
  const int wrow = (warp / T::WN) * 16 * T::FM, wn = warp % T::WN;
  const int wcol = wn * (D / T::WN), wcol1 = wn * (HC / T::WN);
  const GroupSync sync{1 + wg};

  // tile i: image i / per_img of the block's cb, rows (i % per_img) * BMW ..
  const int per_img = (p.N + BMW - 1) / BMW, tiles = cb * per_img;
  const int rounds = (tiles + 1) / 2, C = p.Hd / HC;
  const size_t base = (size_t)blockIdx.x * cb * p.N;
  auto first_row = [&](int i) { return base + (size_t)(i / per_img) * p.N + (i % per_img) * BMW; };
  auto valid_rows = [&](int i) { return min(BMW, p.N - (i % per_img) * BMW); };
  auto stage_in = [&](int i) {  // x rows and LN(x) of tile i
    load_rows<D>(p.x + first_row(i) * D, Xs, T::LDS, valid_rows(i), BMW, tid, WG);
    sync();
    ln_tile<D>(Xs, As, T::LDS, BMW, warp, WG / 32, p.ln_s, p.ln_b);
    sync();
  };

  if (wg == 1) pp_pass(PP_BAR);  // warpgroup 0 takes the tensor cores first
  if (wg < tiles) stage_in(wg);
  FragC acc1[T::FM][T::FN1], acc2[T::FM][T::FN];
  // Both warpgroups run rounds * (C + 1) phases (one without a tile passes
  // the turn on), so every wait meets one arrival.
  for (int k = 0; k < rounds; ++k) {
    const int i = 2 * k + wg;
    const bool has = i < tiles;
    zero(acc2);
    for (int c = 0; c <= C; ++c) {
      pp_wait(PP_BAR + wg);
      if (has) {  // tensor cores: fc2 of chunk c-1, fc1 of chunk c
        if (c > 0)
          fc2_chunk<D, T::FM, T::FN, WG>(Hs, T::LDH, p.w2, p.Hd, (c - 1) * HC, Ws, tid, wrow, wcol,
                                         acc2, sync);
        if (c < C)
          fc1_chunk<D, T::FM, T::FN1, WG>(As, T::LDS, p.w1, c * HC, Ws, tid, wrow, wcol1, acc1,
                                          sync);
      }
      if (wg == 0 || k + 1 < rounds || c < C) pp_pass(PP_BAR + 1 - wg);
      if (!has) continue;
      if (c < C) {  // CUDA cores: GELU of chunk c (fc2 reads it after a sync)
        gelu_chunk(acc1, p.b1, c * HC, Hs, T::LDH, scratch, wrow, wcol1);
      } else {  // the tile's output, then the next tile's rows and LN
        residual_out<D>(acc2, p.b2, Xs, T::LDS, p.out + first_row(i) * D, valid_rows(i), scratch,
                        wrow, wcol);
        if (i + 2 < tiles) {
          sync();
          stage_in(i + 2);
        }
      }
    }
  }
}

template <int D>
int mlp3d_staged_d(const MlpArgs& p, int B, int cb, cudaStream_t s) {
  constexpr int BMW = D > 384 ? 16 : 32;
  return launch(mlp3d_staged_kernel<BMW, D>, B / cb, 2 * WG, 2 * RowTile<BMW, D, WG / 32>::SMEM, p,
                s, cb, 0);
}

// ------------------------------------------------------------ T3 mlp_pipe

constexpr int PC = 64;  // hidden columns per T3 chunk
constexpr int T3_WARPS = 8;

// The 16x16 A fragment of mma.m16n8k16 from a row-major bf16 tile: rows
// r0 + g (+8), columns k0 + 2 t4 (+8).
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* t, int ld, int r0, int k0, int g,
                                       int t4) {
  const bf16* p = t + (r0 + g) * ld + k0 + 2 * t4;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

template <int TM, int S, int D>
struct Pipe {
  static constexpr int SR = TM / S;   // rows of a sub-tile
  static constexpr int FM = SR / 16;  // its 16-row MMA tiles
  static constexpr int NT2 = D / 64;  // fc2's 8-column MMA tiles a warp owns (D / 8 columns)
  static constexpr int LDS = D + 8;   // bf16 pitch of the x / LN tile and of the W1 chunk
  static constexpr int LDP = PC + 8;  // bf16 pitch of the W2 chunk and the hidden tiles
  static constexpr int A_OFF = 0;
  static constexpr int W1_OFF = A_OFF + TM * LDS * 2;
  static constexpr int W2_OFF = W1_OFF + PC * LDS * 2;
  static constexpr int H_OFF = W2_OFF + D * LDP * 2;
  static constexpr int SMEM = H_OFF + 2 * SR * LDP * 2;
  static_assert(FM * 16 == SR && SR * S == TM && T3_WARPS * 8 == PC, "T3 tiling");
};

template <int TM, int S, int D>
__global__ void __launch_bounds__(T3_WARPS * 32) mlp_pipe_kernel(const MlpArgs p, int M, int) {
  using P = Pipe<TM, S, D>;
  constexpr int SR = P::SR, FM = P::FM, NT2 = P::NT2, LDS = P::LDS, LDP = P::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + P::A_OFF);
  bf16* W1s = reinterpret_cast<bf16*>(smem + P::W1_OFF);
  bf16* W2s = reinterpret_cast<bf16*>(smem + P::W2_OFF);
  bf16* Hs = reinterpret_cast<bf16*>(smem + P::H_OFF);  // two (SR, PC) tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * TM, C = p.Hd / PC;
  const int n1 = 8 * warp;            // the warp's 8 hidden columns of a chunk (fc1)
  const int n2 = warp * (D / 8);      // its D / 8 output columns (fc2)

  auto load_w1 = [&](int c) {  // W1[c*PC .. c*PC+PC, :] -> W1s
    for (int v = tid; v < PC * D / 8; v += T3_WARPS * 32) {
      const int i = v / (D / 8), k = (v % (D / 8)) * 8;
      cp_async16(W1s + i * LDS + k, p.w1 + (size_t)(c * PC + i) * D + k);
    }
    cp_async_commit();
  };
  auto load_w2 = [&](int c) {  // W2[:, c*PC .. c*PC+PC] -> W2s
    for (int v = tid; v < D * PC / 8; v += T3_WARPS * 32) {
      const int n = v / (PC / 8), k = (v % (PC / 8)) * 8;
      cp_async16(W2s + n * LDP + k, p.w2 + (size_t)n * p.Hd + c * PC + k);
    }
    cp_async_commit();
  };
  // fc1 of sub-tile j on the chunk in W1s: acc = LN(x)[j] . W1s[n1 .. n1+8]^T
  auto fc1 = [&](int j, float (&acc)[FM][4]) {
#pragma unroll
    for (int mt = 0; mt < FM; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      const bf16* bp = W1s + (n1 + g) * LDS + k0 + 2 * t4;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
      for (int mt = 0; mt < FM; ++mt) {
        uint32_t a[4];
        load_a(a, As, LDS, j * SR + mt * 16, k0, g, t4);
        mma_bf16_16816(acc[mt], a, b0, b1);
      }
    }
  };
  // the hidden of sub-tile j, chunk c: bf16(GELU(acc + b1)) -> H
  auto gelu = [&](const float (&acc)[FM][4], int c, bf16* H) {
    const int col = n1 + 2 * t4;
    const float ba = p.b1[c * PC + col], bb = p.b1[c * PC + col + 1];
#pragma unroll
    for (int mt = 0; mt < FM; ++mt) {
      bf16* h = H + (mt * 16 + g) * LDP + col;
      *reinterpret_cast<uint32_t*>(h) = pack_bf16x2(gelu_erf(acc[mt][0] + ba),
                                                    gelu_erf(acc[mt][1] + bb));
      *reinterpret_cast<uint32_t*>(h + 8 * LDP) = pack_bf16x2(gelu_erf(acc[mt][2] + ba),
                                                              gelu_erf(acc[mt][3] + bb));
    }
  };
  // fc2 of one sub-tile on the chunk in W2s: acc += H . W2s[n2 .., :]^T
  auto fc2 = [&](const bf16* H, float (&acc)[FM][NT2][4]) {
#pragma unroll
    for (int k0 = 0; k0 < PC; k0 += 16) {
      uint32_t a[FM][4];
#pragma unroll
      for (int mt = 0; mt < FM; ++mt) load_a(a[mt], H, LDP, mt * 16, k0, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        const bf16* bp = W2s + (n2 + nt * 8 + g) * LDP + k0 + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
        for (int mt = 0; mt < FM; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
  };

  load_w1(0);
  load_w2(0);
  const int rows = min(TM, M - m0);
  load_rows<D>(p.x + (size_t)m0 * D, As, LDS, rows, TM, tid, T3_WARPS * 32);
  __syncthreads();
  ln_tile<D>(As, As, LDS, TM, warp, T3_WARPS, p.ln_s, p.ln_b);

  float acc2[S][FM][NT2][4];
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int mt = 0; mt < FM; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt)
        acc2[j][mt][nt][0] = acc2[j][mt][nt][1] = acc2[j][mt][nt][2] = acc2[j][mt][nt][3] = 0.f;
  float acc1[2][FM][4];
  for (int c = 0; c < C; ++c) {
    cp_async_wait<1>();  // W1 chunk c has landed; W2's may be in flight
    __syncthreads();     // ... for every thread (and LN(x) is whole)
    fc1(0, acc1[0]);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j + 1 < S) fc1(j + 1, acc1[(j + 1) & 1]);  // issued ahead of GELU(j)
      gelu(acc1[j & 1], c, Hs + (j & 1) * SR * LDP);
      if (j == 0) cp_async_wait<0>();  // W2 chunk c
      __syncthreads();                 // H(j) whole, W2 chunk c visible
      if (j == (S > 1 ? S - 2 : 0) && c + 1 < C) load_w1(c + 1);  // all past fc1(S-1)
      fc2(Hs + (j & 1) * SR * LDP, acc2[j]);
    }
    __syncthreads();  // every warp is past fc2 of chunk c
    if (c + 1 < C) load_w2(c + 1);
  }

  // out = x + bf16(acc2 + b2), rows below M only
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int mt = 0; mt < FM; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        const int col = n2 + nt * 8 + 2 * t4;
        const float ba = p.b2[col], bb = p.b2[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + j * SR + mt * 16 + g + 8 * h;
          if (r >= M) continue;
          const size_t off = (size_t)r * D + col;
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + off));
          *reinterpret_cast<uint32_t*>(p.out + off) =
              pack_bf16x2(x.x + round_bf16(acc2[j][mt][nt][2 * h] + ba),
                          x.y + round_bf16(acc2[j][mt][nt][2 * h + 1] + bb));
        }
      }
}

template <int D>
int mlp_pipe_d(const MlpArgs& p, int M, int tm, int splits, cudaStream_t s) {
  const int grid = (M + tm - 1) / tm;
#define MFV_PIPE(TM, S)                                                                       \
  if (tm == TM && splits == S)                                                                \
    return launch(mlp_pipe_kernel<TM, S, D>, grid, T3_WARPS * 32, Pipe<TM, S, D>::SMEM, p, s, M, \
                  0);
  MFV_PIPE(32, 1)
  MFV_PIPE(32, 2)
  if constexpr (D <= 384) {  // the (64, D) fp32 output tile fits the registers
    MFV_PIPE(64, 1)
    MFV_PIPE(64, 2)
    MFV_PIPE(64, 4)
  }
#undef MFV_PIPE
  return (int)cudaErrorInvalidValue;
}

MlpArgs mlp_args(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, int N, int Hd) {
  MlpArgs p;
  p.x = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  p.N = N;
  p.Hd = Hd;
  return p;
}

}  // namespace

// T6's first design, for the card's checks.
MFV_API int mfv_mlp3d_wmma(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, int B,
                           int N, int D, int Hd, int cb, int flat, void* stream) {
  if (B <= 0 || N <= 0 || cb <= 0 || B % cb != 0 || Hd <= 0 || Hd % HC != 0)
    return (int)cudaErrorInvalidValue;
  const MlpArgs p = mlp_args(x, ln_s, ln_b, w1, b1, w2, b2, out, N, Hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return mlp3d_d<128>(p, B, cb, flat, s);
    case 256: return mlp3d_d<256>(p, B, cb, flat, s);
    case 384: return mlp3d_d<384>(p, B, cb, flat, s);
    case 512: return mlp3d_d<512>(p, B, cb, flat, s);
  }
  return (int)cudaErrorInvalidValue;
}

// T7's first design, for the card's checks.
MFV_API int mfv_mlp3d_staged_wmma(const void* x, const void* ln_s, const void* ln_b,
                                  const void* w1, const void* b1, const void* w2, const void* b2,
                                  void* out, int B, int N, int D, int Hd, int cb, void* stream) {
  if (B <= 0 || N <= 0 || cb <= 0 || B % cb != 0 || Hd <= 0 || Hd % HC != 0)
    return (int)cudaErrorInvalidValue;
  const MlpArgs p = mlp_args(x, ln_s, ln_b, w1, b1, w2, b2, out, N, Hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return mlp3d_staged_d<128>(p, B, cb, s);
    case 256: return mlp3d_staged_d<256>(p, B, cb, s);
    case 384: return mlp3d_staged_d<384>(p, B, cb, s);
    case 512: return mlp3d_staged_d<512>(p, B, cb, s);
  }
  return (int)cudaErrorInvalidValue;
}

// T3's first design, for the card's checks.
MFV_API int mfv_mlp_pipe_mma(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* out, int M,
                             int D, int Hd, int tm, int splits, void* stream) {
  if (M <= 0 || Hd <= 0 || Hd % PC != 0) return (int)cudaErrorInvalidValue;
  const MlpArgs p = mlp_args(x, ln_s, ln_b, w1, b1, w2, b2, out, 0, Hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return mlp_pipe_d<128>(p, M, tm, splits, s);
    case 256: return mlp_pipe_d<256>(p, M, tm, splits, s);
    case 384: return mlp_pipe_d<384>(p, M, tm, splits, s);
    case 512: return mlp_pipe_d<512>(p, M, tm, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}
