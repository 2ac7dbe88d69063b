// mlp_tail: the on-chip MLP stage of the MLP schedule variants T6 and T7
// (mlp_variants.cu), on the WMMA core of gemm_ln.cuh:
//
//   out rows = x + bf16(GELU_erf(LN(x) . W1^T + b1) . W2^T + b2)
//
// over a tile of full rows held in shared memory: LN statistics from the
// tile (one warp per row, in the order of gemm_ln.cuh's ln_stats_kernel),
// LN(x) rounded to bf16, then the hidden width in chunks of HC = 128: h =
// bf16(GELU(LN(x) . W1[chunk]^T + b1[chunk])) into a (rows, 128) bf16
// tile, then acc += h . W2[:, chunk]^T into fp32 accumulators that hold
// the whole output tile in registers across the chunks.
//
// The weights stream through shared memory in K slices of BK = 32, the
// next slice held in registers while the current one is multiplied (WMMA
// 16x16x16). Every fp32 sum walks k in gemm_ln.cuh's order (steps of 16
// from k = 0, one accumulator per output, no split-K), and the epilogues
// round as gemm_ln's, so a tile equals the K2 kernel bit for bit.
//
// The threads that share a tile are a template parameter with the barrier
// that joins them: the whole block (__syncthreads) or one warpgroup of 128
// threads (a named barrier), as T7's two warpgroups each own a tile.
#pragma once

#include "gemm_ln.cuh"

constexpr int HC = 128;  // hidden columns per MLP chunk

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// A tile of BM full rows shared by WARPS warps, laid out WM x WN over
// each (BM, cols) output: a warp owns FM 16-row fragments (two where the
// tile has 32 rows or more) and cols / WN columns. Shared memory, in bytes
// (each offset a multiple of 32, as WMMA needs): the LN rows, the residual
// rows, the hidden chunk, the weight slice and one 16x16 fp32 scratch tile
// per warp.
template <int BM, int D, int WARPS>
struct RowTile {
  static constexpr int FM = BM >= 32 ? 2 : 1;
  static constexpr int WM = BM / (16 * FM);
  static constexpr int WN = WARPS / WM;
  static constexpr int FN = D / 16 / WN;    // fragments a warp holds across D
  static constexpr int FN1 = HC / 16 / WN;  // across one hidden chunk
  static constexpr int LDS = D + 8;         // bf16 pitch of the (BM, D) tiles
  static constexpr int LDH = HC + 8;        // bf16 pitch of the hidden tile
  static constexpr int NW = D > HC ? D : HC;  // most weight rows staged at once
  static constexpr int A_OFF = 0;
  static constexpr int X_OFF = A_OFF + BM * LDS * 2;
  static constexpr int H_OFF = X_OFF + BM * LDS * 2;
  static constexpr int W_OFF = H_OFF + BM * LDH * 2;
  static constexpr int S_OFF = W_OFF + NW * LDA * 2;
  static constexpr int SMEM = round_up(S_OFF + WARPS * 256 * 4, 128);
  static_assert(WM * 16 * FM == BM && FN * 16 * WN == D && FN1 * 16 * WN == HC, "warp tiling");
};

// rows x D bf16 from src (row pitch D, nrows of them valid) into a shared
// tile of pitch ld, zeros past nrows.
template <int D>
__device__ __forceinline__ void load_rows(const bf16* src, bf16* dst, int ld, int nrows, int rows,
                                          int tid, int threads) {
  for (int g = tid; g < rows * D / 8; g += threads) {
    const int i = g / (D / 8), c = (g % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + i * ld + c) =
        i < nrows ? *reinterpret_cast<const uint4*>(src + (size_t)i * D + c)
                  : make_uint4(0, 0, 0, 0);
  }
}

// The barrier over the threads of a tile.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct GroupSync {  // one warpgroup, named barrier `id` (0 is __syncthreads')
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
  }
};

// acc[FM][FN] += As[wrow .. wrow+16*FM, 0:K] . W[wcol .. wcol+16*FN, 0:K]^T:
// As in shared memory (bf16 pitch lda); the NR rows of W (row pitch ldw)
// streamed through Ws in K slices of BK by the THREADS threads of the
// tile (tid is the thread's index among them). The k steps of each
// accumulator run in gemm_ln.cuh's order.
template <int NR, int FM, int FN, int THREADS, class Sync>
__device__ __forceinline__ void smem_gemm(const bf16* As, int lda, const bf16* __restrict__ W,
                                          int ldw, int K, bf16* Ws, int tid, int wrow, int wcol,
                                          FragC (&acc)[FM][FN], Sync sync) {
  constexpr int BV = NR * (BK / 8) / THREADS;  // 16-byte vectors per thread
  static_assert(BV * THREADS == NR * (BK / 8), "W slice split");
  uint4 br[BV];
  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * THREADS;
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      br[v] = *reinterpret_cast<const uint4*>(W + (size_t)i * ldw + k0 + kc);
    }
  };
  const int KT = K / BK;
  load(0);
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * THREADS;
      const int i = idx / (BK / 8), kc = (idx % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(Ws + i * LDA + kc) = br[v];
    }
    sync();
    if (kt + 1 < KT) load((kt + 1) * BK);  // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA af[FM];
      FragB bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wrow + i * 16) * lda + kt * BK + kk, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], Ws + (wcol + j * 16) * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    sync();  // Ws is rewritten next
  }
}

template <int FM, int FN>
__device__ __forceinline__ void zero(FragC (&acc)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
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

// dst rows = bf16(LN(src rows)) with eps 1e-6, one warp per row (rows
// warp, warp + nwarps, ...); the statistics are summed as gemm_ln.cuh's
// ln_stats_kernel sums them. dst may be src.
template <int D>
__device__ __forceinline__ void ln_tile(const bf16* src, bf16* dst, int ld, int rows, int warp,
                                        int nwarps, const float* g, const float* b) {
  const int lane = threadIdx.x & 31;
  for (int row = warp; row < rows; row += nwarps) {
    const bf16* xr = src + row * ld;
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
      for (int j = 0; j < 8; ++j) f[j] = (f[j] - mean) * rstd * g[k + j] + b[k + j];
      *reinterpret_cast<uint4*>(dst + row * ld + k) = float_to_bf16x8(f);
    }
  }
}

// fc1 of one hidden chunk c0 .. c0+HC: acc1 = As . W1[c0 .. c0+HC]^T.
template <int D, int FM, int FN1, int THREADS, class Sync>
__device__ __forceinline__ void fc1_chunk(const bf16* As, int lds, const bf16* w1, int c0,
                                          bf16* Ws, int tid, int wrow, int wcol1,
                                          FragC (&acc1)[FM][FN1], Sync sync) {
  zero(acc1);
  smem_gemm<HC, FM, FN1, THREADS>(As, lds, w1 + (size_t)c0 * D, D, D, Ws, tid, wrow, wcol1, acc1,
                                  sync);
}

// Hs (bf16, pitch ldh) = GELU_erf(acc1 + b1[c0 ..]), the warp's fragments.
template <int FM, int FN1>
__device__ __forceinline__ void gelu_chunk(const FragC (&acc1)[FM][FN1], const float* b1, int c0,
                                           bf16* Hs, int ldh, float* scratch, int wrow,
                                           int wcol1) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN1; ++j)
      frag_epilogue(acc1[i][j], scratch, [&](int rr, int cc, float* v) {
        const int row = wrow + i * 16 + rr, col = wcol1 + j * 16 + cc;
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] += b1[c0 + col + t];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = gelu_erf(v[t]);
        *reinterpret_cast<uint4*>(Hs + row * ldh + col) = float_to_bf16x8(v);
      });
}

// fc2 of one hidden chunk: acc2 += Hs . W2[:, c0 .. c0+HC]^T.
template <int D, int FM, int FN, int THREADS, class Sync>
__device__ __forceinline__ void fc2_chunk(const bf16* Hs, int ldh, const bf16* w2, int Hd, int c0,
                                          bf16* Ws, int tid, int wrow, int wcol,
                                          FragC (&acc2)[FM][FN], Sync sync) {
  smem_gemm<D, FM, FN, THREADS>(Hs, ldh, w2 + c0, Hd, HC, Ws, tid, wrow, wcol, acc2, sync);
}

// The whole hidden width, chunk by chunk: acc2 = GELU(As . W1^T + b1) . W2^T.
template <int D, int FM, int FN, int FN1, int THREADS, class Sync>
__device__ __forceinline__ void mlp_chunks(const bf16* As, int lds, bf16* Hs, int ldh, bf16* Ws,
                                           float* scratch, const bf16* w1, const float* b1,
                                           const bf16* w2, int Hd, int tid, int wrow, int wcol,
                                           int wcol1, FragC (&acc2)[FM][FN], Sync sync) {
  zero(acc2);
  for (int c0 = 0; c0 < Hd; c0 += HC) {
    FragC acc1[FM][FN1];
    fc1_chunk<D, FM, FN1, THREADS>(As, lds, w1, c0, Ws, tid, wrow, wcol1, acc1, sync);
    gelu_chunk(acc1, b1, c0, Hs, ldh, scratch, wrow, wcol1);
    sync();
    fc2_chunk<D, FM, FN, THREADS>(Hs, ldh, w2, Hd, c0, Ws, tid, wrow, wcol, acc2, sync);
  }
}

// out rows (< nrows) = res + bf16(acc2 + b2): res the tile's bf16 residual
// rows in shared memory (pitch lds), out the rows' first element in device
// memory (row pitch D).
template <int D, int FM, int FN>
__device__ __forceinline__ void residual_out(const FragC (&acc2)[FM][FN], const float* b2,
                                             const bf16* res, int lds, bf16* out, int nrows,
                                             float* scratch, int wrow, int wcol) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      frag_epilogue(acc2[i][j], scratch, [&](int rr, int cc, float* v) {
        const int row = wrow + i * 16 + rr, col = wcol + j * 16 + cc;
        if (row >= nrows) return;
        float x[8];
        bf16x8_to_float(*reinterpret_cast<const uint4*>(res + row * lds + col), x);
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] += b2[col + t];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = x[t] + round_bf16(v[t]);
        *reinterpret_cast<uint4*>(out + (size_t)row * D + col) = float_to_bf16x8(v);
      });
}
