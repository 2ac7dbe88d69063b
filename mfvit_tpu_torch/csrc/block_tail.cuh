// block_tail: the on-chip back half of a ViT block on the wgmma core of
// gemm_sm90.cuh, shared by K15 (fused_block.cu) and K2 (fused_mlp.cu), and
// the LayerNorm pass that K1, K2 and K15 run on it:
//
//   PROJ (K15): x2  = x + bf16(o . Wproj^T + bproj)
//   K2, K3:     x2  = x
//   K15, K2:    out = x2 + bf16(GELU(LN2(x2) . W1^T + b1) . W2^T + b2)
//   FINAL (K3): out = bf16(LN_final(x2 + GELU(LN2(x2) . W1^T + b1) . W2^T + b2))
//
// tail_kernel is persistent, one block an SM: two consumer warpgroups and a
// producer warpgroup whose one thread issues every TMA load. Each block
// owns 64 full rows of the M tokens at a time:
// - the tile's A rows (K15: the attention output o; K2: x) arrive by TMA
//   into shared memory, the next tile's while the last hidden chunk of this
//   one runs; rows past M load as zeros and are never stored;
// - K15's proj: each consumer warpgroup owns every other 64-column subtile
//   of the D outputs (64 rows x D/2 fp32 accumulators, D/4 registers a
//   thread), wgmma m64n64k16 with the weights streamed through a ring of
//   16 KB stages, each one 128-row TMA box of a 64-wide K slice (64 weight
//   rows for each warpgroup); each thread loads its residual x values into
//   registers under the proj wgmma; x2 = x + bf16(acc + bproj) goes into a
//   (64, D + 8) bf16 tile in shared memory: x2 never goes to device memory.
//   K2 has no proj: its LN2 pass copies the x rows of the A tile into the
//   x2 tile;
// - LN2 over x2, one warp a row (the order of gemm_ln.cuh's
//   ln_stats_kernel), rounded to bf16 into the A tile, in the swizzled
//   layout the wgmma descriptors read;
// - the MLP over the hidden width in chunks of 128: each warpgroup's 64
//   columns of fc1 (32 registers), h = bf16(GELU_erf(acc + b1)) into a
//   (64, 128) swizzled bf16 tile that both warpgroups then read as fc2's
//   A operand, fc2 accumulated across the chunks in the registers of the
//   proj stage: the (M, 4D) hidden never goes to device memory;
// - out = x2 + bf16(acc + b2); or, for K3 (FINAL), o = x2 + acc + b2 kept
//   in fp32 and the model's final LayerNorm (eps 1e-6) taken over each row
//   on chip: the fp32 rows go, 32 at a time, into the x2 tile (free once
//   every thread has read its x2; FINAL_ROWS x (D + 8) fp32 is its size),
//   and one warp a row sums them as gemm_ln.cuh's ln_rows_kernel does
//   (lane-strided, then warp_sum, two passes), so K3 keeps the bits of
//   its former chain, whose fc2 wrote them to device memory.
//
// Rounding points are K1's and K2's (gemm_ln.cuh's epilogues, eps 1e-6,
// exact erff). Every fp32 sum runs over k in ascending k16 steps into one
// accumulator per output (fc2's across the chunks), the order of
// gemm_ln.cuh's K loop, and a wgmma k16 step rounds as mma.sync's does
// (chip_smoke.py's probe), so K15 equals the K1 -> K2 chain and K2 equals
// its WMMA chain (mfv_fused_mlp_block_wmma) bit for bit.
//
// What bounds it on an H100: its GEMMs (K2 at ViT-S B=256: 119 GFLOP, 0.120
// ms at the bf16 peak; bytes 0.012 ms). On chip the weight stream bounds it
// first (ablations on the card, PERF.md: 0.23 ms of K15's 0.44 for its
// Wproj, W1 and W2 alone, each 64-row tile streaming them once), then the
// exact-erf GELU, the epilogues, LN2 and the wgmma, which add to it rather
// than overlap. Taller row tiles would halve the stream per row, but their
// fp32 output tile does not fit the registers of two warpgroups (D/2 a
// thread at 128 rows); for the same reason D > 512 is refused here (K2
// runs three launches there, fused_mlp.cu). ops/fused_mlp.py::_plan sizes
// the ring (stages) from the shared memory the tiles leave; the C side only
// checks it.
//
// The schedule variants T6 and T7 (mlp3d.cu) run K2's tail with two
// template switches; K2, K3 and K15 take neither, so their code is the
// same:
// - RUNS: the row walk restarts at every run of p.run rows (T6 flat: cb
//   images; T6 per image and T7: one image). Tile t starts at row
//   (t / per_run) * run + (t % per_run) * 64 and stores min(64, run -
//   (t % per_run) * 64) rows; the rows past a run's end are loaded (the
//   next image's, or zeros past M by TMA) and computed but never stored.
//   The grid stays persistent over the p.tiles tiles.
// - OVERLAP (T7): fc1 of hidden chunk c + 1 is issued with
//   wgmma.mma_async one K slice at a time, and the GELU of chunk c runs in
//   GELU_PIECES pieces between the slices, each while the slice just
//   issued is in flight (mlp_overlap). Two fc1 accumulators (64
//   registers; D/4 + 64 a thread with fc2's) and two hidden-chunk buffers,
//   so that the GELU of chunk c + 1 never overwrites what fc2 of chunk c
//   reads; one barrier a chunk where K2 takes two. fc1 still sums over k in
//   ascending k16 steps and fc2 over the chunks in ascending order, so T7
//   keeps K2's bits. ops/mlp_variants.py::_plan sizes its ring beside the
//   second buffer. On the card it does not beat K2's loop (PERF.md): the
//   weight stream sets the tail's pace, and past D = 256 the second fc1
//   accumulator's registers spill.
//
// The schedule variant T3 (mlp_pipe.cu) takes a third switch, PIPE; the
// others take PIPE = 0 and keep their code. PIPE 1 and 2 are the taller
// tile that the weight stream asks for: a block owns 128 rows, and each
// consumer warpgroup one 64-row sub-tile of them (one wgmma m64) with all D
// of fc2's output columns (m64n128 accumulators, D / 2 registers a
// thread). Every weight stage is read by both warpgroups, so the weight
// bytes a row halve. The hidden goes in chunks of PIPE_HC = 64 columns:
// fc1 of a chunk takes D / 128 stages of two 64-row boxes of W1 (two K
// slices each), in two 32-column halves on the same stages (16 registers
// each: a 64-column fc1 beside fc2's 192 accumulators spilled at D = 384),
// fc2 D / 128 stages of 128 W2 rows of the chunk's one K slice; each
// warpgroup writes its own (64, 64) hidden tile.
// There is no room for K2's x2 copy beside two A tiles: LN2 runs in place
// on the A tile (a warp holds its row in registers) and the epilogue reads
// the residual x from device memory, the same bf16 values. PIPE 1 runs the
// two warpgroups in lockstep; PIPE 2 ping-pongs them over two named
// barriers (the TPU kernel's "fc1 of sub-tile j + 1 before the GELU of
// sub-tile j"): a warpgroup waits on its own before each wgmma turn (fc2
// of the last chunk and the first half of fc1 of the next; then its second
// half) and arrives on the other's after it, then runs the GELU of the
// half while the other's wgmma runs. A turn's stages must all fit the ring
// (stages >= D / 64), as the other warpgroup reads them only after it. fc1 sums over k in ascending k16 steps and fc2 over
// the hidden in ascending k16 steps, so T3 keeps K2's bits.
// ops/mlp_variants.py::pipe_plan sizes the ring; the C side checks it.
#pragma once

#include "gemm_sm90.cuh"

namespace blk {

using namespace sm90;

constexpr int LN_ROWS = 8;  // rows (warps) a block of ln1_kernel

// y rows = bf16(LN(x rows)), eps 1e-6, one warp a row, the row read once
// into registers (lane l holds columns l*8 + 256*i .. + 7): the statistics
// summed as gemm_ln.cuh's ln_stats_kernel sums them and the row normalised
// as its LN prologue does, so the bf16 values are the same. The grid is
// persistent: each warp walks rows r, r + (its grid's warps), ..., and
// loads the next row while it normalises this one.
template <int D>
__global__ void __launch_bounds__(LN_ROWS * 32)
    ln1_kernel(const bf16* x, const float* g, const float* b, bf16* y, int M) {
  constexpr int NC = (D + 255) / 256;
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * LN_ROWS;
  int r = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  uint4 next[NC];
  auto load = [&](int row) {
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane * 8 + 256 * i < D && row < M)
        next[i] = *reinterpret_cast<const uint4*>(x + (size_t)row * D + lane * 8 + 256 * i);
  };
  load(r);
  for (; r < M; r += step) {
    float f[NC][8];
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane * 8 + 256 * i < D) bf16x8_to_float(next[i], f[i]);
    load(r + step);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane * 8 + 256 * i < D)
#pragma unroll
        for (int j = 0; j < 8; ++j) s += f[i][j];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane * 8 + 256 * i < D)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[i][j] - mean;
          v += d * d;
        }
    v = warp_sum(v) / D;
    const float rstd = 1.0f / sqrtf(v + 1e-6f);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int k = lane * 8 + 256 * i;
      if (k >= D) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) f[i][j] = (f[i][j] - mean) * rstd * g[k + j] + b[k + j];
      *reinterpret_cast<uint4*>(y + (size_t)r * D + k) = float_to_bf16x8(f[i]);
    }
  }
}

// The widths the LayerNorm pass takes: the tail's and ViT-B's.
static bool ln1_takes(int D) {
  return D == 128 || D == 256 || D == 384 || D == 512 || D == 768;
}

static int launch_ln1(const void* x, const void* g, const void* b, void* y, int M, int D,
                      cudaStream_t s) {
  auto kern = D == 128   ? ln1_kernel<128>
              : D == 256 ? ln1_kernel<256>
              : D == 384 ? ln1_kernel<384>
              : D == 512 ? ln1_kernel<512>
              : D == 768 ? ln1_kernel<768>
                         : nullptr;
  if (kern == nullptr || M <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (M + LN_ROWS - 1) / LN_ROWS, sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // persistent: as many blocks as an SM holds at once (8 of 256 threads)
  kern<<<blocks < 8 * sms ? blocks : 8 * sms, LN_ROWS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<bf16*>(y), M);
  return (int)cudaGetLastError();
}

constexpr int TAIL_ROWS = 64, TAIL_THREADS = 384, TAIL_HC = 128;  // HC: hidden chunk
constexpr int STAGE = 2 * TILE64;  // 64 weight rows of one K slice for each warpgroup
constexpr int FINAL_ROWS = 32;     // fp32 rows the x2 tile holds in K3's epilogue
// T7: the pieces a chunk's GELU is cut into, each after one fc1 K slice
// (on an H100 80GB at 700 W, 2 pieces beat 1, 4 and D / 64 at D of
// 256-512: compare_block's overlap_probe, PERF.md)
constexpr int GELU_PIECES = 2;

struct TailParams {
  CUtensorMap a, wproj, w1, w2;  // boxes of 64 rows (a) and 128 rows (weights)
  const bf16* x;                 // K15's residual (K2's x is the A tile)
  const float *bproj, *ln2_s, *ln2_b, *b1, *b2;
  const float *final_s, *final_b;  // K3's final LayerNorm
  bf16* out;
  int M, Hd, stages;
  int run, per_run, tiles;  // RUNS: rows of a run, its 64-row tiles, all tiles
};

// Shared memory after the ring (stages x STAGE): the A tile (the o or x
// rows, then LN2(x2); D / 64 swizzled K slices), the hidden chunk (two
// slices; hb buffers of it, two under OVERLAP), x2 (pitch D + 8), then the
// barriers; 1024 bytes for the alignment.
template <int D>
struct Tail {
  static constexpr int J = D / 128;  // a warpgroup's 64-column subtiles (every other one)
  static constexpr int KD = D / 64;  // 64-wide K slices over D
  static constexpr int LDX = D + 8;
  static constexpr int A_BYTES = KD * TILE64, H_BYTES = 2 * TILE64;
  static constexpr int X_BYTES = TAIL_ROWS * LDX * 2;
  static_assert(FINAL_ROWS * LDX * 4 == X_BYTES, "K3's fp32 rows fill the x2 tile");
  static int smem(int stages, int hb = 1) {
    return stages * STAGE + A_BYTES + hb * H_BYTES + X_BYTES + (2 * stages + 2) * 8 + 1024;
  }
};

// byte offset of 16-byte group g (8 columns) of row r in a swizzled slice
__device__ __forceinline__ int swz(int r, int g) { return r * 128 + ((g ^ (r & 7)) << 4); }

// Four k16 steps of one stage: d += A slice . B tile^T.
__device__ __forceinline__ void mma_slice(float (&d)[32], const void* a, const void* b) {
  const uint64_t da = desc(a), db = desc(b);
  pin(d);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n64(d, da + 2 * kk, db + 2 * kk);
}

// K3's epilogue: o = x2 + acc + b2 in fp32 (gemm_ln.cuh's EPI_F32 order:
// x + acc, then + bias), then out = bf16(LN(o) * final_s + final_b), eps
// 1e-6, over each of the tile's rows from m0. The fp32 rows pass through
// the x2 tile FINAL_ROWS at a time (the rows of consumer warps 0-1, then
// 2-3, of each warpgroup); each of the 8 consumer warps takes every 8th
// row and sums it as ln_rows_kernel does, so the bits are its.
template <int D>
__device__ __forceinline__ void final_ln(float (&acc)[D / 128][32], bf16* X2, const TailParams& p,
                                         int m0, int t128, int warp, int lane) {
  using T = Tail<D>;
  const int c0 = (warp >> 2) * 64;
#pragma unroll
  for (int j = 0; j < T::J; ++j) {
    pin(acc[j]);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = frag_row(t128, h), col = c0 + j * 128 + frag_col(t128, q);
        const float2 x2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(X2 + row * T::LDX + col));
        float& v0 = acc[j][4 * q + 2 * h];
        float& v1 = acc[j][4 * q + 2 * h + 1];
        v0 = x2.x + v0;
        v0 += p.b2[col];
        v1 = x2.y + v1;
        v1 += p.b2[col + 1];
      }
  }
  consumers_sync();  // every x2 read: the tile takes the fp32 rows
  float* O = reinterpret_cast<float*>(X2);
  for (int half = 0; half < TAIL_ROWS / FINAL_ROWS; ++half) {
    if (((warp & 3) >> 1) == half) {
#pragma unroll
      for (int j = 0; j < T::J; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = frag_row(t128, h) - half * FINAL_ROWS;
            const int col = c0 + j * 128 + frag_col(t128, q);
            *reinterpret_cast<float2*>(O + row * T::LDX + col) =
                make_float2(acc[j][4 * q + 2 * h], acc[j][4 * q + 2 * h + 1]);
          }
    }
    consumers_sync();
    for (int r = warp; r < FINAL_ROWS; r += 8) {
      const int grow = m0 + half * FINAL_ROWS + r;
      if (grow >= p.M) break;
      const float* o = O + r * T::LDX;
      float s = 0.f;
      for (int n = lane; n < D; n += 32) s += o[n];
      const float mean = warp_sum(s) / D;
      float v = 0.f;
      for (int n = lane; n < D; n += 32) {
        const float d = o[n] - mean;
        v += d * d;
      }
      const float rstd = 1.0f / sqrtf(warp_sum(v) / D + 1e-6f);
      for (int k = lane * 8; k < D; k += 256) {
        float f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          f[i] = (o[k + i] - mean) * rstd * p.final_s[k + i] + p.final_b[k + i];
        *reinterpret_cast<uint4*>(p.out + (size_t)grow * D + k) = float_to_bf16x8(f);
      }
    }
    consumers_sync();  // the rows read: the next half, or the next tile's x2
  }
}

// The pieces of the GELU of a hidden chunk that T7 runs between fc1's K
// slices: piece g of P takes the accumulator pairs i (= 2q + h) with
// i * P / 16 == g, h = bf16(GELU(a + b1)) into this warpgroup's 64
// columns Hw of a hidden-chunk buffer, as K2's chunk loop writes them.
template <int P>
__device__ __forceinline__ void gelu_piece(const float (&a)[32], unsigned char* Hw,
                                           const float* b1, int g, int t128) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i * P / 16 != g) continue;
    const int q = i >> 1, h = i & 1;
    const int row = frag_row(t128, h), col = frag_col(t128, q);
    const float2 b = *reinterpret_cast<const float2*>(b1 + col);
    const float v0 = gelu_erf(a[4 * q + 2 * h] + b.x);
    const float v1 = gelu_erf(a[4 * q + 2 * h + 1] + b.y);
    *reinterpret_cast<__nv_bfloat162*>(Hw + swz(row, q) + (col % 8) * 2) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// T7's MLP over one tile: fc2's accumulators acc span the chunks, as in
// K2's loop. Chunk c: fc1 of chunk c + 1 goes out one K slice at a time
// into the other fc1 accumulator, and the GELU of chunk c runs in P
// pieces, piece g after slice g * KD / P, into hidden buffer c % 2, while
// that slice is in flight; then one barrier (both warpgroups' halves of
// the buffer whole) and fc2 of chunk c; then a full wait. That wait lets one
// barrier a chunk do: a warpgroup reaches the barrier of chunk c + 1 only
// after fc2 of chunk c, which read the buffer chunk c + 2 takes, has
// completed. It also keeps ptxas from serializing every wgmma (C7514): each
// accumulator the GELU reads was retired by a wait_group 0, which it can
// see; with only the wait_group 1 of the slice before, it cannot. The last
// chunk has no next fc1; `a_empty` is signalled once fc1 of the last chunk
// has completed, as in K2.
template <int D>
__device__ __forceinline__ void mlp_overlap(float (&acc)[D / 128][32], const TailParams& p,
                                            unsigned char* A, unsigned char* H,
                                            const unsigned char* my_half, uint64_t* full,
                                            uint64_t* empty, uint64_t* a_empty, Consumer& c,
                                            int S, int t128, int wg, int lane) {
  using T = Tail<D>;
  constexpr int P = GELU_PIECES < T::KD ? GELU_PIECES : T::KD;  // the GELU's pieces
  const int chunks = p.Hd / TAIL_HC;
  float f0[32], f1[32];
  auto fc1_slice = [&](float (&f)[32], int k) {
    const int s = c.acquire(full);
    mma_slice(f, A + k * TILE64, my_half + s * STAGE);
    c.issued(empty, S);
    pin(f);
  };
  // chunk ch, its fc1 in cur (completed), the next chunk's going into nxt
  auto chunk = [&](float (&cur)[32], float (&nxt)[32], int ch) {
    unsigned char* Hw = H + (ch & 1) * T::H_BYTES + wg * TILE64;
    const float* b1 = p.b1 + ch * TAIL_HC + wg * 64;
    if (ch + 1 < chunks) {
      zero(nxt);
#pragma unroll
      for (int k = 0; k < T::KD; ++k) {
        fc1_slice(nxt, k);
#pragma unroll
        for (int g = 0; g < P; ++g)  // piece g after slice g * KD / P
          if (g * T::KD / P == k) gelu_piece<P>(cur, Hw, b1, g, t128);
      }
    } else {
      if (lane == 0) bar_arrive(a_empty);  // the next A tile may come
#pragma unroll
      for (int g = 0; g < P; ++g) gelu_piece<P>(cur, Hw, b1, g, t128);
    }
    async_fence();
    consumers_sync();  // the chunk's h whole
    const unsigned char* Hb = H + (ch & 1) * T::H_BYTES;
    for (int k = 0; k < TAIL_HC / 64; ++k)
#pragma unroll
      for (int j = 0; j < T::J; ++j) {
        const int s = c.acquire(full);
        mma_slice(acc[j], Hb + k * TILE64, my_half + s * STAGE);
        c.issued(empty, S);
        pin(acc[j]);
      }
    c.drain(empty);
    pin(nxt);
  };
#pragma unroll
  for (int j = 0; j < T::J; ++j) zero(acc[j]);
  zero(f0);
#pragma unroll
  for (int k = 0; k < T::KD; ++k) fc1_slice(f0, k);
  c.drain(empty);
  pin(f0);
  for (int ch = 0; ch < chunks; ch += 2) {
    chunk(f0, f1, ch);
    if (ch + 1 < chunks) chunk(f1, f0, ch + 1);
  }
}

// ---- T3 (PIPE 1, 2): 128-row tiles, one 64-row sub-tile a warpgroup ----

constexpr int PIPE_ROWS = 128, PIPE_HC = 64;
// setmaxnreg under PIPE: a consumer thread holds fc2's D / 2 accumulators
// and fc1's 16 (208 at D = 384); 2 x 128 x 240 + 128 x 24 <= 65,536
constexpr int PIPE_CONSUMER_REGS = 240, PIPE_PRODUCER_REGS = 24;

template <int D>
struct Pipe {
  static constexpr int KD = D / 64;            // 64-wide K slices over D
  static constexpr int NB = D / 128;           // fc2's m64n128 accumulators; fc1's stages a chunk
  static constexpr int A_BYTES = KD * TILE64;  // a sub-tile's A rows
  static_assert(D % 128 == 0 && D <= 384, "fc2's D / 2 accumulators a thread");
  // the ring, two A sub-tiles, two hidden tiles, the barriers, the alignment
  static int smem(int stages) {
    return stages * STAGE + 2 * A_BYTES + 2 * TILE64 + (2 * stages + 2) * 8 + 1024;
  }
};

// the barrier over one consumer warpgroup (5 for warpgroup 0, 6 for 1)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(5 + wg) : "memory");
}

// Four k16 steps of one stage into an m64n128 accumulator.
__device__ __forceinline__ void mma_slice128(float (&d)[64], const void* a, const void* b) {
  const uint64_t da = desc(a), db = desc(b);
  pin(d);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n128(d, da + 2 * kk, db + 2 * kk);
}

// LN2 over a warpgroup's 64-row sub-tile in place, each of its 4 warps a
// row at a time; a lane holds its columns (l * 8 + 256 i ..) in registers
// and sums them in the order of K2's pass, so the bf16 values are K2's.
template <int D>
__device__ __forceinline__ void ln_in_place(unsigned char* Aw, const TailParams& p, int wq,
                                            int lane) {
  constexpr int NC = (D + 255) / 256;
  for (int row = wq; row < TAIL_ROWS; row += 4) {
    uint4 v[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int k = lane * 8 + 256 * i;
      if (k < D)
        v[i] = *reinterpret_cast<const uint4*>(Aw + (k / 64) * TILE64 + swz(row, (k % 64) / 8));
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (lane * 8 + 256 * i >= D) continue;
      float f[8];
      bf16x8_to_float(v[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += f[j];
    }
    const float mean = warp_sum(s) / D;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (lane * 8 + 256 * i >= D) continue;
      float f[8];
      bf16x8_to_float(v[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[j] - mean;
        var += d * d;
      }
    }
    var = warp_sum(var) / D;
    const float rstd = 1.0f / sqrtf(var + 1e-6f);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int k = lane * 8 + 256 * i;
      if (k >= D) continue;
      float f[8];
      bf16x8_to_float(v[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = (f[j] - mean) * rstd * p.ln2_s[k + j] + p.ln2_b[k + j];
      *reinterpret_cast<uint4*>(Aw + (k / 64) * TILE64 + swz(row, (k % 64) / 8)) =
          float_to_bf16x8(f);
    }
  }
}

// T3's producer thread: each tile's two A sub-tiles, then the weight stages
// in the order both warpgroups take them: fc1 of chunk 0, then for each
// chunk c fc2 of chunk c - 1 and fc1 of chunk c, then fc2 of the last.
template <int D>
__device__ __forceinline__ void pipe_producer(const TailParams& p, unsigned char* ring,
                                              unsigned char* A, uint64_t* full, uint64_t* empty,
                                              uint64_t* a_full, uint64_t* a_empty, int tiles) {
  using P = Pipe<D>;
  const int S = p.stages, chunks = p.Hd / PIPE_HC;
  Ring r;
  int a_ph = 0;
  auto open = [&]() {  // the next stage, once both warpgroups are done with it
    bar_wait(empty + r.s, r.ph ^ 1);
    bar_expect(full + r.s, STAGE);
    return ring + r.s * STAGE;
  };
  auto fc1 = [&](int c) {  // two K slices of the chunk's 64 W1 rows a stage
    for (int e = 0; e < P::KD / 2; ++e) {
      unsigned char* st = open();
      tma_load(st, &p.w1, full + r.s, 2 * e * 64, c * PIPE_HC);
      tma_load(st + TILE64, &p.w1, full + r.s, (2 * e + 1) * 64, c * PIPE_HC);
      r.next(S);
    }
  };
  auto fc2 = [&](int c) {  // 128 W2 rows of the chunk's K slice a stage
    for (int n = 0; n < P::NB; ++n) {
      unsigned char* st = open();
      tma_load(st, &p.w2, full + r.s, c * PIPE_HC, n * 128);
      r.next(S);
    }
  };
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    bar_wait(a_empty, a_ph ^ 1);
    bar_expect(a_full, 2 * P::A_BYTES);
    for (int h = 0; h < 2; ++h)
      for (int k = 0; k < P::KD; ++k)
        tma_load(A + h * P::A_BYTES + k * TILE64, &p.a, a_full, k * 64,
                 t * PIPE_ROWS + h * TAIL_ROWS);
    a_ph ^= 1;
    fc1(0);
    for (int c = 1; c < chunks; ++c) {
      fc2(c - 1);
      fc1(c);
    }
    fc2(chunks - 1);
  }
}

// D[64 x 32] += A[64 x 16] . B[32 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Four k16 steps of one K slice into an m64n32 accumulator: fc1's half
// chunk, B rows 0-31 or 32-63 of a 64-row box (the half at 32 x 128 bytes
// on keeps the swizzle's phase).
__device__ __forceinline__ void mma_slice32(float (&d)[16], const void* a, const void* b) {
  const uint64_t da = desc(a), db = desc(b);
  pin(d);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n32(d, da + 2 * kk, db + 2 * kk);
}

// h = bf16(GELU(acc1 + b1)) of half `half` (32 columns) of hidden chunk ch
// into a warpgroup's (64, 64) hidden tile, as K2's chunk loop writes it.
// (Unrolled: ptxas interleaves the exact-erf evaluations and spills a few
// of their constants at D = 384; one pair an iteration of a loop that was
// not unrolled spilled less and ran 28 % slower, PERF.md.)
__device__ __forceinline__ void pipe_gelu(const float (&a)[16], unsigned char* Hw,
                                          const float* b1, int ch, int half, int t128) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = frag_row(t128, h), col = frag_col(t128, q);
      const int hc = ch * PIPE_HC + half * 32 + col;
      const float v0 = gelu_erf(a[4 * q + 2 * h] + b1[hc]);
      const float v1 = gelu_erf(a[4 * q + 2 * h + 1] + b1[hc + 1]);
      *reinterpret_cast<__nv_bfloat162*>(Hw + swz(row, half * 4 + q) + (col % 8) * 2) =
          __floats2bfloat162_rn(v0, v1);
    }
}

// T3's consumer warpgroup wg: rows 64 wg .. of each 128-row tile. fc1 of a
// chunk runs in two 32-column halves on the same W1 stages (16 registers
// each, so that fc2's D / 2 accumulators and fc1's fit setmaxnreg's 240
// at D = 384), each half's GELU after it. Turn A of chunk ch: fc2 of chunk
// ch - 1, then the first half of fc1 of chunk ch; turn B: its second half,
// after which its W1 stages go back. Under PP each turn is taken from the
// other warpgroup and handed back, and the GELUs run beside its wgmma.
template <int D, bool PP>
__device__ __forceinline__ void pipe_consumer(const TailParams& p, unsigned char* ring,
                                              unsigned char* A, unsigned char* H, uint64_t* full,
                                              uint64_t* empty, uint64_t* a_full, uint64_t* a_empty,
                                              int tiles, int wg, int t128) {
  using P = Pipe<D>;
  constexpr int HALF = 32 * 128;  // bytes of 32 rows of a swizzled box
  const int S = p.stages, chunks = p.Hd / PIPE_HC;
  const int lane = t128 & 31;
  unsigned char* Aw = A + wg * P::A_BYTES;
  unsigned char* Hw = H + wg * TILE64;
  Consumer c;
  int a_ph = 0;
  if (PP && wg == 1) pp_pass(PP_BAR);  // warpgroup 0 takes the tensor cores first
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t * PIPE_ROWS + wg * TAIL_ROWS;
    const bool last_tile = t + gridDim.x >= tiles;
    bar_wait(a_full, a_ph);
    a_ph ^= 1;
    ln_in_place<D>(Aw, p, t128 >> 5, lane);
    async_fence();
    wg_sync(wg);  // LN2(x) whole in the sub-tile

    float acc[P::NB][64];
#pragma unroll
    for (int n = 0; n < P::NB; ++n) zero(acc[n]);
    int w1[P::KD / 2];  // the ring stages of this chunk's W1, held for both halves
    for (int ch = 0; ch <= chunks; ++ch) {
      float acc1[16];
      if (PP) pp_wait(PP_BAR + wg);  // turn A
      if (ch > 0)
#pragma unroll
        for (int n = 0; n < P::NB; ++n) {
          const int s = c.acquire(full);
          mma_slice128(acc[n], Hw, ring + s * STAGE);
          c.issued(empty, S);
          pin(acc[n]);
        }
      if (ch < chunks) {
        zero(acc1);
#pragma unroll
        for (int e = 0; e < P::KD / 2; ++e) {
          w1[e] = c.acquire(full);
          const unsigned char* st = ring + w1[e] * STAGE;
          mma_slice32(acc1, Aw + 2 * e * TILE64, st);
          mma_slice32(acc1, Aw + (2 * e + 1) * TILE64, st + TILE64);
          c.r.next(S);
        }
        wg_commit();
      }
      // the other warpgroup's turn; warpgroup 1's last turn hands it to no one
      if (PP && !(wg == 1 && ch == chunks && last_tile)) pp_pass(PP_BAR + (wg ^ 1));
      c.drain(empty);  // fc2's stages go back; W1's stay for the second half
      if (ch == chunks) break;
      pin(acc1);
      pipe_gelu(acc1, Hw, p.b1, ch, 0, t128);  // fc2 of the last chunk is done with Hw

      if (PP) pp_wait(PP_BAR + wg);  // turn B
      zero(acc1);
      wg_fence();
#pragma unroll
      for (int e = 0; e < P::KD / 2; ++e) {
        const unsigned char* st = ring + w1[e] * STAGE + HALF;
        mma_slice32(acc1, Aw + 2 * e * TILE64, st);
        mma_slice32(acc1, Aw + (2 * e + 1) * TILE64, st + TILE64);
      }
      wg_commit();
      if (PP) pp_pass(PP_BAR + (wg ^ 1));
      wg_wait<0>();
      if (lane == 0) {
#pragma unroll
        for (int e = 0; e < P::KD / 2; ++e) bar_arrive(empty + w1[e]);  // both halves done
        if (ch == chunks - 1) bar_arrive(a_empty);  // the next A tile may come
      }
      pin(acc1);
      pipe_gelu(acc1, Hw, p.b1, ch, 1, t128);
      async_fence();
      wg_sync(wg);  // the chunk's h whole
    }

    // out = x + bf16(acc + b2), x from device memory (8 pairs of columns at
    // a time, all loaded before the first store), rows below M
#pragma unroll
    for (int n = 0; n < P::NB; ++n) {
      pin(acc[n]);
#pragma unroll
      for (int q0 = 0; q0 < 16; q0 += 8) {
        uint32_t xres[8][2];
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + frag_row(t128, h), col = n * 128 + frag_col(t128, q0 + q);
            xres[q][h] = row < p.M
                             ? *reinterpret_cast<const uint32_t*>(p.x + (size_t)row * D + col)
                             : 0u;
          }
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + frag_row(t128, h), col = n * 128 + frag_col(t128, q0 + q);
            if (row >= p.M) continue;
            const float2 x =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xres[q][h]));
            const float v0 = x.x + round_bf16(acc[n][4 * (q0 + q) + 2 * h] + p.b2[col]);
            const float v1 = x.y + round_bf16(acc[n][4 * (q0 + q) + 2 * h + 1] + p.b2[col + 1]);
            *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)row * D + col) =
                __floats2bfloat162_rn(v0, v1);
          }
      }
    }
  }
}

template <int D, bool PROJ, bool FINAL, bool RUNS = false, bool OVERLAP = false, int PIPE = 0>
__global__ void __launch_bounds__(TAIL_THREADS, 1) tail_kernel(const __grid_constant__ TailParams p) {
  static_assert(!(PROJ && FINAL), "K3 has no proj stage");
  static_assert(!((RUNS || OVERLAP) && (PROJ || FINAL)), "T6 and T7 are K2's tail");
  static_assert(!(PIPE && (PROJ || FINAL || RUNS || OVERLAP)), "T3 is K2's tail");
  if constexpr (PIPE) {
    using P = Pipe<D>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = align1024(smem_raw);
    const int S = p.stages;
    unsigned char* A = ring + S * STAGE;
    unsigned char* H = A + 2 * P::A_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(H + 2 * TILE64);
    uint64_t* empty = full + S;
    uint64_t* a_full = empty + S;
    uint64_t* a_empty = a_full + 1;
    const int tid = threadIdx.x, wg = tid >> 7;
    const int tiles = (p.M + PIPE_ROWS - 1) / PIPE_ROWS;
    if (tid == 0) {
      for (int s = 0; s < S; ++s) {
        bar_init(full + s, 1);
        bar_init(empty + s, 8);  // one arrival a consumer warp: both warpgroups read a stage
      }
      bar_init(a_full, 1);
      bar_init(a_empty, 8);
      bar_init_done();
    }
    __syncthreads();
    if (wg == 2) {
      reg_dealloc<PIPE_PRODUCER_REGS>();
      if (tid == 256) pipe_producer<D>(p, ring, A, full, empty, a_full, a_empty, tiles);
    } else {
      reg_alloc<PIPE_CONSUMER_REGS>();
      pipe_consumer<D, PIPE == 2>(p, ring, A, H, full, empty, a_full, a_empty, tiles, wg,
                                  tid & 127);
    }
    return;
  }
  using T = Tail<D>;
  constexpr int HB = OVERLAP ? 2 : 1;  // hidden-chunk buffers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int S = p.stages;
  unsigned char* A = ring + S * STAGE;
  unsigned char* H = A + T::A_BYTES;
  bf16* X2 = reinterpret_cast<bf16*>(H + HB * T::H_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(H + HB * T::H_BYTES + T::X_BYTES);
  uint64_t* empty = full + S;
  uint64_t* a_full = empty + S;
  uint64_t* a_empty = a_full + 1;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles = RUNS ? p.tiles : (p.M + TAIL_ROWS - 1) / TAIL_ROWS;
  const int chunks = p.Hd / TAIL_HC;
  // RUNS: the first row of tile t, and the rows it stores
  auto first_row = [&](int t) {
    return RUNS ? (t / p.per_run) * p.run + (t % p.per_run) * TAIL_ROWS : t * TAIL_ROWS;
  };
  auto stored_rows = [&](int t) {
    return RUNS ? min(TAIL_ROWS, p.run - (t % p.per_run) * TAIL_ROWS) : TAIL_ROWS;
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);  // one arrival a consumer warp
    }
    bar_init(a_full, 1);
    bar_init(a_empty, 8);
    bar_init_done();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: the A tile, then every weight stage in order
    reg_dealloc<PRODUCER_REGS>();
    if (tid != 256) return;
    Ring r;
    int a_ph = 0;
    // a stage: 128 weight rows from `row` of one 64-wide K slice at `col`,
    // the first 64 for warpgroup 0, the next for warpgroup 1
    auto put = [&](const CUtensorMap* m, int row, int col) {
      bar_wait(empty + r.s, r.ph ^ 1);
      bar_expect(full + r.s, STAGE);
      tma_load(ring + r.s * STAGE, m, full + r.s, col, row);
      r.next(S);
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      bar_wait(a_empty, a_ph ^ 1);
      bar_expect(a_full, T::A_BYTES);
      for (int k = 0; k < T::KD; ++k) tma_load(A + k * TILE64, &p.a, a_full, k * 64, first_row(t));
      a_ph ^= 1;
      if (PROJ)
        for (int k = 0; k < T::KD; ++k)
          for (int j = 0; j < T::J; ++j) put(&p.wproj, j * 128, k * 64);
      auto fc1 = [&](int c) {
        for (int k = 0; k < T::KD; ++k) put(&p.w1, c * TAIL_HC, k * 64);
      };
      auto fc2 = [&](int c) {
        for (int k = 0; k < TAIL_HC / 64; ++k)
          for (int j = 0; j < T::J; ++j) put(&p.w2, j * 128, c * TAIL_HC + k * 64);
      };
      if (OVERLAP) {  // T7's order: fc1 of chunk c + 1 before fc2 of chunk c
        fc1(0);
        for (int c = 0; c < chunks; ++c) {
          if (c + 1 < chunks) fc1(c + 1);
          fc2(c);
        }
      } else {
        for (int c = 0; c < chunks; ++c) {
          fc1(c);
          fc2(c);
        }
      }
    }
    return;
  }

  // two consumer warpgroups: warpgroup wg owns the 64-column subtiles 2j + wg
  // of the D output columns
  reg_alloc<CONSUMER_REGS>();
  const int t128 = tid & 127, warp = tid >> 5, lane = tid & 31, c0 = wg * 64;
  const unsigned char* my_half = ring + wg * TILE64;  // this warpgroup's rows of a stage
  Consumer c;
  int a_ph = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = first_row(t), rows = stored_rows(t);
    float acc[T::J][32];

    if constexpr (PROJ) {
#pragma unroll
      for (int j = 0; j < T::J; ++j) zero(acc[j]);
      // the residual x at this thread's accumulator pairs, loaded now so
      // the loads run under the proj wgmma
      uint32_t xres[T::J][16];
#pragma unroll
      for (int j = 0; j < T::J; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = frag_row(t128, h), col = c0 + j * 128 + frag_col(t128, q);
            xres[j][2 * q + h] =
                m0 + row < p.M
                    ? *reinterpret_cast<const uint32_t*>(p.x + (size_t)(m0 + row) * D + col)
                    : 0u;
          }

      // proj: acc = o . Wproj^T
      bar_wait(a_full, a_ph);
      a_ph ^= 1;
      for (int k = 0; k < T::KD; ++k)
#pragma unroll
        for (int j = 0; j < T::J; ++j) {
          const int s = c.acquire(full);
          mma_slice(acc[j], A + k * TILE64, my_half + s * STAGE);
          c.issued(empty, S);
          pin(acc[j]);
        }
      c.drain(empty);
      consumers_sync();  // both warpgroups have read the last tile's x2
#pragma unroll
      for (int j = 0; j < T::J; ++j) {
        pin(acc[j]);
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // x2 = x + bf16(acc + bproj)
            const int row = frag_row(t128, h), col = c0 + j * 128 + frag_col(t128, q);
            const float2 x =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xres[j][2 * q + h]));
            const float v0 = x.x + round_bf16(acc[j][4 * q + 2 * h] + p.bproj[col]);
            const float v1 = x.y + round_bf16(acc[j][4 * q + 2 * h + 1] + p.bproj[col + 1]);
            *reinterpret_cast<__nv_bfloat162*>(X2 + row * T::LDX + col) =
                __floats2bfloat162_rn(v0, v1);
          }
      }
      consumers_sync();  // x2 whole; the o rows no longer needed
    } else {
      bar_wait(a_full, a_ph);  // the x rows
      a_ph ^= 1;
      consumers_sync();  // both warpgroups have read the last tile's x2
    }

    // LN2(x2) over the A rows, one warp a row, as ln_tile (mlp_tail.cuh);
    // K2 reads x2 from the A tile and copies it into the x2 tile
    for (int row = warp; row < TAIL_ROWS; row += 8) {
      const bf16* xr = X2 + row * T::LDX;
      auto load = [&](int k) {  // x2 columns k .. k + 7
        const void* at = PROJ ? static_cast<const void*>(xr + k)
                              : A + (k / 64) * TILE64 + swz(row, (k % 64) / 8);
        return *reinterpret_cast<const uint4*>(at);
      };
      float s = 0.f;
      for (int k = lane * 8; k < D; k += 256) {
        const uint4 v = load(k);
        if (!PROJ) *reinterpret_cast<uint4*>(X2 + row * T::LDX + k) = v;
        float f[8];
        bf16x8_to_float(v, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) s += f[i];
      }
      const float mean = warp_sum(s) / D;
      float var = 0.f;
      for (int k = lane * 8; k < D; k += 256) {
        float f[8];
        bf16x8_to_float(load(k), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = f[i] - mean;
          var += d * d;
        }
      }
      var = warp_sum(var) / D;
      const float rstd = 1.0f / sqrtf(var + 1e-6f);
      for (int k = lane * 8; k < D; k += 256) {
        float f[8];
        bf16x8_to_float(load(k), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = (f[i] - mean) * rstd * p.ln2_s[k + i] + p.ln2_b[k + i];
        *reinterpret_cast<uint4*>(A + (k / 64) * TILE64 + swz(row, (k % 64) / 8)) =
            float_to_bf16x8(f);
      }
    }
    async_fence();
    consumers_sync();

    if constexpr (OVERLAP) {
      mlp_overlap<D>(acc, p, A, H, my_half, full, empty, a_empty, c, S, t128, wg, lane);
    } else {
      // the MLP, a hidden chunk at a time; fc2's accumulators span the chunks
#pragma unroll
      for (int j = 0; j < T::J; ++j) zero(acc[j]);
      for (int ch = 0; ch < chunks; ++ch) {
        float acc1[32];
        zero(acc1);
        for (int k = 0; k < T::KD; ++k) {
          const int s = c.acquire(full);
          mma_slice(acc1, A + k * TILE64, my_half + s * STAGE);
          c.issued(empty, S);
          pin(acc1);
        }
        c.drain(empty);
        pin(acc1);
        if (ch == chunks - 1 && lane == 0) bar_arrive(a_empty);  // the next A tile may come
        consumers_sync();  // both warpgroups are done with the last chunk's h
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // h = bf16(GELU(acc1 + b1))
            const int row = frag_row(t128, h), col = frag_col(t128, q);
            const int hc = ch * TAIL_HC + wg * 64 + col;
            const float v0 = gelu_erf(acc1[4 * q + 2 * h] + p.b1[hc]);
            const float v1 = gelu_erf(acc1[4 * q + 2 * h + 1] + p.b1[hc + 1]);
            *reinterpret_cast<__nv_bfloat162*>(H + wg * TILE64 + swz(row, q) + (col % 8) * 2) =
                __floats2bfloat162_rn(v0, v1);
          }
        async_fence();
        consumers_sync();  // the chunk's h whole
        for (int k = 0; k < TAIL_HC / 64; ++k)
#pragma unroll
          for (int j = 0; j < T::J; ++j) {
            const int s = c.acquire(full);
            mma_slice(acc[j], H + k * TILE64, my_half + s * STAGE);
            c.issued(empty, S);
            pin(acc[j]);
          }
      }
      c.drain(empty);
    }

    if constexpr (FINAL) {
      final_ln<D>(acc, X2, p, m0, t128, warp, lane);
      continue;
    }
    // out = x2 + bf16(acc + b2)
#pragma unroll
    for (int j = 0; j < T::J; ++j) {
      pin(acc[j]);
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = frag_row(t128, h), col = c0 + j * 128 + frag_col(t128, q);
          if (RUNS ? row >= rows : m0 + row >= p.M) continue;
          const float2 x2 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(X2 + row * T::LDX + col));
          const float v0 = x2.x + round_bf16(acc[j][4 * q + 2 * h] + p.b2[col]);
          const float v1 = x2.y + round_bf16(acc[j][4 * q + 2 * h + 1] + p.b2[col + 1]);
          *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)(m0 + row) * D + col) =
              __floats2bfloat162_rn(v0, v1);
        }
    }
  }
}

// The tail on stream s; `a` holds the A rows (K15's o, K2's x), `wproj` is
// read only with PROJ. RUNS: p.run and p.tiles as the caller's walk gives
// them (ops/mlp_variants.py::row_walk), checked here.
template <int D, bool PROJ, bool FINAL, bool RUNS = false, bool OVERLAP = false, int PIPE = 0>
int launch_tail(TailParams& p, const void* a, const void* wproj, const void* w1, const void* w2,
                cudaStream_t s) {
  int smem;
  if constexpr (PIPE) {
    // PIPE 2: a warpgroup's phase (D / 128 stages of fc2, D / 128 of fc1)
    // must fit the ring before the other warpgroup reads its stages
    smem = Pipe<D>::smem(p.stages);
    if (p.Hd % PIPE_HC || (PIPE == 2 && p.stages < D / 64) || p.x == nullptr)
      return (int)cudaErrorInvalidValue;
  } else {
    smem = Tail<D>::smem(p.stages, OVERLAP ? 2 : 1);
    if (p.Hd % TAIL_HC) return (int)cudaErrorInvalidValue;
  }
  if (p.M <= 0 || p.Hd <= 0 || p.stages < 2 || smem > 232448 ||
      (FINAL && (p.final_s == nullptr || p.final_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (RUNS) {
    if (p.run <= 0 || p.M % p.run) return (int)cudaErrorInvalidValue;
    p.per_run = (p.run + TAIL_ROWS - 1) / TAIL_ROWS;
    if (p.tiles != p.M / p.run * p.per_run) return (int)cudaErrorInvalidValue;
  }
  if (int e = tensor_map(&p.a, a, p.M, D, 64)) return e;
  if (PROJ)
    if (int e = tensor_map(&p.wproj, wproj, D, D, 128)) return e;
  // PIPE: W1 in boxes of 64 rows (one hidden chunk), two a stage
  if (int e = tensor_map(&p.w1, w1, p.Hd, D, PIPE ? 64 : 128)) return e;
  if (int e = tensor_map(&p.w2, w2, D, p.Hd, 128)) return e;
  auto kern = tail_kernel<D, PROJ, FINAL, RUNS, OVERLAP, PIPE>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = PIPE ? PIPE_ROWS : TAIL_ROWS, sms = sm_count();
  const int tiles = RUNS ? p.tiles : (p.M + rows - 1) / rows;
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  kern<<<tiles < sms ? tiles : sms, TAIL_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// The tail at a width it takes (128, 256, 384 or 512), else
// cudaErrorInvalidValue; FINAL: K3's epilogue.
template <bool PROJ, bool FINAL = false>
int launch_tail_d(TailParams& p, int D, const void* a, const void* wproj, const void* w1,
                  const void* w2, cudaStream_t s) {
  switch (D) {
    case 128: return launch_tail<128, PROJ, FINAL>(p, a, wproj, w1, w2, s);
    case 256: return launch_tail<256, PROJ, FINAL>(p, a, wproj, w1, w2, s);
    case 384: return launch_tail<384, PROJ, FINAL>(p, a, wproj, w1, w2, s);
    case 512: return launch_tail<512, PROJ, FINAL>(p, a, wproj, w1, w2, s);
  }
  return (int)cudaErrorInvalidValue;
}

// T6 (OVERLAP false) and T7 (true): K2's tail over the run walk.
template <bool OVERLAP>
int launch_runs_d(TailParams& p, int D, const void* x, const void* w1, const void* w2,
                  cudaStream_t s) {
  switch (D) {
    case 128: return launch_tail<128, false, false, true, OVERLAP>(p, x, nullptr, w1, w2, s);
    case 256: return launch_tail<256, false, false, true, OVERLAP>(p, x, nullptr, w1, w2, s);
    case 384: return launch_tail<384, false, false, true, OVERLAP>(p, x, nullptr, w1, w2, s);
    case 512: return launch_tail<512, false, false, true, OVERLAP>(p, x, nullptr, w1, w2, s);
  }
  return (int)cudaErrorInvalidValue;
}

// T3 over 128-row tiles: PIPE 1 (lockstep) or 2 (ping-pong) at a width it
// takes (128, 256 or 384), else cudaErrorInvalidValue.
template <int PIPE>
int launch_pipe_d(TailParams& p, int D, const void* x, const void* w1, const void* w2,
                  cudaStream_t s) {
  switch (D) {
    case 128: return launch_tail<128, false, false, false, false, PIPE>(p, x, nullptr, w1, w2, s);
    case 256: return launch_tail<256, false, false, false, false, PIPE>(p, x, nullptr, w1, w2, s);
    case 384: return launch_tail<384, false, false, false, false, PIPE>(p, x, nullptr, w1, w2, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace blk
