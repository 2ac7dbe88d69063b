// gemm_i8_sm90: the int8 path of the wgmma core (gemm_sm90.cuh) for K11
// and K10 (mfvit_tpu/ops/fused_int8.py::fused_mlp_block_i8, Pallas
// _mlp_kernel_i8 :100, and fused_attention_block_i8, _attn_kernel_i8 :168;
// fused_int8.cu):
//
//   i8_tail_kernel  one launch at D of 128-384: x + fc2(GELU(fc1(LN(x))))
//                   with int8 fc1 and fc2, the hidden kept on chip as int8
//                   codes;
//   gemm_s8_kernel  C[M, N] = epilogue(A[M, K] . W[N, K]^T), A and W int8,
//                   the core of K11's four launches (fc1 with the
//                   GELU into fp32 h1, fc2 with the residual) and of K10's
//                   five (qkv, proj with the residual);
//   gemm_qa_kernel  the same product with A's rows quantized on chip (LN
//                   and quantization of x for K10's qkv, quantization of
//                   the fp32 attention output for its proj): K10's three
//                   launches.
//
// The products run on wgmma.mma_async m64nNk32 .s32.s8.s8 with both
// operands K-major, the only form 8-bit wgmma takes, and the layout the
// operands already have: activations (M, K) and weights in the torch
// Linear layout (out, in). A TMA box of 128 int8 along K fills a row of the
// 128-byte swizzle, so a k32 step starts 32 bytes into each row: the byte
// strides and descriptors of gemm_sm90.cuh's bf16 k16 step (desc, start
// address + 2 a step). The tensor maps take the bytes as UINT8; the wgmma
// reads them as s8. int32 sums of int8 products are exact in any order
// (|sum| <= 127^2 * K < 2^31 for K < 133,000), so every int32 output equals
// gemm_i8.cuh's mma.sync sum, and the epilogues are its functions
// (epi_value, resid_i8, quant_row, amax_scale, quant_code): K11 equals its
// former chain (fused_int8.cu's mfv_fused_mlp_block_i8_mma) bit for bit.
//
// The tail, per 64-row tile of the M tokens, in block_tail.cuh's idiom (a
// producer thread streaming 16 KB weight stages, one 128-row TMA box of a
// 128-byte K slice, into an mbarrier ring; two consumer warpgroups, each
// taking 64 rows of every stage):
// - LN of x in fp32 and the row absmax quantization, one warp a row
//   (quant_row, as quant_rows_kernel<true> runs it), into an int8 A tile
//   in shared memory (D / 128 swizzled K slices) and its row scales, by
//   the producer warpgroup's three other warps, a tile ahead of the
//   consumers (two A tiles, handed over by mbarriers);
// - fc1 pass A: the int8 GEMM over fc1's chunks of 128 hidden columns (each
//   warpgroup 64), the dequantizing epilogue and the GELU in fp32, keeping
//   only each row's running absmax (then the two warpgroups' maxima
//   through shared memory: the row's scale);
// - fc1 pass B: the same chunks again (the same int32 sums, so the same
//   values), each quantized with the now-known row scale into an int8
//   chunk in shared memory, which both warpgroups then read as fc2's A
//   operand: fc2's int32 sums accumulate across the chunks in registers
//   (each warpgroup every other 64-column subtile of the D outputs);
// - out = x + bf16(fc2 dequantized + b2), x read again from device memory.
// No fp32 h1, no codes and no scales reach device memory.
//
// What bounds it on an H100: K11's int8 operations (at ViT-S B=256: 119
// GOP, 0.060 ms at 1,979 TOP/s; the tail itself does 179, fc1 twice). On the
// card (PERF.md, ablations at B=256) the weight stream from L2 (1.77 MB a
// tile: W1 twice and W2) with each chunk's wgmma waited in turn takes
// about 0.30 ms, pass B's GELU and IEEE division for every code about
// 0.19 and pass A's remaining epilogue the rest: one instruction stream a
// warpgroup alternates between them, so they add rather than overlap.
// I8Tail<D> sizes the ring (ops/fused_int8.py::_plan copies it).
// D > 384 is refused here: fc2's accumulators take D / 4 registers a thread,
// and at D = 512 (128 of 168) the tail spilled and ran slower than the four
// launches at every M timed (PERF.md).
#pragma once

#include "block_tail.cuh"
#include "gemm_i8.cuh"

namespace i8sm90 {

using namespace sm90;
using blk::swz;
using blk::TAIL_THREADS;

// The map of a row-major (rows, cols) int8 matrix, boxes of `box_rows` rows
// of 128 columns in the 128-byte swizzle; rows past `rows` load as zeros.
static int tensor_map_i8(CUtensorMap* m, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void zero(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0;
}

// D[64 x 64] (+)= A[64 x 32] . B[64 x 32]^T, int8, A and B K-major in shared
// memory; `acc` 0: D = the product (D's registers are not read)
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 128] += A[64 x 32] . B[128 x 32]^T, int8, both K-major
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Four k32 steps of one 128-byte K slice: d += A slice . B tile^T, or, with
// `acc` 0, d = A slice . B tile^T. No other instruction touches d between
// the wgmma of one group (the caller pins d before its wgmma.fence and
// after its wait), or ptxas serializes every wgmma of the kernel.
__device__ __forceinline__ void mma_slice_i8(int (&d)[32], const void* a, const void* b, int acc) {
  const uint64_t da = desc(a), db = desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_s8_n64(d, da + 2 * kk, db + 2 * kk, kk ? 1 : acc);
}

// ---- the tail ----

constexpr int I8T_ROWS = 64, I8T_HC = 128;  // rows a tile, hidden columns a chunk
constexpr int I8T_STAGE = 2 * TILE64;       // 128 weight rows of one 128-byte K slice
// the ring's depth where pass B needs fewer: deeper rings left less L1 to
// the epilogues' scale and bias loads and ran slower on the H100 (PERF.md:
// 0.77 ms at 6 stages, 0.82 at 12)
constexpr int I8T_STAGES_PREF = 6;
// the rows from which K11 takes the tail: two waves of 64-row tiles on an
// H100's 132 SMs. With fewer the four launches were as fast or faster, a
// wave of the tail taking a tile's latency (PERF.md; tools/i8_routes.py
// times both routes)
constexpr int I8T_TAIL_ROWS = 16896;
// the producer warpgroup: one thread issues the weight stages, warps 1-3 (the
// LN warps) take the LayerNorm and quantization of the next tiles' rows
// (at PRODUCER_REGS registers a thread, the budget beside two consumer
// warpgroups at CONSUMER_REGS)
constexpr int I8T_LN_WARPS = 3;

struct I8TailParams {
  CUtensorMap w1, w2;  // int8 boxes of 128 rows x 128 bytes
  const bf16* x;
  const float *ln_s, *ln_b, *w1s, *b1, *w2s, *b2;
  bf16* out;
  int M, Hd, stages;  // stages: I8Tail<D>::STAGES, set by launch_tail
};

// Shared memory after the ring (stages x I8T_STAGE): two A tiles, the int8
// codes of LN(x) of two tiles (each D / 128 swizzled K slices of 64 rows:
// the LN warps fill one while the consumers read the other), one hidden
// chunk's codes (one slice), the two A tiles' row scales (2 x 64 fp32),
// each warpgroup's h1 row absmax (2 x 64 fp32), then the barriers (the
// ring's, and each A tile's full and empty); 1024 bytes for the alignment.
// Pass B holds a chunk's fc1 stages and the last chunk's fc2 stages at
// once, so the ring needs 2 D / 128 stages at least: STAGES_MIN where
// that is more than I8T_STAGES_PREF.
template <int D>
struct I8Tail {
  static constexpr int J = D / 128;   // a warpgroup's 64-column output subtiles (every other one)
  static constexpr int KD = D / 128;  // 128-byte K slices over D
  static constexpr int A_BYTES = KD * TILE64, H_BYTES = TILE64, S_BYTES = 4 * I8T_ROWS * 4;
  static constexpr int STAGES_MIN = KD + J;
  static constexpr int STAGES = STAGES_MIN > I8T_STAGES_PREF ? STAGES_MIN : I8T_STAGES_PREF;
  static constexpr int SMEM =
      STAGES * I8T_STAGE + 2 * A_BYTES + H_BYTES + S_BYTES + (2 * STAGES + 4) * 8 + 1024;
  static_assert(SMEM <= 232448, "the tail's shared memory exceeds an H100 block's");
};

template <int D>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
    i8_tail_kernel(const __grid_constant__ I8TailParams p) {
  using T = I8Tail<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  // the depth as a run-time value: as a constant it left ptxas spilling
  // more (156 bytes against 104 at D=384)
  const int S = p.stages;
  unsigned char* A = ring + S * I8T_STAGE;
  unsigned char* H = A + 2 * T::A_BYTES;
  float* hs = reinterpret_cast<float*>(H + T::H_BYTES);  // [2][64]: the A tiles' row scales
  float* amx = hs + 2 * I8T_ROWS;                        // [2][64]: h1 row absmax a warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(amx + 2 * I8T_ROWS);
  uint64_t* empty = full + S;
  uint64_t* a_full = empty + S;  // [2]: an A tile written (one arrival an LN warp)
  uint64_t* a_empty = a_full + 2;  // [2]: an A tile read (one arrival a consumer warp)
  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles = (p.M + I8T_ROWS - 1) / I8T_ROWS, chunks = p.Hd / I8T_HC;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);  // one arrival a consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      bar_init(a_full + b, I8T_LN_WARPS);
      bar_init(a_empty + b, 8);
    }
    bar_init_done();
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  if (wg == 2) reg_dealloc<PRODUCER_REGS>();  // the whole warpgroup at once
  if (wg == 2 && warp > 8) {  // the LN warps: tile i's rows into A tile i % 2
    int i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
      const int b = i & 1, m0 = t * I8T_ROWS;
      unsigned char* Ab = A + b * T::A_BYTES;
      bar_wait(a_empty + b, ((i >> 1) & 1) ^ 1);  // tile i - 2 done with it
      // LN(x) quantized, one warp a row (rows past M: zeros)
      for (int row = warp - 9; row < I8T_ROWS; row += I8T_LN_WARPS) {
        auto at = [&](int k) { return Ab + (k / 128) * TILE64 + swz(row, (k % 128) / 16) + k % 16; };
        const bf16* xr = p.x + (size_t)(m0 + row) * D;
        float sc = 1.f;
        if (m0 + row < p.M)
          sc = quant_row<true, bf16>(
              [&](int k, float* f) { RowVec<bf16>::load(xr + k, f); }, p.ln_s, p.ln_b, D, lane,
              [&](int k, const int* cd) {
                *reinterpret_cast<uint2*>(at(k)) = make_uint2(pack_s8x4(cd), pack_s8x4(cd + 4));
              });
        else
          for (int k = lane * 8; k < D; k += 256) *reinterpret_cast<uint2*>(at(k)) = make_uint2(0, 0);
        if (lane == 0) hs[b * I8T_ROWS + row] = sc;
      }
      async_fence();  // the codes visible to the consumers' wgmma
      __syncwarp();
      if (lane == 0) bar_arrive(a_full + b);
    }
    return;
  }
  if (wg == 2) {  // the producer: every weight stage in the consumers' order
    if (tid != 256) return;
    Ring r;
    // a stage: 128 weight rows from `row` of one 128-byte K slice at `col`,
    // the first 64 for warpgroup 0, the next for warpgroup 1
    auto put = [&](const CUtensorMap* m, int row, int col) {
      bar_wait(empty + r.s, r.ph ^ 1);
      bar_expect(full + r.s, I8T_STAGE);
      tma_load(ring + r.s * I8T_STAGE, m, full + r.s, col, row);
      r.next(S);
    };
    auto w1 = [&](int c) {  // fc1's chunk c
      for (int k = 0; k < T::KD; ++k) put(&p.w1, c * I8T_HC, k * 128);
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      for (int c = 0; c < chunks; ++c) w1(c);  // pass A
      w1(0);                                   // pass B: chunk c + 1's fc1, then c's fc2
      for (int c = 0; c < chunks; ++c) {
        if (c + 1 < chunks) w1(c + 1);
        for (int j = 0; j < T::J; ++j) put(&p.w2, j * 128, c * I8T_HC);
      }
    }
    return;
  }

  // two consumer warpgroups: warpgroup wg owns the 64 hidden columns wg of
  // each chunk, and the 64-column subtiles 2j + wg of the D outputs
  reg_alloc<CONSUMER_REGS>();
  const int t128 = tid & 127, c0 = wg * 64;
  const int r0 = frag_row(t128, 0), r1 = frag_row(t128, 1);  // this thread's rows
  const unsigned char* Ab = A;  // this tile's A tile
  const unsigned char* my_half = ring + wg * TILE64;  // this warpgroup's rows of a stage
  Ring r;  // the consumers' walk over the ring, the producer's order
  // wait for the next n stages, noting them in st
  auto take = [&](int* st, int n) {
    for (int i = 0; i < n; ++i) {
      bar_wait(full + r.s, r.ph);
      st[i] = r.s;
      r.next(S);
    }
  };
  // hand back stages whose wgmma this warpgroup has completed (one arrival
  // a warp)
  auto give = [&](const int* st, int n) {
    if (lane == 0)
      for (int i = 0; i < n; ++i) bar_arrive(empty + st[i]);
  };
  // one chunk of fc1, acc = codes(LN(x)) . W1[chunk rows]^T, issued as one
  // wgmma group over its KD stages (the first k32 step sets acc)
  auto fc1 = [&](int (&acc)[32], int (&st)[T::KD]) {
    take(st, T::KD);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int k = 0; k < T::KD; ++k)
      mma_slice_i8(acc, Ab + k * TILE64, my_half + st[k] * I8T_STAGE, k > 0);
    wg_commit();
    pin(acc);
  };
  int a0[32], a1[32], s0[T::KD], s1[T::KD];  // fc1's two chunks in flight
  int i = 0;  // the tile's place in the block's walk
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int m0 = t * I8T_ROWS, b = i & 1;
    Ab = A + b * T::A_BYTES;
    bar_wait(a_full + b, (i >> 1) & 1);  // the LN warps' codes of this tile
    const float rs0 = hs[b * I8T_ROWS + r0], rs1 = hs[b * I8T_ROWS + r1];

    // pass A: each row's absmax of h1 = GELU(v), v = fc1 dequantized + b1
    // (epi_value<I8_GELU_F32> is gelu_i8 of epi_value<I8_RESID>), over this
    // warpgroup's columns; the next chunk's wgmma runs under this one's
    // epilogue. The GELU is taken only where it can set the max: with M the
    // row's running max of v over the chunks so far (this one included,
    // shared by the quad), on every v while M < 0.5, else on v >= M (1 -
    // 1e-4). Exact: GELU rises for v > -0.75 and stays above -0.17 below,
    // so once M >= 0.5 (GELU(M) >= 0.346) a v under M (1 - 1e-4) has
    // |GELU(v)| below GELU(M) by at least 5e-5 of it, far beyond gelu_i8's
    // rounding (under 1e-6 of it); M itself is taken in its chunk, and a v
    // passed over in an earlier chunk lies under this one's bound too.
    // Taking the GELU of every v under a guard cost as much as taking it
    // everywhere (the compiler predicates it), so a thread takes it once a
    // row, of its own max, unless a row holds more than one such value.
    float am0 = 0.f, am1 = 0.f, mx0 = -INFINITY, mx1 = -INFINITY;
    auto pass_a = [&](int (&cur)[32], int (&cs)[T::KD], int (&nxt)[32], int (&ns)[T::KD], int ch) {
      wg_wait<0>();
      pin(cur);
      give(cs, T::KD);
      if (ch + 1 < chunks) fc1(nxt, ns);
      float v[8][4], lm0 = -INFINITY, lm1 = -INFINITY;  // lm: this thread's chunk max a row
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int hc = ch * I8T_HC + c0 + frag_col(t128, q);
        const float ws0 = p.w1s[hc], ws1 = p.w1s[hc + 1], b0 = p.b1[hc], b1 = p.b1[hc + 1];
        v[q][0] = epi_value<I8_RESID>(cur[4 * q], rs0, ws0, b0);
        v[q][1] = epi_value<I8_RESID>(cur[4 * q + 1], rs0, ws1, b1);
        v[q][2] = epi_value<I8_RESID>(cur[4 * q + 2], rs1, ws0, b0);
        v[q][3] = epi_value<I8_RESID>(cur[4 * q + 3], rs1, ws1, b1);
        lm0 = fmaxf(lm0, fmaxf(v[q][0], v[q][1]));
        lm1 = fmaxf(lm1, fmaxf(v[q][2], v[q][3]));
      }
      mx0 = fmaxf(mx0, lm0);
      mx1 = fmaxf(mx1, lm1);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the quad shares a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float th0 = mx0 < 0.5f ? -INFINITY : mx0 * 0.9999f;
      const float th1 = mx1 < 0.5f ? -INFINITY : mx1 * 0.9999f;
      int n0 = 0, n1 = 0;  // this thread's values at or above the bound, a row
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        n0 += (v[q][0] >= th0) + (v[q][1] >= th0);
        n1 += (v[q][2] >= th1) + (v[q][3] >= th1);
      }
      // one such value is the thread's max; more (a near tie, or M < 0.5)
      // take the GELU of each, in a branch the warp rarely enters
      const float g0 = fabsf(gelu_i8(lm0)), g1 = fabsf(gelu_i8(lm1));
      if (n0 == 1) am0 = fmaxf(am0, g0);
      if (n1 == 1) am1 = fmaxf(am1, g1);
      if (__any_sync(0xffffffffu, n0 > 1 || n1 > 1)) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if ((e < 2 ? n0 : n1) > 1 && v[q][e] >= (e < 2 ? th0 : th1)) {
              float& am = e < 2 ? am0 : am1;
              am = fmaxf(am, fabsf(gelu_i8(v[q][e])));
            }
      }
    };
    fc1(a0, s0);
    for (int ch = 0; ch < chunks; ch += 2) {
      pass_a(a0, s0, a1, s1, ch);
      if (ch + 1 < chunks) pass_a(a1, s1, a0, s0, ch + 1);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the quad shares a row
      am0 = fmaxf(am0, __shfl_xor_sync(0xffffffffu, am0, off));
      am1 = fmaxf(am1, __shfl_xor_sync(0xffffffffu, am1, off));
    }
    if ((lane & 3) == 0) {
      amx[wg * I8T_ROWS + r0] = am0;
      amx[wg * I8T_ROWS + r1] = am1;
    }
    consumers_sync();  // both warpgroups' maxima
    const float sc0 = amax_scale(fmaxf(amx[r0], amx[I8T_ROWS + r0]));
    const float sc1 = amax_scale(fmaxf(amx[r1], amx[I8T_ROWS + r1]));

    // pass B: the chunks again, their codes, and fc2 over them; the weight
    // stages of chunk c + 1's fc1 and of chunk c's fc2 arrive under chunk
    // c's codes, and chunk c + 1's fc1 runs under their hand-over. (An
    // accumulator read after wgmma.wait_group 1, which would let chunk c's
    // codes run under chunk c - 1's fc2, makes ptxas serialize every wgmma
    // of the kernel: C7514.)
    int acc[T::J][32], s2[T::J];  // fc2's sums over the chunks (set by chunk 0's)
    auto pass_b = [&](int (&cur)[32], int (&cs)[T::KD], int (&nxt)[32], int (&ns)[T::KD], int ch) {
      wg_wait<0>();  // this chunk's fc1 and the last chunk's fc2
      pin(cur);
#pragma unroll
      for (int j = 0; j < T::J; ++j) pin(acc[j]);
      give(cs, T::KD);
      if (ch > 0) give(s2, T::J);
      uint32_t code[8][2];  // the codes of columns col, col + 1 of rows r0, r1
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int hc = ch * I8T_HC + c0 + frag_col(t128, q);
        const float ws0 = p.w1s[hc], ws1 = p.w1s[hc + 1], b0 = p.b1[hc], b1 = p.b1[hc + 1];
        const int e0 = quant_code(epi_value<I8_GELU_F32>(cur[4 * q], rs0, ws0, b0), sc0);
        const int e1 = quant_code(epi_value<I8_GELU_F32>(cur[4 * q + 1], rs0, ws1, b1), sc0);
        const int e2 = quant_code(epi_value<I8_GELU_F32>(cur[4 * q + 2], rs1, ws0, b0), sc1);
        const int e3 = quant_code(epi_value<I8_GELU_F32>(cur[4 * q + 3], rs1, ws1, b1), sc1);
        code[q][0] = (e0 & 0xff) | ((e1 & 0xff) << 8);
        code[q][1] = (e2 & 0xff) | ((e3 & 0xff) << 8);
      }
      if (ch + 1 < chunks) fc1(nxt, ns);
      consumers_sync();  // both warpgroups are done with the last chunk's codes
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = c0 + frag_col(t128, q);
        *reinterpret_cast<uint16_t*>(H + swz(r0, col / 16) + col % 16) = (uint16_t)code[q][0];
        *reinterpret_cast<uint16_t*>(H + swz(r1, col / 16) + col % 16) = (uint16_t)code[q][1];
      }
      async_fence();
      consumers_sync();  // the chunk's codes whole
      take(s2, T::J);
#pragma unroll
      for (int j = 0; j < T::J; ++j) pin(acc[j]);
      wg_fence();
#pragma unroll
      for (int j = 0; j < T::J; ++j) mma_slice_i8(acc[j], H, my_half + s2[j] * I8T_STAGE, ch > 0);
      wg_commit();
#pragma unroll
      for (int j = 0; j < T::J; ++j) pin(acc[j]);
    };
    fc1(a0, s0);
    for (int ch = 0; ch < chunks; ch += 2) {
      pass_b(a0, s0, a1, s1, ch);
      if (ch + 1 < chunks) pass_b(a1, s1, a0, s0, ch + 1);
    }
    wg_wait<0>();
    give(s2, T::J);
    if (lane == 0) bar_arrive(a_empty + b);  // every fc1 of this tile done: the A tile is free

    // out = x + bf16(fc2 dequantized + b2)
#pragma unroll
    for (int j = 0; j < T::J; ++j) {
      pin(acc[j]);
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = h ? r1 : r0, col = c0 + j * 128 + frag_col(t128, q);
          if (m0 + row >= p.M) continue;
          const float rs = h ? sc1 : sc0;
          const size_t off = (size_t)(m0 + row) * D + col;
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + off));
          const float v0 = epi_value<I8_RESID>(acc[j][4 * q + 2 * h], rs, p.w2s[col], p.b2[col]);
          const float v1 =
              epi_value<I8_RESID>(acc[j][4 * q + 2 * h + 1], rs, p.w2s[col + 1], p.b2[col + 1]);
          *reinterpret_cast<uint32_t*>(p.out + off) = pack_bf16x2(resid_i8(x.x, v0), resid_i8(x.y, v1));
        }
    }
  }
}

template <int D>
int launch_tail(I8TailParams& p, const void* w1, const void* w2, cudaStream_t s) {
  constexpr int smem = I8Tail<D>::SMEM;
  if (p.M <= 0 || p.Hd <= 0 || p.Hd % I8T_HC) return (int)cudaErrorInvalidValue;
  p.stages = I8Tail<D>::STAGES;
  if (int e = tensor_map_i8(&p.w1, w1, p.Hd, D, 128)) return e;
  if (int e = tensor_map_i8(&p.w2, w2, D, p.Hd, 128)) return e;
  auto kern = i8_tail_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (p.M + I8T_ROWS - 1) / I8T_ROWS, sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  kern<<<tiles < sms ? tiles : sms, TAIL_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// The tail at a width it takes (128, 256 or 384), else
// cudaErrorInvalidValue.
static int launch_tail_d(I8TailParams& p, int D, const void* w1, const void* w2, cudaStream_t s) {
  switch (D) {
    case 128: return launch_tail<128>(p, w1, w2, s);
    case 256: return launch_tail<256>(p, w1, w2, s);
    case 384: return launch_tail<384>(p, w1, w2, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the GEMM core (K11's four launches) ----

// gemm_sm90.cuh's gemm_kernel with int8 operands: tiles of 128 x 128
// outputs, a stage the A and W boxes of one 128-byte K slice (32 KB), a
// persistent grid walking the tiles in row-major order, the two consumer
// warpgroups ping-ponging whole tiles (two m64n128 int32 accumulators) and
// taking the ring in turns; gemm_i8.cuh's epilogues (epi_i8).
struct GemmI8Sm90Params {
  CUtensorMap a, w;  // boxes of 128 rows x 128 bytes
  GemmI8Args e;      // the scales, bias, residual and output (its a and w unused)
};

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_s8_kernel(const __grid_constant__ GemmI8Sm90Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + GEMM_STAGES * GEMM_STAGE);
  uint64_t* empty = full + GEMM_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int M = p.e.M, nt = p.e.N / GEMM_BN, tiles = (M + GEMM_BM - 1) / GEMM_BM * nt;
  const int KT = p.e.K / 128;
  if (tid == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 4);  // one arrival a warp of the tile's warpgroup
    }
    bar_init_done();
  }
  __syncthreads();
  if (wg == 2) {  // the producer warpgroup: one thread issues every copy
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 256) {
      Ring r;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / nt * GEMM_BM, n0 = t % nt * GEMM_BN;
        for (int kt = 0; kt < KT; ++kt) {
          bar_wait(empty + r.s, r.ph ^ 1);
          unsigned char* st = sm + r.s * GEMM_STAGE;
          bar_expect(full + r.s, GEMM_STAGE);
          tma_load(st, &p.a, full + r.s, kt * 128, m0);
          tma_load(st + GEMM_BM * 128, &p.w, full + r.s, kt * 128, n0);
          r.next(GEMM_STAGES);
        }
      }
    }
  } else {  // consumer warpgroup wg: the block's tiles wg, wg + 2, ...
    reg_alloc<CONSUMER_REGS>();
    const int t128 = tid & 127;
    Consumer c;
    int i = wg;  // the tile's place in the block's walk: its first stage is i * KT
    for (int t = blockIdx.x + wg * gridDim.x; t < tiles; t += 2 * gridDim.x, i += 2) {
      const int m0 = t / nt * GEMM_BM, n0 = t % nt * GEMM_BN;
      c.r.s = i * KT % GEMM_STAGES;
      c.r.ph = i * KT / GEMM_STAGES & 1;
      int acc[2][64];
      zero(acc[0]);
      zero(acc[1]);
      if (i > 0) pp_wait(PP_BAR + wg);  // the ring in turns, as gemm_sm90.cuh's gemm_kernel
      for (int kt = 0; kt < KT; ++kt) {
        const unsigned char* st = sm + c.acquire(full) * GEMM_STAGE;
        const uint64_t da0 = desc(st), da1 = desc(st + TILE64), db = desc(st + GEMM_BM * 128);
        pin(acc[0]);
        pin(acc[1]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_s8_n128(acc[0], da0 + 2 * kk, db + 2 * kk);
          wgmma_s8_n128(acc[1], da1 + 2 * kk, db + 2 * kk);
        }
        c.issued(empty, GEMM_STAGES);
        pin(acc[0]);
        pin(acc[1]);
      }
      if (t + gridDim.x < tiles) pp_pass(PP_BAR + (wg ^ 1));  // the next tile's turn
      c.drain(empty);
#pragma unroll
      for (int hm = 0; hm < 2; ++hm) {
        pin(acc[hm]);
#pragma unroll
        for (int q = 0; q < 16; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + hm * 64 + frag_row(t128, h), col = n0 + frag_col(t128, q);
            if (row < M) epi_i8<EPI>(p.e, row, col, acc[hm][4 * q + 2 * h], acc[hm][4 * q + 2 * h + 1]);
          }
      }
    }
  }
}

// gemm_i8.cuh's gemm_i8 on the wgmma core: the same arguments and
// epilogues; takes N % 128 == 0, K % 128 == 0.
template <int EPI>
static int gemm_i8(const GemmI8Args& a, cudaStream_t s) {
  if (a.M <= 0 || a.N <= 0 || a.N % GEMM_BN || a.K <= 0 || a.K % 128 ||
      (EPI == I8_RESID && a.resid == nullptr))
    return (int)cudaErrorInvalidValue;
  GemmI8Sm90Params p;
  if (int e = tensor_map_i8(&p.a, a.a, a.M, a.K, GEMM_BM)) return e;
  if (int e = tensor_map_i8(&p.w, a.w, a.N, a.K, GEMM_BN)) return e;
  p.e = a;
  const int tiles = (a.M + GEMM_BM - 1) / GEMM_BM * (a.N / GEMM_BN), sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  auto kern = gemm_s8_kernel<EPI>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<tiles < sms ? tiles : sms, GEMM_THREADS, GEMM_SMEM, s>>>(p);
  return (int)cudaGetLastError();
}


// ---- the quantizing GEMM (K10's qkv and proj) ----

// C[M, N] = epilogue(quant(A)[M, K] . W[N, K]^T) with A's rows quantized on
// chip: bf16 x with its LayerNorm (K10's qkv, I8_QKV) or the fp32
// attention output (K10's proj, I8_RESID), each row by quant_row<LN, T>,
// as quant_rows_kernel quantizes it, so the codes and scales are its bits
// and every output is gemm_i8's. No int8 rows and no scales reach device
// memory.
//
// A block of four warpgroups walks items, each one tile of BM = 64 HM rows
// and a group of `per` consecutive 128-column output tiles; an item's rows
// are quantized into an A tile in shared memory (K / 128 swizzled K slices
// of HM 64-row halves) and its row scales, two A tiles handed over by
// mbarriers. A row's quantization is a chain of IEEE divisions
// (quant_code) and warp reductions, one warp a row, that takes a warp
// microseconds on the H100 (PERF.md), more than a tile's share of the GEMM,
// so every warp but the TMA thread's quantizes: seven LN warps (the
// producer warpgroup's three and a fourth warpgroup) an item ahead, and the
// eight consumer warps before their own tiles of an item. They claim an
// item's rows one at a time from a counter a tile (a claim past the item's
// rows is the next round's, which the warp keeps for it); the A tile is
// whole when all its rows and every quantizing warp have arrived. The
// LayerNorm's vectors, W's scales and the bias are read from shared
// memory. One thread streams W's 128-row boxes of a 128-byte K slice by TMA
// into the ring. The two consumer warpgroups ping-pong whole BM x 128
// output tiles (HM m64n128 int32 accumulators) and take the ring in turns,
// as gemm_s8_kernel; epi_i8's functions with the row scales from shared
// memory.
//
// The split into groups: at few rows (13 tiles of 128 at vit_small B=8)
// one item a row tile would leave most SMs idle, so the N tiles are cut
// into groups (qa_plan) until the items fill the SMs, each group's block
// quantizing its rows again.
//
// What bounds it on an H100: at vit_small B=256 the qkv GEMM's 44.6 GOP
// take 0.023 ms at 1,979 TOP/s and its bytes (x read, qkv written) 0.046
// at 3.35 TB/s; the row quantization on the CUDA cores, which every warp
// of the block shares with the epilogues, sets the pace (PERF.md).
constexpr int QA_STAGES_MAX = 8;  // ring stages where the shared memory allows more
constexpr int QA_HM2_MAX_K = 512;  // 128-row tiles up to this depth, else 64
// four warpgroups: at launch 128 registers a thread; the LN warpgroups give
// theirs down to QA_LN_REGS, the two consumer warpgroups take them up to
// QA_CONSUMER_REGS (2 x 128 x 200 + 2 x 128 x 56 = 65,536)
constexpr int QA_THREADS = 512, QA_CONSUMER_REGS = 200, QA_LN_REGS = 56;
constexpr int QA_LN_WARPS = 7, QA_QUANT_WARPS = QA_LN_WARPS + 8;

// The launch of one quantizing GEMM (ops/fused_int8.py::_qa_plan copies
// it), with the LayerNorm (`ln`) or without: hm 64-row halves a tile, ring
// stages, column-tile groups and the shared memory a block takes (the
// ring, two A tiles, LN's vectors, W's scales and the bias, the A tiles'
// row scales, the barriers and row counters, 1024 bytes to align); stages
// < 2: the shape does not fit.
struct QaPlan {
  int hm, stages, groups, per, smem;
};
static QaPlan qa_plan(int M, int N, int K, int sms, bool ln) {
  QaPlan q;
  q.hm = K <= QA_HM2_MAX_K ? 2 : 1;
  const int bm = 64 * q.hm;
  const int fixed = 2 * bm * K + (ln ? 8 * K : 0) + 8 * N + 2 * bm * 4 + 5 * 8 + 1024;
  q.stages = (232448 - fixed) / (I8T_STAGE + 16);
  if (q.stages > QA_STAGES_MAX) q.stages = QA_STAGES_MAX;
  q.smem = fixed + q.stages * (I8T_STAGE + 16);
  const int mt = (M + bm - 1) / bm, nt = N / 128;
  int g = (sms + mt - 1) / mt;
  g = g < 1 ? 1 : g > nt ? nt : g;
  q.per = nt / g;
  q.groups = (nt + q.per - 1) / q.per;
  return q;
}

template <typename T>
struct GemmQaParams {
  CUtensorMap w;             // W's boxes of 128 rows x 128 bytes
  const T* in;               // (M, K): the rows quantized on chip
  const float *ln_s, *ln_b;  // the LayerNorm's (LN only)
  GemmI8Args e;              // w_s, bias, resid, out, M, N, K (its a, a_s unused)
  int stages, groups, per;
};

template <int EPI, typename T, bool LN, int HM>
__global__ void __launch_bounds__(QA_THREADS, 1)
    gemm_qa_kernel(const __grid_constant__ GemmQaParams<T> p) {
  constexpr int BM = 64 * HM;
  using V = RowVec<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int S = p.stages, M = p.e.M, K = p.e.K, KD = K / 128, A_BYTES = BM * K, Nn = p.e.N;
  unsigned char* A = ring + S * I8T_STAGE;
  float* gb = reinterpret_cast<float*>(A + 2 * A_BYTES);  // LN: [2][K]
  float* wsb = gb + (LN ? 2 * K : 0);  // [2][N]: W's scales, the bias
  float* hs = wsb + 2 * Nn;            // [2][BM]: the A tiles' row scales
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * BM);
  uint64_t* empty = full + S;
  uint64_t* a_full = empty + S;    // [2]: an A tile written (a row, a quantizing warp)
  uint64_t* a_empty = a_full + 2;  // [2]: an A tile read (one arrival a consumer warp)
  int* claim = reinterpret_cast<int*>(a_empty + 2);  // [2]: rows claimed of each A tile
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int nt = Nn / 128, items = (M + BM - 1) / BM * p.groups;
  // item it: rows from (it / groups) BM, column tiles [n0, n1)
  auto cols = [&](int it, int& n0, int& n1) {
    n0 = it % p.groups * p.per;
    n1 = n0 + p.per < nt ? n0 + p.per : nt;
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 4);  // one arrival a warp of the tile's warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      bar_init(a_full + b, BM + QA_QUANT_WARPS);
      bar_init(a_empty + b, 8);
      claim[b] = 0;
    }
    bar_init_done();
  }
  for (int c = tid; c < Nn; c += QA_THREADS) {  // the vectors, once
    wsb[c] = p.e.w_s[c];
    wsb[Nn + c] = p.e.bias[c];
  }
  for (int k = tid; LN && k < K; k += QA_THREADS) {
    gb[k] = p.ln_s[k];
    gb[K + k] = p.ln_b[k];
  }
  __syncthreads();

  // The rows of item i (the walk's i-th, A tile b = i % 2, its round i / 2)
  // that this warp claims, each quantized into the A tile and announced on
  // a_full; `pend`, a claim past the item's rows (the next round's), is
  // kept for that round. Then the warp's own arrival for the item.
  auto quantize = [&](int i, int it, int& pend) {
    const int b = i & 1, m0 = it / p.groups * BM, base = (i >> 1) * BM;
    unsigned char* Ab = A + b * A_BYTES;
    for (;;) {
      int c = pend;
      if (c < 0) {
        if (lane == 0) c = atomicAdd(claim + b, 1);
        c = __shfl_sync(0xffffffffu, c, 0);
      }
      pend = -1;
      const int row = c - base;
      if (row >= BM) {
        pend = c;
        break;
      }
      // column k of the row: K slice k / 128, the row's 64-row half
      auto at = [&](int k) {
        return Ab + ((k / 128) * HM + row / 64) * TILE64 + swz(row % 64, (k % 128) / 16) + k % 16;
      };
      const T* xr = p.in + (size_t)(m0 + row) * K;
      float sc = 1.f;
      if (m0 + row < M)
        sc = quant_row<LN, T>([&](int k, float* f) { V::load(xr + k, f); }, gb, gb + K, K, lane,
                              [&](int k, const int* cd) {
          if constexpr (V::N == 8)
            *reinterpret_cast<uint2*>(at(k)) = make_uint2(pack_s8x4(cd), pack_s8x4(cd + 4));
          else
            *reinterpret_cast<uint32_t*>(at(k)) = pack_s8x4(cd);
        });
      else  // rows past M: zeros
        for (int k = lane * 16; k < K; k += 512)
          *reinterpret_cast<uint4*>(at(k)) = make_uint4(0, 0, 0, 0);
      if (lane == 0) hs[b * BM + row] = sc;
      async_fence();  // the codes visible to the consumers' wgmma
      __syncwarp();
      if (lane == 0) bar_arrive(a_full + b);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(a_full + b);
  };

  if (wg >= 2) reg_dealloc<QA_LN_REGS>();  // whole warpgroups at once
  if (warp > 8) {  // the LN warps: every item's rows, an item ahead of the consumers
    int pend[2] = {-1, -1}, i = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++i) {
      bar_wait(a_empty + (i & 1), ((i >> 1) & 1) ^ 1);  // item i - 2 done with the tile
      quantize(i, it, pend[i & 1]);
    }
    return;
  }
  if (wg == 2) {  // the producer: W's stages in the consumers' order
    if (tid != 256) return;
    Ring r;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      int n0, n1;
      cols(it, n0, n1);
      for (int n = n0; n < n1; ++n)
        for (int k = 0; k < KD; ++k) {
          bar_wait(empty + r.s, r.ph ^ 1);
          bar_expect(full + r.s, I8T_STAGE);
          tma_load(ring + r.s * I8T_STAGE, &p.w, full + r.s, k * 128, n * 128);
          r.next(S);
        }
    }
    return;
  }

  // consumer warpgroup wg: the rows of each item it can still claim, then
  // the block's output tiles (its steps, item after item) wg, wg + 2, ...
  reg_alloc<QA_CONSUMER_REGS>();
  const int t128 = tid & 127;
  Consumer c;
  int pend[2] = {-1, -1}, j = 0;  // j: the block's steps before this item
  int i = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++i) {
    const int b = i & 1, m0 = it / p.groups * BM;
    const unsigned char* Ab = A + b * A_BYTES;
    int n0, n1;
    cols(it, n0, n1);
    bar_wait(a_empty + b, ((i >> 1) & 1) ^ 1);  // item i - 2 done with the tile
    quantize(i, it, pend[b]);
    bar_wait(a_full + b, (i >> 1) & 1);  // every row of the item
    float rs[HM][2];
#pragma unroll
    for (int hm = 0; hm < HM; ++hm)
#pragma unroll
      for (int h = 0; h < 2; ++h) rs[hm][h] = hs[b * BM + hm * 64 + frag_row(t128, h)];
    const bool last_item = it + gridDim.x >= items;
    for (int n = n0 + ((j + wg) & 1); n < n1; n += 2) {
      const int js = j + n - n0;  // this step's place in the block's walk
      c.r.s = js * KD % S;
      c.r.ph = js * KD / S & 1;
      int acc[HM][64];
#pragma unroll
      for (int hm = 0; hm < HM; ++hm) zero(acc[hm]);
      if (js > 0) pp_wait(PP_BAR + wg);  // the ring in turns, as gemm_s8_kernel
      for (int k = 0; k < KD; ++k) {
        const uint64_t db = desc(ring + c.acquire(full) * I8T_STAGE);
        uint64_t da[HM];
#pragma unroll
        for (int hm = 0; hm < HM; ++hm) {
          da[hm] = desc(Ab + (k * HM + hm) * TILE64);
          pin(acc[hm]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hm = 0; hm < HM; ++hm) wgmma_s8_n128(acc[hm], da[hm] + 2 * kk, db + 2 * kk);
        c.issued(empty, S);
#pragma unroll
        for (int hm = 0; hm < HM; ++hm) pin(acc[hm]);
      }
      if (n + 1 < n1 || !last_item) pp_pass(PP_BAR + (wg ^ 1));  // the next step's turn
      c.drain(empty);
      // epi_i8's outputs, W's scales and the bias from shared memory, each
      // 8 columns' residuals loaded before their first store (the stores may
      // alias them, so they would otherwise wait in turn)
#pragma unroll
      for (int hm = 0; hm < HM; ++hm) {
        pin(acc[hm]);
#pragma unroll
        for (int q0 = 0; q0 < 16; q0 += 8) {
          uint32_t res[8][2];
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = m0 + hm * 64 + frag_row(t128, h);
              res[q][h] = row < M ? resid_pair<EPI>(p.e, (size_t)row * Nn + n * 128 +
                                                             frag_col(t128, q0 + q))
                                  : 0u;
            }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int col = n * 128 + frag_col(t128, q0 + q);
            const float2 ws = *reinterpret_cast<const float2*>(wsb + col);
            const float2 bs = *reinterpret_cast<const float2*>(wsb + Nn + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = m0 + hm * 64 + frag_row(t128, h), e = 4 * (q0 + q) + 2 * h;
              if (row < M)
                store_i8<EPI>(p.e, (size_t)row * Nn + col,
                              epi_value<EPI>(acc[hm][e], rs[hm][h], ws.x, bs.x),
                              epi_value<EPI>(acc[hm][e + 1], rs[hm][h], ws.y, bs.y), res[q][h]);
            }
          }
        }
      }
    }
    // this warpgroup's wgmma on the A tile have completed (drained above)
    __syncwarp();
    if (lane == 0) bar_arrive(a_empty + b);
    j += n1 - n0;
  }
}

// The quantizing GEMM on stream s: `in` (M, K), T bf16 with LN (ln_s,
// ln_b) or fp32 without; e.w the int8 weight (N, K), e.w_s, e.bias, e.resid
// (I8_RESID), e.out; e.a and e.a_s unused. N % 128 == 0, K % 128 == 0, and
// a K whose A tiles fit (qa_plan's stages >= 2), else cudaErrorInvalidValue.
template <int EPI, typename T, bool LN>
static int gemm_qa(const void* in, const void* ln_s, const void* ln_b, const GemmI8Args& e,
                   cudaStream_t s) {
  if (e.M <= 0 || e.N <= 0 || e.N % 128 || e.K <= 0 || e.K % 128 ||
      (EPI == I8_RESID && e.resid == nullptr) || (LN && (ln_s == nullptr || ln_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const QaPlan q = qa_plan(e.M, e.N, e.K, sms, LN);
  if (q.stages < 2) return (int)cudaErrorInvalidValue;
  GemmQaParams<T> p;
  if (int r = tensor_map_i8(&p.w, e.w, e.N, e.K, 128)) return r;
  p.in = static_cast<const T*>(in);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.e = e;
  p.stages = q.stages;
  p.groups = q.groups;
  p.per = q.per;
  auto kern = q.hm == 2 ? gemm_qa_kernel<EPI, T, LN, 2> : gemm_qa_kernel<EPI, T, LN, 1>;
  cudaError_t r = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem);
  if (r != cudaSuccess) return (int)r;
  const int items = (e.M + 64 * q.hm - 1) / (64 * q.hm) * q.groups;
  kern<<<items < sms ? items : sms, QA_THREADS, q.smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace i8sm90
