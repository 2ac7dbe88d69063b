// gemm_sm90: the port's warpgroup-MMA GEMM core for Hopper (sm_90a): TMA
// tile loads into a ring of shared-memory stages, filled by one producer
// thread, consumed by warpgroups that run wgmma.mma_async with fp32
// accumulators in registers. K1 (fused_attn.cu) runs its qkv and proj
// GEMMs on gemm_kernel below, K15 (fused_block.cu) its qkv GEMM, K2 and K3
// (fused_mlp.cu) their fc1 and fc2 at D > 512; block_tail.cuh builds K15's,
// K2's and K3's block tail from the same pieces. K5 and K7 (the backward
// halves, gemm_bwd_sm90.cuh) run their GEMMs on gemm_mn_kernel, the same
// core with MN-major operands. The plain C entries of gemm_sm90.cu
// (mfv_gemm_sm90, mfv_gemm_mn) run the kernels alone for the card's checks.
//
//   C[M, N] = epilogue(A[M, K] . W[N, K]^T + bias), A and W bf16, W in the
//   torch Linear layout (out, in): both operands K-major, so neither wgmma
//   operand is transposed.
//
// Layout: a tile is R rows of 64 bf16 along K (128 bytes), as a 2-D tensor
// map box writes it with the 128-byte swizzle (16-byte group g of row r at
// (g ^ (r % 8)) * 16), 1024-byte aligned, so 8-row atoms lie 1024 bytes
// apart (the descriptor's stride byte offset) and the k16 step kk starts
// 32 * kk bytes into each row (the descriptor's start address + 2 * kk).
//
// Sum order: every fp32 sum runs over k in ascending k16 steps into one
// accumulator per output, the order of gemm_ln.cuh's K loop; the epilogues
// round where gemm_ln's do (its Epilogue enum, gelu_erf). Whether a wgmma
// k16 step rounds as mma.sync's does is not documented; chip_smoke.py's
// probe counts the outputs where mfv_gemm_sm90 and gemm_ln differ.
//
// The host encodes the tensor maps with the driver's cuTensorMapEncodeTiled,
// looked up in the already loaded libcuda (no link against it), and passes
// them to the kernel as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "gemm_ln.cuh"

namespace sm90 {

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The map of a row-major (rows, cols) bf16 matrix, boxes of `box_rows` rows
// of 64 columns in the 128-byte swizzle; rows past `rows` load as zeros.
static int tensor_map(CUtensorMap* m, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

static int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// ---- device: barriers, copies, descriptors ----

constexpr int TILE64 = 64 * 128;  // bytes of a 64-row tile
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;  // setmaxnreg, per thread

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the dynamic shared memory rounded up to 1024 bytes (the swizzle atom)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (saddr(p) & 1023)) & 1023);
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_init_done() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b)) : "memory");
}
// arrive and expect `bytes` more from copies that complete on this barrier
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* b, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of map m at (column col, row row) into dst; completes on b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* m, uint64_t* b, int col,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(saddr(b)), "r"(col), "r"(row)
      : "memory");
}

// make this thread's ordinary shared-memory writes visible to wgmma and TMA
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the wgmma descriptor of a K-major 128-byte-swizzled tile at p: start
// address >> 4, leading byte offset 1 (unused in this layout), stride byte
// offset 1024 >> 4 (the next 8-row atom), layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that own the registers
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// the barrier over the two consumer warpgroups (0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// D[64 x N] += A[64 x 16] . B[N x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Accumulator layout of an m64nN wgmma: thread t of the warpgroup holds,
// for q < N / 8 and h < 2, d[4q + 2h] and d[4q + 2h + 1] at row
// 16 * (t / 32) + (t % 32) / 4 + 8h, columns 8q + 2 * (t % 4) and the next.
__device__ __forceinline__ int frag_row(int t, int h) { return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * h; }
__device__ __forceinline__ int frag_col(int t, int q) { return 8 * q + 2 * (t & 3); }

// The ring of the producer thread and of each consumer: stage s, and the
// parity of its current round.
struct Ring {
  int s = 0, ph = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
};

// A consumer warpgroup's walk over the ring: wait for a stage, issue its
// wgmma as one group, and hand back the stage before it once that group has
// completed (one group in flight). `empty` takes one arrival a consumer
// warp.
struct Consumer {
  Ring r;
  int held = -1;  // the stage whose wgmma may still run
  __device__ __forceinline__ int acquire(uint64_t* full) {
    bar_wait(full + r.s, r.ph);
    wg_fence();
    return r.s;
  }
  __device__ __forceinline__ void release(uint64_t* empty) {
    if (held >= 0 && (threadIdx.x & 31) == 0) bar_arrive(empty + held);
  }
  __device__ __forceinline__ void issued(uint64_t* empty, int stages) {
    wg_commit();
    wg_wait<1>();
    release(empty);
    held = r.s;
    r.next(stages);
  }
  // every group completed, every stage handed back
  __device__ __forceinline__ void drain(uint64_t* empty) {
    wg_wait<0>();
    release(empty);
    held = -1;
  }
};

// The descriptor of an MN-major 128-byte-swizzled operand at p, as TMA
// writes a box of 64 K rows of 64 M (or N) values: each K row is 128 bytes,
// 8-row groups lie 1024 bytes apart (stride byte offset 1024 >> 4), and the
// next 64-wide M or N block is the next box, 8192 bytes on (leading byte
// offset 8192 >> 4); the k16 step kk starts 16 rows, 2048 bytes, further
// (start address + 128 * kk). The wgmma then runs with its transpose bit
// set for this operand: the bit says which dimension is contiguous.
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | (512ull << 16) | (64ull << 32) | (1ull << 62);
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]; TA / TB: A / B MN-major (the
// transpose bits), else K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128t(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ---- the GEMM ----

// Tiles of 128 x 128 outputs; a stage is the A and W boxes of one 64-wide K
// slice (32 KB). The grid is persistent and walks the tiles in row-major
// order (blocks at work at once share A rows in L2); a block's tiles
// alternate between its two consumer warpgroups (ping-pong), each holding
// a whole tile (two m64n128 accumulators, 128 registers a thread), so one
// warpgroup's epilogue runs beside the other's wgmma.
constexpr int GEMM_BM = 128, GEMM_BN = 128, GEMM_STAGES = 7, GEMM_THREADS = 384;
constexpr int GEMM_STAGE = (GEMM_BM + GEMM_BN) * 128;
constexpr int GEMM_SMEM = GEMM_STAGES * GEMM_STAGE + 2 * GEMM_STAGES * 8 + 1024;

struct GemmParams {
  CUtensorMap a, w;  // boxes of 128 rows
  const float* bias;
  const bf16* resid;
  void* out;  // bf16, or fp32 (EPI_F32)
  int M, N, K;
};

// out = epilogue(acc + bias) for one accumulator pair at (row, col): gemm_ln's
// rounding points; `res` holds the pair's two bf16 residuals (EPI_BIAS_RESID,
// EPI_F32)
template <int EPI>
__device__ __forceinline__ void store_pair(const GemmParams& p, int row, int col, float v0,
                                           float v1, uint32_t res) {
  if (row >= p.M) return;
  const float2 b = *reinterpret_cast<const float2*>(p.bias + col);
  if (EPI == EPI_F32) {  // K3 at D > 512: x + acc + bias in fp32, gemm_ln's order
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res));
    v0 = x.x + v0;
    v0 += b.x;
    v1 = x.y + v1;
    v1 += b.y;
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + (size_t)row * p.N + col) =
        make_float2(v0, v1);
    return;
  }
  v0 += b.x;
  v1 += b.y;
  if (EPI == EPI_BIAS_GELU) {
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  }
  if (EPI == EPI_BIAS_RESID) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res));
    v0 = x.x + round_bf16(v0);
    v1 = x.y + round_bf16(v1);
  }
  *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + (size_t)row * p.N + col) =
      __floats2bfloat162_rn(v0, v1);
}

// The epilogue of 128 rows from m0 and 128 columns from n0 held in two
// m64n128 accumulators (rows m0 .. + 63, m0 + 64 .. + 127) by one
// warpgroup's thread t128.
template <int EPI>
__device__ __forceinline__ void store_rows(const GemmParams& p, float (&acc)[2][64], int m0, int n0,
                                           int t128) {
#pragma unroll
  for (int hm = 0; hm < 2; ++hm) {
    pin(acc[hm]);
    // the half's residual pairs, all loads issued before its first store
    // (the stores may alias them, so they would otherwise wait in turn)
    uint32_t res[16][2] = {};
    if (EPI == EPI_BIAS_RESID || EPI == EPI_F32) {
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + hm * 64 + frag_row(t128, h);
          if (row < p.M)
            res[q][h] = *reinterpret_cast<const uint32_t*>(p.resid + (size_t)row * p.N + n0 +
                                                           frag_col(t128, q));
        }
    }
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_pair<EPI>(p, m0 + hm * 64 + frag_row(t128, h), n0 + frag_col(t128, q),
                        acc[hm][4 * q + 2 * h], acc[hm][4 * q + 2 * h + 1], res[q][h]);
  }
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1) gemm_kernel(const __grid_constant__ GemmParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + GEMM_STAGES * GEMM_STAGE);
  uint64_t* empty = full + GEMM_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nt = p.N / GEMM_BN, tiles = (p.M + GEMM_BM - 1) / GEMM_BM * nt, KT = p.K / 64;
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
          tma_load(st, &p.a, full + r.s, kt * 64, m0);
          tma_load(st + GEMM_BM * 128, &p.w, full + r.s, kt * 64, n0);
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
      float acc[2][64];
      zero(acc[0]);
      zero(acc[1]);
      // The warpgroups take the ring in turns, a tile's K loop each: a
      // stage's wait tells its rounds apart by parity alone, so a tile's
      // first wait must come after every stage of the tile before has been
      // filled (else, with KT > GEMM_STAGES, it could pass on the round
      // before); the other warpgroup's epilogue runs beside this K loop.
      if (i > 0) pp_wait(PP_BAR + wg);
      for (int kt = 0; kt < KT; ++kt) {
        const unsigned char* st = sm + c.acquire(full) * GEMM_STAGE;
        const uint64_t da0 = desc(st), da1 = desc(st + TILE64), db = desc(st + GEMM_BM * 128);
        pin(acc[0]);
        pin(acc[1]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_n128(acc[0], da0 + 2 * kk, db + 2 * kk);
          wgmma_n128(acc[1], da1 + 2 * kk, db + 2 * kk);
        }
        c.issued(empty, GEMM_STAGES);
        pin(acc[0]);
        pin(acc[1]);
      }
      if (t + gridDim.x < tiles) pp_pass(PP_BAR + (wg ^ 1));  // the next tile's turn
      c.drain(empty);
      store_rows<EPI>(p, acc, m0, n0, t128);
    }
  }
}

// out (M, N) bf16 (EPI_F32: fp32) = epilogue(a . w^T + bias) on stream s;
// resid (M, N) for EPI_BIAS_RESID and EPI_F32. Takes N % 128 == 0, K % 64
// == 0, 16-byte aligned rows.
template <int EPI>
static int gemm(const void* a, const void* w, const void* bias, const void* resid, void* out,
                int M, int N, int K, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || N % GEMM_BN || K % 64 || bias == nullptr ||
      ((EPI == EPI_BIAS_RESID || EPI == EPI_F32) && resid == nullptr))
    return (int)cudaErrorInvalidValue;
  GemmParams p;
  if (int e = tensor_map(&p.a, a, M, K, GEMM_BM)) return e;
  if (int e = tensor_map(&p.w, w, N, K, GEMM_BN)) return e;
  p.bias = static_cast<const float*>(bias);
  p.resid = static_cast<const bf16*>(resid);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  const int tiles = (M + GEMM_BM - 1) / GEMM_BM * (N / GEMM_BN), sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  auto kern = gemm_kernel<EPI>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<tiles < sms ? tiles : sms, GEMM_THREADS, GEMM_SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

// ---- the backward GEMMs: MN-major operands ----
//
// The weight-gradient and NN products of K5 and K7 (gemm_bwd.cuh's gemm_tn
// and gemm_nn, which the former chains keep) on the same core: TMA boxes in
// the 128-byte swizzle into the ring, one producer thread, with the operand
// whose M or N index is contiguous in memory read through MN-major
// descriptors (desc_mn) and the wgmma transpose bits. The NN tiles (short K
// loops, many tiles) ping-pong between the two consumer warpgroups, which
// take the ring in turns, as gemm_kernel's; a TN tile (a K loop of up to a
// hundred stages, two or three tiles a block) is taken by both at once, 64
// of its rows each.
//
//   MN_NN  out (M, N) = a (M, K) . b (K, N), bf16 or fp32: a K-major (one
//          box of 128 rows), b the torch weight (out, in) read as (K, N):
//          MN-major (two boxes of 64 K rows x 64 columns a stage)
//   MN_TN  part[z] (M, N) = a[kz, :]^T . b[kz, :] over the z-th slice of kc
//          rows, a (K, M) and b (K, N) both MN-major (two boxes each a
//          stage), fp32; the tiles at n0 = 0 also write bias_part[z] (M),
//          the slice's column sums of a
//
// Sum order: every output is one fp32 accumulator over k in ascending k16
// steps, gemm_bwd.cuh's order, so with a wgmma k16 step rounding as
// mma.sync's each output has gemm_nn's or gemm_tn's bits; a TN tile skips
// the k16 steps past its slice's end (the rows there belong to the next
// slice: TMA fills zeros only past the tensor's edge). The column sums run
// over the slice's rows in ascending order, one thread a column, as
// gemm_tn's do.
enum MnForm { MN_NN = 0, MN_TN = 1 };

struct MnParams {
  CUtensorMap a, b;
  float* bias_part;  // MN_TN: (S, M)
  void* out;         // MN_NN: (M, N); MN_TN: (S, M, N) fp32
  int M, N, K, kc;   // MN_NN: kc = K
};

// Tile t: its output slice z, rows m0 and columns n0 of the output, and
// the k rows [kb, ke) it sums. Within a slice the tiles run row-major,
// their columns rotated by z, so that the tiles at n0 = 0 (the ones that
// also take the column sums) fall on other blocks in each slice.
template <int FORM>
__device__ __forceinline__ void mn_tile(const MnParams& p, int t, int per_z, int nt, int& z,
                                        int& m0, int& n0, int& kb, int& ke) {
  z = FORM == MN_TN ? t / per_z : 0;
  const int l = t - z * per_z;
  m0 = l / nt * GEMM_BM;
  n0 = (l % nt + z) % nt * GEMM_BN;
  kb = z * p.kc;
  ke = min(p.K, kb + p.kc);
}

template <int FORM, bool F32>
__global__ void __launch_bounds__(GEMM_THREADS, 1) gemm_mn_kernel(const __grid_constant__ MnParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + GEMM_STAGES * GEMM_STAGE);
  uint64_t* empty = full + GEMM_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nt = p.N / GEMM_BN, per_z = (p.M + GEMM_BM - 1) / GEMM_BM * nt;
  const int tiles = per_z * (FORM == MN_TN ? (p.K + p.kc - 1) / p.kc : 1);
  if (tid == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, FORM == MN_TN ? 8 : 4);  // one arrival a warp that takes the stage
    }
    bar_init_done();
  }
  __syncthreads();
  if (wg == 2) {  // the producer
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 256) {
      Ring r;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int z, m0, n0, kb, ke;
        mn_tile<FORM>(p, t, per_z, nt, z, m0, n0, kb, ke);
        for (int k0 = kb; k0 < ke; k0 += 64) {
          bar_wait(empty + r.s, r.ph ^ 1);
          unsigned char* st = sm + r.s * GEMM_STAGE;
          bar_expect(full + r.s, GEMM_STAGE);
          if (FORM == MN_TN) {
            tma_load(st, &p.a, full + r.s, m0, k0);
            tma_load(st + TILE64, &p.a, full + r.s, m0 + 64, k0);
          } else {
            tma_load(st, &p.a, full + r.s, k0, m0);
          }
          tma_load(st + 2 * TILE64, &p.b, full + r.s, n0, k0);
          tma_load(st + 3 * TILE64, &p.b, full + r.s, n0 + 64, k0);
          r.next(GEMM_STAGES);
        }
      }
    }
  } else if (FORM == MN_TN) {  // both consumer warpgroups on every tile: rows 64 wg ..
    reg_alloc<CONSUMER_REGS>();
    const int t128 = tid & 127;
    Consumer c;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int z, m0, n0, kb, ke;
      mn_tile<FORM>(p, t, per_z, nt, z, m0, n0, kb, ke);
      m0 += 64 * wg;
      const bool sums = n0 == 0 && t128 < 64;  // column m0 + t128 of a
      float rs = 0.f;
      float acc[64];
      zero(acc);
      for (int k0 = kb; k0 < ke; k0 += 64) {
        const unsigned char* st = sm + c.acquire(full) * GEMM_STAGE;
        const int rows = min(64, ke - k0), steps = (rows + 15) / 16;
        const uint64_t da = desc_mn(st + wg * TILE64), db = desc_mn(st + 2 * TILE64);
        pin(acc);
        if (steps == 4) {  // a whole stage
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_n128t<1, 1>(acc, da + 128 * kk, db + 128 * kk);
        } else {  // the slice ends inside it
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < steps) wgmma_n128t<1, 1>(acc, da + 128 * kk, db + 128 * kk);
        }
        if (sums) {  // its rows in order, 16 loads at a time
          const unsigned char* col = st + wg * TILE64 + (t128 & 7) * 2;
          const int g16 = t128 >> 3;
          for (int k = 0; k < steps; ++k) {  // past K: TMA's zeros, as gemm_tn's
            float v[16];
#pragma unroll
            for (int r = 0; r < 16; ++r)
              v[r] = __bfloat162float(*reinterpret_cast<const bf16*>(
                  col + (16 * k + r) * 128 + ((g16 ^ (r & 7)) << 4)));
#pragma unroll
            for (int r = 0; r < 16; ++r) rs += v[r];
          }
        }
        c.issued(empty, GEMM_STAGES);
        pin(acc);
      }
      c.drain(empty);
      pin(acc);
      float* of = static_cast<float*>(p.out) + (size_t)z * p.M * p.N;
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + frag_row(t128, h), col = n0 + frag_col(t128, q);
          *reinterpret_cast<float2*>(of + (size_t)row * p.N + col) =
              make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
        }
      if (sums) p.bias_part[(size_t)z * p.M + m0 + t128] = rs;
    }
  } else {  // MN_NN, consumer warpgroup wg: the block's tiles wg, wg + 2, ...
    reg_alloc<CONSUMER_REGS>();
    const int t128 = tid & 127;
    Consumer c;
    int i = wg;
    for (int t = blockIdx.x + wg * gridDim.x; t < tiles; t += 2 * gridDim.x, i += 2) {
      int z, m0, n0, kb, ke;
      mn_tile<FORM>(p, t, per_z, nt, z, m0, n0, kb, ke);
      const int KT = p.K / 64;
      c.r.s = i * KT % GEMM_STAGES;
      c.r.ph = i * KT / GEMM_STAGES & 1;
      float acc[2][64];
      zero(acc[0]);
      zero(acc[1]);
      if (i > 0) pp_wait(PP_BAR + wg);  // the ring in turns, as gemm_kernel
      for (int kt = 0; kt < KT; ++kt) {
        const unsigned char* st = sm + c.acquire(full) * GEMM_STAGE;
        const uint64_t da0 = desc(st), da1 = desc(st + TILE64), db = desc_mn(st + 2 * TILE64);
        pin(acc[0]);
        pin(acc[1]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_n128t<0, 1>(acc[0], da0 + 2 * kk, db + 128 * kk);
          wgmma_n128t<0, 1>(acc[1], da1 + 2 * kk, db + 128 * kk);
        }
        c.issued(empty, GEMM_STAGES);
        pin(acc[0]);
        pin(acc[1]);
      }
      if (t + gridDim.x < tiles) pp_pass(PP_BAR + (wg ^ 1));
      c.drain(empty);
#pragma unroll
      for (int hm = 0; hm < 2; ++hm) {
        pin(acc[hm]);
#pragma unroll
        for (int q = 0; q < 16; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + hm * 64 + frag_row(t128, h), col = n0 + frag_col(t128, q);
            const float v0 = acc[hm][4 * q + 2 * h], v1 = acc[hm][4 * q + 2 * h + 1];
            if (row >= p.M) continue;
            const size_t off = (size_t)row * p.N + col;
            if (F32)
              *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) = make_float2(v0, v1);
            else
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + off) =
                  __floats2bfloat162_rn(v0, v1);
          }
      }
    }
  }
}

// MN_NN: out (M, N) = a (M, K) . b (K, N), bf16 or fp32 (F32); N % 128 ==
// 0, K % 64 == 0. MN_TN: part[z] (M, N) = a[kz]^T . b[kz] over S = ceil(K /
// kc) slices of kc rows, a (K, M), b (K, N), and bias_part[z] (M) the
// slices' column sums of a; M % 128 == 0, N % 128 == 0, kc % 16 == 0.
template <int FORM, bool F32>
static int gemm_mn(const void* a, const void* b, void* out, float* bias_part, int M, int N, int K,
                   int kc, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || N % GEMM_BN ||
      (FORM == MN_NN ? K % 64 != 0 : (M % GEMM_BM || kc <= 0 || kc % 16 || bias_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  MnParams p;
  if (FORM == MN_TN) {
    if (int e = tensor_map(&p.a, a, K, M, 64)) return e;
  } else {
    if (int e = tensor_map(&p.a, a, M, K, GEMM_BM)) return e;
  }
  if (int e = tensor_map(&p.b, b, K, N, 64)) return e;
  p.bias_part = bias_part;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.kc = FORM == MN_TN ? kc : K;
  const long long tiles = (long long)(M + GEMM_BM - 1) / GEMM_BM * (N / GEMM_BN) *
                          (FORM == MN_TN ? (K + kc - 1) / kc : 1);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  auto kern = gemm_mn_kernel<FORM, F32>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<tiles < sms ? (int)tiles : sms, GEMM_THREADS, GEMM_SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace sm90
