// T5's former staged core, kept for the card's checks only (no tool runs
// it; attn_bwd_staged.cuh holds T5's core as it runs now): K5's core
// outputs with the staged schedule of tools/bench_bwd_staged.py::
// staged_bwd (Pallas _staged_bwd_kernel :37), inside K5's launch chain
// (fused_attn_bwd.cu's mfv_staged_bwd_former).
//
// A block owns one head of cb images on a grid of (heads, B / cb). Its two
// warpgroups take every other image, each with K5's shared memory (K and V
// rows, then Q and dO rows, and the row statistics), and run in ping-pong
// ordered by two named barriers, as T4 (attn_staged.cu): a warpgroup waits
// on its own barrier before its tensor-core phase and arrives on the
// other's after it. In phase A a unit is 64 query rows (16 per warp); a
// tensor-core phase runs the gradient products of the warpgroup's last
// unit (o = P V, dP, D_i, dS, dq) and the scores of its next, and after it
// the warpgroup runs the next unit's softmax (the row max, exp, the sums,
// P) on the CUDA cores and SFUs beside the other warpgroup's products. In
// phase B each tensor-core phase runs 64 key rows' dk and dv. The loads of
// an image's rows into shared memory (synchronous, between the phases)
// fall outside the tensor-core phases.
//
// Each warp runs attn_bwd.cuh's stages on its rows unchanged, so o and
// dqkv, and with K5's GEMMs every output, equal K5's bit for bit. Two
// warpgroups' shared memory, 2 x 115,648 bytes at head_dim 128 and N=208,
// is the most a block can have, so head_dim 128 takes N <= 208.
#pragma once

#include "attn_bwd.cuh"

namespace attn_bwd {
namespace staged_former {

constexpr int QB = 64;  // rows of a unit: 16 per warp

template <int DH, int NKT>
__global__ void __launch_bounds__(2 * WG)
    staged_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                      float* __restrict__ o, bf16* __restrict__ dqkv, int N, int heads,
                      float scale, int cb) {
  using S = Smem<DH, NKT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG, warp = tid >> 5;
  unsigned char* sm = smem + wg * S::BYTES;
  bf16* T0 = reinterpret_cast<bf16*>(sm);  // phase A: K rows; phase B: Q rows
  bf16* T1 = T0 + S::NP * S::LD;           // phase A: V rows; phase B: dO rows
  const int qblocks = (N + QB - 1) / QB;
  const int images = (cb + 1) / 2;           // per warpgroup: its i-th is 2i + wg
  const int steps = images * (2 * qblocks + 1);  // ping-pong phases per warpgroup
  int step = 0;
  // a phase without work still takes and passes the turn, so every wait
  // meets one arrival; warpgroup 1 passes none after its last phase
  auto pass = [&]() {
    if (wg == 0 || ++step < steps) pp_pass(PP_BAR + 1 - wg);
  };

  float p[NKT][4], m0 = 0.f, m1 = 0.f, l0 = 0.f, l1 = 0.f;
  if (wg == 1) pp_pass(PP_BAR);  // warpgroup 0 takes the tensor cores first
  for (int i = 0; i < images; ++i) {
    const int bi = 2 * i + wg;
    const bool has = bi < cb;
    const Head hd = head_of<DH, NKT>(qkv, dout, o, dqkv, blockIdx.y * cb + (has ? bi : 0),
                                     blockIdx.x, N, heads, scale, sm);
    const size_t P3 = (size_t)3 * hd.D;
    if (has) {
      group_sync(1 + wg);  // every warp is past the last image's phase B
      load_rows<DH>(T0, hd.q + hd.D, P3, N, S::NP, S::LD, tid, WG);
      load_rows<DH>(T1, hd.q + 2 * hd.D, P3, N, S::NP, S::LD, tid, WG);
      group_sync(1 + wg);
    }
    // phase A: qblocks + 1 phases, the gradients of unit k-1 and the
    // scores of unit k in the k-th, unit k's softmax after it
    for (int k = 0; k <= qblocks; ++k) {
      const int last = (k - 1) * QB + warp * 16, next = k * QB + warp * 16;
      pp_wait(PP_BAR + wg);
      if (has && k > 0 && last < N)
        bwd_query_grads<DH, NKT>(hd, last, T0, T1, p, m0, m1, l0, l1);
      const bool scores = has && k < qblocks && next < N;
      if (scores) bwd_scores<DH, NKT>(hd, next, T0, p);
      pass();
      if (scores) bwd_softmax<NKT>(p, N, scale, m0, m1, l0, l1);
    }
    if (has) {
      group_sync(1 + wg);  // every warp is past phase A
      load_rows<DH>(T0, hd.q, P3, N, S::NP, S::LD, tid, WG);
      load_rows<DH>(T1, hd.dout, hd.D, N, S::NP, S::LD, tid, WG);
      group_sync(1 + wg);
    }
    // phase B: qblocks phases of 64 key rows
    for (int k = 0; k < qblocks; ++k) {
      const int k0 = k * QB + warp * 16;
      pp_wait(PP_BAR + wg);
      if (has && k0 < N) bwd_key_grads<DH, NKT>(hd, k0, T0, T1);
      pass();
    }
  }
}

template <int DH, int NKT>
static int launch(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N, int heads,
                  float scale, int cb, cudaStream_t stream) {
  const int smem = 2 * (int)Smem<DH, NKT>::BYTES;
  auto kern = staged_bwd_kernel<DH, NKT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(heads, B / cb), 2 * WG, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<float*>(o),
      static_cast<bf16*>(dqkv), N, heads, scale, cb);
  return (int)cudaGetLastError();
}

// The smallest key-tile count that covers N, as K5's.
template <int DH>
static int launch_n(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                    int heads, float scale, int cb, cudaStream_t s) {
  if (N <= 64) return launch<DH, 8>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
  if (N <= 128) return launch<DH, 16>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
  if (N <= 208) return launch<DH, 26>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
  if constexpr (DH < 128)
    return launch<DH, 32>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
  return (int)cudaErrorInvalidValue;  // two warpgroups' rows pass the shared memory
}

}  // namespace staged_former

// Built in the units of T5's core (attn_bwd_staged_dh{32,64,128}.cu).
int staged_former_dh32(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                       int heads, float scale, int cb, cudaStream_t s);
int staged_former_dh64(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                       int heads, float scale, int cb, cudaStream_t s);
int staged_former_dh128(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                        int heads, float scale, int cb, cudaStream_t s);

// T5's former staged core: K5's core's outputs, each block owning one head
// of cb images.
static int staged_former_core(const void* qkv, const void* dout, void* o, void* dqkv, int B,
                              int N, int heads, int dh, float scale, int cb, cudaStream_t s) {
  if (B <= 0 || N <= 0 || N > NMAX || heads <= 0 || cb <= 0 || B % cb != 0 || B / cb > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return staged_former_dh32(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
    case 64: return staged_former_dh64(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
    case 128: return staged_former_dh128(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_bwd
