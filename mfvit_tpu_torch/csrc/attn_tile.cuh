// attn_tile: the per-tile pieces of the attention cores that stage whole
// images of one head into an mbarrier ring by a producer warp and give
// each consumer warp 16-row query tiles, a tile's P V waiting past the next
// tile's softmax: T1's pair core (attn_pairs.cu) and T2's rolling core
// (attn_rolling.cu). K1's asynchronous core (attn_async.cu) and T4's
// staged core (attn_staged.cu) keep their own copies: T4 on these pieces
// ran 1 % slower on the card, outside the spread of its own copy's turns
// (PERF.md).
//
// The pieces run K1's arithmetic with its rounding points and the order of
// every sum, so a core built on them equals the K1 kernel bit for bit: q
// scaled in fp32 and rounded to bf16; each score the fp32 sum over dh in
// ascending k16 steps (mma.sync m16n8k16); the row max over the valid
// keys, p = expf(s - max) (0 past N), each lane's row sum over the key
// tiles in ascending order, then the quad's xor-shuffle; P rounded to bf16
// from the score accumulators (attn_pack_p's packing); P V summed over the
// keys in ascending k16 steps; 1/sum applied to the P V output, which is
// rounded once to bf16. Only the last group of 16 keys below N needs the
// key mask; groups past N are skipped (p = 0 adds nothing to any sum).
//
// A slot holds, for each image it stages, the parts [q,] K, V: NKT * 8
// rows each at a pitch of DH + 8 bf16, row-major (zeros past N), read by
// ldmatrix (V's B fragments by ldmatrix.trans: no transposed copy). A
// tile's pieces take NI images at once, each on its own accumulator chain,
// their MMAs interleaved k16 step by k16 step (NI = 2: T1's pair tiles,
// the same 16 rows of both images of a pair; NI = 1: one image's tile).
#pragma once

#include "attn_core.cuh"

namespace tile {

// The producer warp's copy of one image's parts into a slot, 16 bytes a
// cp.async, zeros past N: src points at the image's first staged column of
// the head in qkv (q, or K where q is not staged; the parts lie D columns
// apart), dst at the image's first part in the slot (the parts lie NKT * 8
// rows apart). The caller arrives on the slot's barrier after its images.
template <int DH, int NKT, int PARTS>
__device__ __forceinline__ void stage_image(bf16* dst, const bf16* src, int N, size_t P3, int D,
                                            int lane) {
  constexpr int NK = NKT * 8, LD = DH + 8, PART = NK * LD;
  constexpr int CPR = DH / 8, RPI = 32 / CPR;  // 16-byte chunks a row, rows an iteration
  const int c = lane % CPR * 8;
  src += c;
  dst += c;
#pragma unroll
  for (int part = 0; part < PARTS; ++part)  // [q,] K, V
    for (int n = lane / CPR; n < NK; n += RPI)
      cp_async16_zfill(dst + part * PART + n * LD, n < N ? src + (size_t)n * P3 + part * D : src,
                       n < N);
}

// q's A fragments of rows q0 .. q0 + 15, scaled in fp32 and rounded: from
// the slot's q part qs (QS), else in the layout ldmatrix gives from device
// memory, qg the image's q columns of the head in qkv (zeros past N; 16
// rows a tile, read once).
template <int DH, bool QS>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DH / 16][4], const bf16* qs, const bf16* qg,
                                       int q0, int N, size_t P3, float scale, int lane) {
  constexpr int LD = DH + 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    if constexpr (QS) {
      ldsm_x4(qa[ks], qs + (q0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = q0 + g + (r & 1) * 8, col = ks * 16 + 2 * t4 + (r >> 1) * 8;
        qa[ks][r] =
            row < N ? *reinterpret_cast<const uint32_t*>(qg + (size_t)row * P3 + col) : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[ks][r]));
      qa[ks][r] = pack_bf16x2(f.x * scale, f.y * scale);
    }
  }
}

// One query tile of NI images over NKT * 8 staged keys. PASSES = 1 holds
// each image's row of fp32 scores from the max to the exps (NKT x 4
// registers an image); PASSES = 2 computes them again for the exps (the
// same sums, so the same bits) and holds none.
template <int DH, int NKT, int NI, int PASSES>
struct Tile {
  static constexpr int LD = DH + 8, KG = NKT / 2;  // KG: groups of 16 keys staged
  static constexpr int HELD = PASSES == 1 ? KG : 1;
  using Q = uint32_t[NI][DH / 16][4];  // q's A fragments
  using P = uint32_t[NI][KG][4];       // P, packed as A fragments
  using S = float[HELD][NI][2][4];     // the scores held between the passes
  using O = float[NI][DH / 8][4];      // the P V accumulators

  // the scores of 16-key group kk of each image: sc[n][e] holds 8-key tile
  // 2 kk + e of image n (attn_scores' layout)
  __device__ static __forceinline__ void scores(float (&sc)[NI][2][4], const Q& qa,
                                                const bf16* const (&Ks)[NI], int kk, int lane) {
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[n][e][0] = sc[n][e][1] = sc[n][e][2] = sc[n][e][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks[n] + (16 * kk + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16_16816(sc[n][0], qa[n][ks], kb[0], kb[1]);
        mma_bf16_16816(sc[n][1], qa[n][ks], kb[2], kb[3]);
      }
  }

  // q k^T and each lane's row max of rows g (m0) and g + 8 (m1) over the
  // valid keys; quad_max joins the quad's
  __device__ static __forceinline__ void row_max(S& held, float (&m0)[NI], float (&m1)[NI],
                                                 const Q& qa, const bf16* const (&Ks)[NI],
                                                 int N, int lane) {
    const int t4 = lane & 3, groups = (N + 15) / 16;  // the last group may pass N
#pragma unroll
    for (int n = 0; n < NI; ++n) m0[n] = m1[n] = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (kk >= groups) break;
      float(&sc)[NI][2][4] = held[PASSES == 1 ? kk : 0];
      scores(sc, qa, Ks, kk, lane);
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        if (kk < groups - 1 || 16 * groups == N) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            m0[n] = fmaxf(m0[n], fmaxf(sc[n][e][0], sc[n][e][1]));
            m1[n] = fmaxf(m1[n], fmaxf(sc[n][e][2], sc[n][e][3]));
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (16 * kk + 8 * e + 2 * t4 + c < N) {
                m0[n] = fmaxf(m0[n], sc[n][e][c]);
                m1[n] = fmaxf(m1[n], sc[n][e][2 + c]);
              }
        }
      }
    }
  }

  __device__ static __forceinline__ void quad_max(float (&m0)[NI], float (&m1)[NI]) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        m0[n] = fmaxf(m0[n], __shfl_xor_sync(0xffffffffu, m0[n], off));
        m1[n] = fmaxf(m1[n], __shfl_xor_sync(0xffffffffu, m1[n], off));
      }
  }

  // p = exp(s - max) (0 past N), each lane's row sums over the key tiles in
  // ascending order, P rounded and packed as attn_pack_p packs it; quad_sum
  // joins the quad's sums
  __device__ static __forceinline__ void exps(P& p, float (&l0)[NI], float (&l1)[NI], S& held,
                                              const float (&m0)[NI], const float (&m1)[NI],
                                              const Q& qa, const bf16* const (&Ks)[NI], int N,
                                              int lane) {
    const int t4 = lane & 3, groups = (N + 15) / 16;
#pragma unroll
    for (int n = 0; n < NI; ++n) l0[n] = l1[n] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (kk >= groups) break;
      float(&sc)[NI][2][4] = held[PASSES == 1 ? kk : 0];
      if (PASSES == 2) scores(sc, qa, Ks, kk, lane);
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        if (kk < groups - 1 || 16 * groups == N) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              sc[n][e][c] = expf(sc[n][e][c] - m0[n]);
              sc[n][e][2 + c] = expf(sc[n][e][2 + c] - m1[n]);
              l0[n] += sc[n][e][c];
              l1[n] += sc[n][e][2 + c];
            }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const bool valid = 16 * kk + 8 * e + 2 * t4 + c < N;
              sc[n][e][c] = valid ? expf(sc[n][e][c] - m0[n]) : 0.f;
              sc[n][e][2 + c] = valid ? expf(sc[n][e][2 + c] - m1[n]) : 0.f;
              l0[n] += sc[n][e][c];
              l1[n] += sc[n][e][2 + c];
            }
        }
        p[n][kk][0] = pack_bf16x2(sc[n][0][0], sc[n][0][1]);
        p[n][kk][1] = pack_bf16x2(sc[n][0][2], sc[n][0][3]);
        p[n][kk][2] = pack_bf16x2(sc[n][1][0], sc[n][1][1]);
        p[n][kk][3] = pack_bf16x2(sc[n][1][2], sc[n][1][3]);
      }
    }
  }

  __device__ static __forceinline__ void quad_sum(float (&l0)[NI], float (&l1)[NI]) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        l0[n] += __shfl_xor_sync(0xffffffffu, l0[n], off);
        l1[n] += __shfl_xor_sync(0xffffffffu, l1[n], off);
      }
  }

  // O = P V of each image over the keys below N
  __device__ static __forceinline__ void pv(O& oacc, const P& p, const bf16* const (&Vs)[NI], int N,
                                            int lane) {
    const int groups = (N + 15) / 16;
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
        oacc[n][d][0] = oacc[n][d][1] = oacc[n][d][2] = oacc[n][d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (kk >= groups) break;
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp)
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          uint32_t vb[4];
          ldsm_x4_t(vb, Vs[n] + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + dp * 16 +
                            (lane >> 4) * 8);
          mma_bf16_16816(oacc[n][2 * dp], p[n][kk], vb[0], vb[1]);
          mma_bf16_16816(oacc[n][2 * dp + 1], p[n][kk], vb[2], vb[3]);
        }
    }
  }

  // 1/sum on one image's P V output (rounded once to bf16), rows q0 + g and
  // q0 + g + 8 below N; orow is row q0 + g's output at the head's column
  // 2 t4
  __device__ static __forceinline__ void store(const float (&oacc)[DH / 8][4], float l0, float l1,
                                               bf16* orow, int q0, int N, int D, int lane) {
    const int g = lane >> 2;
    const float r0 = 1.0f / l0, r1 = 1.0f / l1;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      if (q0 + g < N) store_pair(orow + 8 * d, oacc[d][0] * r0, oacc[d][1] * r0);
      if (q0 + g + 8 < N)
        store_pair(orow + (size_t)8 * D + 8 * d, oacc[d][2] * r1, oacc[d][3] * r1);
    }
  }
};

}  // namespace tile
