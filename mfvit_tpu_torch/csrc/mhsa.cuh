// mhsa: the stand-alone multi-head self-attention kernels K12, K13 and K14
// (mfvit_tpu/ops/attention.py), one core over three layouts (mhsa.cu holds
// the entry points; mhsa_dh{32,64,128}.cu the instantiations):
//
//   K12 mhsa_packed    (_packed_attn_kernel :181, pallas_call :236)
//                      qkv (B, N, 3D) -> (B, N, D)
//   K13 mhsa           (_fused_attn_kernel :78, pallas_call :152)
//                      q, k, v (B, H, N, dh) -> (B, H, N, dh)
//   K14 mhsa_packed_t  (_packed_attn_kernel_t :295, pallas_call :346)
//                      qkv (B, 3D, N) -> (B, D, N)
//
// The TPU kernels' rounding points, which are not K1's (attn_core.cuh):
// scores are the fp32 sums of the unscaled bf16 products q k^T, then times
// the scale in fp32 (__fmul_rn: never contracted into the subtraction that
// follows); the row max over the valid keys; p = exp(s - max) in fp32; P is
// normalised BEFORE its bf16 rounding: p / sum by IEEE division (K12, K14),
// or p * (1 / sum) with a correctly rounded reciprocal (K13,
// pl.reciprocal(approx=False)); then PV with fp32 sums (mma.sync m16n8k16)
// and one rounding of the output to bf16. Keys past N get probability zero;
// query rows past N are computed on zeros and not stored.
//
// What bounds it on an H100: at vit_small (B=256, N=197, 12 heads of 32)
// K12 reads 116 MB and writes 39 MB (0.046 ms at 3.35 TB/s) for 15.3 GFLOP
// of q k^T and PV (0.015 ms at 989 TFLOP/s): bytes. In practice the CUDA
// cores: the rounding points ask for an accurate expf and a correctly
// rounded division for every valid score (119 M at N=197; 256 M at N=577,
// B=64, where the exps alone take the SFUs about 0.06 ms, above that
// shape's bytes bound of 0.034 ms), so the design keeps many warps busy
// with little else: tensor work by mma.sync m16n8k16 is enough (wgmma
// would save neither registers nor instructions on 16-row tiles).
//
// The design (chosen by ops/attention.py::_plan, which also sizes it):
// - Units: (query tiles, head, image), R tiles of 16 rows a unit, one
//   consumer warp a tile; R is chosen so that a head's tiles split evenly
//   over its units (N=197: 13 tiles as units of 7 and 6), consecutive
//   units of a head next to each other, so they find K and V in L2.
// - Persistent grid: as many blocks as fit the SMs at once, each walks its
//   units. One producer warp a block streams each unit's q tiles, then its
//   K and V tiles (64 rows each), into a ring of 4 shared-memory slots
//   by 16-byte cp.async, up to the ring's depth ahead of the consumers;
//   `full` and `empty` barriers in shared memory (one arrival a copying
//   lane, one a consumer warp) hand each slot over, so no warp waits for
//   another except for data: the next unit's q and K arrive while a unit
//   is computed.
// - Fragments by ldmatrix: q's A and K's B fragments from row-major tiles,
//   V's B fragment by ldmatrix.trans (no transposed copy).
// - Because P is normalised before it is rounded, PV needs the row max
//   and the row sum first. HOLD (short rows: while four tiles' scores fit
//   the room for two blocks an SM, N <= 376 at head_dim 32): each warp
//   keeps its tile's fp32 scores in shared memory in the mma accumulator
//   layout (one float4 a lane per 8-key tile: every access a
//   conflict-free 16-byte one), so each key is read once a unit and each
//   exp taken once: the scores and row max with the K tiles, one pass for
//   p = exp(s - max) and the row sum over the valid keys, then P V with
//   the V tiles. Longer rows would leave a unit too few rows, each unit
//   reading all of K and V again, so there the scores are computed three
//   times from the K tiles (row max, row sum, then p with its V tile),
//   with any number of rows in shared memory but a unit's staging.
// - exp and the division only for keys below N; a tile of keys all below
//   N takes a path with no masks; the division is div_rn (below), with
//   one reciprocal a row.
// - The output goes out through the warp's own shared memory as 16-byte
//   rows (K12, K13) or token-contiguous runs (K14).
// - K14's token-innermost layout: a head's rows of K^T are N tokens long,
//   so at odd N (197, 577) they are not 16-byte aligned and neither
//   ldmatrix nor a 16-byte copy can start at a token. But the head's dh x N
//   block is contiguous and 16-byte aligned, so the producer copies each
//   tile as the aligned 16-byte chunks around its rows (raw rows), and the
//   consumers shift them into aligned rows together (two chunks into one by
//   funnel shifts) before they use it. The tile is then dimension-major,
//   so each fragment takes the other ldmatrix (.trans for q and K, plain for
//   V) and comes out in the same registers: K12 and K14 run the same MMAs
//   on the same values and give the same bits.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace mhsa {

constexpr int WARPS_MAX = 8;  // warps a block, the producer included
constexpr int KB = 64;         // keys (or q rows) per staged tile
constexpr int STAGES = 4;       // ring depth (a deeper ring measured no faster)
constexpr int RAW = KB + 8;    // K14: bf16 pitch of a raw row (16-byte chunks around 64 tokens)
constexpr int OT = 24;         // K14: bf16 pitch of a head-dimension row of the staged output
constexpr int SMEM_MAX = 232448;

// Element (b, h, n, d) of q/k/v sits at b * ib + h * ih + n * ix + d
// (TRANS false) or b * ib + h * ih + d * ix + n (TRANS true); o likewise
// with ob, oh, ox.
struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long ib, ih, ix;
  long long ob, oh, ox;
  int N, heads, B;
  float scale;
};

enum Variant { PACKED = 0, BHND = 1, PACKED_T = 2 };  // K12, K13, K14

// The launch plan (ops/attention.py::_plan computes it; launch() checks
// it): R query tiles of 16 rows a unit, and whether a tile's scores are
// held in shared memory (`hold`).
struct Plan {
  int R, hold;
};

template <int DH>
struct Layout {
  static constexpr int LD = DH + 8;  // bf16 pitch of a staged token row
  static constexpr int LT = RAW;     // K14: bf16 pitch of a staged head-dimension row
  // bf16 of a ring slot: 64 token rows (K12, K13) or DH raw rows (K14)
  __host__ __device__ static constexpr int slot(bool trans) { return trans ? DH * RAW : KB * LD; }
  __host__ __device__ static constexpr size_t ring_bytes(bool trans) {
    return (size_t)STAGES * slot(trans) * sizeof(bf16);
  }
};

// x4 fragments of the logical 16 x 16 block at token nb, head dimension db
// of a staged tile: matrix m = lane / 8 covers tokens nb + NB(m) .. + 7
// and dimensions db + DB(m) .. + 7; `trans` is the ldmatrix K12's
// token-major tile takes. K14's tile is dimension-major, so it reads the
// same block with the other ldmatrix and gets the same registers.
template <int DH, bool TRANS>
__device__ __forceinline__ void frag(uint32_t (&r)[4], const bf16* tile, int nb, int db,
                                     bool trans) {
  const int i = threadIdx.x & 7;
  if (!TRANS) {
    const bf16* p = tile + (nb + i) * Layout<DH>::LD + db;
    if (trans) ldsm_x4_t(r, p); else ldsm_x4(r, p);
  } else {
    const bf16* p = tile + (db + i) * Layout<DH>::LT + nb;
    if (trans) ldsm_x4(r, p); else ldsm_x4_t(r, p);
  }
}

__device__ __forceinline__ float quad_max(float v) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float quad_min(float v) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// p / l rounded to nearest, the bits of __fdiv_rn, from r = __frcp_rn(l)
// (the row's reciprocal, once a row): q0 = p r is within 1.5 ulp of p / l;
// one correction q1 = q0 + (p - l q0) r, with the residual exact by the
// FMA, is within 1/2 ulp plus 2^-23 of an ulp, so faithful; and by
// Markstein's theorem (r within 1/2 ulp of 1/l, q1 within 1 ulp of p / l)
// the second correction rounds correctly. It holds with no underflow: here
// 1 <= l (the max key's own exp(0) is in the sum) and p <= 1; p = 0 gives
// 0, and a unit whose rows may hold a p in (0, 2^-60) takes the IEEE
// division.
__device__ __forceinline__ float div_rn(float p, float l, float r) {
  float q = __fmul_rn(p, r);
  q = __fmaf_rn(__fmaf_rn(-l, q, p), r, q);
  return __fmaf_rn(__fmaf_rn(-l, q, p), r, q);
}

// Start the copy of rows n0 .. n0 + KB - 1 of one head's q, k or v (`src`
// at element (b, h, 0, 0)) into a ring slot by 16-byte cp.async, one
// warp; rows past N zero. TRANS: into the slot's raw rows, one per head
// dimension, each the aligned 16-byte chunks that cover tokens n0 .. n0 +
// KB - 1 (the consumers realign them in place): the head's block starts
// 16-byte aligned, and a chunk that starts before the row's last needed
// token lies inside the tensor, whose end is aligned too.
template <int DH, bool TRANS>
__device__ __forceinline__ void issue_tile(const bf16* src, long long ix, int N, int n0,
                                           bf16* tile) {
  using L = Layout<DH>;
  const int lane = threadIdx.x & 31;
  if (!TRANS) {
    constexpr int CPR = DH / 8, RPI = 32 / CPR;  // 16-byte chunks a row, rows an iteration
    const int c = lane % CPR * 8;
    int r = lane / CPR;
    const bf16* from = src + (long long)(n0 + r) * ix + c;
    bf16* to = tile + r * L::LD + c;
#pragma unroll 4
    for (; r < KB; r += RPI, from += RPI * ix, to += RPI * L::LD)
      cp_async16_zfill(to, n0 + r < N ? from : src, n0 + r < N);
  } else {
    constexpr int CPR = RAW / 8;
    const int end = min(n0 + KB, N);
    for (int idx = lane; idx < DH * CPR; idx += 32) {
      const int d = idx / CPR, c = idx % CPR;
      const long long first = ((long long)d * ix + n0) & ~7LL;
      const long long at = first + 8 * c;
      const bool ok = at < (long long)d * ix + end;
      cp_async16_zfill(tile + d * RAW + 8 * c, ok ? src + at : src, ok);
    }
  }
}

// K14: a slot's raw rows made aligned in place: token n0 + n of head
// dimension d sits at raw[d][(d * ix + n0) % 8 + n] and moves to
// tile[d][n], 16 bytes at a time (two raw chunks shifted); tokens past N
// zero. One thread a row, the chunks in order, each read before it is
// written; thread t of T takes rows t, t + T, ...
template <int DH>
__device__ __forceinline__ void realign_tile(long long ix, int N, int n0, bf16* tile, int t,
                                             int T) {
  const int i8 = (int)(ix & 7);
  for (int d = t; d < DH; d += T) {
    const int sh = (d * i8 + n0) & 7;
    uint4* row = reinterpret_cast<uint4*>(tile + d * RAW);
    uint4 lo = row[0];
#pragma unroll
    for (int k = 0; k < KB / 8; ++k) {
      const uint4 hi = row[k + 1];
      uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      lo = hi;
      if (sh & 4) {
#pragma unroll
        for (int w = 0; w < 6; ++w) x[w] = x[w + 2];
      }
      if (sh & 2) {
#pragma unroll
        for (int w = 0; w < 5; ++w) x[w] = x[w + 1];
      }
      uint32_t y[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) y[w] = (sh & 1) ? __funnelshift_r(x[w], x[w + 1], 16) : x[w];
      const int valid = N - n0 - 8 * k;  // tokens of this chunk below N
      if (valid < 8) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (2 * w >= valid) y[w] = 0;
          else if (2 * w + 1 >= valid) y[w] &= 0xffffu;
        }
      }
      row[k] = make_uint4(y[0], y[1], y[2], y[3]);
    }
  }
}

// Bytes of the ring's barriers.
constexpr int BAR_BYTES = 2 * STAGES * 8;

// The bytes of shared memory a query tile takes at N: where its scores
// are held, its 16 rows' fp32 scores (one float4 a lane per 8-key tile);
// and at least its staged output tile.
template <int DH>
__host__ __device__ constexpr int region_bytes(int N, bool hold, bool trans) {
  const int scores = hold ? (N + 7) / 8 * 32 * 16 : 0;
  const int out = trans ? DH * OT * 2 : 16 * Layout<DH>::LD * 2;
  return scores > out ? scores : out;
}

// One core for K12, K13 and K14 (see the note at the top): R consumer
// warps, one a query tile, and one producer warp. HOLD:
// the scores wait in the tile's buffer for the row sum; else they are
// computed three times (row max, row sum, then P V).
template <int DH, bool TRANS, bool RECIP, bool HOLD>
__global__ void __launch_bounds__(WARPS_MAX * 32, DH == 128 ? 1 : 2) core(Args a, Plan pl) {
  using L = Layout<DH>;
  constexpr int DT = DH / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::ring_bytes(TRANS));  // [slot]
  uint64_t* empty = full + STAGES;                                           // [slot]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int R = pl.R;

  const int N = a.N;
  const int tiles = (N + 15) / 16;
  const int chunks = (tiles + R - 1) / R;
  const int units = chunks * a.heads * a.B;
  const int nq = (R + 3) / 4;        // q tiles a unit
  const int nk = (N + KB - 1) / KB;  // key tiles
  // a unit's items: its q tiles, then K's tiles; HOLD: then V's tiles;
  // else K's tiles again, then K's and V's in turns
  const int per_unit = nq + (HOLD ? 2 : 4) * nk;
  const int mine = units > (int)blockIdx.x ? (units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = mine * per_unit;  // items of this block's load sequence
  const int nt8 = (N + 7) / 8;        // 8-key tiles below N

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], R);
    }
  }
  __syncthreads();

  if (warp == R) {
    // The producer: each item into the next ring slot (K14: its raw rows)
    // once the consumers have released it.
    // item t of unit u: its source (q, k or v at (b, h, 0, 0)) and its
    // first row
    auto item = [&](int u, int t, const bf16*& src, int& n0) {
      const int hb = u / chunks;
      const long long off = (hb / a.heads) * a.ib + (hb % a.heads) * a.ih;
      if (t < nq) {
        src = a.q + off;
        n0 = (u % chunks) * R * 16 + t * KB;
        return;
      }
      t -= nq;
      const bool v = HOLD ? t >= nk : t >= 2 * nk && (t - 2 * nk) % 2 == 1;
      src = (v ? a.v : a.k) + off;
      n0 = (HOLD || t < 2 * nk ? t % nk : (t - 2 * nk) / 2) * KB;
    };
    for (int j = 0; j < total; ++j) {
      const int slot = j % STAGES;
      const bf16* src;
      int n0;
      item((int)blockIdx.x + j / per_unit * (int)gridDim.x, j % per_unit, src, n0);
      if (j >= STAGES) mbar_wait(&empty[slot], (j / STAGES + 1) & 1);
      issue_tile<DH, TRANS>(src, a.ix, N, n0, ring + slot * L::slot(TRANS));
      cp_async_arrive(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // The consumers: warp `warp` takes query tile `warp` of each unit.
  unsigned char* region =
      smem + L::ring_bytes(TRANS) + BAR_BYTES + (size_t)warp * region_bytes<DH>(N, HOLD, TRANS);
  float4* sc = reinterpret_cast<float4*>(region);  // HOLD: [8-key tile][lane]
  int j = 0;                                       // the next item
  // the next item's tile (K14: realigned in place by the consumers
  // together; n0, its first row)
  auto acquire = [&](int n0) -> const bf16* {
    const int slot = j % STAGES;
    mbar_wait(&full[slot], (j / STAGES) & 1);
    ++j;
    if (TRANS) {
      realign_tile<DH>(a.ix, N, n0, ring + slot * L::slot(TRANS), threadIdx.x, R * 32);
      asm volatile("bar.sync 1, %0;\n" ::"r"(R * 32) : "memory");
    }
    return ring + slot * L::slot(TRANS);
  };
  auto release = [&](int items) {  // the last `items` acquired
    __syncwarp();
    if (lane == 0)
      for (int i = items; i > 0; --i) mbar_arrive(&empty[(j - i) % STAGES]);
  };

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int c = u % chunks, h = (u / chunks) % a.heads, b = u / (chunks * a.heads);
    const int row0 = (c * R + warp) * 16;  // this warp's query tile
    const bool active = row0 < N;

    // q: A fragments of the unscaled bf16 q, rows row0 + (0..15)
    uint32_t qa[DH / 16][4];
    for (int t = 0; t < nq; ++t) {
      const bf16* tile = acquire(c * R * 16 + t * KB);
      const int r = warp * 16 - t * KB;
      if (active && r >= 0 && r < KB) {
#pragma unroll
        for (int kq = 0; kq < DH / 16; ++kq)
          frag<DH, TRANS>(qa[kq], tile, r + ((lane >> 3) & 1) * 8, kq * 16 + (lane >> 4) * 8,
                          false);
      }
      release(1);
    }

    // the scores of the 16-key group jp of a staged K tile, times the
    // scale: s[e] holds 8-key tile 2 jp + e, [0..1] row g, [2..3] row g + 8
    auto scores = [&](const bf16* tile, int jp, float (&s)[2][4]) {
#pragma unroll
      for (int e = 0; e < 2; ++e) s[e][0] = s[e][1] = s[e][2] = s[e][3] = 0.f;
#pragma unroll
      for (int kq = 0; kq < DH / 16; ++kq) {
        uint32_t kb[4];
        frag<DH, TRANS>(kb, tile, 16 * jp + (lane >> 4) * 8, kq * 16 + ((lane >> 3) & 1) * 8,
                        false);
        mma_bf16_16816(s[0], qa[kq], kb[0], kb[1]);
        mma_bf16_16816(s[1], qa[kq], kb[2], kb[3]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[e][q] = __fmul_rn(s[e][q], a.scale);
    };
    // whether key 8 jt + 2 t4 + c is below N (every key of a full 8-key tile)
    auto valid = [&](int jt, int cc) { return 8 * jt + 2 * t4 + cc < N; };
    // f(jp, edge) for each 16-key group of the key tile at k0 below N;
    // edge: the group may hold keys past N
    auto groups = [&](int k0, auto f) {
      if (k0 + KB <= N) {
#pragma unroll
        for (int jp = 0; jp < KB / 16; ++jp) f(jp, std::false_type{});
      } else {
#pragma unroll
        for (int jp = 0; jp < KB / 16; ++jp)
          if (k0 + 16 * jp < N) f(jp, std::true_type{});
      }
    };

    // the row max of rows g (m0) and g + 8 (m1) over the valid keys, and
    // the least (lo0, lo1)
    float m0 = -INFINITY, m1 = -INFINITY, lo0 = INFINITY, lo1 = INFINITY;
    auto fold_max = [&](const float (&s)[4], int jt, bool edge) {
      if (!edge || 8 * jt + 8 <= N) {
        m0 = fmaxf(m0, fmaxf(s[0], s[1]));
        m1 = fmaxf(m1, fmaxf(s[2], s[3]));
        lo0 = fminf(lo0, fminf(s[0], s[1]));
        lo1 = fminf(lo1, fminf(s[2], s[3]));
      } else {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          if (valid(jt, cc)) {
            m0 = fmaxf(m0, s[cc]);
            m1 = fmaxf(m1, s[2 + cc]);
            lo0 = fminf(lo0, s[cc]);
            lo1 = fminf(lo1, s[2 + cc]);
          }
      }
    };
    // p = exp(s - max) over the valid keys, 0 elsewhere
    auto exps = [&](float (&s)[4], int jt, bool edge) {
      if (!edge || 8 * jt + 8 <= N) {
        s[0] = expf(s[0] - m0);
        s[1] = expf(s[1] - m0);
        s[2] = expf(s[2] - m1);
        s[3] = expf(s[3] - m1);
      } else {
        const bool v0 = valid(jt, 0), v1 = valid(jt, 1);
        s[0] = v0 ? expf(s[0] - m0) : 0.f;
        s[1] = v1 ? expf(s[1] - m0) : 0.f;
        s[2] = v0 ? expf(s[2] - m1) : 0.f;
        s[3] = v1 ? expf(s[3] - m1) : 0.f;
      }
    };
    for (int t = 0; t < nk; ++t) {
      const bf16* tile = acquire(t * KB);
      const int k0 = t * KB;
      if (active)
        groups(k0, [&](int jp, auto edge) {
          float s[2][4];
          scores(tile, jp, s);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jt = k0 / 8 + 2 * jp + e;
            if (decltype(edge)::value && jt >= nt8) break;
            fold_max(s[e], jt, decltype(edge)::value);
            if (HOLD) sc[jt * 32 + lane] = make_float4(s[e][0], s[e][1], s[e][2], s[e][3]);
          }
        });
      release(1);
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    // div_rn holds unless some p lies in (0, 2^-60); p >= exp(-40) > 2^-60
    // wherever s - max >= -40, so a unit whose scores all are takes it
    const float span0 = quad_min(lo0) - m0, span1 = quad_min(lo1) - m1;
    const bool ieee = !RECIP && __any_sync(0xffffffffu, span0 < -40.f || span1 < -40.f);

    // the row sums of p (la, lc: row g; lb, ld: row g + 8)
    float la = 0.f, lb = 0.f, lc = 0.f, ld = 0.f;
    if (HOLD) {
      if (active) {
        const int full16 = N / 16;  // 16-key groups below N
        int P = 0;
#pragma unroll 2
        for (; P < full16; ++P)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float4 v = sc[(2 * P + e) * 32 + lane];
            float s[4] = {v.x, v.y, v.z, v.w};
            exps(s, 2 * P + e, false);
            (e ? lc : la) += s[0] + s[1];
            (e ? ld : lb) += s[2] + s[3];
            sc[(2 * P + e) * 32 + lane] = make_float4(s[0], s[1], s[2], s[3]);
          }
        for (int jt = 2 * P; jt < nt8; ++jt) {
          float4 v = sc[jt * 32 + lane];
          float s[4] = {v.x, v.y, v.z, v.w};
          exps(s, jt, true);
          la += s[0] + s[1];
          lb += s[2] + s[3];
          sc[jt * 32 + lane] = make_float4(s[0], s[1], s[2], s[3]);
        }
      }
    } else {
      for (int t = 0; t < nk; ++t) {
        const bf16* tile = acquire(t * KB);
        const int k0 = t * KB;
        if (active)
          groups(k0, [&](int jp, auto edge) {
            float s[2][4];
            scores(tile, jp, s);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jt = k0 / 8 + 2 * jp + e;
              if (decltype(edge)::value && jt >= nt8) break;
              exps(s[e], jt, decltype(edge)::value);
              (e ? lc : la) += s[e][0] + s[e][1];
              (e ? ld : lb) += s[e][2] + s[e][3];
            }
          });
        release(1);
      }
    }
    const float l0 = quad_sum(la + lc), l1 = quad_sum(lb + ld);
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);

    // O = P V, P normalised and rounded 16 keys at a time
    float o[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    // a 16-key group's p of rows g ([0, 1], [4, 5]) and g + 8 ([2, 3],
    // [6, 7]) normalised (by the IEEE division where `ieee`) and rounded,
    // then O += P V
    auto pv = [&](const bf16* vtile, int kk, float (&p)[8]) {
      if (RECIP) {
#pragma unroll
        for (int q = 0; q < 8; ++q) p[q] = __fmul_rn(p[q], (q & 2) ? r1 : r0);
      } else if (ieee) {
#pragma unroll
        for (int q = 0; q < 8; ++q) p[q] = __fdiv_rn(p[q], (q & 2) ? l1 : l0);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) p[q] = (q & 2) ? div_rn(p[q], l1, r1) : div_rn(p[q], l0, r0);
      }
      const uint32_t pa[4] = {pack_bf16x2(p[0], p[1]), pack_bf16x2(p[2], p[3]),
                              pack_bf16x2(p[4], p[5]), pack_bf16x2(p[6], p[7])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vb[4];
        frag<DH, TRANS>(vb, vtile, 16 * kk + ((lane >> 3) & 1) * 8, dp * 16 + (lane >> 4) * 8,
                        true);
        mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    };
    for (int t = 0; t < nk; ++t) {
      const bf16* ktile = HOLD ? nullptr : acquire(t * KB);
      const bf16* vtile = acquire(t * KB);
      const int k0 = t * KB;
      if (active)
        groups(k0, [&](int kk, auto edge) {
          const int jt = k0 / 8 + 2 * kk;
          float p[8];
          if (HOLD) {
            const float4 v = sc[jt * 32 + lane];
            const float4 w = !decltype(edge)::value || jt + 1 < nt8
                                 ? sc[(jt + 1) * 32 + lane]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
            p[4] = w.x, p[5] = w.y, p[6] = w.z, p[7] = w.w;
          } else {
            float s[2][4];
            scores(ktile, kk, s);
            exps(s[0], jt, decltype(edge)::value);
            if (!decltype(edge)::value || jt + 1 < nt8)
              exps(s[1], jt + 1, decltype(edge)::value);
            else
              s[1][0] = s[1][1] = s[1][2] = s[1][3] = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) p[q] = s[0][q], p[4 + q] = s[1][q];
          }
          pv(vtile, kk, p);
        });
      release(HOLD ? 1 : 2);
    }
    if (!active) continue;

    // the output rows, rounded once, through the warp's buffer
    bf16* ob = a.o + b * a.ob + h * a.oh;
    bf16* stg = reinterpret_cast<bf16*>(region);
    __syncwarp();
    if (!TRANS) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        *reinterpret_cast<uint32_t*>(stg + g * L::LD + 8 * d + 2 * t4) = pack_bf16x2(o[d][0], o[d][1]);
        *reinterpret_cast<uint32_t*>(stg + (g + 8) * L::LD + 8 * d + 2 * t4) =
            pack_bf16x2(o[d][2], o[d][3]);
      }
      __syncwarp();
      for (int idx = lane; idx < 16 * DT; idx += 32) {
        const int r = idx % 16, d = idx / 16;
        if (row0 + r < N)
          *reinterpret_cast<uint4*>(ob + (long long)(row0 + r) * a.ox + 8 * d) =
              *reinterpret_cast<const uint4*>(stg + r * L::LD + 8 * d);
      }
    } else {
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          stg[(8 * d + 2 * t4 + (e & 1)) * OT + g + 8 * (e >> 1)] = __float2bfloat16_rn(o[d][e]);
      __syncwarp();
      for (int idx = lane; idx < DH * 16; idx += 32) {
        const int dd = idx / 16, r = idx % 16;
        if (row0 + r < N) ob[(long long)dd * a.ox + row0 + r] = stg[dd * OT + r];
      }
    }
    __syncwarp();
  }
}

template <int DH, bool TRANS, bool RECIP>
static int launch(const Args& a, const Plan& pl, cudaStream_t stream) {
  const int threads = (pl.R + 1) * 32;
  if (pl.R < 1 || threads > WARPS_MAX * 32) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<DH>::ring_bytes(TRANS) + BAR_BYTES +
                      (size_t)pl.R * region_bytes<DH>(a.N, pl.hold, TRANS);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = pl.hold ? core<DH, TRANS, RECIP, true> : core<DH, TRANS, RECIP, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.N + 15) / 16;
  const long long units = (long long)((tiles + pl.R - 1) / pl.R) * a.heads * a.B;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the blocks that fit the card at once, for the last (device, block
  // shape) this instantiation was launched with
  static int last_dev = -1, last_threads = 0, last_hold = 0, last_blocks = 0;
  static size_t last_smem = 0;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if (dev != last_dev || threads != last_threads || smem != last_smem || pl.hold != last_hold) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
        cudaSuccess)
      return (int)e;
    last_dev = dev, last_threads = threads, last_smem = smem, last_hold = pl.hold;
    last_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  kern<<<(int)(units < last_blocks ? units : last_blocks), threads, smem, stream>>>(a, pl);
  return (int)cudaGetLastError();
}

template <int DH>
static int launch_variant(const Args& a, int variant, const Plan& pl, cudaStream_t s) {
  switch (variant) {
    case PACKED: return launch<DH, false, false>(a, pl, s);
    case BHND: return launch<DH, false, true>(a, pl, s);
    case PACKED_T: return launch<DH, true, false>(a, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}

// One translation unit per head_dim (mhsa_dh{32,64,128}.cu), so that the
// instantiations compile in parallel.
int run_dh32(const Args& a, int variant, const Plan& pl, cudaStream_t s);
int run_dh64(const Args& a, int variant, const Plan& pl, cudaStream_t s);
int run_dh128(const Args& a, int variant, const Plan& pl, cudaStream_t s);

static int run(const Args& a, int dh, int variant, const Plan& pl, cudaStream_t s) {
  if (a.B <= 0 || a.N <= 0 || a.heads <= 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return run_dh32(a, variant, pl, s);
    case 64: return run_dh64(a, variant, pl, s);
    case 128: return run_dh128(a, variant, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace mhsa
