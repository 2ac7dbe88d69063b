// T6 and T7, the MLP schedule variants of tools/bench_mlp3d.py, on K2's
// tail (block_tail.cuh's tail_kernel):
//
//   out = x + bf16(bf16(GELU_erf(LN(x) . W1^T + b1)) . W2^T + b2),
//
// K2's function with K2's rounding points and sum order, so each equals
// the K2 kernel (fused_mlp.cu) bit for bit.
//
// - T6 mlp3d replaces tools/bench_mlp3d.py::mlp3d (Pallas _mlp3d_kernel
//   :39, pallas_call :73). The TPU kernel's grid step owns cb images and
//   walks their rows flat (a tile may straddle two images) or image by
//   image (no tile crosses an image; each image ends in a ragged tile).
//   Here that walk is the tail's RUNS walk: a run is cb images (flat) or
//   one image, its rows in 64-row tiles; the unit of work is (run, tile),
//   and the grid is persistent, min(tiles, SMs) blocks, so cb no longer
//   sets how many SMs work.
// - T7 mlp3d_staged replaces mlp3d_staged (_mlp3d_staged_kernel :138,
//   pallas_call :176): T6's per-image walk with fc1 of the next hidden
//   chunk in flight while the GELU of this one runs (the TPU kernel's
//   "GEMM1 of the next before the GELU of this one"), the tail's OVERLAP
//   chunk loop. The overlap stops at the tile's edge: the next tile's
//   first fc1 starts after this tile's last GELU and its epilogue (taking
//   it earlier would need a second A tile).
//
// What bounds them on an H100: K2's GEMMs, 4 * M * D * Hd operations (119
// GFLOP at ViT-S B=256, 0.120 ms at the bf16 peak). Their tiles: K2's 788
// at B=256, N=197; T6 flat 896 / 832 / 800 at cb 2 / 4 / 8 (a ragged tile
// a run), per image and T7 1,024 (four a 197-row image). The rows past a
// run's end are loaded and computed (the next image's, or zeros past M by
// the 2-D tensor map) but never stored. ops/fused_mlp.py::_plan sizes T6's
// ring (K2's), ops/mlp_variants.py::_plan T7's beside its second hidden
// buffer; the walk (run, tiles) comes from ops/mlp_variants.py::row_walk.
// The first designs (mlp_tail.cuh's WMMA stage, a block per cb images) stay
// in mlp_variants.cu as check-only entries, mfv_mlp3d_wmma and
// mfv_mlp3d_staged_wmma.
#include "block_tail.cuh"

template <bool OVERLAP>
static int mlp_runs(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* out, int M, int D,
                    int Hd, int run, int tiles, int stages, void* stream) {
  blk::TailParams t = {};
  t.ln2_s = static_cast<const float*>(ln_s);
  t.ln2_b = static_cast<const float*>(ln_b);
  t.b1 = static_cast<const float*>(b1);
  t.b2 = static_cast<const float*>(b2);
  t.out = static_cast<bf16*>(out);
  t.M = M;
  t.Hd = Hd;
  t.stages = stages;
  t.run = run;
  t.tiles = tiles;
  return blk::launch_runs_d<OVERLAP>(t, D, x, w1, w2, static_cast<cudaStream_t>(stream));
}

// T6: run = cb * N rows (flat) or N (per image).
MFV_API int mfv_mlp3d(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, int M, int D,
                      int Hd, int run, int tiles, int stages, void* stream) {
  return mlp_runs<false>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, D, Hd, run, tiles, stages,
                         stream);
}

// T7: run = N.
MFV_API int mfv_mlp3d_staged(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* out, int M,
                             int D, int Hd, int run, int tiles, int stages, void* stream) {
  return mlp_runs<true>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, D, Hd, run, tiles, stages,
                        stream);
}
