// T3 mlp_pipe, the MLP schedule variant of tools/bench_pipelined.py::
// mlp_pipe (Pallas _mlp_kernel_pipe :43, pallas_call :96), on K2's tail
// (block_tail.cuh's tail_kernel):
//
//   out = x + bf16(bf16(GELU_erf(LN(x) . W1^T + b1)) . W2^T + b2),
//
// K2's function with K2's rounding points and sum order, so it equals the
// K2 kernel (fused_mlp.cu) bit for bit.
//
// The TPU kernel walks flat row tiles of tm rows, each in `splits`
// sub-tiles, and issues fc1 of sub-tile j + 1 before the GELU and fc2 of
// sub-tile j. Here a tile is tm rows a block and a sub-tile 64 rows, one
// wgmma m64 of one consumer warpgroup; (tm, splits) is one of
// - (128, 2): the tail's PIPE 2. Both warpgroups read each weight stage of
//   one 128-row tile, so the weight stream a row is half K2's, and they
//   ping-pong: one warpgroup's GELU runs under the other's fc2 and fc1;
// - (128, 1): PIPE 1, the same tile and stream in lockstep, the control
//   that tells the halved stream from the overlap;
// - (64, 1): K2's own tail over 64-row tiles, the control that tells both
//   from K2.
// The last tile is masked (rows past M load as zeros and are not stored;
// the TPU wrapper's zero padding is a layout, not part of the function).
//
// What bounds it on an H100: K2's GEMMs, 4 * M * D * Hd operations (119
// GFLOP at ViT-S B=256, 0.120 ms at the bf16 peak). On chip K2's tail is
// paced by its weight stream from L2 (2,359,296 bytes a 64-row tile at
// D=384, 1.86 GB a call at B=256): the 128-row tile streams half of that.
// At D = 512 fc2's D / 2 accumulators a thread do not fit the registers,
// so tm = 128 is refused there. ops/mlp_variants.py::pipe_plan sizes the
// ring; the first design (mma.sync, one block a row tile) stays in
// mlp_variants.cu as the check-only mfv_mlp_pipe_mma.
#include "block_tail.cuh"

MFV_API int mfv_mlp_pipe(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out, int M, int D,
                         int Hd, int tm, int splits, int stages, void* stream) {
  blk::TailParams t = {};
  t.x = static_cast<const bf16*>(x);
  t.ln2_s = static_cast<const float*>(ln_s);
  t.ln2_b = static_cast<const float*>(ln_b);
  t.b1 = static_cast<const float*>(b1);
  t.b2 = static_cast<const float*>(b2);
  t.out = static_cast<bf16*>(out);
  t.M = M;
  t.Hd = Hd;
  t.stages = stages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm == 64 && splits == 1) return blk::launch_tail_d<false>(t, D, x, nullptr, w1, w2, s);
  if (tm == 128 && splits == 1) return blk::launch_pipe_d<1>(t, D, x, w1, w2, s);
  if (tm == 128 && splits == 2) return blk::launch_pipe_d<2>(t, D, x, w1, w2, s);
  return (int)cudaErrorInvalidValue;
}
