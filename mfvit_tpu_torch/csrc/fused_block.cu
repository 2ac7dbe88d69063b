// K15: one whole ViT block, replacing mfvit_tpu/ops/fused_block.py::
// fused_transformer_block (Pallas _block_kernel :36):
//
//   x2  = x + bf16(o . Wproj^T + bproj),  o = MHSA(LN1(x))   (K1's half)
//   out = x2 + bf16(GELU(LN2(x2) . W1^T + b1) . W2^T + b2)    (K2's half)
//
// The TPU kernel keeps x2 in VMEM between the halves. Here one image's
// qkv (197 x 1152 bf16 at ViT-S, 443 KiB) does not fit a block's 227 KiB
// of shared memory, so the attention core stays K1's. Four launches on one
// stream, through the caller's (M, D) bf16 scratch o and (M, 3D) qkv; the
// first three are K1's (fused_attn.cu):
//
// 1. block_tail.cuh's ln1_kernel: LN1(x) rounded to bf16 into o;
// 2. the qkv GEMM with its bias on the wgmma core of gemm_sm90.cuh;
// 3. K1's attention core (attn_async.cu), qkv -> o;
// 4. block_tail.cuh's tail_kernel with its proj stage: everything after the
//    attention core, with x2 and the (M, 4D) hidden on chip (the notes in
//    that header say how, and what bounds it).
//
// Every rounding point and every fp32 sum order is K1's and K2's, so K15
// equals the K1 -> K2 chain bit for bit. What did not pay in the tail
// (PERF.md): a 2-block cluster sharing each weight stage by TMA multicast
// (half the L2 reads, 2 % slower in the same call), a deeper ring (no gain
// past 5 stages), fc2 of one chunk interleaved with the GELU of the next
// (slower), two 64-row boxes a stage in place of one 128-row box (the
// same). ops/fused_block.py::_plan sizes the ring (stages); D > 512 is
// refused.
#include "attn_async.cuh"
#include "block_tail.cuh"

MFV_API int mfv_fused_transformer_block(const void* x, const void* ln1_s, const void* ln1_b,
                                        const void* wqkv, const void* bqkv, const void* wproj,
                                        const void* bproj, const void* ln2_s, const void* ln2_b,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, void* qkv, void* o, void* out, int B,
                                        int N, int D, int heads, int Hd, int stages, float scale,
                                        void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0 || D % heads != 0 || Hd <= 0 || Hd % blk::TAIL_HC != 0)
    return (int)cudaErrorInvalidValue;
  if (D != 128 && D != 256 && D != 384 && D != 512) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  if (int e = blk::launch_ln1(x, ln1_s, ln1_b, o, M, D, s)) return e;
  if (int e = sm90::gemm<EPI_BIAS>(o, wqkv, bqkv, nullptr, qkv, M, 3 * D, D, s)) return e;
  if (int e = attn_async<bf16>(qkv, o, B, N, heads, D / heads, scale, s)) return e;
  blk::TailParams t;
  t.x = static_cast<const bf16*>(x);
  t.bproj = static_cast<const float*>(bproj);
  t.ln2_s = static_cast<const float*>(ln2_s);
  t.ln2_b = static_cast<const float*>(ln2_b);
  t.b1 = static_cast<const float*>(b1);
  t.b2 = static_cast<const float*>(b2);
  t.out = static_cast<bf16*>(out);
  t.M = M;
  t.Hd = Hd;
  t.stages = stages;
  return blk::launch_tail_d<true>(t, D, o, wproj, w1, w2, s);
}
