// T5's staged core (attn_bwd_staged.cuh) and its former design
// (attn_bwd_staged_former.cuh) at head_dim 32, in a translation unit of its
// own so that the builds of the head_dims run in parallel.
#include "attn_bwd_staged.cuh"
#include "attn_bwd_staged_former.cuh"

int attn_bwd::staged_dh32(const void* qkv, const void* dout, void* o, void* dqkv, int B,
                            int N, int heads, float scale, int cb, cudaStream_t s) {
  return staged::launch_n<32>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
}

int attn_bwd::staged_former_dh32(const void* qkv, const void* dout, void* o, void* dqkv, int B,
                                   int N, int heads, float scale, int cb, cudaStream_t s) {
  return staged_former::launch_n<32>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
}
