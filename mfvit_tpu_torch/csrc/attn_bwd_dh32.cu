// K5's attention core (attn_bwd.cuh) at head_dim 32, in a translation
// unit of its own so that the builds of the head_dims run in parallel.
#include "attn_bwd.cuh"

int attn_bwd::attn_bwd_dh32(const void* qkv, const void* dout, void* o, void* dqkv, int B,
                             int N, int heads, float scale, cudaStream_t s) {
  return launch_n<32>(qkv, dout, o, dqkv, B, N, heads, scale, s);
}
