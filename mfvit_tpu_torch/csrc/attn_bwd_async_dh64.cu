// K5's attention-backward core (attn_bwd_async.cuh) at head_dim 64, in a
// translation unit of its own so that the builds of the head_dims run in
// parallel.
#include "attn_bwd_async.cuh"

int attn_bwd::attn_bwd_async_dh64(const void* qkv, const void* dout, void* o, void* dqkv, int B,
                                  int N, int heads, float scale, cudaStream_t s) {
  return launch_async_n<64>(qkv, dout, o, dqkv, B, N, heads, scale, s);
}
