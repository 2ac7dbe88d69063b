// attn_async: the attention core of K1 (fused_attn.cu) and K15
// (fused_block.cu), between their qkv and proj GEMMs, and of K10
// (fused_int8.cu) at up to NMAX tokens, between its int8 GEMMs;
// attn_async.cu holds the kernel and says how it works.
#pragma once

#include "common.cuh"

// qkv (B, N, 3D) bf16, columns [q | k | v] x head x dh -> o (B, N, D) in
// OT (bf16 for K1 and K15, fp32 for K10) on stream s, with the rounding
// points of attn_core.cuh's core (attn_core<OT>'s bits); head_dim 32, 64
// or 128 and N <= NMAX, else cudaErrorInvalidValue.
template <typename OT>
int attn_async(const void* qkv, void* o, int B, int N, int heads, int dh, float scale,
               cudaStream_t s);
