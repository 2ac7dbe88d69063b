// attn_long_async: the long-sequence attention core of K9
// (fused_attn_large.cu), between its qkv and proj GEMMs, and of K10
// (fused_int8.cu) past NMAX tokens, between its int8 GEMMs;
// attn_long_async.cu holds the kernel and says how it works.
#pragma once

#include "common.cuh"

// The core's plan (ops/fused_attn.py::_long_plan copies it): keys (and
// query rows) a ring stage, consumer warps a block (one 16-row query tile
// each), ring stages, blocks an SM.
constexpr int LONG_KEYS = 64, LONG_W = 8, LONG_STAGES = 8;

// qkv (B, N, 3D) bf16, columns [q | k | v] x head x dh -> o (B, N, D) in
// OT (bf16 for K9, fp32 for K10) on stream s, with the rounding points and
// sum orders of attn_long.cuh's core (attn_long<OT>'s bits); head_dim 32,
// 64 or 128 and any N >= 1, else cudaErrorInvalidValue.
template <typename OT>
int attn_long_async(const void* qkv, void* o, int B, int N, int heads, int dh, float scale,
                    cudaStream_t s);
