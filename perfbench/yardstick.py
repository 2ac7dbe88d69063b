"""The benchmark's arithmetic: the H100's published peaks, the model's
FLOPs for ``mfu``, and each kernel's least time for its roofline share.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at its 700 W power
limit); a card set below that limit runs slower, so the harness prints the
card's ``power.limit`` beside every reading. A bound is the larger of the
function's bytes over the memory rate (each input read once, each output
written once) and its operations over their unit's peak (the largest over
the units, which run at once). Each product counts at the peak of the
operand precision that the function's plain version fixes, whatever unit
an implementation picks: a product of bf16 operands at the bf16 tensor
peak, one of fp32 operands at the fp32 peak (no TF32). Recomputation
inside a kernel is its own cost and is never counted.

Shapes: B images, N tokens, D width, H the MLP's hidden width, ``heads``.
"""
from __future__ import annotations

PEAK = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12,
        # exp on the special function units: 16 a clock on each of 132
        # SMs at the 1.98 GHz boost clock (Hopper white paper)
        "sfu": 132 * 16 * 1.98e9}
HBM_BYTES_PER_S = 3.35e12
BF16, FP32 = 2, 4


def bound(ops: dict, nbytes: float) -> tuple:
    """(least seconds, "operations" or "bytes")."""
    t_ops = max(n / PEAK[k] for k, n in ops.items())
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


# ------------------------------------------------------------ model FLOPs

def vit_forward_flops(cfg: dict, img: int) -> dict:
    """2 x the multiply-adds of one image through one branch, by part:
    the patch embedding, the blocks' linears and attention products, the
    head."""
    D, P, C = cfg["hidden_size"], cfg["patch_size"], cfg["num_channels"]
    H, K, L = cfg["intermediate_size"], cfg["num_classes"], \
        cfg["num_hidden_layers"]
    n = (img // P) ** 2
    N = n + 1
    block = (2 * N * D * 3 * D + 2 * N * D * D    # qkv, proj
             + 2 * 2 * N * N * D                  # q k^T and p v, all heads
             + 2 * 2 * N * D * H)                 # fc1, fc2
    return {"patch": 2 * n * P * P * C * D, "blocks": L * block,
            "head": 2 * D * K}


def fusion_head_flops(cfg: dict, img: int) -> int:
    """2 x the multiply-adds of the CA head for one pair, as the model
    defines it: per direction k and v over every row, q, the scores and
    p v of the one query, the out projection; the two heads."""
    D, K = cfg["hidden_size"], cfg["num_classes"]
    N = (img // cfg["patch_size"]) ** 2 + 1
    one = 2 * 2 * N * D * D + 2 * D * D + 2 * 2 * N * D + 2 * D * D
    return 2 * one + 2 * 2 * D * K


def serve_flops_per_pair(cfg: dict, img: int) -> float:
    return (2 * sum(vit_forward_flops(cfg, img).values())
            + fusion_head_flops(cfg, img))


def train_flops_per_sample(cfg: dict, img: int) -> float:
    """Forward and backward of the fusion step with every weight trained:
    the backward twice the forward, except the patch embedding, whose
    input (the images) needs no gradient."""
    v = vit_forward_flops(cfg, img)
    return 3 * serve_flops_per_pair(cfg, img) - 2 * v["patch"]


# --------------------------------------------------------- kernel bounds

def _attn_products(B, N, D):
    """2 x multiply-adds of one N x N x D product over all heads."""
    return 2 * B * N * N * D


def attn_fwd_bound(B: int, N: int, D: int, heads: int) -> tuple:
    """K1 / K9, x + proj(MHSA(LN(x))): qkv, q k^T, p v and proj with bf16
    operands (the plain version rounds h, qkv and p to bf16), one exp a
    score; x read and the output written in bf16, the weights in bf16."""
    M = B * N
    ops = {"bf16": 2 * M * D * 4 * D + 2 * _attn_products(B, N, D),
           "sfu": B * heads * N * N}
    nbytes = 2 * M * D * BF16 + 4 * D * D * BF16 + 6 * D * FP32
    return bound(ops, nbytes)


def mlp_fwd_bound(B: int, N: int, D: int, H: int) -> tuple:
    """K2 / K3, x + fc2(GELU(fc1(LN(x)))): fc1 and fc2 with bf16 operands;
    x read and the output written in bf16, the weights in bf16."""
    M = B * N
    nbytes = 2 * M * D * BF16 + 2 * D * H * BF16 + (H + 5 * D) * FP32
    return bound({"bf16": 4 * M * D * H}, nbytes)


def fusion_head_bound(B: int, N: int, D: int, heads: int) -> tuple:
    """K4, both directions of the CA head to the two fused CLS rows. Its
    least work takes the 1-query attention in the absorbed form
    (s = xn . W_k q, o = (p xn) . W_v): per image and direction the scores
    and p xn, 2 N D multiply-adds a head, and q, W_k q, W_v z, proj, D^2
    each; the plain version's row products take bf16 operands. Both
    token streams read once in bf16, the four matrices a direction in
    bf16, the two (B, D) fp32 rows written."""
    ops = {"bf16": 2 * B * (4 * N * D * heads + 8 * D * D)}
    nbytes = (2 * B * N * D * BF16 + 2 * 4 * D * D * BF16
              + 2 * B * D * FP32 + 2 * 6 * D * FP32)
    return bound(ops, nbytes)


def attn_bwd_bound(B: int, N: int, D: int, heads: int) -> tuple:
    """K5, the gradients of K1 from (g, x, weights): the qkv recompute,
    dO, dWqkv and dh with bf16 operands; q k^T, p v, dV, dP, dQ, dK with
    bf16 operands; dWproj = g^T o with fp32 operands (the plain version
    keeps o unrounded and g in fp32), at the fp32 peak. g and x read, dx
    written in bf16; the weights read in bf16, their gradients written in
    fp32."""
    M = B * N
    ops = {"bf16": (2 * M * D * 3 * D * 3 + 2 * M * D * D
                    + 6 * _attn_products(B, N, D)),
           "fp32": 2 * M * D * D}
    nbytes = (3 * M * D * BF16 + 4 * D * D * BF16 + 4 * D * D * FP32
              + 12 * D * FP32)
    return bound(ops, nbytes)


def mlp_bwd_bound(B: int, N: int, D: int, H: int) -> tuple:
    """K7, the gradients of K2 from (g, x, weights): the fc1 recompute,
    g W2, dW1, dW2 and dh1, all with bf16 operands. g and x read, dx
    written in bf16; the weights read in bf16, their gradients written in
    fp32."""
    M = B * N
    nbytes = (3 * M * D * BF16 + 2 * D * H * BF16 + 2 * D * H * FP32
              + (H + 5 * D) * FP32)
    return bound({"bf16": 5 * 2 * M * D * H}, nbytes)
