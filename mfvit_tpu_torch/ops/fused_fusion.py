"""K4: the depth-1 MF-ViT CA fusion head, both directions, returning only
the two fused CLS rows (B, D) fp32.

Replaces ``mfvit_tpu/ops/fused_fusion.py::fused_fusion_cls`` (Pallas
``_kernel`` :85, ``_dir_cls`` :36). Per direction: LN (eps 1e-5) over
[own CLS, other stream's patches] -> packed k/v GEMM and the q GEMM on the
CLS row -> 1-query multi-head attention -> proj + bias -> CLS residual ->
LN (eps 1e-6) -> + tokens[:, 0].

On a CUDA tensor: per direction the LayerNorm row statistics and one
``gemm_ln`` (LN prologue, rows read through two pointers, fp32 k/v out) and one ``fusion_tail`` launch for
both directions (csrc/fused_fusion.cu over csrc/gemm_ln.cuh and
csrc/fusion_tail.cuh). On a CPU tensor: the plain version,
a port of the JAX ``_cls_xla`` math, which is also the reference on the
card. Any batch size and any head_dim go through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from mfvit_tpu_torch.nn.layers import layer_norm, linear_f32
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_fusion_cls": 0}


def flatten_layer(layer, dtype: torch.dtype):
    """One cross-attention layer (``models.fusion`` ModuleList [ca_s, ln_l,
    ca_l, ln_s]) -> the 16 flat operands, 's' direction first, as
    ``mfvit_tpu/ops/fused_fusion.py::_flatten_layer`` (:104). Matrices are
    torch Linear layout (out, in) in ``dtype``; wkv = [wk; wv] (2D, D);
    vectors stay fp32."""
    ca_s, ln_l, ca_l, ln_s = layer
    ops = []
    for pre, ln in ((ca_s, ln_s), (ca_l, ln_l)):
        ca = pre.fn
        wkv = torch.cat([ca.wk.weight, ca.wv.weight], 0)
        ops.extend([pre.norm.weight, pre.norm.bias,
                    ca.wq.weight.to(dtype), wkv.to(dtype).contiguous(),
                    ca.proj.weight.to(dtype), ca.proj.bias,
                    ln.weight, ln.bias])
    return tuple(ops)


def fused_fusion_cls_plain(tok_c, tok_e, flat, heads: int):
    """The K4 math in PyTorch (``_cls_xla``, fused_fusion.py:121): k/v, q,
    scores, softmax and proj sums in fp32, LN outputs and the attention
    output rounded to the token dtype."""
    B, N, D = tok_c.shape
    d = D // heads
    scale = d ** -0.5
    dt = tok_c.dtype

    def direction(own, other, lns5, lnb5, wq, wkv, wp, bp, lns6, lnb6):
        seq = torch.cat([own[:, :1], other[:, 1:]], 1)
        xn = layer_norm(seq, lns5, lnb5, 1e-5)
        kv = linear_f32(xn, wkv)                                 # (B, N, 2D)
        k = kv[..., :D].reshape(B, N, heads, d)
        v = kv[..., D:].reshape(B, N, heads, d)
        q = linear_f32(xn[:, 0], wq) * scale                     # (B, D)
        s = torch.einsum("bhd,bnhd->bhn", q.reshape(B, heads, d), k)
        p = torch.softmax(s, -1)
        o = torch.einsum("bhn,bnhd->bhd", p, v).reshape(B, D)
        y = linear_f32(o.to(dt), wp, bp)
        cal = own[:, 0].float() + y
        return own[:, 0].float() + layer_norm(cal, lns6, lnb6, 1e-6)

    return direction(tok_c, tok_e, *flat[:8]), direction(tok_e, tok_c,
                                                         *flat[8:])


def fused_fusion_cls(tok_c, tok_e, flat, heads: int):
    """K4. CPU tensors take the plain version; CUDA tensors the kernels
    (bf16 tokens and matrices) or a ValueError."""
    if not tok_c.is_cuda:
        return fused_fusion_cls_plain(tok_c, tok_e, flat, heads)
    B, N, D = tok_c.shape
    if D % heads or D % 64:
        raise ValueError(f"the K4 kernels take D % heads == 0 and "
                         f"D % 64 == 0; got D={D}, heads={heads}")
    bf16, f32 = torch.bfloat16, torch.float32
    launch.require(tok_c, bf16, "tok_c")
    launch.require(tok_e, bf16, "tok_e", (B, N, D))
    ws = []
    for lns5, lnb5, wq, wkv, wp, bp, lns6, lnb6 in (flat[:8], flat[8:]):
        launch.require(wq, bf16, "wq", (D, D))
        launch.require(wkv, bf16, "wkv", (2 * D, D))
        launch.require(wp, bf16, "wproj", (D, D))
        ws.append([launch.vec(lns5, D, "ln5_s"), launch.vec(lnb5, D, "ln5_b"),
                   wq, wkv, wp, launch.vec(bp, D, "bproj"),
                   launch.vec(lns6, D, "ln6_s"), launch.vec(lnb6, D, "ln6_b")])
    ptrs = [(ctypes.c_void_p * 8)(*(t.data_ptr() for t in w)) for w in ws]
    stats = torch.empty(B * N, 2, dtype=f32, device=tok_c.device)
    kv_s, kv_l = (torch.empty(B * N, 2 * D, dtype=f32, device=tok_c.device)
                  for _ in range(2))
    out_c, out_e = (torch.empty(B, D, dtype=f32, device=tok_c.device)
                    for _ in range(2))
    launch.call("mfv_fused_fusion_cls", tok_c.device, tok_c, tok_e, B, N, D,
                heads, (D // heads) ** -0.5, ptrs[0], ptrs[1], stats, kv_s,
                kv_l, out_c, out_e)
    LAUNCHES["fused_fusion_cls"] += 1
    return out_c, out_e
