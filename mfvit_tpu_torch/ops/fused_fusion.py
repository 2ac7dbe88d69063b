"""K4: the depth-1 MF-ViT CA fusion head, both directions, returning only
the two fused CLS rows (B, D) fp32.

Replaces ``mfvit_tpu/ops/fused_fusion.py::fused_fusion_cls`` (Pallas
``_kernel`` :85, ``_dir_cls`` :36). Per direction: LN (eps 1e-5) over
[own CLS, other stream's patches] -> packed k/v GEMM and the q GEMM on the
CLS row -> 1-query multi-head attention -> proj + bias -> CLS residual ->
LN (eps 1e-6) -> + tokens[:, 0].

On a CUDA tensor: three launches (csrc/fused_fusion.cu) on the absorbed
form of the 1-query attention, s[h, n] = xn_n . u_h with u_h = W_k[:, h]
(scale q_h), and o_h = z_h . W_v[:, h] with z_h = sum_n p[h, n] xn_n:
per group of images the LN'd CLS row, q and u; per (image, direction)
one pass over the token rows (LN, scores, an online softmax and z, all on
chip); per group o, proj, the CLS residual and the outer LN. No (B*N, 2D)
k/v matrix reaches device memory, and every sum JAX takes in fp32 stays in
fp32. ``_check`` refuses what the kernels do not take.
``fused_fusion_cls_kv`` runs the design K4 had before (per direction the
LayerNorm row statistics and one ``gemm_ln`` writing k and v of every row
in fp32, then ``fusion_tail``; csrc/gemm_ln.cuh and csrc/fusion_tail.cuh)
for the card's checks only. On a CPU tensor: the plain version, a port of
the JAX ``_cls_xla`` math, which is also the reference on the card. Any
batch size and any N go through the kernel, and any head count whose
2 x heads x D fp32 vectors leave room for the pass's ring. The gradient
is that of the plain version, recomputed (``_FusionCls``).
"""
from __future__ import annotations

import ctypes

import torch

from mfvit_tpu_torch.nn.layers import layer_norm, linear_f32
from mfvit_tpu_torch.ops import launch

LAUNCHES = {"fused_fusion_cls": 0}

# csrc/fused_fusion.cu's constants: the threads of a block of the pass and
# of the first and last launch, the images a block of those takes; the rows
# a slot of the pass's two-slot ring (2 a warp); the shared memory a block
# can take on an H100
THREADS, GTHREADS, GROUP = 256, 512, 4
ROWS = 16
SMEM_MAX = 232448


def _pass_smem(D: int, heads: int) -> int:
    """fused_fusion.cu's pass_smem: the ring (2 x ROWS x D bf16), u and z
    (heads x D fp32 each), LN's scale and bias (D fp32 each), the scores
    (heads x ROWS fp32) and three fp32 numbers a head (running maximum and
    sum, the chunk's rescale)."""
    return 2 * ROWS * D * 2 + (2 * heads * D + 2 * D + heads * ROWS
                               + 3 * heads) * 4


def _group_smem(D: int) -> int:
    """fused_fusion.cu's group_smem: GROUP rows of D in bf16 and in fp32,
    and the first launch's partial u, one GROUP x D fp32 tile for each of
    its GTHREADS // (D / 8) row phases."""
    return GROUP * D * 6 + GTHREADS // (D // 8) * GROUP * D * 4


def _check(D: int, heads: int) -> None:
    """A ValueError for what the kernels do not take: D past 8 x GTHREADS
    (a column octet a thread in the first launch), or launches whose
    shared memory does not fit a block's."""
    if not (heads > 0 and 0 < D <= 8 * GTHREADS and D % heads == 0
            and D % 64 == 0 and _group_smem(D) <= SMEM_MAX
            and _pass_smem(D, heads) <= SMEM_MAX):
        raise ValueError(f"the K4 kernels take D % heads == 0, D % 64 == 0 "
                         f"and D <= {8 * GTHREADS}, with 2 x heads x D fp32 "
                         f"vectors and a {ROWS}-row ring in a block's shared "
                         f"memory; got D={D}, heads={heads}")


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


def _operands(tok_c, tok_e, flat, D: int):
    """The two directions' weight lists as the kernels take them (kept
    alive by the caller) and their pointer arrays."""
    bf16 = torch.bfloat16
    B, N, _ = tok_c.shape
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
    return ws, ptrs


def _fusion_cuda(tok_c, tok_e, flat, heads: int):
    """K4's three launches."""
    B, N, D = tok_c.shape
    _check(D, heads)
    f32, dev = torch.float32, tok_c.device
    ws, ptrs = _operands(tok_c, tok_e, flat, D)
    u, z = (torch.empty(2, B, heads, D, dtype=f32, device=dev)
            for _ in range(2))
    out_c, out_e = (torch.empty(B, D, dtype=f32, device=dev)
                    for _ in range(2))
    launch.call("mfv_fused_fusion_cls", dev, tok_c, tok_e, B, N, D, heads,
                (D // heads) ** -0.5, ptrs[0], ptrs[1], u, z, out_c, out_e)
    LAUNCHES["fused_fusion_cls"] += 1
    return out_c, out_e


def fused_fusion_cls_kv(tok_c, tok_e, flat, heads: int):
    """The design K4 had before its redesign (csrc/fused_fusion.cu's
    ``mfv_fused_fusion_cls_kv``: k and v of every row in an fp32 (B*N, 2D)
    scratch per direction, then ``fusion_tail``), forward only, on CUDA
    tensors: the comparator the card's checks hold K4 against. No op calls
    it, and it counts no launch."""
    B, N, D = tok_c.shape
    if D % heads or D % 64:
        raise ValueError(f"the former K4 kernels take D % heads == 0 and "
                         f"D % 64 == 0; got D={D}, heads={heads}")
    f32, dev = torch.float32, tok_c.device
    ws, ptrs = _operands(tok_c, tok_e, flat, D)
    stats = torch.empty(B * N, 2, dtype=f32, device=dev)
    kv_s, kv_l = (torch.empty(B * N, 2 * D, dtype=f32, device=dev)
                  for _ in range(2))
    out_c, out_e = (torch.empty(B, D, dtype=f32, device=dev)
                    for _ in range(2))
    launch.call("mfv_fused_fusion_cls_kv", dev, tok_c, tok_e, B, N, D,
                heads, (D // heads) ** -0.5, ptrs[0], ptrs[1], stats, kv_s,
                kv_l, out_c, out_e)
    return out_c, out_e


class _FusionCls(torch.autograd.Function):
    """K4 forward; backward by recomputing the plain version under
    autograd, as the JAX package differentiates ``_cls_xla`` with
    ``jax.vjp`` (fused_fusion.py:121): the TPU kernel has no backward."""

    @staticmethod
    def forward(ctx, heads, tok_c, tok_e, *flat):
        ctx.save_for_backward(tok_c, tok_e, *flat)
        ctx.heads = heads
        if not tok_c.is_cuda:
            return fused_fusion_cls_plain(tok_c, tok_e, flat, heads)
        return _fusion_cuda(tok_c, tok_e, flat, heads)

    @staticmethod
    def backward(ctx, g_c, g_e):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = fused_fusion_cls_plain(leaves[0], leaves[1], leaves[2:],
                                          ctx.heads)
        grads = torch.autograd.grad(outs, leaves, (g_c, g_e),
                                    allow_unused=True)
        return (None, *grads)


def fused_fusion_cls(tok_c, tok_e, flat, heads: int):
    """K4. CPU tensors take the plain version; CUDA tensors the kernels
    (bf16 tokens and matrices) or a ValueError. Differentiable on both
    devices."""
    return _FusionCls.apply(heads, tok_c, tok_e, *flat)
