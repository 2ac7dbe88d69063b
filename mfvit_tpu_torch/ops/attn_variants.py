"""The JAX harness's attention schedule variants, each computing a
function the port already has a kernel for, with another issue order:

- T4 ``attn_staged``, K1's forward with the staged softmax, replaces
  ``tools/bench_pipelined.py::attn_staged`` (Pallas
  ``_attn_kernel_staged`` :118, ``pallas_call`` :179): csrc/attn_staged.cu.
- T1 ``attn_pairs``, K1's forward with the score and PV products batched
  over image pairs, replaces ``tools/bench_attn_pairs.py::attn_pairs``
  (Pallas ``_attn_pairs_kernel`` :37, ``pallas_call`` :104):
  csrc/attn_pairs.cu.
- T2 ``attn_rolling``, K1's forward with two images' scores live,
  replaces ``tools/bench_rolling.py::attn_rolling`` (Pallas
  ``_attn_kernel_rolling`` :35, ``pallas_call`` :94): csrc/attn_rolling.cu.
- T5 ``staged_bwd``, K5's backward with image b+1's recompute before image
  b's gradients, replaces ``tools/bench_bwd_staged.py::staged_bwd``
  (Pallas ``_staged_bwd_kernel`` :37, ``pallas_call`` :141): K5's launch
  chain (csrc/fused_attn_bwd.cu) with the staged core of
  csrc/attn_bwd_staged.cuh (built per head_dim in
  csrc/attn_bwd_staged_dh{32,64,128}.cu).

On a CUDA tensor each runs its kernels (whose notes say how they order the
work) or raises; none falls back to the plain version. Each kernel equals
its base kernel, K1 or K5, bit for bit, and its plain version is the base
kernel's (``fused_attention_block_plain``, ``fused_attention_block_bwd_
plain``), run after the same argument checks on both devices: the base
kernel's shapes (head_dim 32/64/128, D % 128 == 0, N <= 256), ``cb``
dividing B (and even for T1, whose blocks take whole pairs), and at head_dim
128 N <= 208 (two images' K and V, or T5's two warpgroups' rows, in one
block's shared memory).

The forward variants are forward only, as the tools use them (JAX defines
no VJP): a tensor that requires grad, with grad enabled, raises. T5 returns
K5's gradients, (dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj), in the
torch layout. Weights are in the torch Linear layout, wqkv (3D, D) and
wproj (D, D), and may be fp32 masters (cast inside); vectors are fp32.
"""
from __future__ import annotations

import torch

from mfvit_tpu_torch.ops import fused_attn, launch
from mfvit_tpu_torch.ops.mlp_variants import check_forward_only

LAUNCHES = {"attn_staged": 0, "attn_pairs": 0, "attn_rolling": 0,
            "staged_bwd": 0}

N_MAX_DH128 = 208  # two images' K and Vt (T5: two images' rows) a block


def _check(name: str, x, heads: int, cb: int, pairs: bool = False) -> None:
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got "
                         f"{tuple(x.shape)}")
    B, N, D = x.shape
    fused_attn._check(B, N, D, heads, name)
    if cb < 1 or B % cb:
        raise ValueError(f"{name}: cb={cb} must divide B={B} (a block "
                         "owns cb whole images)")
    if pairs and cb % 2:
        raise ValueError(f"{name}: cb={cb} must be even (a block owns "
                         "cb / 2 image pairs)")
    if D // heads == 128 and N > N_MAX_DH128:
        raise ValueError(f"{name}: at head_dim 128 the kernel takes N "
                         f"<= {N_MAX_DH128} (two images' K and V in one "
                         f"block's shared memory); got N={N}")


def _forward(name, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads, scale,
             cb, plain, pairs=False):
    check_forward_only(name, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)
    _check(name, x, heads, cb, pairs)
    if plain or not x.is_cuda:
        return fused_attn.fused_attention_block_plain(
            x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads, scale)
    B, N, D = x.shape
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
    wqkv = wqkv.to(bf16).contiguous()
    wproj = wproj.to(bf16).contiguous()
    launch.require(wqkv, bf16, "wqkv", (3 * D, D))
    launch.require(wproj, bf16, "wproj", (D, D))
    dev = x.device
    stats = torch.empty(B * N, 2, dtype=torch.float32, device=dev)
    qkv = torch.empty(B, N, 3 * D, dtype=bf16, device=dev)
    o = torch.empty(B, N, D, dtype=bf16, device=dev)
    out = torch.empty_like(x)
    launch.call(f"mfv_{name}", dev, x, launch.vec(ln_s, D, "ln_s"),
                launch.vec(ln_b, D, "ln_b"), wqkv,
                launch.vec(bqkv, 3 * D, "bqkv"), wproj,
                launch.vec(bproj, D, "bproj"), stats, qkv, o, out, B, N, D,
                heads, cb, scale)
    LAUNCHES[name] += 1
    return out


def attn_staged(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
                scale: float, cb: int = 2, plain: bool = False):
    """T4 forward: K1's function, the block's ``cb`` images staged."""
    return _forward("attn_staged", x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                    heads, scale, cb, plain)


def attn_pairs(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
               scale: float, cb: int = 4, plain: bool = False):
    """T1 forward: K1's function, a block's ``cb`` images taken in pairs."""
    return _forward("attn_pairs", x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                    heads, scale, cb, plain, pairs=True)


def attn_rolling(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
                 scale: float, cb: int = 8, plain: bool = False):
    """T2 forward: K1's function, a block's ``cb`` images rolled through
    two buffers."""
    return _forward("attn_rolling", x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                    heads, scale, cb, plain)


def staged_bwd(g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads: int,
               scale: float, cb: int = 2, plain: bool = False):
    """T5: K5's gradients of the attention half for the cotangent g, a
    block's ``cb`` images staged; (dx, dln_s, dln_b, dwqkv, dbqkv, dwproj,
    dbproj), dx in x's dtype, the rest fp32 in the torch layout."""
    _check("staged_bwd", x, heads, cb)
    if g.shape != x.shape:
        raise ValueError(f"staged_bwd: g {tuple(g.shape)} must have x's "
                         f"shape {tuple(x.shape)}")
    if plain or not x.is_cuda:
        return fused_attn.fused_attention_block_bwd_plain(
            g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads, scale)
    out = fused_attn.bwd_cuda(g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads,
                              scale, cb)
    LAUNCHES["staged_bwd"] += 1
    return out
