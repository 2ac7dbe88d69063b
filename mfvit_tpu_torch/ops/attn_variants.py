"""T4: K1's function x + proj(MHSA(LN(x))) with the JAX harness's staged
schedule, ``attn_staged``, which replaces ``tools/bench_pipelined.py::
attn_staged`` (Pallas ``_attn_kernel_staged`` :118, ``pallas_call`` :179).

On a CUDA tensor it runs csrc/attn_staged.cu (whose notes say how it
stages the score products ahead of the softmax and PV across units, by
ping-pong between two warpgroups) or raises; it never falls back to the
plain version. The kernel equals the port's K1 kernel bit for bit. Its
plain version is K1's, ``fused_attention_block_plain``, run after the same
argument checks on both devices: K1's shapes (head_dim 32/64/128, D % 128
== 0, N <= 256), ``cb`` dividing B, and at head_dim 128 N <= 208 (two
warpgroups' K and V in shared memory).

Forward only, as the tool uses it (JAX defines no VJP): a tensor that
requires grad, with grad enabled, raises. Weights are in the torch Linear
layout, wqkv (3D, D) and wproj (D, D), and may be fp32 masters (cast
inside); vectors are fp32.
"""
from __future__ import annotations

import torch

from mfvit_tpu_torch.ops import fused_attn, launch
from mfvit_tpu_torch.ops.mlp_variants import check_forward_only

LAUNCHES = {"attn_staged": 0}

N_MAX_DH128 = 208  # two warpgroups' K and Vt at head_dim 128


def _check(x, heads: int, cb: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"attn_staged: x must be (B, N, D), got "
                         f"{tuple(x.shape)}")
    B, N, D = x.shape
    fused_attn._check(B, N, D, heads, "T4 attn_staged")
    if cb < 1 or B % cb:
        raise ValueError(f"attn_staged: cb={cb} must divide B={B} (a block "
                         "owns cb whole images)")
    if D // heads == 128 and N > N_MAX_DH128:
        raise ValueError(f"attn_staged: at head_dim 128 the kernel takes N "
                         f"<= {N_MAX_DH128} (two warpgroups' K and V in "
                         f"shared memory); got N={N}")


def attn_staged(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
                scale: float, cb: int = 2, plain: bool = False):
    """T4 forward: K1's function, the block's ``cb`` images staged."""
    check_forward_only("attn_staged", x, ln_s, ln_b, wqkv, bqkv, wproj,
                       bproj)
    _check(x, heads, cb)
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
    launch.call("mfv_attn_staged", dev, x, launch.vec(ln_s, D, "ln_s"),
                launch.vec(ln_b, D, "ln_b"), wqkv,
                launch.vec(bqkv, 3 * D, "bqkv"), wproj,
                launch.vec(bproj, D, "bproj"), stats, qkv, o, out, B, N, D,
                heads, cb, scale)
    LAUNCHES["attn_staged"] += 1
    return out
