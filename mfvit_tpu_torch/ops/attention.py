"""K12, K13 and K14: fused multi-head self-attention on its own, the port of
``mfvit_tpu/ops/attention.py``, and the 1-query CLS cross-attention.

- K12 ``mhsa_packed(qkv, heads, scale)``: packed qkv (B, N, 3D), columns
  [q | k | v] x head x dh, -> (B, N, D); replaces ``mhsa_packed`` (Pallas
  ``_packed_attn_kernel`` :181, ``pallas_call`` :236). ``mhsa_from_packed``
  (:403) dispatches to it: the attention of every block of a
  ``quantize_vit_params`` ViT (``nn/vit.py``).
- K13 ``mhsa(q, k, v, scale=None)``: (B, H, N, dh) -> (B, H, N, dh), the
  scale 1/sqrt(dh) by default; replaces ``mhsa`` (``_fused_attn_kernel``
  :78, ``pallas_call`` :152).
- K14 ``mhsa_packed_t(qkv_t, heads, scale)``: transposed packed qkv (B, 3D,
  N) -> (B, D, N); replaces ``mhsa_packed_t`` (``_packed_attn_kernel_t``
  :295, ``pallas_call`` :346).

On a CUDA tensor each launches its hand-written kernel (csrc/mhsa.cu over
csrc/mhsa.cuh: bf16, head_dim 32/64/128, any N) or raises ValueError; on a
CPU tensor (or with ``plain=True``) it runs its plain version, which
rounds where the TPU kernels do and is the reference the kernels are held
to on the card: fp32 scores of the unscaled products, times the scale in
fp32; the row max and p = exp(s - max) in fp32; P normalised before it is
rounded to v's dtype, p / sum (K12, K14) or p * (1 / sum) (K13's
``pl.reciprocal(approx=False)``); PV with fp32 sums, one rounding. This is
not K1's core (``fused_attn.attn_core_plain``), which pre-scales q and
applies 1/sum to the PV output. For K12 it is also the XLA route's math
(``mhsa_from_packed`` :410-418, whose softmax normalises before the cast).

Each is a ``torch.autograd.Function`` whose backward is the JAX package's
(``_mhsa_pallas_bwd`` :109, ``_mhsa_packed_bwd`` :260,
``_mhsa_packed_t_bwd`` :369): an fp32 softmax recompute in plain PyTorch on
both devices, since no Pallas kernel backs it.

``cross_attention_1q`` (:423-437) is an XLA einsum in JAX with no Pallas
kernel, so it has no kernel here either.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mfvit_tpu_torch.ops import launch

LAUNCHES = {"mhsa_packed": 0, "mhsa": 0, "mhsa_packed_t": 0}


def _attn_plain(q, k, v, scale: float, recip: bool = False) -> torch.Tensor:
    """(B, H, N, dh) -> (B, H, N, dh) in q's dtype, the TPU kernels'
    rounding points (module docstring)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    total = p.sum(-1, keepdim=True)
    p = p * (1.0 / total) if recip else p / total
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def _attn_bwd_f32(q, k, v, g, scale: float):
    """The fp32 recompute backward of softmax(q k^T * scale) v for the
    cotangent g, all (B, H, N, dh): (dq, dk, dv) in fp32."""
    q, k, v, g = (t.float() for t in (q, k, v, g))
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, -1)
    dv = p.transpose(-1, -2) @ g
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale, dv


def _to_heads(t, heads: int, transposed: bool) -> torch.Tensor:
    """(B, N, D), or (B, D, N) if ``transposed``, -> a (B, H, N, dh) view."""
    if transposed:
        B, D, N = t.shape
        return t.reshape(B, heads, D // heads, N).transpose(-1, -2)
    B, N, D = t.shape
    return t.reshape(B, N, heads, D // heads).transpose(1, 2)


def _from_heads(t, transposed: bool) -> torch.Tensor:
    """The inverse of ``_to_heads``."""
    B, H, N, dh = t.shape
    if transposed:
        return t.transpose(-1, -2).reshape(B, H * dh, N)
    return t.transpose(1, 2).reshape(B, N, H * dh)


def _split(qkv, heads: int, transposed: bool):
    """Packed qkv, (B, N, 3D) or (B, 3D, N) -> q, k, v (B, H, N, dh)."""
    axis = 1 if transposed else 2
    return [_to_heads(t, heads, transposed)
            for t in qkv.split(qkv.shape[axis] // 3, dim=axis)]


def mhsa_packed_plain(qkv, heads: int, scale: float) -> torch.Tensor:
    """K12's plain version: (B, N, 3D) -> (B, N, D)."""
    return _from_heads(_attn_plain(*_split(qkv, heads, False), scale), False)


def mhsa_plain(q, k, v, scale: float) -> torch.Tensor:
    """K13's plain version: (B, H, N, dh) -> (B, H, N, dh)."""
    return _attn_plain(q, k, v, scale, recip=True)


def mhsa_packed_t_plain(qkv_t, heads: int, scale: float) -> torch.Tensor:
    """K14's plain version: (B, 3D, N) -> (B, D, N)."""
    return _from_heads(_attn_plain(*_split(qkv_t, heads, True), scale), True)


def _check_dims(heads: int, dh: int, N: int, what: str) -> None:
    if dh not in (32, 64, 128) or N < 1 or heads < 1:
        raise ValueError(f"the {what} kernel takes head_dim 32/64/128 and "
                         f"N >= 1; got head_dim={dh}, heads={heads}, N={N}")


# csrc/mhsa.cuh's constants: the most warps a block (the producer included),
# the rows of a staged tile, the ring's depth, the pitch of K14's raw rows
# and of its staged output, the bytes of the ring's barriers, and the
# shared memory a block can take on an H100 (an SM has 228 KB, less 1 KB a
# block)
WARPS_MAX, KB, STAGES, RAW, OT, BAR = 8, 64, 4, 72, 24, 64
SMEM_MAX, SMEM_SM = 232448, 233472


class Plan(NamedTuple):
    """A launch of K12-K14's core: ``tiles`` query tiles of 16 rows a
    unit, one warp each; ``region`` bytes of shared memory a tile;
    ``smem`` bytes a block; and whether a tile's scores are held there
    until the row sum is known (``hold``), or computed three times (row
    max, row sum, P V)."""
    tiles: int
    region: int
    smem: int
    hold: bool


def _ring(dh: int, transposed: bool) -> int:
    """Bytes of the ring and its barriers: a slot holds 64 token rows of
    dh, or for K14 dh raw rows of 64 tokens (realigned in place)."""
    return STAGES * (dh * RAW if transposed else KB * (dh + 8)) * 2 + BAR


def _region(N: int, dh: int, hold: bool, transposed: bool) -> int:
    """A query tile's shared memory (mhsa.cuh's region_bytes): ``hold``,
    its 16 rows' fp32 scores (64 bytes a key, in 8-key tiles); and at least
    its staged output tile."""
    out = dh * OT * 2 if transposed else 16 * (dh + 8) * 2
    return max(-(-N // 8) * 32 * 16 if hold else 0, out)


def _rooms(dh: int, transposed: bool) -> tuple:
    """The shared memory for the tiles' regions beside the ring: with two
    blocks an SM, and with one."""
    ring = _ring(dh, transposed)
    return SMEM_SM // 2 - 1024 - ring, SMEM_MAX - ring


def _plan(N: int, dh: int, transposed: bool) -> Plan:
    """The plan for sequence length N at head_dim ``dh`` (``transposed``:
    K14, which also stages raw rows). Scores are held while four query
    tiles' fit the room for two blocks an SM in K14's layout (N <= 376 at
    head_dim 32); past that the units would hold too few rows, each reading
    all of K and V, and the scores are computed three times instead. K12
    and K13 decide the same way: it sets the order of the row sums and so
    K12's bits, which K14's must equal. Query tiles a unit: as many as the
    room and the block's warps leave, split evenly over the fewest units
    (at N=197, 13 tiles as units of 7 and 6 rather than 7 and 7, or 4, 4, 4
    and 1)."""
    room2 = _rooms(dh, True)[0]
    hold = room2 >= 4 * _region(N, dh, True, True)
    region = _region(N, dh, hold, transposed)
    tiles = -(-N // 16)
    consumers = WARPS_MAX - 1  # and the producer warp
    for room in _rooms(dh, transposed):
        rmax = min(consumers, room // region)
        if rmax >= 1:
            r = -(-tiles // -(-tiles // rmax))
            return Plan(r, region, _ring(dh, transposed) + r * region, hold)
    raise AssertionError(f"no plan for N={N}, head_dim={dh}")


def _core_args(N: int, dh: int, transposed: bool) -> tuple:
    """(tiles, hold) for the C entry points."""
    plan = _plan(N, dh, transposed)
    return plan.tiles, int(plan.hold)


def _packed_cuda(t, heads: int, scale: float, transposed: bool):
    """K12 on qkv (B, N, 3D), or K14 on qkv_t (B, 3D, N) if ``transposed``."""
    entry = "mhsa_packed_t" if transposed else "mhsa_packed"
    B, N, three_d = (t.shape[0], t.shape[2], t.shape[1]) if transposed \
        else t.shape
    if three_d % (3 * heads):
        raise ValueError(f"{entry}: {three_d} features are not 3 x {heads} "
                         "heads")
    D = three_d // 3
    _check_dims(heads, D // heads, N, entry)
    launch.require(t, torch.bfloat16, "qkv")
    out = torch.empty((B, D, N) if transposed else (B, N, D),
                      dtype=torch.bfloat16, device=t.device)
    launch.call(f"mfv_{entry}", t.device, t, out, B, N, heads, D // heads,
                *_core_args(N, D // heads, transposed),
                scale)
    LAUNCHES[entry] += 1
    return out


def _mhsa_cuda(q, k, v, scale: float):
    B, H, N, dh = q.shape
    _check_dims(H, dh, N, "mhsa")
    for name, t in (("q", q), ("k", k), ("v", v)):
        launch.require(t, torch.bfloat16, name, (B, H, N, dh))
    out = torch.empty_like(q)
    launch.call("mfv_mhsa", q.device, q, k, v, out, B, H, N, dh,
                *_core_args(N, dh, False), scale)
    LAUNCHES["mhsa"] += 1
    return out


class _MhsaPacked(torch.autograd.Function):
    """K12, or K14 if ``transposed``."""

    @staticmethod
    def forward(ctx, qkv, heads, scale, plain, transposed):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.scale, ctx.transposed = heads, scale, transposed
        if plain or not qkv.is_cuda:
            fn = mhsa_packed_t_plain if transposed else mhsa_packed_plain
            return fn(qkv, heads, scale)
        return _packed_cuda(qkv, heads, scale, transposed)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        tr = ctx.transposed
        grads = _attn_bwd_f32(*_split(qkv, ctx.heads, tr),
                              _to_heads(g, ctx.heads, tr), ctx.scale)
        dqkv = torch.cat([_from_heads(d, tr) for d in grads], 1 if tr else 2)
        return dqkv.to(qkv.dtype), None, None, None, None


class _Mhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, plain):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if plain or not q.is_cuda:
            return mhsa_plain(q, k, v, scale)
        return _mhsa_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        grads = _attn_bwd_f32(q, k, v, g, ctx.scale)
        return (*(d.to(t.dtype) for d, t in zip(grads, (q, k, v))), None,
                None)


def mhsa_packed(qkv: torch.Tensor, heads: int, scale: float,
                plain: bool = False) -> torch.Tensor:
    """K12: (B, N, 3D) -> (B, N, D). CPU tensors (and ``plain=True``) take
    the plain version; CUDA tensors the kernel (bf16, contiguous,
    head_dim 32/64/128, any N) or a ValueError."""
    return _MhsaPacked.apply(qkv, heads, scale, plain, False)


def mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: float | None = None, plain: bool = False) -> torch.Tensor:
    """K13: q, k, v (B, H, N, dh) -> (B, H, N, dh); ``scale`` defaults to
    1/sqrt(dh). CPU tensors (and ``plain=True``) take the plain version;
    CUDA tensors the kernel or a ValueError."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Mhsa.apply(q, k, v, scale, plain)


def mhsa_packed_t(qkv_t: torch.Tensor, heads: int, scale: float,
                  plain: bool = False) -> torch.Tensor:
    """K14: (B, 3D, N) -> (B, D, N). CPU tensors (and ``plain=True``) take
    the plain version; CUDA tensors the kernel or a ValueError."""
    return _MhsaPacked.apply(qkv_t, heads, scale, plain, True)


def mhsa_from_packed(qkv: torch.Tensor, heads: int, scale: float,
                     plain: bool = False) -> torch.Tensor:
    """Packed-qkv attention (B, N, 3D) -> (B, N, D), as the JAX
    dispatcher: K12 on a CUDA tensor, its plain version (the XLA route's
    math) on the CPU or with ``plain=True``."""
    return mhsa_packed(qkv, heads, scale, plain)


def cross_attention_1q(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float | None = None) -> torch.Tensor:
    """CLS-token cross-attention: q (B, H, 1, D), k/v (B, H, N, D) ->
    (B, H, 1, D) in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, -1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)
