"""The JAX harness's attention schedule variants, each computing a
function the port already has a kernel for, with another issue order:

- T4 ``attn_staged``, K1's forward with the staged softmax, replaces
  ``tools/bench_pipelined.py::attn_staged`` (Pallas
  ``_attn_kernel_staged`` :118, ``pallas_call`` :179): K1's four launches
  with the staged core of csrc/attn_staged.cu, a sibling of K1's
  asynchronous core whose blocks walk ``unit_walk``'s units through a
  two-slot ring, its consumer warps in two groups that ping-pong (one
  group's P V and q k^T beside the other's softmax; ``staged_fwd_plan``).
- T1 ``attn_pairs``, K1's forward with the score and PV products batched
  over image pairs, replaces ``tools/bench_attn_pairs.py::attn_pairs``
  (Pallas ``_attn_pairs_kernel`` :37, ``pallas_call`` :104): K1's four
  launches with the pair core of csrc/attn_pairs.cu, a sibling of K1's
  asynchronous core whose blocks walk ``unit_walk``'s units a pair of
  images at a time, a producer warp staging one head of both images of a
  pair into one ring slot, each consumer warp running its next tile's
  scores and softmax before its last tile's P V (``pairs_plan``; tiles of
  one image, or, as a trial setting, of both images of a pair with their
  MMA chains interleaved).
- T2 ``attn_rolling``, K1's forward with two images' scores live,
  replaces ``tools/bench_rolling.py::attn_rolling`` (Pallas
  ``_attn_kernel_rolling`` :35, ``pallas_call`` :94): K1's four launches
  with the rolling core of csrc/attn_rolling.cu, a sibling of K1's
  asynchronous core whose blocks walk ``unit_walk``'s units of one head of
  ``cb`` images through a two-slot ring (``rolling_plan``).
- T5 ``staged_bwd``, K5's backward with image b+1's recompute before image
  b's gradients, replaces ``tools/bench_bwd_staged.py::staged_bwd``
  (Pallas ``_staged_bwd_kernel`` :37, ``pallas_call`` :141): K5's launch
  chain (csrc/fused_attn_bwd.cu) with the staged core of
  csrc/attn_bwd_staged.cuh (K5's asynchronous core over ``unit_walk``'s
  units, each warp deferring a query tile's gradients past the next
  tile's recompute; ``staged_plan``), built per head_dim in
  csrc/attn_bwd_staged_dh{32,64,128}.cu.

``attn_staged_wmma``, ``attn_pairs_wmma``, ``attn_rolling_wmma`` and
``staged_bwd_former`` run T4's, T1's, T2's and T5's former designs (T4, T1
and T2 on K1's former WMMA chain, csrc/attn_staged_wmma.cu,
csrc/attn_pairs_wmma.cu and csrc/attn_rolling_wmma.cu; T5's ping-pong
core, csrc/attn_bwd_staged_former.cuh), for the card's checks only: no
tool calls them and they count no launch. T1's and T2's cores share
csrc/attn_tile.cuh's per-tile pieces.

On a CUDA tensor each runs its kernels (whose notes say how they order the
work) or raises; none falls back to the plain version. Each kernel equals
its base kernel, K1 or K5, bit for bit, and its plain version is the base
kernel's (``fused_attention_block_plain``, ``fused_attention_block_bwd_
plain``), run after the same argument checks on both devices: the base
kernel's shapes (head_dim 32/64/128, D % 128 == 0, N <= 256), ``cb``
dividing B (and even for T1, whose blocks take whole pairs), and at head_dim
128 N <= 208 (two images' K and V in one block's shared memory; T5's
deferred tile needs two slots of K5's ring).

The forward variants are forward only, as the tools use them (JAX defines
no VJP): a tensor that requires grad, with grad enabled, raises. T5 returns
K5's gradients, (dx, dln_s, dln_b, dwqkv, dbqkv, dwproj, dbproj), in the
torch layout. Weights are in the torch Linear layout, wqkv (3D, D) and
wproj (D, D), and may be fp32 masters (cast inside); vectors are fp32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mfvit_tpu_torch.ops import fused_attn, launch
from mfvit_tpu_torch.ops.mlp_variants import check_forward_only

LAUNCHES = {"attn_staged": 0, "attn_pairs": 0, "attn_rolling": 0,
            "staged_bwd": 0}

N_MAX_DH128 = 208  # T2, T4: two slots of K and V a block; T1: one pair
# slot of K and V; T5: two of K5's

# csrc/attn_rolling.cu's constants (T2's rolling core): the shared memory a
# block can take, the consumer warps a block (at most T of them take tiles)
# and the passes over the keys by head_dim, the key rows staged
SMEM_MAX = 232448
ROLL_WARPS = {32: 11, 64: 11, 128: 7}
ROLL_PASSES = {32: 2, 64: 2, 128: 1}
KEYS = fused_attn.BWD_KEYS  # 64, 128, 208 or 256, as K1's and K5's cores
# csrc/attn_bwd_staged.cuh's consumer warps (T5's staged core)
STAGED_WARPS = 7
# csrc/attn_staged.cu's warps a group (two groups) and passes over the keys
# by head_dim (T4's staged core)
STAGED_FWD_GROUP = {32: 7, 64: 7, 128: 7}
STAGED_FWD_PASSES = {32: 2, 64: 2, 128: 2}
# csrc/attn_pairs.cu's constants (T1's pair core) by head_dim: the consumer
# warps, the passes over the keys, the images a tile (2: pair tiles, both
# images' MMA chains interleaved; 1: one image's tile), and whether a
# tile's P V waits past the warp's next tile's softmax
PAIRS_WARPS = {32: 11, 64: 11, 128: 7}
PAIRS_PASSES = {32: 2, 64: 2, 128: 2}
PAIRS_IMAGES = {32: 1, 64: 1, 128: 1}
PAIRS_DEFER = True
# T1's pair slots in the order the C side tries them: (slots, parts an
# image: q, K and V, or K and V with q's fragments from device memory)
PAIRS_RINGS = ((2, 3), (2, 2), (1, 3), (1, 2))


class RollPlan(NamedTuple):
    """A launch of T2's rolling core at N tokens and head_dim dh: ``keys``
    rows staged of each part (zeros past N), ``q_staged`` whether a slot
    holds q beside K and V (else q's fragments come from device memory),
    ``slot_bytes`` of each of the ring's two slots, ``smem`` bytes a block,
    ``warps`` consumer warps, ``takers`` of them that take tiles (at most
    the T = ceil(N / 16) tiles of an image: a deferred tile holds its slot
    while the warp waits for the next image)."""
    keys: int
    q_staged: bool
    slot_bytes: int
    smem: int
    warps: int
    takers: int


def _two_slots(name: str, N: int, dh: int) -> tuple:
    """T2's and T4's ring: (keys, q_staged, slot bytes), two slots of q,
    K and V where they fit, else of K and V; the smallest ``keys`` that
    holds N."""
    if dh not in ROLL_WARPS or not 0 < N <= KEYS[-1]:
        raise ValueError(f"{name}: the kernel takes head_dim 32/64/128 "
                         f"and N <= {KEYS[-1]}; got head_dim {dh}, N={N}")
    keys = next(k for k in KEYS if N <= k)
    part = keys * (dh + 8) * 2
    q_staged = 2 * 3 * part + 4 * 8 <= SMEM_MAX
    slot = (3 if q_staged else 2) * part
    if 2 * slot + 4 * 8 > SMEM_MAX:
        raise ValueError(f"{name}: two slots of K and V pass a block's "
                         f"shared memory at head_dim {dh}, N={N}")
    return keys, q_staged, slot


def rolling_plan(N: int, dh: int) -> RollPlan:
    """RollCore's layout: two slots of q, K and V where they fit, else of
    K and V; the smallest ``keys`` that holds N. The C side computes the
    same from its template arguments; this copy checks what it takes."""
    keys, q_staged, slot = _two_slots("attn_rolling", N, dh)
    return RollPlan(keys, q_staged, slot, 2 * slot + 4 * 8, ROLL_WARPS[dh],
                    min(ROLL_WARPS[dh], -(-N // 16)))


class StagedFwdPlan(NamedTuple):
    """A launch of T4's staged core at N tokens and head_dim dh: T2's
    two-slot ring (``keys``, ``q_staged``, ``slot_bytes``, ``smem``),
    ``group`` warps in each of the two groups, ``takers`` of them in each
    that take tiles (at most (T + 1) // 2, T = ceil(N / 16) the tiles of an
    image: the P V an image's fill waits on lies at most 2 takers - 1 tiles
    before the waiting tile), ``passes`` over the keys."""
    keys: int
    q_staged: bool
    slot_bytes: int
    smem: int
    group: int
    takers: int
    passes: int


def staged_fwd_plan(N: int, dh: int) -> StagedFwdPlan:
    """StagedCore's layout (T2's ring) and its groups; refuses what T2's
    ring refuses (head_dim 128 past N = 208)."""
    keys, q_staged, slot = _two_slots("attn_staged", N, dh)
    g = STAGED_FWD_GROUP[dh]
    return StagedFwdPlan(keys, q_staged, slot, 2 * slot + 4 * 8, g,
                         min(g, (-(-N // 16) + 1) // 2),
                         STAGED_FWD_PASSES[dh])


class PairsPlan(NamedTuple):
    """A launch of T1's pair core at N tokens and head_dim dh: ``keys``
    rows staged of each part (zeros past N), ``slots`` pair slots in the
    ring, each holding one head of both images of a pair, ``q_staged``
    whether a slot holds q beside K and V (else q's fragments come from
    device memory), ``part_bytes`` of one image's q, K or V, ``slot_bytes``
    of a pair slot, ``smem`` bytes a block (the ring and its full and empty
    barriers), ``warps`` consumer warps, ``images`` a tile (2: pair tiles),
    ``takers`` of the warps that take tiles (at most the tiles of a pair,
    2T / images, T = ceil(N / 16): a deferred tile holds its slot while the
    warp waits for the next pair), ``passes`` over the keys and ``defer``
    whether a tile's P V waits past the next tile's softmax."""
    keys: int
    slots: int
    q_staged: bool
    part_bytes: int
    slot_bytes: int
    smem: int
    warps: int
    images: int
    takers: int
    passes: int
    defer: bool


def pair_ring_bytes(part: int, slots: int, parts: int) -> int:
    """A ring of ``slots`` pair slots of ``parts`` parts an image, each
    ``part`` bytes, and its full and empty barriers (csrc/attn_pairs.cu's
    ``pair_ring`` in bytes)."""
    return slots * 2 * parts * part + 2 * slots * 8


def pairs_plan(N: int, dh: int) -> PairsPlan:
    """PairCore's layout: the first of ``PAIRS_RINGS`` that fits a block's
    shared memory; the smallest ``keys`` that holds N. The C side computes
    the same from its template arguments; this copy checks what it
    takes."""
    if dh not in PAIRS_WARPS or not 0 < N <= KEYS[-1]:
        raise ValueError(f"attn_pairs: the kernel takes head_dim 32/64/128 "
                         f"and N <= {KEYS[-1]}; got head_dim {dh}, N={N}")
    keys = next(k for k in KEYS if N <= k)
    part = keys * (dh + 8) * 2
    fits = [(s, p) for s, p in PAIRS_RINGS
            if pair_ring_bytes(part, s, p) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"attn_pairs: one pair slot of K and V passes a "
                         f"block's shared memory at head_dim {dh}, N={N}")
    slots, parts = fits[0]
    images = PAIRS_IMAGES[dh]
    return PairsPlan(keys, slots, parts == 3, part, 2 * parts * part,
                     pair_ring_bytes(part, slots, parts), PAIRS_WARPS[dh],
                     images, min(PAIRS_WARPS[dh], 2 * -(-N // 16) // images),
                     PAIRS_PASSES[dh], PAIRS_DEFER)


def pair_walk(B: int, heads: int, cb: int, grid: int) -> list:
    """The image pairs each of ``grid`` persistent blocks takes in order
    in T1's pair core: ``unit_walk``'s images of each block, two at a time
    ((image a, image b, head); cb is even, so a pair never straddles two
    units)."""
    if cb % 2:
        raise ValueError(f"attn_pairs: cb={cb} must be even")
    return [[(blk[i][0], blk[i + 1][0], blk[i][1])
             for i in range(0, len(blk), 2)]
            for blk in unit_walk(B, heads, cb, grid)]


class StagedPlan(NamedTuple):
    """A launch of T5's staged core: K5's ring (``fused_attn._bwd_plan``:
    ``keys``, ``slots`` and as many statistics buffers, ``smem``),
    ``warps`` consumer warps, ``takers`` of them that take tasks: at most
    (slots - 1) * T, as a deferred query tile holds its stage while the
    warp waits for a stage up to slots - 1 later."""
    keys: int
    slots: int
    smem: int
    warps: int
    takers: int


def staged_plan(N: int, dh: int) -> StagedPlan:
    """T5's launch at N tokens and head_dim dh; refuses a one-slot ring
    (head_dim 128 past N = 208), where no tile could be deferred."""
    k5 = fused_attn._bwd_plan(N, dh)
    if k5.slots < 2:
        raise ValueError(f"staged_bwd: at head_dim {dh} the kernel takes N "
                         f"<= {N_MAX_DH128} (a deferred tile needs two "
                         f"slots of K5's ring); got N={N}")
    return StagedPlan(k5.keys, k5.slots, k5.smem, STAGED_WARPS,
                      min(STAGED_WARPS, (k5.slots - 1) * -(-N // 16)))


def unit_walk(B: int, heads: int, cb: int, grid: int) -> list:
    """The (image, head) pairs each of ``grid`` persistent blocks takes in
    order, in T2's and T5's cores: units of cb images of one head (unit u:
    images (u // heads) * cb ..., head u % heads), block bid taking units
    bid, bid + grid, ..., each unit's images in order."""
    units = B // cb * heads
    return [[(u // heads * cb + i, u % heads)
             for u in range(bid, units, grid) for i in range(cb)]
            for bid in range(grid)]


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


def _launch(entry, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads, scale,
            cb, stats=True):
    """A forward variant's chain through its C entry point, with the (M, 2)
    fp32 statistics scratch where the chain (K1's former one) takes it."""
    B, N, D = x.shape
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
    wqkv = wqkv.to(bf16).contiguous()
    wproj = wproj.to(bf16).contiguous()
    launch.require(wqkv, bf16, "wqkv", (3 * D, D))
    launch.require(wproj, bf16, "wproj", (D, D))
    dev = x.device
    scratch = ([torch.empty(B * N, 2, dtype=torch.float32, device=dev)]
               if stats else [])
    qkv = torch.empty(B, N, 3 * D, dtype=bf16, device=dev)
    o = torch.empty(B, N, D, dtype=bf16, device=dev)
    out = torch.empty_like(x)
    launch.call(entry, dev, x, launch.vec(ln_s, D, "ln_s"),
                launch.vec(ln_b, D, "ln_b"), wqkv,
                launch.vec(bqkv, 3 * D, "bqkv"), wproj,
                launch.vec(bproj, D, "bproj"), *scratch, qkv, o, out, B, N, D,
                heads, cb, scale)
    return out


def _forward(name, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads, scale,
             cb, plain, pairs=False):
    check_forward_only(name, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)
    _check(name, x, heads, cb, pairs)
    if plain or not x.is_cuda:
        return fused_attn.fused_attention_block_plain(
            x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads, scale)
    plans = {"attn_rolling": rolling_plan, "attn_staged": staged_fwd_plan,
             "attn_pairs": pairs_plan}
    k1_chain = name in plans
    if k1_chain:  # K1's LN pass and GEMMs, its own core
        B, N, D = x.shape
        if D not in fused_attn.K1_WIDTHS:
            raise ValueError(f"{name}: K1's chain takes D of 128, 256, 384, "
                             f"512 or 768; got D={D}")
        plans[name](N, D // heads)
    out = _launch(f"mfv_{name}", x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                  heads, scale, cb, stats=not k1_chain)
    LAUNCHES[name] += 1
    return out


def attn_staged(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
                scale: float, cb: int = 2, plain: bool = False):
    """T4 forward: K1's function, the block's ``cb`` images staged."""
    return _forward("attn_staged", x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                    heads, scale, cb, plain)


def attn_staged_wmma(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
                     scale: float, cb: int = 2):
    """T4's former design (K1's former WMMA chain around two warpgroups in
    ping-pong over 64-row query units, csrc/attn_staged_wmma.cu), forward
    only, on CUDA tensors: the comparator the card's checks hold T4 against
    bit for bit. No tool calls it, and it counts no launch."""
    _check("attn_staged_wmma", x, heads, cb)
    return _launch("mfv_attn_staged_wmma", x, ln_s, ln_b, wqkv, bqkv, wproj,
                   bproj, heads, scale, cb)


def attn_pairs(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
               scale: float, cb: int = 4, plain: bool = False):
    """T1 forward: K1's function, a block's ``cb`` images taken in pairs."""
    return _forward("attn_pairs", x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                    heads, scale, cb, plain, pairs=True)


def attn_pairs_wmma(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
                    scale: float, cb: int = 4):
    """T1's former design (K1's former WMMA chain around a core of eight
    warps that holds both images' K and a transposed V, csrc/
    attn_pairs_wmma.cu), forward only, on CUDA tensors: the comparator the
    card's checks hold T1 against bit for bit. No tool calls it, and it
    counts no launch."""
    _check("attn_pairs_wmma", x, heads, cb, pairs=True)
    return _launch("mfv_attn_pairs_wmma", x, ln_s, ln_b, wqkv, bqkv, wproj,
                   bproj, heads, scale, cb)


def attn_rolling(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
                 scale: float, cb: int = 8, plain: bool = False):
    """T2 forward: K1's function, a block's ``cb`` images rolled through
    two buffers."""
    return _forward("attn_rolling", x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                    heads, scale, cb, plain)


def attn_rolling_wmma(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads: int,
                      scale: float, cb: int = 8):
    """T2's former design (K1's former WMMA chain around a four-warp rolling
    core, csrc/attn_rolling_wmma.cu), forward only, on CUDA tensors: the
    comparator the card's checks hold T2 against bit for bit. No tool calls
    it, and it counts no launch."""
    _check("attn_rolling_wmma", x, heads, cb)
    return _launch("mfv_attn_rolling_wmma", x, ln_s, ln_b, wqkv, bqkv, wproj,
                   bproj, heads, scale, cb)


def staged_bwd(g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads: int,
               scale: float, cb: int = 2, plain: bool = False):
    """T5: K5's gradients of the attention half for the cotangent g, a
    block's units ``cb`` images of one head, staged; (dx, dln_s, dln_b,
    dwqkv, dbqkv, dwproj, dbproj), dx in x's dtype, the rest fp32 in the
    torch layout."""
    _check("staged_bwd", x, heads, cb)
    if g.shape != x.shape:
        raise ValueError(f"staged_bwd: g {tuple(g.shape)} must have x's "
                         f"shape {tuple(x.shape)}")
    if plain or not x.is_cuda:
        return fused_attn.fused_attention_block_bwd_plain(
            g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads, scale)
    staged_plan(x.shape[1], x.shape[2] // heads)
    out = fused_attn.bwd_cuda(g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads,
                              scale, cb)
    LAUNCHES["staged_bwd"] += 1
    return out


def staged_bwd_former(g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads: int,
                      scale: float, cb: int = 2):
    """T5's former design (K5's chain with the ping-pong staged core,
    csrc/attn_bwd_staged_former.cuh), on CUDA tensors: the comparator the
    card's checks hold T5 against bit for bit. No tool calls it, and it
    counts no launch."""
    _check("staged_bwd_former", x, heads, cb)
    return fused_attn.bwd_cuda(g, x, ln_s, ln_b, wqkv, bqkv, wproj, heads,
                               scale, cb, entry="mfv_staged_bwd_former")
