"""T6, T7 and T3: the MLP schedule variants of the JAX harness's timing
tools, each K2's function x + fc2(GELU(fc1(LN(x)))) in another schedule.

- T6 ``mlp3d`` replaces ``tools/bench_mlp3d.py::mlp3d`` (Pallas
  ``_mlp3d_kernel`` :39, ``pallas_call`` :73): one launch with the hidden
  on chip, walking the rows of each group of ``cb`` images flat
  (``flat=True``: tiles may straddle images) or image by image.
- T7 ``mlp3d_staged`` replaces ``mlp3d_staged`` (``_mlp3d_staged_kernel``
  :138, ``pallas_call`` :176): T6's per-image tiles, fc1 of the next
  hidden chunk in flight while the GELU of this one runs.
- T3 ``mlp_pipe`` replaces ``tools/bench_pipelined.py::mlp_pipe``
  (``_mlp_kernel_pipe`` :43, ``pallas_call`` :96): flat row tiles of
  ``tm`` rows in ``splits`` sub-tiles, fc1 of sub-tile j+1 before the GELU
  and fc2 of sub-tile j, by software pipelining inside each warp.

On a CUDA tensor each runs its kernel or raises; it never falls back to
the plain version. T6 and T7 run csrc/mlp3d.cu, K2's persistent wgmma
tail (csrc/block_tail.cuh) over ``row_walk``'s (run, 64-row tile) units,
T7 with the tail's overlapped chunk loop and the ring ``_plan`` sizes
beside its second hidden buffer; T3 runs csrc/mlp_variants.cu. Those
notes say how each carries its schedule and what bounds it. The kernels
equal the port's K2 kernel bit for bit. ``mlp3d_wmma`` and
``mlp3d_staged_wmma`` run the first designs of T6 and T7 (a block per
``cb`` images on csrc/mlp_tail.cuh's WMMA stage, csrc/mlp_variants.cu),
for the card's checks only: no tool calls them and they count no launch.
The plain version of all three is K2's,
``fused_mlp_block_plain``, run after the same argument checks, which hold
on both devices:

- ``cb`` divides B (JAX's grid ``B // cb`` would leave the rest of the
  output unwritten);
- ``tm % splits == 0``; the tools' ``tm`` of 512 and 1024 are TPU VMEM
  sizes, so here ``tm`` is the rows a block owns and ``splits`` the
  sub-tiles it pipelines over: tm 32 or 64, splits 1, 2 or 4, sub-tiles
  of 16 rows or more;
- D is 128, 256, 384 or 512 and tm * D <= 64 * 384 (the fp32 output tile
  lives in registers), the hidden width a multiple of 128.

Forward only, as the tools use them (JAX defines no VJP): a tensor that
requires grad, with grad enabled, raises. Matrices are in the torch Linear
layout, w1 (Hd, D) and w2 (D, Hd), and may be fp32 masters (cast inside);
vectors are fp32. TPU layout choices are not ported: ``mlp_pipe``'s zero
padding of M to a multiple of ``tm`` becomes a masked last tile.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mfvit_tpu_torch.ops import fused_mlp as fm
from mfvit_tpu_torch.ops import launch
from mfvit_tpu_torch.ops.fused_mlp import fused_mlp_block_plain

LAUNCHES = {"mlp3d": 0, "mlp3d_staged": 0, "mlp_pipe": 0}

WIDTHS = (128, 256, 384, 512)     # the D the kernels are built for
TILE_ROWS = (32, 64)              # mlp_pipe's tm
SPLITS = (1, 2, 4)                # mlp_pipe's splits
MIN_SUB_ROWS = 16                 # one MMA row tile
REG_TILE = 64 * 384               # tm * D, the fp32 output tile in registers
# T7's fp32 accumulators a consumer thread may hold at once: setmaxnreg's
# CONSUMER_REGS less 40 for the addresses, the ring's phases and the GELU's
# temporaries (a limit, not a promise: ptxas still spills a few registers
# of T7 at D of 384 and 512, PERF.md)
ACC_BUDGET = fm.CONSUMER_REGS - 40


class Walk(NamedTuple):
    """T6's and T7's row walk (csrc/block_tail.cuh's RUNS): ``run`` rows a
    run (``cb`` images flat, else one image), ``per_run`` 64-row tiles a
    run (the last one ragged where 64 does not divide ``run``), ``tiles``
    in all; the wrapper passes ``run`` and ``tiles`` and the kernel's grid
    is min(tiles, SMs) blocks."""
    run: int
    per_run: int
    tiles: int


def row_walk(B: int, N: int, cb: int, flat: bool) -> Walk:
    """The walk over B images of N rows in groups of ``cb`` images."""
    run = cb * N if flat else N
    per_run = -(-run // fm.TAIL_ROWS)
    return Walk(run, per_run, B * N // run * per_run)


def tile_rows(walk: Walk, t: int) -> tuple:
    """(first row, rows stored) of tile t, as the kernel's walk takes it."""
    r, i = divmod(t, walk.per_run)
    return (r * walk.run + i * fm.TAIL_ROWS,
            min(fm.TAIL_ROWS, walk.run - i * fm.TAIL_ROWS))


def _smem(D: int, stages: int) -> int:
    """T7's shared memory: K2's tail (``fused_mlp._smem``) and the second
    hidden-chunk buffer (two 64-row swizzled slices)."""
    return fm._smem(D, stages) + 2 * fm.TILE64


def _plan(D: int, Hd: int) -> fm.Plan:
    """T7's launch at width D and hidden Hd: as many ring stages as the
    shared memory beside the tiles and both hidden buffers holds (at most
    STAGES_MAX); its consumer threads hold fc2's D/4 accumulators and two
    fc1 chunks' 32 each. The C side only checks it."""
    if D not in WIDTHS or Hd <= 0 or Hd % fm.HC:
        raise ValueError(f"mlp3d_staged: the kernel takes D in {WIDTHS} and "
                         f"hidden % {fm.HC} == 0; got D={D}, hidden={Hd}")
    stages = max(s for s in range(1, fm.STAGES_MAX + 1)
                 if _smem(D, s) <= fm.SMEM_MAX)
    return fm.Plan("tail", stages, _smem(D, stages), D // 4 + 64)


def check_forward_only(name: str, *tensors) -> None:
    """The variants have no backward: refuse to build a graph through them."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward only (the JAX tool defines no "
                           "VJP); call it under torch.no_grad() or on tensors "
                           "that do not require grad")


def _check_mlp(name: str, x, w1, cb: int | None = None) -> None:
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got {tuple(x.shape)}")
    B, _, D = x.shape
    Hd = w1.shape[0]
    if cb is not None and (cb < 1 or B % cb):
        raise ValueError(f"{name}: cb={cb} must divide B={B} (the walk takes "
                         "groups of cb whole images)")
    if D not in WIDTHS or Hd % 128:
        raise ValueError(f"{name}: the kernel takes D in {WIDTHS} (its fp32 "
                         "output tile lives in registers) and hidden % 128 "
                         f"== 0; got D={D}, hidden={Hd}")


def check_pipe(D: int, tm: int, splits: int) -> None:
    """mlp_pipe's tile arguments, on both devices."""
    if splits < 1 or tm % splits:
        raise ValueError(f"mlp_pipe: tm={tm} must be a multiple of "
                         f"splits={splits}")
    if (tm not in TILE_ROWS or splits not in SPLITS
            or tm // splits < MIN_SUB_ROWS or tm * D > REG_TILE):
        raise ValueError(
            f"mlp_pipe: the kernel takes tm in {TILE_ROWS} rows a block, "
            f"splits in {SPLITS} sub-tiles of >= {MIN_SUB_ROWS} rows, and "
            f"tm * D <= {REG_TILE} (its fp32 output tile lives in "
            f"registers); got tm={tm}, splits={splits}, D={D}")


def _args(x, ln_s, ln_b, w1, b1, w2, b2):
    """The kernels' operands: bf16 x and matrices, fp32 vectors."""
    B, N, D = x.shape
    Hd = w1.shape[0]
    bf16 = torch.bfloat16
    launch.require(x, bf16, "x")
    w1 = w1.to(bf16).contiguous()
    w2 = w2.to(bf16).contiguous()
    launch.require(w1, bf16, "w1", (Hd, D))
    launch.require(w2, bf16, "w2", (D, Hd))
    return (x, launch.vec(ln_s, D, "ln_s"), launch.vec(ln_b, D, "ln_b"), w1,
            launch.vec(b1, Hd, "b1"), w2, launch.vec(b2, D, "b2"),
            torch.empty_like(x))


def _runs(entry, x, ln_s, ln_b, w1, b1, w2, b2, walk: Walk,
          stages: int) -> torch.Tensor:
    """T6 or T7 on K2's tail over ``walk``."""
    B, N, D = x.shape
    a = _args(x, ln_s, ln_b, w1, b1, w2, b2)
    launch.call(entry, x.device, *a, B * N, D, w1.shape[0], walk.run,
                walk.tiles, stages)
    return a[-1]


def mlp3d(x, ln_s, ln_b, w1, b1, w2, b2, cb: int = 4, flat: bool = True,
          plain: bool = False) -> torch.Tensor:
    """T6: K2's function over the rows of each group of ``cb`` images,
    walked flat or image by image."""
    check_forward_only("mlp3d", x, ln_s, ln_b, w1, b1, w2, b2)
    _check_mlp("mlp3d", x, w1, cb)
    if plain or not x.is_cuda:
        return fused_mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2)
    B, N, D = x.shape
    out = _runs("mfv_mlp3d", x, ln_s, ln_b, w1, b1, w2, b2,
                row_walk(B, N, cb, flat), fm._plan(D, w1.shape[0]).stages)
    LAUNCHES["mlp3d"] += 1
    return out


def mlp3d_staged(x, ln_s, ln_b, w1, b1, w2, b2, cb: int = 4,
                 plain: bool = False) -> torch.Tensor:
    """T7: K2's function on per-image tiles, fc1 of the next hidden chunk
    in flight while the GELU of this one runs."""
    check_forward_only("mlp3d_staged", x, ln_s, ln_b, w1, b1, w2, b2)
    _check_mlp("mlp3d_staged", x, w1, cb)
    if plain or not x.is_cuda:
        return fused_mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2)
    B, N, D = x.shape
    out = _runs("mfv_mlp3d_staged", x, ln_s, ln_b, w1, b1, w2, b2,
                row_walk(B, N, cb, False), _plan(D, w1.shape[0]).stages)
    LAUNCHES["mlp3d_staged"] += 1
    return out


def mlp3d_wmma(x, ln_s, ln_b, w1, b1, w2, b2, cb: int = 4,
               flat: bool = True) -> torch.Tensor:
    """T6's first design (a block per ``cb`` images on csrc/mlp_tail.cuh's
    WMMA stage), forward only, on CUDA tensors: the comparator the card's
    checks hold T6 against bit for bit. No tool calls it, and it counts no
    launch."""
    _check_mlp("mlp3d_wmma", x, w1, cb)
    B, N, D = x.shape
    a = _args(x, ln_s, ln_b, w1, b1, w2, b2)
    launch.call("mfv_mlp3d_wmma", x.device, *a, B, N, D, w1.shape[0], cb,
                int(bool(flat)))
    return a[-1]


def mlp3d_staged_wmma(x, ln_s, ln_b, w1, b1, w2, b2,
                      cb: int = 4) -> torch.Tensor:
    """T7's first design (two warpgroups in ping-pong on per-image tiles of
    csrc/mlp_tail.cuh's WMMA stage), forward only, on CUDA tensors: the
    comparator the card's checks hold T7 against bit for bit. No tool
    calls it, and it counts no launch."""
    _check_mlp("mlp3d_staged_wmma", x, w1, cb)
    B, N, D = x.shape
    a = _args(x, ln_s, ln_b, w1, b1, w2, b2)
    launch.call("mfv_mlp3d_staged_wmma", x.device, *a, B, N, D, w1.shape[0],
                cb)
    return a[-1]


def mlp_pipe(x, ln_s, ln_b, w1, b1, w2, b2, splits: int = 2, tm: int = 64,
             plain: bool = False) -> torch.Tensor:
    """T3: K2's function over flat row tiles of ``tm`` rows, pipelined over
    ``splits`` sub-tiles."""
    check_forward_only("mlp_pipe", x, ln_s, ln_b, w1, b1, w2, b2)
    _check_mlp("mlp_pipe", x, w1)
    check_pipe(x.shape[-1], tm, splits)
    if plain or not x.is_cuda:
        return fused_mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2)
    B, N, D = x.shape
    a = _args(x, ln_s, ln_b, w1, b1, w2, b2)
    launch.call("mfv_mlp_pipe", x.device, *a, B * N, D, w1.shape[0], tm,
                splits)
    LAUNCHES["mlp_pipe"] += 1
    return a[-1]
