"""The C bindings of the port's kernels, on the CPU: ``ops/build.py``'s
ctypes table against the entry points the CUDA sources declare (a table
that drifts from a changed C signature cuts pointers silently on the
card), K12-K14's launch plan at every head_dim and every N up to 2048, and
K2's and K15's at every width they take.
"""
from __future__ import annotations

import ctypes
import re

import pytest

from mfvit_tpu_torch.ops import (attention, build, fused_attn, fused_block,
                                 fused_mlp)

_DECL = re.compile(r"MFV_API\s+int\s+(mfv_\w+)\s*\(([^)]*)\)", re.S)
_CTYPE = {"void**": ctypes.POINTER(ctypes.c_void_p), "int": ctypes.c_int,
          "float": ctypes.c_float}


def _declared() -> dict:
    """name -> the C argument types, one per argument, of every ``MFV_API
    int mfv_*(...)`` in csrc/*.cu."""
    out = {}
    for src in build.sources():
        if src.suffix != ".cu":
            continue
        for name, args in _DECL.findall(src.read_text()):
            types = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                ptrs = arg.count("*")
                base = re.sub(r"\bconst\b", "", arg.replace("*", " ")).split()
                types.append("void*" if ptrs == 1 else
                             "void**" if ptrs == 2 else base[0])
            assert name not in out, f"{name} declared twice"
            out[name] = types
    return out


DECLARED = _declared()


def test_every_entry_point_has_a_ctypes_signature():
    """The same entry points on both sides (mfv_error_string, which
    returns a string, is bound on its own)."""
    assert set(DECLARED) == set(build.SIGNATURES)
    assert "mfv_error_string" not in build.SIGNATURES


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_ctypes_signature_matches_the_c_declaration(name):
    """Argument by argument: c_void_p for each pointer, c_int for each int,
    c_float for each float, POINTER(c_void_p) for a void**."""
    want = [ctypes.c_void_p if t == "void*" else _CTYPE[t]
            for t in DECLARED[name]]
    assert build.SIGNATURES[name] == want


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_mhsa_plan_fits_at_every_length(dh, transposed):
    """Every N from 1 to 2048 gets a plan within a block's shared memory on
    an H100: at most 8 warps a block with the producer, a region a query
    tile that holds its staged output tile and, where the scores are held,
    its 16 rows' fp32 scores; at most one idle query tile a unit; and
    K12's choice to hold the scores equal to K14's, since it sets the
    order of the row sums."""
    ring = attention.STAGES * (dh * attention.RAW if transposed
                               else attention.KB * (dh + 8)) * 2
    out = dh * attention.OT * 2 if transposed else 16 * (dh + 8) * 2
    for n in range(1, 2049):
        plan = attention._plan(n, dh, transposed)
        tiles = -(-n // 16)
        units = -(-tiles // plan.tiles)
        assert 1 <= plan.tiles <= attention.WARPS_MAX - 1
        assert plan.smem <= attention.SMEM_MAX, (n, plan)
        assert plan.smem == ring + attention.BAR + plan.tiles * plan.region
        assert plan.region % 16 == 0 and plan.region >= out, (n, plan)
        assert not plan.hold or plan.region >= -(-n // 8) * 512, (n, plan)
        assert units * plan.tiles - tiles < units, (n, plan)
        assert plan.hold == attention._plan(n, dh, not transposed).hold


def test_mhsa_plan_at_the_main_shapes():
    """vit_small at 224 px (N=197): the scores held, 13 query tiles as
    units of 7, two blocks an SM; at 384 px (N=577), the scores computed
    three times, units of 7 tiles; and the longest N that holds its scores
    at head_dim 32 is 376."""
    p = attention._plan(197, 32, False)
    assert (p.tiles, p.region, p.hold) == (7, 12800, True)
    assert 2 * (p.smem + 1024) <= attention.SMEM_SM
    p = attention._plan(577, 32, False)
    assert (p.tiles, p.hold) == (7, False)
    assert attention._plan(376, 32, True).hold
    assert not attention._plan(377, 32, True).hold


_SM90 = (build.CSRC / "gemm_sm90.cuh").read_text()
_TAIL = (build.CSRC / "block_tail.cuh").read_text()
_ATTN = (build.CSRC / "fused_attn.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


def test_k15_plan_constants_are_the_c_sources():
    """ops/fused_mlp.py's copy of the constants that size the block tail's
    launch (K2's and K15's) equals the CUDA sources' (a drift would plan
    shared memory the kernel lays out otherwise)."""
    fm = fused_mlp
    assert fm.CONSUMER_REGS == _const(_SM90, "CONSUMER_REGS")
    assert fm.PRODUCER_REGS == _const(_SM90, "PRODUCER_REGS")
    assert fm.GEMM_SMEM == (
        _const(_SM90, "GEMM_STAGES") * (_const(_SM90, "GEMM_BM")
                                        + _const(_SM90, "GEMM_BN")) * 128
        + 2 * _const(_SM90, "GEMM_STAGES") * 8 + 1024)
    assert fm.TAIL_ROWS == _const(_TAIL, "TAIL_ROWS")
    assert fm.THREADS == _const(_TAIL, "TAIL_THREADS") \
        == _const(_SM90, "GEMM_THREADS")
    assert fm.HC == _const(_TAIL, "TAIL_HC")
    assert fm.TILE64 == 64 * 128 and fm.STAGE == 2 * 64 * 128


def test_k2_plan_constants_are_the_c_sources():
    """K2's routes as the C sources take them: the tail's widths are the
    cases of block_tail.cuh's launch_tail_d, the three-launch widths the
    LayerNorm pass's other widths (ln1_takes), and K1 takes every width
    that pass takes."""
    tail = set(map(int, re.findall(
        r"case (\d+): return launch_tail<\d+, PROJ, FINAL>", _TAIL)))
    ln1 = set(map(int, re.findall(r"D == (\d+)", re.search(
        r"ln1_takes\(int D\) \{([^}]*)\}", _TAIL).group(1))))
    assert tail == set(fused_mlp.TAIL_WIDTHS)
    assert ln1 - tail == set(fused_mlp.WIDE_WIDTHS)
    assert ln1 == set(fused_attn.K1_WIDTHS)
    assert "ln1_takes(D)" in _ATTN


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_k15_plan_fits_at_every_width(D, dh):
    """K15's tail (K2's at the same width) at every D it takes (hidden 4D)
    and every head_dim: the ring holds at least 3 stages and the block fits
    a block's shared memory on an H100, as does the qkv GEMM's; the
    accumulators a consumer thread holds at once (fc2's D/4 and one fc1
    chunk's 32) leave 64 registers under setmaxnreg's 232, and the two
    consumer warpgroups at 232 and the producer's at 40 fit the SM's 65,536
    registers and the 255 a thread."""
    fm = fused_mlp
    plan = fused_block._plan(D, 4 * D, dh)
    assert plan == fm._plan(D, 4 * D) and plan.route == "tail"
    assert 3 <= plan.stages <= fm.STAGES_MAX
    assert plan.smem == fm._smem(D, plan.stages) <= fm.SMEM_MAX
    assert plan.stages == fm.STAGES_MAX or \
        fm._smem(D, plan.stages + 1) > fm.SMEM_MAX
    assert fm.GEMM_SMEM <= fm.SMEM_MAX
    assert plan.acc_regs == D // 4 + 32
    assert plan.acc_regs + 64 <= fm.CONSUMER_REGS <= 255
    assert (2 * 128 * fm.CONSUMER_REGS + 128 * fm.PRODUCER_REGS) <= 65536


@pytest.mark.parametrize("hidden", [1, 2, 4])
@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_k2_plan_fits_at_every_width(D, hidden):
    """K2 runs one launch of the block tail at D <= 512, at any hidden
    width that is a multiple of 128: the ring as deep as the shared memory
    beside the tiles allows, which does not depend on the hidden width."""
    plan = fused_mlp._plan(D, hidden * D)
    assert plan.route == "tail"
    assert plan == fused_mlp._plan(D, 4 * D)
    assert plan.smem <= fused_mlp.SMEM_MAX and plan.stages >= 3


@pytest.mark.parametrize("D", [768])
def test_k2_takes_the_three_launch_route_past_512(D):
    """At ViT-B's width fc2's fp32 output tile does not fit the registers
    of two warpgroups (D/4 a thread), so K2 runs three launches on the GEMM
    core: no ring of the tail's."""
    plan = fused_mlp._plan(D, 4 * D)
    assert plan.route == "gemm" and plan.stages == 0
    assert plan.smem == fused_mlp.GEMM_SMEM


@pytest.mark.parametrize("D,Hd", [(640, 2560), (1024, 4096), (64, 256),
                                  (384, 1500), (768, 3000), (384, 0)])
def test_k2_plan_refuses_what_the_kernels_do_not_take(D, Hd):
    with pytest.raises(ValueError, match="K2"):
        fused_mlp._plan(D, Hd)


@pytest.mark.parametrize("D,Hd,dh", [(768, 3072, 64), (640, 2560, 64),
                                     (384, 1500, 32), (384, 1536, 48)])
def test_k15_plan_refuses_what_the_kernel_does_not_take(D, Hd, dh):
    with pytest.raises(ValueError, match="K15"):
        fused_block._plan(D, Hd, dh)
