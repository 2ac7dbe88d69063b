"""K5's and K7's launches on the wgmma core, on the CPU: the C entry points
they add (the MN-major GEMM forms, the check-only former chains) against
``ops/build.py``'s ctypes table, the plans of K5's attention-backward core
and of K7's dual GEMM against the constants of the CUDA sources, what the
plans refuse, the K slices of the weight-gradient GEMMs (every token row
summed once, a slice's end inside a 64-row tile included), and the
check-only wrappers refusing CPU tensors. The card's tests
(``test_torch_port_cuda.py``) hold the kernels equal to their former
chains bit for bit.
"""
from __future__ import annotations

import ctypes
import re

import pytest
import torch

from mfvit_tpu_torch.ops import build, fused_attn, fused_mlp, gemm, launch

_ASYNC = (build.CSRC / "attn_bwd_async.cuh").read_text()
_BWD90 = (build.CSRC / "gemm_bwd_sm90.cuh").read_text()
_SM90 = (build.CSRC / "gemm_sm90.cuh").read_text()
_DECL = re.compile(r"MFV_API\s+int\s+(mfv_\w+)\s*\(([^)]*)\)", re.S)

NEW_ENTRIES = ("mfv_gemm_mn", "mfv_gemm_bwd",
               "mfv_fused_attention_block_bwd_wmma",
               "mfv_fused_mlp_block_bwd_wmma")


def _declaration(name: str) -> list:
    """The ctypes of each argument of ``name``'s MFV_API declaration."""
    for src in build.sources():
        if src.suffix != ".cu":
            continue
        for found, args in _DECL.findall(src.read_text()):
            if found == name:
                out = []
                for arg in args.split(","):
                    arg = " ".join(arg.split())
                    out.append(ctypes.c_void_p if "*" in arg else
                               ctypes.c_float if arg.startswith("float")
                               else ctypes.c_int)
                return out
    raise AssertionError(f"{name} is declared in no csrc/*.cu")


@pytest.mark.parametrize("name", NEW_ENTRIES)
def test_new_entry_points_have_their_ctypes_signature(name):
    """Each new entry point is bound with one ctypes type per C argument."""
    assert build.SIGNATURES[name] == _declaration(name)


@pytest.mark.parametrize("name", ["mfv_fused_attention_block_bwd",
                                  "mfv_fused_mlp_block_bwd"])
def test_former_chains_take_the_arguments_of_the_new(name):
    """The check-only former chains take exactly the new chains' arguments,
    so one wrapper feeds both the same scratch and splits."""
    assert _declaration(f"{name}_wmma") == _declaration(name)
    assert build.SIGNATURES[f"{name}_wmma"] == build.SIGNATURES[name]


def _c_const(src: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


def test_k5_core_plan_constants_are_the_c_source():
    """``fused_attn._bwd_plan`` copies attn_bwd_async.cuh: the shared-memory
    limit, the consumer warps by head_dim, the key rows launch_async_n
    stages for each N, and a slot's bytes (AsyncBwd::PER_SLOT)."""
    assert fused_attn.BWD_SMEM_MAX == _c_const(_ASYNC, "ASYNC_SMEM_MAX")
    w128, w = map(int, re.search(r"W = DH == 128 \? (\d+) : (\d+);",
                                 _ASYNC).groups())
    assert fused_attn.BWD_WARPS == {32: w, 64: w, 128: w128}
    cases = re.findall(r"if \(N <= (\d+)\) return launch_async<DH, (\d+)>",
                       _ASYNC)
    last = re.search(r"\n  return launch_async<DH, (\d+)>", _ASYNC).group(1)
    keys = [8 * int(nkt) for _, nkt in cases] + [8 * int(last)]
    assert [int(n) for n, _ in cases] == keys[:-1]
    assert tuple(keys) == fused_attn.BWD_KEYS
    assert "PER_SLOT = SLOT_BYTES + STATS * 4 + 3 * 8" in _ASYNC
    assert "SLOT_BYTES = 2 * PART * 2" in _ASYNC
    assert "LD = DH + 8" in (build.CSRC / "attn_bwd.cuh").read_text()


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_k5_core_plan_fits_at_every_length(dh):
    """Every N from 1 to 256 gets a plan: its key rows hold N, at least one
    slot, the block within an H100's shared memory, the most slots (up to
    4) that fit, at least one consumer warp taking tasks (at most slots x
    tiles do, so no warp runs more than the ring ahead of another), and
    producer and consumers within 1,024 threads."""
    for n in range(1, 257):
        plan = fused_attn._bwd_plan(n, dh)
        assert n <= plan.keys and plan.keys % 16 == 0
        assert 1 <= plan.slots <= 4
        assert plan.smem == plan.slots * fused_attn._bwd_slot_bytes(
            plan.keys, dh) <= fused_attn.BWD_SMEM_MAX
        assert plan.slots == 4 or (plan.slots + 1) * \
            fused_attn._bwd_slot_bytes(plan.keys, dh) > fused_attn.BWD_SMEM_MAX
        assert min(plan.warps, plan.slots * -(-n // 16)) >= 1
        assert (plan.warps + 1) * 32 <= 1024


def test_k5_core_plan_at_the_model_shapes():
    """vit_small (head_dim 32) and vit_base (64) at 197 tokens: 208 key
    rows, four and three slots; head_dim 128 takes one slot past 208."""
    assert fused_attn._bwd_plan(197, 32)[:3] == (208, 4, 15)
    assert fused_attn._bwd_plan(197, 64)[:3] == (208, 3, 15)
    assert fused_attn._bwd_plan(208, 128).slots == 2
    assert fused_attn._bwd_plan(256, 128).slots == 1


@pytest.mark.parametrize("N,dh", [(257, 32), (577, 64), (0, 32), (197, 48),
                                  (197, 16), (197, 256)])
def test_k5_core_plan_refuses_what_the_kernel_does_not_take(N, dh):
    with pytest.raises(ValueError, match="K5"):
        fused_attn._bwd_plan(N, dh)


def test_k7_dual_plan_constants_are_the_c_source():
    """fused_mlp's copy of the dual kernel's tile, ring and stage sizes is
    gemm_bwd_sm90.cuh's, and the block fits an H100's shared memory; the
    MN-major GEMMs take gemm_kernel's ring."""
    assert fused_mlp.DUAL_BM == _c_const(_BWD90, "DUAL_BM")
    assert fused_mlp.DUAL_STAGES == _c_const(_BWD90, "DUAL_STAGES")
    assert "DUAL_STAGE = 8 * TILE64" in _BWD90
    assert fused_mlp.DUAL_SMEM == (fused_mlp.DUAL_STAGES * fused_mlp.DUAL_STAGE
                                   + 2 * fused_mlp.DUAL_STAGES * 8 + 1024)
    assert "DUAL_SMEM = DUAL_STAGES * DUAL_STAGE + 2 * DUAL_STAGES * 8 + 1024" \
        in _BWD90
    assert fused_mlp.DUAL_SMEM <= fused_mlp.SMEM_MAX
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM" in _SM90


def _tn_walk(K: int, S: int, kc: int) -> list:
    """The rows each k16 step of gemm_mn_kernel's TN tiles sums, slice by
    slice, as the kernel walks them (mn_tile, then 64-row stages from the
    slice's first row, each with ceil(rows / 16) k16 steps of the rows left
    in the slice); rows past K are TMA's zeros."""
    steps = []
    for z in range(-(-K // kc)):
        kb, ke = z * kc, min(K, z * kc + kc)
        for k0 in range(kb, ke, 64):
            rows = min(64, ke - k0)
            for kk in range(-(-rows // 16)):
                steps.append((z, range(k0 + 16 * kk, k0 + 16 * kk + 16)))
    return steps


# (K rows, output tiles) of each weight-gradient GEMM the ops split:
# vit_small's dWqkv (27 tiles of 128) and dW1/dW2 (36) and vit_base's (108,
# 144), at the batches the FT step, chip_smoke.py and the tests run, and
# N=50 (a K that 16 does not divide)
K_CASES = [(B * N, tiles) for B in (1, 2, 3, 8, 16, 32, 64, 256)
           for N in (197, 50) for tiles in (27, 36, 108, 144)]


@pytest.mark.parametrize("K,tiles", K_CASES)
def test_k_slices_cover_every_row_once(K, tiles):
    """launch.k_split's (S, kc) for the TN GEMMs: kc a multiple of 32, S
    slices covering the K rows with none empty; the kernel's walk sums every
    row below K in exactly one k16 step of its own slice, and no step of a
    slice reaches a row of the next (a slice may end inside a 64-row
    stage: those steps are skipped)."""
    S, kc = launch.k_split(K, tiles, 32)
    assert kc % 32 == 0 and (S - 1) * kc < K <= S * kc
    seen = {}
    for z, rows in _tn_walk(K, S, kc):
        for r in rows:
            assert r >= K or z * kc <= r < (z + 1) * kc, (z, r)
            if r < K:
                assert r not in seen, r
                seen[r] = z
    assert len(seen) == K


def test_k7_slices_end_inside_a_64_row_stage():
    """K7 at vit_small B=256: kc = 6304 = 98.5 stages of 64, so every
    slice but the last ends half-way through a stage, whose last two k16
    steps the kernel skips; the C source skips them as the walk above
    does."""
    S, kc = launch.k_split(256 * 197, 36, 32)
    assert (S, kc) == (8, 6304) and kc % 64 == 32
    assert "rows = min(64, ke - k0), steps = (rows + 15) / 16" in _SM90
    assert "if (kk < steps)" in _SM90


@pytest.mark.parametrize("form", ["nn", "nn_f32", "tn"])
def test_gemm_mn_takes_its_plain_version_on_the_cpu(form):
    """On CPU tensors both backward GEMM forms run the plain fp32 product
    (and, for "tn", the column sums of a), the reference the card holds
    them to."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(150, 128, generator=g).bfloat16()
    b = torch.randn(150 if form == "tn" else 128, 256,
                    generator=g).bfloat16()
    for fn in (gemm.gemm_mn, gemm.gemm_bwd):
        got = fn(a, b, form, 3, 64)
        want = gemm.gemm_bwd_plain(a, b, form)
        for x, y in zip(got if form == "tn" else (got,),
                        want if form == "tn" else (want,)):
            assert torch.equal(x, y)
    if form == "tn":
        out, bias = gemm.gemm_bwd_plain(a, b, "tn")
        torch.testing.assert_close(out, a.float().T @ b.float())
        torch.testing.assert_close(bias, a.float().sum(0))


def _block(D: int = 128, heads: int = 4, N: int = 17):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, N, D, generator=g).bfloat16()
    vec = torch.zeros(D)
    return dict(g=x.clone(), x=x, ln_s=vec + 1, ln_b=vec,
                wqkv=torch.zeros(3 * D, D), bqkv=torch.zeros(3 * D),
                wproj=torch.zeros(D, D), w1=torch.zeros(4 * D, D),
                b1=torch.zeros(4 * D), w2=torch.zeros(D, 4 * D),
                heads=heads, scale=(D // heads) ** -0.5)


def test_the_former_chains_refuse_cpu_tensors():
    """The check-only former K5 and K7 run only on the card: a CPU tensor
    raises, it never takes a plain version."""
    t = _block()
    with pytest.raises(ValueError, match="CUDA"):
        fused_attn.fused_attention_block_bwd_wmma(
            t["g"], t["x"], t["ln_s"], t["ln_b"], t["wqkv"], t["bqkv"],
            t["wproj"], t["heads"], t["scale"])
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_mlp_block_bwd_wmma(t["g"], t["x"], t["ln_s"],
                                           t["ln_b"], t["w1"], t["b1"],
                                           t["w2"])


@pytest.mark.parametrize("D,heads,N", [(192, 4, 17), (384, 8, 17),
                                       (384, 12, 300)])
def test_the_former_chains_refuse_what_k5_does_not_take(D, heads, N):
    """A width not a multiple of 128, head_dim 48 or N > 256 raises before
    anything is launched, on either device."""
    t = _block(D, heads, N)
    with pytest.raises(ValueError, match="K5"):
        fused_attn.fused_attention_block_bwd_wmma(
            t["g"], t["x"], t["ln_s"], t["ln_b"], t["wqkv"], t["bqkv"],
            t["wproj"], t["heads"], t["scale"])


@pytest.mark.parametrize("D", [192, 320])
def test_the_former_k7_refuses_what_k7_does_not_take(D):
    t = _block(D, 4)
    with pytest.raises(ValueError, match="K7"):
        fused_mlp.fused_mlp_block_bwd_wmma(t["g"], t["x"], t["ln_s"],
                                           t["ln_b"], t["w1"], t["b1"],
                                           t["w2"])
