"""K3's and K4's Hopper designs, on the CPU: the absorbed form K4's kernels
compute, against the JAX package's ``_cls_xla``; K3's and K4's launch
plans against the C sources' constants and a block's shared memory on an
H100; and the check-only former designs refusing CPU tensors.

K4's kernels regroup the 1-query attention of each direction: with xn the
bf16 LayerNorm of the rows [own CLS, other stream's patches],

    s[h, n] = xn_n . u_h,  u_h = W_k[:, h] (scale q_h)
    o_h     = z_h . W_v[:, h],  z_h = sum_n p[h, n] xn_n

in place of k = xn W_k and v = xn W_v for every row. ``_absorbed`` below
is that order of the sums in torch fp32, with every bf16 rounding point of
``_cls_xla`` (xn, o) kept; it is held against ``_cls_xla`` on the same
bf16 inputs at rel (max|diff| / max|ref|) 1e-5: both sum in fp32, in
other orders, and a bf16 rounding of xn that lands on the other side of a
tie is all that may differ.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfvit_tpu.ops import fused_fusion as jff
from mfvit_tpu_torch.nn.layers import layer_norm
from mfvit_tpu_torch.ops import build, fused_fusion, fused_mlp

ABSORBED_REL = 1e-5

_TAIL = (build.CSRC / "block_tail.cuh").read_text()
_FUSION = (build.CSRC / "fused_fusion.cu").read_text()


def _absorbed(tok_c, tok_e, flat, heads: int):
    """K4's sums in the kernels' order of association, torch fp32: bf16
    tokens and matrices in the torch layout (wkv = [W_k; W_v], (2D, D)),
    fp32 vectors."""
    def direction(own, other, lns5, lnb5, wq, wkv, wp, bp, lns6, lnb6):
        B, N, D = own.shape
        dh = D // heads
        seq = torch.cat([own[:, :1], other[:, 1:]], 1).float()
        xn = layer_norm(seq, lns5, lnb5, 1e-5).bfloat16().float()
        wk = wkv[:D].float().reshape(heads, dh, D)
        wv = wkv[D:].float().reshape(heads, dh, D)
        q = (xn[:, 0] @ wq.float().t()) * dh ** -0.5
        u = torch.einsum("bhd,hdi->bhi", q.reshape(B, heads, dh), wk)
        p = torch.softmax(torch.einsum("bni,bhi->bhn", xn, u), -1)
        z = torch.einsum("bhn,bni->bhi", p, xn)
        o = torch.einsum("bhi,hdi->bhd", z, wv).reshape(B, D)
        y = o.bfloat16().float() @ wp.float().t() + bp
        cal = own[:, 0].float() + y
        return own[:, 0].float() + layer_norm(cal, lns6, lnb6, 1e-6)

    return direction(tok_c, tok_e, *flat[:8]), direction(tok_e, tok_c,
                                                         *flat[8:])


def _case(seed: int, B: int, N: int, D: int):
    """Seeded bf16 tokens and one fusion layer's flat operands (torch
    layout; matrices bf16, vectors fp32), as numpy makes them."""
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std).astype(np.float32))

    tok_c, tok_e = (r(B, N, D).bfloat16() for _ in range(2))
    flat = []
    for _ in range(2):
        flat += [1 + r(D, std=0.1), r(D, std=0.1),
                 r(D, D, std=D ** -0.5).bfloat16(),
                 r(2 * D, D, std=D ** -0.5).bfloat16(),
                 r(D, D, std=D ** -0.5).bfloat16(), r(D, std=0.1),
                 1 + r(D, std=0.1), r(D, std=0.1)]
    return tok_c, tok_e, flat


def _jax_flat(flat):
    """The same operands in the JAX package's layout: matrices (in, out)
    in bf16, vectors fp32."""
    out = []
    for a in flat:
        if a.dim() == 2:
            out.append(jnp.asarray(a.float().t().contiguous().numpy())
                       .astype(jnp.bfloat16))
        else:
            out.append(jnp.asarray(a.numpy()))
    return tuple(out)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("B,N,D,heads", [(3, 197, 384, 3), (2, 50, 768, 12)])
def test_absorbed_k4_matches_jax_cls_xla(B, N, D, heads):
    """vit_small's width (3 heads of 128, N=197) and vit_base's (12 heads
    of 64) at N=50: the absorbed sums within ABSORBED_REL of ``_cls_xla``
    on the same bf16 inputs, both directions."""
    tok_c, tok_e, flat = _case(B + D, B, N, D)
    want = jff._cls_xla(
        jnp.asarray(tok_c.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(tok_e.float().numpy()).astype(jnp.bfloat16),
        _jax_flat(flat), heads)
    got = _absorbed(tok_c, tok_e, flat, heads)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < ABSORBED_REL


def test_absorbed_k4_matches_the_plain_version():
    """The port's plain version (the reference on the card, k and v of
    every row) and the absorbed order agree as closely on the same
    inputs."""
    tok_c, tok_e, flat = _case(7, 4, 197, 384)
    for g, w in zip(_absorbed(tok_c, tok_e, flat, 3),
                    fused_fusion.fused_fusion_cls_plain(tok_c, tok_e, flat,
                                                        3)):
        assert _rel(g.numpy(), w.numpy()) < ABSORBED_REL


def _const(src: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_k3_plan_fits_at_every_tail_width(D):
    """K3 runs one launch of the block tail at D of 128-512 (hidden 4D):
    the plan fits a block's shared memory on an H100 (232,448 bytes) with
    a ring of at least 3 stages, and its final-LayerNorm epilogue takes no
    more, since FINAL_ROWS fp32 rows of pitch D + 8 fill the x2 tile's
    bytes exactly."""
    plan = fused_mlp._plan(D, 4 * D)
    assert plan.route == "tail" and plan.stages >= 3
    assert plan.smem == fused_mlp._smem(D, plan.stages) <= 232448
    assert fused_mlp.SMEM_MAX == 232448
    assert (fused_mlp.FINAL_ROWS * (D + 8) * 4
            == fused_mlp.TAIL_ROWS * (D + 8) * 2)
    assert fused_mlp.TAIL_ROWS % fused_mlp.FINAL_ROWS == 0


def test_k3_takes_the_gemm_core_route_at_768():
    """At ViT-B's width K3 runs on the GEMM core (K2's launches with an
    fp32 fc2 epilogue, then the row LayerNorm): no ring of the tail's."""
    plan = fused_mlp._plan(768, 3072)
    assert plan.route == "gemm" and plan.stages == 0
    assert plan.smem == fused_mlp.GEMM_SMEM <= 232448


@pytest.mark.parametrize("D,Hd", [(640, 2560), (1024, 4096), (64, 256),
                                  (384, 1500), (768, 3000), (384, 0)])
def test_k3_plan_refuses_what_the_kernels_do_not_take(D, Hd):
    with pytest.raises(ValueError, match="K3"):
        fused_mlp._plan(D, Hd)


def test_k3_plan_constants_are_the_c_sources():
    """FINAL_ROWS is block_tail.cuh's, which asserts at compile time that
    the fp32 rows fill the x2 tile; the tail's FINAL instances are the ones
    launch_tail_d dispatches at every tail width."""
    assert fused_mlp.FINAL_ROWS == _const(_TAIL, "FINAL_ROWS")
    assert "FINAL_ROWS * LDX * 4 == X_BYTES" in _TAIL
    assert set(map(int, re.findall(
        r"case (\d+): return launch_tail<\d+, PROJ, FINAL>", _TAIL))) \
        == set(fused_mlp.TAIL_WIDTHS)


@pytest.mark.parametrize("D,heads", [(384, 3), (384, 6), (384, 12),
                                     (768, 3), (768, 12), (768, 24),
                                     (1024, 8), (1024, 16), (128, 2)])
def test_k4_plan_at_the_model_widths(D, heads):
    """vit_small's and vit_base's fusion heads (3 heads at every width, the
    CLIs' default) and more heads at those widths and wider ones fit the
    pass's 16-row ring and the group launches in a block's shared
    memory."""
    fused_fusion._check(D, heads)
    assert fused_fusion._pass_smem(D, heads) <= 232448
    assert fused_fusion._group_smem(D) <= 232448
    assert fused_fusion.ROWS % (fused_fusion.THREADS // 32) == 0


@pytest.mark.parametrize("D,heads", [(384, 5), (352, 4), (96, 3), (0, 1),
                                     (384, 0), (768, 48), (1024, 64),
                                     (4160, 4), (768, 32)])
def test_k4_plan_refuses_what_the_kernels_do_not_take(D, heads):
    """A width that heads does not divide, or that is no multiple of 64, a
    width past 8 x GTHREADS and vectors too large to leave room for the
    ring in a block's shared memory raise."""
    with pytest.raises(ValueError, match="K4"):
        fused_fusion._check(D, heads)


def test_k4_plan_constants_are_the_c_sources():
    """THREADS, GTHREADS and GROUP are fused_fusion.cu's, ROWS its ring
    slot (RPW rows a warp); ``_pass_smem`` and ``_group_smem`` evaluate the
    C source's pass_smem and group_smem expressions at several widths; the
    widths it takes are 8 x GTHREADS at most; the shared-memory limit is
    the one the C side checks."""
    fus = _FUSION[_FUSION.index("namespace fus"):]
    for name in ("THREADS", "GTHREADS", "GROUP"):
        assert getattr(fused_fusion, name) == _const(fus, name), name
    assert fused_fusion.ROWS == _const(fus, "RPW") * fused_fusion.THREADS // 32
    assert "R = WARPS * RPW" in fus
    expr = re.search(r"static int pass_smem\(int D, int heads\) "
                     r"\{\s*return ([^;]*);", _FUSION).group(1)
    group = re.search(r"static int group_smem\(int D\) \{ return ([^;]*);",
                      _FUSION).group(1)
    phases = re.search(r"int phases\(int D\) \{ return ([^;]*);",
                       _FUSION).group(1)
    consts = {k: getattr(fused_fusion, k) for k in ("GROUP", "GTHREADS")}
    for D, heads in ((384, 3), (768, 12), (1024, 16), (128, 2)):
        assert eval(expr, {}, dict(D=D, heads=heads, R=fused_fusion.ROWS)) \
            == fused_fusion._pass_smem(D, heads)
        p = eval(phases.replace("/", "//"), {}, dict(consts, D=D))
        assert eval(group.replace("phases(D)", str(p)), {},
                    dict(consts, D=D)) == fused_fusion._group_smem(D)
    assert "D > 8 * GTHREADS" in _FUSION
    assert f"smem_pass > {fused_fusion.SMEM_MAX}" in _FUSION


def test_the_former_designs_refuse_cpu_tensors():
    """The check-only former K3 and K4 run only on the card: a CPU tensor
    raises, it never takes a plain version."""
    tok_c, tok_e, flat = _case(1, 1, 17, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fused_fusion.fused_fusion_cls_kv(tok_c, tok_e, flat, 2)
    D = 128
    x = tok_c
    w1 = torch.zeros(4 * D, D, dtype=torch.bfloat16)
    w2 = torch.zeros(D, 4 * D, dtype=torch.bfloat16)
    vec = torch.zeros(D)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_mlp_block_final_ln_wmma(x, vec, vec, w1,
                                                torch.zeros(4 * D), w2, vec,
                                                vec, vec)
