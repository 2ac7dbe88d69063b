"""K9's long-sequence core and K11's int8 block tail on the CPU: their
launch plans (``ops/fused_attn.py::_long_plan``, ``ops/fused_int8.py::
_plan``) against a block's shared memory on an H100 and against the
constants of their CUDA sources, K11's routes by width, a tiled plain
emulation of K11's two-pass schedule against the plain version (bit for
bit) and against JAX's ``fused_mlp_block_i8`` in interpret mode, and the
check-only former chains refusing CPU tensors. The kernels themselves run
only on the card (``test_torch_port_cuda.py``, ``chip_smoke.py``)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvit_tpu.ops import fused_int8 as jfi8
from mfvit_tpu_torch.ops import build, fused_attn, fused_int8

from test_torch_port_int8 import _block as int8_block

_LONG_H = (build.CSRC / "attn_long_async.cuh").read_text()
_LONG = (build.CSRC / "attn_long_async.cu").read_text()
_I8T = (build.CSRC / "gemm_i8_sm90.cuh").read_text()
_INT8 = (build.CSRC / "fused_int8.cu").read_text()
_LARGE = (build.CSRC / "fused_attn_large.cu").read_text()
SMEM_SM = 233472  # an H100 SM's shared memory; 1 KB of it reserved a block


def _const(src: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_long_plan_fits_at_every_length(dh):
    """Every N from 1 to 4096 at each head_dim: a block's shared memory
    (the ring and its barriers) within the H100's 232,448 bytes, the
    blocks an SM within its 233,472, the units cover N with at most one
    unit's worth of idle query tiles an (image, head), and the key tiles
    cover N."""
    for n in range(1, 4097):
        p = fused_attn._long_plan(n, dh)
        assert p.smem == p.stages * p.stage_bytes + 2 * p.stages * 8
        assert p.smem <= fused_attn.BWD_SMEM_MAX, (n, p)
        assert p.blocks * (p.smem + 1024) <= SMEM_SM, (n, p)
        tiles = -(-n // 16)
        assert p.units * p.warps >= tiles > (p.units - 1) * p.warps, (n, p)
        assert p.key_tiles * fused_attn.LONG_KEYS >= n > \
            (p.key_tiles - 1) * fused_attn.LONG_KEYS


def test_long_plan_constants_are_the_c_sources():
    """ops/fused_attn.py's copy of K9's core sizes equals the CUDA
    source's: keys a stage, consumer warps, stages, the blocks an SM by
    head_dim, the staged row's pitch (dh + 8 bf16) and the shared memory
    a block (the ring and two mbarriers a stage); and K9's C entry takes
    K1's widths (the LayerNorm pass's)."""
    fa = fused_attn
    assert fa.LONG_KEYS == _const(_LONG_H, "LONG_KEYS")
    assert fa.LONG_W == _const(_LONG_H, "LONG_W")
    assert fa.LONG_STAGES == _const(_LONG_H, "LONG_STAGES")
    blocks = re.search(r"BLOCKS = DH == (\d+) \? (\d+) : (\d+);", _LONG)
    big, few, many = map(int, blocks.groups())
    assert fa.LONG_BLOCKS == {dh: few if dh == big else many
                              for dh in (32, 64, 128)}
    assert "LD = DH + 8;" in _LONG
    assert "STAGE = LONG_KEYS * LD;" in _LONG
    assert "SMEM = LONG_STAGES * STAGE_BYTES + 2 * LONG_STAGES * 8;" in _LONG
    assert "QROWS = LONG_W * 16;" in _LONG
    assert "!blk::ln1_takes(D)" in _LARGE
    assert "attn_long_async<bf16>(qkv, o" in _LARGE


@pytest.mark.parametrize("hidden", [1, 2, 4])
@pytest.mark.parametrize("D", [128, 256, 384, 512, 640, 768, 1024])
def test_k11_plan_fits_at_every_width(D, hidden):
    """K11 at every width it takes (D and hidden % 128 == 0): one launch
    of the tail at D of 128-384 (from I8T_TAIL_ROWS rows on), its ring
    I8T_STAGES_PREF stages deep, or the 2 D / 128 stages pass B holds at
    once where that is more, and the block within the H100's 232,448
    bytes; four launches on the int8 wgmma core above 384."""
    fi = fused_int8
    plan = fi._plan(D, hidden * D, fi.I8T_TAIL_ROWS)
    if D <= 384:
        assert plan.route == "tail"
        assert fi._stages_min(D) == 2 * D // 128
        assert plan.stages == max(fi.I8T_STAGES_PREF, fi._stages_min(D))
        assert plan.smem == fi._smem(D, plan.stages) <= fi.SMEM_MAX
    else:
        assert plan == fi.Plan("gemm", 0, 0)


@pytest.mark.parametrize("D,Hd", [(100, 400), (384, 1000), (0, 512)])
def test_k11_plan_refuses_what_no_route_takes(D, Hd):
    with pytest.raises(ValueError, match="K11"):
        fused_int8._plan(D, Hd, 50432)


def test_k11_plan_routes_by_width():
    """The one-launch route at D 128-384, the four launches at 512 (where
    the tail was slower at every M timed) and 768 (the widths the six
    configurations use: 384 and 768), at B=256's and 384-px B=64's token
    counts."""
    for M in (256 * 197, 64 * 577):
        assert [fused_int8._plan(D, 4 * D, M).route
                for D in (128, 256, 384, 512, 768)] == \
            ["tail"] * 3 + ["gemm"] * 2


@pytest.mark.parametrize("D", [128, 384, 512, 768])
def test_k11_plan_routes_by_rows(D):
    """Below I8T_TAIL_ROWS token rows (one or a few images, a last partial
    batch) every width takes the four launches; from there on the tail
    widths take the tail."""
    fi = fused_int8
    rows = fi.I8T_TAIL_ROWS
    assert [fi._plan(D, 4 * D, M).route for M in (1, 197, rows - 1)] == \
        ["gemm"] * 3
    assert [fi._plan(D, 4 * D, M).route for M in (rows, 8 * rows)] == \
        ["tail" if D <= 384 else "gemm"] * 2


def test_k11_plan_constants_are_the_c_sources():
    """ops/fused_int8.py's copy of the tail's constants equals the CUDA
    sources': rows a tile, hidden columns a chunk, the stage (two 64-row
    swizzled slices), the ring's preferred depth and its minimum, the
    shared memory formula, the widths of launch_tail_d, and the entry's
    route by width and rows."""
    fi = fused_int8
    assert fi.I8T_ROWS == _const(_I8T, "I8T_ROWS")
    assert fi.I8T_HC == _const(_I8T, "I8T_HC")
    assert fi.I8T_STAGES_PREF == _const(_I8T, "I8T_STAGES_PREF")
    assert fi.I8T_TAIL_ROWS == _const(_I8T, "I8T_TAIL_ROWS")
    assert "I8T_STAGE = 2 * TILE64;" in _I8T
    assert fi.I8T_STAGE == 2 * fi.TILE64 and fi.TILE64 == 64 * 128
    assert ("A_BYTES = KD * TILE64, H_BYTES = TILE64, S_BYTES = 4 * I8T_ROWS "
            "* 4;") in _I8T
    assert ("STAGES = STAGES_MIN > I8T_STAGES_PREF ? STAGES_MIN : "
            "I8T_STAGES_PREF;") in _I8T
    assert ("STAGES * I8T_STAGE + 2 * A_BYTES + H_BYTES + S_BYTES + "
            "(2 * STAGES + 4) * 8 + 1024;") in _I8T
    assert "p.stages = I8Tail<D>::STAGES;" in _I8T
    assert "STAGES_MIN = KD + J;" in _I8T and "J = D / 128;" in _I8T
    assert "SMEM <= 232448" in _I8T and fi.SMEM_MAX == 232448
    widths = set(map(int, re.findall(r"case (\d+): return launch_tail<\d+>",
                                     _I8T)))
    assert widths == set(fi.I8T_WIDTHS)
    assert (f"D <= {max(widths)} && M >= i8sm90::I8T_TAIL_ROWS"
            in " ".join(_INT8.split()))


def _k11_tiled(x, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, rows=64,
               chunk=128):
    """K11's schedule, written out in plain PyTorch: 64-row tiles; each
    tile's LN(x) quantized per row; fc1 over chunks of 128 hidden columns,
    first for each row's absmax of GELU(fc1) (pass A), then again, each
    chunk quantized with the row's scale and its fc2 product summed in
    int64 (pass B); then the dequantized fc2, the bias and the residual."""
    fi = fused_int8
    B, N, D = x.shape
    Hd = w1q.shape[0]
    xf = x.reshape(B * N, D)
    out = torch.empty_like(xf)
    w1l, w2l = w1q.long(), w2q.long()
    for m0 in range(0, B * N, rows):
        xt = xf[m0:m0 + rows]
        h = fi.layer_norm(xt.float(), ln_s, ln_b, 1e-6)
        hq, hs = fi.quant_rows(h)

        def h1(c):
            cols = slice(c, c + chunk)
            acc = (hq.long() @ w1l[cols].t()).float()
            return fi._gelu(acc * hs * w1s[cols].float() + b1[cols].float())

        amax = torch.zeros(xt.shape[0], 1)
        for c in range(0, Hd, chunk):
            amax = torch.maximum(amax, h1(c).abs().amax(-1, keepdim=True))
        sc = fi._amax_scale(amax)
        sc = torch.where(sc == 0, torch.ones_like(sc), sc)
        acc2 = torch.zeros(xt.shape[0], D, dtype=torch.long)
        for c in range(0, Hd, chunk):
            codes = torch.clamp(torch.round(h1(c) / sc), -127, 127).long()
            acc2 += codes @ w2l[:, c:c + chunk].t()
        y = acc2.float() * sc * w2s.float() + b2.float()
        out[m0:m0 + rows] = xt + y.to(x.dtype)
    return out.reshape(B, N, D)


def _k11_inputs(p, dtype):
    """K11's arguments from one block of test_torch_port_int8.py's numpy
    inputs ``p`` (JAX's (in, out) layout), the weights quantized by JAX's
    ``quantize_weight_cols``: (the port's arguments, JAX's)."""
    jq1, jq2 = (jfi8.quantize_weight_cols(jnp.asarray(p[k]))
                for k in ("w1", "w2"))
    q1, q2 = ((torch.from_numpy(np.array(q["q"]).T.copy()),
               torch.from_numpy(np.array(q["s"]))) for q in (jq1, jq2))
    v = [torch.from_numpy(p[k]) for k in ("ln_s", "ln_b", "b1", "b2")]
    xj = jnp.asarray(p["x"]).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                    else jnp.float32)
    return ((torch.from_numpy(p["x"]).to(dtype), v[0], v[1], *q1, v[2], *q2,
             v[3]),
            (xj, p["ln_s"], p["ln_b"], jq1["q"], jq1["s"], p["b1"], jq2["q"],
             jq2["s"], p["b2"]))


def _hidden(p, Hd):
    """Block ``p`` with its MLP cut to a hidden width of Hd."""
    return dict(p, w1=p["w1"][:, :Hd], b1=p["b1"][:Hd], w2=p["w2"][:Hd])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,D,Hd,seed", [(2, 50, 128, 512, 0),
                                           (1, 130, 256, 384, 1),
                                           (3, 17, 128, 256, 2),
                                           (1, 64, 384, 1536, 3)])
def test_k11_two_pass_schedule_equals_plain(B, N, D, Hd, seed, dtype):
    """The tiled two-pass emulation equals ``fused_mlp_block_i8_plain`` bit
    for bit, ragged last tiles included: int sums are exact in any order,
    a row's absmax does not depend on the chunking, and every fp32 step
    rounds where the plain version's does."""
    args, _ = _k11_inputs(_hidden(int8_block(B, N, D, seed), Hd), dtype)
    assert torch.equal(_k11_tiled(*args),
                       fused_int8.fused_mlp_block_i8_plain(*args))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,D", [(2, 17, 64), (2, 50, 128)])
def test_k11_two_pass_schedule_matches_jax(B, N, D, dtype, seed):
    """The emulation against JAX's ``fused_mlp_block_i8`` in interpret mode
    on test_torch_port_int8.py's inputs (its ``_block``: shapes, seeds,
    hidden 4D), within its bars: fp32 rel < 1e-5, bf16 rel < 1e-2. As it
    says, an fp32 sum that XLA takes in another order can move a value
    across a rounding tie and flip an int8 code, which the fp32 bar
    catches; on these inputs no code flips (the next test holds wider
    shapes to the one-code bar)."""
    args, jargs = _k11_inputs(int8_block(B, N, D, seed), dtype)
    want = np.asarray(jfi8.fused_mlp_block_i8(*jargs, interpret=True)
                      .astype(jnp.float32))
    got = _k11_tiled(*args, chunk=min(128, 4 * D)).float().numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,D,Hd,seed", [(1, 130, 256, 384, 1),
                                           (2, 50, 128, 512, 1),
                                           (2, 50, 128, 512, 2)])
def test_k11_two_pass_schedule_matches_jax_up_to_one_code(B, N, D, Hd, seed,
                                                          dtype):
    """The emulation against JAX's ``fused_mlp_block_i8`` in interpret mode
    at wider shapes with the hidden cut to Hd, where XLA's fp32 sums in
    another order may move a value across a rounding tie and flip one
    int8 code: in fp32 every token row but at most one stays within rel
    1e-5 and that one within 7e-4 (a flipped code moves one row); in bf16
    rel < 1e-2, test_torch_port_int8.py's bar."""
    args, jargs = _k11_inputs(_hidden(int8_block(B, N, D, seed), Hd), dtype)
    want = np.asarray(jfi8.fused_mlp_block_i8(*jargs, interpret=True)
                      .astype(jnp.float32))
    got = _k11_tiled(*args).float().numpy()
    rel = (np.abs(got - want).reshape(B * N, D).max(1)
           / np.abs(want).max())
    if dtype == torch.float32:
        assert (rel > 1e-5).sum() <= 1 and rel.max() < 7e-4
    else:
        assert rel.max() < 1e-2


def test_former_chains_refuse_cpu_tensors():
    """The check-only former chains of K9 and K11, and K11's forced routes,
    run on CUDA tensors only: on CPU tensors they raise, and never fall
    back to a plain version."""
    g = torch.Generator().manual_seed(0)
    D, H = 128, 4
    x = torch.randn(1, 300, D, generator=g).bfloat16()
    vec = torch.zeros(D)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attn.fused_attention_block_large_wmma(
            x, vec, vec, torch.zeros(3 * D, D), torch.zeros(3 * D),
            torch.zeros(D, D), vec, H, (D // H) ** -0.5)
    q1 = fused_int8.quantize_weight_cols(torch.randn(4 * D, D, generator=g))
    q2 = fused_int8.quantize_weight_cols(torch.randn(D, 4 * D, generator=g))
    with pytest.raises(ValueError, match="CUDA"):
        fused_int8.fused_mlp_block_i8_mma(x, vec, vec, *q1,
                                          torch.zeros(4 * D), *q2, vec)
    for tail in (True, False):
        with pytest.raises(ValueError, match="CUDA"):
            fused_int8.fused_mlp_block_i8_route(x, vec, vec, *q1,
                                                torch.zeros(4 * D), *q2, vec,
                                                tail)
