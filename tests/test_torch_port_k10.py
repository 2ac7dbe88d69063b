"""K10's redesign on the CPU: the launch plan of the quantizing int8 GEMM
(``ops/fused_int8.py::_qa_plan``) against a block's shared memory on an
H100 and against the constants of its CUDA sources, the split of the
column tiles by rows, K10's route by rows, a tiled plain emulation of the
three launches' schedule (row tiles quantized on their own, every group of
column tiles quantizing its rows again) against the plain version bit for
bit and against JAX's ``fused_attention_block_i8`` in interpret mode, and
the check-only wrappers refusing CPU tensors. The kernels themselves run
only on the card (``test_torch_port_cuda.py``, ``chip_smoke.py``)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvit_tpu.ops import fused_int8 as jfi8
from mfvit_tpu_torch.nn.layers import layer_norm
from mfvit_tpu_torch.ops import build, fused_int8
from mfvit_tpu_torch.ops.fused_attn import attn_core_plain

from test_torch_port_int8 import _block as int8_block

_I8T = (build.CSRC / "gemm_i8_sm90.cuh").read_text()
_INT8 = (build.CSRC / "fused_int8.cu").read_text()
_ASYNC = (build.CSRC / "attn_async.cu").read_text()
_LONG = (build.CSRC / "attn_long_async.cu").read_text()
ROWS_MAX = 256 * 577  # vit_small_ori@384 at B=256
WIDTHS = (128, 256, 384, 512, 640, 768, 1024)  # D % 128 == 0, head_dim 32-128


def _const(src: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


@pytest.mark.parametrize("D", WIDTHS)
def test_qa_plan_fits_at_every_row_count(D):
    """K10's two quantizing GEMMs (qkv: N = 3D on bf16 x with its LN;
    proj: N = D on the fp32 attention output; both K = D) at every M from
    1 to 256 x 577 rows: 128-row tiles up to K = 512, else 64; the block's
    shared memory (the W ring, two A tiles, LN's vectors, W's scales and
    the bias, the row scales, the barriers and counters, the alignment)
    within the H100's
    232,448 bytes with at least two ring stages; the groups cover the
    column tiles with none empty; and the items (a row tile and a group)
    fill a wave of 132 SMs wherever the row tiles times the column tiles
    do."""
    fi = fused_int8
    for N, ln in ((3 * D, True), (D, False)):
        nt = N // 128
        for M in range(1, ROWS_MAX + 1):
            p = fi._qa_plan(M, N, D, fi.SMS, ln)
            assert p.rows == (128 if D <= fi.QA_HM2_MAX_K else 64)
            assert 2 <= p.stages <= fi.QA_STAGES_MAX
            assert p.smem == (
                p.stages * (fi.I8T_STAGE + 16) + 2 * p.rows * D
                + (8 * D if ln else 0) + 8 * N + 2 * p.rows * 4 + 5 * 8
                + 1024) <= fi.SMEM_MAX
            assert p.groups * p.per >= nt > (p.groups - 1) * p.per
            mt = -(-M // p.rows)
            assert mt * p.groups >= min(fi.SMS, mt * nt), (M, N, p)


def test_qa_plan_takes_every_stage_that_fits():
    """The ring as deep as the shared memory allows, up to QA_STAGES_MAX,
    fewer as the A tiles and row buffers grow with D (qkv, proj), and none
    where they leave no room for two stages (D = 1536: that width takes
    the five launches)."""
    fi = fused_int8
    assert [tuple(p.stages for p in fi._qa_plans(1, D))
            for D in (128, 384, 512, 768, 1024)] == \
        [(8, 8), (7, 7), (5, 5), (6, 7), (4, 5)]
    assert fi._qa_plans(1, 1536)[0].stages < 2
    assert not fi._k10_fused(ROWS_MAX, 1536)


def test_qa_plan_splits_the_columns_at_few_rows():
    """vit_small's qkv (nine column tiles of 128): one group at B=256 (394
    row tiles), three at B=32 (50), nine at B=8 (13: 117 items, every row
    tile's column tiles apart); vit_base's proj (six) at B=2 (4 tiles of
    64 rows) six groups."""
    fi = fused_int8
    assert [fi._qa_plans(B * 197, 384)[0][2:4] for B in (256, 32, 8)] == \
        [(1, 9), (3, 3), (9, 1)]
    assert fi._qa_plans(2 * 197, 768)[1][2:4] == (6, 1)


@pytest.mark.parametrize("D", [128, 384, 768])
def test_k10_routes_by_rows(D):
    """Below I8Q_FUSED_WORK token rows x width K10 takes its five launches,
    from there on the three on the quantizing GEMMs."""
    fi = fused_int8
    rows = -(-fi.I8Q_FUSED_WORK // D)
    assert [fi._k10_fused(M, D) for M in (1, 197, rows - 1)] == [False] * 3
    assert [fi._k10_fused(M, D) for M in (rows, rows + 197, ROWS_MAX)] == \
        [True] * 3


def test_k10_routes_of_the_timed_shapes():
    """The routes where tools/i8_routes.py timed both (PERF.md): the five
    launches at vit_small B=96 and below, vit_base B=48 and below and
    vit_small_ori@384 B=32; the three at vit_small B=128 and B=256,
    vit_base B=64 and vit_small_ori@384 B=64."""
    fused = fused_int8._k10_fused
    assert not any([fused(96 * 197, 384), fused(48 * 197, 768),
                    fused(32 * 577, 384)])
    assert all([fused(128 * 197, 384), fused(256 * 197, 384),
                fused(64 * 197, 768), fused(64 * 577, 384)])


def test_qa_plan_constants_are_the_c_sources():
    """ops/fused_int8.py's copy of the quantizing GEMM's plan equals the
    CUDA sources': the ring's deepest, the depth up to which a tile holds
    128 rows, the shared memory formula, the split into groups, the
    kernel's layout of its shared memory, and the entry's route by rows;
    and K10's cores are the asynchronous ones with an fp32 output."""
    fi = fused_int8
    assert fi.QA_STAGES_MAX == _const(_I8T, "QA_STAGES_MAX")
    assert fi.QA_HM2_MAX_K == _const(_I8T, "QA_HM2_MAX_K")
    assert fi.I8Q_FUSED_WORK == 1 << 23
    assert "constexpr long long I8Q_FUSED_WORK = 1 << 23;" in _INT8
    src = " ".join(_I8T.split())
    for line in ("q.hm = K <= QA_HM2_MAX_K ? 2 : 1;",
                 "fixed = 2 * bm * K + (ln ? 8 * K : 0) + 8 * N + 2 * bm * 4 "
                 "+ 5 * 8 + 1024;",
                 "q.stages = (232448 - fixed) / (I8T_STAGE + 16);",
                 "if (q.stages > QA_STAGES_MAX) q.stages = QA_STAGES_MAX;",
                 "q.smem = fixed + q.stages * (I8T_STAGE + 16);",
                 "int g = (sms + mt - 1) / mt;",
                 "g = g < 1 ? 1 : g > nt ? nt : g;",
                 "q.per = nt / g;",
                 "q.groups = (nt + q.per - 1) / q.per;",
                 "unsigned char* A = ring + S * I8T_STAGE;",
                 "float* gb = reinterpret_cast<float*>(A + 2 * A_BYTES);",
                 "float* wsb = gb + (LN ? 2 * K : 0);",
                 "float* hs = wsb + 2 * Nn;",
                 "uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * BM);",
                 "int* claim = reinterpret_cast<int*>(a_empty + 2);",
                 "qa_plan(e.M, e.N, e.K, sms, LN);",
                 "if (q.stages < 2) return (int)cudaErrorInvalidValue;"):
        assert line in src, line
    entry = " ".join(_INT8.split())
    assert ("(long long)B * N * D >= I8Q_FUSED_WORK && i8sm90::qa_plan(1, 3 * "
            "D, D, 1, true).stages >= 2 && i8sm90::qa_plan(1, D, D, 1, "
            "false).stages >= 2") in entry
    assert "attn_async<float>(qkv, o" in entry
    assert "attn_long_async<float>(qkv, o" in entry
    for src in (_ASYNC, _LONG):
        assert "template int" in src and "<float>(const void*, void*" in src


def _gemm_tiled(a, w, ws, bias, epi, sms, quant):
    """One quantizing GEMM as the kernel schedules it, in plain PyTorch:
    ``a`` (M, K) rows, ``quant`` a row tile's (codes, scales); row tiles of
    ``_qa_plan``'s rows, each group of column tiles quantizing its rows
    again; each 128-column tile's int sums (int64, exact), then ``epi``
    (acc, row scales, weight scales, bias) in fp32."""
    M, K = a.shape
    N = w.shape[0]
    p = fused_int8._qa_plan(M, N, K, sms)
    out = torch.empty(M, N)
    wl = w.long()
    for m0 in range(0, M, p.rows):
        for g in range(p.groups):
            q, s = quant(a[m0:m0 + p.rows])  # again for every group
            for n in range(g * p.per, min((g + 1) * p.per, N // 128)):
                c = slice(128 * n, 128 * (n + 1))
                acc = (q.long() @ wl[c].t()).float()
                out[m0:m0 + p.rows, c] = epi(acc, s, ws[c].float(),
                                             bias[c].float())
    return out


def _k10_tiled(x, ln_s, ln_b, wqkvq, wqkvs, bqkv, wprojq, wprojs, bproj,
               heads, scale, sms=132):
    """K10's three launches written out in plain PyTorch: the qkv GEMM with
    each row tile's LN(x) quantized on its own, the bias after the weight
    scale, then the token scale, in x's dtype; the core with an fp32
    output; the proj GEMM with each row tile of that output quantized over
    all D, the token scale first, the bias, then x + y in x's dtype."""
    B, N, D = x.shape
    dt = x.dtype
    xf = x.reshape(B * N, D)
    fi = fused_int8
    qkv = _gemm_tiled(
        xf, wqkvq, wqkvs, bqkv, lambda acc, s, ws, b: acc * ws * s + b, sms,
        lambda r: fi.quant_rows(layer_norm(r.float(), ln_s, ln_b, 1e-6)))
    o = attn_core_plain(qkv.to(dt).reshape(B, N, 3 * D), heads, scale,
                        out_dtype=torch.float32)
    y = _gemm_tiled(o.reshape(B * N, D), wprojq, wprojs, bproj,
                    lambda acc, s, ws, b: acc * s * ws + b, sms,
                    fi.quant_rows)
    return (xf + y.to(dt)).reshape(B, N, D)


def _k10_inputs(p, heads, dtype):
    """K10's arguments from one block of test_torch_port_int8.py's numpy
    inputs ``p`` (JAX's (in, out) layout), the weights quantized by JAX's
    ``quantize_weight_cols``: (the port's arguments, JAX's)."""
    D = p["x"].shape[-1]
    scale = (D // heads) ** -0.5
    jq, jp = (jfi8.quantize_weight_cols(jnp.asarray(p[k]))
              for k in ("wqkv", "wproj"))
    q, pq = ((torch.from_numpy(np.array(v["q"]).T.copy()),
              torch.from_numpy(np.array(v["s"]))) for v in (jq, jp))
    v = [torch.from_numpy(p[k]) for k in ("ln_s", "ln_b", "bqkv", "bproj")]
    xj = jnp.asarray(p["x"]).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                    else jnp.float32)
    return ((torch.from_numpy(p["x"]).to(dtype), v[0], v[1], *q, v[2], *pq,
             v[3], heads, scale),
            (xj, p["ln_s"], p["ln_b"], jq["q"], jq["s"], p["bqkv"], jp["q"],
             jp["s"], p["bproj"], heads, scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,D,heads,sms,seed", [
    (2, 50, 128, 2, 132, 0),   # one row tile: every column tile its group
    (3, 97, 128, 4, 2, 1),     # ragged last row tile, groups of two tiles
    (1, 300, 256, 4, 1, 2),    # past 256 tokens, one group
    (2, 70, 640, 5, 132, 3),   # 64-row tiles (K > 512), head_dim 128
])
def test_k10_tiled_schedule_equals_plain(B, N, D, heads, sms, seed, dtype):
    """The tiled emulation equals ``fused_attention_block_i8_plain`` bit for
    bit, ragged last tiles and re-quantized groups included: a row's codes
    and scale do not depend on its tile, int sums are exact in any order,
    and every fp32 step rounds where the plain version's does."""
    args, _ = _k10_inputs(int8_block(B, N, D, seed), heads, dtype)
    assert torch.equal(_k10_tiled(*args, sms=sms),
                       fused_int8.fused_attention_block_i8_plain(*args))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,D,heads", [(2, 50, 128, 2), (1, 260, 128, 4)])
def test_k10_tiled_schedule_matches_jax(B, N, D, heads, dtype, seed):
    """The emulation against JAX's ``fused_attention_block_i8`` in
    interpret mode on test_torch_port_int8.py's inputs, at 50 tokens and
    past 256, within the bars test_torch_port_k9_k11.py holds K11's
    emulation to: XLA's fp32 sums in another order may move a value across
    a rounding tie and flip one int8 code (at 260 tokens, seed 1, one row
    reads 5.2e-5), so in fp32 every token row but at most one stays within
    rel 1e-5 and that one within 7e-4; in bf16 rel < 1e-2."""
    args, jargs = _k10_inputs(int8_block(B, N, D, seed), heads, dtype)
    want = np.asarray(jfi8.fused_attention_block_i8(*jargs, interpret=True)
                      .astype(jnp.float32))
    got = _k10_tiled(*args).float().numpy()
    rel = np.abs(got - want).reshape(B * N, D).max(1) / np.abs(want).max()
    if dtype == torch.float32:
        assert (rel > 1e-5).sum() <= 1 and rel.max() < 7e-4
    else:
        assert rel.max() < 1e-2


def test_k10_check_only_wrappers_refuse_cpu_tensors():
    """K10's former chain and its forced routes run on CUDA tensors only:
    on CPU tensors they raise, and never fall back to a plain version."""
    g = torch.Generator().manual_seed(0)
    D, H = 128, 4
    x = torch.randn(1, 50, D, generator=g).bfloat16()
    vec = torch.zeros(D)
    qkv = fused_int8.quantize_weight_cols(torch.randn(3 * D, D, generator=g))
    proj = fused_int8.quantize_weight_cols(torch.randn(D, D, generator=g))
    a = (x, vec, vec, *qkv, torch.zeros(3 * D), *proj, vec, H, 0.17)
    with pytest.raises(ValueError, match="CUDA"):
        fused_int8.fused_attention_block_i8_mma(*a)
    for fused in (True, False):
        with pytest.raises(ValueError, match="CUDA"):
            fused_int8.fused_attention_block_i8_route(*a, fused)
