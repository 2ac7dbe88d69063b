"""The port's kernel modules (K1-K4) and eager attention against the JAX
package on the CPU: the port's plain versions (fp32) against the Pallas
kernels in interpret mode and against the JAX XLA formulations, on the
same numpy inputs. Tolerance: rtol 1e-4, atol 1e-5 (fp32 math, summation
order differs)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import layers as jlayers
from mfvit_tpu.nn import posembed as jposembed
from mfvit_tpu.ops import attention as jattn
from mfvit_tpu.ops import fused_attn as jfa
from mfvit_tpu.ops import fused_fusion as jff
from mfvit_tpu.ops import fused_mlp as jfm
from mfvit_tpu_torch import ops
from mfvit_tpu_torch.exp.checkpoint import fusion_state_from_jax
from mfvit_tpu_torch.models.fusion import Fusion
from mfvit_tpu_torch.nn import layers, posembed
from mfvit_tpu_torch.ops import (attention, attn_variants, fused_attn,
                                 fused_block, fused_fusion, fused_int8,
                                 fused_mlp, gemm, mlp_variants)

TOL = dict(rtol=1e-4, atol=1e-5)

# tests/test_fused_attn.py shapes
B, N, H, DH = 2, 67, 4, 16
D = H * DH
SCALE = DH ** -0.5


def _np(t):
    return np.asarray(t, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def blk():
    """One block's inputs and weights in the JAX (in, out) layout."""
    rng = np.random.default_rng(0)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(
        x=f(B, N, D), ln_s=1 + f(D, std=0.1), ln_b=f(D, std=0.1),
        wqkv=f(D, 3 * D, std=0.05), bqkv=f(3 * D, std=0.01),
        wproj=f(D, D, std=0.05), bproj=f(D, std=0.01),
        w1=f(D, 4 * D, std=0.05), b1=f(4 * D, std=0.01),
        w2=f(4 * D, D, std=0.05), b2=f(D, std=0.01),
        fs=1 + f(D, std=0.1), fb=f(D, std=0.1))


def _port_attn_args(p):
    return (_t(p["x"]), _t(p["ln_s"]), _t(p["ln_b"]), _t(p["wqkv"].T),
            _t(p["bqkv"]), _t(p["wproj"].T), _t(p["bproj"]))


def _port_mlp_args(p):
    return (_t(p["x"]), _t(p["ln_s"]), _t(p["ln_b"]), _t(p["w1"].T),
            _t(p["b1"]), _t(p["w2"].T), _t(p["b2"]))


def _jax_mlp_args(p):
    return tuple(jnp.asarray(p[k]) for k in
                 ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2"))


def _xla_attn(p):
    ln = {"scale": p["ln_s"], "bias": p["ln_b"]}
    h = jlayers.layernorm(ln, jnp.asarray(p["x"]))
    qkv = h @ p["wqkv"] + p["bqkv"]
    o = jattn.mhsa_from_packed(qkv, H, SCALE, backend="xla")
    return p["x"] + o @ p["wproj"] + p["bproj"]


def _xla_mlp(p):
    ln = {"scale": p["ln_s"], "bias": p["ln_b"]}
    mp = {"fc1": {"w": p["w1"], "b": p["b1"]},
          "fc2": {"w": p["w2"], "b": p["b2"]}}
    x = jnp.asarray(p["x"])
    return x + jlayers.mlp(mp, jlayers.layernorm(ln, x))


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_fused_attention_block_matches_jax(blk, ref):
    if ref == "pallas_interpret":
        want = jfa.fused_attention_block(
            *(jnp.asarray(blk[k]) for k in
              ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj")),
            H, SCALE, True)
    else:
        want = _xla_attn(blk)
    got = fused_attn.fused_attention_block(*_port_attn_args(blk), H, SCALE)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# The plain K1 in bf16 against JAX's K1 in interpret mode: the branch
# error ||got - want|| / ||want - x||. Both keep the qkv and proj biases in
# fp32 and round the sums once, so only the order of the fp32 sums differs
# (readings 0 at D=64, up to about 1.2e-4 at D=128: a rare bf16 flip).
# Rounding the biases to bf16 first, the fault the plain version once had,
# reads 4.5e-3 and more.
K1_BIAS_BAR = 1e-3


@pytest.mark.parametrize("shape", [(2, 67, 4, 16), (4, 197, 4, 32)])
def test_plain_k1_keeps_its_biases_in_fp32_in_bf16(shape):
    b, n, h, dh = shape
    d, scale = h * dh, dh ** -0.5
    rng = np.random.default_rng(7)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    p = dict(x=f(b, n, d), ln_s=1 + f(d, std=0.1), ln_b=f(d, std=0.1),
             wqkv=f(d, 3 * d, std=0.05), bqkv=f(3 * d, std=0.3),
             wproj=f(d, d, std=0.05), bproj=f(d, std=0.3))
    xb = jnp.asarray(p["x"]).astype(jnp.bfloat16)
    want = _np(jfa.fused_attention_block(
        xb, *(jnp.asarray(p[k]) for k in
              ("ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj")),
        h, scale, True).astype(jnp.float32))
    x, ln_s, ln_b, wqkv, bqkv, wproj, bproj = _port_attn_args(p)
    x = torch.from_numpy(_np(xb.astype(jnp.float32))).bfloat16()
    wqkv, wproj = wqkv.bfloat16(), wproj.bfloat16()
    # the biases are off the bf16 grid, so rounding them changes them
    assert not torch.equal(bqkv.bfloat16().float(), bqkv)

    def branch_err(bq, bp):
        got = fused_attn.fused_attention_block_plain(
            x, ln_s, ln_b, wqkv, bq, wproj, bp, h, scale).float().numpy()
        return float(np.linalg.norm(got - want)
                     / np.linalg.norm(want - _np(x.float())))

    assert branch_err(bqkv, bproj) < K1_BIAS_BAR
    rounded = branch_err(bqkv.bfloat16().float(), bproj.bfloat16().float())
    assert rounded > K1_BIAS_BAR, rounded


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_fused_mlp_block_matches_jax(blk, ref):
    want = (jfm.fused_mlp_block(*_jax_mlp_args(blk), True)
            if ref == "pallas_interpret" else _xla_mlp(blk))
    got = fused_mlp.fused_mlp_block(*_port_mlp_args(blk))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_fused_mlp_block_final_ln_matches_jax(blk, ref):
    fs, fb = jnp.asarray(blk["fs"]), jnp.asarray(blk["fb"])
    if ref == "pallas_interpret":
        want = jfm.fused_mlp_block_final_ln(*_jax_mlp_args(blk), fs, fb, True)
    else:
        want = jlayers.layernorm({"scale": fs, "bias": fb}, _xla_mlp(blk))
    got = fused_mlp.fused_mlp_block_final_ln(*_port_mlp_args(blk),
                                             _t(blk["fs"]), _t(blk["fb"]))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_layers_match_jax(blk):
    """nn/layers.py: linear, LayerNorm (both eps values) and the GELU MLP."""
    x = _t(blk["x"])
    ln = torch.nn.LayerNorm(D)
    fc1, fc2 = torch.nn.Linear(D, 4 * D), torch.nn.Linear(4 * D, D)
    mlp = layers.Mlp(D, 4 * D)
    with torch.no_grad():
        ln.weight.copy_(_t(blk["ln_s"]))
        ln.bias.copy_(_t(blk["ln_b"]))
        for m, w, b in ((fc1, "w1", "b1"), (fc2, "w2", "b2"),
                        (mlp.fc1, "w1", "b1"), (mlp.fc2, "w2", "b2")):
            m.weight.copy_(_t(blk[w].T))
            m.bias.copy_(_t(blk[b]))
        jln = {"scale": blk["ln_s"], "bias": blk["ln_b"]}
        for eps in (1e-6, 1e-5):
            np.testing.assert_allclose(
                layers.layernorm(ln, x, eps).numpy(),
                _np(jlayers.layernorm(jln, jnp.asarray(blk["x"]), eps)), **TOL)
        np.testing.assert_allclose(
            layers.linear(fc1, x).numpy(),
            _np(jlayers.linear({"w": blk["w1"], "b": blk["b1"]},
                               jnp.asarray(blk["x"]))), **TOL)
        mp = {"fc1": {"w": blk["w1"], "b": blk["b1"]},
              "fc2": {"w": blk["w2"], "b": blk["b2"]}}
        np.testing.assert_allclose(
            layers.mlp(mlp, x).numpy(),
            _np(jlayers.mlp(mp, jnp.asarray(blk["x"]))), **TOL)
        np.testing.assert_allclose(
            layers.linear_f32(x, fc1.weight, fc1.bias).numpy(),
            layers.linear(fc1, x).numpy(), **TOL)


def test_mhsa_from_packed_matches_jax(blk):
    qkv = np.random.default_rng(1).standard_normal((B, N, 3 * D)).astype(
        np.float32)
    want = jattn.mhsa_from_packed(jnp.asarray(qkv), H, SCALE, backend="xla")
    got = attention.mhsa_from_packed(_t(qkv), H, SCALE)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # the K1 core (kernel rounding points) is the same math in fp32
    np.testing.assert_allclose(
        fused_attn.attn_core_plain(_t(qkv), H, SCALE).numpy(), _np(want),
        **TOL)


def test_cross_attention_1q_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 2, 1, 16)).astype(np.float32)
    k = rng.standard_normal((3, 2, 11, 16)).astype(np.float32)
    v = rng.standard_normal((3, 2, 11, 16)).astype(np.float32)
    want = jattn.cross_attention_1q(*(jnp.asarray(a) for a in (q, k, v)))
    got = attention.cross_attention_1q(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# tests/test_fused_fusion.py shapes
FB, FN, FD, FHEADS = 4, 17, 384, 3


@pytest.fixture(scope="module")
def fusion_case():
    jp = jfusion.init(jax.random.PRNGKey(0), num_classes=3, dim=FD,
                      heads=FHEADS)
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(3)
    tok_c = rng.standard_normal((FB, FN, FD)).astype(np.float32)
    tok_e = rng.standard_normal((FB, FN, FD)).astype(np.float32)
    fus = Fusion(3, FD, FHEADS)
    fus.load_state_dict(fusion_state_from_jax(jp), strict=True)
    return jp, fus, tok_c, tok_e


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_fused_fusion_cls_matches_jax(fusion_case, ref):
    jp, fus, tok_c, tok_e = fusion_case
    flat = jff._flatten_layer(jp["encoders"][0]["layers"][0])
    tc, te = jnp.asarray(tok_c), jnp.asarray(tok_e)
    want = (jff.fused_fusion_cls(tc, te, flat, FHEADS, True)
            if ref == "pallas_interpret"
            else jff._cls_xla(tc, te, flat, FHEADS))
    pflat = fused_fusion.flatten_layer(
        fus.multi_scale_transformers[0].cross_attn_layers[0], torch.float32)
    with torch.no_grad():
        got = fused_fusion.fused_fusion_cls(_t(tok_c), _t(tok_e), pflat,
                                            FHEADS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


@pytest.mark.parametrize("grid", [(14, 14, 384), (2, 2, 128), (3, 5, 32)])
def test_sincos_2d_matches_jax(grid):
    h, w, d = grid
    np.testing.assert_array_equal(posembed.sincos_2d(h, w, d).numpy(),
                                  _np(jposembed.sincos_2d(h, w, d)))


def test_cpu_tensors_never_count_a_launch(blk, fusion_case):
    ops.reset_launch_counts()
    x = _t(blk["x"]).requires_grad_()
    out = fused_attn.fused_attention_block(x, *_port_attn_args(blk)[1:], H,
                                           SCALE)
    out = fused_mlp.fused_mlp_block(out, *_port_mlp_args(blk)[1:])
    out = fused_mlp.fused_mlp_block_final_ln(out, *_port_mlp_args(blk)[1:],
                                             _t(blk["fs"]), _t(blk["fb"]))
    out = fused_attn.fused_attention_block_large(
        out, *_port_attn_args(blk)[1:], H, SCALE)
    out = fused_block.fused_transformer_block(
        out, *_port_attn_args(blk)[1:], *_port_mlp_args(blk)[1:], H, SCALE)
    out.sum().backward()  # the backward Functions take the plain path too
    assert x.grad is not None
    _, fus, tok_c, tok_e = fusion_case
    a, m = _port_attn_args(blk), _port_mlp_args(blk)
    q = [fused_int8.quantize_weight_cols(w) for w in (a[3], a[5], m[3], m[5])]
    with torch.no_grad():
        fus(_t(tok_c), _t(tok_e))
        fused_int8.fused_attention_block_i8(*a[:3], *q[0], a[4], *q[1], a[6],
                                            H, SCALE)
        fused_int8.fused_mlp_block_i8(*m[:3], *q[2], m[4], *q[3], m[6])
        fused_int8.fused_attention_block_dequant(*a[:3], *q[0], a[4], *q[1],
                                                 a[6], H, SCALE)
    qkv = torch.zeros(B, N, 3 * D, requires_grad=True)
    attention.mhsa_packed(qkv, H, SCALE).sum().backward()
    attention.mhsa_packed_t(qkv.detach().transpose(1, 2), H, SCALE)
    attention.mhsa(*torch.zeros(3, B, H, N, DH))
    # the schedule variants take D in 128..512 and head_dim 32/64/128
    x = torch.randn(B, N, 128)
    v = [torch.ones(128), torch.zeros(128)]
    mlp_args = (x, *v, torch.randn(512, 128), torch.zeros(512),
                torch.randn(128, 512), torch.zeros(128))
    mlp_variants.mlp3d(*mlp_args, cb=2)
    mlp_variants.mlp3d_staged(*mlp_args, cb=2)
    mlp_variants.mlp_pipe(*mlp_args)
    a = (x, *v, torch.randn(384, 128), torch.zeros(384),
         torch.randn(128, 128), torch.zeros(128), 4, 32 ** -0.5)
    attn_variants.attn_staged(*a, cb=2)
    attn_variants.attn_pairs(*a, cb=2)
    attn_variants.attn_rolling(*a, cb=2)
    attn_variants.staged_bwd(x, *a[:6], 4, 32 ** -0.5, cb=2)
    gemm.gemm_sm90(x[0], torch.randn(128, 128), torch.zeros(128))
    gemm.gemm_ln(x[0], torch.randn(128, 128), torch.zeros(128))
    gemm.gemm_mn(x[0], torch.randn(128, 128), "nn")
    gemm.gemm_bwd(x[0], torch.randn(N, 128), "tn", 1, 32)
    assert ops.launch_counts() == {
        "fused_attention_block": 0, "fused_attention_block_large": 0,
        "fused_mlp_block": 0,
        "fused_mlp_block_final_ln": 0, "fused_fusion_cls": 0,
        "fused_attention_block_bwd": 0, "fused_mlp_block_bwd": 0,
        "fused_attention_block_i8": 0, "fused_mlp_block_i8": 0,
        "mhsa_packed": 0, "mhsa": 0, "mhsa_packed_t": 0,
        "fused_transformer_block": 0, "mlp3d": 0, "mlp3d_staged": 0,
        "mlp_pipe": 0, "attn_staged": 0, "attn_pairs": 0, "attn_rolling": 0,
        "staged_bwd": 0, "gemm_sm90": 0, "gemm_ln": 0, "gemm_mn": 0,
        "gemm_bwd": 0}
