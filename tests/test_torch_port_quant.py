"""The port's XLA-level W8A8 path (``ops/quant.py`` trees: K12 in every
block) and the stand-alone attention kernels K12, K13 and K14 against the
JAX package on the CPU, from numpy seeds: the plain versions against the
Pallas kernels in interpret mode (fp32 rel < 1e-5, bf16 rel < 1e-2, rel =
max|diff| / max|ref|) and their gradients against ``jax.grad`` through the
custom VJPs (fp32 rel < 1e-4); ``quantized_linear`` and the quantizer bit
for bit; the two W8A8 block halves; the weight bridge; a whole quantized
ViT and the quantized MF-ViT CA forward against ``vit.apply`` /
``fusion.fused_forward`` with ``attn_backend="pallas_interpret"`` at 224
px and past 256 tokens (fp32 atol 1e-4, bf16 rel < 2e-2)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import layers as jlayers
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ops import attention as jattn
from mfvit_tpu.ops import quant as jquant
from mfvit_tpu_torch import ops
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.ops import attention, fused_int8, quant

REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
HEADS = 2


def _rel(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(B, N, dh, seed):
    """Packed qkv (B, N, 3D) in fp32, [q | k | v] x head x dh."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, N, 3 * HEADS * dh)).astype(np.float32)


def _bhnd(qkv):
    """Packed (B, N, 3D) -> q, k, v (B, H, N, dh), in JAX."""
    B, N, three_d = qkv.shape
    x = qkv.reshape(B, N, 3, HEADS, three_d // (3 * HEADS))
    return [x[:, :, i].transpose(0, 2, 1, 3) for i in range(3)]


# kernel -> (JAX Pallas kernel in interpret mode, the port's op), each on
# the packed (B, N, 3D) array laid out as the kernel takes it
def _jax_k12(x, scale):
    return jattn.mhsa_packed(x, HEADS, scale, True)


def _jax_k13(x, scale):
    return jattn.mhsa(*_bhnd(x), scale=scale, backend="pallas_interpret")


def _jax_k14(x, scale):
    return jattn.mhsa_packed_t(x.transpose(0, 2, 1), HEADS, scale, True)


def _port_k12(x, scale):
    return attention.mhsa_packed(x, HEADS, scale)


def _port_k13(x, scale):
    return attention.mhsa(*(t.contiguous() for t in attention._split(
        x, HEADS, False)), scale=scale)


def _port_k14(x, scale):
    return attention.mhsa_packed_t(x.transpose(1, 2), HEADS, scale)


KERNELS = {"mhsa_packed": (_jax_k12, _port_k12),
           "mhsa": (_jax_k13, _port_k13),
           "mhsa_packed_t": (_jax_k14, _port_k14)}


@pytest.mark.parametrize("dh", [16, 32])
@pytest.mark.parametrize("N", [9, 67, 197])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_mhsa_kernels_match_pallas_interpret(kernel, dtype, N, dh):
    """K12, K13 (its default scale, 1/sqrt(dh)) and K14: the port's plain
    versions against the Pallas kernels in interpret mode on the same
    values, in the kernels' own layouts."""
    jfn, pfn = KERNELS[kernel]
    x = _qkv(2, N, dh, seed=N + dh)
    scale = None if kernel == "mhsa" else dh ** -0.5
    want = jfn(jnp.asarray(x).astype(JDT[dtype]), scale)
    got = pfn(_t(x).to(dtype), scale)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) < REL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mhsa_explicit_scale_matches_pallas_interpret(dtype):
    x = _qkv(2, 67, 32, seed=5)
    want = _jax_k13(jnp.asarray(x).astype(JDT[dtype]), 0.3)
    got = _port_k13(_t(x).to(dtype), 0.3)
    assert _rel(got, want) < REL[dtype]


@pytest.mark.parametrize("N", [9, 67])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_mhsa_gradients_match_jax(kernel, N):
    """The Functions' fp32-recompute backward against ``jax.grad`` through
    the JAX custom VJPs, for a random cotangent, in fp32."""
    jfn, pfn = KERNELS[kernel]
    x = _qkv(2, N, 16, seed=40 + N)
    scale = 0.25
    cot = np.random.default_rng(N).standard_normal(
        np.asarray(jfn(jnp.asarray(x), scale)).shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jfn(a, scale) * cot))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (pfn(xt, scale) * _t(cot)).sum().backward()
    assert _rel(xt.grad, want) < 1e-4


def test_mhsa_backward_returns_the_input_dtypes():
    qkv = _t(_qkv(2, 9, 16, seed=3)).bfloat16().requires_grad_()
    attention.mhsa_packed(qkv, HEADS, 0.25).float().sum().backward()
    assert qkv.grad.dtype == torch.bfloat16
    q, k, v = (t.contiguous().detach().requires_grad_()
               for t in attention._split(qkv.detach(), HEADS, False))
    attention.mhsa(q, k, v).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))


def test_mhsa_from_packed_dispatches_to_k12_plain():
    """On the CPU the dispatcher is K12's plain version, which is also the
    JAX XLA route's math (its PV summed in fp32, rounded once)."""
    x = _qkv(2, 67, 32, seed=8)
    for dtype in (torch.float32, torch.bfloat16):
        xt = _t(x).to(dtype)
        assert torch.equal(attention.mhsa_from_packed(xt, HEADS, 0.2),
                           attention.mhsa_packed_plain(xt, HEADS, 0.2))
        want = jattn.mhsa_from_packed(jnp.asarray(x).astype(JDT[dtype]),
                                      HEADS, 0.2, backend="xla")
        assert _rel(attention.mhsa_from_packed(xt, HEADS, 0.2),
                    want) < REL[dtype]


@pytest.mark.parametrize("bias", [False, True])
def test_quantized_linear_matches_jax(bias):
    """Bit for bit in fp32 on (2, 7, 64) activations with an all-zero row
    and exact .5 ties, against JAX's ``quantize_weight`` codes."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((64, 40)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 2, :4] = [127.0, 0.5, 2.5, -1.5]
    b = (rng.standard_normal(40) * 0.1).astype(np.float32) if bias else None
    qp = jquant.quantize_weight(jnp.asarray(w))
    q, s = fused_int8.quantize_weight_cols(_t(w.T))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp["q"]).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(qp["s"]))
    want = jquant.quantized_linear(qp, jnp.asarray(x),
                                   None if b is None else jnp.asarray(b))
    got = quant.quantized_linear(q, s, _t(x), None if b is None else _t(b))
    assert got.shape == (2, 7, 40) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_linear_refuses_requires_grad():
    """Inference only, as the int8 ops of fused_int8: an x that requires a
    gradient raises under grad mode and runs under no_grad."""
    q, s = fused_int8.quantize_weight_cols(torch.randn(8, 16))
    x = torch.randn(3, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        quant.quantized_linear(q, s, x)
    with torch.no_grad():
        assert quant.quantized_linear(q, s, x).shape == (3, 8)


def test_gelu_exact_matches_jax():
    h = np.random.default_rng(12).standard_normal((4, 96)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        want = jax.nn.gelu(jnp.asarray(h).astype(JDT[dtype]),
                           approximate=False)
        got = quant.gelu_exact(_t(h).to(dtype))
        assert got.dtype == dtype
        assert _rel(got, want) < (1e-6 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("half", ["attention", "mlp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_block_halves_match_jax(dtype, half):
    """``ops.quant``'s two W8A8 block halves against JAX's eager chain on
    the same quantized block (``nn/vit.py`` :405-410 with K12 in interpret
    mode, :433 ``layers.mlp``), with unit-scale activations: fp32 atol
    1e-3, since an fp32 ulp between K12's plain version and the Pallas
    kernel can flip one activation code of proj's input, which moves an
    output by xs * s * |q| (by 1.7e-4 at most on this input); bf16 rel <
    2e-2."""
    jcfg = jvit.ViTConfig("vit_test", img_size=32, patch=16, dim=64,
                          depth=1, heads=HEADS)
    blk = jquant.quantize_vit_params(jvit.init(
        jax.random.PRNGKey(36), jcfg, num_classes=3))["blocks"][0]
    x = np.random.default_rng(37).standard_normal((2, 67, 64)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(JDT[dtype])
    npb = jax.tree.map(lambda a: _t(np.asarray(a)), blk)
    qs = {k: (npb[k]["wq"]["q"].T.contiguous(), npb[k]["wq"]["s"],
              npb[k]["b"])
          for k in ("qkv", "proj")}
    qs.update({k: (npb["mlp"][k]["wq"]["q"].T.contiguous(),
                   npb["mlp"][k]["wq"]["s"], npb["mlp"][k]["b"])
               for k in ("fc1", "fc2")})
    scale = jcfg.head_dim ** -0.5
    if half == "attention":
        qkv = jlayers.linear(blk["qkv"], jlayers.layernorm(blk["norm1"], xj))
        want = xj + jlayers.linear(blk["proj"], jattn.mhsa_from_packed(
            qkv, HEADS, scale, backend="pallas_interpret"))
        ln = npb["norm1"]
        with torch.no_grad():
            got = quant.quant_attention_block(
                _t(x).to(dtype), ln["scale"], ln["bias"], *qs["qkv"],
                *qs["proj"], HEADS, scale)
    else:
        want = xj + jlayers.mlp(blk["mlp"],
                                jlayers.layernorm(blk["norm2"], xj))
        ln = npb["norm2"]
        with torch.no_grad():
            got = quant.quant_mlp_block(_t(x).to(dtype), ln["scale"],
                                        ln["bias"], *qs["fc1"], *qs["fc2"])
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    else:
        assert _rel(got, want) < 2e-2


def _port_cfg(jcfg):
    return vit.ViTConfig(**{f: getattr(jcfg, f) for f in
                            vit.ViTConfig.__dataclass_fields__})


def _quant_vit(jtree, jcfg):
    """The port's quantized ViT loaded with ``strict=True`` from JAX's
    ``quantize_vit_params`` tree of ``jtree`` through the bridge."""
    cfg = _port_cfg(jcfg)
    m = vit.quantize_vit_params(vit.ViT(cfg, 3))
    m.load_state_dict(checkpoint.vit_quant_state_from_jax(
        jax.tree.map(np.asarray, jquant.quantize_vit_params(jtree)), cfg),
        strict=True)
    return m.eval()


def test_quantize_vit_params_matches_jax():
    """The port's own quantization of the converted fp32 ViT equals JAX's
    ``quantize_vit_params`` tree through the bridge, buffer for buffer:
    int8 codes and scales of the patch projection and of every block
    linear; LayerNorms, CLS, position table and head unchanged."""
    jcfg = jvit.ViTConfig("vit_test", img_size=32, patch=16, dim=32,
                          depth=2, heads=2)
    jp = jvit.init(jax.random.PRNGKey(31), jcfg, num_classes=3)
    cfg = _port_cfg(jcfg)
    own = vit.ViT(cfg, 3)
    own.load_state_dict(checkpoint.vit_state_from_jax(
        jax.tree.map(np.asarray, jp), cfg), strict=True)
    head = own.head.weight.clone()
    own = vit.quantize_vit_params(own).state_dict()
    got = _quant_vit(jp, jcfg).state_dict()
    assert sorted(got) == sorted(own)
    assert own["patch_embed.proj.q"].shape == (32, 16 * 16 * 3)
    for k in ("patch_embed.proj.q", "blocks.1.mlp.fc2.q"):
        assert own[k].dtype == torch.int8, k
    for k in own:
        assert own[k].dtype == got[k].dtype, k
        assert torch.equal(own[k], got[k]), k
    assert torch.equal(own["head.weight"], head)


VIT = jvit.ViTConfig("vit_test", img_size=224, patch=16, dim=32, depth=2,
                     heads=2)


@pytest.mark.parametrize("img", [224, 288])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_vit_forward_matches_jax(dtype, img):
    """Tokens (after the eager final LayerNorm) and logits of a whole
    quantized ViT against JAX's ``vit.apply`` on the same tree with K12 in
    interpret mode, at 224 px (197 tokens) and 288 px (325: K12 past 256
    tokens on the card)."""
    jcfg = VIT if img == 224 else jvit.ViTConfig(
        "vit_test", img_size=img, patch=16, dim=32, depth=2, heads=2)
    jp = jvit.init(jax.random.PRNGKey(32), jcfg, num_classes=3)
    jq = jquant.quantize_vit_params(jp)
    m = _quant_vit(jp, jcfg)
    img_np = np.random.default_rng(33).standard_normal(
        (2, img, img, 3)).astype(np.float32)
    jt, jl = jvit.apply(jq, jnp.asarray(img_np), jcfg,
                        compute_dtype=JDT[dtype],
                        attn_backend="pallas_interpret", return_features=True)
    with torch.no_grad():
        pt, pl = m(_t(img_np), compute_dtype=dtype, return_features=True)
    assert pt.dtype == dtype and pt.shape == (2, jcfg.seq_len, 32)
    if dtype == torch.float32:
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-4)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    else:
        assert _rel(pt, jt) < 2e-2 and _rel(pl, jl) < 2e-2
    assert all(o.final_ln is False for o in m.plans[False])


@pytest.mark.parametrize("img", [224, 288])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_fused_forward_matches_jax(dtype, img):
    """The quantized MF-ViT CA forward (both branches quantized, the CA
    head unchanged: K4, one fusion head of 128 so that JAX runs its K4 in
    interpret mode too) against ``fusion.fused_forward`` on the same
    ``quantize_vit_params`` trees; and no kernel counted on the CPU."""
    jcfg = jvit.ViTConfig("vit_q", img_size=img, patch=16, dim=128, depth=2,
                          heads=4)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(34 + img), 3)
    jc = jvit.init(k1, jcfg, num_classes=3)
    je = jvit.init(k2, jcfg, num_classes=3)
    jf = jfusion.init(k3, num_classes=3, dim=128, heads=1)
    fus = fusion.Fusion(3, 128, 1)
    fus.load_state_dict(checkpoint.fusion_state_from_jax(
        jax.tree.map(np.asarray, jf)), strict=True)
    rng = np.random.default_rng(35)
    xc, xe = (rng.standard_normal((2, img, img, 3)).astype(np.float32)
              for _ in range(2))
    want = jfusion.fused_forward(
        jquant.quantize_vit_params(jc), jquant.quantize_vit_params(je), jf,
        jnp.asarray(xc), jnp.asarray(xe), jcfg, heads=1,
        compute_dtype=JDT[dtype], attn_backend="pallas_interpret")
    ops.reset_launch_counts()
    with torch.no_grad():
        got = fusion.fused_forward(_quant_vit(jc, jcfg), _quant_vit(je, jcfg),
                                   fus.eval(), _t(xc), _t(xe),
                                   compute_dtype=dtype)
    assert not any(ops.launch_counts().values())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
        else:
            assert _rel(g, w) < 2e-2
