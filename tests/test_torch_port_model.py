"""The port's ViT, fusion head and weight bridge against the JAX package on
the CPU: JAX-initialised weights pushed through the bridge, the same numpy
images through both forwards (fp32)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.exp import checkpoint as jckpt
from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu_torch.exp.checkpoint import (fusion_state_from_jax,
                                            vit_state_from_jax)
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.train.steps import make_fusion_forward

from test_golden import GOLDEN_FUSED, GOLDEN_VIT


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_vit(jp, jcfg, num_classes=3):
    cfg = vit.ViTConfig(**{f: getattr(jcfg, f) for f in
                           vit.ViTConfig.__dataclass_fields__})
    m = vit.ViT(cfg, num_classes)
    m.load_state_dict(vit_state_from_jax(_np_tree(jp), cfg), strict=True)
    return m.eval()


def _port_fusion(jp, dim, heads, depth=1, enc_depth=1):
    m = fusion.Fusion(3, dim, heads, depth, enc_depth)
    m.load_state_dict(fusion_state_from_jax(_np_tree(jp)), strict=True)
    return m.eval()


def _imgs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("learned_pos", [False, True])
def test_vit_bridge_matches_params_to_torch(learned_pos):
    cfg = jvit.ViTConfig("t", img_size=32, patch=16, dim=32, depth=2,
                         heads=2, learned_pos=learned_pos)
    jp = jvit.init(jax.random.PRNGKey(1), cfg, num_classes=3)
    want = jckpt.params_to_torch_vit(jp, cfg)
    got = vit_state_from_jax(_np_tree(jp), cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("enc_depth,depth", [(1, 1), (2, 2)])
def test_fusion_bridge_matches_fusion_params_to_torch(enc_depth, depth):
    jp = jfusion.init(jax.random.PRNGKey(2), num_classes=3, dim=32, heads=2,
                      cross_attn_depth=depth, multi_scale_enc_depth=enc_depth)
    want = jckpt.fusion_params_to_torch(jp)
    got = fusion_state_from_jax(_np_tree(jp))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# the slice at a tiny width: fusion heads=1 -> head_dim 128, so JAX's
# pallas_interpret backend runs K4 as well as K1-K3
TINY = jvit.ViTConfig("tiny", img_size=32, patch=16, dim=128, depth=2,
                      heads=4)


@pytest.fixture(scope="module")
def tiny_slice():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    jc = jvit.init(k1, TINY, num_classes=3)
    je = jvit.init(k2, TINY, num_classes=3)
    jf = jfusion.init(k3, num_classes=3, dim=TINY.dim, heads=1)
    models = {"cxr": _port_vit(jc, TINY), "enh": _port_vit(je, TINY),
              "fus": _port_fusion(jf, TINY.dim, 1)}
    return jc, je, jf, models, _imgs((3, 32, 32, 3), 0), _imgs((3, 32, 32, 3), 1)


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_fused_forward_matches_jax(tiny_slice, backend):
    jc, je, jf, models, xc, xe = tiny_slice
    want = jfusion.fused_forward(jc, je, jf, jnp.asarray(xc), jnp.asarray(xe),
                                 TINY, heads=1, compute_dtype=jnp.float32,
                                 attn_backend=backend)
    got = make_fusion_forward(compute_dtype=torch.float32)(
        models, torch.from_numpy(xc), torch.from_numpy(xe))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_tokens_match_jax(tiny_slice):
    jc, _, _, models, xc, _ = tiny_slice
    jt, jl = jvit.apply(jc, jnp.asarray(xc), TINY, compute_dtype=jnp.float32,
                        attn_backend="xla", return_features=True)
    with torch.no_grad():
        pt, pl = models["cxr"](torch.from_numpy(xc),
                               compute_dtype=torch.float32,
                               return_features=True)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)


def test_reference_plan_equals_cpu_dispatch(tiny_slice):
    """On CPU tensors the kernel wrappers run the plain versions, so the
    reference plan gives the same numbers bit for bit."""
    _, _, _, models, xc, xe = tiny_slice
    a = make_fusion_forward(compute_dtype=torch.float32)(
        models, torch.from_numpy(xc), torch.from_numpy(xe))
    b = make_fusion_forward(compute_dtype=torch.float32, reference=True)(
        models, torch.from_numpy(xc), torch.from_numpy(xe))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_deep_fusion_head_uses_general_encode():
    """depth > 1 and several encoders take the general path, as in JAX."""
    jp = jfusion.init(jax.random.PRNGKey(3), num_classes=3, dim=64, heads=2,
                      cross_attn_depth=2, multi_scale_enc_depth=2)
    tc, te = _imgs((2, 5, 64), 4), _imgs((2, 5, 64), 5)
    want = jfusion.apply(jp, jnp.asarray(tc), jnp.asarray(te), heads=2,
                         attn_backend="xla")
    with torch.no_grad():
        got = _port_fusion(jp, 64, 2, 2, 2)(torch.from_numpy(tc),
                                            torch.from_numpy(te))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_golden_logits():
    """tests/test_golden.py's recorded logits, from the same
    PRNGKey(42) weights converted through the bridge."""
    cfg = jvit.ViTConfig("g", img_size=32, patch=16, dim=32, depth=2, heads=2)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(42), 3)
    vp = jvit.init(k1, cfg, num_classes=3)
    fp = jfusion.init(k2, num_classes=3, dim=32, heads=2)
    img = torch.from_numpy(np.array(jax.random.normal(k3, (2, 32, 32, 3))))
    v, fus = _port_vit(vp, cfg), _port_fusion(fp, 32, 2)
    with torch.no_grad():
        logits = v(img, compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), GOLDEN_VIT, rtol=1e-5,
                               atol=1e-6)
    fused, lc, le = make_fusion_forward(compute_dtype=torch.float32)(
        {"cxr": v, "enh": v, "fus": fus}, img, img)
    np.testing.assert_allclose((fused + lc + le).numpy(), GOLDEN_FUSED,
                               rtol=1e-5, atol=1e-6)


def test_vit_small_full_width_matches_jax():
    cfg = jvit.get_config("vit_small")
    jp = jvit.init(jax.random.PRNGKey(5), cfg, num_classes=3)
    img = _imgs((1, 224, 224, 3), 6)
    want = jvit.apply(jp, jnp.asarray(img), cfg, compute_dtype=jnp.float32,
                      attn_backend="xla")
    with torch.no_grad():
        got = _port_vit(jp, cfg)(torch.from_numpy(img),
                                 compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_init_follows_the_jax_distributions():
    cfg = vit.get_config("vit_small")
    a = vit.ViT(cfg, 3, generator=torch.Generator().manual_seed(3))
    b = vit.ViT(cfg, 3, generator=torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    qkv = a.blocks[0].attn.qkv.weight
    assert qkv.abs().max() <= (3.0 / cfg.dim) ** 0.5
    assert qkv.std() > 0.9 * (1.0 / cfg.dim) ** 0.5  # uniform, not truncated
    assert a.cls_token.std() < 1e-5
    assert abs(a.head.weight.std().item() - 0.01) < 1e-3
    fc1 = a.blocks[0].mlp.fc1.weight
    assert fc1.abs().max() <= 0.04 and abs(fc1.std().item() - 0.0176) < 2e-3
    f = fusion.Fusion(generator=torch.Generator().manual_seed(3))
    wq = f.multi_scale_transformers[0].cross_attn_layers[0][0].fn.wq.weight
    assert wq.abs().max() <= 0.04


@pytest.mark.parametrize("name", ["vit_conv_small", "vit_conv_base"])
def test_conv_stem_archs_are_not_ported_yet(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vit.ViT(vit.get_config(name), 3)
