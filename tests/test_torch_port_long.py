"""The port's long-sequence path (N > 256 tokens: img_size 288 and up at
patch 16) against the JAX package on the CPU, from numpy seeds: K9's plain
forward and its fp32-recompute backward against the JAX
``fused_attention_block_large`` (Pallas in interpret mode, ``jax.vjp``
through its ``_bwd_xla_reference``), the ViT and the MF-ViT CA forward with
JAX forced onto K9 (``vit.fused_attn_supported`` patched to False, as
``tests/test_quant.py`` forces its routes), the block plans, the int8
attention route against JAX's rule and both of its kernels, and a
fine-tuning trajectory.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 for one block, atol 1e-4 for a
model (sums in another order); bf16 rel < 1e-2 (rel = max|diff| /
max|ref|); the gradients, fp32 recompute on both sides, rel < 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ops import fused_attn as jfa
from mfvit_tpu.ops import fused_int8 as jfi8
from mfvit_tpu.train import optim as joptim
from mfvit_tpu.train import steps as jsteps
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.ops import fused_attn, fused_int8
from mfvit_tpu_torch.train import optim, steps
from mfvit_tpu_torch.train.steps import make_fusion_forward

TOL = dict(rtol=1e-4, atol=1e-5)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
ATTN = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _block(B, N, D, seed):
    """One attention half's inputs, weights in the JAX (in, out) layout."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(x=f(B, N, D), ln_s=1 + f(D, std=0.1), ln_b=f(D, std=0.1),
                wqkv=f(D, 3 * D, std=D ** -0.5), bqkv=f(3 * D, std=0.1),
                wproj=f(D, D, std=D ** -0.5), bproj=f(D, std=0.1))


def _port_args(p, dtype=torch.float32):
    """The port's arguments: x in ``dtype``, fp32 weights (out, in)."""
    return (_t(p["x"]).to(dtype), _t(p["ln_s"]), _t(p["ln_b"]),
            _t(p["wqkv"].T), _t(p["bqkv"]), _t(p["wproj"].T), _t(p["bproj"]))


# (B=2, N=325) pads to Np=384 in JAX; vit_small@384 is (B=1, 577, 384, 12)
SHAPES = [(2, 325, 128, 4), (1, 577, 384, 12)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,D,heads", SHAPES)
def test_k9_forward_matches_pallas_interpret(B, N, D, heads, dtype):
    p = _block(B, N, D, seed=0)
    scale = (D // heads) ** -0.5
    j = [jnp.asarray(p[k]) for k in ATTN]
    j[0] = j[0].astype(JDT[dtype])
    want = jfa.fused_attention_block_large(*j, heads, scale, True)
    got = fused_attn.fused_attention_block_large(*_port_args(p, dtype),
                                                 heads, scale)
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        assert _rel(got.float(), want) < 1e-2


def test_k9_gradients_match_jax():
    """All seven gradients of the port's K9 Function against ``jax.vjp``
    through JAX's K9 (its custom VJP, ``_bwd_xla_reference``), in fp32:
    the same recompute on both sides, so rel < 1e-4."""
    B, N, D, heads = SHAPES[0]
    p = _block(B, N, D, seed=1)
    g = np.random.default_rng(2).standard_normal((B, N, D)).astype(np.float32)
    scale = (D // heads) ** -0.5
    out, vjp = jax.vjp(
        lambda *a: jfa.fused_attention_block_large(*a, heads, scale, True),
        *(jnp.asarray(p[k]) for k in ATTN))
    want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _port_args(p)]
    got_out = fused_attn.fused_attention_block_large(*leaves, heads, scale)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               **TOL)
    got = torch.autograd.grad(got_out, leaves, _t(g))
    for name, gp, gj in zip(ATTN, got, want):
        gj = np.asarray(gj)
        if name in ("wqkv", "wproj"):  # JAX (in, out), torch (out, in)
            gj = gj.T
        assert gp.dtype == torch.float32, name
        assert _rel(gp.numpy(), gj) < 1e-4, name


def test_k9_backward_returns_the_input_dtypes():
    """bf16 x, fp32 master weights: dx comes back in bf16 and the weight
    gradients in fp32, as from ``_bwd_xla_reference``; dx is the fp32
    recompute rounded once."""
    B, N, D, heads = 1, 300, 128, 1
    p = _block(B, N, D, seed=3)
    leaves = [t.requires_grad_() for t in _port_args(p, torch.bfloat16)]
    scale = (D // heads) ** -0.5
    out = fused_attn.fused_attention_block_large(*leaves, heads, scale)
    g = torch.randn(B, N, D, generator=torch.Generator().manual_seed(4))
    grads = torch.autograd.grad(out, leaves, g.bfloat16())
    assert [t.dtype for t in grads] == [torch.bfloat16] + [torch.float32] * 6
    want = fused_attn.fused_attention_block_bwd_f32(
        g.bfloat16(), *[t.detach() for t in leaves[:-1]], heads, scale)
    assert torch.equal(grads[0], want[0].bfloat16())
    for a, b in zip(grads[1:], want[1:]):
        assert torch.equal(a, b)


# a ViT with 325 tokens: img 288 at patch 16; fusion heads=1 (head_dim 128)
# so that JAX's pallas_interpret backend runs K4 too
LONG = jvit.ViTConfig("long", img_size=288, patch=16, dim=128, depth=2,
                      heads=4)


def _port_cfg(jcfg):
    return vit.ViTConfig(**{f: getattr(jcfg, f) for f in
                            vit.ViTConfig.__dataclass_fields__})


def _port_vit(tree, jcfg):
    cfg = _port_cfg(jcfg)
    m = vit.ViT(cfg, 3)
    m.load_state_dict(checkpoint.vit_state_from_jax(
        jax.tree.map(np.asarray, tree), cfg), strict=True)
    return m.eval()


@pytest.fixture
def jax_on_k9(monkeypatch):
    """JAX's vit.apply forced onto K9 (as on the chip at N=577: K1's scores
    do not fit); returns the list its K9 calls are counted in."""
    monkeypatch.setattr(jvit, "fused_attn_supported",
                        lambda N, D, heads: False)
    calls = []
    orig = jvit.fused_attention_block_large

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(jvit, "fused_attention_block_large", spy)
    return calls


@pytest.fixture(scope="module")
def long_slice():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(21), 3)
    jc = jvit.init(k1, LONG, num_classes=3)
    je = jvit.init(k2, LONG, num_classes=3)
    jf = jfusion.init(k3, num_classes=3, dim=LONG.dim, heads=1)
    fus = fusion.Fusion(3, LONG.dim, 1)
    fus.load_state_dict(checkpoint.fusion_state_from_jax(
        jax.tree.map(np.asarray, jf)), strict=True)
    models = {"cxr": _port_vit(jc, LONG), "enh": _port_vit(je, LONG),
              "fus": fus.eval()}
    rng = np.random.default_rng(22)
    imgs = [rng.standard_normal((2, 288, 288, 3)).astype(np.float32)
            for _ in range(2)]
    return jc, je, jf, models, imgs


def test_long_vit_forward_matches_jax_k9(long_slice, jax_on_k9):
    jc, _, _, models, (xc, _) = long_slice
    jt, jl = jvit.apply(jc, jnp.asarray(xc), LONG, compute_dtype=jnp.float32,
                        attn_backend="pallas_interpret", return_features=True)
    assert len(jax_on_k9) == LONG.depth
    with torch.no_grad():
        pt, pl = models["cxr"](torch.from_numpy(xc),
                               compute_dtype=torch.float32,
                               return_features=True)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)


def test_long_fused_forward_matches_jax_k9(long_slice, jax_on_k9):
    jc, je, jf, models, (xc, xe) = long_slice
    want = jfusion.fused_forward(jc, je, jf, jnp.asarray(xc), jnp.asarray(xe),
                                 LONG, heads=1, compute_dtype=jnp.float32,
                                 attn_backend="pallas_interpret")
    assert len(jax_on_k9) == 2 * LONG.depth
    got = make_fusion_forward(compute_dtype=torch.float32)(
        models, torch.from_numpy(xc), torch.from_numpy(xe))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def _attn_fn(op):
    return op.func if hasattr(op, "func") else op


@pytest.mark.parametrize("img,want", [(224, "fused_attention_block"),
                                      (240, "fused_attention_block"),
                                      (256, "fused_attention_block_large"),
                                      (384, "fused_attention_block_large"),
                                      (512, "fused_attention_block_large")])
def test_block_plan_picks_k9_past_256_tokens(img, want):
    """K1 up to 256 tokens (img 240 at patch 16 is 226), K9 past them (img
    256 is 257 tokens), in every block of the kernel and reference plans."""
    cfg = vit.get_config("vit_small", img)
    for reference in (False, True):
        plan = vit.block_plan(cfg, reference=reference)
        assert len(plan) == cfg.depth
        assert {_attn_fn(o.attn).__name__ for o in plan} == {want}
        assert all(o.attn.keywords["plain"] is reference for o in plan)


ARCHS = sorted(vit.CONFIGS)


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_attention_matches_jax_rule(arch):
    """The int8 attention route equals JAX's ``attn_supported`` at every
    config x img {224, 384, 512}, and at random shapes."""
    for img in (224, 384, 512):
        c = vit.get_config(arch, img)
        assert (fused_int8.w8a8_attention(c.seq_len, c.dim, c.heads)
                == jfi8.attn_supported(c.seq_len, c.dim, c.heads)), img
    rng = np.random.default_rng(ARCHS.index(arch))
    for _ in range(50):
        heads = int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16]))
        D = heads * int(rng.choice([32, 64, 128]))
        N = int(rng.integers(1, 1600))
        assert (fused_int8.w8a8_attention(N, D, heads)
                == jfi8.attn_supported(N, D, heads)), (N, D, heads)


@pytest.mark.parametrize("arch,img,want", [
    ("vit_small", 224, "fused_attention_block_i8"),
    ("vit_small", 384, "fused_attention_block_dequant"),
    ("vit_small_ori", 384, "fused_attention_block_i8"),
    ("vit_small_ori", 512, "fused_attention_block_dequant"),
    ("vit_base", 384, "fused_attention_block_dequant")])
def test_int8_plan_takes_the_jax_route(arch, img, want):
    plan = vit.block_plan(vit.get_config(arch, img), mode="int8")
    assert {_attn_fn(o.attn).__name__ for o in plan} == {want}
    assert {_attn_fn(o.mlp).__name__ for o in plan} == {"fused_mlp_block_i8"}


@pytest.fixture(scope="module")
def long_int8():
    tree = jvit.init(jax.random.PRNGKey(23), LONG, num_classes=3)
    img = np.random.default_rng(24).standard_normal(
        (2, 288, 288, 3)).astype(np.float32)
    return tree, jfi8.quantize_vit_for_serving(tree), img


def _int8_port_vit(qtree, monkeypatch, route):
    """The port's int8 ViT from JAX's int8 tree, on ``route``; every K10
    call is recorded (block, input, output)."""
    cfg = _port_cfg(LONG)
    if route == "dequant":
        monkeypatch.setattr(fused_int8, "w8a8_attention",
                            lambda N, D, heads: False)
    calls = []
    k10 = fused_int8.fused_attention_block_i8

    def recording(x, *a, **k):
        out = k10(x, *a, **k)
        calls.append((x, out))
        return out

    recording.__name__ = k10.__name__
    monkeypatch.setattr(fused_int8, "fused_attention_block_i8", recording)
    m = vit.quantize_vit_for_serving(vit.ViT(cfg, 3))
    m.load_state_dict(checkpoint.vit_int8_state_from_jax(
        jax.tree.map(np.asarray, qtree), cfg), strict=True)
    name = {"w8a8": "fused_attention_block_i8",
            "dequant": "fused_attention_block_dequant"}[route]
    assert {_attn_fn(o.attn).__name__ for o in m.plans[False]} == {name}
    return m.eval(), calls


def test_long_int8_dequant_route_matches_jax(long_int8, monkeypatch):
    """The int8 ViT at 325 tokens through K9 on the dequantized weights
    (and K11) against JAX with its K10 seam (``attn_kernel_ok``) closed,
    so that it takes K9 on ``dequant_w`` weights in every block: fp32 rel
    < 1e-3. Not tighter: an fp32 sum taken in another order can move a
    value across a rounding tie and flip one int8 code of K11 (measured
    rel 1.3e-4-1.9e-4 here)."""
    _, qtree, img = long_int8
    monkeypatch.setattr(jfi8, "attn_kernel_ok",
                        lambda N, D, heads, interp: False)
    calls = []
    orig = jvit.fused_attention_block_large
    monkeypatch.setattr(jvit, "fused_attention_block_large",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    jt, jl = jvit.apply(qtree, jnp.asarray(img), LONG,
                        compute_dtype=jnp.float32,
                        attn_backend="pallas_interpret", return_features=True)
    assert len(calls) == LONG.depth
    m, k10_calls = _int8_port_vit(qtree, monkeypatch, "dequant")
    with torch.no_grad():
        pt, pl = m(torch.from_numpy(img), compute_dtype=torch.float32,
                   return_features=True)
    assert not k10_calls
    assert _rel(pt.numpy(), jt) < 1e-3 and _rel(pl.numpy(), jl) < 1e-3


def test_long_int8_w8a8_route_matches_jax(long_int8, monkeypatch):
    """The int8 ViT at 325 tokens through K10 (the route at these dims)
    against JAX's K10 in interpret mode. Each K10 call is held on the
    input the port's forward gave it against JAX's K10 on that input, fp32
    rel < 1e-3 (one-code flips, measured below 1e-4 per call); the whole
    forward, where the flips compound over the blocks with random weights
    (measured rel 3.1e-3-3.6e-3), within the bf16 bar, rel < 2e-2."""
    _, qtree, img = long_int8
    jt, jl = jvit.apply(qtree, jnp.asarray(img), LONG,
                        compute_dtype=jnp.float32,
                        attn_backend="pallas_interpret", return_features=True)
    m, k10_calls = _int8_port_vit(qtree, monkeypatch, "w8a8")
    with torch.no_grad():
        pt, pl = m(torch.from_numpy(img), compute_dtype=torch.float32,
                   return_features=True)
    assert len(k10_calls) == LONG.depth
    assert _rel(pt.numpy(), jt) < 2e-2 and _rel(pl.numpy(), jl) < 2e-2
    scale = LONG.head_dim ** -0.5
    for blk, (x, out) in zip(qtree["blocks"], k10_calls):
        want = jfi8.fused_attention_block_i8(
            jnp.asarray(x.numpy()), blk["norm1"]["scale"],
            blk["norm1"]["bias"], blk["qkv8"]["q"], blk["qkv8"]["s"],
            blk["qkv8"]["b"], blk["proj8"]["q"], blk["proj8"]["s"],
            blk["proj8"]["b"], LONG.heads, scale, interpret=True)
        assert _rel(out.numpy(), want) < 1e-3


def test_serving_checkpoint_fits_the_input_size(tmp_path):
    """A serving file saved at 224 px serves at 384 (the sin-cos table is
    rebuilt for the grid); a learned table of another length raises."""
    c224, c384 = (vit.get_config("vit_small", s) for s in (224, 384))
    m = vit.ViT(c224, 3)
    f = fusion.Fusion(3, c224.dim, 3)
    path = str(tmp_path / "serving.pt")
    checkpoint.save_serving(path, m.state_dict(), m.state_dict(),
                            f.state_dict())
    ck = checkpoint.load_serving(path, c384)
    m384 = vit.ViT(c384, 3)
    m384.load_state_dict(ck["cxr"], strict=True)
    assert torch.equal(m384.blocks[0].attn.qkv.weight,
                       m.blocks[0].attn.qkv.weight)
    assert m384.pos_embed.shape == (1, 577, 384)
    ori = vit.ViT(vit.get_config("vit_small_ori", 224), 3).state_dict()
    checkpoint.save_serving(path, ori, ori, f.state_dict())
    with pytest.raises(ValueError, match="224 px"):
        checkpoint.load_serving(path, vit.get_config("vit_small_ori", 384))


def test_long_step_trajectory_matches_jax():
    """Ten fp32 SGD steps of the classifier at 325 tokens (K9 forward, its
    fp32-recompute backward) against JAX's XLA step on the same weights
    and batches, the bar of the 224 trajectory in
    ``tests/test_torch_port_train.py``: losses rtol 1e-5, parameters atol
    1e-5."""
    tiny = dict(img_size=288, patch=16, dim=32, depth=2, heads=2)
    cfg = jvit.ViTConfig("vit_test", **tiny)
    pcfg = vit.ViTConfig("vit_test", **tiny)
    assert pcfg.seq_len == 325
    tree = jax.tree.map(np.asarray,
                        jvit.init(jax.random.PRNGKey(25), cfg, num_classes=3))
    model = vit.ViT(pcfg, 3)
    model.load_state_dict(checkpoint.vit_state_from_jax(tree, pcfg),
                          strict=True)
    assert {_attn_fn(o.attn).__name__ for o in model.plans[False]} == {
        "fused_attention_block_large"}
    tx = joptim.build_optimizer(
        "sgd", joptim.finetune_lr(0.05, 2, cos=True, steps_per_epoch=5),
        weight_decay=1e-4, momentum=0.9)
    jstep, _ = jsteps.make_classifier_steps(cfg, tx,
                                            compute_dtype=jnp.float32,
                                            attn_backend="xla")
    params = jax.tree.map(jnp.asarray, tree)
    state = tx.init(params)
    opt = optim.build_optimizer(
        "sgd", model.named_parameters(),
        optim.finetune_lr(0.05, 2, cos=True, steps_per_epoch=5),
        weight_decay=1e-4, momentum=0.9)
    step, _ = steps.make_classifier_steps(compute_dtype=torch.float32)
    rng = np.random.default_rng(26)
    for _ in range(10):
        imgs = rng.standard_normal((2, 288, 288, 3)).astype(np.float32)
        labels = rng.integers(0, 3, 2)
        params, state, jloss, _ = jstep(params, state, jnp.asarray(imgs),
                                        jnp.asarray(labels))
        loss, _ = step(model, opt, torch.from_numpy(imgs),
                       torch.from_numpy(labels))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = checkpoint.vit_state_from_jax(jax.tree.map(np.asarray, params),
                                         pcfg)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=k)
