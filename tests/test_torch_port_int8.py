"""The port's int8 W8A8 serving path (K10, K11, ``infer --int8``) against
the JAX package on the CPU, from numpy seeds: the weight and row
quantizers bit for bit, the plain versions of K10/K11 against the Pallas
kernels in interpret mode (fp32 rel < 1e-5, bf16 rel < 1e-2, rel =
max|diff| / max|ref|), the int8 weight bridge, a whole int8 ViT and the
serving forward."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ops import fused_int8 as fi8
from mfvit_tpu.train import steps as jsteps
from mfvit_tpu_torch.cli import common, infer
from mfvit_tpu_torch.exp import checkpoint
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.ops import fused_int8

from test_torch_port_infer import PORT_FLAGS, paired  # noqa: F401 (fixture)

REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _rel(got, want) -> float:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quantize_weight_cols_matches_jax():
    """Codes and scales bit-identical to JAX's on the (in, out) layout,
    including an all-zero output channel (scale 1)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)
    w[:, 7] = 0.0
    w[3, 5] = 0.5 * w[:, 5].max()  # a code near a tie
    want = fi8.quantize_weight_cols(jnp.asarray(w))
    q, s = fused_int8.quantize_weight_cols(_t(w.T))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want["q"]).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(want["s"]))
    assert s[7] == 1.0 and not q[7].any()
    np.testing.assert_array_equal(
        fused_int8.dequant_w(q, s).numpy(),
        np.asarray(fi8.dequant_w(want)).T)


def test_quant_rows_matches_jax():
    """Bit-identical to ``_quant_rows`` on fp32 rows with exact .5 ties
    (rounded half to even) and on an all-zero row."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((6, 64)).astype(np.float32)
    h[0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]  # s == 1
    h[0, 8:] = 0.25
    h[1] = 0.0
    h[2] *= 1e-3
    want_q, want_s = fi8._quant_rows(jnp.asarray(h))
    q, s = fused_int8.quant_rows(_t(h))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert q[0, :8].tolist() == [127, 0, 2, 2, 0, -2, 4, -126]
    assert s[1, 0] == 1.0 and not q[1].any()


def _block(B, N, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(x=f(B, N, D), ln_s=1 + f(D, std=0.1), ln_b=f(D, std=0.1),
                wqkv=f(D, 3 * D, std=0.05), bqkv=f(3 * D, std=0.01),
                wproj=f(D, D, std=0.05), bproj=f(D, std=0.01),
                w1=f(D, 4 * D, std=0.05), b1=f(4 * D, std=0.01),
                w2=f(4 * D, D, std=0.05), b2=f(D, std=0.01))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,D,heads", [(2, 17, 64, 2), (2, 50, 128, 2)])
def test_int8_blocks_match_pallas_interpret(B, N, D, heads, dtype, seed):
    """K11's and K10's plain versions against the Pallas kernels in
    interpret mode on the same int8 weights, over several seeds. fp32 sums
    taken in another order than XLA's could move a value within an ulp of
    a rounding tie across it and flip an int8 code, which the fp32 bar
    would catch; no seed here does. In bf16 some codes flip, inside the
    bf16 bar."""
    p = _block(B, N, D, seed=seed)
    jq = {k: fi8.quantize_weight_cols(jnp.asarray(p[k]))
          for k in ("wqkv", "wproj", "w1", "w2")}
    pq = {k: (_t(np.asarray(v["q"]).T), _t(v["s"])) for k, v in jq.items()}
    v = {k: _t(p[k]) for k in ("ln_s", "ln_b", "bqkv", "bproj", "b1", "b2")}
    xj = jnp.asarray(p["x"]).astype(JDT[dtype])
    xt = _t(p["x"]).to(dtype)
    scale = (D // heads) ** -0.5

    want = fi8.fused_mlp_block_i8(
        xj, p["ln_s"], p["ln_b"], jq["w1"]["q"], jq["w1"]["s"], p["b1"],
        jq["w2"]["q"], jq["w2"]["s"], p["b2"], interpret=True)
    got = fused_int8.fused_mlp_block_i8(xt, v["ln_s"], v["ln_b"], *pq["w1"],
                                        v["b1"], *pq["w2"], v["b2"])
    assert got.dtype == dtype and _rel(got, want) < REL[dtype]

    want = fi8.fused_attention_block_i8(
        xj, p["ln_s"], p["ln_b"], jq["wqkv"]["q"], jq["wqkv"]["s"],
        p["bqkv"], jq["wproj"]["q"], jq["wproj"]["s"], p["bproj"], heads,
        scale, interpret=True)
    got = fused_int8.fused_attention_block_i8(
        xt, v["ln_s"], v["ln_b"], *pq["wqkv"], v["bqkv"], *pq["wproj"],
        v["bproj"], heads, scale)
    assert got.dtype == dtype and _rel(got, want) < REL[dtype]


CFG = jvit.ViTConfig("vit_test", img_size=32, patch=16, dim=32, depth=2,
                     heads=2)


def _port_cfg():
    return vit.ViTConfig(**{f: getattr(CFG, f) for f in
                            vit.ViTConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def int8_vit():
    """A JAX vit_test tree, its int8 serving tree, and the port's int8
    model loaded from that tree through the bridge."""
    jp = jvit.init(jax.random.PRNGKey(3), CFG, num_classes=3)
    jq = fi8.quantize_vit_for_serving(jp)
    cfg = _port_cfg()
    m = vit.quantize_vit_for_serving(vit.ViT(cfg, 3))
    m.load_state_dict(checkpoint.vit_int8_state_from_jax(
        jax.tree.map(np.asarray, jq), cfg), strict=True)
    return jp, jq, m.eval()


def test_int8_weight_bridge_matches_port_quantizer(int8_vit):
    """The JAX int8 tree through the bridge equals the port's own
    quantization of the converted fp32 model, buffer for buffer."""
    jp, _, bridged = int8_vit
    cfg = _port_cfg()
    own = vit.ViT(cfg, 3)
    own.load_state_dict(checkpoint.vit_state_from_jax(
        jax.tree.map(np.asarray, jp), cfg), strict=True)
    own = vit.quantize_vit_for_serving(own).state_dict()
    got = bridged.state_dict()
    assert sorted(got) == sorted(own)
    assert own["blocks.0.attn.qkv.q"].dtype == torch.int8
    for k in own:
        assert own[k].dtype == got[k].dtype, k
        assert torch.equal(own[k], got[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_vit_forward_matches_jax(int8_vit, dtype):
    """Tokens (after the eager final LayerNorm) and logits of the whole
    int8 ViT against JAX's K10/K11 path in interpret mode: fp32 atol 1e-4,
    bf16 rel < 2e-2 (the bf16 bar of Pallas against XLA)."""
    _, jq, m = int8_vit
    img = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    jt, jl = jvit.apply(jq, jnp.asarray(img), CFG,
                        compute_dtype=JDT[dtype],
                        attn_backend="pallas_interpret", return_features=True)
    with torch.no_grad():
        pt, pl = m(_t(img), compute_dtype=dtype, return_features=True)
    assert pt.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-4)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    else:
        assert _rel(pt, jt) < 2e-2 and _rel(pl, jl) < 2e-2
    assert all(ops.final_ln is False for ops in m.plans[False])


def test_infer_int8_matches_jax_kernel_path(paired, tmp_path):  # noqa: F811
    """``infer --int8`` on the CPU against JAX's ``make_fusion_forward``
    on the int8 tree with the K10/K11 kernels in interpret mode, on the
    same normalised batches: logits atol 1e-4, identical predictions."""
    _, man = paired
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(12), 3)
    tree = {"cxr": jvit.init(k1, CFG, num_classes=3),
            "enh": jvit.init(k2, CFG, num_classes=3),
            "fus": jfusion.init(k3, num_classes=3, dim=32, heads=2)}
    np_tree = jax.tree.map(np.asarray, tree)
    cfg = _port_cfg()
    ckpt = str(tmp_path / "port.pt")
    checkpoint.save_serving(
        ckpt, checkpoint.vit_state_from_jax(np_tree["cxr"], cfg),
        checkpoint.vit_state_from_jax(np_tree["enh"], cfg),
        checkpoint.fusion_state_from_jax(np_tree["fus"]))
    argv = PORT_FLAGS + ["--checkpoint", ckpt, "--manifest", man, "--output",
                         str(tmp_path / "port.json"), "-b", "3", "--device",
                         "cpu", "--int8"]
    got = infer.main(argv)

    jq = dict(tree, cxr=fi8.quantize_vit_for_serving(tree["cxr"]),
              enh=fi8.quantize_vit_for_serving(tree["enh"]))
    fwd = jsteps.make_fusion_forward(CFG, heads=2, compute_dtype=jnp.float32,
                                     attn_backend="pallas_interpret")
    args = infer.build_parser().parse_args(argv)
    loader = common.make_paired_loader(args, man)
    want = np.concatenate([
        np.asarray(sum(fwd(jq, *(jnp.asarray(x.numpy()) for x in
                                 infer.prepare(b, "cpu", torch.float32)))))
        for b in loader])[:got["n"]]
    np.testing.assert_allclose(np.asarray(got["logits"]), want, atol=1e-4)
    assert got["predictions"] == want.argmax(-1).tolist()
    assert set(got["metrics"]) == {"auc", "top1", "precision", "recall", "f1"}


def test_int8_ops_refuse_requires_grad():
    """No backward, as in JAX: an x that requires a gradient raises under
    grad mode, and runs under no_grad."""
    p = _block(1, 5, 32, seed=9)
    x = _t(p["x"]).requires_grad_()
    q = {k: fused_int8.quantize_weight_cols(_t(p[k].T))
         for k in ("wqkv", "wproj", "w1", "w2")}
    v = {k: _t(p[k]) for k in ("ln_s", "ln_b", "bqkv", "bproj", "b1", "b2")}
    mlp = (v["ln_s"], v["ln_b"], *q["w1"], v["b1"], *q["w2"], v["b2"])
    attn = (v["ln_s"], v["ln_b"], *q["wqkv"], v["bqkv"], *q["wproj"],
            v["bproj"], 2, 16 ** -0.5)
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_int8.fused_mlp_block_i8(x, *mlp)
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_int8.fused_attention_block_i8(x, *attn)
    with torch.no_grad():
        assert fused_int8.fused_mlp_block_i8(x, *mlp).shape == x.shape
        assert fused_int8.fused_attention_block_i8(x, *attn).shape == x.shape
