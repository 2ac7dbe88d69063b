"""Four bf16 rounding faults of the port against the JAX package, each
pinned on the CPU with a bias that bf16 cannot represent.

1. ``fused_mlp_block_plain`` (K2's plain version) adds fc2's fp32 bias to
   the fp32 sums and rounds once, as JAX's ``fused_mlp_block`` does.
   Held against it in interpret mode on the branch, ||out - want|| /
   ||want - x|| < 1e-3 (the A&S GELU of the Pallas kernel against the
   exact erf, and sums in another order, leave about 2e-4; a bias rounded
   to bf16 first reads about 3e-3).
2. ``patch_embed`` does the same with the patch bias (fp32 sums, fp32
   bias, one rounding), as JAX's ``patch_embed``. The bf16 tokens of a ViT
   with a non-zero patch bias against ``vit.apply`` (``pallas_interpret``,
   whose kernels round where the port's plain versions do): ||diff|| /
   ||want|| < 1e-3 (0 here; about 3e-3 with the bias rounded to bf16
   first), and the embedding itself equal to JAX's on all but 1 % of its
   values (an fp32 near-tie may round the other way; about 20 % differ
   with the bias rounded first).
3. ``layers.linear`` (the depth > 1 fusion ``encode``) rounds the product,
   then adds the bias cast to bf16 and rounds again, as JAX's ``linear``.
   The fused CLS rows of a depth-2 ``encode`` in bf16 against JAX's:
   ||diff|| / ||want|| < 2e-5 (0 here; a single rounding reads about
   3e-4).
4. At D > 512 the port's last block still runs K3, which keeps the
   residual sum in fp32 into the final LayerNorm, where JAX runs K2 (a
   bf16 sum) and an eager final LayerNorm (a routing difference that
   ``nn/vit.py``'s docstring lists). At D=768, depth 2, bf16 tokens
   against ``vit.apply``: ||diff|| / ||want|| < 1e-2 (about 3e-3, of
   which bf16 flips compounding over two blocks are most: the port's ops
   on JAX's route read about 2e-3).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from mfvit_tpu.models import fusion as jfusion
from mfvit_tpu.nn import vit as jvit
from mfvit_tpu.ops import fused_mlp as jfm
from mfvit_tpu_torch.exp.checkpoint import (fusion_state_from_jax,
                                            vit_state_from_jax)
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.ops import fused_mlp

BF = jnp.bfloat16


def _fro(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_mlp_plain_adds_the_fp32_fc2_bias_once():
    rng = np.random.default_rng(0)
    B, N, D = 2, 197, 128

    def r(*s, std=1.0):
        return (std * rng.standard_normal(s)).astype(np.float32)

    x = _np32(jnp.asarray(r(B, N, D)).astype(BF))
    lns, lnb = 1 + r(D, std=0.1), r(D, std=0.1)
    w1, b1, w2 = r(D, 4 * D, std=0.05), r(4 * D, std=0.1), r(4 * D, D,
                                                              std=0.05)
    b2 = (0.5 * rng.uniform(-1, 1, D) + 0.37 / 512).astype(np.float32)
    want = _np32(jfm.fused_mlp_block(jnp.asarray(x).astype(BF), lns, lnb, w1,
                                     b1, w2, b2, True))
    got = _np32(fused_mlp.fused_mlp_block_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(lns),
        torch.from_numpy(lnb), torch.from_numpy(w1.T.copy()),
        torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
        torch.from_numpy(b2)))
    assert _fro(got - x, want - x) < 1e-3


def _port_vit(jp, jcfg):
    cfg = vit.ViTConfig(**{f: getattr(jcfg, f) for f in
                           vit.ViTConfig.__dataclass_fields__})
    m = vit.ViT(cfg, 3)
    m.load_state_dict(vit_state_from_jax(jp, cfg), strict=True)
    return m.eval()


def _vit_case(dim, heads, key, seed):
    """A depth-2 ViT at 32 px with a patch bias bf16 cannot represent, its
    port, and bf16 tokens from JAX's kernel path in interpret mode."""
    jcfg = jvit.ViTConfig("t", img_size=32, patch=16, dim=dim, depth=2,
                          heads=heads)
    jp = jax.tree.map(np.asarray, jvit.init(jax.random.PRNGKey(key), jcfg,
                                            num_classes=3))
    rng = np.random.default_rng(seed)
    jp["patch"]["b"] = rng.uniform(-1, 1, dim).astype(np.float32)
    imgs = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    tokens, _ = jvit.apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(imgs),
                           jcfg, compute_dtype=BF,
                           attn_backend="pallas_interpret",
                           return_features=True)
    return _port_vit(jp, jcfg), torch.from_numpy(imgs), _np32(tokens)


def _tokens(model, imgs):
    with torch.no_grad():
        tokens, _ = model(imgs, compute_dtype=torch.bfloat16,
                          return_features=True)
    return _np32(tokens)


def test_patch_embed_adds_the_fp32_bias_once():
    model, imgs, want = _vit_case(128, 4, 7, 1)
    assert _fro(_tokens(model, imgs), want) < 1e-3
    # the embedding itself: one rounding, as JAX's; a rare fp32 near-tie
    # may round the other way
    p = model.patch_embed.proj
    jp = {"w": p.weight.detach().permute(2, 3, 1, 0).reshape(-1, 128).numpy(),
          "b": p.bias.detach().numpy()}
    xb = imgs.bfloat16()
    want = _np32(jvit.patch_embed(jp, jnp.asarray(imgs).astype(BF), 16))
    got = _np32(vit.patch_embed(p, xb, 16))
    assert np.mean(got != want) < 1e-2


def test_depth2_fusion_encode_rounds_as_jax_linear():
    jp = jax.tree.map(np.asarray, jfusion.init(
        jax.random.PRNGKey(2), num_classes=3, dim=64, heads=2,
        cross_attn_depth=2, multi_scale_enc_depth=1))
    rng = np.random.default_rng(3)

    def biases(t):  # every bias non-zero and off the bf16 grid
        if isinstance(t, dict):
            return {k: (rng.uniform(-1, 1, v.shape).astype(np.float32)
                        if k == "b" else biases(v)) for k, v in t.items()}
        return [biases(v) for v in t] if isinstance(t, list) else t

    jp = biases(jp)
    m = fusion.Fusion(3, 64, 2, cross_attn_depth=2).eval()
    m.load_state_dict(fusion_state_from_jax(jp), strict=True)
    tc, te = (rng.standard_normal((8, 17, 64)).astype(np.float32)
              for _ in range(2))
    want = jfusion.encode(jax.tree.map(jnp.asarray, jp),
                          jnp.asarray(tc).astype(BF),
                          jnp.asarray(te).astype(BF), 2)
    with torch.no_grad():
        got = fusion.encode(m, torch.from_numpy(tc).bfloat16(),
                            torch.from_numpy(te).bfloat16())
    for g, w in zip(got, want):
        assert _fro(_np32(g)[:, 0], _np32(w)[:, 0]) < 2e-5


def test_vit_base_width_final_ln_routing_difference():
    model, imgs, want = _vit_case(768, 12, 5, 5)
    assert _fro(_tokens(model, imgs), want) < 1e-2
