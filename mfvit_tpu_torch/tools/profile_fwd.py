"""The MF-ViT CA forward's budget by ablation, the port of
``tools/profile_fwd.py``.

    python -m mfvit_tpu_torch.tools.profile_fwd [batch] [--device cuda]

Five variants of the vit_small paired forward (JAX :69-82), each timed
over 20 iterations with the one-iteration-lag fetch after 2 warm-ups
(``card.lag_seconds``, JAX :85-96), B=512 unless given:

- ``full``: ``models.fusion.fused_forward``, the decision logits (K1 24,
  K2 22, K3 2, K4 1);
- ``branches``: both ViT branches' logits through ``ViT(...,
  return_features=True)``, the fusion head cut (K1 24, K2 22, K3 2);
- ``one_branch``: the CXR branch alone (K1 12, K2 11, K3 1);
- ``stem_only``: patch embed, CLS and the sin-cos table per branch, the
  tokens summed (no kernel);
- ``nofinal``: each branch's stem, then its 12 blocks as
  ``ops.fused_attn.fused_attention_block`` and
  ``ops.fused_mlp.fused_mlp_block`` (K1 24, K2 24, K3 0), the head on
  the CLS row without the final LayerNorm (JAX :45-66).

Then the derived lines: the fusion head (full - branches), the final
LayerNorm x2 (branches - nofinal), the stems x2 and one branch (JAX
:106-110). The JAX stem (:36-42) is the TPU's transpose-free patch embed;
its math is what is kept: ``nn.vit.patch_embed`` on the patch
projection, the CLS row, then the sin-cos table added in fp32 and the
sum rounded to bf16. The table is built once, as JAX's compiled program
holds it as a constant. Weights and images come from seeded
``torch.Generator``s (``bench_latency.make_models``), one image tensor
for both branches as in JAX (:33, :88). ``--device cpu`` runs the plain
versions (a smoke test, not a measurement of any device).
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.models import fusion
from mfvit_tpu_torch.nn import posembed, vit
from mfvit_tpu_torch.ops.fused_attn import fused_attention_block
from mfvit_tpu_torch.ops.fused_mlp import fused_mlp_block
from mfvit_tpu_torch.tools import bench_latency, card

ITERS, WARMUP = 20, 2
NAMES = ("full", "branches", "one_branch", "stem_only", "nofinal")


def stem_fn(cfg: vit.ViTConfig, device, dt: torch.dtype = torch.bfloat16):
    """``stem(model, imgs) -> (B, N+1, D)`` tokens in ``dt``."""
    pos = posembed.sincos_2d(cfg.grid, cfg.grid, cfg.dim).to(device)

    def stem(model: vit.ViT, imgs):
        x = vit.patch_embed(model.patch_embed.proj, imgs.to(dt), cfg.patch)
        cls = model.cls_token.to(dt).expand(imgs.shape[0], 1, cfg.dim)
        x = torch.cat([cls, x], 1)
        return (x.float() + pos).to(dt)

    return stem


def blocks(model: vit.ViT, x):
    """Every block as K1 then K2 (the last block's K2 too: no final
    LayerNorm)."""
    cfg = model.cfg
    scale = cfg.head_dim ** -0.5
    for blk in model.blocks:
        x = fused_attention_block(
            x, blk.norm1.weight, blk.norm1.bias,
            *vit._linear_params(blk.attn.qkv),
            *vit._linear_params(blk.attn.proj), cfg.heads, scale)
        x = fused_mlp_block(x, blk.norm2.weight, blk.norm2.bias,
                            *vit._linear_params(blk.mlp.fc1),
                            *vit._linear_params(blk.mlp.fc2))
    return x


def variants(models, cfg: vit.ViTConfig, device,
             dt: torch.dtype = torch.bfloat16) -> dict:
    """{name: fn(a, b) -> a (B, k) fp32 tensor}, JAX's five (:69-82)."""
    vc, ve, fp = models["cxr"], models["enh"], models["fus"]
    stem = stem_fn(cfg, device, dt)

    def branch(model, imgs, final_ln=True):
        if final_ln:
            return model(imgs, compute_dtype=dt, return_features=True)
        x = blocks(model, stem(model, imgs))
        head = model.head
        return x, F.linear(x[:, 0].float(), head.weight, head.bias)

    def full(a, b):
        out = fusion.fused_forward(vc, ve, fp, a, b, compute_dtype=dt)
        return out[0] + out[1] + out[2]

    def stem_sum(model, imgs):
        return stem(model, imgs).float().sum((1, 2))[:, None]

    fns = {
        "full": full,
        "branches": lambda a, b: branch(vc, a)[1] + branch(ve, b)[1],
        "one_branch": lambda a, b: branch(vc, a)[1],
        "stem_only": lambda a, b: stem_sum(vc, a) + stem_sum(ve, b),
        "nofinal": lambda a, b: (branch(vc, a, final_ln=False)[1]
                                 + branch(ve, b, final_ln=False)[1]),
    }
    return {k: torch.inference_mode()(v) for k, v in fns.items()}


def run(device, batch: int = 512, iters: int = ITERS, warmup: int = WARMUP,
        cfg: vit.ViTConfig = None, models=None, names=NAMES) -> dict:
    """{name: seconds per iteration}, each line printed, then the derived
    lines where their variants ran."""
    cfg = cfg or vit.get_config("vit_small")
    models = models if models is not None else \
        bench_latency.make_models(cfg, device)
    img = bench_latency.images(batch, cfg, device)
    fns = variants(models, cfg, device)
    results = {}
    for name in names:
        sec = card.lag_seconds(lambda: fns[name](img, img), iters, warmup)
        results[name] = sec
        print(f"{name:12s} {sec * 1000:8.2f} ms/iter   {batch / sec:8.0f} "
              "pairs/sec", flush=True)
    if set(NAMES) <= set(results):
        r = results
        print(f"\nfusion head : {(r['full'] - r['branches']) * 1000:6.2f} ms")
        print(f"final LN x2 : {(r['branches'] - r['nofinal']) * 1000:6.2f} "
              "ms")
        print(f"stems x2    : {r['stem_only'] * 1000:6.2f} ms (incl fixed "
              "overhead)")
        print(f"one branch  : {r['one_branch'] * 1000:6.2f} ms")
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-profile-fwd")
    p.add_argument("batch", nargs="?", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    card.note(device)
    return run(device, args.batch)


if __name__ == "__main__":
    main()
