"""The system under test for MF-ViT CA: the port's own modules, built as
its CLIs build them, holding the benchmark's seeded weights.

The modules are built on the device (their own initialisation runs there,
from a generator on the device, and is then overwritten), so that no
weight is drawn on the host. Their buffers (the sin-cos table) are the
port's own.
"""
from __future__ import annotations

import torch
from torch import nn


def build(config: dict, img: int, params: dict, device) -> nn.ModuleDict:
    """``{"cxr": ViT, "enh": ViT, "fus": Fusion}`` as ``cli.fuse`` and
    ``cli.infer`` build them (the port's ``-a <arch>``, its CA head), on
    ``device`` with ``params`` loaded. Raises where the port's sizes or
    names differ from the configuration's."""
    from mfvit_tpu_torch.models.fusion import Fusion
    from mfvit_tpu_torch.nn import vit

    if config["arch"] in vit.CONFIGS:
        cfg = vit.get_config(config["arch"], img)
    else:   # the CLIs' own test sizes (-a vit_test)
        import argparse

        from mfvit_tpu_torch.cli import common
        cfg = common.get_vit_arch(argparse.Namespace(
            arch=config["arch"], img_size=img, crop=None,
            in_chans=config["num_channels"]))
    got = {"hidden_size": cfg.dim, "num_attention_heads": cfg.heads,
           "num_hidden_layers": cfg.depth, "patch_size": cfg.patch,
           "intermediate_size": cfg.dim * cfg.mlp_ratio}
    wrong = {k: v for k, v in got.items() if config[k] != v}
    if wrong or cfg.learned_pos or cfg.conv_stem or not cfg.qkv_bias:
        raise ValueError(f"the port's {config['arch']!r} is not "
                         f"{config['name']}: {wrong}")
    K = config["num_classes"]
    gen = torch.Generator(device=device)
    with torch.device(device):
        models = nn.ModuleDict({
            "cxr": vit.ViT(cfg, K, in_chans=config["num_channels"],
                           generator=gen, device=device),
            "enh": vit.ViT(cfg, K, in_chans=config["num_channels"],
                           generator=gen, device=device),
            "fus": Fusion(K, cfg.dim, config["fusion_heads"],
                          config["cross_attn_depth"],
                          config["multi_scale_enc_depth"], generator=gen,
                          device=device)})
    for part, m in models.items():
        missing, unexpected = m.load_state_dict(params[part], strict=False)
        buffers = {n for n, _ in m.named_buffers()}
        if unexpected or set(missing) - buffers:
            raise ValueError(f"{part}: the port's names differ from the "
                             f"reference's: missing {missing}, unexpected "
                             f"{unexpected}")
    return models
