"""The weight bridge from JAX parameter trees, the port's serving
checkpoint, the training checkpoints (``BestKeeper``) and the reference
MoCo ``.pth.tar`` surgery.

``vit_state_from_jax`` and ``fusion_state_from_jax`` take the JAX package's
parameter trees as nested dicts of numpy arrays (``mfvit_tpu/nn/vit.py::init``
and ``mfvit_tpu/models/fusion.py::init`` layouts) and return the port's
state dicts, under the MoCo-v3 ``vits.py`` / reference ``Fus_CrossViT``
names that ``mfvit_tpu/exp/checkpoint.py::params_to_torch_vit`` (:313) and
``fusion_params_to_torch`` (:362) emit. Linear weights go from JAX's
(in, out) to torch's (out, in); the patch projection (P*P*C, D) becomes the
conv weight (D, C, P, P).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from mfvit_tpu_torch.nn import posembed


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def vit_state_from_jax(tree, cfg) -> dict:
    """JAX ViT tree -> ``nn.vit.ViT`` state dict."""
    D, P = cfg.dim, cfg.patch
    pw = np.asarray(tree["patch"]["w"])  # (P*P*C, D), (ph, pw, c) order
    C = pw.shape[0] // (P * P)
    sd = {
        "patch_embed.proj.weight": _t(pw.reshape(P, P, C, D)
                                      .transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _t(tree["patch"]["b"]),
        "cls_token": _t(tree["cls"]),
        "pos_embed": (_t(tree["pos"]) if cfg.learned_pos
                      else posembed.sincos_2d(cfg.grid, cfg.grid, D)),
        "norm.weight": _t(tree["norm"]["scale"]),
        "norm.bias": _t(tree["norm"]["bias"]),
    }
    for i, blk in enumerate(tree["blocks"]):
        b = f"blocks.{i}."
        for name, p in (("norm1", blk["norm1"]), ("norm2", blk["norm2"])):
            sd[b + name + ".weight"] = _t(p["scale"])
            sd[b + name + ".bias"] = _t(p["bias"])
        for name, p in (("attn.qkv", blk["qkv"]), ("attn.proj", blk["proj"]),
                        ("mlp.fc1", blk["mlp"]["fc1"]),
                        ("mlp.fc2", blk["mlp"]["fc2"])):
            sd[b + name + ".weight"] = _t(np.asarray(p["w"]).T)
            sd[b + name + ".bias"] = _t(p["b"])
    if "head" in tree:
        sd["head.weight"] = _t(np.asarray(tree["head"]["w"]).T)
        sd["head.bias"] = _t(tree["head"]["b"])
    return sd


def fusion_state_from_jax(tree) -> dict:
    """JAX fusion tree -> ``models.fusion.Fusion`` state dict."""
    sd = {}
    for e, enc in enumerate(tree["encoders"]):
        for l, lay in enumerate(enc["layers"]):
            base = f"multi_scale_transformers.{e}.cross_attn_layers.{l}."
            for which, key in (("0", "ca_s"), ("2", "ca_l")):
                ca, p = lay[key], f"{base}{which}."
                sd[p + "norm.weight"] = _t(ca["norm"]["scale"])
                sd[p + "norm.bias"] = _t(ca["norm"]["bias"])
                for w in ("wq", "wk", "wv", "proj"):
                    sd[p + f"fn.{w}.weight"] = _t(np.asarray(ca[w]["w"]).T)
                sd[p + "fn.proj.bias"] = _t(ca["proj"]["b"])
            for which, key in (("1", "ln_l"), ("3", "ln_s")):
                sd[f"{base}{which}.weight"] = _t(lay[key]["scale"])
                sd[f"{base}{which}.bias"] = _t(lay[key]["bias"])
    for name, key in (("mlp_head_cxr", "head_cxr"), ("mlp_head_enh", "head_enh")):
        sd[f"{name}.0.weight"] = _t(np.asarray(tree[key]["w"]).T)
        sd[f"{name}.0.bias"] = _t(tree[key]["b"])
    return sd


def save_serving(path: str, cxr: dict, enh: dict, fus: dict) -> None:
    """One ``torch.save`` file {"cxr": sd, "enh": sd, "fus": sd} holding the
    two ViT branches and the fusion head (tensors moved to the CPU)."""
    def cpu(sd):
        return {k: v.detach().cpu() for k, v in sd.items()}
    torch.save({"cxr": cpu(cxr), "enh": cpu(enh), "fus": cpu(fus)}, path)


def load_serving(path: str) -> dict:
    """Inverse of ``save_serving`` (tensors only: ``weights_only=True``)."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if set(ck) != {"cxr", "enh", "fus"}:
        raise ValueError(f"{path}: expected a serving checkpoint with keys "
                         f"cxr/enh/fus, got {sorted(ck)}")
    return ck


# ------------------------------------------------------ training artifacts

class BestKeeper:
    """Track a metric (higher is better) and save best/last checkpoints
    (the reference policy, ``mfvit_tpu/exp/checkpoint.py:77-104``), as
    ``torch.save`` state dicts under the same names."""

    best_name, last_name = "model_best", "last_checkpoint"

    def __init__(self, folder):
        self.folder = str(folder)
        self.best = None

    def _save(self, name: str, state: dict) -> None:
        torch.save({k: v.detach().cpu() for k, v in state.items()},
                   os.path.join(self.folder, name))

    def update(self, metric: float, state: dict, *,
               save_last: bool = True) -> bool:
        """Save ``last`` (optional) and, on improvement, ``best``. Returns
        True when the metric improved. A NaN metric never becomes best."""
        if save_last:
            self._save(self.last_name, state)
        if not np.isfinite(metric):
            return False
        better = (self.best is None or not np.isfinite(self.best)
                  or metric > self.best)
        if better:
            self.best = metric
            self._save(self.best_name, state)
        return better


# ------------------------------------------------ reference .pth.tar files

def load_torch_state_dict(path: str) -> dict:
    """A reference ``.pth.tar`` -> flat {name: tensor} (unwrapping the
    ``{'state_dict': ...}`` the mains save)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def strip_prefix(sd: dict, prefix: str) -> dict:
    """Keep only keys under ``prefix``, with it removed (the reference's
    ``module.base_encoder.`` surgery)."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_moco_pretrained_backbone(path: str, cfg) -> dict:
    """MoCo ``.pth.tar`` -> the ``nn.vit.ViT`` state dict of its base
    encoder without a head (``mfvit_tpu/exp/checkpoint.py:168``): strip
    ``module.base_encoder.``, drop the projector that replaced ``head``,
    and keep the fixed position table of the port for sincos configs."""
    sd = strip_prefix(load_torch_state_dict(path), "module.base_encoder.")
    sd = {k: v.float() for k, v in sd.items() if not k.startswith("head.")}
    if not cfg.learned_pos:
        sd["pos_embed"] = posembed.sincos_2d(cfg.grid, cfg.grid, cfg.dim)
    want = {"patch_embed.proj.weight", "cls_token", "norm.weight"}
    if not want <= set(sd):
        raise ValueError(f"{path}: no MoCo base encoder under "
                         "'module.base_encoder.'")
    return sd
