"""The weight bridge from JAX parameter trees, the port's serving
checkpoint, the training checkpoints (``BestKeeper``, the pretrain
checkpoints), the JAX package's orbax checkpoints (``load_serving`` and
``load_pretrain_checkpoint`` take their directories, through
``orbax_io.read_tree``), the reference MoCo ``.pth.tar`` (its surgery and
its export), the reference ``Fus_CrossViT`` head's ``.pth.tar``
(``load_reference_fusion``) and the torchvision ResNet arms.

``vit_state_from_jax``, ``vit_int8_state_from_jax``,
``vit_quant_state_from_jax``, ``fusion_state_from_jax``,
``gpt_fusion_state_from_jax``, ``crossvit_cnn_state_from_jax``,
``resnet_state_from_jax`` and ``moco_state_from_jax`` take the JAX
package's parameter trees as nested dicts of numpy arrays
(``mfvit_tpu/nn/vit.py::init``, ``mfvit_tpu/models/fusion.py::init``,
``gpt_fusion.py::init``, ``crossvit_cnn.py::init``,
``mfvit_tpu/nn/resnet.py::init`` and ``mfvit_tpu/ssl/moco.py::init``
layouts) and return the port's state dicts, under the MoCo-v3 ``vits.py``
/ reference ``Fus_CrossViT`` / ``GPT`` / torchvision names that
``mfvit_tpu/exp/checkpoint.py::params_to_torch_vit`` (:313),
``fusion_params_to_torch`` (:362) and ``torch_resnet_to_params`` (:182)
use. Linear weights go from JAX's (in, out) to torch's (out, in); the patch
projection (P*P*C, D) becomes the conv weight (D, C, P, P), an HWIO
convolution torch's OIHW. C is read from the tree, so the 4-channel
trees of ``init(..., in_chans=4)`` convert as the 3-channel ones do.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from mfvit_tpu_torch.exp import orbax_io
from mfvit_tpu_torch.nn import posembed


def _t(x) -> torch.Tensor:
    """A leaf as an fp32 tensor of its own (a bf16 one, as ``read_tree``
    gives it, through ``orbax_io.to_torch``)."""
    return orbax_io.to_torch(np.array(x)).float()


def vit_state_from_jax(tree, cfg) -> dict:
    """JAX ViT tree -> ``nn.vit.ViT`` state dict. A quantized patch
    projection (``{"wq": ..., "b"}``) becomes ``Int8Linear`` buffers."""
    D, P = cfg.dim, cfg.patch
    sd = {}
    if "stem" in tree["patch"]:
        _conv_stem_from_jax(sd, tree["patch"])
    elif "wq" in tree["patch"]:
        _int8_from_jax(sd, "patch_embed.proj.", tree["patch"]["wq"],
                       tree["patch"]["b"])
    else:
        pw = np.asarray(tree["patch"]["w"])  # (P*P*C, D), (ph, pw, c) order
        C = pw.shape[0] // (P * P)
        sd["patch_embed.proj.weight"] = _t(pw.reshape(P, P, C, D)
                                           .transpose(3, 2, 0, 1))
        sd["patch_embed.proj.bias"] = _t(tree["patch"]["b"])
    sd.update({
        "cls_token": _t(tree["cls"]),
        "pos_embed": (_t(tree["pos"]) if cfg.learned_pos
                      else posembed.sincos_2d(cfg.grid, cfg.grid, D)),
        "norm.weight": _t(tree["norm"]["scale"]),
        "norm.bias": _t(tree["norm"]["bias"]),
    })
    for i, blk in enumerate(tree["blocks"]):
        b = f"blocks.{i}."
        _norms_from_jax(sd, b, blk)
        for name, p in (("attn.qkv", blk["qkv"]), ("attn.proj", blk["proj"]),
                        ("mlp.fc1", blk["mlp"]["fc1"]),
                        ("mlp.fc2", blk["mlp"]["fc2"])):
            sd[b + name + ".weight"] = _t(np.asarray(p["w"]).T)
            if "b" in p:  # a ConvStem arch's qkv has none
                sd[b + name + ".bias"] = _t(p["b"])
    if "head" in tree:
        sd["head.weight"] = _t(np.asarray(tree["head"]["w"]).T)
        sd["head.bias"] = _t(tree["head"]["b"])
    return sd


def _conv_from_jax(w) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def _bn_from_jax(sd: dict, prefix: str, bn) -> None:
    """A BatchNorm's scale, bias and running statistics (an affine-free
    one has no scale and bias)."""
    if "scale" in bn:
        sd[prefix + "weight"] = _t(bn["scale"])
        sd[prefix + "bias"] = _t(bn["bias"])
    sd[prefix + "running_mean"] = _t(bn["mean"])
    sd[prefix + "running_var"] = _t(bn["var"])
    sd[prefix + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _conv_stem_from_jax(sd: dict, patch) -> None:
    """A ConvStem (``{"stem": [conv, bn] x 4, "proj"}``) -> ``vits.py``'s
    ``patch_embed.proj.{0,1,3,4,6,7,9,10,12}``."""
    pre = "patch_embed.proj."
    for i, layer in enumerate(patch["stem"]):
        sd[f"{pre}{3 * i}.weight"] = _conv_from_jax(layer["conv"]["w"])
        _bn_from_jax(sd, f"{pre}{3 * i + 1}.", layer["bn"])
    sd[pre + "12.weight"] = _conv_from_jax(patch["proj"]["w"])
    sd[pre + "12.bias"] = _t(patch["proj"]["b"])


def resnet_state_from_jax(tree, cfg) -> dict:
    """JAX ResNet tree -> ``nn.resnet.ResNet`` state dict (torchvision
    names), the inverse of ``torch_resnet_to_params`` (:182)."""
    sd = {"conv1.weight": _conv_from_jax(tree["stem"]["conv"]["w"])}
    _bn_from_jax(sd, "bn1.", tree["stem"]["bn"])
    for s, stage in enumerate(tree["stages"]):
        for b, blk in enumerate(stage):
            pre = f"layer{s + 1}.{b}."
            for i in (1, 2, 3):
                if f"conv{i}" in blk:
                    sd[f"{pre}conv{i}.weight"] = _conv_from_jax(
                        blk[f"conv{i}"]["w"])
                    _bn_from_jax(sd, f"{pre}bn{i}.", blk[f"bn{i}"])
            if "down_conv" in blk:
                sd[pre + "downsample.0.weight"] = _conv_from_jax(
                    blk["down_conv"]["w"])
                _bn_from_jax(sd, pre + "downsample.1.", blk["down_bn"])
    if "fc" in tree:
        sd["fc.weight"] = _t(np.asarray(tree["fc"]["w"]).T)
        sd["fc.bias"] = _t(tree["fc"]["b"])
    return sd


def _mlp_from_jax(sd: dict, prefix: str, mlp) -> None:
    """A MoCo MLP stack (``{"layers": [...]}``) -> its ``nn.Sequential``
    numbering (Linear[, BN, ReLU | ReLU] per hidden layer, Linear[, BN]),
    as ``_mlp_params_to_torch_seq`` (:393) numbers it."""
    idx = 0
    for layer in mlp["layers"]:
        sd[f"{prefix}{idx}.weight"] = _t(np.asarray(layer["lin"]["w"]).T)
        if "b" in layer["lin"]:
            sd[f"{prefix}{idx}.bias"] = _t(layer["lin"]["b"])
        idx += 1
        if "bn" in layer:
            _bn_from_jax(sd, f"{prefix}{idx}.", layer["bn"])
            idx += 2
        elif "relu_marker" in layer:
            idx += 1
        elif "bn_noaffine" in layer:
            _bn_from_jax(sd, f"{prefix}{idx}.", layer["bn_noaffine"])
            idx += 1


def moco_state_from_jax(state, mcfg, backbone_cfg) -> dict:
    """JAX MoCo state (``mfvit_tpu/ssl/moco.py::init``) -> the state dict
    of ``ssl.moco.MoCo(mcfg, backbone_cfg)``."""
    from mfvit_tpu_torch.nn.vit import ViTConfig
    enc = (vit_state_from_jax if isinstance(backbone_cfg, ViTConfig)
           else resnet_state_from_jax)
    sd = {}
    for tower in ("base", "momentum"):
        for k, v in enc(state[tower]["encoder"], backbone_cfg).items():
            sd[f"{tower}.encoder.{k}"] = v
        _mlp_from_jax(sd, f"{tower}.projector.", state[tower]["projector"])
    _mlp_from_jax(sd, "predictor.", state["predictor"])
    sd["queue"] = _t(state["queue"])
    sd["queue_ptr"] = torch.tensor(int(np.asarray(state["queue_ptr"])),
                                   dtype=torch.long)
    return sd


def _norms_from_jax(sd: dict, prefix: str, blk) -> None:
    for name, p in (("norm1", blk["norm1"]), ("norm2", blk["norm2"])):
        sd[prefix + name + ".weight"] = _t(p["scale"])
        sd[prefix + name + ".bias"] = _t(p["bias"])


def _int8_from_jax(sd: dict, prefix: str, qs, b) -> None:
    """One quantized linear: int8 ``q`` (in, out) -> ``q`` (out, in), its
    scales ``s`` and the bias ``b`` as ``s`` and ``bias``."""
    q = np.ascontiguousarray(np.asarray(qs["q"], np.int8).T)
    sd[prefix + "q"] = torch.from_numpy(q)
    sd[prefix + "s"] = _t(qs["s"])
    sd[prefix + "bias"] = _t(b)


def vit_int8_state_from_jax(qtree, cfg) -> dict:
    """JAX int8 serving tree (``mfvit_tpu/ops/fused_int8.py::
    quantize_vit_for_serving``) -> the state dict of an ``nn.vit.ViT``
    after ``nn.vit.quantize_vit_for_serving``: each ``qkv8``/``proj8``/
    ``fc18``/``fc28`` entry as ``_int8_from_jax`` maps it."""
    sd = vit_state_from_jax(dict(qtree, blocks=[]), cfg)
    for i, blk in enumerate(qtree["blocks"]):
        b = f"blocks.{i}."
        _norms_from_jax(sd, b, blk)
        for name, key in (("attn.qkv", "qkv8"), ("attn.proj", "proj8"),
                          ("mlp.fc1", "fc18"), ("mlp.fc2", "fc28")):
            _int8_from_jax(sd, b + name + ".", blk[key], blk[key]["b"])
    return sd


def vit_quant_state_from_jax(qtree, cfg) -> dict:
    """JAX XLA-level W8A8 tree (``mfvit_tpu/ops/quant.py::
    quantize_vit_params``) -> the state dict of an ``nn.vit.ViT`` after
    ``nn.vit.quantize_vit_params``: every ``{"wq": {"q", "s"}, "b"}``
    entry, the patch projection's included, as ``_int8_from_jax`` maps
    it."""
    sd = vit_state_from_jax(dict(qtree, blocks=[]), cfg)
    for i, blk in enumerate(qtree["blocks"]):
        b = f"blocks.{i}."
        _norms_from_jax(sd, b, blk)
        for name, p in (("attn.qkv", blk["qkv"]), ("attn.proj", blk["proj"]),
                        ("mlp.fc1", blk["mlp"]["fc1"]),
                        ("mlp.fc2", blk["mlp"]["fc2"])):
            _int8_from_jax(sd, b + name + ".", p["wq"], p["b"])
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


def _linear_from_jax(sd: dict, prefix: str, p) -> None:
    sd[prefix + "weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[prefix + "bias"] = _t(p["b"])


def _ln_from_jax(sd: dict, prefix: str, p) -> None:
    sd[prefix + "weight"] = _t(p["scale"])
    sd[prefix + "bias"] = _t(p["bias"])


def gpt_fusion_state_from_jax(tree) -> dict:
    """JAX GPT fusion tree (``mfvit_tpu/models/gpt_fusion.py::init``) ->
    ``models.gpt_fusion.GPTFusion`` state dict (the reference ``GPT``
    names)."""
    sd = {"pos_emb": _t(tree["pos_emb"])} if "pos_emb" in tree else {}
    for i, blk in enumerate(tree["blocks"]):
        b = f"blocks.{i}."
        _ln_from_jax(sd, b + "ln1.", blk["ln1"])
        _ln_from_jax(sd, b + "ln2.", blk["ln2"])
        for name, key in (("attn.query", "q"), ("attn.key", "k"),
                          ("attn.value", "v"), ("attn.proj", "proj"),
                          ("mlp.0", "fc1"), ("mlp.2", "fc2")):
            _linear_from_jax(sd, f"{b}{name}.", blk[key])
    _ln_from_jax(sd, "ln_f.", tree["ln_f"])
    _linear_from_jax(sd, "head.", tree["head"])
    return sd


def crossvit_cnn_state_from_jax(tree) -> dict:
    """JAX ViT + CNN cross-attention tree
    (``mfvit_tpu/models/crossvit_cnn.py::init``) ->
    ``models.crossvit_cnn.CrossViTCNN`` state dict (the same names)."""
    sd = {}
    for e, enc in enumerate(tree["encoders"]):
        for l, lay in enumerate(enc["layers"]):
            b = f"encoders.{e}.layers.{l}."
            for name in ("f_sl", "g_ls", "to_qkv", "to_out"):
                _linear_from_jax(sd, f"{b}{name}.", lay[name])
            _ln_from_jax(sd, b + "norm.", lay["norm"])
    _ln_from_jax(sd, "head_norm.", tree["head_norm"])
    _linear_from_jax(sd, "head.", tree["head"])
    return sd


def save_serving(path: str, cxr: dict, enh: dict, fus: dict) -> None:
    """One ``torch.save`` file {"cxr": sd, "enh": sd, "fus": sd} holding the
    two ViT branches and the fusion head (tensors moved to the CPU)."""
    def cpu(sd):
        return {k: v.detach().cpu() for k, v in sd.items()}
    torch.save({"cxr": cpu(cxr), "enh": cpu(enh), "fus": cpu(fus)}, path)


SERVING_KEYS = ("cxr", "enh", "fus")


def serving_from_jax(tree, cfg, fusion_arch: str = "ca") -> dict:
    """JAX ``fuse``'s ``model_best`` tree ``{'cxr', 'enh', 'fus'}`` -> the
    three state dicts of ``save_serving``: the branches through
    ``vit_state_from_jax``, the head through ``fusion_state_from_jax`` or,
    for ``fusion_arch="gpt"``, ``gpt_fusion_state_from_jax``, as JAX's
    ``infer`` builds its template by ``--fusion-arch``
    (``mfvit_tpu/cli/infer.py:44-77``). A tree of another layout raises."""
    if not isinstance(tree, dict) or set(tree) != set(SERVING_KEYS):
        raise ValueError("expected a fuse model_best tree with keys "
                         f"cxr/enh/fus, got {sorted(tree)}")
    gpt = "blocks" in tree["fus"]
    if gpt != (fusion_arch == "gpt"):
        raise ValueError(f"the fusion head is a {'GPT' if gpt else 'CA'} "
                         f"head; this run has --fusion-arch {fusion_arch}")
    fus = (gpt_fusion_state_from_jax if gpt else fusion_state_from_jax)(
        tree["fus"])
    return {"cxr": vit_state_from_jax(tree["cxr"], cfg),
            "enh": vit_state_from_jax(tree["enh"], cfg), "fus": fus}


def load_serving(path: str, cfg=None, fusion_arch: str = "ca") -> dict:
    """Inverse of ``save_serving`` (tensors only: ``weights_only=True``).
    It also takes the flat state dict of an ``nn.ModuleDict({"cxr", "enh",
    "fus"})``, the ``model_best`` that ``cli/fuse.py`` saves: the
    ``cxr.``/``enh.``/``fus.`` entries become the three state dicts. A
    directory is JAX ``fuse``'s orbax ``model_best``, read by
    ``orbax_io.read_tree`` (which needs ``cfg``) and bridged by
    ``serving_from_jax`` for ``fusion_arch``.

    With the branches' ``cfg``, the ViT entries are made to fit its input
    size: a fixed sin-cos position table is rebuilt for ``cfg``'s grid (it
    is a function of the input size, which the JAX package never stores),
    so a file saved at 224 px serves at 384; a learned table of another
    length raises, naming both input sizes. A GPT fusion head (a ``fus``
    group with a ``pos_emb``) is taken as it is, but its joint position
    table must hold both streams' tokens at ``cfg``'s size, or it
    raises, naming both lengths."""
    if os.path.isdir(path):
        if cfg is None:
            raise ValueError(f"{path}: an orbax directory needs the "
                             "branches' config")
        ck = serving_from_jax(orbax_io.read_tree(path, "serving"), cfg,
                              fusion_arch)
    else:
        ck = torch.load(path, map_location="cpu", weights_only=True)
    if set(ck) != set(SERVING_KEYS):
        groups = {k: {} for k in SERVING_KEYS}
        for name, v in ck.items():
            head, _, rest = name.partition(".")
            if head not in groups or not rest:
                raise ValueError(f"{path}: expected a serving checkpoint "
                                 "with keys cxr/enh/fus or a fusion "
                                 "model_best with cxr./enh./fus. entries, "
                                 f"got {name!r}")
            groups[head][rest] = v
        ck = groups
    if cfg is not None:
        for k in ("cxr", "enh"):
            pos = ck[k]["pos_embed"]
            if not cfg.learned_pos:
                ck[k]["pos_embed"] = posembed.sincos_2d(cfg.grid, cfg.grid,
                                                        cfg.dim)
            elif pos.shape[1] != cfg.seq_len:
                side = round((pos.shape[1] - 1) ** 0.5) * cfg.patch
                raise ValueError(
                    f"{path}: the {k} branch learned its position table at "
                    f"{side} px ({pos.shape[1]} tokens); it cannot serve "
                    f"{cfg.img_size} px ({cfg.seq_len} tokens)")
        pos = ck["fus"].get("pos_emb")
        if pos is not None and pos.shape[1] != 2 * cfg.seq_len:
            raise ValueError(
                f"{path}: the GPT fusion head learned its joint position "
                f"table for {pos.shape[1]} tokens; {cfg.img_size} px gives "
                f"{2 * cfg.seq_len} (two streams of {cfg.seq_len})")
    return ck


def load_reference_fusion(path: str, fus) -> None:
    """The reference ``Fus_CrossViT`` head's ``.pth.tar`` (its
    ``multi_scale_transformers.*`` and ``mlp_head_*``, a ``module.``
    prefix stripped) into ``fus``, a ``models.fusion.Fusion`` of the same
    depths, whose names are the reference's: the counterpart of
    ``mfvit_tpu/exp/checkpoint.py::torch_fusion_to_params`` (:258-310). A
    missing or an extra entry raises ValueError naming it."""
    sd = load_torch_state_dict(path)
    if any(k.startswith("module.") for k in sd):
        sd = strip_prefix(sd, "module.")
    want = set(fus.state_dict())
    missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
    if missing or extra:
        raise ValueError(f"{path}: not the Fus_CrossViT head of this "
                         f"fusion config (missing {missing}, unexpected "
                         f"{extra})")
    fus.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)


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

def load_vit_state(path: str, cfg) -> dict:
    """A single-branch ViT file -> the ``nn.vit.ViT`` state dict it holds,
    for a strict load (``mfvit_tpu/cli/fuse.py::load_branch`` :87-94): a
    reference ``.pth``/``.pth.tar``/``.pt`` (MoCo-v3 ``vits.py`` names, a
    ``module.`` prefix stripped) or the port's own ``finetune``
    ``model_best``. A fixed sin-cos position table is rebuilt for
    ``cfg``, as ``load_serving`` does."""
    sd = load_torch_state_dict(path)
    if any(k.startswith("module.") for k in sd):
        sd = strip_prefix(sd, "module.")
    sd = {k: v.float() for k, v in sd.items()}
    if not cfg.learned_pos:
        sd["pos_embed"] = posembed.sincos_2d(cfg.grid, cfg.grid, cfg.dim)
    return sd


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


# ------------------------------------------------------- MoCo pretraining

MOCO_TOWERS = (("base.encoder.", "module.base_encoder."),
               ("base.projector.", "module.base_encoder.head."),
               ("momentum.encoder.", "module.momentum_encoder."),
               ("momentum.projector.", "module.momentum_encoder.head."),
               ("predictor.", "module.predictor."))


def save_moco_torch_checkpoint(path: str, model, *, epoch: int = 0,
                               arch: str = "vit_small") -> None:
    """The reference-layout ``.pth.tar`` of ``mfvit_tpu/exp/checkpoint.py::
    save_moco_torch_checkpoint`` (:420), key for key: each tower's encoder
    under ``module.{base,momentum}_encoder.`` with its projector as
    ``head.*``, the predictor, ``module.queue`` and ``module.queue_ptr``
    (int64, shape (1,)), in ``{"epoch", "arch", "state_dict"}``. The
    BatchNorms' ``num_batches_tracked`` counters, which the JAX trees do
    not have, are left out."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.detach().cpu()
        if k == "queue":
            sd["module.queue"] = v
        elif k == "queue_ptr":
            sd["module.queue_ptr"] = v.reshape(1).to(torch.int64)
        else:
            old, new = next(t for t in MOCO_TOWERS if k.startswith(t[0]))
            sd[new + k[len(old):]] = v
    torch.save({"epoch": int(epoch), "arch": arch, "state_dict": sd}, path)


def save_pretrain_checkpoint(path: str, model, *, epoch: int,
                             opt=None) -> None:
    """The pretrain CLI's own checkpoint (``checkpoint_best_loss``,
    ``checkpoint_{epoch:04d}``): a ``torch.save`` of {"state": the MoCo
    state dict, "epoch"[, "opt_state": the optimizer's with its step
    count]}, the contents of JAX's orbax ones in a torch file."""
    ck = {"state": {k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, "epoch": int(epoch)}
    if opt is not None:
        ck["opt_state"] = opt.state_dict()
    torch.save(ck, path)


def moco_moments_from_jax(tree, mcfg, backbone_cfg) -> dict:
    """An optax moment tree over JAX's MoCo gradient parameters
    (``{"base": {"encoder", "projector"}, "predictor"}``,
    ``mfvit_tpu/cli/pretrain.py:175``) -> {``MoCo`` parameter name:
    tensor}, through ``moco_state_from_jax`` (the momentum tower's and the
    queue's entries, which no optimizer holds, come out too)."""
    state = {"base": tree["base"], "momentum": tree["base"],
             "predictor": tree["predictor"], "queue": np.zeros((1, 1)),
             "queue_ptr": 0}
    return moco_state_from_jax(state, mcfg, backbone_cfg)


def load_pretrain_checkpoint(path: str, model=None, opt=None) -> dict:
    """Inverse of ``save_pretrain_checkpoint``: {"state", "epoch"[,
    "opt_state"]}. A directory is a JAX ``pretrain`` checkpoint read by
    ``orbax_io.read_tree``: ``checkpoint_{epoch:04d}``'s {'state',
    'opt_state', 'epoch'} or ``checkpoint_best_loss``'s {'state',
    'epoch'} (``mfvit_tpu/cli/pretrain.py:203-216``), the state through
    ``moco_state_from_jax`` for ``model`` (a ``ssl.moco.MoCo`` of the same
    flags, ViT or ResNet arms) and the optimizer state through
    ``train.optim.opt_state_from_jax`` for ``opt`` (``build_optimizer``
    over ``model.trainable()``)."""
    if not os.path.isdir(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    from mfvit_tpu_torch.train import optim
    tree = orbax_io.read_tree(path, "pretrain")
    if not isinstance(tree, dict) or not {"state", "epoch"} <= set(tree):
        raise ValueError(f"{path}: not a pretrain checkpoint (keys "
                         f"{sorted(tree)})")
    mcfg, bcfg = model.cfg, model.backbone_cfg
    ck = {"state": moco_state_from_jax(tree["state"], mcfg, bcfg),
          "epoch": int(np.asarray(tree["epoch"]))}
    if "opt_state" in tree and opt is not None:
        ck["opt_state"] = optim.opt_state_from_jax(
            tree["opt_state"], opt.name, opt,
            lambda t: moco_moments_from_jax(t, mcfg, bcfg))
    return ck


def load_resnet_arms(model, path: str) -> None:
    """Both MoCo towers' ResNet encoders from a local torchvision state
    dict (``mfvit_tpu/exp/checkpoint.py::resnet_arms_from_torchvision``,
    :223): every convolution and BatchNorm, the classifier ``fc`` left
    out; each tower gets its own copy. With 4 input channels the towers
    keep their fresh stem convolution, as builder_4ch replaces ``conv1``
    after the pretrained load."""
    keep = {"conv1.weight"} if model.in_chans != 3 else set()
    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in load_torch_state_dict(path).items()
          if not k.startswith("fc.") and k not in keep}
    for tower in (model.base, model.momentum):
        missing, unexpected = tower.encoder.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")
                   and k not in keep]
        if missing or unexpected:
            raise ValueError(f"{path}: not a torchvision "
                             f"{model.backbone_cfg.name} state dict "
                             f"(missing {missing[:4]}, unexpected "
                             f"{unexpected[:4]})")
