"""Batch inference: the MF-ViT fusion forward over a paired manifest,
writing predictions as JSON (the port of ``mfvit_tpu/cli/infer.py``).

    python -m mfvit_tpu_torch.cli.infer -a vit_small \\
        --checkpoint serving.pt --manifest paired.txt -b 256 \\
        [--int8 | --fusion-arch gpt [--gpt-layers 8]]
        [--attn-backend xla] [--report-throughput] [--device cuda]

The checkpoint is a ``mfvit_tpu_torch.exp.checkpoint.save_serving`` file
(fp32), a ``model_best`` of ``mfvit_tpu_torch.cli.fuse``, or JAX
``fuse``'s orbax ``model_best`` directory, read by ``exp/orbax_io.py``
where ``tensorstore`` is importable (elsewhere it exits naming ``python
-m mfvit_tpu_torch.tools.convert_orbax ... --kind serving``, to run on
the host that wrote it). The network
input is ``--crop`` pixels square (``--img-size`` the resize before the
center crop): at 224 the blocks run K1, past 256 tokens (``--img-size 384
--crop 384``: 577) K9. ``--int8`` quantizes both ViT branches after
loading (``nn.vit.quantize_vit_for_serving``): their blocks then run K11
and, for the attention half, the W8A8 K10 or K9 on the dequantized
weights, by the JAX package's rule (vit_small at 384: K9). ``--fusion-arch
gpt`` serves a ``fuse --fusion-arch gpt`` checkpoint through the GPT head
(plain PyTorch, as it is XLA in JAX) at the input size it was trained at,
since its joint position table is learned; ``--int8`` takes the CA head
only, as in JAX. The output JSON holds ``predictions``, ``logits`` and
``n``; when every label of the manifest is >= 0, a ``metrics`` block
(``auc``, ``top1``, ``precision``, ``recall``, ``f1``); with
``--report-throughput`` also ``pairs_per_sec`` (device-resident batch) and
``pairs_per_sec_e2e`` (the whole run, host decode included). The host
sends uint8 canvases, normalised on the device; under ``--aug-host`` it
sends the host stack's normalised floats, which are only cast.
``--attn-backend xla`` runs JAX's XLA route (``nn/xla_route.py``) in the
branches and the head, no kernel; the first line printed names the route.
``--mesh-devices N`` (JAX's data mesh, infer.py:105-110) holds one replica
of the models on each of cuda:0..N-1 and runs each batch as N row blocks,
one a replica, the logits concatenated in order (under ``--device cpu``, N
replicas on the CPU); the default takes the most visible cards that
divide the batch.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.data import device_aug
from mfvit_tpu_torch.exp import checkpoint as ckpt_mod
from mfvit_tpu_torch.nn import vit as vit_mod
from mfvit_tpu_torch.train import metrics
from mfvit_tpu_torch.train import steps as steps_mod

FLAVORS = ("data", "Train_Mix")  # the CXR and enhanced normalisations
THROUGHPUT_ITERS = 10  # timed forwards behind --report-throughput


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-infer")
    common.add_common_args(p)
    p.add_argument("--checkpoint", required=True,
                   help="serving checkpoint {'cxr','enh','fus'} "
                        "(exp.checkpoint.save_serving), the model_best "
                        "that cli/fuse.py saves (flat cxr./enh./fus. "
                        "entries), or JAX fuse's orbax model_best dir")
    p.add_argument("--manifest", required=True, help="paired manifest file")
    p.add_argument("--output", default="predictions.json")
    p.add_argument("--int8", action="store_true",
                   help="quantize ViT linears to int8 (W8A8 serving mode)")
    common.add_fusion_args(p)
    p.add_argument("--report-throughput", action="store_true")
    p.set_defaults(batch_size=256)
    return p


def load_models(args, cfg, device) -> dict:
    """The serving checkpoint's models on ``device`` in eval mode, both ViT
    branches quantized to int8 under ``--int8``."""
    ck = ckpt_mod.load_serving(args.checkpoint, cfg, args.fusion_arch)
    models = {
        "cxr": vit_mod.ViT(cfg, args.num_classes),
        "enh": vit_mod.ViT(cfg, args.num_classes),
        "fus": common.fusion_head(args, cfg),
    }
    for k, m in models.items():
        m.load_state_dict(ck[k], strict=True)
        m.to(device).eval()
    if args.int8:
        for k in ("cxr", "enh"):
            vit_mod.quantize_vit_for_serving(models[k])
    return models


def prepare(batch, device, dtype, aug_device: bool = True) -> list:
    """A loader batch's CXR and enhanced images -> normalised images in
    ``dtype`` on ``device``: uint8 canvases normalised there, or under
    ``--aug-host`` (``aug_device`` False) host-normalised floats cast."""
    xs = [torch.from_numpy(b).to(device) for b in batch[:2]]
    if not aug_device:
        return [x.to(dtype) for x in xs]
    return [device_aug.augment_batch(x, img_type=flavor, out_dtype=dtype)
            for x, flavor in zip(xs, FLAVORS)]


def replica_devices(device: torch.device, n: int) -> list:
    """The devices of ``n`` replicas: ``device`` alone for one, else
    cuda:0..n-1 (raising past the visible cards), or n times the CPU."""
    if n == 1:
        return [device]
    if device.type == "cpu":
        return [device] * n
    have = torch.cuda.device_count()
    if n > have:
        raise SystemExit(f"--mesh-devices {n}: {have} CUDA devices are "
                         "visible here")
    return [torch.device("cuda", i) for i in range(n)]


def split_forward(forward, replicas: list, devices: list):
    """``forward(models, xc, xe) -> logits`` over len(devices) replicas:
    the batch's row blocks, block i on ``devices[i]`` through
    ``replicas[i]``, the logits concatenated in order on the first
    device."""
    if len(devices) == 1:
        return lambda xc, xe: forward(replicas[0], xc, xe)

    def run(xc, xe):
        n = len(devices)
        outs = [forward(m, c.to(d), e.to(d)).to(devices[0])
                for m, d, c, e in zip(replicas, devices, xc.chunk(n),
                                      xe.chunk(n))]
        return torch.cat(outs)

    return run


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.int8 and args.fusion_arch == "gpt":
        raise SystemExit("--int8 serving is wired for the CA fusion path "
                         "only")
    common.print_route(args)
    device = common.resolve_device(args.device)
    cfg = common.get_vit_arch(args)
    dt = common.compute_dtype(args)
    devices = replica_devices(device, common.setup_mesh(args))
    replicas = [load_models(args, cfg, d) for d in devices]
    # the forward fuse selected model_best with, so serving cannot drift
    fwd3 = steps_mod.make_fusion_forward(compute_dtype=dt,
                                         fusion_arch=args.fusion_arch,
                                         attn_backend=args.attn_backend)

    def decision(models, xc, xe):
        fused, lc, le = fwd3(models, xc, xe)
        return fused + lc + le

    forward = split_forward(decision, replicas, devices)

    loader = common.make_paired_loader(args, args.manifest)
    n_total = len(loader.ds)
    t0 = time.perf_counter()
    logits, labels = [], []
    for b in loader:
        logits.append(forward(*prepare(b, device, dt, args.aug_device))
                      .cpu().numpy())
        labels.append(np.asarray(b[2]))
    logits = np.concatenate(logits)[:n_total]
    labels = np.concatenate(labels)[:n_total]
    wall = time.perf_counter() - t0

    out = {
        "predictions": logits.argmax(-1).tolist(),
        "logits": logits.tolist(),
        "n": int(len(logits)),
    }
    if (labels >= 0).all():
        out["metrics"] = {
            "auc": metrics.macro_ovr_auc(logits, labels, args.num_classes),
            "top1": metrics.top1_acc(logits, labels),
            **metrics.precision_recall_f1(logits, labels, args.num_classes),
        }
    if args.report_throughput:
        out["pairs_per_sec_e2e"] = len(logits) / wall
        # forward throughput on one device-resident batch, the logits
        # fetched to the host every iteration
        xc0, xe0 = prepare(next(iter(loader)), device, dt, args.aug_device)
        forward(xc0, xe0).cpu()  # warm
        t0 = time.perf_counter()
        for _ in range(THROUGHPUT_ITERS):
            forward(xc0, xe0).cpu()
        out["pairs_per_sec"] = (xc0.shape[0] * THROUGHPUT_ITERS
                                / (time.perf_counter() - t0))
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("predictions", "logits")}))
    return out


if __name__ == "__main__":
    main()
