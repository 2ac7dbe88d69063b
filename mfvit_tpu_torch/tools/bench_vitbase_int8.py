"""vit_base serving, bf16 against int8 W8A8, the port of
``tools/bench_vitbase_int8.py``.

    python -m mfvit_tpu_torch.tools.bench_vitbase_int8 [--device cuda]

One vit_base classifier (3 classes) from a seeded ``torch.Generator``,
B=256 images N(0, 1) in bf16 (JAX :14-17; ``bench_latency.images``).
Each form runs 2 warm-ups, then 10 forwards with the logits fetched one
forward behind (``card.lag_seconds``, JAX :19-30): first bf16 (per
forward K1 12, K2 11, K3 1), then the same model after
``nn.vit.quantize_vit_for_serving`` (K10 12, K11 12 and nothing else). It prints ms and images/s of each,
then the top-1 agreement of the two forms' last logits and the largest
logit drift between them (JAX :32-36). The JAX docstring's TPU readings
are that package's, not the port's. ``--device cpu`` runs the plain
versions (a smoke test, not a measurement of any device).
"""
from __future__ import annotations

import argparse

import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.nn import vit
from mfvit_tpu_torch.tools import bench_latency, card

B = 256
ITERS, WARMUP = 10, 2


def make_model(device, cfg: vit.ViTConfig = None, seed: int = 0) -> vit.ViT:
    cfg = cfg or vit.get_config("vit_base")
    return vit.ViT(cfg, 3, generator=torch.Generator().manual_seed(seed)
                   ).to(device).eval()


def forward_fn(model: vit.ViT, dt: torch.dtype = torch.bfloat16):
    return torch.inference_mode()(
        lambda img: model(img, compute_dtype=dt))


def time_form(model, img, label: str, iters: int = ITERS,
              warmup: int = WARMUP,
              dt: torch.dtype = torch.bfloat16) -> tuple:
    """(seconds per forward, the last logits (fp32, host)), printed."""
    fwd = forward_fn(model, dt)
    last = {}

    def call():
        last["logits"] = fwd(img)
        return last["logits"]

    print(f"compiling {label}...", flush=True)
    sec = card.lag_seconds(call, iters, warmup)
    print(f"{label}: {sec * 1000:.1f} ms  {img.shape[0] / sec:.0f} img/s",
          flush=True)
    return sec, last["logits"].float().cpu()


def agreement(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(top-1 agreement, the largest |a - b|)."""
    return ((a.argmax(-1) == b.argmax(-1)).float().mean().item(),
            (a - b).abs().max().item())


def run(device, batch: int = B, iters: int = ITERS, warmup: int = WARMUP,
        model: vit.ViT = None) -> dict:
    """Both forms on the same images; ``model`` is quantized in place."""
    model = model if model is not None else make_model(device)
    cfg = model.cfg
    img = bench_latency.images(batch, cfg, device)
    bf16_s, a = time_form(model, img, f"{cfg.name} bf16 ", iters, warmup)
    vit.quantize_vit_for_serving(model)
    int8_s, b = time_form(model, img, f"{cfg.name} int8 ", iters, warmup)
    agree, drift = agreement(a, b)
    print(f"top-1 agreement: {agree:.3f}, max logit drift {drift:.3f}")
    return {"bf16_ms": bf16_s * 1e3, "int8_ms": int8_s * 1e3,
            "bf16_img_s": batch / bf16_s, "int8_img_s": batch / int8_s,
            "top1_agreement": agree, "max_logit_drift": drift,
            "logits_bf16": a, "logits_int8": b}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-bench-vitbase-int8")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    card.note(device)
    return run(device)


if __name__ == "__main__":
    main()
