#!/usr/bin/env python3
"""Drive the PyTorch port's MF-ViT CA serving path once on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, in order; any failure raises and exits non-zero:

1. environment: torch, CUDA, nvcc and Triton versions, the card's name and
   power limit (nvidia-smi); no CUDA -> exit 1 with no result;
2. build: the kernels of mfvit_tpu_torch/csrc, from source (build seconds);
3. every kernel (K1-K4) against its plain PyTorch version at serving
   shapes (ViT-S/16: B=8, N=197, D=384, 12 heads; fusion 3 heads of 128),
   bf16 inputs from a seeded generator, the plain version in fp32 on the
   same bf16-rounded inputs: rel = max|diff| / max|ref| < 2e-2;
4. the slice through its entry point: 64 synthetic PNG pairs, vit_small and
   fusion weights from a seed, ``mfvit_tpu_torch.cli.infer.main`` at B=32 on
   the card; n, finite logits, launch counts (K1 24, K2 22, K3 2, K4 1 per
   forward), and decision logits within rel 2e-2 of the plain path in bf16
   on the card (top-1 agreement and rel against the plain fp32 path are
   printed for information: random heads nearly tie);
5. times with CUDA events at B=256: each kernel against its plain version,
   and end-to-end pairs/s of the kernel path against the plain path.

The last two lines are the kernel report (one JSON object) and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REL_BAR = 2e-2
KERNELS = [  # name, CUDA source, the Pallas kernel body it replaces
    ("fused_attention_block", "mfvit_tpu_torch/csrc/fused_attn.cu",
     "mfvit_tpu/ops/fused_attn.py:28"),
    ("fused_mlp_block", "mfvit_tpu_torch/csrc/fused_mlp.cu",
     "mfvit_tpu/ops/fused_mlp.py:62"),
    ("fused_mlp_block_final_ln", "mfvit_tpu_torch/csrc/fused_mlp.cu",
     "mfvit_tpu/ops/fused_mlp.py:137"),
    ("fused_fusion_cls", "mfvit_tpu_torch/csrc/fused_fusion.cu",
     "mfvit_tpu/ops/fused_fusion.py:85"),
]
PER_FORWARD = {"fused_attention_block": 24, "fused_mlp_block": 22,
               "fused_mlp_block_final_ln": 2, "fused_fusion_cls": 1}


def rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def phase(name: str) -> None:
    torch.cuda.synchronize()
    print(f"== {name}", flush=True)


def environment() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    from mfvit_tpu_torch.ops import build
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not importable")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    # the plain references: fp32 in full fp32, bf16 GEMMs with fp32 sums
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("allow_tf32: matmul False, cudnn False; "
          "allow_bf16_reduced_precision_reduction: False")
    return smi[0]


def block_inputs(g, B, D, dev):
    """One block's bf16 activations and weights, scaled so the attention
    and MLP branches are O(1) against the residual."""
    def r(*s, std=1.0):
        return (torch.randn(*s, generator=g) * std).to(dev)
    return dict(
        x=r(B, 197, D).bfloat16(), ln_s=1 + r(D, std=0.1),
        ln_b=r(D, std=0.1), wqkv=r(3 * D, D, std=D ** -0.5).bfloat16(),
        bqkv=r(3 * D, std=0.1), wproj=r(D, D, std=D ** -0.5).bfloat16(),
        bproj=r(D, std=0.1), w1=r(4 * D, D, std=D ** -0.5).bfloat16(),
        b1=r(4 * D, std=0.1), w2=r(D, 4 * D, std=(4 * D) ** -0.5).bfloat16(),
        b2=r(D, std=0.1), fs=1 + r(D, std=0.1), fb=r(D, std=0.1))


def fusion_inputs(g, B, D, dev):
    def r(*s, std=1.0):
        return (torch.randn(*s, generator=g) * std).to(dev)
    flat = []
    for _ in range(2):
        flat += [1 + r(D, std=0.1), r(D, std=0.1),
                 r(D, D, std=D ** -0.5).bfloat16(),
                 r(2 * D, D, std=D ** -0.5).bfloat16(),
                 r(D, D, std=D ** -0.5).bfloat16(), r(D, std=0.1),
                 1 + r(D, std=0.1), r(D, std=0.1)]
    return r(B, 197, D).bfloat16(), r(B, 197, D).bfloat16(), flat


ATTN = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
MLP = ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")


def kernel_calls(t, heads, tok_c, tok_e, flat, fusion_heads):
    """name -> (kernel call, plain call in the inputs' dtype, plain call in
    fp32 on the same values)."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_fusion as ff
    from mfvit_tpu_torch.ops import fused_mlp as fm
    scale = (t["x"].shape[-1] // heads) ** -0.5
    a = [t[k] for k in ATTN]
    m = [t[k] for k in MLP]
    a32 = [v.float() for v in a]
    m32 = [v.float() for v in m]
    f32 = [v.float() for v in flat]
    fin = (t["fs"], t["fb"])
    return {
        "fused_attention_block": (
            lambda: fa.fused_attention_block(*a, heads, scale),
            lambda: fa.fused_attention_block_plain(*a, heads, scale),
            lambda: fa.fused_attention_block_plain(*a32, heads, scale)),
        "fused_mlp_block": (
            lambda: fm.fused_mlp_block(*m),
            lambda: fm.fused_mlp_block_plain(*m),
            lambda: fm.fused_mlp_block_plain(*m32)),
        "fused_mlp_block_final_ln": (
            lambda: fm.fused_mlp_block_final_ln(*m, *fin),
            lambda: fm.fused_mlp_block_final_ln_plain(*m, *fin),
            lambda: fm.fused_mlp_block_final_ln_plain(*m32, *fin)),
        "fused_fusion_cls": (
            lambda: torch.cat(ff.fused_fusion_cls(tok_c, tok_e, flat,
                                                  fusion_heads)),
            lambda: torch.cat(ff.fused_fusion_cls_plain(tok_c, tok_e, flat,
                                                        fusion_heads)),
            lambda: torch.cat(ff.fused_fusion_cls_plain(
                tok_c.float(), tok_e.float(), f32, fusion_heads))),
    }


def check_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    t = block_inputs(g, 8, 384, dev)
    tok_c, tok_e, flat = fusion_inputs(g, 8, 384, dev)
    errs = {}
    for name, (kern, _, plain32) in kernel_calls(t, 12, tok_c, tok_e, flat,
                                                 3).items():
        got = kern()
        torch.cuda.synchronize()
        ref = plain32()
        r = rel(got, ref)
        errs[name] = (got.float() - ref).abs().max().item()
        extra = ""
        if name in ("fused_attention_block", "fused_mlp_block"):
            x = t["x"].float()
            extra = (f" (the branch without the residual: rel "
                     f"{rel(got.float() - x, ref - x):.3e})")
        print(f"{name}: rel {r:.3e}, max_abs_err {errs[name]:.3e}{extra}")
        if not (math.isfinite(r) and r < REL_BAR):
            raise AssertionError(f"{name}: rel {r} >= {REL_BAR}")
    return errs


def write_pairs(root: str, n: int, seed: int) -> str:
    import cv2

    from mfvit_tpu_torch.data.manifest import write_covid_manifest
    rng = np.random.default_rng(seed)
    for folder in ("data", "Train_Mix"):
        os.makedirs(os.path.join(root, "images", folder))
    names = [f"pair_{i:03d}.png" for i in range(n)]
    yy, xx = np.mgrid[0:256, 0:288]
    for i, fn in enumerate(names):
        for folder in ("data", "Train_Mix"):
            img = rng.integers(0, 60, (256, 288, 3), np.uint8)
            img += ((np.sin(xx / (9 + i % 7)) + np.cos(yy / 13)) * 90
                    + 100).astype(np.uint8)[..., None]
            cv2.imwrite(os.path.join(root, "images", folder, fn), img)
    man = os.path.join(root, "paired.txt")
    write_covid_manifest(man, os.path.join(root, "images"), names,
                         [i % 3 for i in range(n)])
    return man


def run_slice(dev, tmp: str) -> dict:
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import common, infer
    from mfvit_tpu_torch.exp.checkpoint import save_serving
    from mfvit_tpu_torch.models.fusion import Fusion
    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train.steps import make_fusion_forward

    n, bs = 64, 32
    man = write_pairs(tmp, n, seed=0)
    cfg = get_config("vit_small")
    seeds = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    ckpt = os.path.join(tmp, "serving.pt")
    save_serving(ckpt, ViT(cfg, 3, generator=seeds[0]).state_dict(),
                 ViT(cfg, 3, generator=seeds[1]).state_dict(),
                 Fusion(3, cfg.dim, 3, generator=seeds[2]).state_dict())
    argv = ["-a", "vit_small", "-b", str(bs), "--device", dev.type,
            "--report-throughput", "--checkpoint", ckpt, "--manifest", man,
            "--output", os.path.join(tmp, "predictions.json"), "-j", "8"]

    ops.reset_launch_counts()
    out = infer.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    forwards = -(-n // bs) + 1 + infer.THROUGHPUT_ITERS
    print(f"launch counts {counts} over {forwards} forwards")
    want = {k: v * forwards for k, v in PER_FORWARD.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    logits = torch.tensor(out["logits"])
    if out["n"] != n or logits.shape != (n, 3) or not logits.isfinite().all():
        raise AssertionError(f"bad infer output: n={out['n']}, "
                             f"shape={tuple(logits.shape)}")

    # the same weights and batches through the plain path on the card
    args = infer.build_parser().parse_args(argv)
    models = infer.load_models(args, cfg, dev)
    loader = common.make_paired_eval_loader(args, man)
    def outputs(dt, reference):  # (3, n, classes): fused, cxr, enh
        fwd = make_fusion_forward(compute_dtype=dt, reference=reference)
        return torch.cat([torch.stack([o.cpu() for o in fwd(
            models, *infer.prepare(b, dev, dt))]) for b in loader], 1)[:, :n]

    plain16 = outputs(torch.bfloat16, True)
    plain32 = outputs(torch.float32, True)
    kern = outputs(torch.bfloat16, False)
    r16, r32 = rel(logits, plain16.sum(0)), rel(logits, plain32.sum(0))
    top1 = (logits.argmax(-1) == plain32.sum(0).argmax(-1)).float()
    print(f"decision logits: rel vs plain bf16 {r16:.3e} (bar {REL_BAR}); "
          f"for information: rel vs plain fp32 {r32:.3e}, top-1 agreement "
          f"with plain fp32 {top1.mean().item():.3f}; per output vs plain "
          "bf16: " + ", ".join(f"{k} {rel(kern[i], plain16[i]):.3e}" for i, k
                                in enumerate(("fused", "cxr", "enh"))))
    if not r16 < REL_BAR:
        raise AssertionError(f"decision logits rel {r16} >= {REL_BAR}")
    print(f"infer: pairs_per_sec {out['pairs_per_sec']:.1f}, "
          f"pairs_per_sec_e2e {out['pairs_per_sec_e2e']:.1f} (B={bs}, n={n})")
    return counts


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(dev) -> dict:
    g = torch.Generator().manual_seed(1)
    t = block_inputs(g, 256, 384, dev)
    tok_c, tok_e, flat = fusion_inputs(g, 256, 384, dev)
    times = {}
    with torch.inference_mode():
        for name, (kern, plain, _) in kernel_calls(t, 12, tok_c, tok_e,
                                                   flat, 3).items():
            # kernel, plain, plain, kernel: the card's clock drifts
            k1, p1, p2, k2 = (cuda_ms(f, 10) for f in (kern, plain, plain,
                                                       kern))
            times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"{name} at B=256: kernel {k1:.3f}/{k2:.3f} ms, plain "
                  f"{p1:.3f}/{p2:.3f} ms (bf16)")
    return times


def time_e2e(dev) -> dict:
    from mfvit_tpu_torch.models.fusion import Fusion
    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train.steps import make_fusion_forward

    cfg = get_config("vit_small")
    gens = [torch.Generator().manual_seed(s) for s in (4, 5, 6, 7)]
    models = {"cxr": ViT(cfg, 3, device=dev, generator=gens[0]).eval(),
              "enh": ViT(cfg, 3, device=dev, generator=gens[1]).eval(),
              "fus": Fusion(3, cfg.dim, 3, device=dev,
                            generator=gens[2]).eval()}
    B = 256
    xc = torch.randn(B, 224, 224, 3, generator=gens[3]).to(dev, torch.bfloat16)
    xe = torch.randn(B, 224, 224, 3, generator=gens[3]).to(dev, torch.bfloat16)
    fwds = {"kernel": make_fusion_forward(),
            "plain": make_fusion_forward(reference=True)}

    def rate(which: str, iters: int = 5) -> float:
        fwd = fwds[which]
        sum(fwd(models, xc, xe)).cpu()
        t0 = time.perf_counter()
        for _ in range(iters):
            sum(fwd(models, xc, xe)).cpu()  # decision logits to the host
        return B * iters / (time.perf_counter() - t0)

    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        runs[which].append(rate(which))
    out = {k: sum(v) / len(v) for k, v in runs.items()}
    print("end to end at B=256 (bf16, logits fetched every forward): "
          + ", ".join(f"{k} {' / '.join(f'{r:.1f}' for r in v)} pairs/s"
                      for k, v in runs.items()))
    return out


def main() -> int:
    smi = environment()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    phase("build")
    from mfvit_tpu_torch.ops import build
    built = build.library_path().exists()
    t0 = time.perf_counter()
    build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}"
          + (" (already built)" if built else ""))

    phase("kernels against their plain versions (B=8)")
    errs = check_kernels(dev)

    phase("the slice through mfvit_tpu_torch.cli.infer (vit_small, B=32)")
    with tempfile.TemporaryDirectory() as tmp:
        counts = run_slice(dev, tmp)

    phase("times (B=256)")
    times = time_kernels(dev)
    e2e = time_e2e(dev)
    phase("done")

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, src, rep in KERNELS]}
    print(json.dumps({"e2e_pairs_per_sec_B256": e2e, "card": smi}))
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
