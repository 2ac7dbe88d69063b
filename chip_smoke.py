#!/usr/bin/env python3
"""Drive the PyTorch port's MF-ViT CA serving path and its ViT fine-tuning
path once on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, in order; any failure raises and exits non-zero:

1. environment: torch, CUDA, nvcc and Triton versions, the card's name and
   power limit (nvidia-smi); no CUDA -> exit 1 with no result;
2. build: the kernels of mfvit_tpu_torch/csrc, from source (build seconds);
3. every forward kernel (K1-K4) against its plain PyTorch version at
   serving shapes (ViT-S/16: B=8, N=197, D=384, 12 heads; fusion 3 heads
   of 128), bf16 inputs from a seeded generator, the plain version in fp32
   on the same bf16-rounded inputs: rel = max|diff| / max|ref| < 2e-2;
4. the serving slice through its entry point: 64 synthetic PNG pairs,
   vit_small and fusion weights from a seed, ``mfvit_tpu_torch.cli.infer.
   main`` at B=32 on the card; n, finite logits, launch counts (K1 24, K2
   22, K3 2, K4 1 per forward), and decision logits within rel 2e-2 of the
   plain path in bf16 on the card;
5. the backward kernels K5 and K7 (K7 also through K3's backward) against
   their plain versions, all seven (nine) outputs, at vit_small block
   shapes (B=8 and B=32) and vit_base block shapes (B=2, D=768, 12 heads, hidden
   3072); bf16 inputs and cotangent, the plain backward in fp32 on the same
   values; rel < 2e-2 per output;
6. the training slice through its entry point: 64 synthetic PNGs in a
   ``--covid-ds`` layout and a MoCo ``.pth.tar`` from seeded weights;
   ``mfvit_tpu_torch.cli.finetune.main`` with ``-a vit_small
   --semi-supervised -b 32 --epochs 2 --draws 1`` (FT): the loss finite at
   every step, launch counts per step (K1 12, K2 11, K3 1, K5 12, K7 12)
   plus one forward per eval batch, the backbone changed; then LP (no
   ``--semi-supervised``): the CLI's frozen-backbone check passes and K5/K7
   count 0;
7. train-step parity: the kernel path and the plain path (bf16 on the
   card) from the same vit_small weights and batch (B=32), three SGD steps
   each: the loss per step within rel 1e-2, and each block's flattened
   first-step gradient within rel 5e-2;
8. times with CUDA events at B=256: each forward kernel and K5/K7 against
   its plain version (K5/K7 first held against the plain fp32 backward on
   the timed inputs), the end-to-end pairs/s of serving and the images/s
   of the FT train step, kernel path against plain path; the FT step
   also at B=16, the finetune CLI's default batch.

The last three lines are the end-to-end numbers, the kernel report (one
JSON object) and ``{"ok": true, "device": {...}}``.
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
PARITY_LOSS_BAR, PARITY_GRAD_BAR = 1e-2, 5e-2
KERNELS = [  # name, CUDA source, the Pallas kernel body it replaces
    ("fused_attention_block", "mfvit_tpu_torch/csrc/fused_attn.cu",
     "mfvit_tpu/ops/fused_attn.py:28"),
    ("fused_mlp_block", "mfvit_tpu_torch/csrc/fused_mlp.cu",
     "mfvit_tpu/ops/fused_mlp.py:62"),
    ("fused_mlp_block_final_ln", "mfvit_tpu_torch/csrc/fused_mlp.cu",
     "mfvit_tpu/ops/fused_mlp.py:137"),
    ("fused_fusion_cls", "mfvit_tpu_torch/csrc/fused_fusion.cu",
     "mfvit_tpu/ops/fused_fusion.py:85"),
    ("fused_attention_block_bwd", "mfvit_tpu_torch/csrc/fused_attn_bwd.cu",
     "mfvit_tpu/ops/fused_attn.py:385"),
    ("fused_mlp_block_bwd", "mfvit_tpu_torch/csrc/fused_mlp_bwd.cu",
     "mfvit_tpu/ops/fused_mlp.py:246"),
]
PER_FORWARD = {"fused_attention_block": 24, "fused_mlp_block": 22,
               "fused_mlp_block_final_ln": 2, "fused_fusion_cls": 1}
# one vit_small forward (12 blocks) and one FT training step
PER_VIT_FORWARD = {"fused_attention_block": 12, "fused_mlp_block": 11,
                   "fused_mlp_block_final_ln": 1}
PER_FT_STEP = {"fused_attention_block_bwd": 12, "fused_mlp_block_bwd": 12}
# the H100 SXM's published dense peaks at 700 W (NVIDIA data sheet)
PEAK = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


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
    want.update({k: 0 for k in PER_FT_STEP})  # inference runs no backward
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


def bound(ops: dict, nbytes: float) -> tuple:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over their type's peak (the
    largest over the types, since the tensor cores and the CUDA cores run
    at once), and which of the two it is."""
    t_ops = max(n / PEAK[k] for k, n in ops.items())
    t_mem = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def kernel_bounds(B: int, N: int, D: int, heads: int, Hd: int,
                  fusion_heads: int) -> dict:
    """name -> (bound ms, bound_by) at these shapes: each input read once
    and each output written once, in the dtypes the kernels take."""
    M, dh = B * N, D // heads
    act = M * D * 2                         # one bf16 (B, N, D) tensor
    attn_nn = 2 * B * heads * N * N * dh    # one N x N x dh product
    w_attn, w_mlp = 4 * D * D * 2, 2 * D * Hd * 2
    return {
        "fused_attention_block": bound(
            {"bf16": 2 * M * D * 3 * D + 2 * M * D * D + 2 * attn_nn},
            2 * act + w_attn),
        "fused_mlp_block": bound({"bf16": 4 * M * D * Hd}, 2 * act + w_mlp),
        "fused_mlp_block_final_ln": bound({"bf16": 4 * M * D * Hd},
                                          2 * act + w_mlp),
        "fused_fusion_cls": bound(
            {"bf16": 2 * (2 * M * D * 2 * D + 2 * B * D * D * 2)},
            2 * act + 2 * 4 * D * D * 2 + 2 * B * D * 4),
        # K5: qkv recompute, dO, dWqkv, dh on the tensor cores; S, PV, dP,
        # dV, dQ, dK; dWproj in fp32 as the TPU kernel keeps it
        "fused_attention_block_bwd": bound(
            {"bf16": 3 * 2 * M * D * 3 * D + 2 * M * D * D + 6 * attn_nn,
             "fp32": 2 * M * D * D},
            3 * act + w_attn + 4 * D * D * 4),
        # K7: fc1 recompute, g . W2, dW1, dW2, dh1
        "fused_mlp_block_bwd": bound({"bf16": 5 * 2 * M * D * Hd},
                                     3 * act + w_mlp + 2 * D * Hd * 4),
    }


BWD_NAMES = ("dx", "dln_s", "dln_b", "dw_a", "db_a", "dw_b", "db_b")


def bwd_calls(t, g, heads):
    """name -> (kernel backward, plain backward in the inputs' dtype,
    plain backward in fp32 on the same values), each returning its
    gradients. K3's runs through its autograd Function: the epilogue
    LayerNorm backward, then K7 (nine gradients)."""
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_mlp as fm
    scale = (t["x"].shape[-1] // heads) ** -0.5
    a = [g] + [t[k] for k in ATTN[:-1]]
    m = [g] + [t[k] for k in MLP[:-1]]
    a32, m32 = [v.float() for v in a], [v.float() for v in m]

    def k3(plain, dtype):
        leaves = [t["x"].to(dtype)] + [t[k].float() for k in MLP[1:]]
        leaves += [t["fs"], t["fb"]]
        leaves = [v.detach().clone().requires_grad_() for v in leaves]
        out = fm.fused_mlp_block_final_ln(*leaves, plain=plain)
        return torch.autograd.grad(out, leaves, g.to(dtype))

    return {
        "fused_attention_block_bwd": (
            lambda: fa.fused_attention_block_bwd(*a, heads, scale),
            lambda: fa.fused_attention_block_bwd_plain(*a, heads, scale),
            lambda: fa.fused_attention_block_bwd_plain(*a32, heads, scale)),
        "fused_mlp_block_bwd": (
            lambda: fm.fused_mlp_block_bwd(*m),
            lambda: fm.fused_mlp_block_bwd_plain(*m),
            lambda: fm.fused_mlp_block_bwd_plain(*m32)),
        "fused_mlp_block_final_ln (backward)": (
            lambda: k3(False, torch.bfloat16), None,
            lambda: k3(True, torch.float32)),
    }


def hold_bwd(name: str, label: str, kern, plain32) -> float:
    """One backward's outputs against the plain fp32 backward on the same
    values, rel < REL_BAR each; returns the largest abs error."""
    got = kern()
    torch.cuda.synchronize()
    ref = plain32()
    rels = [rel(x, y) for x, y in zip(got, ref)]
    names = BWD_NAMES + ("d_final_s", "d_final_b")
    print(f"{name} at {label}: " + ", ".join(
        f"{n} {r:.3e}" for n, r in zip(names, rels)))
    if not all(math.isfinite(r) and r < REL_BAR for r in rels):
        raise AssertionError(f"{name} at {label}: rel {rels}")
    return max((x.float() - y).abs().max().item() for x, y in zip(got, ref))


def check_bwd_kernels(dev) -> dict:
    """K5 and K7 against their plain fp32 backward at vit_small block
    shapes (B=8, and B=32 as the FT run drives them) and vit_base (B=2);
    the largest abs error over the outputs at vit_small."""
    errs = {}
    for label, B, D in (("vit_small", 8, 384), ("vit_small", 32, 384),
                        ("vit_base", 2, 768)):
        gen = torch.Generator().manual_seed(2)
        t = block_inputs(gen, B, D, dev)
        g = torch.randn(B, 197, D, generator=gen).to(dev).bfloat16()
        for name, (kern, _, plain32) in bwd_calls(t, g, 12).items():
            err = hold_bwd(name, f"{label} (B={B}, D={D})", kern, plain32)
            if label == "vit_small" and name in {k[0] for k in KERNELS}:
                errs[name] = max(errs.get(name, 0.0), err)
    return errs


def write_covid_ds(root: str, n: int, seed: int) -> str:
    """n synthetic PNGs in the ``--covid-ds`` layout: every image in the
    train manifest (1_labeled_train_0.txt), the two halves as val and
    test."""
    import cv2

    from mfvit_tpu_torch.data.manifest import write_covid_manifest
    rng = np.random.default_rng(seed)
    images = os.path.join(root, "images")
    man = os.path.join(root, "create_covid_dataset")
    os.makedirs(os.path.join(images, "data"))
    os.makedirs(man)
    names = [f"img_{i:03d}.png" for i in range(n)]
    labels = [i % 3 for i in range(n)]
    yy, xx = np.mgrid[0:256, 0:288]
    for i, fn in enumerate(names):
        img = rng.integers(0, 60, (256, 288, 3), np.uint8)
        img += ((np.sin(xx / (9 + i % 7)) + np.cos(yy / 13)) * 60
                + 100 + 30 * labels[i]).astype(np.uint8)[..., None]
        cv2.imwrite(os.path.join(images, "data", fn), img)
    half = n // 2
    for fname, sl in (("1_labeled_train_0.txt", slice(0, n)),
                      ("val_ds.txt", slice(0, half)),
                      ("test_ds.txt", slice(half, n))):
        write_covid_manifest(os.path.join(man, fname), images, names[sl],
                             labels[sl])
    return man


def write_moco(path: str, cfg, seed: int) -> dict:
    """A MoCo ``.pth.tar`` in the reference layout from seeded weights:
    both towers' encoders under ``module.{base,momentum}_encoder.`` with a
    projector as their ``head.*``. Returns the base encoder's state."""
    from mfvit_tpu_torch.nn.vit import ViT
    sd = {}
    base = None
    for i, tower in enumerate(("base_encoder", "momentum_encoder")):
        enc = ViT(cfg, generator=torch.Generator().manual_seed(seed + i))
        state = enc.state_dict()
        base = base or state
        for k, v in state.items():
            sd[f"module.{tower}.{k}"] = v
        sd[f"module.{tower}.head.0.weight"] = torch.randn(
            256, cfg.dim, generator=torch.Generator().manual_seed(seed))
    torch.save({"epoch": 0, "arch": cfg.name, "state_dict": sd}, path)
    return base


def run_training(dev, tmp: str) -> dict:
    """FT then LP through ``cli.finetune.main`` (vit_small, B=32, two
    epochs over 64 images); returns the FT run's launch counts."""
    from mfvit_tpu_torch import ops
    from mfvit_tpu_torch.cli import finetune
    from mfvit_tpu_torch.nn.vit import get_config

    cfg = get_config("vit_small")
    man = write_covid_ds(os.path.join(tmp, "ds"), 64, seed=5)
    moco = os.path.join(tmp, "moco.pth.tar")
    base = write_moco(moco, cfg, seed=6)
    argv = ["-a", "vit_small", "-b", "32", "--epochs", "2", "--draws", "1",
            "--pretrained", moco, "--covid-ds", man, "--lr", "0.01",
            "-j", "8", "-p", "1", "--device", dev.type]
    counts = {}
    for mode in ("FT", "LP"):
        root = os.path.join(tmp, mode)
        extra = ["--semi-supervised"] if mode == "FT" else []
        ops.reset_launch_counts()
        res = finetune.main(argv + extra + ["--storage-root", root])[0]
        torch.cuda.synchronize()
        got = ops.launch_counts()
        losses = res.extra["train_losses"]
        steps, evals = len(losses), res.extra["eval_batches"]
        fwd = steps + evals
        want = {k: v * fwd for k, v in PER_VIT_FORWARD.items()}
        want.update({k: (v * steps if mode == "FT" else 0)
                     for k, v in PER_FT_STEP.items()})
        want["fused_fusion_cls"] = 0
        print(f"{mode}: {steps} steps, {evals} eval batches, losses "
              + ", ".join(f"{v:.4f}" for v in losses)
              + f"; launch counts {got}")
        if steps != 4 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{mode}: losses {losses}")
        if got != want:
            raise AssertionError(f"{mode}: launch counts {got} != {want}")
        exp = next(os.scandir(root)).path
        last = torch.load(os.path.join(exp, "train_1_0", "last_checkpoint"),
                          weights_only=True)
        moved = [k for k, v in base.items() if not torch.equal(last[k], v)]
        print(f"{mode}: {len(moved)} of {len(base)} backbone entries "
              f"changed; test auc {res.test_auc:.4f}")
        if mode == "FT" and not any(k.startswith("blocks.") for k in moved):
            raise AssertionError("FT left the backbone blocks unchanged")
        if mode == "LP" and moved:
            raise AssertionError(f"LP changed frozen weights: {moved[:4]}")
        counts[mode] = got
    return counts["FT"]


def train_parity(dev) -> None:
    """Three SGD steps of the kernel path and of the plain path (bf16 on
    the card) from the same weights and batch."""
    import copy

    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train import optim, steps

    gen = torch.Generator().manual_seed(8)
    model0 = ViT(get_config("vit_small"), 3, generator=gen)
    imgs = torch.randn(32, 224, 224, 3, generator=gen).to(dev).bfloat16()
    labels = torch.randint(0, 3, (32,), generator=gen).to(dev)
    runs = {}
    for ref in (False, True):
        model = copy.deepcopy(model0).to(dev)
        opt = optim.build_optimizer("sgd", model.named_parameters(), 0.01,
                                    momentum=0.9, weight_decay=1e-6)
        step, _ = steps.make_classifier_steps(reference=ref)
        losses, grads = [], None
        for i in range(3):
            loss, _ = step(model, opt, imgs, labels)
            losses.append(loss.item())
            if i == 0:
                grads = [torch.cat([p.grad.flatten() for p in blk.parameters()])
                         for blk in model.blocks]
        runs[ref] = (losses, grads)
    (lk, gk), (lp, gp) = runs[False], runs[True]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    grad_rel = [rel(a, b) for a, b in zip(gk, gp)]
    print("train-step parity (vit_small, B=32, 3 SGD steps): losses kernel "
          + ", ".join(f"{v:.5f}" for v in lk) + " plain "
          + ", ".join(f"{v:.5f}" for v in lp) + "; loss rel "
          + ", ".join(f"{v:.3e}" for v in loss_rel)
          + f" (bar {PARITY_LOSS_BAR}); first-step gradient rel per block "
          + ", ".join(f"{v:.3e}" for v in grad_rel)
          + f" (bar {PARITY_GRAD_BAR})")
    if not (max(loss_rel) < PARITY_LOSS_BAR
            and max(grad_rel) < PARITY_GRAD_BAR):
        raise AssertionError("train-step parity out of its bar")


def time_bwd(dev) -> dict:
    """K5 and K7 at B=256: each held against its plain fp32 backward on
    the timed inputs (the K-split geometry depends on B), then timed."""
    gen = torch.Generator().manual_seed(9)
    t = block_inputs(gen, 256, 384, dev)
    g = torch.randn(256, 197, 384, generator=gen).to(dev).bfloat16()
    times = {}
    for name, (kern, plain, plain32) in bwd_calls(t, g, 12).items():
        hold_bwd(name, "vit_small (B=256, D=384)", kern, plain32)
        if plain is None:
            continue
        k1, p1, p2, k2 = (cuda_ms(f, n) for f, n in ((kern, 10), (plain, 3),
                                                     (plain, 3), (kern, 10)))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"{name} at B=256: kernel {k1:.3f}/{k2:.3f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms (bf16)")
    return times


def time_train(dev, B: int, iters: int) -> dict:
    """Images/s of the FT train step (forward, backward, SGD step, loss
    fetched every step) at batch B, kernel path against plain path."""
    from mfvit_tpu_torch.nn.vit import ViT, get_config
    from mfvit_tpu_torch.train import optim, steps

    gen = torch.Generator().manual_seed(10)
    imgs = torch.randn(B, 224, 224, 3, generator=gen).to(dev).bfloat16()
    labels = torch.randint(0, 3, (B,), generator=gen).to(dev)
    model = ViT(get_config("vit_small"), 3, device=dev, generator=gen)
    opt = optim.build_optimizer("sgd", model.named_parameters(), 1e-4,
                                momentum=0.9)
    fns = {k: steps.make_classifier_steps(reference=k == "plain")[0]
           for k in ("kernel", "plain")}

    def rate(which: str) -> float:
        fns[which](model, opt, imgs, labels)[0].item()
        t0 = time.perf_counter()
        for _ in range(iters):
            fns[which](model, opt, imgs, labels)[0].item()
        return B * iters / (time.perf_counter() - t0)

    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        runs[which].append(rate(which))
    print(f"FT train step at B={B} (bf16, forward + backward + SGD, loss "
          "fetched every step): " + ", ".join(
              f"{k} {' / '.join(f'{r:.1f}' for r in v)} images/s"
              for k, v in runs.items()))
    return {k: sum(v) / len(v) for k, v in runs.items()}


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

    phase("forward kernels against their plain versions (B=8)")
    errs = check_kernels(dev)

    phase("the serving slice through mfvit_tpu_torch.cli.infer "
          "(vit_small, B=32)")
    with tempfile.TemporaryDirectory() as tmp:
        counts = run_slice(dev, tmp)

    phase("backward kernels against their plain versions")
    errs.update(check_bwd_kernels(dev))

    phase("the training slice through mfvit_tpu_torch.cli.finetune "
          "(vit_small, B=32, FT then LP)")
    with tempfile.TemporaryDirectory() as tmp:
        ft_counts = run_training(dev, tmp)
    counts.update({k: ft_counts[k] for k in PER_FT_STEP})

    phase("train-step parity, kernel path against plain path (B=32)")
    train_parity(dev)

    phase("times (B=256)")
    times = time_kernels(dev)
    times.update(time_bwd(dev))
    e2e = time_e2e(dev)
    train = time_train(dev, 256, 4)
    train_cli = time_train(dev, 16, 32)  # the finetune CLI's default -b
    phase("done")

    bounds = kernel_bounds(256, 197, 384, 12, 1536, 3)
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, src, rep in KERNELS]}
    print(json.dumps({"e2e_pairs_per_sec_B256": e2e,
                      "ft_train_images_per_sec_B256": train,
                      "ft_train_images_per_sec_B16": train_cli,
                      "card": smi}))
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
