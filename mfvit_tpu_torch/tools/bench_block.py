"""Time a chain of ViT-S blocks two ways on one device: the K1 -> K2 pair
(``ops.fused_attn`` then ``ops.fused_mlp``) and K15
(``ops.fused_block``), the port of ``tools/bench_block.py``.

    python -m mfvit_tpu_torch.tools.bench_block [--device cuda] \\
        [--batch 512] [--depth 12]

The inputs are the JAX tool's (:17-33): B=512 images of N=197 tokens at
D=384 with 12 heads, x ~ N(0, 1) in bf16, the LayerNorm scales 1 + 0.02
N(0, 1), the biases 0.02 N(0, 1) (b2 zero), the weights 0.05 N(0, 1), one
block's weights shared by every block of the chain, drawn from a seeded
``torch.Generator`` (the numbers differ from ``jax.random``'s). Each chain
runs once to warm up, then ITERS times between CUDA events; it prints
the ms for the chain, the ms per block and a checksum (the fp32 sum of the
output), as the JAX tool's ``timeit`` (:36-50) does, in the order pair,
K15, K15, pair. The JAX tool's sweep over CB, the images a TPU grid step
takes (:64-73), is a choice the CUDA kernels do not have and is not
ported. ``--device cpu`` runs the plain versions and times with the host
clock (a smoke test, not a measurement of any device).
"""
from __future__ import annotations

import argparse
import time

import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.ops import fused_attn, fused_block, fused_mlp
from mfvit_tpu_torch.tools import card

N, D, HEADS = 197, 384, 12
SCALE = (D // HEADS) ** -0.5
ITERS = 3  # timed chains after each warm-up


def make_inputs(batch: int, device, seed: int = 0):
    """(x, block weights) of the JAX tool, the weights in the torch Linear
    layout: matrices in bf16, vectors in fp32."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=g) * std

    x = r(batch, N, D).bfloat16()
    p = dict(ln1_s=1 + r(D, std=0.02), ln1_b=r(D, std=0.02),
             wqkv=r(3 * D, D, std=0.05).bfloat16(), bqkv=r(3 * D, std=0.02),
             wproj=r(D, D, std=0.05).bfloat16(), bproj=r(D, std=0.02),
             ln2_s=1 + r(D, std=0.02), ln2_b=r(D, std=0.02),
             w1=r(4 * D, D, std=0.05).bfloat16(), b1=r(4 * D, std=0.02),
             w2=r(D, 4 * D, std=0.05).bfloat16(), b2=torch.zeros(D))
    return x.to(device), {k: v.to(device) for k, v in p.items()}


ATTN = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "bproj")
MLP = ("ln2_s", "ln2_b", "w1", "b1", "w2", "b2")


def chain_pair(x, p, depth: int):
    attn, mlp = [p[k] for k in ATTN], [p[k] for k in MLP]
    for _ in range(depth):
        x = fused_attn.fused_attention_block(x, *attn, HEADS, SCALE)
        x = fused_mlp.fused_mlp_block(x, *mlp)
    return x


def chain_block(x, p, depth: int):
    args = [p[k] for k in ATTN + MLP]
    for _ in range(depth):
        x = fused_block.fused_transformer_block(x, *args, HEADS, SCALE)
    return x


CHAINS = {"K1 -> K2": chain_pair, "K15": chain_block}


@torch.inference_mode()
def time_chain(chain, x, p, depth: int) -> tuple:
    """(ms for one chain of ``depth`` blocks, checksum of its output)."""
    out = chain(x, p, depth)  # warm-up (and the kernels' first build)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            out = chain(x, p, depth)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / ITERS
    else:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = chain(x, p, depth)
        ms = (time.perf_counter() - t0) * 1e3 / ITERS
    return ms, out.float().sum().item()


def run(device, batch: int = 512, depth: int = 12) -> dict:
    """Both chains on the same inputs, timed pair, K15, K15, pair, each
    line printed: name -> (mean ms for the chain, checksum)."""
    x, p = make_inputs(batch, device)
    runs = {k: [] for k in CHAINS}
    for name in ("K1 -> K2", "K15", "K15", "K1 -> K2"):
        ms, s = time_chain(CHAINS[name], x, p, depth)
        runs[name].append((ms, s))
        print(f"{name}: {ms:.1f} ms for {depth} blocks "
              f"({ms / depth:.2f} ms/block)  [checksum {s:.3f}]")
    return {k: (sum(m for m, _ in v) / len(v), v[-1][1])
            for k, v in runs.items()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mfvit-torch-bench-block")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--depth", type=int, default=12)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    card.describe(device)
    print(f"B={args.batch}, N={N}, D={D}, heads={HEADS}, depth={args.depth} "
          f"on {device}")
    return run(device, args.batch, args.depth)


if __name__ == "__main__":
    main()
