"""Time chains of ViT-S blocks whose attention half is K1 or the
pair-batched schedule variant T1 (``attn_pairs``), the port of
``tools/bench_attn_pairs.py``.

    python -m mfvit_tpu_torch.tools.bench_attn_pairs [--device cuda] \\
        [--batch 512] [--depth 12]

On ``tools/bench_block``'s inputs (the JAX tools' recipe), in the JAX
tool's order (:153-158): the baseline (K1 -> K2), then ``attn_pairs`` ->
K2 at cb 4 and 8, then the baseline again. Lines, timing and ``--device
cpu`` as in ``bench_mlp3d``.
"""
from __future__ import annotations

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.ops import fused_mlp
from mfvit_tpu_torch.ops.attn_variants import attn_pairs
from mfvit_tpu_torch.tools import card
from mfvit_tpu_torch.tools.bench_block import D, HEADS, N, SCALE
from mfvit_tpu_torch.tools.bench_mlp3d import build_parser, run_chains
from mfvit_tpu_torch.tools.bench_pipelined import chain_of, k1

__all__ = ["attn_pairs", "run", "main"]

CBS = (4, 8)


def _pairs(x, a, cb):
    return attn_pairs(x, *a, HEADS, SCALE, cb=cb)


def chains() -> list:
    """(name, cb or None, chain) in the JAX tool's order."""
    out = [("shipped staged cb=4", None,
            chain_of(k1, fused_mlp.fused_mlp_block))]
    out += [(f"pairs cb={cb}", cb,
             chain_of(_pairs, fused_mlp.fused_mlp_block, cb)) for cb in CBS]
    return out + out[:1]


def run(device, batch: int = 512, depth: int = 12) -> dict:
    return run_chains(chains(), device, batch, depth)


def main(argv=None) -> dict:
    args = build_parser("mfvit-torch-bench-attn-pairs").parse_args(argv)
    device = common.resolve_device(args.device)
    card.describe(device)
    print(f"B={args.batch}, N={N}, D={D}, heads={HEADS}, depth={args.depth} "
          f"on {device}")
    return run(device, args.batch, args.depth)


if __name__ == "__main__":
    main()
