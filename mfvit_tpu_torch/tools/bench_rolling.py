"""Time chains of ViT-S blocks whose attention half is K1 or the rolling
schedule variant T2 (``attn_rolling``), the port of
``tools/bench_rolling.py``.

    python -m mfvit_tpu_torch.tools.bench_rolling [--device cuda] \\
        [--batch 512] [--depth 12]

On ``tools/bench_block``'s inputs (the JAX tools' recipe), in the JAX
tool's order (:139-148): the baseline (K1 -> K2), then ``attn_rolling`` ->
K2 at cb 4, 8 and 16, then the baseline again. Lines, timing and
``--device cpu`` as in ``bench_mlp3d``.
"""
from __future__ import annotations

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.ops import fused_mlp
from mfvit_tpu_torch.ops.attn_variants import attn_rolling
from mfvit_tpu_torch.tools import card
from mfvit_tpu_torch.tools.bench_block import D, HEADS, N, SCALE
from mfvit_tpu_torch.tools.bench_mlp3d import build_parser, run_chains
from mfvit_tpu_torch.tools.bench_pipelined import chain_of, k1

__all__ = ["attn_rolling", "run", "main"]

CBS = (4, 8, 16)


def _rolling(x, a, cb):
    return attn_rolling(x, *a, HEADS, SCALE, cb=cb)


def chains() -> list:
    """(name, cb or None, chain) in the JAX tool's order."""
    out = [("staged cb=4 (current) + mlp", None,
            chain_of(k1, fused_mlp.fused_mlp_block))]
    out += [(f"rolling cb={cb} + mlp", cb,
             chain_of(_rolling, fused_mlp.fused_mlp_block, cb))
            for cb in CBS]
    return out + out[:1]


def run(device, batch: int = 512, depth: int = 12) -> dict:
    return run_chains(chains(), device, batch, depth)


def main(argv=None) -> dict:
    args = build_parser("mfvit-torch-bench-rolling").parse_args(argv)
    device = common.resolve_device(args.device)
    card.describe(device)
    print(f"B={args.batch}, N={N}, D={D}, heads={HEADS}, depth={args.depth} "
          f"on {device}")
    return run(device, args.batch, args.depth)


if __name__ == "__main__":
    main()
