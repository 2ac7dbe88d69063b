"""Time chains of ViT-S blocks through the pipelined schedule variants T3
(``mlp_pipe``) and T4 (``attn_staged``), the port of
``tools/bench_pipelined.py``.

    python -m mfvit_tpu_torch.tools.bench_pipelined [--device cuda] \\
        [--batch 512] [--depth 12]

On ``tools/bench_block``'s inputs (the JAX tools' recipe), in the JAX
tool's order (:224-245): the baseline (K1 -> K2); K1 then ``mlp_pipe`` over
its (splits, tm) sweep, in the sizes the kernel takes (the JAX tool's tm of
512 and 1024 are TPU VMEM tiles; here tm is the rows a block owns);
``attn_staged`` at cb 2 and 4 then K2; ``attn_staged`` cb=2 then
``mlp_pipe`` s=2; then the baseline again. Lines, timing and ``--device
cpu`` as in ``bench_mlp3d``.
"""
from __future__ import annotations

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.ops import fused_attn, fused_mlp
from mfvit_tpu_torch.ops.attn_variants import attn_staged
from mfvit_tpu_torch.ops.mlp_variants import mlp_pipe
from mfvit_tpu_torch.tools.bench_block import ATTN, D, HEADS, MLP, N, SCALE
from mfvit_tpu_torch.tools.bench_mlp3d import build_parser, run_chains

__all__ = ["mlp_pipe", "attn_staged", "run", "main"]

PIPE_SWEEP = ((2, 32), (2, 64), (4, 64))  # (splits, tm)
CBS = (2, 4)


def k1(x, a, cb):
    return fused_attn.fused_attention_block(x, *a, HEADS, SCALE)


def _staged(x, a, cb):
    return attn_staged(x, *a, HEADS, SCALE, cb=cb)


def chain_of(attn, mlp, cb=None):
    def chain(x, p, depth: int):
        a, w = [p[k] for k in ATTN], [p[k] for k in MLP]
        for _ in range(depth):
            x = mlp(attn(x, a, cb), *w)
        return x
    return chain


def chains() -> list:
    """(name, cb or None, chain) in the JAX tool's order."""
    out = [("baseline attn+mlp", None,
            chain_of(k1, fused_mlp.fused_mlp_block))]
    out += [(f"attn + mlp_pipe s={sp} tm={tm}", None, chain_of(
        k1, lambda *w, sp=sp, tm=tm: mlp_pipe(*w, splits=sp, tm=tm)))
        for sp, tm in PIPE_SWEEP]
    out += [(f"attn_staged cb={cb} + mlp", cb,
             chain_of(_staged, fused_mlp.fused_mlp_block, cb)) for cb in CBS]
    out.append(("attn_staged cb=2 + mlp_pipe s=2", 2, chain_of(
        _staged, lambda *w: mlp_pipe(*w, splits=2, tm=64), 2)))
    return out + out[:1]


def run(device, batch: int = 512, depth: int = 12) -> dict:
    return run_chains(chains(), device, batch, depth)


def main(argv=None) -> dict:
    args = build_parser("mfvit-torch-bench-pipelined").parse_args(argv)
    device = common.resolve_device(args.device)
    print(f"B={args.batch}, N={N}, D={D}, heads={HEADS}, depth={args.depth} "
          f"on {device}")
    return run(device, args.batch, args.depth)


if __name__ == "__main__":
    main()
