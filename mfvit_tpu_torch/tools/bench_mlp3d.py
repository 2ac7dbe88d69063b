"""Time chains of ViT-S blocks whose MLP half is K2 or one of its schedule
variants T6 (``mlp3d``, flat and per image) and T7 (``mlp3d_staged``), the
port of ``tools/bench_mlp3d.py``.

    python -m mfvit_tpu_torch.tools.bench_mlp3d [--device cuda] \\
        [--batch 512] [--depth 12]

Each chain is ``depth`` blocks of attention (K1) followed by the MLP half
on the inputs of ``tools/bench_block`` (the JAX tools' recipe, :20-36
there). The chains run in the JAX tool's order (:123-133, :196-201): the
baseline (K1 -> K2), ``mlp3d`` flat at cb 2/4/8, per image ("loop") at cb
2/4/8, ``mlp3d_staged`` at cb 2/4/8, then the baseline again. Each line
gives the ms for the chain, the ms per block and a checksum (the fp32 sum
of the output), as JAX's ``timeit`` (:93-105) does; a cb that does not
divide the batch prints as skipped. Timing as ``bench_block``'s: a warm-up,
then ITERS chains between CUDA events. ``--device cpu`` runs the plain
versions and times with the host clock (a smoke test, not a measurement
of any device).
"""
from __future__ import annotations

import argparse

import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.ops import fused_attn, fused_mlp
from mfvit_tpu_torch.ops.mlp_variants import mlp3d, mlp3d_staged
from mfvit_tpu_torch.tools.bench_block import (ATTN, D, HEADS, MLP, N, SCALE,
                                               make_inputs, time_chain)

__all__ = ["mlp3d", "mlp3d_staged", "run", "main"]

CBS = (2, 4, 8)


def chain_of(mlp):
    """A chain of ``depth`` blocks: K1, then ``mlp(x, *mlp_weights)``."""
    def chain(x, p, depth: int):
        attn, w = [p[k] for k in ATTN], [p[k] for k in MLP]
        for _ in range(depth):
            x = mlp(fused_attn.fused_attention_block(x, *attn, HEADS, SCALE),
                    *w)
        return x
    return chain


def chains() -> list:
    """(name, cb or None, chain) in the JAX tool's order."""
    out = [("baseline flat-MLP", None, chain_of(fused_mlp.fused_mlp_block))]
    for kind, flat in (("flat", True), ("loop", False)):
        out += [(f"mlp3d {kind} cb={cb}", cb, chain_of(
            lambda *a, cb=cb, flat=flat: mlp3d(*a, cb=cb, flat=flat)))
            for cb in CBS]
    out += [(f"mlp3d staged cb={cb}", cb, chain_of(
        lambda *a, cb=cb: mlp3d_staged(*a, cb=cb))) for cb in CBS]
    return out + out[:1]


def run_chains(named, device, batch: int, depth: int) -> dict:
    """Time each (name, cb, chain) on the same inputs, printing a line
    each: name -> (ms for the chain, checksum), the mean of a name's runs
    (the baseline runs twice)."""
    x, p = make_inputs(batch, device)
    runs = {}
    for name, cb, chain in named:
        if cb is not None and batch % cb:
            print(f"{name}: skipped, cb must divide B={batch}")
            continue
        ms, s = time_chain(chain, x, p, depth)
        runs.setdefault(name, []).append((ms, s))
        print(f"{name}: {ms:.1f} ms ({ms / depth:.2f} ms/block) "
              f"[checksum {s:.3f}]")
    return {k: (sum(m for m, _ in v) / len(v), v[-1][1])
            for k, v in runs.items()}


def run(device, batch: int = 512, depth: int = 12) -> dict:
    return run_chains(chains(), device, batch, depth)


def build_parser(prog: str = "mfvit-torch-bench-mlp3d", batch: int = 512):
    p = argparse.ArgumentParser(prog)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises where CUDA is missing")
    p.add_argument("--batch", type=int, default=batch)
    p.add_argument("--depth", type=int, default=12)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    print(f"B={args.batch}, N={N}, D={D}, heads={HEADS}, depth={args.depth} "
          f"on {device}")
    return run(device, args.batch, args.depth)


if __name__ == "__main__":
    main()
