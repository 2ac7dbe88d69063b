"""Time chains of attention backwards through K5 and its staged schedule
variant T5 (``staged_bwd``), the port of ``tools/bench_bwd_staged.py``.

    python -m mfvit_tpu_torch.tools.bench_bwd_staged [--device cuda] \\
        [--batch 256] [--depth 12]

The inputs follow the JAX tool's recipe (:24-34): B=256 images of N=197
tokens at D=384 with 12 heads, x and a cotangent g0 ~ N(0, 1) in bf16, and
``tools/bench_block``'s attention weights, all from seeded
``torch.Generator``s (the numbers differ from ``jax.random``'s). A chain
runs ``depth`` backwards (the JAX tool's REPS = 12), each dx fed back as the
next g with x fixed; its checksum is the fp32 sum of the last dx plus, over
the chain, the sums of dWproj's first two input rows (the JAX tool's
``outs[3][:2]``, :176-184). The chains run in the JAX tool's order
(:199-204): K5, then ``staged_bwd`` at cb 2 and 4, then K5 again; a cb that
does not divide the batch prints as skipped. Each line gives the ms per
backward and the checksum. Then, as the JAX tool does (:206-213), the
agreement of ``staged_bwd`` cb=2 with K5 on g0, per output in the JAX
order: max|a - b| / max(1, max|b|). Timing as ``bench_block``'s; ``--device
cpu`` runs the plain versions (a smoke test, not a measurement of any
device).
"""
from __future__ import annotations

import torch

from mfvit_tpu_torch.cli import common
from mfvit_tpu_torch.ops import fused_attn
from mfvit_tpu_torch.ops.attn_variants import staged_bwd
from mfvit_tpu_torch.tools.bench_block import (ATTN, D, HEADS, N, SCALE,
                                               make_inputs, time_chain)
from mfvit_tpu_torch.tools.bench_mlp3d import build_parser

__all__ = ["staged_bwd", "run", "main"]

BATCH = 256
CBS = (2, 4)
# the outputs in the JAX order, as indices into the port's (dx, dln_s,
# dln_b, dwqkv, dbqkv, dwproj, dbproj)
JAX_ORDER = (("dx", 0), ("dwqkv", 3), ("dbqkv", 4), ("dwproj", 5),
             ("dbproj", 6), ("ds", 1), ("db", 2))


def _k5(g, x, w, cb):
    if not x.is_cuda:
        return fused_attn.fused_attention_block_bwd_plain(g, x, *w, HEADS,
                                                          SCALE)
    return fused_attn.fused_attention_block_bwd(g, x, *w, HEADS, SCALE)


def _staged(g, x, w, cb):
    return staged_bwd(g, x, *w, HEADS, SCALE, cb=cb)


def chain_of(bwd, cb=None):
    """``depth`` backwards, dx fed back as g; returns the checksum."""
    def chain(g, p, depth: int):
        x, w = p["x"], [p[k] for k in ATTN[:-1]]  # bproj has no gradient here
        acc = torch.zeros((), device=g.device)
        for _ in range(depth):
            outs = bwd(g, x, w, cb)
            g = outs[0]
            acc = acc + outs[5][:, :2].sum()
        return g.float().sum() + acc
    return chain


def chains() -> list:
    """(name, cb or None, chain) in the JAX tool's order."""
    out = [("current cb=2", None, chain_of(_k5))]
    out += [(f"staged cb={cb}", cb, chain_of(_staged, cb)) for cb in CBS]
    return out + out[:1]


def make_bwd_inputs(batch: int, device):
    """(g0, block weights with x under "x") on ``device``."""
    x, p = make_inputs(batch, device)
    g = torch.Generator().manual_seed(1)
    g0 = torch.randn(batch, N, D, generator=g).bfloat16().to(device)
    return g0, dict(p, x=x)


def agreement(g0, p) -> dict:
    """name -> max|T5 - K5| / max(1, max|K5|) of each output on g0, T5 at
    cb=2 as the JAX tool runs it."""
    x, w = p["x"], [p[k] for k in ATTN[:-1]]
    with torch.inference_mode():
        ref = _k5(g0, x, w, None)
        got = _staged(g0, x, w, 2)
    out = {}
    for name, i in JAX_ORDER:
        a, b = got[i].float(), ref[i].float()
        out[name] = ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()
    return out


def run(device, batch: int = BATCH, depth: int = 12) -> tuple:
    """Time each chain on the same inputs and print the agreement lines:
    ({name: (ms per backward, checksum)}, {output: agreement})."""
    g0, p = make_bwd_inputs(batch, device)
    runs = {}
    for name, cb, chain in chains():
        if cb is not None and batch % cb:
            print(f"{name}: skipped, cb must divide B={batch}")
            continue
        ms, s = time_chain(chain, g0, p, depth)
        runs.setdefault(name, []).append((ms / depth, s))
        print(f"{name}: {ms / depth:.2f} ms/bwd [checksum {s:.3f}]")
    errs = agreement(g0, p) if batch % 2 == 0 else {}
    for name, e in errs.items():
        print(f"{name} max rel-to-scale err {e:.2e}")
    return ({k: (sum(m for m, _ in v) / len(v), v[-1][1])
             for k, v in runs.items()}, errs)


def main(argv=None) -> tuple:
    args = build_parser("mfvit-torch-bench-bwd-staged", BATCH).parse_args(
        argv)
    device = common.resolve_device(args.device)
    print(f"B={args.batch}, N={N}, D={D}, heads={HEADS}, depth={args.depth} "
          f"on {device}")
    return run(device, args.batch, args.depth)


if __name__ == "__main__":
    main()
