"""Time the two routes of K11 or of K10 against each other on one card,
from one image to a full batch:

    python -m mfvit_tpu_torch.tools.i8_routes [--op k11|k10] [--out FILE]
        [--e2e-batch B]

K11 (the default): at the tail's widths, D = 128, 256 and 384 (hidden
4D), on B images of 197 tokens and on 384-px images (577 tokens) at B =
16, 32 and 64, ``ops.fused_int8.fused_mlp_block_i8_route`` runs the
one-launch tail and the four launches on the int8 wgmma core. K10: at
vit_small (D=384, 12 heads) and vit_base (D=768, 12 heads) on B images of
197 tokens and at vit_small_ori@384 (577 tokens, 6 heads) at B = 16, 32
and 64, ``fused_attention_block_i8_route`` runs the three launches on the
quantizing int8 GEMMs and the five with ``quant_rows`` before the plain
int8 wgmma core. Both routes run on the same inputs
(``chip_smoke.block_inputs``, seed 16, weights quantized per output
channel) and must equal the chain the kernel ran before
(``fused_mlp_block_i8_mma``, ``fused_attention_block_i8_mma``) bit for bit;
each is timed with CUDA events in turns (A, B, B, A), beside the route the
op itself takes there (K11's ``_plan``: I8T_TAIL_ROWS; K10's
``_k10_fused``: I8Q_FUSED_WORK). The crossover these times show is what
sets those constants. With ``--e2e-batch`` it then times the paired
serving forward at that batch (``chip_smoke.time_e2e``: bf16 and
``--int8`` on the same weights). Prints the card's name and power limit
and one line a shape, and writes every reading to FILE as JSON. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from mfvit_tpu_torch.ops.fused_int8 import I8T_WIDTHS

BATCHES = (1, 2, 4, 8, 16, 32, 40, 48, 64, 96, 128, 256)
# the 384-px serving shapes: B, tokens
SHAPES_384 = ((16, 577), (32, 577), (64, 577))
# K10's widths: D, heads (vit_small, vit_base) and the heads of its
# 384-px shapes (vit_small_ori@384, where K10 runs past 256 tokens)
K10_WIDTHS = ((384, 12), (768, 12))
K10_HEADS_384 = 6


def route_times(dev, op: str, D: int, B: int, N: int = 197, heads: int = 12,
                iters: int = 20) -> dict:
    """K11 or K10 (``op``) at width D on B images of N tokens: each route's
    ms (twice), the route the op takes ("route") and whether both routes
    equal the former chain bit for bit ("equal")."""
    import chip_smoke
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    t = chip_smoke.block_inputs(torch.Generator().manual_seed(16), B, D, dev,
                                N=N)
    x = t["x"]
    if op == "k11":
        m = chip_smoke.i8_args(t, heads)["fused_mlp_block_i8"]
        calls = {"tail": lambda: fi8.fused_mlp_block_i8_route(x, *m, True),
                 "four launches": lambda: fi8.fused_mlp_block_i8_route(
                     x, *m, False)}
        former = lambda: fi8.fused_mlp_block_i8_mma(x, *m)  # noqa: E731
        route = fi8._plan(D, 4 * D, B * N).route
    else:
        a = chip_smoke.i8_args(t, heads)["fused_attention_block_i8"]
        calls = {"three launches": lambda: fi8.fused_attention_block_i8_route(
                     x, *a, True),
                 "five launches": lambda: fi8.fused_attention_block_i8_route(
                     x, *a, False)}
        former = lambda: fi8.fused_attention_block_i8_mma(x, *a)  # noqa: E731
        route = ("three launches" if fi8._k10_fused(B * N, D)
                 else "five launches")
    out = {name: [] for name in calls}
    with torch.inference_mode():
        ref = former()
        same = all(torch.equal(f(), ref) for f in calls.values())
        for name in (*calls, *reversed(calls)):
            out[name].append(chip_smoke.cuda_ms(calls[name], iters))
    out["route"] = route
    out["equal"] = same
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", choices=("k11", "k10"), default="k11")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--e2e-batch", type=int)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    res, ok = {"card": card}, True
    if args.op == "k11":
        shapes = ([(D, B, 197, 12) for D in I8T_WIDTHS for B in BATCHES]
                  + [(384, B, N, 12) for B, N in SHAPES_384])
    else:
        shapes = ([(D, B, 197, h) for D, h in K10_WIDTHS for B in BATCHES]
                  + [(384, B, N, K10_HEADS_384) for B, N in SHAPES_384])
    for D, B, N, heads in shapes:
        r = route_times(dev, args.op, D, B, N, heads)
        res[f"{args.op} D={D} B={B} N={N}"] = r
        print(f"{args.op.upper()} D={D} B={B} N={N} ({B * N} rows): "
              + ", ".join(f"{k} " + "/".join(f"{v:.4f}" for v in ms) + " ms"
                          for k, ms in r.items() if isinstance(ms, list))
              + f"; the op's route: {r['route']}; equal to the former "
              f"chain: {r['equal']}", flush=True)
        ok &= r["equal"]
    if args.e2e_batch:
        res["e2e"] = chip_smoke.time_e2e(dev, B=args.e2e_batch)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
