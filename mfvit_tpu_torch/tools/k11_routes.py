"""Time K11's two routes against each other on one card, from one image to
a full batch:

    python -m mfvit_tpu_torch.tools.k11_routes [--out FILE] [--e2e-batch B]

At the tail's widths, D = 128, 256 and 384 (hidden 4D), on B images of
197 tokens and on 384-px images (577 tokens) at B = 16, 32 and 64,
``ops.fused_int8.fused_mlp_block_i8_route`` runs the one-launch tail and
the four launches on the int8 wgmma core on the same inputs
(``chip_smoke.block_inputs``, seed 16, weights quantized per output
channel). Both must equal the chain K11 ran before
(``fused_mlp_block_i8_mma``) bit for bit; each is timed with CUDA events in
turns (tail, four launches, four launches, tail), beside the route the op
itself takes there (``_plan``: I8T_TAIL_ROWS). The crossover these times
show is what sets I8T_TAIL_ROWS. With ``--e2e-batch`` it then times the
paired serving forward at that batch (``chip_smoke.time_e2e``: bf16 and
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
# the 384-px serving shapes at vit_small's width: B, tokens
SHAPES_384 = ((16, 577), (32, 577), (64, 577))


def route_times(dev, D: int, B: int, N: int = 197, iters: int = 20) -> dict:
    """K11 at width D on B images of N tokens: each route's ms (twice),
    the route the op takes ("route") and whether both routes equal the
    former chain bit for bit ("equal")."""
    import chip_smoke
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    t = chip_smoke.block_inputs(torch.Generator().manual_seed(16), B, D, dev,
                                N=N)
    m = chip_smoke.i8_args(t, 8)["fused_mlp_block_i8"]
    x = t["x"]
    calls = {"tail": lambda: fi8.fused_mlp_block_i8_route(x, *m, True),
             "four launches": lambda: fi8.fused_mlp_block_i8_route(x, *m,
                                                                   False)}
    out = {name: [] for name in calls}
    with torch.inference_mode():
        former = fi8.fused_mlp_block_i8_mma(x, *m)
        same = all(torch.equal(f(), former) for f in calls.values())
        for name in (*calls, *reversed(calls)):
            out[name].append(chip_smoke.cuda_ms(calls[name], iters))
    out["route"] = fi8._plan(D, 4 * D, B * N).route
    out["equal"] = same
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    shapes = [(D, B, 197) for D in I8T_WIDTHS for B in BATCHES]
    for D, B, N in shapes + [(384, B, N) for B, N in SHAPES_384]:
        r = route_times(dev, D, B, N)
        res[f"D={D} B={B} N={N}"] = r
        print(f"K11 D={D} B={B} N={N} ({B * N} rows): tail "
              + "/".join(f"{v:.4f}" for v in r["tail"])
              + " ms, four launches "
              + "/".join(f"{v:.4f}" for v in r["four launches"])
              + f" ms; the op's route: {r['route']}; equal to the "
              f"former chain: {r['equal']}", flush=True)
        ok &= r["equal"]
    if args.e2e_batch:
        res["e2e"] = chip_smoke.time_e2e(dev, B=args.e2e_batch)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
