"""Readings that the limits of ``limits/<cell>.json`` are set from, over
many seeds in one process (set-up is long):

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--out FILE]

For each seed it builds the cell's session and compares against the
plain fp32 reference:

- serving: every batch of a short window at the cell's own load (the
  program), the port's int8 serving path (``quantize_vit_for_serving``)
  on the same batches, and the reference computed with fp8 products;
- training: the program's first steps, the same steps with half of the
  batch left out of the loss, gradients and update but the whole batch's
  logits returned (``faults.half_batch``), and the reference trained with
  fp8 products and with its weights and Adam's moments in bf16.

Each seed's numbers go to standard output as one JSON line; the last
line holds, for each number, the largest program reading and the
smallest reading of each control and fault.
"""
from __future__ import annotations

import argparse
import copy
import importlib
import json
import sys

import torch

from perfbench import faults, harness, loop


def serve_readings(step, config, traffic, seed, device, reference,
                   seconds) -> dict:
    from mfvit_tpu_torch.nn.vit import quantize_vit_for_serving
    from mfvit_tpu_torch.train.steps import make_fusion_forward

    sess = step.Session(config, traffic, seed, device, reference)
    sess.window(seconds)
    pool = sorted({k for k, _ in sess.served})
    models8 = {k: (quantize_vit_for_serving(copy.deepcopy(m))
                   if k != "fus" else m) for k, m in sess.models.items()}
    fwd = make_fusion_forward(
        compute_dtype=getattr(torch, config["compute_dtype"]))
    int8 = {k: sum(fwd(models8, sess.inputs["cxr"][k],
                       sess.inputs["enh"][k])).cpu() for k in pool}
    del models8
    sess.free()
    ref = sess.reference_logits(pool)
    fp8 = sess.reference_logits(pool, "fp8")
    out = {}
    for name, g, w in (("program", [o for _, o in sess.served],
                        [ref[k] for k, _ in sess.served]),
                       ("int8", [int8[k] for k in pool],
                        [ref[k] for k in pool]),
                       ("fp8", [fp8[k] for k in pool],
                        [ref[k] for k in pool])):
        nums = loop.batch_numbers(g, w)
        nums.pop("row_gaps")
        nums.pop("batch_gaps")
        out[name] = nums
    out["batches"] = len(sess.served)
    return out


def train_readings(step, config, traffic, seed, device, reference) -> dict:
    sess = step.Session(config, traffic, seed, device, reference)
    sess.free()
    with faults.planted("half_batch"):
        half = step.Session(config, traffic, seed, device, reference)
    half.free()
    ref = sess.reference_steps()
    out = {}
    for name, rec in (("program", sess.record), ("half_batch", half.record),
                      ("fp8", sess.reference_steps("fp8")),
                      ("bf16_state", sess.reference_steps("bf16_state"))):
        nums, notes = loop.train_numbers(rec, ref)
        out[name] = dict(nums, loss_gap_first=notes["loss_gap_first"],
                         grad_err_median=notes["grad_err_median"],
                         grad_gap_median=notes["grad_gap_median"],
                         change_gap_median=notes["change_gap_median"])
        out[name + "_notes"] = notes
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    files = harness.Files()
    cell = harness.cell_of(files.spec(), args.workload)
    config = files.json("configs", cell["config"])
    traffic = files.json("traffic", cell["traffic"])
    reference = importlib.import_module(
        f"perfbench.reference.{config['reference']}")
    step = importlib.import_module(f"perfbench.steps.{traffic['step']}")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    print(f"calibrate: {harness.card_line()}", file=sys.stderr)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        if traffic["step"] == "fusion_train":
            r = train_readings(step, config, traffic, seed, device,
                               reference)
        else:
            r = serve_readings(step, config, traffic, seed, device,
                               reference, args.seconds)
        r["seed"] = seed
        rows.append(r)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    kinds = [k for k in rows[0] if isinstance(rows[0][k], dict)
             and not k.endswith("_notes")]
    summary = {"workload": args.workload, "seeds": len(rows)}
    for kind in kinds:
        agg = max if kind == "program" else min
        summary[kind] = {n: agg(r[kind][n] for r in rows)
                         for n in rows[0][kind]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
