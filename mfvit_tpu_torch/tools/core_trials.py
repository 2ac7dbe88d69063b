"""Trial builds of T2's rolling core (csrc/attn_rolling.cu) and T5's
staged core (csrc/attn_bwd_staged.cuh) on one card, the trade of warps
against registers and passes that set their constants:

    python -m mfvit_tpu_torch.tools.core_trials [--out FILE]

Each trial is a copy of this checkout's port under
``build/core_trials/<tag>`` with ``RollCore::W``, ``RollCore::PASSES``
and ``StagedBwd::W`` set as ``TRIALS`` says, keeping only the sources K1,
K5, T2 and T5 build from (its library binds the entry points those
define). The copies build in parallel; then each trial runs in a process
of its own, in turns (the trials in order, then reversed): T2 at cb 4, 8
and 16 and T5 at cb 2 and 4 at vit_small B=256 (12 heads of 32), T2 at
cb=8 and T5 at cb=2 at 6 heads of 64 and 3 of 128, K1 and K5 beside
each, every call first held equal to its base kernel bit for bit, then
timed with CUDA events. Prints the card's name and power limit and one
line a reading, and writes every reading to FILE as JSON. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

from mfvit_tpu_torch.tools import turns

# tag -> (T2's warps at head_dim 32 and 64, at 128; its passes at 32 and
# 64, at 128; T5's warps); "tree" is this checkout's setting
TRIALS = {"tree": ((11, 7), (2, 1), 7), "A": ((15, 7), (2, 2), 11),
          "B": ((11, 7), (1, 1), 15), "C": ((7, 7), (1, 1), 7)}
ROLL_W = "static constexpr int W = DH == 128 ? 7 : 11;"
ROLL_PASSES = "static constexpr int PASSES = DH == 128 ? 1 : 2;"
STAGED_W = "static constexpr int W = 7;"
SOURCES = {"attn_rolling.cu", "attn_async.cu", "fused_attn.cu",
           "fused_attn_bwd.cu"} | {
    f"attn_bwd_{kind}dh{dh}.cu" for kind in ("", "async_", "staged_")
    for dh in (32, 64, 128)}
BIND_DEFINED = '''
SIGNATURES = {k: v for k, v in SIGNATURES.items()
              if any(f"MFV_API int {k}(" in p.read_text()
                     for p in CSRC.glob("*.cu"))}
'''

CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
from mfvit_tpu_torch.ops import build
from mfvit_tpu_torch.tools.core_trials import times
build.lib()
print("RESULT " + json.dumps(times(torch.device("cuda"))))
"""


def make_tree(root: Path, dest: Path, trial: tuple) -> None:
    """A copy of ``root``'s port and ``chip_smoke.py`` at ``dest`` with the
    trial's constants and only ``SOURCES`` to build."""
    (w, w128), (passes, passes128), staged_w = trial
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(root / "mfvit_tpu_torch", dest / "mfvit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "chip_smoke.py", dest)
    csrc = dest / "mfvit_tpu_torch" / "csrc"
    for f in csrc.glob("*.cu"):
        if f.name not in SOURCES:
            f.unlink()
    for name, old, new in (
            ("attn_rolling.cu", ROLL_W,
             f"static constexpr int W = DH == 128 ? {w128} : {w};"),
            ("attn_rolling.cu", ROLL_PASSES,
             f"static constexpr int PASSES = DH == 128 ? {passes128} : "
             f"{passes};"),
            ("attn_bwd_staged.cuh", STAGED_W,
             f"static constexpr int W = {staged_w};")):
        text = (csrc / name).read_text()
        if old not in text:
            raise RuntimeError(f"{name} no longer holds {old!r}")
        (csrc / name).write_text(text.replace(old, new))
    build_py = dest / "mfvit_tpu_torch" / "ops" / "build.py"
    text = build_py.read_text()
    i = text.index("_lib = None")
    build_py.write_text(text[:i] + BIND_DEFINED + "\n" + text[i:])


def times(dev, B: int = 256, iters: int = 20) -> dict:
    """The trial's readings at vit_small batch B (``chip_smoke.
    block_inputs``, seed 18; T5's cotangent seed 19): name -> [ms, ms],
    each call held equal to K1 (T2) or K5 (T5, every output) first."""
    import torch

    import chip_smoke as cs
    from mfvit_tpu_torch.ops import attn_variants as av
    from mfvit_tpu_torch.ops import fused_attn as fa
    t = cs.block_inputs(torch.Generator().manual_seed(18), B, 384, dev)
    a = [t[k] for k in ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj",
                        "bproj")]
    g = torch.randn(B, 197, 384, generator=torch.Generator().manual_seed(
        19)).to(dev).bfloat16()
    def call(op, *args, **kw):
        return lambda: op(*args, **kw)

    calls = {}  # name -> (its base kernel's name, call)
    for heads, t2_cbs, t5_cbs in ((12, (4, 8, 16), (2, 4)), (6, (8,), (2,)),
                                  (3, (8,), (2,))):
        sc, tag = (384 // heads) ** -0.5, f" H={heads}"
        calls["k1" + tag] = (None, call(fa.fused_attention_block, *a, heads,
                                        sc))
        calls["k5" + tag] = (None, call(fa.fused_attention_block_bwd, g,
                                        *a[:6], heads, sc))
        for cb in t2_cbs:
            calls[f"t2 cb={cb}{tag}"] = ("k1" + tag, call(
                av.attn_rolling, *a, heads, sc, cb=cb))
        for cb in t5_cbs:
            calls[f"t5 cb={cb}{tag}"] = ("k5" + tag, call(
                av.staged_bwd, g, *a[:6], heads, sc, cb=cb))
    out = {name: [] for name in calls}
    with torch.inference_mode():
        for name, (base, fn) in calls.items():
            if base and not all(torch.equal(u, v) for u, v in zip(
                    cs.as_tuple(fn()), cs.as_tuple(calls[base][1]()))):
                raise AssertionError(f"{name} differs from {base}")
        for name in (*calls, *reversed(calls)):
            out[name].append(cs.cuda_ms(calls[name][1], iters))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    base = turns.ROOT / "build" / "core_trials"
    trees = {tag: base / tag for tag in TRIALS}
    for tag, trial in TRIALS.items():
        make_tree(turns.ROOT, trees[tag], trial)
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); from "
         "mfvit_tpu_torch.ops import build; build.lib()"], cwd=tree)
        for tree in trees.values()]
    if any([p.wait() for p in builds]):
        raise RuntimeError("a trial build failed")
    order = [*TRIALS, *reversed(TRIALS)]
    runs = [(tag, turns.turn(trees[tag], CHILD)) for tag in order]
    for tag, trial in TRIALS.items():
        for name in runs[0][1]:
            ms = [v for t, r in runs if t == tag for v in r[name]]
            print(f"trial {tag} {trial}: {name}: " + "/".join(
                f"{v:.4f}" for v in ms) + " ms")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "trials": TRIALS,
                                        "order": order,
                                        "runs": [r for _, r in runs]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
