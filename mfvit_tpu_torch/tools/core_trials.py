"""Trial builds of T2's rolling core (csrc/attn_rolling.cu) and T5's
staged core (csrc/attn_bwd_staged.cuh), or (``--set t3t4``) of T4's
staged core (csrc/attn_staged.cu) and T3's registers (csrc/block_tail.cuh's
PIPE), or (``--set t1``) of T1's pair core (csrc/attn_pairs.cu), on one
card, the trade of warps against registers and passes that set their
constants:

    python -m mfvit_tpu_torch.tools.core_trials [--set t2t5|t3t4|t1] \
        [--out FILE]

Each trial is a copy of this checkout's port under
``build/core_trials/<tag>`` with ``RollCore::W``, ``RollCore::PASSES``
and ``StagedBwd::W`` set as ``TRIALS`` says, keeping only the sources K1,
K5, T2 and T5 build from (its library binds the entry points those
define). The copies build in parallel; then each trial runs in a process
of its own, in turns (the trials in order, then reversed): T2 at cb 4, 8
and 16 and T5 at cb 2 and 4 at vit_small B=256 (12 heads of 32), T2 at
cb=8 and T5 at cb=2 at 6 heads of 64 and 3 of 128, K1 and K5 beside
each, every call first held equal to its base kernel bit for bit, then
timed with CUDA events. ``--set t3t4`` does the same with
``StagedCore::G`` and ``PASSES`` (T4) and T3's setmaxnreg pair set as
``FWD_TRIALS`` says, from the sources K1, K2, T3 and T4 build from: T4 at
cb 2 and 4 at vit_small B=256 and at cb=2 at 6 heads of 64 and 3 of 128,
K1 beside each, and T3 at each (splits, tm) beside K2. ``--set t1`` does
the same with ``PairCore``'s warps, passes, images a tile and deferral set
as ``PAIRS_TRIALS`` says, from the sources K1 and T1 build from: T1 at cb 4
and 8 at vit_small B=256 and at cb=4 at 6 heads of 64 and 3 of 128, K1
beside each; it also prints each trial's registers, stack and spills of
T1's kernels from the compiler's ``-Xptxas -v`` report. Prints the card's
name and power limit and one line a reading, and writes every reading to
FILE as JSON. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
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
# tag -> (T4's warps a group at head_dim 32 and 64, at 128; its passes at 32
# and 64, at 128; T3's setmaxnreg, consumer and producer); "tree" is this
# checkout's setting
FWD_TRIALS = {"tree": ((7, 7), (2, 2), (240, 24)),
              "A": ((7, 7), (2, 2), (232, 40)),
              "B": ((6, 6), (2, 2), (240, 24)),
              "C": ((7, 7), (1, 1), (240, 24))}
STAGED_G = "static constexpr int G = 7;"
STAGED_PASSES = "static constexpr int PASSES = 2;"
PIPE_REGS = ("constexpr int PIPE_CONSUMER_REGS = 240, PIPE_PRODUCER_REGS = "
             "24;")
FWD_SOURCES = {"attn_staged.cu", "attn_async.cu", "fused_attn.cu",
               "fused_mlp.cu", "mlp_pipe.cu"}
# tag -> (T1's warps at head_dim 32 and 64, at 128; its passes at 32 and
# 64, at 128; its images a tile (2: pair tiles, both images' chains
# interleaved; 1: image tiles) at 32 and 64, at 128; whether a tile's P V
# waits past the next tile's softmax); "tree" is this checkout's setting.
# The deferral's grains: (i) pair tiles deferred (the TPU's order), (ii)
# image tiles deferred, a pair in each slot, (iii) pair tiles undeferred.
PAIRS_TRIALS = {"tree": ((11, 7), (2, 2), (1, 1), True),
                "A": ((7, 7), (2, 1), (2, 2), True),
                "B": ((15, 7), (2, 1), (2, 2), True),
                "C": ((9, 7), (1, 1), (2, 2), True),
                "D": ((11, 7), (2, 1), (1, 1), True),
                "E": ((15, 7), (2, 2), (1, 1), True),
                "F": ((11, 7), (2, 1), (2, 2), False),
                "G": ((9, 9), (2, 2), (2, 1), True)}
PAIRS_W = "static constexpr int W = DH == 128 ? 7 : 11;"
PAIRS_PASSES = "static constexpr int PASSES = 2;"
PAIRS_NI = "static constexpr int NI = 1;"
PAIRS_DEFER = "static constexpr bool DEFER = true;"
PAIRS_SOURCES = {"attn_pairs.cu", "attn_async.cu", "fused_attn.cu"}
BIND_DEFINED = '''
SIGNATURES = {k: v for k, v in SIGNATURES.items()
              if any(f"MFV_API int {k}(" in p.read_text()
                     for p in CSRC.glob("*.cu"))}
'''

CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
from mfvit_tpu_torch.ops import build
from mfvit_tpu_torch.tools.core_trials import %s
build.lib()
print("RESULT " + json.dumps(%s(torch.device("cuda"))))
"""


def _copy_tree(root: Path, dest: Path, sources: set, edits) -> None:
    """A copy of ``root``'s port and ``chip_smoke.py`` at ``dest`` with
    only ``sources`` to build, each (file, old, new) of ``edits`` made, and
    its library binding only the entry points those define."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(root / "mfvit_tpu_torch", dest / "mfvit_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "chip_smoke.py", dest)
    csrc = dest / "mfvit_tpu_torch" / "csrc"
    for f in csrc.glob("*.cu"):
        if f.name not in sources:
            f.unlink()
    for name, old, new in edits:
        text = (csrc / name).read_text()
        if old not in text:
            raise RuntimeError(f"{name} no longer holds {old!r}")
        (csrc / name).write_text(text.replace(old, new))
    build_py = dest / "mfvit_tpu_torch" / "ops" / "build.py"
    text = build_py.read_text()
    i = text.index("_lib = None")
    build_py.write_text(text[:i] + BIND_DEFINED + "\n" + text[i:])


def make_tree(root: Path, dest: Path, trial: tuple) -> None:
    """A copy with a ``TRIALS`` entry's constants (T2, T5) and only
    ``SOURCES`` to build."""
    (w, w128), (passes, passes128), staged_w = trial
    _copy_tree(root, dest, SOURCES, (
        ("attn_rolling.cu", ROLL_W,
         f"static constexpr int W = DH == 128 ? {w128} : {w};"),
        ("attn_rolling.cu", ROLL_PASSES,
         f"static constexpr int PASSES = DH == 128 ? {passes128} : "
         f"{passes};"),
        ("attn_bwd_staged.cuh", STAGED_W,
         f"static constexpr int W = {staged_w};")))


def make_fwd_tree(root: Path, dest: Path, trial: tuple) -> None:
    """A copy with a ``FWD_TRIALS`` entry's constants (T4, T3) and only
    ``FWD_SOURCES`` to build."""
    (g, g128), (passes, passes128), (regs, pregs) = trial
    _copy_tree(root, dest, FWD_SOURCES, (
        ("attn_staged.cu", STAGED_G,
         f"static constexpr int G = DH == 128 ? {g128} : {g};"),
        ("attn_staged.cu", STAGED_PASSES,
         f"static constexpr int PASSES = DH == 128 ? {passes128} : "
         f"{passes};"),
        ("block_tail.cuh", PIPE_REGS,
         f"constexpr int PIPE_CONSUMER_REGS = {regs}, PIPE_PRODUCER_REGS = "
         f"{pregs};")))


def make_pairs_tree(root: Path, dest: Path, trial: tuple) -> None:
    """A copy with a ``PAIRS_TRIALS`` entry's constants (T1) and only
    ``PAIRS_SOURCES`` to build."""
    (w, w128), (passes, passes128), (ni, ni128), defer = trial
    _copy_tree(root, dest, PAIRS_SOURCES, (
        ("attn_pairs.cu", PAIRS_W,
         f"static constexpr int W = DH == 128 ? {w128} : {w};"),
        ("attn_pairs.cu", PAIRS_PASSES,
         f"static constexpr int PASSES = DH == 128 ? {passes128} : "
         f"{passes};"),
        ("attn_pairs.cu", PAIRS_NI,
         f"static constexpr int NI = DH == 128 ? {ni128} : {ni};"),
        ("attn_pairs.cu", PAIRS_DEFER,
         f"static constexpr bool DEFER = {'true' if defer else 'false'};")))


def ptxas_report(log: str, kernel: str, source: str) -> dict:
    """The registers, stack frame and spill bytes of each instance of
    ``kernel`` compiled from ``source`` in a build log (``build.py``'s: each
    nvcc command line, then its ``-Xptxas -v`` report): "DH=.. NKT=.." (its
    template arguments) -> {"registers", "stack", "spill_stores",
    "spill_loads"}. Another source may hold a kernel of the same name in an
    anonymous namespace (a former design)."""
    out, cur, mine = {}, None, False
    for line in log.splitlines():
        if " -c " in line:  # a command line starts the next source's report
            mine, cur = f"/{source} -o " in line, None
            continue
        if not mine:
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = None
            if kernel in m.group(1):
                args = re.search(r"ILi(\d+)ELi(\d+)E", m.group(1))
                cur = (f"DH={args.group(1)} NKT={args.group(2)}" if args
                       else m.group(1))
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            cur = None
    return out


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


def fwd_times(dev, B: int = 256, iters: int = 20) -> dict:
    """The trial's readings of T4 and T3 at vit_small batch B
    (``chip_smoke.block_inputs``, seed 18): name -> [ms, ms], each call held
    equal to K1 (T4) or K2 (T3) first."""
    import torch

    import chip_smoke as cs
    from mfvit_tpu_torch.ops import attn_variants as av
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_mlp as fm
    from mfvit_tpu_torch.ops import mlp_variants as mv
    t = cs.block_inputs(torch.Generator().manual_seed(18), B, 384, dev)
    a = [t[k] for k in ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj",
                        "bproj")]
    m = [t[k] for k in ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")]

    def call(op, *args, **kw):
        return lambda: op(*args, **kw)

    calls = {"k2": (None, call(fm.fused_mlp_block, *m))}
    for sp, tm in ((2, 128), (1, 128), (1, 64)):
        calls[f"t3 s={sp} tm={tm}"] = ("k2", call(mv.mlp_pipe, *m,
                                                   splits=sp, tm=tm))
    for heads, cbs in ((12, (2, 4)), (6, (2,)), (3, (2,))):
        sc, tag = (384 // heads) ** -0.5, f" H={heads}"
        calls["k1" + tag] = (None, call(fa.fused_attention_block, *a, heads,
                                        sc))
        for cb in cbs:
            calls[f"t4 cb={cb}{tag}"] = ("k1" + tag, call(
                av.attn_staged, *a, heads, sc, cb=cb))
    out = {name: [] for name in calls}
    with torch.inference_mode():
        for name, (base, fn) in calls.items():
            if base and not torch.equal(fn(), calls[base][1]()):
                raise AssertionError(f"{name} differs from {base}")
        for name in (*calls, *reversed(calls)):
            out[name].append(cs.cuda_ms(calls[name][1], iters))
    return out


def pairs_times(dev, B: int = 256, iters: int = 20) -> dict:
    """The trial's readings of T1 at vit_small batch B
    (``chip_smoke.block_inputs``, seed 18): name -> [ms, ms], each call held
    equal to K1 first."""
    import torch

    import chip_smoke as cs
    from mfvit_tpu_torch.ops import attn_variants as av
    from mfvit_tpu_torch.ops import fused_attn as fa
    t = cs.block_inputs(torch.Generator().manual_seed(18), B, 384, dev)
    a = [t[k] for k in ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj",
                        "bproj")]

    def call(op, *args, **kw):
        return lambda: op(*args, **kw)

    calls = {}
    for heads, cbs in ((12, (4, 8)), (6, (4,)), (3, (4,))):
        sc, tag = (384 // heads) ** -0.5, f" H={heads}"
        calls["k1" + tag] = (None, call(fa.fused_attention_block, *a, heads,
                                        sc))
        for cb in cbs:
            calls[f"t1 cb={cb}{tag}"] = ("k1" + tag, call(
                av.attn_pairs, *a, heads, sc, cb=cb))
    out = {name: [] for name in calls}
    with torch.inference_mode():
        for name, (base, fn) in calls.items():
            if base and not torch.equal(fn(), calls[base][1]()):
                raise AssertionError(f"{name} differs from {base}")
        for name in (*calls, *reversed(calls)):
            out[name].append(cs.cuda_ms(calls[name][1], iters))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", choices=("t2t5", "t3t4", "t1"),
                    default="t2t5")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    trials, make, fn = {"t2t5": (TRIALS, make_tree, "times"),
                        "t3t4": (FWD_TRIALS, make_fwd_tree, "fwd_times"),
                        "t1": (PAIRS_TRIALS, make_pairs_tree,
                               "pairs_times")}[args.set]
    base = turns.ROOT / "build" / "core_trials"
    trees = {tag: base / tag for tag in trials}
    for tag, trial in trials.items():
        make(turns.ROOT, trees[tag], trial)
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); from "
         "mfvit_tpu_torch.ops import build; build.lib()"], cwd=tree)
        for tree in trees.values()]
    if any([p.wait() for p in builds]):
        raise RuntimeError("a trial build failed")
    ptxas = {}
    if args.set == "t1":
        for tag, tree in trees.items():
            log = (tree / "build" / "mfvit_tpu_torch" / "build.log")
            ptxas[tag] = ptxas_report(log.read_text(), "attn_pairs_kernel",
                                      "attn_pairs.cu")
            for inst, r in ptxas[tag].items():
                print(f"trial {tag} {trials[tag]}: attn_pairs_kernel {inst}: "
                      f"{r.get('registers')} registers, {r.get('stack')} "
                      f"bytes stack, {r.get('spill_stores')} bytes spill "
                      f"stores, {r.get('spill_loads')} bytes spill loads")
    order = [*trials, *reversed(trials)]
    runs = [(tag, turns.turn(trees[tag], CHILD % (fn, fn)))
            for tag in order]
    for tag, trial in trials.items():
        for name in runs[0][1]:
            ms = [v for t, r in runs if t == tag for v in r[name]]
            print(f"trial {tag} {trial}: {name}: " + "/".join(
                f"{v:.4f}" for v in ms) + " ms")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "trials": trials,
                                        "order": order, "ptxas": ptxas,
                                        "runs": [r for _, r in runs]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
