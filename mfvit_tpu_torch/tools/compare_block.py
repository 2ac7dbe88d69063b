"""Time K15, K1-K5, K7, K9, K10, K11 and the schedule variants T1-T7 of
two checkouts of the repository on one card, in turns, and the
end-to-end figures beside them:

    python -m mfvit_tpu_torch.tools.compare_block --other DIR [--out FILE] \
        [--only variants]

DIR holds another checkout (for example a ``git archive`` of the parent
commit unpacked into a directory that ``.gitignore`` lists). Each turn is a
process of its own, started in one checkout (``tools/turns.py``, turns
other, this, this, other), that builds that checkout's kernels and runs:
its own ``chip_smoke.time_block`` (K15, the K1 -> K2 pair, K15's plain
version and the library block at vit_small B=256), ``half_times`` below
(K1, K2, K3 and K4 alone at B=256), ``stage_times`` below (the launches of
K15, K1, K2, K3, K4, K5 and K7 one by one under ``torch.profiler``; K5 and
K7 also at vit_base, B=64, as K6 and K8), its own ``chip_smoke.time_bwd``
(K5 and K7 against their plain backward at vit_small B=256 and vit_base
B=64),
``long_times`` below (K9 at vit_small@384 B=64 and vit_small_ori@512 B=16,
K11 at vit_small B=256, vit_base B=64 and vit_small@384 B=64, K2 there,
K10 at vit_small B=256, vit_small_ori@384 B=64 and vit_base B=64) and the
launches of each under ``stage_times``, ``bench_block``'s 12-block chains at
B=512, the GEMM cores alone at B=256 where the checkout has
``ops.gemm`` (``chip_smoke.time_gemm``), then the serving pairs/s at B=256
and at 384 px, B=64 (``time_e2e``: bf16, int8 and the XLA-level W8A8
path; at 384 px also on vit_small_ori, whose int8 path runs K10 past 256
tokens, ``e2e_ori384``), the FT step's images/s at B=256 and B=16
(``time_train``) and the fusion step's pairs/s at B=256 (``time_fusion``,
LP and ``--semi-supervised``). Every turn also runs ``variant_times``
below (T6 flat and per image and T7 at cb 2, 4 and 8 and T3 at its three
(splits, tm) beside K2, T2 at cb 4, 8 and 16, T4 at cb 2 and 4 and T1 at
cb 4 and 8 beside K1, T5 at cb 2 and 4 beside K5, and their former designs
where the checkout has them, at vit_small B=256), the "t6", "t7", "t3",
"t2", "t4", "t1" and "t5" breakdowns of ``stage_times`` (and the former
designs'),
``overlap_probe`` (T6 per image on K2's and on T7's ring depth against
T7, at D of 128-512), ``pipe_probe`` (T3's 128-row tile against K2 at D
of 128-384), and ``output_digests`` (a hash of the output bits
of K1, K2, K3, K5, K9, K10, K15 and of T6, T7, T3, T2, T4, T1 and T5 on
fixed inputs, which must be the same in both checkouts where their
functions are).
``--only variants`` runs only K15's ``time_block``, ``half_times``, those
four and the breakdowns of K1, K2, K5 and the variants. Prints the
card's name and power limit, one line a reading, and writes every
reading to FILE as JSON.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
from pathlib import Path

from mfvit_tpu_torch.tools import turns


def stage_times(dev, op: str = "k15", B: int = 256, iters: int = 5,
                D: int = 384, N: int = 197, heads: int = 12) -> dict:
    """The device ms of each kernel that one call of ``op`` launches at
    batch B, N tokens, width D and ``heads`` heads (hidden 4D; vit_small at
    D=384, vit_base at 768; ``chip_smoke.block_inputs``, seed 16), under
    ``torch.profiler`` over ``iters`` calls: "k15" K15, "k1" K1, "k2" K2,
    "k3" K3 and "k9" K9 (on the block's x), "k10" K10 and "k11" K11 (on
    the block's weights quantized per output channel), "k4" K4 (the fusion
    head, 3 heads of 128, on ``chip_smoke.fusion_inputs``, seed 16), "k5"
    K5 and "k7" K7 (the backward halves, for a cotangent drawn with seed
    17; K6 and K8 at D=768); "k1_wmma", "k2_wmma", "k3_wmma", "k4_kv",
    "k5_wmma", "k7_wmma", "k9_wmma", "k10_mma" and "k11_mma" the former
    designs, where the checkout has them; "k10_three" and "k10_five" K10's
    two routes forced; "t6" T6 (``mlp3d`` flat, cb=4) and "t7" T7
    (``mlp3d_staged``, cb=4) on K2's inputs, "t6_wmma" and "t7_wmma" their
    former designs where the checkout has them; "t3" T3 (``mlp_pipe`` at
    splits=2, tm=128) on K2's inputs and "t4" T4 (``attn_staged``, cb=2)
    on K1's, "t3_former" and "t4_wmma" their former designs (the
    checkout's ``mlp_pipe_mma`` at its default and ``attn_staged_wmma``,
    or ``mlp_pipe`` and ``attn_staged`` where they are still those); "t1"
    T1 (``attn_pairs``, cb=4) on K1's inputs and "t1_wmma" its former
    design (``attn_pairs_wmma``, or ``attn_pairs`` in a checkout where it
    is still the first design). Kernel name
    (namespace and parameters dropped, template arguments kept, so that
    two instances of one template stay apart; "t2" T2 (``attn_rolling``,
    cb=8) and "t5" T5 (``staged_bwd``, cb=2) on K1's and K5's inputs,
    "t2_wmma" and "t5_former" their former designs where the checkout has
    them; the n-th launch of a name
    within one call as "name #n") -> its mean device ms, in launch order.
    Where the profiler saw every launch of every call, each launch is
    averaged over the calls; else each name over its launches (the
    profiler may miss the window's first launches). A window that saw no
    launch is taken again once (the profiler has returned an empty
    window among the many of one process), and a second such window
    raises."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from mfvit_tpu_torch.ops import attn_variants as av
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_block as fb
    from mfvit_tpu_torch.ops import fused_fusion as ff
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    from mfvit_tpu_torch.ops import fused_mlp as fm
    from mfvit_tpu_torch.ops import mlp_variants as mv
    t = chip_smoke.block_inputs(torch.Generator().manual_seed(16), B, D, dev,
                                N=N)
    a = [t[k] for k in chip_smoke.K15_KEYS]
    fin = (t["fs"], t["fb"])
    scale = (D // heads) ** -0.5
    g = torch.randn(B, N, D, generator=torch.Generator().manual_seed(17))
    g = g.to(dev).bfloat16()
    tok = chip_smoke.fusion_inputs(torch.Generator().manual_seed(16), B, D,
                                   dev)
    i8 = chip_smoke.i8_args(t, heads) if op.startswith(("k10",
                                                        "k11")) else {}
    call = {"k15": lambda: fb.fused_transformer_block(*a, heads, scale),
            "k1": lambda: fa.fused_attention_block(*a[:7], heads, scale),
            "k9": lambda: fa.fused_attention_block_large(*a[:7], heads,
                                                         scale),
            "k9_wmma": lambda: fa.fused_attention_block_large_wmma(
                *a[:7], heads, scale),
            "k10": lambda: fi8.fused_attention_block_i8(
                a[0], *i8["fused_attention_block_i8"]),
            "k10_three": lambda: fi8.fused_attention_block_i8_route(
                a[0], *i8["fused_attention_block_i8"], True),
            "k10_five": lambda: fi8.fused_attention_block_i8_route(
                a[0], *i8["fused_attention_block_i8"], False),
            "k10_mma": lambda: fi8.fused_attention_block_i8_mma(
                a[0], *i8["fused_attention_block_i8"]),
            "k11": lambda: fi8.fused_mlp_block_i8(
                a[0], *i8["fused_mlp_block_i8"]),
            "k11_mma": lambda: fi8.fused_mlp_block_i8_mma(
                a[0], *i8["fused_mlp_block_i8"]),
            "k2": lambda: fm.fused_mlp_block(a[0], *a[7:]),
            "k3": lambda: fm.fused_mlp_block_final_ln(a[0], *a[7:], *fin),
            "k4": lambda: ff.fused_fusion_cls(*tok, 3),
            "k5": lambda: fa.fused_attention_block_bwd(g, *a[:6], heads,
                                                       scale),
            "k7": lambda: fm.fused_mlp_block_bwd(g, a[0], *a[7:12]),
            "k1_wmma": lambda: fa.fused_attention_block_wmma(*a[:7], heads,
                                                             scale),
            "k2_wmma": lambda: fm.fused_mlp_block_wmma(a[0], *a[7:]),
            "k3_wmma": lambda: fm.fused_mlp_block_final_ln_wmma(
                a[0], *a[7:], *fin),
            "k4_kv": lambda: ff.fused_fusion_cls_kv(*tok, 3),
            "k5_wmma": lambda: fa.fused_attention_block_bwd_wmma(
                g, *a[:6], heads, scale),
            "k7_wmma": lambda: fm.fused_mlp_block_bwd_wmma(g, a[0],
                                                           *a[7:12]),
            "t6": lambda: mv.mlp3d(a[0], *a[7:], cb=4, flat=True),
            "t7": lambda: mv.mlp3d_staged(a[0], *a[7:], cb=4),
            "t6_wmma": lambda: mv.mlp3d_wmma(a[0], *a[7:], cb=4, flat=True),
            "t7_wmma": lambda: mv.mlp3d_staged_wmma(a[0], *a[7:], cb=4),
            "t2": lambda: av.attn_rolling(*a[:7], heads, scale, cb=8),
            "t2_wmma": lambda: av.attn_rolling_wmma(*a[:7], heads, scale,
                                                    cb=8),
            "t5": lambda: av.staged_bwd(g, *a[:6], heads, scale, cb=2),
            "t5_former": lambda: av.staged_bwd_former(g, *a[:6], heads,
                                                      scale, cb=2),
            "t3": lambda: mv.mlp_pipe(a[0], *a[7:], splits=2, tm=128),
            "t4": lambda: av.attn_staged(*a[:7], heads, scale, cb=2),
            "t3_former": lambda: getattr(mv, "mlp_pipe_mma", mv.mlp_pipe)(
                a[0], *a[7:]),
            "t4_wmma": lambda: getattr(av, "attn_staged_wmma",
                                       av.attn_staged)(*a[:7], heads, scale,
                                                       cb=2),
            "t1": lambda: av.attn_pairs(*a[:7], heads, scale, cb=4),
            "t1_wmma": lambda: getattr(av, "attn_pairs_wmma",
                                       av.attn_pairs)(*a[:7], heads, scale,
                                                      cb=4)}[op]
    with torch.inference_mode():
        call()
        torch.cuda.synchronize()
        for _ in range(2):  # a second window where the first saw nothing
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    call()
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events()
                             if e.device_type == DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            if events:
                break
    if not events:
        raise RuntimeError(f"stage_times {op}: torch.profiler saw no "
                           "launch on the card in two windows")
    names = [re.sub(r"^void |\(anonymous namespace\)::|\w+::", "",
                    e.name).split("(")[0] for e in events]
    ms = [e.time_range.elapsed_us() / 1e3 for e in events]
    L = len(events) // iters
    if L and len(events) == L * iters and all(
            names[i] == names[i % L] for i in range(len(names))):
        seen, keys = {}, []
        for n in names[:L]:  # one call's launches, repeats numbered
            seen[n] = seen.get(n, 0) + 1
            keys.append(n if seen[n] == 1 else f"{n} #{seen[n]}")
        out = {k: sum(ms[i::L]) / iters for i, k in enumerate(keys)}
    else:  # the profiler missed launches: one mean a name, in first launch order
        runs = {}
        for n, v in zip(names, ms):
            runs.setdefault(n, []).append(v)
        out = {n: sum(v) / len(v) for n, v in runs.items()}
    print(f"{op.upper()}'s launches at B={B}, N={N}, D={D} (device ms per "
          "call, "
          "torch.profiler): " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in out.items())
          + f"; sum {sum(out.values()):.4f} ({len(events)} launches in "
          f"{iters} calls)")
    return out


def half_times(dev, B: int = 256, iters: int = 20) -> dict:
    """K1, K2, K3 (``chip_smoke.block_inputs``, seed 16) and K4 (the fusion
    head, 3 heads of 128, ``chip_smoke.fusion_inputs``, seed 16) at
    vit_small batch B, each timed twice with CUDA events in turns (K1, K2,
    K3, K4, K4, K3, K2, K1): name -> [ms, ms]."""
    import torch

    import chip_smoke
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_fusion as ff
    from mfvit_tpu_torch.ops import fused_mlp as fm
    t = chip_smoke.block_inputs(torch.Generator().manual_seed(16), B, 384, dev)
    a = [t[k] for k in chip_smoke.K15_KEYS]
    tok = chip_smoke.fusion_inputs(torch.Generator().manual_seed(16), B, 384,
                                   dev)
    calls = {"k1": lambda: fa.fused_attention_block(*a[:7], 12, 32 ** -0.5),
             "k2": lambda: fm.fused_mlp_block(a[0], *a[7:]),
             "k3": lambda: fm.fused_mlp_block_final_ln(a[0], *a[7:], t["fs"],
                                                       t["fb"]),
             "k4": lambda: ff.fused_fusion_cls(*tok, 3)}
    out = {name: [] for name in calls}
    with torch.inference_mode():
        for name in (*calls, *reversed(calls)):
            out[name].append(chip_smoke.cuda_ms(calls[name], iters))
    print(f"K1-K4 at B={B}: " + ", ".join(
        f"{k} {'/'.join(f'{v:.4f}' for v in ms)} ms" for k, ms in out.items()))
    return out


# the long-sequence and int8 halves ``long_times`` and ``stage_times``
# take: op, label, B, N, D, heads
LONG_SHAPES = (("k9", "vit_small@384", 64, 577, 384, 12),
               ("k9", "vit_small_ori@512", 16, 1025, 384, 6),
               ("k11", "vit_small", 256, 197, 384, 12),
               ("k11", "vit_base", 64, 197, 768, 12),
               ("k11", "vit_small@384", 64, 577, 384, 12),
               ("k2", "vit_small@384", 64, 577, 384, 12),
               ("k10", "vit_small", 256, 197, 384, 12),
               ("k10", "vit_small_ori@384", 64, 577, 384, 6),
               ("k10", "vit_base", 64, 197, 768, 12))


def long_times(dev, iters: int = 20) -> dict:
    """K9, K11, K2 and K10 at LONG_SHAPES (``chip_smoke.block_inputs``,
    seed 16; K10 and K11 on the block's weights quantized per output
    channel), each timed twice with CUDA events in turns (the shapes in
    order, then in reverse): "<op> <label> B=<B>" -> [ms, ms]."""
    import torch

    import chip_smoke
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    from mfvit_tpu_torch.ops import fused_mlp as fm
    calls = {}
    for op, label, B, N, D, heads in LONG_SHAPES:
        t = chip_smoke.block_inputs(torch.Generator().manual_seed(16), B, D,
                                    dev, N=N)
        a = [t[k] for k in chip_smoke.K15_KEYS]
        i8 = chip_smoke.i8_args(t, heads)
        scale = (D // heads) ** -0.5
        calls[f"{op} {label} B={B}"] = {
            "k9": lambda a=a, h=heads, s=scale:
                fa.fused_attention_block_large(*a[:7], h, s),
            "k11": lambda a=a, i8=i8: fi8.fused_mlp_block_i8(
                a[0], *i8["fused_mlp_block_i8"]),
            "k2": lambda a=a: fm.fused_mlp_block(a[0], *a[7:]),
            "k10": lambda a=a, i8=i8: fi8.fused_attention_block_i8(
                a[0], *i8["fused_attention_block_i8"])}[op]
    out = {name: [] for name in calls}
    with torch.inference_mode():
        for name in (*calls, *reversed(calls)):
            out[name].append(chip_smoke.cuda_ms(calls[name], iters))
    print("K9, K11, K2 and K10: " + ", ".join(
        f"{k} {'/'.join(f'{v:.4f}' for v in ms)} ms" for k, ms in out.items()))
    return out


def variant_calls(t) -> dict:
    """T6 flat and per image ("loop") and T7 at cb 2, 4 and 8 on one
    block's MLP inputs ``t`` (``chip_smoke.block_inputs``) beside K2, T3 at
    (splits, tm) (2, 128), (1, 128) and (1, 64) beside K2, T2 at cb 4, 8
    and 16, T4 at cb 2 and 4 and T1 at cb 4 and 8 on its attention inputs
    beside K1, T5 at cb 2 and 4 on them and a cotangent drawn with seed 17
    beside K5, and the former designs where the checkout has them
    (``mlp3d_wmma``, ``mlp3d_staged_wmma``, ``attn_rolling_wmma``,
    ``staged_bwd_former``; "t3_former", T3's first design at its default,
    "t4_wmma" at cb 2 and 4 and "t1_wmma" at cb 4 and 8: ``mlp_pipe_mma``,
    ``attn_staged_wmma`` and ``attn_pairs_wmma``, or ``mlp_pipe``,
    ``attn_staged`` and ``attn_pairs`` in a checkout where those are still
    the first designs): name -> call (T5 and K5 return their seven
    outputs)."""
    import torch

    from mfvit_tpu_torch.ops import attn_variants as av
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_mlp as fm
    from mfvit_tpu_torch.ops import mlp_variants as mv
    a = [t[k] for k in ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")]
    x = [t[k] for k in ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj",
                        "bproj")]
    g = torch.randn(*t["x"].shape, generator=torch.Generator().manual_seed(
        17)).to(t["x"].device).bfloat16()
    heads, scale = 12, 32 ** -0.5
    calls = {"k2": lambda: fm.fused_mlp_block(*a),
             "k1": lambda: fa.fused_attention_block(*x, heads, scale),
             "k5": lambda: fa.fused_attention_block_bwd(g, *x[:6], heads,
                                                        scale)}
    ops = {"t6 flat": (mv.mlp3d, dict(flat=True)),
           "t6 loop": (mv.mlp3d, dict(flat=False)),
           "t7": (mv.mlp3d_staged, {})}
    if hasattr(mv, "mlp3d_wmma"):
        ops.update({"t6_wmma flat": (mv.mlp3d_wmma, dict(flat=True)),
                    "t6_wmma loop": (mv.mlp3d_wmma, dict(flat=False)),
                    "t7_wmma": (mv.mlp3d_staged_wmma, {})})
    for name, (op, kw) in ops.items():
        for cb in (2, 4, 8):
            calls[f"{name} cb={cb}"] = (
                lambda op=op, kw=kw, cb=cb: op(*a, cb=cb, **kw))
    if hasattr(mv, "mlp_pipe_mma"):
        for sp, tm in ((2, 128), (1, 128), (1, 64)):
            calls[f"t3 s={sp} tm={tm}"] = (
                lambda sp=sp, tm=tm: mv.mlp_pipe(*a, splits=sp, tm=tm))
    calls["t3_former"] = lambda: getattr(mv, "mlp_pipe_mma", mv.mlp_pipe)(*a)
    staged = {"t4_wmma": getattr(av, "attn_staged_wmma", av.attn_staged)}
    if hasattr(av, "attn_staged_wmma"):
        staged["t4"] = av.attn_staged
    for name, op in staged.items():
        for cb in (2, 4):
            calls[f"{name} cb={cb}"] = (
                lambda op=op, cb=cb: op(*x, heads, scale, cb=cb))
    pairs = {"t1_wmma": getattr(av, "attn_pairs_wmma", av.attn_pairs)}
    if hasattr(av, "attn_pairs_wmma"):
        pairs["t1"] = av.attn_pairs
    for name, op in pairs.items():
        for cb in (4, 8):
            calls[f"{name} cb={cb}"] = (
                lambda op=op, cb=cb: op(*x, heads, scale, cb=cb))
    attn = {"t2": av.attn_rolling}
    bwd = {"t5": av.staged_bwd}
    if hasattr(av, "attn_rolling_wmma"):
        attn["t2_wmma"] = av.attn_rolling_wmma
    if hasattr(av, "staged_bwd_former"):
        bwd["t5_former"] = av.staged_bwd_former
    for name, op in attn.items():
        for cb in (4, 8, 16):
            calls[f"{name} cb={cb}"] = (
                lambda op=op, cb=cb: op(*x, heads, scale, cb=cb))
    for name, op in bwd.items():
        for cb in (2, 4):
            calls[f"{name} cb={cb}"] = (
                lambda op=op, cb=cb: op(g, *x[:6], heads, scale, cb=cb))
    return calls


def variant_times(dev, B: int = 256, iters: int = 20) -> dict:
    """Every call of ``variant_calls`` at vit_small batch B
    (``chip_smoke.block_inputs``, seed 16), each first held equal to its
    base kernel on those inputs (K2; T2, T4, T1: K1; T5: K5, every output), then
    timed twice with CUDA events in turns (the calls in order, then in
    reverse): name -> [ms, ms]."""
    import torch

    import chip_smoke
    t = chip_smoke.block_inputs(torch.Generator().manual_seed(16), B, 384,
                                dev)
    calls = variant_calls(t)
    out = {name: [] for name in calls}
    with torch.inference_mode():
        base = {k: chip_smoke.as_tuple(calls[k]()) for k in ("k1", "k2",
                                                              "k5")}
        for name, call in calls.items():
            want = base[{"t2": "k1", "t4": "k1", "t1": "k1", "t5": "k5",
                         "k1": "k1", "k5": "k5"}.get(name[:2], "k2")]
            if not all(torch.equal(u, v) for u, v in zip(
                    chip_smoke.as_tuple(call()), want)):
                raise AssertionError(f"{name} differs from its base kernel "
                                     f"at B={B}")
        for name in (*calls, *reversed(calls)):
            out[name].append(chip_smoke.cuda_ms(calls[name], iters))
    print(f"T6, T7, T3, T2, T4, T1, T5, K1, K2 and K5 at vit_small B={B}: "
          + ", ".join(f"{k} {'/'.join(f'{v:.4f}' for v in ms)} ms"
                      for k, ms in out.items()))
    return out


def overlap_probe(dev, B: int = 256, iters: int = 20) -> dict:
    """Whether T7's in-flight fc1 hides the GELU, on the same tiles: at
    each width D of 128-512 (hidden 4D, ``chip_smoke.block_inputs``, seed
    16), T6 per image (cb=4) on K2's ring, T6 per image on T7's ring depth
    (``mlp_variants._plan``, one stage fewer where the second hidden
    buffer costs one) and T7, each held equal to K2, then timed twice with
    CUDA events in turns: "<name> D=<D>" -> [ms, ms]. Empty in a checkout
    without T7 on K2's tail (no ``mlp_variants.row_walk``)."""
    import torch

    import chip_smoke
    from mfvit_tpu_torch.ops import fused_mlp as fm
    from mfvit_tpu_torch.ops import mlp_variants as mv
    if not hasattr(mv, "row_walk"):
        return {}
    calls = {}
    with torch.inference_mode():
        for D in (128, 256, 384, 512):
            t = chip_smoke.block_inputs(torch.Generator().manual_seed(16), B,
                                        D, dev)
            a = [t[k] for k in ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")]
            walk = mv.row_walk(B, 197, 4, False)
            rings = (fm._plan(D, 4 * D).stages, mv._plan(D, 4 * D).stages)
            named = {f"t6 loop D={D} ({rings[0]} stages)":
                     lambda a=a: mv.mlp3d(*a, cb=4, flat=False),
                     f"t6 loop D={D} ({rings[1]} stages)":
                     lambda a=a, w=walk, s=rings[1]: mv._runs(
                         "mfv_mlp3d", *a, w, s),
                     f"t7 D={D} ({rings[1]} stages)":
                     lambda a=a: mv.mlp3d_staged(*a, cb=4)}
            k2 = fm.fused_mlp_block(*a)
            for name, call in named.items():
                if not torch.equal(call(), k2):
                    raise AssertionError(f"{name} differs from K2")
            calls.update(named)
        out = {name: [] for name in calls}
        for name in (*calls, *reversed(calls)):
            out[name].append(chip_smoke.cuda_ms(calls[name], iters))
    print(f"T6 per image against T7 at B={B}: " + ", ".join(
        f"{k} {'/'.join(f'{v:.4f}' for v in ms)} ms" for k, ms in out.items()))
    return out


def pipe_probe(dev, B: int = 256, iters: int = 20) -> dict:
    """Whether T3's 128-row tile pays where the registers do not bind: at
    each width D of 128, 256 and 384 (hidden 4D, ``chip_smoke.block_inputs``,
    seed 16) K2 against T3 at tm=128 in ping-pong (s=2) and in lockstep
    (s=1), each held equal to K2, then timed twice with CUDA events in
    turns: "<name> D=<D>" -> [ms, ms]. Empty in a checkout without T3 on
    K2's tail (no ``mlp_variants.pipe_plan``)."""
    import torch

    import chip_smoke
    from mfvit_tpu_torch.ops import fused_mlp as fm
    from mfvit_tpu_torch.ops import mlp_variants as mv
    if not hasattr(mv, "pipe_plan"):
        return {}
    calls = {}
    with torch.inference_mode():
        for D in (128, 256, 384):
            t = chip_smoke.block_inputs(torch.Generator().manual_seed(16), B,
                                        D, dev)
            a = [t[k] for k in ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")]
            named = {f"k2 D={D}": lambda a=a: fm.fused_mlp_block(*a),
                     f"t3 s=2 tm=128 D={D}":
                     lambda a=a: mv.mlp_pipe(*a, splits=2, tm=128),
                     f"t3 s=1 tm=128 D={D}":
                     lambda a=a: mv.mlp_pipe(*a, splits=1, tm=128)}
            k2 = fm.fused_mlp_block(*a)
            for name, call in named.items():
                if not torch.equal(call(), k2):
                    raise AssertionError(f"{name} differs from K2")
            calls.update(named)
        out = {name: [] for name in calls}
        for name in (*calls, *reversed(calls)):
            out[name].append(chip_smoke.cuda_ms(calls[name], iters))
    print(f"T3 at tm=128 against K2 at B={B}: " + ", ".join(
        f"{k} {'/'.join(f'{v:.4f}' for v in ms)} ms" for k, ms in out.items()))
    return out


def output_digests(dev, B: int = 256) -> dict:
    """A SHA-256 of the output bits of K1, K2, K3, K5, K10, K15 and of T6,
    T7, T3, T2, T4, T1 and T5 at every argument of ``variant_calls``, on the inputs of
    ``half_times`` (vit_small B, seed 16), and of K9 at vit_small@384
    (577 tokens, B=16, seed 16): name -> hex digest. Two checkouts whose
    kernels compute the same function bit for bit give the same digest."""
    import hashlib

    import torch

    import chip_smoke
    from mfvit_tpu_torch.ops import fused_attn as fa
    from mfvit_tpu_torch.ops import fused_block as fb
    from mfvit_tpu_torch.ops import fused_int8 as fi8
    from mfvit_tpu_torch.ops import fused_mlp as fm
    t = chip_smoke.block_inputs(torch.Generator().manual_seed(16), B, 384,
                                dev)
    a = [t[k] for k in chip_smoke.K15_KEYS]
    i8 = chip_smoke.i8_args(t, 12)["fused_attention_block_i8"]
    long = chip_smoke.block_inputs(torch.Generator().manual_seed(16), 16,
                                   384, dev, N=577)
    la = [long[k] for k in chip_smoke.K15_KEYS[:7]]
    calls = {"k3": lambda: fm.fused_mlp_block_final_ln(a[0], *a[7:],
                                                       t["fs"], t["fb"]),
             "k15": lambda: fb.fused_transformer_block(*a, 12, 32 ** -0.5),
             "k10": lambda: fi8.fused_attention_block_i8(a[0], *i8),
             "k9": lambda: fa.fused_attention_block_large(*la, 12,
                                                          32 ** -0.5),
             **variant_calls(t)}

    def bits(v) -> bytes:
        return b"".join(u.contiguous().flatten().view(torch.uint8).cpu()
                        .numpy().tobytes() for u in chip_smoke.as_tuple(v))
    with torch.inference_mode():
        return {name: hashlib.sha256(bits(call())).hexdigest()
                for name, call in calls.items()}


def e2e_ori384(dev) -> dict:
    """The serving pairs/s of ``chip_smoke.time_e2e`` at 384 px, B=64, on
    vit_small_ori (6 heads of 64: its int8 attention half is K10 past 256
    tokens, where vit_small's is K9 on the dequantized weights): the same
    call with ``get_config`` giving vit_small_ori for vit_small, so that it
    runs in a checkout whose ``time_e2e`` takes no model name."""
    from mfvit_tpu_torch.nn import vit

    import chip_smoke
    get = vit.get_config
    vit.get_config = lambda name, img=224: get(
        "vit_small_ori" if name == "vit_small" else name, img)
    try:
        return chip_smoke.time_e2e(dev, B=64, img=384)
    finally:
        vit.get_config = get


HEAD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
from mfvit_tpu_torch.ops import build
from mfvit_tpu_torch.ops import mlp_variants
from mfvit_tpu_torch.tools import bench_block
build.lib()
dev = torch.device("cuda")
%s
%s
from mfvit_tpu_torch.ops import attn_variants
T_OPS = ("t6", "t7", "t2", "t5", "t3_former", "t4_wmma", "t1_wmma")
if hasattr(attn_variants, "attn_pairs_wmma"):
    T_OPS += ("t1",)
if hasattr(mlp_variants, "mlp_pipe_mma"):
    T_OPS += ("t3", "t4")
if hasattr(mlp_variants, "mlp3d_wmma"):
    T_OPS += ("t6_wmma", "t7_wmma")
if hasattr(attn_variants, "staged_bwd_former"):
    T_OPS += ("t2_wmma", "t5_former")
""" % (inspect.getsource(stage_times), inspect.getsource(half_times)
       + "\nLONG_SHAPES = %r\n" % (LONG_SHAPES,)
       + inspect.getsource(long_times) + inspect.getsource(e2e_ori384)
       + inspect.getsource(variant_calls) + inspect.getsource(variant_times)
       + inspect.getsource(overlap_probe) + inspect.getsource(pipe_probe)
       + inspect.getsource(output_digests))

# --only variants: K15, K1-K4 alone, T1-T7 with their breakdowns
CHILD_VARIANTS = HEAD + """
out = {"block": chip_smoke.time_block(dev), "halves": half_times(dev),
       "variants": variant_times(dev), "overlap": overlap_probe(dev),
       "pipe": pipe_probe(dev), "digests": output_digests(dev),
       "stages": {op: stage_times(dev, op)
                  for op in ("k1", "k2", "k5") + T_OPS}}
print("RESULT " + json.dumps(out))
"""

CHILD = HEAD + """
out = {"block": chip_smoke.time_block(dev), "halves": half_times(dev),
       "variants": variant_times(dev), "overlap": overlap_probe(dev),
       "pipe": pipe_probe(dev), "digests": output_digests(dev),
       "stages": {op: stage_times(dev, op)
                  for op in ("k15", "k1", "k2", "k3", "k4", "k5", "k7")
                  + T_OPS},
       "stages_base": {op: stage_times(dev, op, B=64, D=768)
                       for op in ("k5", "k7")},
       "stages_long": {f"{op} {label} B={B}": stage_times(
           dev, op, B=B, N=N, D=D, heads=h)
           for op, label, B, N, D, h in LONG_SHAPES},
       "long": long_times(dev),
       "bwd": {"vit_small B=256": chip_smoke.time_bwd(dev, "vit_small", 256,
                                                      384),
               "vit_base B=64": chip_smoke.time_bwd(dev, "vit_base", 64,
                                                    768)},
       "bench_block": {k: v[0] for k, v in bench_block.run(dev).items()}}
if hasattr(chip_smoke, "time_gemm"):
    out["gemm"] = chip_smoke.time_gemm(dev)
fusion = chip_smoke.time_fusion(dev, 256, 3)
out["e2e"] = {"serving_pairs_per_sec_B256": chip_smoke.time_e2e(dev),
              "serving_pairs_per_sec_384_B64": chip_smoke.time_e2e(
                  dev, B=64, img=384),
              "serving_pairs_per_sec_ori384_B64": e2e_ori384(dev),
              "ft_images_per_sec_B256": chip_smoke.time_train(dev, 256, 4),
              "ft_images_per_sec_B16": chip_smoke.time_train(dev, 16, 32),
              "fusion_pairs_per_sec_B256": {
                  f"{mode} {k}": v for mode, rates in fusion.items()
                  for k, v in rates.items()}}
print("RESULT " + json.dumps(out))
"""


def _turns(label: str, ms: dict, fmt: str = ".4f") -> str:
    """'<label>: this a/b ms, other c/d ms' from by_checkout's lists (each
    reading a number or a list of numbers)."""
    def flat(v):
        return [x for r in v for x in (r if isinstance(r, list) else [r])]
    return (f"{label}: this " + "/".join(f"{v:{fmt}}" for v in flat(
        ms["this"])) + " ms, other " + "/".join(
        f"{v:{fmt}}" for v in flat(ms["other"])) + " ms")


def print_variants(runs: list) -> None:
    """T1-T7, K1, K2 and K5 of both checkouts, and whether the
    output bits of ``output_digests`` are the same in both (names both
    checkouts have)."""
    names = [n for n in runs[0][1]["variants"]
             if all(n in r["variants"] for _, r in runs)]
    for name in names:
        print(_turns(f"{name} at vit_small B=256",
                     turns.by_checkout(runs, lambda r: r["variants"][name])))
    only = {n for _, r in runs for n in r["variants"]} - set(names)
    for name in sorted(only):
        who = [w for w, r in runs if name in r["variants"]][0]
        ms = [v for w, r in runs if w == who for v in r["variants"][name]]
        print(f"{name} at vit_small B=256 ({who} only): " + "/".join(
            f"{v:.4f}" for v in ms) + " ms")
    for key in ("overlap", "pipe"):
        for name in runs[0][1][key] or runs[1][1][key]:
            ms = [v for _, r in runs for v in r[key].get(name, [])]
            print(f"{name} at vit_small widths, B=256 (turns of the "
                  "checkout that has it): " + "/".join(
                      f"{v:.4f}" for v in ms) + " ms")
    digests = turns.by_checkout(runs, lambda r: r["digests"])
    common = set(digests["this"][0]) & set(digests["other"][0])
    same = {n: len({d[n] for d in digests["this"] + digests["other"]}) == 1
            for n in sorted(common)}
    print("output bits the same in both checkouts: " + ", ".join(
        f"{n} {'yes' if v else 'NO'}" for n, v in same.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--only", choices=("variants",),
                    help="run only K15, K1-K4 alone, T1-T7 (and the "
                    "breakdowns of K1, K2, K5 and the variants)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    runs = turns.run(args.other, CHILD_VARIANTS if args.only else CHILD)
    full = not args.only
    if full:
        turns.print_e2e(runs)
    for i, what in enumerate(("K15", "plain", "library block", "K1 -> K2")):
        print(_turns(f"{what} at vit_small B=256",
                     turns.by_checkout(runs, lambda r: r["block"][i])))
    for name in ("k1", "k2", "k3", "k4"):
        print(_turns(f"{name.upper()} at vit_small B=256",
                     turns.by_checkout(runs, lambda r: r["halves"][name])))
    print_variants(runs)
    if full:
        for shape in runs[0][1]["bwd"]:
            for name in runs[0][1]["bwd"][shape]:
                print(_turns(f"{name} at {shape}", turns.by_checkout(
                    runs, lambda r: r["bwd"][shape][name][0])))
        for name in runs[0][1]["long"]:
            print(_turns(name, turns.by_checkout(
                runs, lambda r: r["long"][name])))
        for name in runs[0][1]["bench_block"]:
            print(_turns(f"bench_block {name}, 12 blocks at B=512",
                         turns.by_checkout(
                             runs, lambda r: r["bench_block"][name]), ".2f"))
    for who, r in runs:
        print(f"{who}: " + "; ".join(
            f"{op.upper()}'s stages " + ", ".join(
                f"{k} {v:.4f}" for k, v in st.items()) + " ms"
            for op, st in (*r["stages"].items(),
                           *((f"{op} vit_base B=64", st)
                             for op, st in r.get("stages_base", {}).items()),
                           *r.get("stages_long", {}).items()))
            + "".join(f"; GEMM {k} wgmma {v[0]:.4f} ms ({v[2]:.1f} TFLOP/s), "
                      f"gemm_ln {v[1]:.4f} ms ({v[3]:.1f} TFLOP/s)"
                      for k, v in r.get("gemm", {}).items()))
    turns.write(args.out, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
