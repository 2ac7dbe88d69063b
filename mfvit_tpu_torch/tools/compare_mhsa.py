"""Time K12-K14 of two checkouts of the repository on one card, in turns,
and the end-to-end figures beside them:

    python -m mfvit_tpu_torch.tools.compare_mhsa --other DIR [--out FILE]

DIR holds another checkout (for example a ``git archive`` of the parent
commit unpacked into a directory that ``.gitignore`` lists). Each turn is a
process of its own, started in one checkout, that builds that checkout's
kernels and runs its own ``chip_smoke`` timers: ``time_mhsa`` (kernel,
plain, plain, kernel, then SDPA on the same values) at vit_small B=256
(N=197) and at vit_small@384 B=64 (N=577), then the serving pairs/s at
B=256 (bf16, int8 and the XLA-level W8A8 path, which runs K12,
``time_e2e``), the FT step's images/s at B=256 (``time_train``) and the
fusion step's pairs/s at B=256 (``time_fusion``). The turns go other,
this, this, other (``tools/turns.py``). Prints one line a reading, and
writes every reading to FILE as JSON. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from mfvit_tpu_torch.tools import turns

SHAPES = (("vit_small", 256, 197, 384, 12), ("vit_small@384", 64, 577, 384, 12))
CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
from mfvit_tpu_torch.ops import build
build.lib()
dev = torch.device("cuda")
out = {label: chip_smoke.time_mhsa(dev, label, B, N, D, heads)
       for label, B, N, D, heads in %r}
fusion = chip_smoke.time_fusion(dev, 256, 3)
out["e2e"] = {"serving_pairs_per_sec_B256": chip_smoke.time_e2e(dev),
              "ft_images_per_sec_B256": chip_smoke.time_train(dev, 256, 4),
              "fusion_pairs_per_sec_B256": {
                  f"{mode} {k}": v for mode, rates in fusion.items()
                  for k, v in rates.items()}}
print("RESULT " + json.dumps(out))
""" % (SHAPES,)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    runs = turns.run(args.other, CHILD)
    turns.print_e2e(runs)
    for label, B, N, *_ in SHAPES:
        for name in runs[0][1][label]:
            ms = turns.by_checkout(runs, lambda r: r[label][name][0])
            sdpa = [r[label][name][2] for _, r in runs]
            print(f"{name} at {label} B={B} (N={N}): this "
                  + "/".join(f"{v:.4f}" for v in ms["this"]) + " ms, other "
                  + "/".join(f"{v:.4f}" for v in ms["other"]) + " ms, SDPA "
                  + "/".join(f"{v:.4f}" for v in sdpa) + " ms")
    turns.write(args.out, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
