"""The turn runner of the compare tools (``compare_mhsa``,
``compare_block``): the same measurements in two checkouts of the
repository on one card, in turns other, this, this, other, so that a drift
of the card over the call shows as a difference between the two turns of
one checkout.

Each turn is a process of its own, started in one checkout with that
checkout first on ``sys.path``: it builds that checkout's kernels, runs the
child code it is given and prints one line ``RESULT <json>``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ORDER = ("other", "this", "this", "other")


def turn(checkout: Path, child: str) -> dict:
    """The JSON that ``child`` prints after ``RESULT `` in one process in
    ``checkout``; its other output goes to this process's."""
    env = dict(os.environ, PYTHONPATH=str(checkout))
    res = subprocess.run([sys.executable, "-c", child], cwd=checkout, env=env,
                         capture_output=True, text=True)
    sys.stdout.write(res.stdout)
    if res.returncode:
        sys.stderr.write(res.stderr)
        raise RuntimeError(f"the turn in {checkout} failed ({res.returncode})")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def run(other: Path, child: str) -> list:
    """[(who, result)] for the turns other, this, this, other."""
    paths = {"other": other.resolve(), "this": ROOT}
    return [(who, turn(paths[who], child)) for who in ORDER]


def by_checkout(runs: list, get) -> dict:
    """who -> [get(result) of each of its turns], in turn order."""
    return {who: [get(r) for w, r in runs if w == who]
            for who in ("this", "other")}


def print_e2e(runs: list) -> None:
    """One line a end-to-end figure of the results' "e2e" entry: this
    checkout's turns, then the other's."""
    for what, figures in runs[0][1]["e2e"].items():
        for key in figures:
            rate = by_checkout(runs, lambda r: r["e2e"][what][key])
            print(f"{what} {key}: this " + "/".join(
                f"{v:.1f}" for v in rate["this"]) + ", other " + "/".join(
                f"{v:.1f}" for v in rate["other"]))


def write(path, runs: list) -> None:
    """Every reading, as JSON, to ``path`` (if given)."""
    if path:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"order": [w for w, _ in runs],
                                    "runs": [r for _, r in runs]}))
