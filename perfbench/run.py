"""The benchmark's command: one run of one cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (import, loading the kernel library, weights, inputs, warm-up) is
counted from the process's start. The kernel library and every other
cache live in fixed directories of the checkout, so only the first run in
a checkout builds.
"""
from __future__ import annotations

import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _since_process_start() -> float:
    """Seconds from the process's start to now, from /proc (0 where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def _caches() -> None:
    """Every cache a library of the run could write, inside the
    checkout at a fixed path."""
    base = os.path.join(ROOT, "build", "perfbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = STARTED - _since_process_start()
    _caches()
    import torch
    torch.set_num_threads(2)
    from perfbench import harness
    return harness.main(args, started)


if __name__ == "__main__":
    sys.exit(main())
