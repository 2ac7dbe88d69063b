"""What every timing tool of the port shares: the card's line, and the two
ways the tools time.

``describe(device)`` prints the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, on a line of its own, where ``device`` is a CUDA device, and returns
it; on the CPU it prints nothing and returns None. A card may run below
its 700 W, and slower under load, so a tool prints this before any time.

``lag_seconds`` is ``bench.py``'s method: launch iteration i + 1, then
read iteration i's output on the host, and divide the host clock's
seconds by the iterations. ``event_ms`` times back-to-back calls on one
stream between CUDA events, for pieces too short for the host clock; on
the CPU it falls back to the host clock. ``CPU_NOTE`` is what a tool
prints when it runs on the CPU: the plain versions, timed on the host,
which measures no device.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional

import torch

CPU_NOTE = ("--device cpu: the plain versions, timed with the host clock "
            "(a smoke test, not a measurement of any device)")


def describe(device) -> Optional[str]:
    """The card's ``name, power.limit`` line, printed; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(out[0], flush=True)
    return out[0]


def note(device) -> None:
    """The card's line on CUDA, ``CPU_NOTE`` on the CPU."""
    if describe(device) is None:
        print(CPU_NOTE, flush=True)


def fetch(t: torch.Tensor) -> None:
    """Read ``t`` on the host (waits for what computed it)."""
    t.detach().reshape(-1)[:1].cpu()


def lag_seconds(call: Callable[[], torch.Tensor], iters: int,
                warmup: int) -> float:
    """Seconds per call: ``warmup`` calls each fetched, then ``iters``
    calls with the output of call i fetched after call i + 1 is launched
    (``bench.py``'s one-iteration lag), over the host clock."""
    for _ in range(warmup):
        fetch(call())
    t0 = time.perf_counter()
    pending = None
    for _ in range(iters):
        out = call()
        if pending is not None:
            fetch(pending)
        pending = out
    fetch(pending)
    return (time.perf_counter() - t0) / iters


def event_ms(fn: Callable[[], object], reps: int, device) -> float:
    """ms per call of ``fn``, ``reps`` calls back to back after one
    warm-up: between CUDA events on the current stream, or the host clock
    on the CPU."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
