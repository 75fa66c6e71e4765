"""Device time of one call on the card, the timer of ``chip_smoke.py`` and
``profile_split``: a CUDA event pair around the call, the median of
``iters`` runs after ``warmup`` calls, L2 flushed (a 128 MB write) before
each run when ``cold``, as the main path finds each layer's cache cold. A
device-side spin (``torch.cuda._sleep``, about 2 ms at the H100's 1.98 GHz
boost clock, longer than any wrapper's host enqueue) keeps the card busy
while the host enqueues the start event and the call, so the pair brackets
the device work; the host's own time for the call (Python, argument checks,
enqueue) is measured beside it on the host's clock, as the least over the
runs: the host is shared, and contention only adds to a run's time.

This file imports nothing of the package, so a run that times several
checkouts with one timer can load it by path.
"""
from __future__ import annotations

import statistics
import time

import torch

SPIN_CYCLES = 4_000_000


def device_times(fn, iters: int = 25, warmup: int = 3,
                 cold: bool = True) -> tuple[float, float]:
    """Median device ms of ``fn`` and least host ms of one call of it."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    device, host = [], []
    for _ in range(iters):
        if cold:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    return statistics.median(device), min(host)
