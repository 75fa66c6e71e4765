"""Tools that drive the port's engine and kernels. Three are the
counterparts of the JAX package's scripts of the same name in ``tools/``
(which is left as it is):

* ``profile_insert`` — KV-insert strategies of the decode step, and kernel
  #5 (``csrc/kv_insert.cu``, the port of ``insert_pallas``) with its wrapper.
* ``profile_decode`` — the decode step with parts ablated, the weight
  stream and the sort alone.
* ``profile_engine_burst`` — the engine's own decode bursts, host enqueue
  split from the final fetch.

One more, ``profile_split``, sweeps the decode kernels' key split at one
head geometry, on the card only and without a JAX counterpart; it and
``chip_smoke.py`` share one device timer (``_timing``).

Each of the first three runs as ``python -m
llmapigateway_tpu_torch.tools.<name>`` on the card (``--device cuda``, the
default) or on the CPU (``--device cpu``, at a tiny preset or small dims),
prints its per-variant times to stderr and one JSON
object of results as its last line of standard output, and returns the
results from ``main(argv)``. Times on the card are CUDA-event times around
whole bursts, best of ``--reps`` after a warm-up call; on the CPU they are
host-clock times and say nothing of the card.
"""
from __future__ import annotations

import sys
import time

import torch


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def elapsed_ms(fn, device: torch.device):
    """(ms, result) of one call of ``fn``: CUDA events around it on the
    card (the device's timeline, synchronized), the host clock on the
    CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def best_ms(fn, device: torch.device, reps: int):
    """(best ms over ``reps`` calls, warm-up ms, last result) of ``fn``,
    after one warm-up call."""
    warm, out = elapsed_ms(fn, device)
    best = float("inf")
    for _ in range(reps):
        ms, out = elapsed_ms(fn, device)
        best = min(best, ms)
    return best, warm, out
