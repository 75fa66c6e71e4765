"""The compiled decode step: one CUDA graph per (burst depth, greedy), and
the pinned-memory transfers around it (counterpart of the JAX engine's
``_decode_programs`` and ``_start_host_copy``).

* **Static buffers.** Every graph of an engine reads the same device
  buffers (tokens, lengths, active, the five sampling vectors, the penalty
  counts and the page table) and writes its own ``[n, B]`` token block; its
  last captured ops write the burst's final tokens and lengths back into
  the input buffers, so burst N+1 chains on the device with no host step.
  The engine uploads into those buffers in place (:func:`upload`).
* **Capture.** :class:`DecodeGraphs` warms a variant up eagerly (first
  launches, the kernels' build) on the current stream, whose cuBLAS
  workspace already exists (each new side stream would hold a workspace of
  its own for the life of the process), then captures it; all graphs
  share one memory pool, and are replayed one at a time on one stream. A
  sampled graph registers the engine's generator, so each replay draws
  from the generator's next Philox offset. A capture or a replay that
  fails raises: nothing falls back to eager launches.
* **Launch counters.** The kernel wrappers count launches on the host
  (``launches``, ``body_launches``, ``body_splits``), so they see a capture
  and not its replays. :class:`DecodeGraphs` records the counts one capture
  added (:func:`launch_counts`, :func:`counts_delta`), takes the warm-up's
  and the capture's own counts back out, and adds the capture's counts on
  every replay (:func:`add_counts`): the counters then read as if every
  replay had launched its kernels.
* **The lag-one fetch.** :class:`LagOneFetch` copies a dispatched burst's
  token block into one of two pinned host buffers behind an event; the
  flush waits on that event only. Two buffers alternate, because burst N+1
  is dispatched before burst N is read.

Nothing here touches CUDA at import time, and on the CPU the engine runs
the same decode body eagerly, with no graph.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.flash_attention import (flash_decode_attention,
                                   flash_prefill_attention)
from ..ops.paged_attention import (paged_decode_attention,
                                   paged_prefill_attention)
from ..ops.quant_mm import int8_mm, w4a8_mm

# The kernel (and library product) wrappers whose launch counters a replay
# must advance: the attention kernels and the quantized projections.
COUNTED = (paged_decode_attention, paged_prefill_attention,
           flash_decode_attention, flash_prefill_attention, int8_mm, w4a8_mm)


def launch_counts(fns=COUNTED) -> dict:
    """A copy of each wrapper's counters: ``{name: (launches,
    body_launches, body_splits)}``."""
    return {fn.__name__: (fn.launches, dict(fn.body_launches),
                          dict(fn.body_splits)) for fn in fns}


def counts_delta(before: dict, after: dict) -> dict:
    """What happened between two :func:`launch_counts`: per wrapper, the
    launches added, the launches added per body, and the split records of
    the bodies that launched (a record is the last launch's, not a sum)."""
    out = {}
    for name, (n1, bodies1, splits1) in after.items():
        n0, bodies0, _ = before[name]
        added = {b: k - bodies0.get(b, 0) for b, k in bodies1.items()
                 if k != bodies0.get(b, 0)}
        out[name] = (n1 - n0, added,
                     {b: s for b, s in splits1.items() if b in added})
    return out


def add_counts(delta: dict, fns=COUNTED) -> None:
    """Advance each wrapper's counters by ``delta`` (:func:`counts_delta`)."""
    for fn in fns:
        n, bodies, splits = delta[fn.__name__]
        fn.launches += n
        for body, k in bodies.items():
            fn.body_launches[body] = fn.body_launches.get(body, 0) + k
        fn.body_splits.update(splits)


def restore_counts(snapshot: dict, fns=COUNTED) -> None:
    """Set each wrapper's counters back to ``snapshot``
    (:func:`launch_counts`)."""
    for fn in fns:
        n, bodies, splits = snapshot[fn.__name__]
        fn.launches, fn.body_launches, fn.body_splits = (
            n, dict(bodies), dict(splits))


def upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Host array into the device buffer ``dst``, in place, on the current
    stream, so it lands after any burst already dispatched there. On the
    card the array goes through pinned staging memory from PyTorch's caching
    host allocator, which records the copy's event and does not hand that
    memory out again before the copy has run."""
    host = torch.from_numpy(np.ascontiguousarray(src))
    if dst.device.type == "cuda":
        dst.copy_(host.pin_memory(), non_blocking=True)
    else:
        dst.copy_(host)


class CudaGraph:
    """One ``torch.cuda.CUDAGraph``: :meth:`capture` records what ``fn``
    launches and returns its output, :meth:`replay` launches it again."""

    def __init__(self, pool=None, generator: torch.Generator | None = None):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            # Each replay then advances the generator's Philox offset.
            self.graph.register_generator_state(generator)
        self.pool = pool

    def capture(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        with torch.cuda.graph(self.graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = fn()
        self.pool = self.graph.pool()
        return out

    def replay(self) -> None:
        self.graph.replay()


class DecodeGraphs:
    """The decode graphs of one engine, one per (depth, greedy).

    ``generator`` is the engine's sampling generator; ``graph_cls`` makes a
    graph (the :class:`CudaGraph` interface; the CPU tests pass a stub).
    Nothing here refers back to the engine (the body is an argument of
    :meth:`capture`), so an engine is freed when its last reference goes,
    with no reference cycle waiting for the garbage collector."""

    def __init__(self, generator: torch.Generator | None = None,
                 graph_cls=CudaGraph, counted=COUNTED):
        self.generator = generator
        self.graph_cls = graph_cls
        self.counted = counted
        self.pool = None
        # (depth, greedy) -> (graph, token block, launch counts of a replay)
        self.graphs: dict[tuple[int, bool], tuple] = {}
        self.replays = 0

    def __contains__(self, key: tuple[int, bool]) -> bool:
        return key in self.graphs

    def capture(self, body: Callable[[int, bool], torch.Tensor], n: int,
                greedy: bool, warm: bool = True) -> None:
        """Warm the (n, greedy) variant up (one eager burst), then capture
        it. ``body(n, greedy)`` runs ``n`` decode steps over the engine's
        static buffers and returns the ``[n, B]`` token block. The caller
        makes the warm-up harmless to its state; the counters end as they
        were."""
        snapshot = launch_counts(self.counted)
        if warm:
            body(n, greedy)
            torch.cuda.synchronize()
        before = launch_counts(self.counted)
        graph = self.graph_cls(self.pool, None if greedy else self.generator)
        out = graph.capture(lambda: body(n, greedy))
        self.pool = graph.pool
        delta = counts_delta(before, launch_counts(self.counted))
        restore_counts(snapshot, self.counted)
        self.graphs[(n, greedy)] = (graph, out, delta)

    def replay(self, n: int, greedy: bool) -> torch.Tensor:
        """Launch the captured burst; its token block (the same tensor on
        every replay of this variant). A variant that was not captured
        raises."""
        entry = self.graphs.get((n, greedy))
        if entry is None:
            raise RuntimeError(f"no decode graph captured for depth {n}, "
                               f"{'greedy' if greedy else 'sampled'}")
        graph, out, delta = entry
        graph.replay()
        add_counts(delta, self.counted)
        self.replays += 1
        return out


class LagOneFetch:
    """Device → host copies of dispatched token blocks that the host waits
    for only when it reads them. On the card: two pinned ``[rows, B]``
    buffers used in turn, each behind an event; on the CPU the block
    itself."""

    def __init__(self, rows: int, B: int, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.bufs = [torch.empty((rows, B), dtype=torch.int64,
                                     pin_memory=True) for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
        self.turn = 0

    def start(self, block: torch.Tensor):
        """Queue the copy of ``block [n, B]``; a handle for :meth:`wait`."""
        if not self.cuda:
            return block, None
        buf = self.bufs[self.turn][:block.shape[0]]
        event = self.events[self.turn]
        self.turn ^= 1
        buf.copy_(block, non_blocking=True)
        event.record()
        return buf, event

    @staticmethod
    def wait(handle) -> np.ndarray:
        """The block on the host (a copy: its buffer is reused two
        dispatches later)."""
        buf, event = handle
        if event is not None:
            event.synchronize()
        return buf.numpy().copy()
