"""Time the engine's own decode bursts: the port's counterpart of
``tools/profile_engine_burst.py``.

Builds the port's ``InferenceEngine`` as the JAX tool builds its own
(tinyllama-1.1b, bf16, batch 8, ``max_seq_len`` 1024, ``prefill_chunk``
128, ``decode_burst`` = ``--burst``, ``--kv contiguous|paged``), prefills
every slot with a 128-token prompt through ``_exec_prefill``, then times:

1. whole ``_decode_burst`` calls (host clock): under lag-one pipelining
   each call dispatches one burst and fetches the one before it, so its
   wall is one steady pipelined burst;
2. the same greedy burst the engine dispatches (on the card the replay of
   its decode graph, on the CPU the same body run eagerly), split into
   dispatch (up to the last launch) and the fetch of its tokens (to the
   sync) — the JAX tool's dispatch/fetch split;
3. chained bursts with one fetch at the end.

The paged engine keeps the default ``prefix_cache: true``, as the JAX
tool's does; the slots are filled through ``_exec_prefill``, outside the
scheduler, so the cache sees none of this traffic.

    python -m llmapigateway_tpu_torch.tools.profile_engine_burst
        [--attention auto] [--burst 32] [--kv contiguous|paged]
        [--preset tinyllama-1.1b] [--quant int8|int4] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config.schemas import LocalEngineConfig
from ..engine.engine import InferenceEngine, resolve_device
from . import note

PROMPT_TOKENS = 128


def build_engine(args, device) -> InferenceEngine:
    cfg = LocalEngineConfig(
        preset=args.preset, dtype="bfloat16", max_batch_size=8,
        max_seq_len=1024, prefill_chunk=PROMPT_TOKENS,
        decode_burst=args.burst, kv_layout=args.kv,
        attention=args.attention, quant=args.quant)
    return InferenceEngine(cfg, device=device)


def prefill_all(engine: InferenceEngine) -> None:
    """Every slot prefilled with the same seeded 128-token prompt, greedy,
    and marked active, as the JAX tool does."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, engine.model_cfg.vocab_size,
                          size=PROMPT_TOKENS).tolist()
    for slot in range(engine.B):
        if engine.paged:
            engine.allocator.allocate(slot, engine.S)
            engine._table_dirty = True
        first = engine._exec_prefill([slot], [0], [prompt],
                                     [(0.0, 1.0, 0, 0.0, 0.0)])
        engine.lengths[slot] = len(prompt)
        engine.active[slot] = True
        engine.last_token[slot] = 1
        first.cpu()
    engine._d_dirty = True


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m llmapigateway_tpu_torch.tools.profile_engine_burst",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--attention", default="auto", choices=("auto",),
                    help="the engine always runs its attention kernels on "
                         "the card (plain versions on the CPU)")
    ap.add_argument("--burst", type=int, default=32)
    ap.add_argument("--kv", default="contiguous",
                    choices=("contiguous", "paged"))
    ap.add_argument("--preset", default="tinyllama-1.1b",
                    help="the JAX tool's model; a tiny preset for CPU runs")
    ap.add_argument("--quant", default="", choices=("", "int8", "int4"),
                    help="weight quantization (models/quant.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card fails")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    burst = args.burst
    res = {"device": str(device), "preset": args.preset, "kv": args.kv,
           "quant": args.quant or "bf16", "burst": burst}

    t0 = time.monotonic()
    engine = build_engine(args, device)
    _sync(device)
    res["engine_init_s"] = time.monotonic() - t0
    note(f"engine init: {res['engine_init_s']:.1f}s")
    with torch.no_grad():
        prefill_all(engine)
        note("prefill done")

        t0 = time.monotonic()
        engine._decode_burst(burst)
        note(f"burst warm: {time.monotonic() - t0:.1f}s")

        res["decode_burst_ms"] = []
        for i in range(3):
            t0 = time.monotonic()
            engine._decode_burst(burst)
            dt = time.monotonic() - t0
            res["decode_burst_ms"].append(1e3 * dt)
            note(f"_decode_burst({burst}) #{i}: {1e3 * dt:.1f} ms "
                 f"({1e3 * dt / burst:.2f} ms/step)")

        # The burst in flight lands first; then the same greedy burst the
        # engine dispatches (``_dispatch``: the graph's replay on the card,
        # the eager body on the CPU; no host mirror, no lag-one fetch):
        # dispatch (to the last launch) vs the fetch (to the sync).
        engine._flush_pending()
        res["raw"] = []
        for i in range(3):
            _sync(device)
            t0 = time.monotonic()
            toks = engine._dispatch(burst, True)
            t1 = time.monotonic()
            toks.cpu()
            t2 = time.monotonic()
            res["raw"].append({"enqueue_ms": 1e3 * (t1 - t0),
                               "fetch_ms": 1e3 * (t2 - t1)})
            note(f"raw burst #{i}: dispatch {1e3 * (t1 - t0):.1f} ms, fetch "
                 f"{1e3 * (t2 - t1):.1f} ms, total "
                 f"{1e3 * (t2 - t0) / burst:.2f} ms/step")

        n = 4
        _sync(device)
        t0 = time.monotonic()
        for _ in range(n):
            toks = engine._dispatch(burst, True)
        toks.cpu()
        dt = time.monotonic() - t0
        res["chained_ms_per_step"] = 1e3 * dt / (n * burst)
        note(f"{n} chained bursts + 1 fetch: {1e3 * dt:.1f} ms "
             f"({res['chained_ms_per_step']:.2f} ms/step)")
    res["decode_burst_ms_per_step"] = min(res["decode_burst_ms"]) / burst
    res["decode_steps"] = engine.decode_steps
    res["raw_steps"] = (3 + n) * burst
    print(json.dumps(res), flush=True)
    del engine
    return res


if __name__ == "__main__":
    main()
