"""Time the engine's own decode bursts: the port's counterpart of
``tools/profile_engine_burst.py``.

Builds the port's ``InferenceEngine`` as the JAX tool builds its own
(tinyllama-1.1b, bf16, batch 8, ``max_seq_len`` 1024, ``prefill_chunk``
128, ``decode_burst`` = ``--burst``, ``--kv contiguous|paged``), prefills
every slot with a 128-token prompt through ``_exec_prefill``, then times:

1. whole ``_decode_burst`` calls (host clock, tokens fetched);
2. the same greedy steps run through the engine's ``_forward``, split into
   host enqueue (up to the last launch) and the final fetch (to the sync)
   — the counterpart of the JAX tool's dispatch/fetch split;
3. chained bursts with one fetch at the end.

The paged engine is built with ``prefix_cache: false``: the port refuses
the default ``true`` on the paged layout for a full-attention model until
the prefix cache is ported (ROADMAP.md, port queue: prefix cache), where
the JAX tool builds with it on. Its bursts never share a prefix, so the
cache would not change what is timed.

    python -m llmapigateway_tpu_torch.tools.profile_engine_burst
        [--attention auto] [--burst 32] [--kv contiguous|paged]
        [--preset tinyllama-1.1b] [--device cuda]
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
        attention=args.attention,
        **({"prefix_cache": False} if args.kv == "paged" else {}))
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


def raw_burst(engine: InferenceEngine, n_steps: int, attn):
    """``n_steps`` greedy steps through the engine's ``_forward`` on its
    device state (the body of ``_decode_burst`` for all-greedy slots,
    without the host mirror). Returns the stacked device tokens [n, B]."""
    tokens, lengths = engine._d_tokens, engine._d_lengths
    active = engine._d_active
    out = []
    for _ in range(n_steps):
        logits, engine.cache = engine._forward(
            engine.params, engine.model_cfg, tokens[:, None], lengths,
            engine.cache, attention_fn=attn, active=active)
        tokens = torch.argmax(logits[:, 0, :], dim=-1)
        lengths = torch.where(active, lengths + 1, lengths)
        out.append(tokens)
    engine._d_tokens, engine._d_lengths = tokens, lengths
    return torch.stack(out)


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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card fails")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    burst = args.burst
    res = {"device": str(device), "preset": args.preset, "kv": args.kv,
           "burst": burst}

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

        # The same greedy steps on the engine's own forward: host enqueue
        # (to the last launch) vs the fetch (to the sync).
        window = engine.model_cfg.sliding_window
        if engine.paged:
            from ..ops.paged_attention import make_paged_attention_fn
            attn = make_paged_attention_fn(engine._device_table(), window,
                                           engine.kv_ppb)
        else:
            from ..ops.flash_attention import make_cache_attention_fn
            attn = make_cache_attention_fn(window=window)
        res["raw"] = []
        for i in range(3):
            _sync(device)
            t0 = time.monotonic()
            toks = raw_burst(engine, burst, attn)
            t1 = time.monotonic()
            toks.cpu()
            t2 = time.monotonic()
            res["raw"].append({"enqueue_ms": 1e3 * (t1 - t0),
                               "fetch_ms": 1e3 * (t2 - t1)})
            note(f"raw burst #{i}: enqueue {1e3 * (t1 - t0):.1f} ms, fetch "
                 f"{1e3 * (t2 - t1):.1f} ms, total "
                 f"{1e3 * (t2 - t0) / burst:.2f} ms/step")

        n = 4
        _sync(device)
        t0 = time.monotonic()
        for _ in range(n):
            toks = raw_burst(engine, burst, attn)
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
