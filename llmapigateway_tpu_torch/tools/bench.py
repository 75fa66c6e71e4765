"""Benchmark the port's engine: steady decode throughput, TTFT under load
and the prefix cache's cold against warm TTFT, the port's counterpart of
the repository's root ``bench.py`` (which stays as it is) for the rungs the
port serves.

Prints ONE JSON line as the last line of standard output:

  {"metric": ..., "value": N, "unit": "tok/s", "extra": {...}}

``value`` is the headline arm's decode tok/s: the ``--preset`` model
(tinyllama-1.1b), ``--batch`` slots filled with a ``--prompt-len`` prompt,
then ``--steps`` greedy decode steps timed through the engine's own burst
loop (``_decode_burst``), on the first of ``--layout`` and the first KV
type of ``--kv``. Every arm reports tok/s, ms per step, MFU, and the weight
+ live-KV bytes a step streams as GB/s and as a share of ``--peak-gbps``
(the H100's 3350 GB/s; ``--peak-tflops`` 989, its dense bf16 rate).
``extra`` records the card's name and power limit as ``nvidia-smi`` prints
them, beside every number.

Rungs, in order (each guarded: a failing rung records its error in
``extra["errors"]`` and the rest still report; once ``--max-seconds`` have
passed the optional rungs are skipped and named in
``extra["skipped_phases"]``):

1. the headline arms: ``--layout`` (contiguous, paged or both; the root
   bench's ``--kv`` picks layouts, here ``--layout`` does) × ``--kv`` (bf16,
   int8 or both), then p50/p95 TTFT of ``--ttft-probes`` distinct-prompt
   requests injected into the first arm's saturated batch;
2. ``--eight-b``: llama-3-8b at int8 weights with int8 KV (the root
   bench's north-star rung), contiguous with TTFT, then paged;
   ``--ttft-target MS``: that arm's engine (the headline preset's without
   ``--eight-b``) built with ``ttft_target_ms`` — every burst depth's
   decode graph captured at build — then decode tok/s through the real
   scheduler, TTFT p50/p95 under load and the burst-depth controller's
   ``burst_*`` stats (the root bench's adaptive-TTFT leg);
3. ``--shared-prefix``: cold against warm TTFT on requests that share a
   ``--shared-prefix-len``-token prefix, with the proof that prefill was
   skipped taken from the engine's counters (prefill calls per request,
   prefix hits, cached tokens), not from the wall clock;
4. ``--long-ctx``: bf16 against int8 KV at a 2048-token context;
5. ``--swa``: mistral-7b with its window against the same model without;
6. ``--second-preset``: a mid-size preset (llama-3b-class);
7. ``--quant-rung``: the headline preset's weights at int8 (bf16 KV), int8
   with int8 KV and int4 with int8 KV, contiguous, each with its weight bytes
   and ``speedup_vs_bf16`` over the contiguous bf16 arm, and int4's
   ``speedup_vs_int8`` (the root bench's quant rungs).

The root bench's other rungs are refused here by naming the port-queue item
that brings them (``--spec-*``, ``--disagg-ab``, ``--flight-ab``,
``--annot-ab``, ``--failover-ab``); its TPU chip lease and backend probe
have no counterpart.

Runs on the card (``--device cuda``, the default; without a card it prints
the failure line and exits 2). ``--device cpu`` runs the same code on the
CPU at a tiny preset, for the tests: its numbers are host-clock times of
the CPU, not of a card, and ``extra["device"]`` says so.

    python -m llmapigateway_tpu_torch.tools.bench [--preset tinyllama-1.1b]
        [--layout both] [--kv both] [--steps 200] [--device cuda]
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..config.schemas import LocalEngineConfig, not_ported
from ..engine.checkpoint import unique_bytes, weight_count
from ..engine.engine import GenRequest, InferenceEngine, resolve_device
from ..models.config import get_preset
from . import note

GREEDY = (0.0, 1.0, 0, 0.0, 0.0)     # _exec_prefill's per-row sampling
# The rungs' shapes, as the root bench's defaults set them.
EIGHT_B = dict(preset="llama-3-8b", batch=32, seq=512, steps=96)
SWA = dict(preset="mistral-7b", seq=8192, prompt=7680, batch=4, steps=32)
LONG_CTX = dict(seq=4096, prompt=2048, batch=4, steps=64)
SECOND_STEPS = 96
# The quant rung's arms (name, weight quant, KV quant), as the root bench.
QUANT_ARMS = (("quant_int8", "int8", ""), ("quant_int8_kv8", "int8", "int8"),
              ("quant_int4_kv8", "int4", "int8"))
# Root-bench rungs the port cannot serve yet: flag → port-queue item.
REFUSED = {
    "spec_draft": "speculative decoding",
    "spec_ladder": "speculative decoding",
    "spec_mixed": "speculative decoding",
    "disagg_ab": "disaggregation, supervision, observability",
    "flight_ab": "disaggregation, supervision, observability",
    "annot_ab": "disaggregation, supervision, observability",
    "failover_ab": "disaggregation, supervision, observability",
}


def fail_line(diag: str) -> None:
    """The failure contract: one parseable line that says what went wrong
    (the command then exits with 2)."""
    print(json.dumps({"metric": "decode_tok_s", "value": 0.0,
                      "unit": "tok/s", "error": diag, "extra": {}}),
          flush=True)


def card_info(device: torch.device) -> dict:
    """Where the numbers come from: the card's name, count, and its name
    and power limit as ``nvidia-smi`` prints them."""
    if device.type != "cuda":
        return {"device": "cpu", "card": None,
                "note": "--device cpu: host-clock times of the CPU, not of "
                        "a card"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "not available"
    return {"device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "card": smi}


def build_engine(args, device, kv_layout: str, preset: str | None = None,
                 kv_quant: str = "", model_cfg=None, **knobs):
    """(engine, init seconds) of one arm; ``knobs`` override any other
    LocalEngineConfig field."""
    cfg = LocalEngineConfig(**{
        "preset": preset or args.preset, "dtype": "bfloat16",
        "max_batch_size": args.batch, "max_seq_len": args.seq,
        "prefill_chunk": min(512, args.prompt_len), "kv_quant": kv_quant,
        "decode_burst": args.burst, "kv_layout": kv_layout,
        "kv_page_size": args.page_size,
        "hbm_peak_gbps": args.peak_gbps, **knobs})
    t0 = time.monotonic()
    engine = InferenceEngine(cfg, device=device, model_cfg=model_cfg)
    init_s = time.monotonic() - t0
    note(f"[bench] engine init ({kv_layout}, {kv_quant or 'bf16'} KV): "
         f"{init_s:.1f}s (B={engine.B}, S={engine.S})")
    return engine, round(init_s, 2)


def _model_footprint(engine) -> tuple[int, int]:
    """(n_params, param_bytes) of the engine's weights
    (engine/checkpoint.py ``weight_count`` and ``unique_bytes``)."""
    return weight_count(engine.params), unique_bytes(engine.params)


def decode_footprint(prompt_len: int, steps: int, warmup: int,
                     burst: int) -> tuple[int, int]:
    """(warmup_steps, total_tokens) of fill_and_time_decode's workload;
    ``total_tokens`` sizes the paged reservation, which must cover every
    step or the tail would write through the trash page."""
    burst = max(1, burst)
    tail = steps % burst
    warmup_steps = burst + tail + (max(0, warmup - burst - tail)
                                   // burst) * burst
    return warmup_steps, prompt_len + warmup_steps + steps + 1


def _sync(engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def fill_and_time_decode(engine, args, steps: int | None = None) -> dict:
    """Fill every slot through prefill, then time steady decode through the
    engine's own burst loop (``_decode_burst``, one host fetch a burst)."""
    B, S = engine.B, engine.S
    steps = steps if steps is not None else args.steps
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, engine.model_cfg.vocab_size,
                          size=args.prompt_len).tolist()
    burst = max(1, engine.decode_burst)
    tail = steps % burst
    warmup_steps, total_tokens = decode_footprint(
        len(prompt), steps, args.warmup, burst)
    if total_tokens > S:
        raise RuntimeError(
            f"--seq {S} too small for {len(prompt)} prompt + "
            f"{warmup_steps + steps} decode steps")
    groups = [list(range(i, min(i + engine.prefill_batch, B)))
              for i in range(0, B, engine.prefill_batch)]

    def prefill(group):
        pos, first = 0, None
        while pos < len(prompt):
            chunk = prompt[pos:pos + engine.prefill_chunk]
            first = engine._exec_prefill(group, [pos] * len(group),
                                         [chunk] * len(group),
                                         [GREEDY] * len(group))
            pos += len(chunk)
        return first

    # Warm every prefill shape the fill uses before timing it (writes land
    # on the trash page or in rows the fill overwrites).
    for k in sorted({len(g) for g in groups}):
        prefill(list(range(k)))
    _sync(engine)
    if engine.paged:
        for slot in range(B):
            if not engine.allocator.allocate(slot, total_tokens):
                raise RuntimeError("paged KV pool too small for the shape")
        engine._table_dirty = True
    t0 = time.monotonic()
    for group in groups:
        prefill(group)
        for slot in group:
            engine.lengths[slot] = len(prompt)
            engine.active[slot] = True
            engine.last_token[slot] = 1
    _sync(engine)
    prefill_s = time.monotonic() - t0

    engine._d_dirty = True
    engine._decode_burst(burst)
    if tail:
        engine._decode_burst(tail)
    for _ in range(max(0, args.warmup - burst - tail) // burst):
        engine._decode_burst(burst)
    engine._flush_pending()
    t0 = time.monotonic()
    done = 0
    while done < steps:
        n = min(burst, steps - done)
        engine._decode_burst(n)         # lag-one: returns the burst before
        done += n
    # The window closes once the last burst's tokens are on the host.
    engine._flush_pending()
    decode_s = time.monotonic() - t0
    tok_s = B * steps / decode_s
    note(f"[bench] decode timed: {steps} steps x{B} slots -> "
         f"{tok_s:.1f} tok/s")

    # A decode step reads every weight byte once plus the live KV; about
    # 2 · params FLOPs a token.
    c = engine.model_cfg
    n_params, param_bytes = _model_footprint(engine)
    step_s = decode_s / steps
    avg_live = args.prompt_len + warmup_steps + steps / 2
    kv_elem_bytes = (1 + 4 / c.head_dim) if engine.kv_quant else 2
    kv_bytes = (2 * c.n_layers * B * c.n_kv_heads * avg_live * c.head_dim
                * kv_elem_bytes)
    hbm_gbps = (param_bytes + kv_bytes) / step_s / 1e9
    out = {
        "tok_s": round(tok_s, 1),
        "ms_per_decode_step": round(1000.0 * step_s, 3),
        "prefill_tok_s": round(B * args.prompt_len / prefill_s, 1),
        "n_params_b": round(n_params / 1e9, 3),
        "mfu": round(2.0 * n_params * B / step_s
                     / (args.peak_tflops * 1e12), 4),
        "hbm_gbps": round(hbm_gbps, 1),
        "roofline_fraction": round(hbm_gbps / args.peak_gbps, 3),
    }
    if engine.paged and engine.kv_ppb > 1:
        out["pages_per_block"] = engine.kv_ppb
    return out


def reset_slots(engine) -> None:
    """Return a bench-filled engine to a clean scheduler state."""
    engine._flush_pending()
    engine.lengths[:] = 0
    engine.active[:] = False
    engine.last_token[:] = 0
    engine._d_dirty = True
    if engine.paged:
        for slot in range(engine.B):
            engine.allocator.release(slot)
        engine._table_dirty = True


async def _first_token(r: GenRequest) -> float:
    """The engine's own first-token stamp (text deltas can lag tokens)."""
    while r.t_first_token is None and r.finish_reason is None:
        await asyncio.sleep(0.002)
    return r.t_first_token or time.monotonic()


def measure_ttft_under_load(engine, args) -> dict:
    """p50/p95 time to first token of requests injected while every other
    slot decodes: admission, chunked prefill interleaved with decode
    bursts. Every probe's prompt is distinct, so the prefix cache serves
    none of them warm (the shared-prefix rung measures that)."""
    rng = np.random.default_rng(1)
    V = engine.model_cfg.vocab_size

    async def run() -> dict:
        await engine.start()
        bg = []
        budget = engine.S - args.prompt_len - 8
        for _ in range(max(1, engine.B - 1)):
            r = GenRequest(
                prompt_ids=rng.integers(0, V, args.prompt_len).tolist(),
                max_tokens=budget, temperature=0.0)
            await engine.submit(r)
            bg.append(r)
        for r in bg:
            await _first_token(r)
        note(f"[bench] TTFT: {len(bg)} background slots decoding; "
             f"injecting {args.ttft_probes} probes")
        ttfts = []
        for _ in range(args.ttft_probes):
            p = GenRequest(
                prompt_ids=rng.integers(0, V, args.prompt_len).tolist(),
                max_tokens=4, temperature=0.0)
            t_sub = time.monotonic()
            await engine.submit(p)
            ttfts.append(1000.0 * (await _first_token(p) - t_sub))
            async for _ in engine.stream(p):
                pass
        for r in bg:
            r.cancelled = True
        await engine.stop()
        arr = np.asarray(sorted(ttfts))
        return {"ttft_p50_ms": round(float(np.percentile(arr, 50)), 1),
                "ttft_p95_ms": round(float(np.percentile(arr, 95)), 1),
                "ttft_probes": len(arr), "ttft_load_slots": len(bg)}

    return asyncio.run(run())


def scheduler_throughput(engine, args, n_tokens: int = 120) -> float:
    """Steady decode tok/s through the real scheduler loop (admission,
    bursts, the burst-depth controller) with distinct prompts: one warm
    request, then a full batch timed from all slots decoding to the end
    (the root bench's ``scheduler_throughput``)."""
    rng = np.random.default_rng(9)
    V = engine.model_cfg.vocab_size
    n_tokens = max(2, min(n_tokens, engine.S - args.prompt_len - 8))

    async def drain(r):
        async for _ in engine.stream(r):
            pass

    async def run() -> float:
        await engine.start()
        warm = GenRequest(
            prompt_ids=rng.integers(0, V, args.prompt_len).tolist(),
            max_tokens=2 * max(1, engine.decode_burst), temperature=0.0)
        await engine.submit(warm)
        await drain(warm)
        reqs = [GenRequest(
            prompt_ids=rng.integers(0, V, args.prompt_len).tolist(),
            max_tokens=n_tokens, temperature=0.0) for _ in range(engine.B)]
        for r in reqs:
            await engine.submit(r)
        for r in reqs:
            await _first_token(r)
        t0 = time.monotonic()
        await asyncio.gather(*(drain(r) for r in reqs))
        dt = time.monotonic() - t0
        await engine.stop()
        return sum(len(r.generated) - 1 for r in reqs) / dt

    return asyncio.run(run())


def ttft_target_rung(args, device) -> dict:
    """The burst-depth controller under load: the llama-3-8b arm's engine
    (``--eight-b``; else the headline preset's) with ``ttft_target_ms``,
    every depth's decode graph captured at build, measured through the real
    scheduler: decode tok/s, TTFT p50/p95 under load, and the controller's
    ``burst_*`` stats with the engine's graph and pipeline counts."""
    rargs = argparse.Namespace(**vars(args))
    preset, kv_quant = args.preset, ""
    if args.eight_b:
        preset, kv_quant = EIGHT_B["preset"], "int8"
        rargs.seq, rargs.batch = EIGHT_B["seq"], EIGHT_B["batch"]
        rargs.prompt_len = min(args.prompt_len, 128)
    engine, init_s = build_engine(rargs, device, "contiguous", preset=preset,
                                  kv_quant=kv_quant,
                                  ttft_target_ms=args.ttft_target)
    sched_tok_s = scheduler_throughput(engine, rargs)
    t = measure_ttft_under_load(engine, rargs)
    diag = {k: v for k, v in engine.stats().items()
            if k.startswith("burst_") or k in (
                "graphs_captured", "graph_replays", "sync_bursts",
                "flushes")}
    return {"target_ms": args.ttft_target, "preset": preset,
            "kv_quant": kv_quant or "bf16", "batch": rargs.batch,
            "init_s": init_s, "scheduler_tok_s": round(sched_tok_s, 1),
            **t, **diag}


def shared_prefix_rung(args, device) -> dict:
    """Cold against warm TTFT on a shared-prefix workload: every request
    carries the same ``--shared-prefix-len``-token prefix and a distinct
    tail; the first pays the full prefill, later ones must hit the prefix
    cache. That prefill was skipped is read from the engine's counters."""
    plen = max(32, args.shared_prefix_len)
    tail_len = max(8, args.shared_prefix_tail)
    # The default page when it leaves at least two shareable blocks in the
    # prefix; a smaller one only for a short prefix.
    page = min(args.page_size, max(16, plen // 2))
    seq = max(args.seq, plen + tail_len + 64)
    engine, _ = build_engine(
        args, device, "paged", max_seq_len=seq, kv_page_size=page,
        prefill_chunk=min(512, max(32, plen // 4)),
        # Slack past the full reservation, so that a release can keep the
        # prefix resident instead of evicting it for the next admission.
        kv_num_pages=(args.batch + 2) * -(-seq // page) + 1,
        decode_burst=max(1, min(args.burst, 8)))
    if engine._prefix_cache is None:
        raise RuntimeError("prefix cache inactive on the rung's engine")
    rng = np.random.default_rng(17)
    V = engine.model_cfg.vocab_size
    prefix = rng.integers(2, V, size=plen).tolist()

    async def one(ids, n_gen=8) -> float:
        r = GenRequest(prompt_ids=ids, max_tokens=n_gen, temperature=0.0)
        t_sub = time.monotonic()
        await engine.submit(r)
        ttft = 1000.0 * (await _first_token(r) - t_sub)
        async for _ in engine.stream(r):
            pass
        return ttft

    async def run() -> dict:
        await engine.start()
        # Warm the shapes off the measured path: an unrelated full-length
        # prompt and an unrelated prompt as short as a warm tail.
        await one(rng.integers(2, V, size=plen + tail_len).tolist())
        await one(rng.integers(2, V, size=tail_len + 1).tolist())
        calls0 = engine.prefill_calls
        cold_ttft = await one(prefix + rng.integers(2, V,
                                                    size=tail_len).tolist())
        cold_calls = engine.prefill_calls - calls0
        warm, warm_calls = [], []
        for _ in range(max(1, args.shared_prefix_warm)):
            calls0 = engine.prefill_calls
            warm.append(await one(
                prefix + rng.integers(2, V, size=tail_len).tolist()))
            warm_calls.append(engine.prefill_calls - calls0)
        stats = engine.stats()
        await engine.stop()
        engine._prefix_cache.check_invariants()
        arr = np.asarray(sorted(warm))
        p50 = float(np.percentile(arr, 50))
        return {
            "prefix_tokens": plen,
            "page_size": page,
            "cold_ttft_ms": round(cold_ttft, 1),
            "warm_ttft_p50_ms": round(p50, 1),
            "warm_ttft_p95_ms": round(float(np.percentile(arr, 95)), 1),
            "warm_requests": len(warm),
            "ttft_speedup": round(cold_ttft / max(1e-9, p50), 2),
            # The structural proof: prefill calls per request and the
            # engine's own hit accounting.
            "cold_prefill_calls": cold_calls,
            "warm_prefill_calls_max": max(warm_calls),
            "prefix_hits_total": stats["prefix_hits_total"],
            "prefix_cached_tokens_total": stats[
                "prefix_cached_tokens_total"],
        }

    return asyncio.run(run())


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m llmapigateway_tpu_torch.tools.bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--preset", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--burst", type=int, default=32,
                    help="chained decode steps per host fetch")
    ap.add_argument("--layout", default="both",
                    choices=["contiguous", "paged", "both"],
                    help="KV layouts of the headline arms (the root "
                         "bench's --kv)")
    ap.add_argument("--kv", default="both", choices=["bf16", "int8", "both"],
                    help="KV types of the headline arms")
    ap.add_argument("--page-size", type=int, default=256)
    ap.add_argument("--skip-ttft", action="store_true")
    ap.add_argument("--ttft-probes", type=int, default=5)
    ap.add_argument("--peak-tflops", type=float, default=989.0,
                    help="dense bf16 TFLOP/s for MFU (H100 SXM: 989)")
    ap.add_argument("--peak-gbps", type=float, default=3350.0,
                    help="HBM GB/s for the roofline share (H100 SXM: 3350)")
    ap.add_argument("--second-preset", default="llama-3b-class",
                    help="mid-size preset rung ('' disables)")
    ap.add_argument("--eight-b", type=int, default=1,
                    help="llama-3-8b rung, bf16 weights + int8 KV "
                         "(0 disables)")
    ap.add_argument("--swa", type=int, default=1,
                    help="sliding-window rung: mistral-7b with its window "
                         "against the same model without (0 disables)")
    ap.add_argument("--long-ctx", type=int, default=1,
                    help="long-context bf16 vs int8 KV rung (0 disables)")
    ap.add_argument("--shared-prefix", type=int, default=1,
                    help="shared-prefix rung: cold vs warm TTFT through "
                         "the prefix cache (0 disables)")
    ap.add_argument("--ttft-target", type=float, default=0.0,
                    help="ttft_target_ms of the burst-depth controller rung "
                         "(the root bench's 200; 0 disables)")
    ap.add_argument("--quant-rung", type=int, default=0,
                    help="weight-quantization rung on the headline preset, "
                         "contiguous: int8, int8 + int8 KV, int4 + int8 KV, "
                         "each against the contiguous bf16 arm (0 disables)")
    ap.add_argument("--shared-prefix-len", type=int, default=512)
    ap.add_argument("--shared-prefix-tail", type=int, default=32)
    ap.add_argument("--shared-prefix-warm", type=int, default=6)
    ap.add_argument("--max-seconds", type=float, default=1200.0,
                    help="soft deadline: optional rungs are skipped once "
                         "this much time has passed")
    # The root bench's rungs that the port cannot serve yet: accepted only
    # at 0, so that a command line written for bench.py fails loudly.
    for flag in REFUSED:
        ap.add_argument("--" + flag.replace("_", "-"), type=float, default=0,
                        help=f"not ported ({REFUSED[flag]}); 0 only")
    args = ap.parse_args(argv)
    for flag, item in REFUSED.items():
        if getattr(args, flag):
            raise not_ported(f"--{flag.replace('_', '-')}", item)
    return args


def main(argv=None) -> dict:
    """Run the rungs; print the one JSON line and return it."""
    t_start = time.monotonic()
    args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        fail_line(str(e))
        raise
    layouts = ["contiguous", "paged"] if args.layout == "both" \
        else [args.layout]
    kvs = ["bf16", "int8"] if args.kv == "both" else [args.kv]
    result = {"metric": (f"decode_tok_s ({args.preset}, bs={args.batch}, "
                         f"ctx={args.prompt_len}+{args.steps}, {layouts[0]}, "
                         f"{kvs[0]} KV)"),
              "value": 0.0, "unit": "tok/s", "extra": {}}
    extra = result["extra"]
    extra.update(card_info(device))
    extra["peak_gbps"], extra["peak_tflops"] = args.peak_gbps, args.peak_tflops
    errors: list[str] = []

    def over_budget(phase: str) -> bool:
        if time.monotonic() - t_start <= args.max_seconds:
            return False
        note(f"[bench] soft deadline {args.max_seconds:.0f}s passed — "
             f"skipping {phase}")
        extra.setdefault("skipped_phases", []).append(phase)
        return True

    def guarded(phase: str, fn):
        try:
            return fn()
        except Exception as e:            # a failed rung must not end the run
            errors.append(f"{phase}: {e!r}")
            note(f"[bench] FAILED {phase}: {e!r}")
            return None

    # 1. Headline arms; TTFT under load on the first.
    for i, (layout, kv) in enumerate(
            (lay, kv) for lay in layouts for kv in kvs):
        name = f"{layout}_{kv}"
        if i and over_budget(name):
            continue

        def arm():
            engine, init_s = build_engine(
                args, device, layout, kv_quant="int8" if kv == "int8" else "")
            r = {"init_s": init_s, **fill_and_time_decode(engine, args)}
            if i == 0 and not args.skip_ttft:
                reset_slots(engine)
                r.update(measure_ttft_under_load(engine, args))
            return r
        r = guarded(name, arm)
        if r is not None:
            extra[name] = r
            if i == 0:
                result["value"] = r["tok_s"]

    # 2. llama-3-8b, int8 weights + int8 KV: contiguous (+ TTFT), paged.
    if args.eight_b and not over_budget("eight_b"):
        bargs = argparse.Namespace(**vars(args))
        bargs.seq, bargs.batch = EIGHT_B["seq"], EIGHT_B["batch"]
        bargs.prompt_len = min(args.prompt_len, 128)
        r8 = {"preset": EIGHT_B["preset"], "weights": "int8",
              "kv_quant": "int8", "batch": bargs.batch}
        for layout in ("contiguous", "paged"):
            if layout == "paged" and over_budget("eight_b_paged"):
                break

            def arm():
                engine, _ = build_engine(bargs, device, layout,
                                         preset=EIGHT_B["preset"],
                                         kv_quant="int8", quant="int8")
                r = fill_and_time_decode(engine, bargs,
                                         steps=EIGHT_B["steps"])
                if layout == "contiguous" and not args.skip_ttft:
                    reset_slots(engine)
                    r.update(measure_ttft_under_load(engine, bargs))
                return r
            r = guarded(f"eight_b_{layout}", arm)
            if r is not None:
                r8[layout] = r
        extra["eight_b"] = r8

    # 2b. The burst-depth controller at a TTFT target.
    if args.ttft_target > 0 and not over_budget("ttft_target"):
        r = guarded("ttft_target", lambda: ttft_target_rung(args, device))
        if r is not None:
            extra["ttft_target"] = r
            note(f"[bench] ttft_target {args.ttft_target} ms: TTFT p50 "
                 f"{r['ttft_p50_ms']} ms, {r['scheduler_tok_s']} tok/s "
                 f"through the scheduler")

    # 3. Shared prefix through the prefix cache.
    if args.shared_prefix and not over_budget("shared_prefix"):
        r = guarded("shared_prefix", lambda: shared_prefix_rung(args, device))
        if r is not None:
            extra["shared_prefix"] = r
            note(f"[bench] shared prefix: cold TTFT {r['cold_ttft_ms']} ms "
                 f"-> warm p50 {r['warm_ttft_p50_ms']} ms, prefill calls "
                 f"{r['cold_prefill_calls']} -> "
                 f"{r['warm_prefill_calls_max']}")

    # 4. Long context: bf16 against int8 KV.
    if args.long_ctx and not over_budget("long_ctx"):
        largs = argparse.Namespace(**vars(args))
        largs.seq, largs.prompt_len, largs.batch = (
            LONG_CTX["seq"], LONG_CTX["prompt"], LONG_CTX["batch"])
        lmc = dataclasses.replace(get_preset(args.preset),
                                  max_seq_len=LONG_CTX["seq"])

        def long_ctx():
            lc = {}
            for label, kvq in (("bf16", ""), ("int8", "int8")):
                engine, _ = build_engine(largs, device, "contiguous",
                                         kv_quant=kvq, model_cfg=lmc)
                r = fill_and_time_decode(engine, largs,
                                         steps=LONG_CTX["steps"])
                lc[label] = {k: r[k] for k in ("tok_s", "ms_per_decode_step",
                                               "hbm_gbps")}
                del engine
            lc["shape"] = (f"bs={LONG_CTX['batch']} "
                           f"ctx={LONG_CTX['prompt']}+{LONG_CTX['steps']}")
            lc["int8_speedup"] = round(lc["int8"]["tok_s"]
                                       / lc["bf16"]["tok_s"], 2)
            return lc
        r = guarded("long_ctx", long_ctx)
        if r is not None:
            extra["long_ctx"] = r

    # 5. Sliding window: the preset with its window against without.
    if args.swa and not over_budget("swa"):
        sargs = argparse.Namespace(**vars(args))
        sargs.seq, sargs.prompt_len, sargs.batch = (
            SWA["seq"], SWA["prompt"], SWA["batch"])
        mc = get_preset(SWA["preset"])

        def swa():
            sw = {}
            for label, window in (("windowed", mc.sliding_window),
                                  ("full", 0)):
                mcv = dataclasses.replace(
                    mc, sliding_window=window,
                    max_seq_len=max(mc.max_seq_len, SWA["seq"]))
                engine, _ = build_engine(sargs, device, "contiguous",
                                         preset=SWA["preset"],
                                         kv_quant="int8", model_cfg=mcv)
                r = fill_and_time_decode(engine, sargs,
                                         steps=SWA["steps"])
                sw[label] = {k: r[k] for k in ("tok_s",
                                               "ms_per_decode_step")}
                del engine
            sw["shape"] = (f"{SWA['preset']} bf16 weights + int8 KV "
                           f"bs={SWA['batch']} "
                           f"ctx={SWA['prompt']}+{SWA['steps']} "
                           f"window={mc.sliding_window}")
            sw["window_speedup"] = round(sw["windowed"]["tok_s"]
                                         / sw["full"]["tok_s"], 2)
            return sw
        r = guarded("swa", swa)
        if r is not None:
            extra["swa"] = r

    # 6. A mid-size preset.
    if args.second_preset and not over_budget("second_preset"):
        def second():
            engine, init_s = build_engine(args, device, "contiguous",
                                          preset=args.second_preset)
            return {"preset": args.second_preset, "init_s": init_s,
                    **fill_and_time_decode(engine, args,
                                           steps=SECOND_STEPS)}
        r = guarded("second_preset", second)
        if r is not None:
            extra["second_preset"] = r

    # 7. Weight quantization on the headline preset, contiguous: int8
    #    weights, int8 weights + int8 KV, int4 weights + int8 KV.
    if args.quant_rung:
        base = extra.get("contiguous_bf16", {}).get("tok_s")
        for name, quant, kvq in QUANT_ARMS:
            if over_budget(name):
                continue

            def arm():
                engine, init_s = build_engine(args, device, "contiguous",
                                              kv_quant=kvq, quant=quant)
                r = fill_and_time_decode(engine, args)
                return {"init_s": init_s, **{k: r[k] for k in (
                    "tok_s", "ms_per_decode_step", "mfu", "hbm_gbps",
                    "roofline_fraction")},
                    "weight_bytes": _model_footprint(engine)[1],
                    "speedup_vs_bf16": (round(r["tok_s"] / base, 2)
                                        if base else None)}
            r = guarded(name, arm)
            if r is not None:
                extra[name] = r
        int8 = extra.get("quant_int8_kv8", {}).get("tok_s")
        if int8 and "quant_int4_kv8" in extra:
            extra["quant_int4_kv8"]["speedup_vs_int8"] = round(
                extra["quant_int4_kv8"]["tok_s"] / int8, 2)

    if errors:
        extra["errors"] = errors
    extra["wall_s"] = round(time.monotonic() - t_start, 1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    try:
        out = main()
    except RuntimeError:
        sys.exit(2)
    sys.exit(0 if out["value"] > 0 else 1)
