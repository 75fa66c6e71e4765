#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``llmapigateway_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

or, to time the decode (or prefill) rows of several checkouts in turn with
one timer (say a ``git archive`` of the parent, this one, this one, the
parent), or to run each checkout's own bench tool in turn::

    python3 chip_smoke.py --decode-ab TREE [TREE ...] [--out FILE]
    python3 chip_smoke.py --prefill-ab TREE [TREE ...] [--out FILE]
    python3 chip_smoke.py --bench-ab TREE [TREE ...] [--out FILE]

Phases, each printed as JSON lines:

1. device  — ``nvidia-smi`` name and power limit, ``torch.cuda`` name.
2. build   — every CUDA source in ``llmapigateway_tpu_torch/csrc/``
             compiled for sm_90a, one ``nvcc`` per source, all started
             together (build time, ptxas's registers and spills per
             kernel, and each body's shared memory).
3. kernel  — each kernel body's wrapper against its plain PyTorch version
             on the same card tensors at the main path's shapes: the paged
             kernels over a page pool, the flash kernels over a contiguous
             cache, each with a bf16 cache and with an int8 cache and its
             fp32 scales; full attention at llama-3-8b, tinyllama-1.1b
             (64-wide heads) and gemma-2b (256-wide, one KV head) heads, the
             window variants at mistral-7b (window 4096 over 8192
             positions) and phi-3-mini (MHA, 96-wide heads, window 2047)
             heads over a ring-like table whose pages below the window are
             the trash page, and the multi-page variants (pages_per_block 2
             and 4) on a packed, shuffled table, each bit-for-bit the
             per-page kernel's output.
             Per-element error against the fp32 plain output under the
             stated relative + absolute tolerance, and device times (CUDA
             events, median of 25 runs with L2 flushed before each and a
             device-side spin hiding the host's enqueue; the wrapper's host
             time per call beside them) beside the plain
             version, one library call on the dense view
             (``scaled_dot_product_attention`` on bf16 K/V with a causal or
             banded mask; timed only — the port never calls it; no library
             call takes int8 K/V with per-key scales) and the least time the
             card could take for the keys the kernel must read. Then every
             group size (1, 2, 3, 4, 7, 8, 16) and head width (64, 96, 128,
             256) the kernels are built for, with and without a window, held
             the same way, for every kernel body. Then every decode body
             (both layouts and KV types, window 0 and 700, pages_per_block
             1/2/4) with slots at 0, the cache's end and each boundary ±1
             of the key split its wrapper launched with. Decode rows carry
             that split (``n_split``, ``split_keys``) and workspace bytes as
             the wrapper recorded them. Then kernel #5, the
             decode step's one-row KV insert, ``torch.equal`` to its plain
             version and to ``index_put_`` at the insert tool's shape and at
             llama-3-8b's, timed beside both, its bound and an empty
             kernel's launch.
4. model   — two-layer models of llama-3-8b head geometry through the
             port's forward on the card (kernels) against the same weights
             through the plain path on the CPU in fp32, on both layouts and
             both cache types; the same with tiny-mistral-test's window (16)
             over 16-token pages; a packed pool read two pages a run; and
             the LM head at llama-3-8b's shape, which must give fp32 logits
             equal to the fp32 product of its bf16 operands.
5. graphs  — the decode graphs at llama-3-8b full width (paged bf16, paged
             int8, contiguous bf16) and at mistral-7b through the paged SWA
             ring (int8), each engine capturing one graph per burst depth
             and sampler variant at build: from one device state, the
             greedy burst replayed by its graph and the same burst run
             eagerly give equal tokens and ``torch.equal`` KV and buffers;
             the sampled graph replayed twice from one generator state
             gives equal tokens, each inside the plain sampler's candidate
             set (top-k 40, top-p 0.9) along the replayed tokens.
6. tools   — the three engine-driving tools (llmapigateway_tpu_torch/tools/)
             with their default flags at tinyllama-1.1b width and depth:
             every KV-insert variant, kernel #5 launched twice per layer
             per step and its caches equal to index_put's; the decode
             ablation with the kernels' attention (kernel #3 once per layer
             per step); the engine's bursts on both layouts.
7. serve   — the port's aiohttp app in-process on a local port, once per
             served configuration (SERVE_RUNS): llama-3-8b on both layouts
             and cache types and with two- and four-page blocks, mistral-7b
             (both cache types: contiguous; paged through the SWA page ring;
             paged with multi-page blocks over a context the ring would not
             shrink), phi-3-mini (both cache types, contiguous and through
             the ring; int8 with multi-page blocks), tinyllama-1.1b and
             gemma-2b (256-wide heads, one KV head) on both layouts and
             cache types, qwen2-0.5b (a group of 7) and gemma-7b (256-wide
             heads, a group of 1), each at full width and depth with random
             weights from a seed, each engine stopped and its memory freed
             before the next is built: every body of the kernel phase's
             timed rows runs at its own head geometry. 2 SSE + 2 JSON
             concurrent requests, all admitted in the engine's first step.
             Launch counters are zeroed just before each run and read just
             after: the layout's kernels must have run their configured body
             (window, pages per block, KV type) at the model's head width
             and group once per layer per forward of their kind (a one-token
             prefill call runs the decode kernel), and no other body or
             layout's kernel at all. On the ring runs the ring
             rotates in prefill and in decode, no slot ever holds more than
             the ring, and every page comes back. Pairs of runs that read
             the same values in the same order must stream the same text.
             Each run reports the decode graphs captured, their replays,
             the synchronous bursts and the early flushes of a burst in
             flight; full-depth bursts must have replayed (the launch
             counts above include every replay's launches).
8. prefix  — the prefix cache at llama-3-8b full width (paged, page 256,
             chunk 512, prefix_cache at its default; bf16, int8, and bf16
             with two-page blocks): one cold request and four warm ones,
             one at a time, sharing a 2048-token system prompt, over HTTP.
             Each warm request must be served 2048 cached tokens
             (``usage.prompt_tokens_details``) and run one prefill call
             (the cold one runs 5), and stream the text the same prompt
             streams on an engine with prefix_cache false; launch counts
             as in the serve phase; after the run the allocator's
             refcounts and the tree agree and every page is free or
             resident. Then five distinct system prompts through a pool
             that must evict for the fifth. Cold and warm TTFT are
             information only. Kernels #1 and #2 over aliased page tables
             (the cache's shared blocks) are held in the kernel phase.
9. gateway — the gateway around the engine: a loopback aiohttp stub
             upstream (written here) as three ``remote_http`` providers
             (failing: HTTP 500, then an in-band error at 200; healthy;
             slow) and a local llama-3-8b at full width and depth (paged,
             bf16) behind one app. A chain [failing stub with one retry,
             local] answers the local text; the stub is hit twice a request
             until its breaker opens, then never. ``rotate_models`` over
             [healthy stub, local] alternates as ``RotationDB`` says. A
             ``timeout_ms`` below the slow stub's delay answers 504 with the
             stub alone or first, and the local answer with the stub
             second. ``/v1/api/usage-records`` holds one row per served
             request with its usage block's provider and token counts,
             ``/v1/api/health/providers`` the failing stub's breaker open;
             #1/#2 ran once per layer per forward. Walls, and the added cost
             of a failed remote attempt before the local answer.
10. checkpoint — an HF checkpoint on the card through the config API: a
             tinyllama-1.1b checkpoint at full width and depth (bf16, two
             shards) written by the port's synthetic-checkpoint tool; the
             app serves a local provider on the tinyllama-1.1b preset (random
             weights) and one built from the checkpoint. A providers.json
             with a syntax error POSTed to ``/v1/config/providers`` gets 400
             with the file and the config version unchanged; the same
             entry with ``model_path`` gets 200 and the next version. The
             next request (its ``x-request-id`` returned) rebuilds the
             provider from the checkpoint, and the other provider is not
             rebuilt: every param leaf ``torch.equal`` to its tensor read
             back from the shards; 2 SSE + 2 JSON requests, counted,
             stream the text the directly built engine streams, #1/#2 once
             per layer per forward; ``/v1/models/AsOpenCodeFormat`` lists
             the model. The retired engine closes after the registry's
             grace period (shortened here) and ``memory_allocated`` falls
             by at least its weights' bytes. Load seconds, host-to-device
             GB/s, the resident set the load added and the first request's
             wall are information.
             The same checkpoint is then loaded with int4 weights: every
             leaf equal to the shards' quantization on the host.
11. quant  — quantized weights and the Mixtral family. The W4A8 kernel
             (``csrc/w4a8_mm.cu``) against its plain version (unpack, then
             ``torch._int_mm``) at llama-3-8b's projections (M 1, 8, 32 and
             512) and mixtral-8x7b's experts (the dense form at decode, 8
             experts over one shared activation block; capacity dispatch
             at 256 rows an expert): int32 sums ``torch.equal``, bf16
             outputs within one bf16 rounding; the int8 product
             (``torch._int_mm``, rows padded to 17) ``torch.equal`` to the
             exact product; device times beside the plain version,
             ``torch._int_mm`` on the unpacked levels and the bound (packed
             bytes at 3.35 TB/s or int8 operations at 1979 TOP/s). Then
             serve runs, as in phase 7, of llama-3-8b (int8 weights, bf16
             KV; int4 weights, int8 KV) and mixtral-8x7b at full width and
             depth (the same two), each reporting its weight bytes against
             the arithmetic (within 1%), the build's peak memory above
             what it keeps (below what a full-precision tree adds) and the
             quantized products' launches (int4: the W4A8 kernel 7 times
             per layer per forward, the int8 head once); #1/#2 once per
             layer per forward; then tinyllama-1.1b, qwen2-0.5b, gemma-7b,
             mistral-7b (SWA ring) and phi-3-mini at int4 and the tied
             gemma-2b at int8, the same way. mixtral-8x7b int8's decode
             graphs replayed against eager as in phase 5. A synthetic mixtral-8x7b
             checkpoint at full width and one layer (reduced depth),
             loaded with int8: every leaf equal to the shards' host
             quantization, one request served.
12. bench  — the port's bench tool (``tools/bench.py``) at tinyllama-1.1b,
             32 steps, 3 TTFT probes, its shared-prefix rung, its
             ``--ttft-target 200`` rung and its ``--quant-rung`` (int8,
             int8 + int8 KV, int4 + int8 KV): its JSON line, a positive
             value, warm requests that ran fewer prefill calls than the
             cold one, the controller rung served through decode graphs,
             and the three quant arms with their speedups.
13. the ``kernels`` line (decode rows with the key split ``n_split`` and
   workspace bytes of their timed launch), the nvidia-smi line, and last the contract line
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line. Without a CUDA card,
or without the package beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import asyncio
import collections
import functools
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and dense bf16.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Kernel vs plain, per element: the plain version runs in fp32 on the same
# (bf16-valued, or int8 + fp32 scale) inputs; the kernel accumulates in fp32
# and rounds its output to bf16 once, which moves a value by at most half a
# bf16 ulp, 2^-8 of it. The absolute term covers the fp32 summation order
# over up to 4096 keys near an output of 0 (a few 1e-6). An element passes
# when
#   |kernel - plain| <= KERNEL_RTOL * |plain| + KERNEL_ATOL.
# The long rows average over ~1000-4000 keys (|out| ~ 0.03), so a kernel
# that drops or mis-masks a key there is off by well over 2^-8.
KERNEL_RTOL = 2.0 ** -8
KERNEL_ATOL = 2.0 ** -14
# Decode groups (query heads per KV head) and head widths the kernels are
# built for, each held to the plain version at H 32 and a batch of long and
# short slots, with full attention and with a window that is no multiple of
# the key tile or the page.
# A group that does not divide 32 heads (3, 7) takes H = G * KV at the KV
# head count given here (llama-3b-class's 24 over 8, qwen2-0.5b's 14 over 2).
GROUP_CASES = dict(B=4, H=32, n_stale=[0, 257, 1000, 4095], T=100,
                   starts=[0, 1000], windows=[0, 700], kv_for_group={3: 8, 7: 2})
# Decode split edges: every decode body at these heads (SHAPES' decode
# cases' geometry), B slots a launch, window 0 and 700, the slots' n_stale
# at 0, the cache's end and each boundary ±1 of the launch's key split.
SPLIT_EDGES = dict(shapes=("llama-3-8b", "gemma-2b"), B=8, windows=(0, 700))
# LM head: fp32 logits from bf16 operands, against the fp32 product of the
# same values; a bf16 rounding of the logits (2^-9 of the largest) fails.
HEAD_REL_TOL = 2.0 ** -12
# Model check: bf16 weights and activations on the card (cuBLAS projections,
# bf16 rounding after every op) against fp32 on the CPU; relative to the
# largest reference logit.
MODEL_REL_TOL = 5e-2

# Kernel shapes, by model: the decode case and the prefill case. llama-3-8b
# is the full-attention main path of PRs 1-2; mistral-7b and phi-3-mini the
# window variants (their serve runs below); n_stale and starts sit around
# the window and past it. Prefill runs at a whole chunk (T 512) and a
# ragged one (T 300, no multiple of the 64- or 32-row query tile).
SHAPES = {
    "llama-3-8b": (
        dict(B=8, H=32, KV=8, Dh=128, page=256, NP=16, S=4096, window=0,
             n_stale=[0, 1, 255, 256, 257, 1000, 2047, 4095]),
        dict(H=32, KV=8, Dh=128, page=256, NP=16, S=4096, window=0,
             starts=[0, 256, 1000], T=(512, 300))),
    "mistral-7b": (
        dict(B=8, H=32, KV=8, Dh=128, page=256, NP=32, S=8192, window=4096,
             n_stale=[0, 1, 4095, 4096, 4097, 6000, 8000, 8191]),
        dict(H=32, KV=8, Dh=128, page=256, NP=32, S=8192, window=4096,
             starts=[0, 4000, 6000], T=(512, 300))),
    "phi-3-mini": (
        dict(B=8, H=32, KV=32, Dh=96, page=256, NP=16, S=4096, window=2047,
             n_stale=[0, 1, 2046, 2047, 2048, 3000, 3500, 4095]),
        dict(H=32, KV=32, Dh=96, page=256, NP=16, S=4096, window=2047,
             starts=[0, 2000, 3500], T=(512, 300))),
    # The head widths 64 (tinyllama, G 8) and 256 (gemma-2b, MQA: G 8 over
    # one KV head).
    "tinyllama-1.1b": (
        dict(B=8, H=32, KV=4, Dh=64, page=256, NP=8, S=2048, window=0,
             n_stale=[0, 1, 255, 256, 257, 1000, 1500, 2047]),
        dict(H=32, KV=4, Dh=64, page=256, NP=8, S=2048, window=0,
             starts=[0, 256, 1000], T=(512, 300))),
    "gemma-2b": (
        dict(B=8, H=8, KV=1, Dh=256, page=256, NP=16, S=4096, window=0,
             n_stale=[0, 1, 255, 256, 257, 1000, 2047, 4095]),
        dict(H=8, KV=1, Dh=256, page=256, NP=16, S=4096, window=0,
             starts=[0, 256, 1000], T=(512, 300))),
}
# Kernel #5 (the decode step's one-row KV insert): at the insert tool's
# default shape (tinyllama-1.1b's cache, tools/profile_insert.py) and at
# llama-3-8b's contiguous one, with lengths at 0, mid-page and S - 1.
INSERT_SHAPES = {
    "tinyllama-1.1b": dict(B=8, KV=4, S=1024, Dh=64),
    "llama-3-8b": dict(B=8, KV=8, S=4096, Dh=128),
}
# The multi-page bodies (pages_per_block 2 and 4) of the paged kernels, on a
# table packed for 4: at llama-3-8b shape and at mistral-7b's windowed one.
PPB_SHAPES = ("llama-3-8b", "mistral-7b")
PPBS = (2, 4)
LIBRARY_NONE = ("no single PyTorch call takes int8 K/V with per-key fp32 "
                "scales")

# The served configurations, in order. Weights (14.5-16 GB) and KV cache
# live on the card one engine at a time. mistral-7b's 32768-token context
# is cut to 8192 (the window is 4096; 8192 positions hold prompts past the
# window and past the ring), and to 5120 (phi-3-mini's 4096 to 3072) for
# the multi-page runs below; every width and depth is the preset's.
LLAMA = {"preset": "llama-3-8b", "max_batch_size": 8, "max_seq_len": 4096,
         "prefill_chunk": 512, "mesh": {}}
MISTRAL = {"preset": "mistral-7b", "max_batch_size": 8, "max_seq_len": 8192,
           "prefill_chunk": 512, "mesh": {}}
PHI3 = {"preset": "phi-3-mini", "max_batch_size": 8, "max_seq_len": 4096,
        "prefill_chunk": 512, "mesh": {}}
PAGED = {"kv_layout": "paged", "kv_page_size": 256}
# The SWA ring's size (engine._init_state, the JAX engine's formula):
# ceil((window + decode_burst + max(prefill_chunk, decode_burst)) / page) + 2
# — 21 pages for mistral-7b, 13 for phi-3-mini. Each paged ring run's pool
# holds B rings and the trash page, below B whole contexts.
MISTRAL_RING, PHI3_RING = 21, 13
# Prompt lengths: llama in bytes (one token each, plus the chat template's
# ~25): one within a page, one across a page, two across a prefill chunk.
# mistral-7b and phi-3-mini in prompt tokens: one inside the window, two
# past it, and one past the ring that ends 16 tokens below a page boundary,
# so the ring rotates in prefill and again when decode crosses the page.
LLAMA_PROMPT_CHARS = (40, 300, 700, 1100)
MISTRAL_PROMPT_TOKENS = (1500, 4600, 5200, 24 * 256 - 16)
PHI3_PROMPT_TOKENS = (600, 2300, 2900, 15 * 256 - 16)
# The window with multi-page blocks: the JAX engine's rule keeps per-page
# blocks under the ring, so these runs hold contexts whose ring would not
# be smaller than a slot (mistral-7b 5120 positions = 20 pages < 21;
# phi-3-mini 3072 = 12 < 13) — prompts still past the window.
MISTRAL_PPB = {**MISTRAL, "max_seq_len": 5120}
PHI3_PPB = {**PHI3, "max_seq_len": 3072}
MISTRAL_PPB_PROMPT_TOKENS = (1500, 4200, 4600, 5000)
PHI3_PPB_PROMPT_TOKENS = (600, 2100, 2500, 3000)
SERVE_RUNS = [  # (tag, engine config, prompts: ("chars"|"tokens", lengths))
    ("contiguous-bf16", {**LLAMA, "kv_layout": "contiguous", "kv_quant": ""},
     ("chars", LLAMA_PROMPT_CHARS)),
    ("contiguous-int8", {**LLAMA, "kv_layout": "contiguous",
                         "kv_quant": "int8"}, ("chars", LLAMA_PROMPT_CHARS)),
    ("paged-int8", {**LLAMA, **PAGED, "kv_pages_per_block": 1,
                    "prefix_cache": False, "kv_quant": "int8"},
     ("chars", LLAMA_PROMPT_CHARS)),
    ("paged-bf16", {**LLAMA, **PAGED, "kv_pages_per_block": 1,
                    "prefix_cache": False, "kv_quant": ""},
     ("chars", LLAMA_PROMPT_CHARS)),
    ("llama-paged-bf16-ppb2", {**LLAMA, **PAGED, "kv_pages_per_block": 2,
                               "prefix_cache": False, "kv_quant": ""},
     ("chars", LLAMA_PROMPT_CHARS)),
    ("mistral-contiguous-bf16", {**MISTRAL, "kv_layout": "contiguous",
                                 "kv_quant": ""},
     ("tokens", MISTRAL_PROMPT_TOKENS)),
    # prefix_cache stays at its default true: inert for a sliding-window
    # model, as in the JAX engine.
    ("mistral-paged-bf16-ring", {**MISTRAL, **PAGED, "kv_quant": "",
                                 "kv_num_pages": 8 * MISTRAL_RING + 1},
     ("tokens", MISTRAL_PROMPT_TOKENS)),
    ("phi3-contiguous-int8", {**PHI3, "kv_layout": "contiguous",
                              "kv_quant": "int8"},
     ("tokens", PHI3_PROMPT_TOKENS)),
    ("phi3-paged-int8-ring", {**PHI3, **PAGED, "kv_quant": "int8",
                              "kv_num_pages": 8 * PHI3_RING + 1},
     ("tokens", PHI3_PROMPT_TOKENS)),
    # Every other multi-page body of the kernel phase on a served path.
    *[(f"llama-paged-{kv or 'bf16'}-ppb{ppb}",
       {**LLAMA, **PAGED, "kv_pages_per_block": ppb, "prefix_cache": False,
        "kv_quant": kv}, ("chars", LLAMA_PROMPT_CHARS))
      for kv, ppb in (("", 4), ("int8", 2), ("int8", 4))],
    *[(f"mistral-paged-bf16-ppb{ppb}",
       {**MISTRAL_PPB, **PAGED, "kv_pages_per_block": ppb, "kv_quant": ""},
       ("tokens", MISTRAL_PPB_PROMPT_TOKENS)) for ppb in PPBS],
    *[(f"phi3-paged-int8-ppb{ppb}",
       {**PHI3_PPB, **PAGED, "kv_pages_per_block": ppb, "kv_quant": "int8"},
       ("tokens", PHI3_PPB_PROMPT_TOKENS)) for ppb in PPBS],
]
# Every other head width and group the presets have, at full width and
# depth: tinyllama-1.1b (Dh 64, G 8), qwen2-0.5b (Dh 64, G 7, QKV bias),
# gemma-2b (Dh 256, MQA) and gemma-7b (Dh 256, G 1).
TINYLLAMA = {"preset": "tinyllama-1.1b", "max_batch_size": 8,
             "max_seq_len": 2048, "prefill_chunk": 512, "mesh": {}}
QWEN2 = {"preset": "qwen2-0.5b", "max_batch_size": 8, "max_seq_len": 4096,
         "prefill_chunk": 512, "mesh": {}}
GEMMA2B = {"preset": "gemma-2b", "max_batch_size": 8, "max_seq_len": 4096,
           "prefill_chunk": 512, "mesh": {}}
GEMMA7B = {"preset": "gemma-7b", "max_batch_size": 8, "max_seq_len": 4096,
           "prefill_chunk": 512, "mesh": {}}
SERVE_RUNS += [
    ("tinyllama-contiguous-bf16", {**TINYLLAMA, "kv_layout": "contiguous",
                                   "kv_quant": ""},
     ("chars", LLAMA_PROMPT_CHARS)),
    ("qwen2-paged-bf16", {**QWEN2, **PAGED, "prefix_cache": False,
                          "kv_quant": ""}, ("chars", LLAMA_PROMPT_CHARS)),
    ("gemma2b-contiguous-int8", {**GEMMA2B, "kv_layout": "contiguous",
                                 "kv_quant": "int8"},
     ("chars", LLAMA_PROMPT_CHARS)),
    ("gemma7b-paged-bf16", {**GEMMA7B, **PAGED, "prefix_cache": False,
                            "kv_quant": ""}, ("chars", LLAMA_PROMPT_CHARS)),
]
# The other KV type of the window models, and of tinyllama-1.1b and
# gemma-2b on both layouts: with these, every body the kernel phase times
# runs on a served path at the head width and group of its row.
SERVE_RUNS += [
    ("mistral-contiguous-int8", {**MISTRAL, "kv_layout": "contiguous",
                                 "kv_quant": "int8"},
     ("tokens", MISTRAL_PROMPT_TOKENS)),
    ("mistral-paged-int8-ring", {**MISTRAL, **PAGED, "kv_quant": "int8",
                                 "kv_num_pages": 8 * MISTRAL_RING + 1},
     ("tokens", MISTRAL_PROMPT_TOKENS)),
    *[(f"mistral-paged-int8-ppb{ppb}",
       {**MISTRAL_PPB, **PAGED, "kv_pages_per_block": ppb,
        "kv_quant": "int8"}, ("tokens", MISTRAL_PPB_PROMPT_TOKENS))
      for ppb in PPBS],
    ("phi3-contiguous-bf16", {**PHI3, "kv_layout": "contiguous",
                              "kv_quant": ""}, ("tokens", PHI3_PROMPT_TOKENS)),
    ("phi3-paged-bf16-ring", {**PHI3, **PAGED, "kv_quant": "",
                              "kv_num_pages": 8 * PHI3_RING + 1},
     ("tokens", PHI3_PROMPT_TOKENS)),
    ("tinyllama-contiguous-int8", {**TINYLLAMA, "kv_layout": "contiguous",
                                   "kv_quant": "int8"},
     ("chars", LLAMA_PROMPT_CHARS)),
    *[(f"tinyllama-paged-{kv or 'bf16'}",
       {**TINYLLAMA, **PAGED, "prefix_cache": False, "kv_quant": kv},
       ("chars", LLAMA_PROMPT_CHARS)) for kv in ("", "int8")],
    ("gemma2b-contiguous-bf16", {**GEMMA2B, "kv_layout": "contiguous",
                                 "kv_quant": ""},
     ("chars", LLAMA_PROMPT_CHARS)),
    *[(f"gemma2b-paged-{kv or 'bf16'}",
       {**GEMMA2B, **PAGED, "prefix_cache": False, "kv_quant": kv},
       ("chars", LLAMA_PROMPT_CHARS)) for kv in ("", "int8")],
]
SERVE_MAX_TOKENS = 32
# Pairs of runs that read the same values in the same order (the layouts'
# kernels walk the same key tiles; the two-page body reads the per-page
# body's keys), so with the same admissions they stream the same text.
SAME_TEXT = [("mistral-contiguous-bf16", "mistral-paged-bf16-ring"),
             ("phi3-contiguous-int8", "phi3-paged-int8-ring"),
             ("paged-bf16", "llama-paged-bf16-ppb2"),
             ("paged-bf16", "llama-paged-bf16-ppb4"),
             ("paged-int8", "llama-paged-int8-ppb2"),
             ("paged-int8", "llama-paged-int8-ppb4"),
             ("mistral-paged-bf16-ppb2", "mistral-paged-bf16-ppb4"),
             ("phi3-paged-int8-ppb2", "phi3-paged-int8-ppb4"),
             ("mistral-contiguous-int8", "mistral-paged-int8-ring"),
             ("phi3-contiguous-bf16", "phi3-paged-bf16-ring"),
             ("mistral-paged-int8-ppb2", "mistral-paged-int8-ppb4")]
# The decode graphs at llama-3-8b full width on paged bf16 and int8 and
# contiguous bf16, and at mistral-7b through the paged SWA ring (int8): six
# of the eight slots prefilled (two ride along inactive), lengths inside a
# page, across pages and chunks, and (mistral-7b) past the window and the
# ring.
GRAPH_RUNS = [
    ("llama-paged-bf16", {**LLAMA, **PAGED, "prefix_cache": False,
                          "kv_quant": ""}, (40, 300, 700, 1100, 2000, 257)),
    ("llama-paged-int8", {**LLAMA, **PAGED, "prefix_cache": False,
                          "kv_quant": "int8"},
     (40, 300, 700, 1100, 2000, 257)),
    ("llama-contiguous-bf16", {**LLAMA, "kv_layout": "contiguous",
                               "kv_quant": ""},
     (40, 300, 700, 1100, 2000, 257)),
    ("mistral-paged-int8-ring", {**MISTRAL, **PAGED, "kv_quant": "int8",
                                 "kv_num_pages": 8 * MISTRAL_RING + 1},
     (1500, 4600, 5200, 24 * 256 - 16, 300, 4100)),
]
# The prefix cache at llama-3-8b full width, paged, page 256, chunk 512,
# prefix_cache at its default (the first run is LocalEngineConfig's
# defaults but for preset and layout): one cold request, then PREFIX_WARM
# warm ones, one at a time, each with the same system prompt — its shared
# tokens a little past PREFIX_TOKENS, a multiple of the chunk, the page and
# the two-page block, so every warm request is served PREFIX_TOKENS from
# the cache and prefills its ~150-token tail in one call — and a distinct
# ~100-character question. Each warm text must equal the same prompt's on
# an engine built the same with prefix_cache false.
PREFIX_TOKENS = 2048
PREFIX_SHARED_EXTRA = 40        # shared tokens past PREFIX_TOKENS
PREFIX_WARM = 4
PREFIX_MAX_TOKENS = 16
PREFIX_LLAMA = {"preset": "llama-3-8b", "kv_layout": "paged"}
PREFIX_RUNS = [("llama-prefix-bf16", PREFIX_LLAMA),
               ("llama-prefix-int8", {**PREFIX_LLAMA, "kv_quant": "int8"}),
               ("llama-prefix-bf16-ppb2", {**PREFIX_LLAMA,
                                           "kv_pages_per_block": 2})]
# The eviction run: five distinct system prompts, one request each, on a
# pool that holds four requests' indexed blocks and one free page less than
# a reservation, so the fifth admission must evict.
EVICT_PROMPTS = 5
# Aliased page tables, as the prefix cache maps them: the rows' first
# `shared_pages` pages are slot 0's (a shared 2048-token prompt), the rest
# private. Decode over slots past the shared span, one empty, one a token
# past it; prefill chunks that start at the span's end (a warm request's
# first chunk) and one a page later. llama-3-8b heads.
ALIASED = dict(H=32, KV=8, Dh=128, page=256, NP=16, shared_pages=8,
               n_stale=[2148, 2055, 2348, 2303, 4000, 2100, 0, 2049],
               starts=[2048, 2048, 2048, 2304], T=512)
# The bench phase: the port's bench tool on the card at a short setting.
BENCH_ARGS = ["--preset", "tinyllama-1.1b", "--steps", "32",
              "--ttft-probes", "3", "--eight-b", "0", "--swa", "0",
              "--long-ctx", "0", "--second-preset", "", "--ttft-target",
              "200", "--quant-rung", "1"]
FREED_BYTES_MAX = 2 ** 30
SOURCES = {"paged": "paged_attention.cu", "contiguous": "flash_attention.cu"}
REPLACES = {
    ("decode", "paged"): "llmapigateway_tpu/ops/paged_attention.py:272",
    ("prefill", "paged"): "llmapigateway_tpu/ops/paged_attention.py:438",
    ("decode", "contiguous"): "llmapigateway_tpu/ops/flash_attention.py:186",
    ("prefill", "contiguous"): "llmapigateway_tpu/ops/flash_attention.py:329",
}


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def body_smem_bytes(head_dims) -> dict:
    """Each attention body's shared memory by its layout (ptxas does not
    report the dynamic shared memory of the bodies above 48 KiB). Prefill
    (``PrefillTiles<KVT>``, csrc/prefill_mma.cuh): a BQ-row query tile (64,
    32 at HD 256) and KT-key K and V tiles (64, 32 at HD 256), rows of HD
    bf16 padded by 16 bytes; bf16 keeps a 2-stage ring of K/V tiles, int8 a 2-stage ring of
    raw tiles with their scales and one widened tile. Decode
    (``SplitSmem<R, KVT>``, csrc/decode_split.cuh) at G 16: a ring of 2-4
    stages of a raw K and V tile and its scales (aiming at 40 KiB), the
    warps' merge area over it, and per warp 8 probabilities and a rescale
    factor per row."""
    from llmapigateway_tpu_torch.ops import _kernels

    def prefill(HD, quant):
        row = HD * 2 + 16
        bq, kt = _kernels.prefill_rows(HD), _kernels.prefill_tile_keys(HD)
        if not quant:
            return bq * row + 2 * 2 * kt * row
        return bq * row + 2 * kt * row + 2 * (2 * kt * HD + 2 * kt * 4)

    def decode(HD, elem):
        stage = 2 * 32 * HD * elem + 2 * 32 * 4
        stages = 4 if 4 * stage <= 40960 else 3 if 3 * stage <= 40960 else 2
        return stages * stage + 4 * 4 * (8 + 1) * 4   # 4 warps x 4 rows
    out = {}
    for HD in head_dims:
        out[f"prefill Dh{HD} bf16"] = prefill(HD, False)
        out[f"prefill Dh{HD} int8"] = prefill(HD, True)
        out[f"decode Dh{HD} G16 bf16"] = decode(HD, 2)
        out[f"decode Dh{HD} G16 int8"] = decode(HD, 1)
    return out


def cuda_times(torch, fn, iters: int = 25, warmup: int = 3):
    """(median device ms, least host ms of one call) of ``fn`` on the
    card, L2 flushed before each run (``tools/_timing.py``: the pair of
    events brackets the device work, a device-side spin covering the host's
    enqueue; the host's time is the call's Python and enqueue)."""
    from llmapigateway_tpu_torch.tools._timing import device_times
    return device_times(fn, iters, warmup)


def cuda_ms(torch, fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device ms of ``fn`` (:func:`cuda_times`)."""
    return cuda_times(torch, fn, iters, warmup)[0]


def graph_ms(torch, fn, n: int = 100, reps: int = 5) -> float:
    """Device ms per call of ``fn``, for calls too short for one event pair
    to time: ``n`` calls captured in a CUDA graph, the graph replayed
    ``reps`` times between events, the median over ``n`` (no host work
    between the calls; L2 warm)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(torch, q, k, v, mask):
    """One library call computing the same attention (timed only)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def kv_bytes_per_key(quant: bool, KV: int, Dh: int) -> int:
    """K and V bytes of one key position: bf16 values, or int8 values plus
    one fp32 scale per head."""
    return KV * (Dh + 4 if quant else Dh * 2) * 2


def window_floor(q_pos: int, window: int) -> int:
    """The first key position the query at ``q_pos`` sees (HF semantics:
    key j visible iff q_pos - j < window; 0 = no window)."""
    return max(q_pos - (window - 1), 0) if window else 0


def variant_kw(layout: str, window: int, ppb: int) -> dict:
    kw = {"window": window}
    if layout == "paged":
        kw["pages_per_block"] = ppb
    return kw


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def quantized(torch, x):
    """A [N, KV, S, Dh] bf16 cache (or pool) → the port's int8 dict, through
    the port's own quantizer."""
    from llmapigateway_tpu_torch.models.llama import quantize_kv
    q, s = quantize_kv(x)
    return {"q": q, "s": s[:, :, None, :].contiguous()}


def _pool_and_table(torch, gen, B, KV, Dh, page, NP, live_pages, quant,
                    first_pages=None, packed=0):
    """A pool whose trash page 0 (with ``packed``, the whole trash run of
    that many pages) is filled with a large finite value, and a shuffled
    page table whose entries past each slot's live pages — and below
    ``first_pages``, as the SWA ring leaves them — are 0: a kernel that
    reads the trash page for a live key, or a dead page, shows up in the
    error. ``packed``: the table maps aligned runs of that many logical
    pages onto aligned runs of physical pages, runs shuffled, live pages
    rounded up to whole runs (the superpage allocator's table). int8: the
    pool quantized, trash at q 127, scale 1e3."""
    run = max(packed, 1)
    P = B * NP + run
    pools = []
    for _ in range(2):
        pool = torch.randn((P, KV, page, Dh), generator=gen, device="cuda"
                           ).to(torch.bfloat16)
        pool[:run] = 3e4
        if quant:
            pool = quantized(torch, pool)
            pool["q"][:run] = 127
            pool["s"][:run] = 1e3
        pools.append(pool)
    runs = torch.randperm(B * NP // run, generator=gen, device="cuda") + 1
    table = (runs.reshape(B, NP // run, 1) * run
             + torch.arange(run, device="cuda")).reshape(B, NP).to(torch.int32)
    for b, n in enumerate(live_pages):
        table[b, -(-n // run) * run:] = 0
        if first_pages is not None:
            table[b, :first_pages[b]] = 0
    return pools[0], pools[1], table.contiguous()


def _cache(torch, gen, B, KV, S, Dh, quant):
    """A contiguous cache layer [B, KV, S, Dh] of random values: positions
    past a row's live keys, and below its window, hold values too, so a
    kernel that reads them shows up in the error."""
    c = torch.randn((B, KV, S, Dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    return quantized(torch, c) if quant else c


def _fp32(args):
    """The plain versions' inputs: the same values, floats in fp32 (int8
    dicts as they are)."""
    return tuple(a.float() if hasattr(a, "is_floating_point")
                 and a.is_floating_point() else a for a in args)


def held(torch, name: str, got, ref) -> dict:
    """Hold a kernel's bf16 output to its plain version's fp32 output, per
    element (KERNEL_RTOL, KERNEL_ATOL)."""
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got.float() - ref).abs()
    ratio = diff / (KERNEL_RTOL * ref.abs() + KERNEL_ATOL)
    return {"max_abs_err": diff.max().item(),
            "max_err_over_tol": ratio.max().item()}


def decode_inputs(torch, gen, layout, quant, B, H, KV, n_list, Dh=128,
                  page=256, NP=16, S=4096, window=0, packed=0):
    """The wrapper's positional args of one decode case: q, k_new, v_new,
    the cache (a page pool and its table, or a contiguous layer), n_stale.
    A windowed paged case maps no page wholly below a slot's window (the
    ring's table); a packed one keeps every run up to the live pages."""
    if layout == "paged":
        live = [-(-n // page) for n in n_list]
        first = (None if packed or not window else
                 [window_floor(n, window) // page for n in n_list])
        k, v, table = _pool_and_table(torch, gen, B, KV, Dh, page, NP, live,
                                      quant, first, packed)
        cache = (k, v, table)
    else:
        cache = (_cache(torch, gen, B, KV, S, Dh, quant),
                 _cache(torch, gen, B, KV, S, Dh, quant))
    q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    k_new = torch.randn((B, KV, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    v_new = torch.randn((B, KV, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    n_stale = torch.tensor(n_list, dtype=torch.int32, device="cuda")
    return (q, k_new, v_new, *cache, n_stale)


def prefill_inputs(torch, gen, layout, quant, T, H, KV, starts, Dh=128,
                   page=256, NP=16, S=4096, window=0, packed=0):
    B = len(starts)
    if layout == "paged":
        live = [-(-(s + T) // page) for s in starts]
        first = (None if packed or not window else
                 [window_floor(s, window) // page for s in starts])
        k, v, table = _pool_and_table(torch, gen, B, KV, Dh, page, NP, live,
                                      quant, first, packed)
        cache = (k, v, table)
    else:
        cache = (_cache(torch, gen, B, KV, S, Dh, quant),
                 _cache(torch, gen, B, KV, S, Dh, quant))
    q = torch.randn((B, T, H, Dh), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return (q, *cache, start)


class Kernels:
    """The four wrappers and their plain versions, by (kind, layout)."""

    def __init__(self, pa, fa):
        self.pa, self.fa = pa, fa
        self.fn = {("decode", "paged"): pa.paged_decode_attention,
                   ("prefill", "paged"): pa.paged_prefill_attention,
                   ("decode", "contiguous"): fa.flash_decode_attention,
                   ("prefill", "contiguous"): fa.flash_prefill_attention}
        self.plain = {("decode", "paged"): pa._paged_decode_plain,
                      ("prefill", "paged"): pa._paged_prefill_plain,
                      ("decode", "contiguous"): fa._flash_decode_plain,
                      ("prefill", "contiguous"): fa._flash_prefill_plain}

    def name(self, kind, layout):
        return self.fn[(kind, layout)].__name__

    def all_wrappers(self):
        """The attention wrappers and the quantized products' wrappers
        (ops/quant_mm.py: the int8 library product and the W4A8 kernel)."""
        from llmapigateway_tpu_torch.ops import quant_mm
        return list(self.fn.values()) + [quant_mm.int8_mm, quant_mm.w4a8_mm]

    def call(self, kind, layout, args, window=0, ppb=1):
        return self.fn[(kind, layout)](*args, **variant_kw(layout, window,
                                                           ppb))

    def launched_split(self, layout, window, ppb, quant, Dh, G) -> dict:
        """The key split and workspace bytes the decode wrapper recorded
        for its latest launch of this body at this head geometry."""
        from llmapigateway_tpu_torch.ops.flash_attention import body_name
        return self.fn[("decode", layout)].body_splits[
            body_name(window, ppb, quant, Dh, G)]

    def call_plain(self, kind, layout, args, window=0):
        """The plain version on the same args (fp32 floats); the contiguous
        ones take ``rows`` before the window."""
        fn = self.plain[(kind, layout)]
        if layout == "paged":
            return fn(*args, window)
        return fn(*args, None, window)


def _dense_view(ks, layout, side, table, S):
    """The bf16 dense [B, KV, S, Dh] view of one cache side (SDPA input)."""
    if layout == "paged":
        return ks.pa.gather_pages(side, table, S)
    return side[:, :, :S]


def row_name(ks, kind, layout, quant, shape, window, ppb) -> str:
    name = (f"{ks.name(kind, layout)}{'_int8' if quant else ''}"
            f"{'_window' if window else ''}{f'_ppb{ppb}' if ppb > 1 else ''}")
    return name if shape == "llama-3-8b" else f"{name}[{shape}]"


def _timed_rows(torch, ks, kind, layout, quant, shape, args, window, ppbs,
                library_fn, n_bytes, n_flops, shape_info, tag=""):
    """Run, hold and time the body of every ``ppb`` in ``ppbs`` on the same
    inputs; a ppb > 1 body must also equal the ppb 1 body bit for bit. A
    decode row carries the key split its timed launches ran with, as the
    wrapper recorded it. Returns one result per ppb."""
    ref = ks.call_plain(kind, layout, _fp32(args), window)
    base = ks.call(kind, layout, args, window)
    torch.cuda.synchronize()
    library_ms = (cuda_ms(torch, library_fn) if library_fn is not None
                  else None)
    bound_ms, bound_by = bound(n_bytes, n_flops)
    out = []
    for ppb in ppbs:
        name = row_name(ks, kind, layout, quant, shape, window, ppb)
        got = ks.call(kind, layout, args, window, ppb)
        torch.cuda.synchronize()
        err = held(torch, f"{name}{tag}", got, ref)
        res = {"phase": "kernel", "name": name, "fn": ks.name(kind, layout),
               "kind": kind, "layout": layout, "model": shape,
               "kv": "int8" if quant else "bf16", "window": window,
               "pages_per_block": ppb, "shape": shape_info, **err,
               "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL}
        if ppb > 1:
            res["equal_to_ppb1"] = bool(torch.equal(got, base))
        ms, host_ms = cuda_times(torch, lambda: ks.call(kind, layout, args,
                                                        window, ppb))
        if kind == "decode":
            res.update(ks.launched_split(
                layout, window, ppb, quant, shape_info["Dh"],
                shape_info["H"] // shape_info["KV"]))
        res.update({
            "ms": ms, "host_ms": host_ms,
            "plain_ms": cuda_ms(torch, lambda: ks.call_plain(
                kind, layout, args, window), iters=5),
            "library_ms": library_ms,
            **({"library_none": LIBRARY_NONE} if quant else {}),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": n_bytes})
        emit(res)
        check(err["max_err_over_tol"] <= 1.0,
              f"{name}{tag} disagrees: {err}")
        check(res.get("equal_to_ppb1", True),
              f"{name}{tag}: the {ppb}-page body's output differs from the "
              f"per-page body's on a packed table")
        out.append(res)
    return out


def check_decode(torch, ks, gen, layout, quant, shape, ppbs=(1,)) -> list:
    """The decode body at ``shape``'s decode case; ``ppbs`` other than
    (1,): the multi-page bodies on a table packed for the largest."""
    d = SHAPES[shape][0]
    B, H, KV, Dh, window = d["B"], d["H"], d["KV"], d["Dh"], d["window"]
    n_list = d["n_stale"]
    args = decode_inputs(torch, gen, layout, quant, B, H, KV, n_list, Dh,
                         d["page"], d["NP"], d["S"], window,
                         packed=max(ppbs) if ppbs != (1,) else 0)
    q, k_new, v_new = args[:3]
    n_stale = args[-1]
    w0 = [window_floor(n, window) for n in n_list]
    library_fn = None
    if not quant:
        # Library yardstick: SDPA over the dense stale view + self column,
        # the window as a banded boolean mask.
        S = (max(-(-n // d["page"]) for n in n_list) * d["page"]
             if layout == "paged" else max(n_list))
        table = args[5] if layout == "paged" else None
        dk = _dense_view(ks, layout, args[3], table, S)
        dv = _dense_view(ks, layout, args[4], table, S)
        k_all = torch.cat([dk, k_new[:, :, None]], dim=2)
        v_all = torch.cat([dv, v_new[:, :, None]], dim=2)
        pos = torch.arange(S + 1, device="cuda")[None, :]
        lo = torch.tensor(w0, device="cuda")[:, None]
        mask = (((pos < n_stale[:, None]) & (pos >= lo)) | (pos == S))[
            :, None, None, :]

        def library_fn():
            return sdpa(torch, q[:, :, None], k_all, v_all, mask)
    # The keys the kernel must read: each slot's in-window stale keys.
    tokens = sum(n - lo for n, lo in zip(n_list, w0))
    index_bytes = sum(a.nbytes for a in args[5:] if hasattr(a, "nbytes"))
    out_bytes = B * H * Dh * 2
    n_bytes = (q.nbytes + k_new.nbytes + v_new.nbytes + out_bytes
               + index_bytes + tokens * kv_bytes_per_key(quant, KV, Dh))
    n_flops = B * H * (tokens / B + 1) * Dh * 4
    info = {"B": B, "H": H, "KV": KV, "Dh": Dh, "window": window,
            **({"page": d["page"], "NP": d["NP"]} if layout == "paged"
               else {"S": d["S"]}), "n_stale": n_list}
    return _timed_rows(torch, ks, "decode", layout, quant, shape, args,
                       window, ppbs, library_fn, n_bytes, n_flops, info)


def decode_rows(torch, ks, gen, smoke=None) -> list[dict]:
    """The kernel phase's timed decode rows: each shape's decode case on
    both layouts and KV types, then the multi-page bodies. ``smoke``: the
    chip_smoke module whose cases and checks run (this one; the A/B passes
    each tree's own)."""
    cs = smoke or sys.modules[__name__]
    rows = []
    for shape in cs.SHAPES:
        for layout in ("paged", "contiguous"):
            for quant in (False, True):
                rows += cs.check_decode(torch, ks, gen, layout, quant, shape)
    for shape in cs.PPB_SHAPES:
        for quant in (False, True):
            rows += cs.check_decode(torch, ks, gen, "paged", quant, shape,
                                    cs.PPBS)
    return rows


def split_edge_n_stale(split: dict, limit: int, window: int) -> list[int]:
    """0, the cache's end and each split boundary ±1 of a launch's key
    ``split``: the slot's n - base (base: its window floor's tile) at
    s·split_keys + d, d in -1, 0, 1 — below the window directly, past it
    where some floor reaches it."""
    sk, tile = split["split_keys"], 32
    ns = {0, 1, limit - 1, limit}
    for s in range(1, split["n_split"] + 1):
        for d in (-1, 0, 1):
            t = s * sk + d
            if not window or t < window:
                ns.add(t)
            rem = t - (window - 1)
            if window and 0 <= rem < tile:
                ns |= {window - 1 + tile * m + rem for m in (1, 9)}
    if window:
        ns |= {window - 1, window, window + 1, window + 2 * tile + 7}
    return sorted(x for x in ns if 0 <= x <= limit)


def check_split_edges(torch, ks, gen) -> list[dict]:
    """Every decode body (both layouts and KV types, window 0 and 700,
    pages_per_block 1/2/4 on a packed table) at the heads of
    ``SPLIT_EDGES["shapes"]``, held to its plain version with n_stale at
    every edge of its own launch's key split, ``B`` slots a launch. Not
    timed."""
    c = SPLIT_EDGES
    rows = []
    for shape in c["shapes"]:
        d = SHAPES[shape][0]
        H, KV, Dh, page, NP, S = (d["H"], d["KV"], d["Dh"], d["page"],
                                  d["NP"], d["S"])
        for layout in ("paged", "contiguous"):
            limit = NP * page if layout == "paged" else S
            for window in c["windows"]:
                for quant in (False, True):
                    for ppb in ((1, 2, 4) if layout == "paged" else (1,)):
                        def launch(n_list):
                            args = decode_inputs(
                                torch, gen, layout, quant, c["B"], H, KV,
                                n_list, Dh, page, NP, S, window,
                                packed=4 if ppb > 1 else 0)
                            got = ks.call("decode", layout, args, window, ppb)
                            return got, args, ks.launched_split(
                                layout, window, ppb, quant, Dh, H // KV)
                        # The split depends on shapes only: an empty launch
                        # shows it before the edges are chosen.
                        split = launch([0] * c["B"])[2]
                        edges = split_edge_n_stale(split, limit, window)
                        edges += [0] * (-len(edges) % c["B"])
                        tag = (f"split edges {shape} {layout} "
                               f"{'int8' if quant else 'bf16'} "
                               f"window={window} ppb={ppb}")
                        worst = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
                        for i in range(0, len(edges), c["B"]):
                            got, args, ran = launch(edges[i:i + c["B"]])
                            check(ran == split, f"{tag}: launched with {ran}, "
                                                f"edges chosen for {split}")
                            err = held(torch, tag, got, ks.call_plain(
                                "decode", layout, _fp32(args), window))
                            worst = {k: max(worst[k], err[k]) for k in worst}
                        rows.append({
                            "model": shape, "layout": layout,
                            "kv": "int8" if quant else "bf16",
                            "window": window, "pages_per_block": ppb,
                            **split, "n_stale": edges, **worst})
    emit({"phase": "split-edges", "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL,
          "B": c["B"], "cases": rows})
    for r in rows:
        check(r["max_err_over_tol"] <= 1.0,
              f"decode disagrees at a split edge: {r}")
    return rows


def check_prefill(torch, ks, gen, layout, quant, shape, T: int,
                  ppbs=(1,)) -> list:
    d = SHAPES[shape][1]
    H, KV, Dh, window = d["H"], d["KV"], d["Dh"], d["window"]
    starts = d["starts"]
    B = len(starts)
    args = prefill_inputs(torch, gen, layout, quant, T, H, KV, starts, Dh,
                          d["page"], d["NP"], d["S"], window,
                          packed=max(ppbs) if ppbs != (1,) else 0)
    q, start = args[0], args[-1]
    library_fn = None
    if not quant:
        S = max(starts) + T
        table = args[3] if layout == "paged" else None
        dk = _dense_view(ks, layout, args[1], table, S)
        dv = _dense_view(ks, layout, args[2], table, S)
        q_pos = start[:, None] + torch.arange(T, device="cuda")[None, :]
        s_pos = torch.arange(S, device="cuda")[None, None, :]
        mask = s_pos <= q_pos[:, :, None]
        if window:
            mask = mask & (s_pos > q_pos[:, :, None] - window)
        mask = mask[:, None]
        qh = q.transpose(1, 2)

        def library_fn():
            return sdpa(torch, qh, dk, dv, mask)
    # Keys the kernel must read: from the first query's window floor to the
    # chunk's end, per slot; each query t sees min(start + t + 1, window)
    # of them (QK and PV, 2 flops per multiply-add, per head).
    keys = sum(s + T - window_floor(s, window) for s in starts)
    index_bytes = sum(a.nbytes for a in args[3:] if hasattr(a, "nbytes"))
    n_bytes = (q.nbytes * 2 + index_bytes
               + keys * kv_bytes_per_key(quant, KV, Dh))
    seen = sum(min(s + t + 1, window) if window else s + t + 1
               for s in starts for t in range(T))
    n_flops = H * Dh * 4 * seen
    info = {"B": B, "T": T, "H": H, "KV": KV, "Dh": Dh, "window": window,
            **({"page": d["page"], "NP": d["NP"]} if layout == "paged"
               else {"S": d["S"]}), "start": starts}
    return _timed_rows(torch, ks, "prefill", layout, quant, shape, args,
                       window, ppbs, library_fn, n_bytes, n_flops, info,
                       tag=f" T={T}")


def check_groups(torch, ks, group_sizes, head_dims, gen) -> list[dict]:
    """Every group size (H 32 over H/G KV heads; H = G * KV for a group
    that does not divide 32) and head width the kernels are built for,
    every kernel body (paged and contiguous, bf16 and int8, decode and
    prefill, full and windowed), held to the plain versions. Not timed."""
    c = GROUP_CASES
    rows = []
    for Dh in head_dims:
        for G in group_sizes:
            KV = c["kv_for_group"].get(G, c["H"] // G)
            for layout in ("paged", "contiguous"):
                for quant in (False, True):
                    for window in c["windows"]:
                        rows.append(_group_case(torch, ks, gen, c, Dh, G, KV,
                                                layout, quant, window))
    emit({"phase": "groups", "shape": c, "rtol": KERNEL_RTOL,
          "atol": KERNEL_ATOL, "groups": rows})
    for r in rows:
        for k in ("decode", "prefill"):
            check(r[k]["max_err_over_tol"] <= 1.0,
                  f"{k} kernel disagrees at {r['layout']} {r['kv']} "
                  f"Dh={r['Dh']} G={r['G']} window={r['window']}: {r[k]}")
    return rows


def _group_case(torch, ks, gen, c, Dh, G, KV, layout, quant, window):
    H = G * KV
    dargs = decode_inputs(torch, gen, layout, quant, c["B"], H, KV,
                          c["n_stale"], Dh, window=window)
    pargs = prefill_inputs(torch, gen, layout, quant, c["T"], H, KV,
                           c["starts"], Dh, window=window)
    tag = (f"{layout} {'int8' if quant else 'bf16'} Dh={Dh} G={G} "
           f"window={window}")
    return {"Dh": Dh, "G": G, "H": H, "KV": KV, "layout": layout,
            "window": window,
            "kv": "int8" if quant else "bf16",
            "decode": held(torch, f"decode {tag}",
                           ks.call("decode", layout, dargs, window),
                           ks.call_plain("decode", layout, _fp32(dargs),
                                         window)),
            "prefill": held(torch, f"prefill {tag}",
                            ks.call("prefill", layout, pargs, window),
                            ks.call_plain("prefill", layout, _fp32(pargs),
                                          window))}


def check_insert(torch, gen, shape: str) -> dict:
    """Kernel #5 at ``INSERT_SHAPES[shape]``: ``torch.equal`` to its plain
    version (the one-hot select) and to ``index_put_`` on the same card
    tensors (a copy has no rounding), then timed beside both, the bound and
    an empty kernel on the same stream (its real floor). An 8 KB copy is
    far below what one event pair resolves, so ``ms``, ``plain_ms``,
    ``library_ms`` and ``launch_floor_ms`` are device times per call from a
    CUDA graph of 100 calls (``graph_ms``); ``single_launch_ms`` and
    ``single_floor_ms`` time one call after an L2 flush (``cuda_ms``), host
    gaps and launch latency included."""
    from llmapigateway_tpu_torch.ops import _kernels
    from llmapigateway_tpu_torch.tools import profile_insert as pi
    d = INSERT_SHAPES[shape]
    B, KV, S, Dh = d["B"], d["KV"], d["S"], d["Dh"]
    cache = torch.randn((B, KV, S, Dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    new = torch.randn((B, 1, KV, Dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    lens = [0, 1, 128, 255, 256 + 128, S // 2, S - 2, S - 1]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ref = pi.insert_onehot(cache, new, lengths)
    lib = pi.insert_index_put(cache.clone(), new, lengths)
    got = pi.insert_kernel(cache.clone(), new, lengths)
    torch.cuda.synchronize()
    name = "kv_insert" if shape == "tinyllama-1.1b" else f"kv_insert[{shape}]"
    work = cache.clone()
    n_bytes = new.nbytes + B * KV * Dh * cache.element_size() \
        + lengths.nbytes
    bound_ms, bound_by = bound(n_bytes, 0)
    res = {"phase": "kernel", "name": name, "model": shape,
           "shape": {**d, "lengths": lens},
           "equal_to_plain": bool(torch.equal(got, ref)),
           "equal_to_index_put": bool(torch.equal(got, lib)),
           "max_abs_err": (got.float() - ref.float()).abs().max().item()}

    def kernel():
        pi.insert_kernel(work, new, lengths)

    def empty():
        _kernels.launch_empty(work.device)
    res.update({
        "ms": graph_ms(torch, kernel),
        "plain_ms": graph_ms(torch, lambda: pi.insert_onehot(work, new,
                                                             lengths)),
        "library_ms": graph_ms(torch, lambda: pi.insert_index_put(
            work, new, lengths)),
        "launch_floor_ms": graph_ms(torch, empty),
        "single_launch_ms": cuda_ms(torch, kernel),
        "single_floor_ms": cuda_ms(torch, empty),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": n_bytes})
    emit(res)
    check(res["equal_to_plain"] and res["equal_to_index_put"],
          f"{name}: kernel #5 differs from its plain version or index_put_: "
          f"{res}")
    return res


def check_aliased(torch, ks, gen) -> list[dict]:
    """Kernels #1 and #2 over page tables whose rows alias the same
    physical pages (``ALIASED``: the prefix cache's shared blocks), bf16
    and int8, per-page and two-page blocks, each held to its plain version
    on the same inputs under the kernel tolerance, and timed."""
    c = ALIASED
    H, KV, Dh, page, shared = c["H"], c["KV"], c["Dh"], c["page"], \
        c["shared_pages"]

    def pool(live, quant, ppb):
        k, v, table = _pool_and_table(torch, gen, len(live), KV, Dh, page,
                                      c["NP"], live, quant,
                                      packed=ppb if ppb > 1 else 0)
        for b, n in enumerate(live):
            m = min(n, shared)
            table[b, :m] = table[0, :m]
        aliased = int((table[1:, :shared] == table[0, :shared]).all(1)
                      .sum().item())
        return k, v, table, aliased

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    rows = []
    for quant in (False, True):
        for ppb in (1, 2):
            B = len(c["n_stale"])
            k, v, table, d_alias = pool([-(-n // page) for n in c["n_stale"]],
                                        quant, ppb)
            dargs = (rnd(B, H, Dh), rnd(B, KV, Dh), rnd(B, KV, Dh), k, v,
                     table, torch.tensor(c["n_stale"], dtype=torch.int32,
                                         device="cuda"))
            starts = c["starts"]
            k, v, table, p_alias = pool(
                [-(-(s0 + c["T"]) // page) for s0 in starts], quant, ppb)
            pargs = (rnd(len(starts), c["T"], H, Dh), k, v, table,
                     torch.tensor(starts, dtype=torch.int32, device="cuda"))
            for kind, args, n_alias in (("decode", dargs, d_alias),
                                        ("prefill", pargs, p_alias)):
                name = (f"{ks.name(kind, 'paged')}{'_int8' if quant else ''}"
                        f"{f'_ppb{ppb}' if ppb > 1 else ''}[aliased]")
                got = ks.call(kind, "paged", args, 0, ppb)
                ref = ks.call_plain(kind, "paged", _fp32(args), 0)
                torch.cuda.synchronize()
                rows.append({"name": name, "kv": "int8" if quant else "bf16",
                             "pages_per_block": ppb,
                             "rows_aliasing_slot0": n_alias,
                             **held(torch, name, got, ref),
                             "ms": cuda_ms(torch, lambda: ks.call(
                                 kind, "paged", args, 0, ppb))})
    emit({"phase": "aliased", "shape": c, "rtol": KERNEL_RTOL,
          "atol": KERNEL_ATOL, "rows": rows})
    for r in rows:
        check(r["rows_aliasing_slot0"] >= 2,
              f"{r['name']}: the table aliases too few rows: {r}")
        check(r["max_err_over_tol"] <= 1.0,
              f"{r['name']} disagrees over an aliased table: {r}")
    return rows


def prefill_rows(torch, ks, gen, smoke=None) -> list[dict]:
    """The kernel phase's timed prefill rows: each shape's prefill case at
    each of its chunk lengths (this file's ``SHAPES``) on both layouts and
    KV types, then the multi-page bodies. ``smoke``: the chip_smoke module
    whose checks and case inputs run (this one; the A/B passes each tree's
    own, so every tree runs the same chunk lengths)."""
    cs = smoke or sys.modules[__name__]
    rows = []
    for shape in SHAPES:
        for layout in ("paged", "contiguous"):
            for quant in (False, True):
                for T in SHAPES[shape][1]["T"]:
                    rows += cs.check_prefill(torch, ks, gen, layout, quant,
                                             shape, T)
    for shape in PPB_SHAPES:
        for quant in (False, True):
            rows += cs.check_prefill(torch, ks, gen, "paged", quant, shape,
                                     SHAPES[shape][1]["T"][0], PPBS)
    return rows


def kernel_phase(torch, ks, gen) -> list[dict]:
    """Phase 3: every kernel body at the main path's shapes — full
    attention, both window shapes, the multi-page bodies; the decode rows
    first — then every group size and head width, then the decode bodies
    at their split edges, then #1 and #2 over aliased page tables. Returns
    the timed rows."""
    rows = decode_rows(torch, ks, gen)
    rows += prefill_rows(torch, ks, gen)
    from llmapigateway_tpu_torch.ops import _kernels
    check_groups(torch, ks, _kernels.GROUP_SIZES, _kernels.HEAD_DIMS, gen)
    check_split_edges(torch, ks, gen)
    check_aliased(torch, ks, gen)
    return rows


# ---------------------------------------------------------------------------
# Phase 4: small models of the main path's head geometry, card vs CPU
# ---------------------------------------------------------------------------

def check_model(torch) -> dict:
    from llmapigateway_tpu_torch.models.config import ModelConfig
    from llmapigateway_tpu_torch.models.llama import (KVCache, forward,
                                                      init_params)
    from llmapigateway_tpu_torch.ops.flash_attention import (
        make_cache_attention_fn)
    from llmapigateway_tpu_torch.ops.paged_attention import (
        PagedKVCache, make_paged_attention_fn)

    base = dict(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                n_kv_heads=1, d_ff=1024, rope_theta=500000.0,
                max_seq_len=1024)                       # Dh 128, G 4
    # (tag, config, page, pool pages, table, pages_per_block): the full-
    # attention model over 256-token pages (PRs 1-2); tiny-mistral-test's
    # window (16) at the kernels' head width over 16-token pages, so a
    # window and a key tile straddle pages; the full model on a pool packed
    # in runs of two pages read by the two-page body. A window of 16 needs
    # no ring here: the table maps every page.
    windowed = ModelConfig(**base, sliding_window=16)
    gen = torch.Generator(device="cpu").manual_seed(1)
    perm16 = (torch.randperm(2 * 20, generator=gen) + 1).reshape(2, 20)
    models = [
        ("", ModelConfig(**base), 256, 9,
         torch.tensor([[3, 7, 0, 0], [5, 2, 8, 0]]), 1),
        ("window16-", windowed, 16, 41, perm16, 1),
        ("ppb2-", ModelConfig(**base), 256, 10,
         torch.tensor([[4, 5, 0, 0], [8, 9, 2, 3]]), 2),
    ]
    B = 2
    prompt = torch.randint(0, 512, (B, 300), generator=gen)
    # Fixed decode inputs: both runs must see the same tokens.
    steps = torch.randint(0, 512, (4, B), generator=gen)

    def run(cfg, params_cpu, device, dtype, layout, kv_quant, page, P, table,
            ppb):
        params = {k: ({n: w.to(device, dtype) for n, w in v.items()}
                      if isinstance(v, dict) else v.to(device, dtype))
                  for k, v in params_cpu.items()}
        window = cfg.sliding_window
        if layout == "paged":
            cache = PagedKVCache.create(cfg, P, page, dtype, kv_quant,
                                        device=device)
            attn = make_paged_attention_fn(table.to(device, torch.int32),
                                           window, ppb)
        else:
            cache = KVCache.create(cfg, B, 1024, dtype, kv_quant,
                                   device=device)
            attn = make_cache_attention_fn(window=window)
        lengths = torch.zeros(B, dtype=torch.int32, device=device)
        logits, cache = forward(params, cfg, prompt.to(device), lengths,
                                cache, attention_fn=attn)
        outs = [logits[:, -1]]
        lengths = lengths + prompt.shape[1]
        active = torch.ones(B, dtype=torch.bool, device=device)
        for tok in steps.to(device):
            logits, cache = forward(params, cfg, tok[:, None], lengths, cache,
                                    attention_fn=attn, active=active)
            outs.append(logits[:, 0])
            lengths = lengths + 1
        return torch.stack(outs).float().cpu()

    rels = {}
    with torch.no_grad():
        for prefix, cfg, page, P, table, ppb in models:
            params_cpu = init_params(cfg, torch.Generator().manual_seed(1),
                                     dtype=torch.bfloat16)
            layouts = ("paged",) if ppb > 1 else ("paged", "contiguous")
            quants = ("",) if ppb > 1 else ("", "int8")
            for layout in layouts:
                for kv_quant in quants:
                    spec = (page, P, table, ppb)
                    got = run(cfg, params_cpu, "cuda", torch.bfloat16,
                              layout, kv_quant, *spec)
                    ref = run(cfg, params_cpu, "cpu", torch.float32, layout,
                              kv_quant, *spec)
                    tag = f"{prefix}{layout}-{kv_quant or 'bf16'}"
                    check(bool(torch.isfinite(got).all()),
                          f"model {tag}: non-finite logits")
                    check(got.shape == ref.shape == (5, B, cfg.vocab_size),
                          f"model {tag}: logits shape {tuple(got.shape)}")
                    rels[tag] = ((got - ref).abs().max()
                                 / ref.abs().max()).item()
    head = check_head(torch)
    res = {"phase": "model", "layers": 2, "prompt": 300, "decode_steps": 4,
           "max_rel_err": rels, "tol": MODEL_REL_TOL, "head": head}
    emit(res)
    for tag, rel in rels.items():
        check(rel <= MODEL_REL_TOL, f"model logits disagree ({tag}): {rel}")
    check(head["dtype"] == "torch.float32"
          and head["max_rel_err"] <= HEAD_REL_TOL,
          f"LM head logits are not an fp32 product: {head}")
    return res


def check_head(torch) -> dict:
    """The LM head at llama-3-8b's shape on the card: bf16 hidden states and
    weights give fp32 logits equal to the fp32 product of the same values
    (no bf16 rounding of the logits)."""
    from llmapigateway_tpu_torch.models.config import get_preset
    from llmapigateway_tpu_torch.models.llama import head_logits

    cfg = get_preset("llama-3-8b")
    gen = torch.Generator(device="cuda").manual_seed(2)
    w = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                     device="cuda") * 0.02).to(torch.bfloat16)
    x = torch.randn((8, cfg.d_model), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    got = head_logits({"lm_head": w, "embed": w}, cfg, x)
    ref = x.float() @ w.float().T
    rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
    return {"shape": [8, cfg.d_model, cfg.vocab_size], "dtype": str(got.dtype),
            "max_rel_err": rel, "tol": HEAD_REL_TOL}


# ---------------------------------------------------------------------------
# Phase 5: the decode graphs, replay against eager, at full width
# ---------------------------------------------------------------------------

def _kv_leaves(cache) -> list:
    """Every tensor of a KV cache (values, and int8 scales)."""
    out = []
    for side in (cache.k, cache.v):
        out += [side["q"], side["s"]] if isinstance(side, dict) else [side]
    return out


def _decode_state(engine) -> list:
    """The tensors a decode burst reads or writes: the static buffers, the
    penalty counts and the KV cache."""
    return [engine._d_tokens, engine._d_lengths, engine._d_active,
            *engine._d_samp, engine._d_counts, *_kv_leaves(engine.cache)]


def _graph_fill(engine, prompt_tokens) -> list:
    """Prefill one slot per prompt length (random tokens from a seed)
    through the engine's own chunk path, the SWA ring mapped per chunk as
    the scheduler maps it; the slots are then decoding, greedy."""
    import numpy as np

    from llmapigateway_tpu_torch.engine.engine import GenRequest
    rng = np.random.default_rng(5)
    reqs = []
    for slot, n in enumerate(prompt_tokens):
        req = GenRequest(prompt_ids=rng.integers(
            2, engine.model_cfg.vocab_size, n).tolist(), max_tokens=64)
        req.slot = slot
        if engine.allocator is not None:
            engine.allocator.allocate(slot, n + 64,
                                      ring_pages=engine._swa_ring_pages)
            engine._table_dirty = True
        while req.prefill_pos < n:
            if engine._swa_ring_pages:
                engine._swa_map_chunks([req])
            engine._prefill_chunk_group([req])
        reqs.append(req)
    return reqs


def traced_kernels(torch, fn) -> dict:
    """The kernels the card ran while ``fn`` ran, by name, as the profiler
    (CUPTI) records them: a graph replay's kernels one by one."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def replay_launches(torch, engine, n: int, greedy: bool) -> dict:
    """One replay of the (n, greedy) graph under the profiler: per attention
    kernel and the decode combine, the launches it traced beside the
    launches its capture recorded (what every replay adds to the wrappers'
    counters; a combine follows each split launch)."""
    delta = engine._graphs.graphs[(n, greedy)][2]
    recorded = {"decode_combine_kernel": 0}
    for wrapper, (k, bodies, splits) in delta.items():
        if wrapper == "w4a8_mm":
            recorded["w4a8_kernel"] = k
        if not wrapper.endswith("_attention"):
            continue        # the int8 product's cuBLAS kernels vary by name
        recorded[wrapper.replace("_attention", "_kernel")] = k
        recorded["decode_combine_kernel"] += sum(
            c for body, c in bodies.items() if splits[body]["n_split"] > 1)
    seen = traced_kernels(torch, lambda: engine._graphs.replay(n, greedy))
    traced = {name: sum(c for kname, c in seen.items() if name in kname)
              for name in recorded}
    return {"traced": traced, "recorded": recorded,
            "kernels_traced": sum(seen.values())}


def _graph_check(torch, tag: str, engine_cfg: dict, prompt_tokens) -> dict:
    """From one device state: a greedy burst replayed by its graph and the
    same burst run eagerly give equal tokens and equal KV; the sampled
    graph replayed twice from one generator state gives equal tokens, each
    inside the plain sampler's candidate set along the replayed tokens; one
    greedy replay traced by the profiler launched the attention and combine
    kernels its capture recorded (n_layers x depth decode launches)."""
    import numpy as np

    from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
    from llmapigateway_tpu_torch.engine.engine import InferenceEngine
    from llmapigateway_tpu_torch.engine.sampling import (apply_penalties,
                                                         candidate_logits)
    t0 = time.monotonic()
    engine = InferenceEngine(LocalEngineConfig(**engine_cfg), device="cuda")
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    n = engine.decode_burst
    captured = sorted(engine._graphs.graphs)
    check(captured == sorted((d, g) for d in engine._burst_depths if d > 1
                             for g in (True, False)),
          f"graphs {tag}: captured {captured} for depths "
          f"{engine._burst_depths}")
    with torch.no_grad():
        reqs = _graph_fill(engine, prompt_tokens)
        engine._upload_slot_state()
        if engine._swa_ring_pages:
            engine._swa_rotate(reqs, n)
        if engine.paged:
            engine._device_table()
        torch.cuda.synchronize()
        state0 = [t.clone() for t in _decode_state(engine)]

        def restore():
            for dst, src in zip(_decode_state(engine), state0):
                dst.copy_(src)

        replayed = engine._graphs.replay(n, True).clone()
        after_graph = [t.clone() for t in _decode_state(engine)]
        restore()
        eager = engine._decode_body(n, True).clone()
        after_eager = _decode_state(engine)
        greedy_equal = torch.equal(replayed, eager)
        state_equal = all(torch.equal(a, b)
                          for a, b in zip(after_graph, after_eager))
        del after_graph, after_eager

        # The sampled variant: temperature, top-k and top-p on live slots.
        live = np.zeros(engine.B, bool)
        live[:len(reqs)] = True
        engine.samp_temperature[live] = 0.8
        engine.samp_top_k[live] = 40
        engine.samp_top_p[live] = 0.9
        engine._upload_slot_state()
        state0[3:8] = [t.clone() for t in engine._d_samp]
        restore()
        rng_state = engine._rng.get_state()
        first = engine._graphs.replay(n, False).clone()
        restore()
        engine._rng.set_state(rng_state)
        second = engine._graphs.replay(n, False).clone()
        restore()
        engine._rng.set_state(rng_state)
        sampled_eager = engine._decode_body(n, False).clone()
        # Teacher-forced through the replayed tokens: each drawn token has
        # a finite candidate logit in the plain sampler.
        restore()
        in_set = True
        tokens, lengths = engine._d_tokens.clone(), engine._d_lengths.clone()
        active = engine._d_active
        attn = engine._decode_attention()
        for i in range(n):
            logits, _ = engine._forward(
                engine.params, engine.model_cfg, tokens[:, None], lengths,
                engine.cache, attention_fn=attn, active=active)
            cand = candidate_logits(apply_penalties(
                logits[:, 0, :], engine._d_counts, engine._d_samp),
                engine._d_samp)
            picked = cand.gather(1, first[i][:, None])[:, 0]
            in_set &= bool(torch.isfinite(picked[:len(reqs)]).all())
            tokens = first[i]
            lengths = torch.where(active, lengths + 1, lengths)
        restore()
        launches = replay_launches(torch, engine, n, True)
        decode_k = ("paged" if engine.paged else "flash") + "_decode_kernel"
        torch.cuda.synchronize()
    res = {"phase": "graphs", "config": tag, "engine": engine_cfg,
           "layers": engine.model_cfg.n_layers, "depths":
           list(engine._burst_depths), "captured": len(captured),
           "build_with_capture_s": build_s, "depth": n,
           "slots": len(reqs), "prompt_tokens": list(prompt_tokens),
           "swa_ring_pages": engine._swa_ring_pages,
           "greedy_replay_equals_eager": greedy_equal,
           "kv_and_buffers_equal": state_equal,
           "sampled_replays_equal": torch.equal(first, second),
           "sampled_in_candidate_set": in_set,
           "sampled_replay_equals_eager": torch.equal(first, sampled_eager),
           "replay_launches": launches,
           "note": "sampled_replay_equals_eager is information only"}
    del engine, state0
    emit(res)
    check(greedy_equal, f"graphs {tag}: greedy replay and eager tokens "
                        f"differ")
    check(state_equal, f"graphs {tag}: KV or buffers differ after replay "
                       f"and eager run")
    check(res["sampled_replays_equal"],
          f"graphs {tag}: two sampled replays from one generator state "
          f"differ")
    check(in_set, f"graphs {tag}: a sampled token outside the plain "
                  f"sampler's candidate set")
    check(launches["traced"] == launches["recorded"]
          and launches["recorded"][decode_k] == res["layers"] * n,
          f"graphs {tag}: one traced replay launched {launches['traced']}, "
          f"its capture recorded {launches['recorded']} ({res['layers']} "
          f"layers x depth {n})")
    return res


def graphs_phase(torch) -> dict:
    """GRAPH_RUNS in turn, one engine on the card at a time."""
    out = {}
    for tag, engine_cfg, prompt_tokens in GRAPH_RUNS:
        t0 = time.monotonic()
        out[tag] = _graph_check(torch, tag, engine_cfg, prompt_tokens)
        _freed(torch, f"graphs {tag}", t0)
    return out


# ---------------------------------------------------------------------------
# Phase 6: the engine-driving tools at tinyllama-1.1b width and depth
# ---------------------------------------------------------------------------

def tools_phase(torch, ks) -> dict:
    """The three ported tools with their default flags (tinyllama-1.1b, 22
    layers, d_model 2048, on the card): every insert variant, kernel #5's
    launches counted (2 per layer per step of its burst runs) and its final
    caches ``torch.equal`` to the index_put variant's; the decode ablation
    with the kernels' attention (kernel #3 once per layer per step); the
    engine's bursts on both layouts (their decode kernels only)."""
    from llmapigateway_tpu_torch.models.config import get_preset
    from llmapigateway_tpu_torch.ops.flash_attention import (body_name,
                                                            reset_launches)
    from llmapigateway_tpu_torch.tools import (profile_decode,
                                               profile_engine_burst,
                                               profile_insert)
    cfg = get_preset("tinyllama-1.1b")
    L = cfg.n_layers
    out = {}

    reset_launches(profile_insert.insert_kernel)
    ins = profile_insert.main([])
    launches = profile_insert.insert_kernel.launches
    out["profile_insert"] = {**ins, "kernel_launches": launches}
    want = 2 * ins["dims"]["layers"] * ins["steps"].get("cuda", 0)
    check(set(ins["ms_per_step"]) == {"index_put", "onehot", "cuda",
                                      "stacked"},
          f"profile_insert: variants {sorted(ins['ms_per_step'])}")
    check(launches == want > 0,
          f"profile_insert: kernel #5 launched {launches} times, expected "
          f"2 x {ins['dims']['layers']} layers x {ins['steps'].get('cuda')} "
          f"steps = {want}")
    check(ins.get("cuda_equals_index_put") is True,
          "profile_insert: the cuda burst's caches differ from index_put's")

    for fn in ks.all_wrappers():
        reset_launches(fn)
    dec = profile_decode.main(["--kernels"])
    steps = 32 * (1 + 3)             # default --burst 32: warm-up + 3 reps
    flash = ks.fn[("decode", "contiguous")]
    out["profile_decode"] = {"ms_per_step": dec,
                             "flash_decode_launches": flash.launches}
    body = body_name(0, 1, False, cfg.head_dim,
                     cfg.n_heads // cfg.n_kv_heads)
    check(flash.body_launches == {body: L * steps},
          f"profile_decode --kernels: kernel #3 ran "
          f"{flash.body_launches}, expected {{{body!r}: {L * steps}}}")

    for kv, layout in (("contiguous", "contiguous"), ("paged", "paged")):
        for fn in ks.all_wrappers():
            reset_launches(fn)
        res = profile_engine_burst.main(["--kv", kv])
        launches = {fn.__name__: fn.launches for fn in ks.all_wrappers()}
        out[f"profile_engine_burst[{kv}]"] = {**res, "launches": launches}
        decode_k = ks.name("decode", layout)
        want = L * (res["decode_steps"] + res["raw_steps"])
        check(launches[decode_k] == want,
              f"profile_engine_burst --kv {kv}: {decode_k} ran "
              f"{launches[decode_k]} times, expected {want} "
              f"({res['decode_steps']} engine + {res['raw_steps']} raw "
              f"steps, x {L} layers)")
        other = "paged" if layout == "contiguous" else "contiguous"
        check(all(launches[ks.name(k, other)] == 0
                  for k in ("decode", "prefill")),
              f"profile_engine_burst --kv {kv}: the {other} kernels ran "
              f"{launches}")
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "tools", **out})
    return out


# ---------------------------------------------------------------------------
# Phase 7: serve /v1/chat/completions at full width, per configuration
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Gateway:
    """The port's app on a local port with one local provider per entry of
    ``engines`` (name → engine config) and a rule ``gw/<name>`` for each;
    ``provider(name)`` builds and returns its provider."""

    def __init__(self, engines: dict):
        self.engines = engines

    async def __aenter__(self):
        from aiohttp import web

        from llmapigateway_tpu_torch.config.loader import ConfigLoader
        from llmapigateway_tpu_torch.config.settings import Settings
        from llmapigateway_tpu_torch.providers.local import (
            make_local_provider)
        from llmapigateway_tpu_torch.server.app import build_app
        self._dir = tempfile.TemporaryDirectory()
        d = self._dir.name
        with open(os.path.join(d, "providers.json"), "w") as f:
            json.dump([{name: {"type": "local", "engine": cfg}}
                       for name, cfg in self.engines.items()], f)
        with open(os.path.join(d, "models_fallback_rules.json"), "w") as f:
            json.dump([{"gateway_model_name": f"gw/{name}",
                        "fallback_models": [{"provider": name,
                                             "model": cfg["preset"]}]}
                       for name, cfg in self.engines.items()], f)
        first = next(iter(self.engines))
        self.app = build_app(
            Settings(fallback_provider=first, config_dir=d,
                     db_dir=os.path.join(d, "db")),
            loader=ConfigLoader(d, first),
            local_factory=functools.partial(make_local_provider,
                                            device="cuda"))
        self.runner = web.AppRunner(self.app)
        await self.runner.setup()
        self.port = _free_port()
        await web.TCPSite(self.runner, "127.0.0.1", self.port).start()
        return self

    async def provider(self, name: str):
        provider = await self.app["gateway"].registry.get(name)
        check(provider is not None, f"provider {name} did not build")
        return provider

    async def __aexit__(self, *exc):
        await self.runner.cleanup()
        self._dir.cleanup()
        self.app = self.runner = None


async def _chat(session, port: int, what: str, body: dict) -> dict:
    """POST one chat completion (JSON, or SSE when ``body["stream"]``);
    its usage block, text and finish reason."""
    async with session.post(f"http://127.0.0.1:{port}/v1/chat/completions",
                            json=body) as resp:
        if resp.status != 200:
            raise SmokeFailure(f"{what}: HTTP {resp.status}: "
                               f"{await resp.text()}")
        if not body["stream"]:
            out = await resp.json()
            return {"usage": out["usage"],
                    "text": out["choices"][0]["message"]["content"],
                    "finish": out["choices"][0]["finish_reason"]}
        from llmapigateway_tpu_torch.utils.sse import SSEParser
        parser, frames = SSEParser(), []
        async for chunk in resp.content.iter_any():
            frames.extend(parser.feed(chunk))
        check(bool(frames) and frames[-1].is_done,
              f"{what}: SSE stream did not end in [DONE]: "
              f"{[fr.data[:200] for fr in frames[-2:]]}")
        usage = [fr.json["usage"] for fr in frames
                 if fr.json and "usage" in fr.json]
        choices = [fr.json["choices"][0] for fr in frames
                   if fr.json and fr.json.get("choices")]
        text = "".join(c["delta"].get("content") or "" for c in choices)
        finish = [c["finish_reason"] for c in choices
                  if c.get("finish_reason")]
        check(len(usage) == 1, f"{what}: SSE usage frame missing")
        return {"usage": usage[0], "text": text,
                "finish": finish[-1] if finish else None}


def _gate_first_step(engine, n_requests: int) -> None:
    """Hold the engine's first scheduler step until all ``n_requests`` are
    queued (30 s at most), so every run admits the same requests in one
    step: the prefill groups, and with them cuBLAS's GEMM shapes, are then
    the same in runs that must stream the same text."""
    first = engine._step

    async def gated():
        t_end = time.monotonic() + 30
        while (engine._queue.qsize() < n_requests
               and time.monotonic() < t_end):
            await asyncio.sleep(0.005)
        engine._step = first
        return await first()
    engine._step = gated


def _watch_ring(engine) -> dict:
    """Record the ring on a paged engine: the most pages any table row ever
    maps, and how often rotation changed the table before a prefill chunk
    and before a decode burst."""
    import numpy as np
    alloc = engine.allocator
    seen = {"max_row_pages": 0, "prefill_rotations": 0,
            "decode_rotations": 0}

    def note():
        seen["max_row_pages"] = max(seen["max_row_pages"], int(
            np.count_nonzero(alloc.table, axis=1).max()))

    def wrap(obj, attr, after):
        orig = getattr(obj, attr)

        def wrapped(*a, **kw):
            before = alloc.table.copy()
            out = orig(*a, **kw)
            after(before)
            return out
        setattr(obj, attr, wrapped)

    wrap(alloc, "allocate", lambda _: note())
    wrap(alloc, "ensure_mapped", lambda _: note())
    for attr, key in (("_swa_map_chunks", "prefill_rotations"),
                      ("_swa_rotate", "decode_rotations")):
        wrap(engine, attr, lambda before, key=key: seen.__setitem__(
            key, seen[key] + int((alloc.table != before).any())))
    return seen


async def _serve(torch, ks, card: str, tag: str, engine_cfg: dict,
                 prompt_spec) -> dict:
    import aiohttp

    from llmapigateway_tpu_torch.ops.flash_attention import (body_name,
                                                            reset_launches)

    layout = engine_cfg["kv_layout"]
    async with _Gateway({"local": engine_cfg}) as gw:
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        provider = await gw.provider("local")
        engine = provider.engine
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        weights = quant_weights(torch, engine) if engine.quant else None
        n_layers = engine.model_cfg.n_layers
        window = engine.model_cfg.sliding_window
        cache_kind = (f"{type(engine.cache).__name__}"
                      f"{'[int8]' if isinstance(engine.cache.k, dict) else ''}")

        words = ("the quick brown fox jumps over the lazy dog while "
                 "paged attention streams every live key once ")
        unit, lengths = prompt_spec
        if unit == "tokens":
            # Bytes for the wanted prompt lengths, less the chat
            # template's and the tokenizer's own tokens.
            overhead = len(provider._build_genrequest({"messages": [
                {"role": "user", "content": ""}]}).prompt_ids)
            lengths = [n - overhead for n in lengths]
        prompts = [(words * (n // len(words) + 1))[:n] for n in lengths]
        streams = [True, False, True, False]

        async def one(session, text, stream):
            body = {"model": "gw/local", "temperature": 0,
                    "max_tokens": SERVE_MAX_TOKENS, "stream": stream,
                    "messages": [{"role": "user", "content": text}]}
            return await _chat(session, gw.port, f"serve {tag}", body)

        ring = _watch_ring(engine) if engine.paged else None
        _gate_first_step(engine, len(prompts))
        # Zero every launch count just before driving the main path.
        for fn in ks.all_wrappers():
            reset_launches(fn)
        engine.decode_steps = engine.prefill_calls = 0
        engine.prefill_one_token_calls = 0
        engine.prefill_shapes.clear()
        _reset_pipeline(engine)
        t1 = time.monotonic()
        async with aiohttp.ClientSession() as session:
            results = await asyncio.gather(*[
                one(session, p, s) for p, s in zip(prompts, streams)])
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t1
        launches = {fn.__name__: fn.launches for fn in ks.all_wrappers()}
        bodies = {fn.__name__: dict(fn.body_launches)
                  for fn in ks.all_wrappers()}
        steps = {"decode_steps": engine.decode_steps,
                 "prefill_calls": engine.prefill_calls,
                 "prefill_one_token_calls":
                 engine.prefill_one_token_calls}
        shapes = dict(engine.prefill_shapes)
        pipeline = _pipeline(engine)
        mc = engine.model_cfg
        geometry = {"kv_ppb": engine.kv_ppb,
                    "swa_ring_pages": engine._swa_ring_pages,
                    "window": window, "head_dim": mc.head_dim,
                    "group": mc.n_heads // mc.n_kv_heads}
        if engine.paged:
            alloc = engine.allocator
            alloc.check_invariants()
            geometry.update(
                pages_per_slot=alloc.pages_per_slot,
                num_pages=alloc.num_pages,
                free_pages_after=alloc.free_pages,
                free_pages_expected=alloc.num_pages - engine.kv_ppb,
                **ring)
    del provider, engine, gw

    usages = [r["usage"] for r in results]
    for r in results:
        u = r["usage"]
        # Greedy on random weights: every request runs to max_tokens unless
        # it samples an end-of-sequence token.
        check(u["completion_tokens"] > 0
              and (u["completion_tokens"] == SERVE_MAX_TOKENS
                   or r["finish"] == "stop"),
              f"serve {tag}: unexpected completion {u} ({r['finish']})")
    if unit == "tokens":
        check([u["prompt_tokens"] for u in usages] == list(prompt_spec[1]),
              f"serve {tag}: prompt tokens {[u['prompt_tokens'] for u in usages]}"
              f" != {list(prompt_spec[1])}")
    body = body_name(window, geometry["kv_ppb"],
                     engine_cfg["kv_quant"] == "int8", geometry["head_dim"],
                     geometry["group"])
    check_launches(ks, f"serve {tag}", layout, body, n_layers, steps,
                   launches, bodies)
    check_pipeline(f"serve {tag}", pipeline)
    forms = None
    if weights is not None:
        forms = check_quant_run(f"serve {tag}", mc, weights, steps, shapes,
                                launches, bodies)
    ppb_req = engine_cfg.get("kv_pages_per_block", 1)
    if layout == "paged":
        check(geometry["kv_ppb"] == (1 if geometry["swa_ring_pages"]
                                     else ppb_req),
              f"serve {tag}: kv_ppb {geometry['kv_ppb']} (asked {ppb_req})")
        check(geometry["free_pages_after"] == geometry["free_pages_expected"],
              f"serve {tag}: pages not returned: {geometry}")
    if tag.endswith("-ring"):
        g = geometry
        check(0 < g["swa_ring_pages"] < g["pages_per_slot"],
              f"serve {tag}: the SWA ring did not engage: {g}")
        check(g["max_row_pages"] <= g["swa_ring_pages"],
              f"serve {tag}: a slot held more than the ring: {g}")
        check(g["prefill_rotations"] > 0 and g["decode_rotations"] > 0,
              f"serve {tag}: the ring did not rotate in prefill and in "
              f"decode: {g}")
    res = {"phase": "serve", "config": tag, "card": card,
           "engine": engine_cfg, "layers": n_layers, "cache": cache_kind,
           "geometry": geometry, "requests": len(results),
           "sse": sum(streams),
           "prompt_tokens": [u["prompt_tokens"] for u in usages],
           "completion_tokens": [u["completion_tokens"] for u in usages],
           "finish": [r["finish"] for r in results],
           "ttft_ms": [u.get("ttft_ms") for u in usages],
           "decode_tok_per_s": [u.get("tokens_per_sec") for u in usages],
           "engine_build_s": build_s, "wall_s": wall_s,
           "launches": launches, "body_launches": bodies, **steps,
           "pipeline": pipeline, "weights": weights,
           "prefill_shapes": [[*k, n] for k, n in sorted(shapes.items())],
           "mlp_forms": forms,
           "note": "TTFT and tok/s are information only"}
    emit(res)
    res["texts"] = [r["text"] for r in results]
    return res


def _reset_pipeline(engine) -> None:
    """Zero the engine's graph replays, synchronous bursts and flushes."""
    engine.sync_bursts = engine.flushes = 0
    engine._graphs.replays = 0


def _pipeline(engine) -> dict:
    """Graphs captured, and since the reset: replays, synchronous bursts,
    early flushes of a burst in flight."""
    st = engine.stats()
    return {k: st[k] for k in ("graphs_captured", "graph_replays",
                               "sync_bursts", "flushes")}


def check_pipeline(what: str, pipeline: dict) -> None:
    """The run's full-depth bursts were graph replays."""
    check(pipeline["graphs_captured"] > 0 and pipeline["graph_replays"] > 0,
          f"{what}: no decode graph replayed on the main path: {pipeline}")


def check_launches(ks, what: str, layout: str, body: str, n_layers: int,
                   steps: dict, launches: dict, bodies: dict) -> None:
    """The layout's kernels ran ``body`` once per layer per forward of
    their kind in the counted run, and the other layout's kernels not at
    all. A prefill call one token wide runs the decode kernel (the
    forward's T == 1 path); every other prefill call runs the prefill
    kernel."""
    decode_k = ks.name("decode", layout)
    prefill_k = ks.name("prefill", layout)
    other = "contiguous" if layout == "paged" else "paged"
    check(launches[decode_k] > 0,
          f"{what}: the decode kernel never ran on the main path")
    check(launches[prefill_k] > 0,
          f"{what}: the prefill kernel never ran on the main path")
    one_tok = steps["prefill_one_token_calls"]
    want = {decode_k: n_layers * (steps["decode_steps"] + one_tok),
            prefill_k: n_layers * (steps["prefill_calls"] - one_tok)}
    for name, n in want.items():
        check(bodies[name] == {body: n},
              f"{what}: {name} ran {bodies[name]}, expected "
              f"{{{body!r}: {n}}} ({n_layers} layers x {steps})")
    for kind in ("decode", "prefill"):
        name = ks.name(kind, other)
        check(launches[name] == 0,
              f"{what}: the {other} layout's kernel {name} ran "
              f"{launches[name]} times")


def serve_phase(torch, ks, card: str) -> dict:
    """Phase 5: each served configuration in turn; the card holds one
    engine at a time."""
    out = {}
    for tag, engine_cfg, prompt_spec in SERVE_RUNS:
        t0 = time.monotonic()
        out[tag] = asyncio.run(_serve(torch, ks, card, tag, engine_cfg,
                                      prompt_spec))
        _freed(torch, tag, t0)
    same = {f"{a}=={b}": out[a]["texts"] == out[b]["texts"]
            for a, b in SAME_TEXT}
    # Information: the llama layouts read the same values in the same order
    # too, but their text is not required to agree.
    emit({"phase": "serve-agreement", **same,
          "bf16_layouts_same_text": out["contiguous-bf16"]["texts"]
          == out["paged-bf16"]["texts"],
          "int8_layouts_same_text": out["contiguous-int8"]["texts"]
          == out["paged-int8"]["texts"]})
    for pair, ok in same.items():
        check(ok, f"serve: {pair} streamed different text")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the prefix cache, served at llama-3-8b full width
# ---------------------------------------------------------------------------

def _prefix_messages(system: str, question: str) -> list:
    return [{"role": "system", "content": system},
            {"role": "user", "content": question}]


def _prefix_texts(provider, n_systems: int, n_questions: int):
    """``n_systems`` distinct system prompts (distinct from their first
    block on) whose tokens shared with any question end PREFIX_TOKENS +
    PREFIX_SHARED_EXTRA into the prompt, and ``n_questions`` ~100-character questions that
    differ from their first character; the shared token count."""
    words = ("a shared system prompt that every request of this tenant "
             "carries ahead of its own question; ")

    def prompt_ids(system, question):
        return provider._build_genrequest(
            {"messages": _prefix_messages(system, question)}).prompt_ids

    def shared(system):
        a, b = prompt_ids(system, "0"), prompt_ids(system, "1")
        return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    chars = PREFIX_TOKENS + PREFIX_SHARED_EXTRA - shared("")
    systems = [(f"{i}: tenant; " + words * (chars // len(words) + 1))[:chars]
               for i in range(n_systems)]
    questions = [(f"{i}) what does the shared prompt say about paging, "
                  f"chunks and blocks of keys, in one short line? ")[:100]
                 for i in range(n_questions)]
    return systems, questions, shared(systems[0])


def _prefix_cache_whole(engine, what: str) -> dict:
    """The allocator's refcounts and the tree agree, no request pins a
    block, and every page is free or resident in the cache."""
    cache, alloc = engine._prefix_cache, engine.allocator
    try:
        cache.check_invariants()
    except AssertionError as e:
        raise SmokeFailure(f"{what}: prefix cache invariants: {e}") from None
    stats = engine.stats()
    check(stats["prefix_pinned_refs"] == 0,
          f"{what}: pins left after the run: {stats}")
    check(stats["free_pages"] + stats["prefix_resident_pages"]
          == stats["total_pages"],
          f"{what}: pages neither free nor resident: {stats}")
    return {k: v for k, v in stats.items() if k.startswith("prefix_")
            or k.endswith("_pages")}


async def _prefix_serve(torch, ks, card: str, tag: str,
                        engine_cfg: dict) -> dict:
    """One cold request, then PREFIX_WARM warm ones, one at a time; then
    the warm prompts again on an engine with prefix_cache false."""
    import aiohttp

    from llmapigateway_tpu_torch.ops.flash_attention import (body_name,
                                                            reset_launches)
    what = f"prefix {tag}"
    engines = {"cached": engine_cfg,
               "plain": {**engine_cfg, "prefix_cache": False}}
    async with _Gateway(engines) as gw:
        cached = await gw.provider("cached")
        await gw.provider("plain")
        engine = cached.engine
        check(engine._prefix_cache is not None,
              f"{what}: the engine built no prefix cache")
        block = engine._prefix_cache.block_tokens
        (system,), questions, shared = _prefix_texts(cached, 1,
                                                     1 + PREFIX_WARM)
        check(PREFIX_TOKENS <= shared < PREFIX_TOKENS + block,
              f"{what}: {shared} shared tokens, want [{PREFIX_TOKENS}, "
              f"{PREFIX_TOKENS + block})")

        def body(model, question, stream=False):
            return {"model": model, "temperature": 0, "stream": stream,
                    "max_tokens": PREFIX_MAX_TOKENS,
                    "messages": _prefix_messages(system, question)}
        for fn in ks.all_wrappers():
            reset_launches(fn)
        engine.decode_steps = engine.prefill_calls = 0
        engine.prefill_one_token_calls = 0
        _reset_pipeline(engine)
        results = []
        async with aiohttp.ClientSession() as session:
            for i, q in enumerate(questions):
                calls = engine.prefill_calls
                r = await _chat(session, gw.port, what,
                                body("gw/cached", q, stream=i == 2))
                r["prefill_calls"] = engine.prefill_calls - calls
                results.append(r)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in ks.all_wrappers()}
            bodies = {fn.__name__: dict(fn.body_launches)
                      for fn in ks.all_wrappers()}
            steps = {"decode_steps": engine.decode_steps,
                     "prefill_calls": engine.prefill_calls,
                     "prefill_one_token_calls":
                     engine.prefill_one_token_calls}
            pipeline = _pipeline(engine)
            plain = [(await _chat(session, gw.port, what,
                                  body("gw/plain", q)))["text"]
                     for q in questions[1:]]
        mc = engine.model_cfg
        body_launched = body_name(0, engine.kv_ppb,
                                  engine_cfg.get("kv_quant") == "int8",
                                  mc.head_dim, mc.n_heads // mc.n_kv_heads)
        n_layers = mc.n_layers
        cache_state = _prefix_cache_whole(engine, what)
        chunk = engine.prefill_chunk
    del cached, engine, gw

    check_launches(ks, what, "paged", body_launched, n_layers, steps,
                   launches, bodies)
    check_pipeline(what, pipeline)
    usages = [r["usage"] for r in results]
    cached_tokens = [u.get("prompt_tokens_details", {}).get("cached_tokens",
                                                            0)
                     for u in usages]
    calls = [r["prefill_calls"] for r in results]
    # Cold: every chunk of the prompt (5 at 2203 tokens); warm: the chunks
    # past the cached span (1: a ~155-token tail).
    want_calls = [-(-(u["prompt_tokens"] - c) // chunk)
                  for u, c in zip(usages, cached_tokens)]
    check(cached_tokens == [0] + [PREFIX_TOKENS] * PREFIX_WARM,
          f"{what}: cached tokens {cached_tokens}")
    check(calls == want_calls,
          f"{what}: prefill calls per request {calls}, expected "
          f"{want_calls}")
    for r in results:
        check(r["usage"]["completion_tokens"] > 0
              and r["finish"] in ("length", "stop"),
              f"{what}: unexpected completion {r['usage']} ({r['finish']})")
    same = [r["text"] == t for r, t in zip(results[1:], plain)]
    res = {"phase": "prefix", "config": tag, "card": card,
           "engine": engine_cfg, "block_tokens": block,
           "shared_prompt_tokens": shared,
           "prompt_tokens": [u["prompt_tokens"] for u in usages],
           "cached_tokens": cached_tokens,
           "prefill_calls_per_request": calls,
           "same_text_as_no_cache": same,
           "cold_ttft_ms": usages[0].get("ttft_ms"),
           "warm_ttft_ms": [u.get("ttft_ms") for u in usages[1:]],
           "launches": launches, "body_launches": bodies, **steps,
           "pipeline": pipeline, "cache": cache_state,
           "note": "TTFT is information only"}
    emit(res)
    check(all(same), f"{what}: a warm request's text differs from the same "
                     f"prompt's without the cache: {same}")
    return res


async def _evict_serve(torch, card: str, prompt_tokens: int) -> dict:
    """EVICT_PROMPTS distinct system prompts, one request each, one at a
    time, on a pool that holds EVICT_PROMPTS - 1 requests' indexed blocks
    and one free page less than a reservation."""
    import aiohttp

    from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
    page = LocalEngineConfig(**PREFIX_LLAMA).kv_page_size
    need = -(-(prompt_tokens + PREFIX_MAX_TOKENS) // page)
    kept = (prompt_tokens + PREFIX_MAX_TOKENS - 1) // page
    num_pages = 1 + (EVICT_PROMPTS - 1) * kept + need - 1
    engine_cfg = {**PREFIX_LLAMA, "kv_num_pages": num_pages}
    async with _Gateway({"cached": engine_cfg}) as gw:
        provider = await gw.provider("cached")
        engine = provider.engine
        systems, (question,), _ = _prefix_texts(provider, EVICT_PROMPTS, 1)
        results = []
        async with aiohttp.ClientSession() as session:
            for system in systems:
                results.append(await _chat(session, gw.port, "evict", {
                    "model": "gw/cached", "temperature": 0, "stream": False,
                    "max_tokens": PREFIX_MAX_TOKENS,
                    "messages": _prefix_messages(system, question)}))
        torch.cuda.synchronize()
        cache_state = _prefix_cache_whole(engine, "evict")
    del provider, engine, gw
    res = {"phase": "prefix-evict", "card": card, "engine": engine_cfg,
           "prompt_tokens": [r["usage"]["prompt_tokens"] for r in results],
           "completion_tokens": [r["usage"]["completion_tokens"]
                                 for r in results],
           "finish": [r["finish"] for r in results], "cache": cache_state}
    emit(res)
    check(res["prompt_tokens"] == [prompt_tokens] * EVICT_PROMPTS,
          f"evict: prompt tokens {res['prompt_tokens']}")
    check(cache_state["prefix_evicted_blocks"] > 0,
          f"evict: nothing was evicted: {cache_state}")
    check(all(n > 0 for n in res["completion_tokens"])
          and all(f in ("length", "stop") for f in res["finish"]),
          f"evict: a request did not complete: {res}")
    return res


def _freed(torch, what: str, t0: float) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    freed = torch.cuda.memory_allocated()
    emit({"phase": "serve-freed", "config": what, "allocated_bytes": freed,
          "seconds": time.monotonic() - t0})
    check(freed < FREED_BYTES_MAX,
          f"{what}: {freed} bytes still allocated after the engine stopped")


def prefix_phase(torch, ks, card: str) -> dict:
    """Phase 7: PREFIX_RUNS, then the eviction run; one gateway at a
    time."""
    out = {}
    for tag, engine_cfg in PREFIX_RUNS:
        t0 = time.monotonic()
        out[tag] = asyncio.run(_prefix_serve(torch, ks, card, tag,
                                             engine_cfg))
        _freed(torch, f"prefix {tag}", t0)
    t0 = time.monotonic()
    out["evict"] = asyncio.run(_evict_serve(
        torch, card, out[PREFIX_RUNS[0][0]]["prompt_tokens"][0]))
    _freed(torch, "prefix evict", t0)
    return out


# ---------------------------------------------------------------------------
# Phase 9: the gateway around the engine: remote upstream, then the card
# ---------------------------------------------------------------------------

# The local target: llama-3-8b at full width and depth, paged bf16, as the
# serve phase's paged-bf16 run (prefix cache off, so a repeated prompt is
# prefilled again and streams the same text).
GATEWAY_ENGINE = {**LLAMA, **PAGED, "kv_pages_per_block": 1,
                  "prefix_cache": False, "kv_quant": ""}
GATEWAY_MAX_TOKENS = 16
GATEWAY_PROMPT = "route this request through the gateway's fallback chain"
GATEWAY_CLIENT_KEY = "smoke-client"
# The failing stub's breaker opens at its 4th failure: the 2nd failover
# request's retry. The first two requests then cost 2 stub hits each, the
# rest none.
STUB_BREAKER = {"min_requests": 4, "failure_threshold": 0.5,
                "window_s": 600.0, "cooldown_s": 600.0}
GATEWAY_FAILOVER_HITS = [2, 2, 0, 0]
GATEWAY_ROTATIONS = 4
STUB_SLOW_S = 2.0
GATEWAY_TIMEOUT_MS = 1000


class _StubUpstream:
    """A loopback OpenAI-compatible upstream (aiohttp's server, nothing of
    the tests): ``/ok`` answers JSON or SSE with a usage block, ``/fail``
    answers its odd requests with HTTP 500 and its even ones with an
    in-band error at HTTP 200, ``/slow`` answers after STUB_SLOW_S."""

    TOKENS = ["stub ", "answer"]
    USAGE = {"prompt_tokens": 5, "completion_tokens": 2, "total_tokens": 7}

    def __init__(self) -> None:
        self.hits = {"ok": 0, "fail": 0, "slow": 0}

    async def chat(self, request):
        from aiohttp import web
        kind = request.match_info["kind"]
        self.hits[kind] += 1
        body = await request.json()
        stream = bool(body.get("stream"))
        if kind == "fail" and self.hits[kind] % 2:
            return web.json_response({"error": {"message": "stub 500"}},
                                     status=500)
        if kind == "slow":
            await asyncio.sleep(STUB_SLOW_S)
        error = {"error": {"message": "stub in-band error"}}
        if not stream:
            if kind == "fail":
                return web.json_response(error)
            return web.json_response({
                "id": "stub", "object": "chat.completion",
                "model": body.get("model"),
                "choices": [{"index": 0, "finish_reason": "stop",
                             "message": {"role": "assistant",
                                         "content": "".join(self.TOKENS)}}],
                "usage": self.USAGE})
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        frames = [error] if kind == "fail" else [
            {"id": "stub", "object": "chat.completion.chunk",
             "choices": [{"index": 0, "delta": {"content": t},
                          "finish_reason": None}]} for t in self.TOKENS] + [
            {"id": "stub", "object": "chat.completion.chunk",
             "choices": [{"index": 0, "delta": {}, "finish_reason": "stop"}],
             "usage": self.USAGE}, "[DONE]"]
        for frame in frames:
            data = frame if isinstance(frame, str) else json.dumps(frame)
            await resp.write(f"data: {data}\n\n".encode())
        await resp.write_eof()
        return resp


def _gateway_config(stub_base: str) -> tuple[list, list]:
    local = {"provider": "local", "model": GATEWAY_ENGINE["preset"]}
    slow = {"provider": "stub-slow", "model": "stub"}
    providers = [
        {"stub-fail": {"baseUrl": f"{stub_base}/fail/v1", "apikey": "stub-key",
                       "breaker": STUB_BREAKER}},
        {"stub-ok": {"baseUrl": f"{stub_base}/ok/v1", "apikey": "stub-key"}},
        {"stub-slow": {"baseUrl": f"{stub_base}/slow/v1",
                       "apikey": "stub-key"}},
        {"local": {"type": "local", "engine": GATEWAY_ENGINE}}]
    rules = [
        {"gateway_model_name": "gw/local", "fallback_models": [local]},
        {"gateway_model_name": "gw/failover", "fallback_models": [
            {"provider": "stub-fail", "model": "stub", "retry_count": 1},
            local]},
        {"gateway_model_name": "gw/rotate", "rotate_models": True,
         "fallback_models": [{"provider": "stub-ok", "model": "stub"},
                             local]},
        # The budget is the request's: a target that spends it ends the
        # request (504) whatever follows it in the chain.
        {"gateway_model_name": "gw/deadline-alone",
         "timeout_ms": GATEWAY_TIMEOUT_MS, "fallback_models": [slow]},
        {"gateway_model_name": "gw/deadline-first",
         "timeout_ms": GATEWAY_TIMEOUT_MS, "fallback_models": [slow, local]},
        {"gateway_model_name": "gw/deadline-second",
         "timeout_ms": GATEWAY_TIMEOUT_MS, "fallback_models": [local, slow]}]
    return providers, rules


async def _gw_post(session, port: int, model: str, stream: bool,
                   text: str = GATEWAY_PROMPT,
                   max_tokens: int = GATEWAY_MAX_TOKENS,
                   headers: dict | None = None) -> dict:
    """POST one greedy chat completion through the gateway: status, text,
    usage block, the response's request id and wall ms (the body read to
    its end)."""
    body = {"model": model, "stream": stream, "temperature": 0,
            "max_tokens": max_tokens,
            "messages": [{"role": "user", "content": text}]}
    t0 = time.monotonic()
    async with session.post(f"http://127.0.0.1:{port}/v1/chat/completions",
                            json=body, headers=headers or {}) as resp:
        raw = await resp.read()
        resp_status = resp.status
        request_id = resp.headers.get("x-request-id")
    wall_ms = 1000.0 * (time.monotonic() - t0)
    out = {"status": resp_status, "wall_ms": wall_ms, "text": None,
           "usage": None, "request_id": request_id}
    if resp_status != 200:
        out["error"] = json.loads(raw)["error"]["message"][:300]
        return out
    if not stream:
        data = json.loads(raw)
        out["text"] = data["choices"][0]["message"]["content"]
        out["usage"] = data.get("usage")
        return out
    from llmapigateway_tpu_torch.utils.sse import SSEParser
    frames = list(SSEParser().feed(raw))
    check(bool(frames) and frames[-1].is_done,
          f"gateway {model}: SSE stream did not end in [DONE]: "
          f"{[fr.data[:200] for fr in frames[-2:]]}")
    objs = [fr.json for fr in frames if fr.json]
    out["text"] = "".join((c.get("delta") or {}).get("content") or ""
                          for o in objs for c in o.get("choices") or [])
    usage = [o["usage"] for o in objs if "usage" in o]
    out["usage"] = usage[-1] if usage else None
    return out


async def _gateway_serve(torch, ks, card: str) -> dict:
    import aiohttp
    from aiohttp import web

    from llmapigateway_tpu_torch.config.loader import ConfigLoader
    from llmapigateway_tpu_torch.config.settings import Settings
    from llmapigateway_tpu_torch.db.rotation import RotationDB
    from llmapigateway_tpu_torch.ops.flash_attention import (body_name,
                                                            reset_launches)
    from llmapigateway_tpu_torch.providers.local import make_local_provider
    from llmapigateway_tpu_torch.server.app import build_app

    stub = _StubUpstream()
    stub_app = web.Application()
    stub_app.router.add_post("/{kind}/v1/chat/completions", stub.chat)
    stub_runner = web.AppRunner(stub_app)
    await stub_runner.setup()
    stub_port = _free_port()
    await web.TCPSite(stub_runner, "127.0.0.1", stub_port).start()
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    providers, rules = _gateway_config(f"http://127.0.0.1:{stub_port}")
    with open(os.path.join(d, "providers.json"), "w") as f:
        json.dump(providers, f)
    with open(os.path.join(d, "models_fallback_rules.json"), "w") as f:
        json.dump(rules, f)
    app = build_app(Settings(fallback_provider="local", config_dir=d,
                             db_dir=os.path.join(d, "db")),
                    loader=ConfigLoader(d, "local"),
                    local_factory=functools.partial(make_local_provider,
                                                    device="cuda"))
    runner = web.AppRunner(app)
    await runner.setup()
    port = _free_port()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    gw = app["gateway"]
    try:
        t0 = time.monotonic()
        local = await gw.registry.get("local")
        engine = local.engine
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        # Routing ms before the local attempt starts, per request that
        # reaches it: failed remote attempts and breaker skips are in it,
        # the local answer's own time is not.
        pre_local, t_dispatch = [], [0.0]
        dispatch, complete = gw.router.dispatch, local.complete

        async def timed_dispatch(*a, **kw):
            t_dispatch[0] = time.perf_counter()
            return await dispatch(*a, **kw)

        async def timed_complete(request, observer):
            pre_local.append(1000.0 * (time.perf_counter() - t_dispatch[0]))
            return await complete(request, observer)
        gw.router.dispatch, local.complete = timed_dispatch, timed_complete
        mc = engine.model_cfg
        for fn in ks.all_wrappers():
            reset_launches(fn)
        engine.decode_steps = engine.prefill_calls = 0
        engine.prefill_one_token_calls = 0
        t1 = time.monotonic()
        async with aiohttp.ClientSession(headers={
                "Authorization": f"Bearer {GATEWAY_CLIENT_KEY}"}) as session:
            async def post(model, stream):
                n = len(pre_local)
                out = await _gw_post(session, port, model, stream)
                out["pre_local_ms"] = (pre_local[n] if len(pre_local) > n
                                       else None)
                return out
            direct = [await post("gw/local", s)
                      for s in (False, True, False, True)]
            failover, hits = [], []
            for i in range(len(GATEWAY_FAILOVER_HITS)):
                before = stub.hits["fail"]
                failover.append(await post("gw/failover", bool(i % 2)))
                hits.append(stub.hits["fail"] - before)
            rotation = [await post("gw/rotate", False)
                        for _ in range(GATEWAY_ROTATIONS)]
            deadline = {name: await post(f"gw/deadline-{name}", False)
                        for name in ("alone", "first", "second")}
            await asyncio.to_thread(gw.usage_recorder.flush)
            async with session.get(f"http://127.0.0.1:{port}"
                                   f"/v1/api/usage-records?limit=100") as r:
                records = (await r.json())["records"]
            async with session.get(f"http://127.0.0.1:{port}"
                                   f"/v1/api/health/providers") as r:
                health = (await r.json())["providers"]
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t1
        launches = {fn.__name__: fn.launches for fn in ks.all_wrappers()}
        bodies = {fn.__name__: dict(fn.body_launches)
                  for fn in ks.all_wrappers()}
        steps = {"decode_steps": engine.decode_steps,
                 "prefill_calls": engine.prefill_calls,
                 "prefill_one_token_calls": engine.prefill_one_token_calls}
        recorder = gw.usage_recorder.stats()
        del engine, local, complete
    finally:
        await runner.cleanup()
        await stub_runner.cleanup()
        tmp.cleanup()

    what = "gateway"
    texts = {s: [r["text"] for r in direct if r["status"] == 200
                 and r["text"] is not None][s::2] for s in (0, 1)}
    check(all(r["status"] == 200 for r in direct)
          and texts[0][0] == texts[0][1] and texts[1][0] == texts[1][1]
          and texts[0][0] == texts[1][0],
          f"{what}: direct local answers differ or failed: {direct}")
    local_text = texts[0][0]
    check(hits == GATEWAY_FAILOVER_HITS,
          f"{what}: failing stub hits per failover request {hits}, "
          f"expected {GATEWAY_FAILOVER_HITS} (the breaker opens after the "
          f"second request)")
    for i, r in enumerate(failover):
        check(r["status"] == 200 and r["text"] == local_text,
              f"{what}: failover request {i} did not answer the local "
              f"text: {r}")
    # A fresh RotationDB gives the start index of each rotated request.
    with tempfile.TemporaryDirectory() as rd:
        rot = RotationDB(rd)
        starts = [rot.next_index(GATEWAY_CLIENT_KEY, "gw/rotate", 2)
                  for _ in range(GATEWAY_ROTATIONS)]
        rot.close()
    rot_targets = [r["fallback_models"] for r in rules
                   if r["gateway_model_name"] == "gw/rotate"][0]
    want_rot = [rot_targets[i]["provider"] for i in starts]
    served_rot = ["local" if r["text"] == local_text else
                  "stub-ok" if r["text"] == "".join(_StubUpstream.TOKENS)
                  else r["text"] for r in rotation]
    check(all(r["status"] == 200 for r in rotation)
          and served_rot == want_rot,
          f"{what}: rotation served {served_rot}, RotationDB says "
          f"{want_rot}")
    check(stub.hits["ok"] == want_rot.count("stub-ok"),
          f"{what}: healthy stub hits {stub.hits['ok']}")
    check(deadline["alone"]["status"] == 504
          and deadline["first"]["status"] == 504,
          f"{what}: a slow stub past timeout_ms did not answer 504: "
          f"{deadline}")
    check(deadline["second"]["status"] == 200
          and deadline["second"]["text"] == local_text,
          f"{what}: the local target ahead of the slow stub did not answer "
          f"inside the budget: {deadline['second']}")
    served = ([("local", r["usage"]) for r in direct + failover]
              + [(p, r["usage"]) for p, r in zip(served_rot, rotation)]
              + [("local", deadline["second"]["usage"])])
    want_rows = sorted((p, u["prompt_tokens"], u["completion_tokens"])
                       for p, u in served)
    got_rows = sorted((r["provider"], r["prompt_tokens"],
                       r["completion_tokens"]) for r in records)
    check(got_rows == want_rows,
          f"{what}: usage records {got_rows} != served requests' usage "
          f"blocks {want_rows}")
    check(health["stub-fail"]["state"] == "open"
          and health["stub-fail"]["opens"] == 1
          and health["local"]["state"] == "closed",
          f"{what}: provider health {health}")
    body = body_name(mc.sliding_window, 1, False, mc.head_dim,
                     mc.n_heads // mc.n_kv_heads)
    check_launches(ks, what, "paged", body, mc.n_layers, steps, launches,
                   bodies)

    def pre(rows):
        return statistics.median(r["pre_local_ms"] for r in rows)
    # Per failed attempt: the routing time before the local attempt of a
    # failover request whose stub was tried twice, less a direct one's.
    failed_attempt_ms = ((pre(failover[:2]) - pre(direct))
                         / GATEWAY_FAILOVER_HITS[0])
    skip_ms = pre(failover[2:]) - pre(direct)
    local_usage = [r["usage"] for r in direct + failover]
    res = {"phase": "gateway", "card": card, "engine": GATEWAY_ENGINE,
           "layers": mc.n_layers, "engine_build_s": build_s,
           "wall_s": wall_s,
           "requests": {"direct": len(direct), "failover": len(failover),
                        "rotation": len(rotation),
                        "deadline": len(deadline)},
           "failover_stub_hits": hits, "stub_hits": stub.hits,
           "rotation_served": served_rot,
           "deadline_status": {k: v["status"] for k, v in deadline.items()},
           "deadline_wall_ms": {k: v["wall_ms"] for k, v in deadline.items()},
           "walls_ms": {"direct_json": [r["wall_ms"] for r in direct[0::2]],
                        "direct_sse": [r["wall_ms"] for r in direct[1::2]],
                        "failover": [r["wall_ms"] for r in failover],
                        "rotation": [r["wall_ms"] for r in rotation]},
           "pre_local_ms": {"direct": [r["pre_local_ms"] for r in direct],
                            "failover": [r["pre_local_ms"]
                                         for r in failover]},
           "failed_attempt_ms": failed_attempt_ms,
           "breaker_skip_ms": skip_ms,
           "local_ttft_ms": [u.get("ttft_ms") for u in local_usage],
           "local_tok_per_s": [u.get("tokens_per_sec")
                               for u in local_usage],
           "usage_rows": len(records), "recorder": recorder,
           "breakers": {k: {f: v[f] for f in ("state", "opens",
                                               "failure_rate",
                                               "window_requests")}
                        for k, v in health.items()},
           "launches": launches, "body_launches": bodies, **steps,
           "note": "walls, TTFT and tok/s are information only"}
    emit(res)
    return res


def gateway_phase(torch, ks, card: str) -> dict:
    """Phase 9: the gateway around the local engine on the card."""
    t0 = time.monotonic()
    out = asyncio.run(_gateway_serve(torch, ks, card))
    _freed(torch, "gateway", t0)
    return out


# ---------------------------------------------------------------------------
# Phase 10: an HF checkpoint on the card through the config API's hot reload
# ---------------------------------------------------------------------------

# tinyllama-1.1b at full width and depth, paged bf16; first random weights
# from its preset, then the same knobs with the checkpoint's weights.
CKPT_PRESET = "tinyllama-1.1b"
CKPT_ENGINE = {**TINYLLAMA, **PAGED, "prefix_cache": False, "kv_quant": ""}
CKPT_SHARD_GB = 1.0
# The retired engine closes this long after the reload began (the
# registry's grace period, 330 s in a deployment): longer than the rebuild,
# so the card holds both engines for a while.
CKPT_RETIRE_S = 30.0
CKPT_PROMPT_CHARS = (40, 300, 700, 1100)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class _RssPeak:
    """The largest resident set of this process while the block runs,
    sampled every 10 ms by a thread, less the resident set at its start."""

    def __enter__(self):
        import threading
        self.base = self.peak = _rss_bytes()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, _rss_bytes())
        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())

    @property
    def added(self) -> int:
        return self.peak - self.base


def check_params_are_the_shards(torch, params, model_dir: str) -> int:
    """Every param leaf, layer by layer, is ``torch.equal`` to its tensor
    read back from the shards (projections transposed), and every leaf is
    covered. → the tensors compared."""
    from pathlib import Path

    from llmapigateway_tpu_torch.engine.checkpoint import _map_name
    from llmapigateway_tpu_torch.utils.safetensors_lite import safe_open
    want = {(k, None) for k in params if k != "layers"}
    want |= {(k, i) for k, v in params["layers"].items()
             for i in range(v.shape[0])}
    seen = set()
    for shard in sorted(Path(model_dir).glob("*.safetensors")):
        with safe_open(shard) as f:
            for name in f.keys():
                key, layer, _, transpose = _map_name(name)
                leaf = params[key] if layer is None \
                    else params["layers"][key][layer]
                t = f.get_tensor(name).to(leaf.device)
                check(torch.equal(leaf, t.T if transpose else t),
                      f"checkpoint: {key}[{layer}] differs from {name} in "
                      f"{shard.name}")
                seen.add((key, layer))
    if "lm_head" not in {k for k, _ in seen}:
        check(params["lm_head"] is params["embed"],
              "checkpoint: a tied lm_head is not the embed tensor")
        seen.add(("lm_head", None))
    check(seen == want, f"checkpoint: leaves not in the shards: "
                        f"{sorted(want - seen)[:8]}")
    return len(seen)


async def _checkpoint_serve(torch, ks, card: str) -> dict:
    import aiohttp
    from aiohttp import web

    from llmapigateway_tpu_torch.config.loader import ConfigLoader
    from llmapigateway_tpu_torch.config.settings import Settings
    from llmapigateway_tpu_torch.engine.checkpoint import unique_bytes
    from llmapigateway_tpu_torch.ops.flash_attention import (body_name,
                                                            reset_launches)
    from llmapigateway_tpu_torch.providers.local import make_local_provider
    from llmapigateway_tpu_torch.routing.router import ProviderRegistry
    from llmapigateway_tpu_torch.server.app import build_app
    from llmapigateway_tpu_torch.tools import make_synthetic_checkpoint

    what = "checkpoint"
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    ckpt = os.path.join(d, "ckpt")
    t0 = time.monotonic()
    written = make_synthetic_checkpoint.main([
        "--preset", CKPT_PRESET, "--out", ckpt, "--dtype", "bfloat16",
        "--shard-gb", str(CKPT_SHARD_GB), "--seed", "0"])
    write_s = time.monotonic() - t0
    check(written["shards"] >= 2, f"{what}: {written['shards']} shard(s)")
    preset_entry = {"type": "local", "engine": CKPT_ENGINE}
    ckpt_entry = {"type": "local",
                  "engine": {**CKPT_ENGINE, "model_path": ckpt}}
    cfg_dir = os.path.join(d, "config")
    os.mkdir(cfg_dir)
    with open(os.path.join(cfg_dir, "providers.json"), "w") as f:
        json.dump([{"local": preset_entry}, {"direct": ckpt_entry}], f)
    with open(os.path.join(cfg_dir, "models_fallback_rules.json"), "w") as f:
        json.dump([{"gateway_model_name": f"gw/{name}",
                    "fallback_models": [{"provider": name,
                                         "model": CKPT_PRESET}]}
                   for name in ("local", "direct")], f)
    retire_s = ProviderRegistry.RETIRE_AFTER_S
    ProviderRegistry.RETIRE_AFTER_S = CKPT_RETIRE_S
    app = build_app(Settings(fallback_provider="local", config_dir=cfg_dir,
                             db_dir=os.path.join(d, "db")),
                    loader=ConfigLoader(cfg_dir, "local"),
                    local_factory=functools.partial(make_local_provider,
                                                    device="cuda"))
    runner = web.AppRunner(app)
    await runner.setup()
    port = _free_port()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    gw = app["gateway"]
    res = {"phase": what, "card": card, "preset": CKPT_PRESET,
           "engine": CKPT_ENGINE, "checkpoint": written,
           "checkpoint_write_s": write_s}
    try:
        t0 = time.monotonic()
        direct = await gw.registry.get("direct")
        torch.cuda.synchronize()
        res["direct_build_s"] = time.monotonic() - t0
        res["direct_load"] = dict(direct.engine.load_stats)
        words = ("the quick brown fox jumps over the lazy dog while a "
                 "checkpoint streams its shards onto the card ")
        prompts = [(words * (n // len(words) + 1))[:n]
                   for n in CKPT_PROMPT_CHARS]

        post = functools.partial(_gw_post, max_tokens=SERVE_MAX_TOKENS)
        async with aiohttp.ClientSession() as session:
            r = await post(session, port, "gw/local", False, prompts[0])
            check(r["status"] == 200, f"{what}: random-init request: {r}")
            old = (await gw.registry.get("local")).engine
            check(not old.cfg.model_path, f"{what}: not the preset engine")
            old_bytes = unique_bytes(old.params)
            url = f"http://127.0.0.1:{port}/v1/config/providers"
            with open(os.path.join(cfg_dir, "providers.json")) as f:
                before = f.read()
            version = gw.loader.version
            async with session.get(url) as resp:
                check(resp.status == 200 and await resp.text() == before,
                      f"{what}: GET providers did not return the file")
            bad = json.dumps([{"local": ckpt_entry},
                              {"direct": ckpt_entry}])[:-3]
            async with session.post(url, data=bad) as resp:
                bad_res = {"status": resp.status, "body": await resp.json()}
            with open(os.path.join(cfg_dir, "providers.json")) as f:
                after_bad = f.read()
            check(bad_res["status"] == 400 and bad_res["body"]["errors"]
                  and after_bad == before and gw.loader.version == version,
                  f"{what}: a save with a syntax error was not refused "
                  f"cleanly: {bad_res}, version {gw.loader.version}")
            good = ("// tinyllama-1.1b: the checkpoint's weights\n"
                    + json.dumps([{"local": ckpt_entry},
                                  {"direct": ckpt_entry}], indent=1))
            async with session.post(url, data=good) as resp:
                good_res = {"status": resp.status,
                            "body": await resp.json()}
            with open(os.path.join(cfg_dir, "providers.json")) as f:
                saved = f.read()
            check(good_res["status"] == 200
                  and good_res["body"]["config_version"] == version + 1
                  and saved == good,
                  f"{what}: the good save: {good_res}")

            # The next request rebuilds "local" from the checkpoint.
            with _RssPeak() as rss:
                first = await post(session, port, "gw/local", False,
                                   prompts[0],
                                   headers={"x-request-id": "smoke-ckpt-1"})
            check(first["status"] == 200
                  and first["request_id"] == "smoke-ckpt-1",
                  f"{what}: the rebuilding request: {first}")
            provider = await gw.registry.get("local")
            engine = provider.engine
            check(engine is not old and engine.cfg.model_path == ckpt,
                  f"{what}: 'local' was not rebuilt from the checkpoint")
            check(await gw.registry.get("direct") is direct,
                  f"{what}: the unchanged provider was rebuilt")
            res.update(first_request_ms=first["wall_ms"],
                       rebuild_load=dict(engine.load_stats),
                       rebuild_rss_added_bytes=rss.added)
            res["params_compared"] = check_params_are_the_shards(
                torch, engine.params, ckpt)

            # 2 SSE + 2 JSON requests, counted, on the rebuilt engine; the
            # same on the directly built one. Random weights mostly choose
            # ids past the byte tokenizer's 256, which decode to no text,
            # so the greedy token ids are compared as well.
            async def four(model, prov):
                _gate_first_step(prov.engine, len(prompts))
                reqs, build = [], prov._build_genrequest

                def recorded(payload):
                    reqs.append(build(payload))
                    return reqs[-1]
                prov._build_genrequest = recorded
                out = await asyncio.gather(*[
                    post(session, port, model, s, p)
                    for p, s in zip(prompts, (True, False, True, False))])
                del prov._build_genrequest
                return out, sorted((r.prompt_ids, r.generated) for r in reqs)
            for fn in ks.all_wrappers():
                reset_launches(fn)
            engine.decode_steps = engine.prefill_calls = 0
            engine.prefill_one_token_calls = 0
            rebuilt, rebuilt_ids = await four("gw/local", provider)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in ks.all_wrappers()}
            bodies = {fn.__name__: dict(fn.body_launches)
                      for fn in ks.all_wrappers()}
            steps = {"decode_steps": engine.decode_steps,
                     "prefill_calls": engine.prefill_calls,
                     "prefill_one_token_calls":
                     engine.prefill_one_token_calls}
            direct_out, direct_ids = await four("gw/direct", direct)
            async with session.get(f"http://127.0.0.1:{port}/v1/models/"
                                   f"AsOpenCodeFormat") as resp:
                opencode = await resp.json()

            # The retired engine closes after the grace period, and the
            # card's memory falls by at least its weights.
            gc.collect()
            both_bytes = torch.cuda.memory_allocated()
            check(old.params is not None,
                  f"{what}: the retired engine closed before the rebuild "
                  f"ended; raise CKPT_RETIRE_S")
            t_wait = time.monotonic()
            while old.params is not None \
                    and time.monotonic() - t_wait < CKPT_RETIRE_S + 30:
                await asyncio.sleep(0.1)
            check(old.params is None,
                  f"{what}: the retired engine was not closed")
            gc.collect()
            after_bytes = torch.cuda.memory_allocated()
            # The same checkpoint loaded with int4 weights (phase 11's
            # check: every leaf the shards' host quantization).
            res["int4_load"] = await _quantized_load(
                torch, ckpt, "int4", QUANT_CKPT_ENGINE, f"{what} int4")
        mc = engine.model_cfg
        del engine, provider, direct
    finally:
        ProviderRegistry.RETIRE_AFTER_S = retire_s
        await runner.cleanup()
        tmp.cleanup()

    texts = [r["text"] for r in rebuilt]
    check(all(r["status"] == 200 for r in rebuilt + direct_out),
          f"{what}: a request failed: {rebuilt + direct_out}")
    check(texts == [r["text"] for r in direct_out],
          f"{what}: the rebuilt engine's text differs from the directly "
          f"built one's: {texts} vs {[r['text'] for r in direct_out]}")
    check(rebuilt_ids == direct_ids and len(rebuilt_ids) == len(prompts)
          and all(ids for _, ids in rebuilt_ids),
          f"{what}: the rebuilt engine's greedy tokens differ from the "
          f"directly built one's: {rebuilt_ids} vs {direct_ids}")
    body_launched = body_name(0, 1, False, mc.head_dim,
                              mc.n_heads // mc.n_kv_heads)
    check_launches(ks, what, "paged", body_launched, mc.n_layers, steps,
                   launches, bodies)
    listed = opencode["llmgateway"]["models"]
    check("gw/local" in listed and "gw/direct" in listed,
          f"{what}: AsOpenCodeFormat lists {sorted(listed)}")
    freed = both_bytes - after_bytes
    check(freed >= old_bytes,
          f"{what}: memory_allocated fell by {freed} bytes when the retired "
          f"engine closed, less than its {old_bytes} bytes of weights")
    load = res["rebuild_load"]
    res.update(
        generated_tokens=[len(ids) for _, ids in rebuilt_ids],
        launches=launches, body_launches=bodies, **steps,
        retired_param_bytes=old_bytes, allocated_both_bytes=both_bytes,
        allocated_after_close_bytes=after_bytes, freed_bytes=freed,
        load_s=load["seconds"], read_s=load["read_s"],
        h2d_gbps=load["bytes"] / 1e9 / load["seconds"],
        note="load, read, GB/s, RSS and first-request wall are information")
    emit(res)
    return res


def checkpoint_phase(torch, ks, card: str) -> dict:
    """Phase 10: a tinyllama-1.1b checkpoint through the config API."""
    t0 = time.monotonic()
    out = asyncio.run(_checkpoint_serve(torch, ks, card))
    _freed(torch, "checkpoint", t0)
    return out


# ---------------------------------------------------------------------------
# Phase 11: quantized weights (W8A8, W4A8) and the Mixtral family
# ---------------------------------------------------------------------------

INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 (NVIDIA data sheet)
# No Pallas kernel: the W4A8 kernel replaces XLA's mixed s8 x s4
# dot_general of the JAX package's quantized projections.
W4A8_REPLACES = ("llmapigateway_tpu/models/quant.py:171 (XLA s8 x s4 "
                 "dot_general; no Pallas kernel)")
MIXTRAL = {"preset": "mixtral-8x7b", "max_batch_size": 8,
           "max_seq_len": 4096, "prefill_chunk": 512, "mesh": {}}
# The W4A8 kernel's shapes: llama-3-8b's projections (K, N) at decode rows
# 1, 8 and 32 and a 512-token prefill chunk; mixtral-8x7b's experts at
# decode (the dense all-experts form: one activation block shared by the 8
# experts for w1/w3, per-expert rows for w2) and in a 512-token chunk's
# capacity dispatch (256 rows an expert).
LLAMA_PROJ = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
              "wg/wu": (4096, 14336), "wd": (14336, 4096)}
W4A8_ROWS = (
    [("llama-3-8b", proj, 1, M, K, N, False)
     for proj, (K, N) in LLAMA_PROJ.items() for M in (1, 8, 32, 512)]
    + [("mixtral-8x7b", "w1/w3 dense", 8, M, 4096, 14336, True)
       for M in (1, 8, 32)]
    + [("mixtral-8x7b", "w2", 8, M, 14336, 4096, False) for M in (1, 8, 32)]
    + [("mixtral-8x7b", "w1/w3 dispatch", 8, 256, 4096, 14336, False),
       ("mixtral-8x7b", "w2 dispatch", 8, 256, 14336, 4096, False)])
# The int8 product (torch._int_mm, rows padded to 17 below 17): llama-3-8b's
# MLP shapes and mixtral-8x7b's eight experts' w1 as one [D, E*F] product.
INT8_ROWS = [("llama-3-8b", "wg/wu", M, 4096, 14336) for M in (1, 32, 512)] \
    + [("llama-3-8b", "wd", M, 14336, 4096) for M in (1, 32, 512)] \
    + [("mixtral-8x7b", "w1 x 8 experts", 32, 4096, 8 * 14336)]
QUANT_SERVE_RUNS = [
    ("llama-paged-w8", {**LLAMA, **PAGED, "prefix_cache": False,
                        "kv_quant": "", "quant": "int8"},
     ("chars", LLAMA_PROMPT_CHARS)),
    ("llama-paged-w4-kv8", {**LLAMA, **PAGED, "prefix_cache": False,
                            "kv_quant": "int8", "quant": "int4"},
     ("chars", LLAMA_PROMPT_CHARS)),
    ("mixtral-paged-w8", {**MIXTRAL, **PAGED, "prefix_cache": False,
                          "kv_quant": "", "quant": "int8"},
     ("chars", LLAMA_PROMPT_CHARS)),
    ("mixtral-paged-w4-kv8", {**MIXTRAL, **PAGED, "prefix_cache": False,
                              "kv_quant": "int8", "quant": "int4"},
     ("chars", LLAMA_PROMPT_CHARS)),
]
# Every other dense preset's head geometry and block served quantized (the
# W4A8 kernel at its projections' shapes; a tied model's int8 head copy;
# the window bodies, the SWA ring): serve runs of phase 7 with weights at
# int4 (int8 for the tied gemma-2b).
QUANT_PRESET_RUNS = [
    (tag.replace("-ring", f"-w{quant[-1]}-ring") if tag.endswith("-ring")
     else f"{tag}-w{quant[-1]}", {**cfg, "quant": quant}, spec)
    for tag, cfg, spec in SERVE_RUNS
    for want, quant in (("tinyllama-contiguous-int8", "int4"),
                        ("qwen2-paged-bf16", "int4"),
                        ("gemma2b-paged-int8", "int8"),
                        ("gemma7b-paged-bf16", "int4"),
                        ("mistral-paged-int8-ring", "int4"),
                        ("phi3-contiguous-int8", "int4"))
    if tag == want]
QUANT_GRAPH_RUN = ("mixtral-paged-w8", QUANT_SERVE_RUNS[2][1],
                   (40, 300, 700, 1100, 2000, 257))
# Two quantized engines that share a contraction width (K 2048) serving at
# once in one process, every product eager (burst depth 1) and short (4
# rows a decode step, below _int_mm's 17, so padded): each must stream the
# ids it streams alone. Padding shared between calls would let one
# engine's rows land in the other's product.
QUANT_CONCURRENT = [
    (name, {**cfg, **PAGED, "prefix_cache": False, "kv_quant": "",
            "quant": "int8", "decode_burst": 1, "decode_burst_busy": 1})
    for name, cfg in (("tinyllama-1.1b", TINYLLAMA), ("gemma-2b", GEMMA2B))]
QUANT_CONCURRENT_PROMPTS = (3, 7, 12, 16)
# Weights on the card against their arithmetic, and the build's transient
# memory: a build never holds a full-precision tree (mixtral-8x7b's would
# be 93 GB; llama-3-8b's 16 GB against 8.6 GB of int8), only one part (a
# layer's, an expert's, the head's fp32 draw) and its quantization
# temporaries at a time. Had the tree existed, the peak would have stood at
# least its bytes less the quantized weights' above what the build kept.
WEIGHT_BYTES_REL_TOL = 0.01
# A synthetic mixtral-8x7b checkpoint at full width and reduced depth.
QUANT_CKPT_PRESET = "mixtral-8x7b"
QUANT_CKPT_LAYERS = 1
QUANT_CKPT_ENGINE = {"kv_layout": "paged", "kv_page_size": 256,
                     "max_batch_size": 4, "max_seq_len": 2048,
                     "prefill_chunk": 512, "prefix_cache": False}


def quant_weight_bytes(c, quant: str, elem: int = 2) -> int:
    """The bytes a quantized model's weights must take: embed, norms,
    router and biases at ``elem`` bytes (bf16: 2); every layer matmul (each
    expert's) as levels (a byte each, half a byte under int4) plus an fp32
    scale per output channel; the int8 head (``lm_head`` or a tied model's
    ``lm_head_q8``)."""
    D, L = c.d_model, c.n_layers
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    bits = 4 if quant == "int4" else 8

    def mat(K, N, b):
        return K * N * b // 8 + 4 * N
    mlp = [(D, c.d_ff), (D, c.d_ff), (c.d_ff, D)]
    mats = [(D, q), (D, kv), (D, kv), (q, D)] + mlp * max(1, c.n_experts)
    total = L * sum(mat(K, N, bits) for K, N in mats)
    total += elem * (2 * L * D + D + c.vocab_size * D)     # norms, embed
    total += elem * L * D * c.n_experts                    # router
    total += elem * L * (q + 2 * kv) if c.attn_bias else 0  # qwen2 biases
    return total + mat(D, c.vocab_size, 8)


def quant_weights(torch, engine) -> dict:
    """A quantized engine just built: its weight bytes on the card against
    the arithmetic, and the build's peak memory against what stays."""
    from llmapigateway_tpu_torch.engine.checkpoint import (unique_bytes,
                                                           weight_count)
    c = engine.model_cfg
    got = unique_bytes(engine.params)
    want = quant_weight_bytes(c, engine.quant, engine.dtype.itemsize)
    peak, resident = (torch.cuda.max_memory_allocated(),
                      torch.cuda.memory_allocated())
    return {"quant": engine.quant, "layers": c.n_layers, "moe": c.is_moe,
            "unique_bytes": got, "arithmetic_bytes": want,
            "rel_err": abs(got - want) / want,
            "build_peak_allocated_bytes": peak,
            "resident_after_build_bytes": resident,
            "build_transient_bytes": peak - resident,
            "bf16_tree_bytes": 2 * weight_count(engine.params)}


def quant_products(c, quant: str, dense: int, dispatch: int
                   ) -> tuple[dict, dict]:
    """The quantized products a run of ``dense`` forwards of the dense MLP
    form and ``dispatch`` forwards of capacity dispatch must launch, per
    shape (``K../N..``): ``(w4a8_mm bodies, int8_mm bodies)``. Each layer
    matmul is one product per forward (Q, K, V, O, gate, up, down); the
    int8 head one more. Under int4 an MoE projection is one W4A8 launch
    over its experts; under int8 the dense form runs gate and up as one
    product against the ``[D, E·F]`` view and down once per expert, and
    dispatch runs all three once per expert."""
    D, F, E = c.d_model, c.d_ff, c.n_experts
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    fwd = dense + dispatch
    w4, w8 = collections.Counter(), collections.Counter()
    out = w4 if quant == "int4" else w8
    for K, N in [(D, q), (D, kv), (D, kv), (q, D)]:
        out[f"K{K}/N{N}"] += c.n_layers * fwd
    mlp = [(D, F), (D, F), (F, D)]
    if quant == "int4" or not E:
        for K, N in mlp:
            out[f"K{K}/N{N}"] += c.n_layers * fwd
    else:
        w8[f"K{D}/N{E * F}"] += 2 * c.n_layers * dense
        w8[f"K{D}/N{F}"] += 2 * E * c.n_layers * dispatch
        w8[f"K{F}/N{D}"] += E * c.n_layers * fwd
    w8[f"K{D}/N{c.vocab_size}"] += fwd
    return dict(+w4), dict(+w8)


def check_quant_run(what: str, c, w: dict, steps: dict, shapes: dict,
                    launches: dict, bodies: dict) -> dict:
    """The weights hold their arithmetic's bytes within 1%, the build's
    transient memory stayed below what a full-precision tree would have
    added, and the quantized products ran exactly as the model needs, per
    shape (:func:`quant_products`). An MoE prefill call's form follows
    from its rows × padded width (``engine.prefill_shapes``): more than
    models/mixtral.py's DISPATCH_THRESHOLD tokens dispatch, every decode
    step and shorter chunk runs dense. → the forwards of each form."""
    from llmapigateway_tpu_torch.models.mixtral import DISPATCH_THRESHOLD
    check(w["rel_err"] <= WEIGHT_BYTES_REL_TOL,
          f"{what}: {w['unique_bytes']} weight bytes on the card against "
          f"{w['arithmetic_bytes']} by arithmetic")
    check(w["build_transient_bytes"]
          < w["bf16_tree_bytes"] - w["unique_bytes"],
          f"{what}: the build peaked {w['build_transient_bytes']} bytes "
          f"above what it kept: a full-precision tree ({w['bf16_tree_bytes']}"
          f" bytes) may have existed beside the {w['unique_bytes']} kept")
    check(sum(shapes.values()) == steps["prefill_calls"],
          f"{what}: prefill shapes {shapes} do not add up to "
          f"{steps['prefill_calls']} prefill calls")
    dispatch = sum(n for (rows, width), n in shapes.items()
                   if c.is_moe and width > 1
                   and rows * width > DISPATCH_THRESHOLD)
    dense = steps["decode_steps"] + steps["prefill_calls"] - dispatch
    want = dict(zip(("w4a8_mm", "int8_mm"),
                    quant_products(c, w["quant"], dense, dispatch)))
    for name, bodies_want in want.items():
        check(bodies[name] == bodies_want
              and launches[name] == sum(bodies_want.values()),
              f"{what}: {name} ran {launches[name]} times as {bodies[name]}"
              f", expected {bodies_want} ({dense} dense and {dispatch} "
              f"dispatch forwards of {c.n_layers} layers, {w['quant']})")
    return {"dense_forwards": dense, "dispatch_forwards": dispatch}


def _w4a8_inputs(torch, gen, E, M, K, N, shared):
    from llmapigateway_tpu_torch.ops import quant_mm as qm
    ex = 1 if shared else E
    x = torch.randint(-127, 128, (ex, M, K), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    xs = torch.rand((ex, M, 1), generator=gen, device="cuda") * 1e-2 + 1e-4
    if shared:
        x, xs = x.expand(E, M, K), xs.expand(E, M, 1)
    levels = torch.randint(-7, 8, (E, N, K), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
    wq = qm.pack_int4(levels).transpose(-1, -2)
    ws = torch.rand((E, N), generator=gen, device="cuda") * 1e-2 + 1e-4
    return x, xs, wq, ws, levels


def check_w4a8(torch, gen, row) -> dict:
    """The W4A8 kernel against its plain version on the same card tensors:
    the int32 sums ``torch.equal``, the bf16 outputs within one bf16
    rounding (KERNEL_RTOL); device times of both and of ``torch._int_mm``
    on the same levels unpacked to int8 (the yardstick), and the bound:
    packed bytes at 3.35 TB/s or int8 operations at 1979 TOP/s."""
    from llmapigateway_tpu_torch.ops import quant_mm as qm
    model, proj, E, M, K, N, shared = row
    x, xs, wq, ws, levels = _w4a8_inputs(torch, gen, E, M, K, N, shared)
    acc = qm.w4a8_mm(x, xs, wq, ws, acc=True)
    acc_plain = qm.w4a8_mm_plain(x, xs, wq, ws, acc=True)
    out = qm.w4a8_mm(x, xs, wq, ws, torch.bfloat16)
    ref = (acc_plain.float() * xs * ws[:, None, :])
    torch.cuda.synchronize()
    sums_equal = torch.equal(acc, acc_plain)
    err = held(torch, f"w4a8 {model} {proj} M{M}", out, ref)
    w8 = levels.transpose(-1, -2)                        # [E, K, N] int8
    if shared:
        flat = levels.reshape(E * N, K).t()

        def library():
            return qm.int_mm_library(x[0], flat)
    else:
        def library():
            return [qm.int_mm_library(x[e], w8[e]) for e in range(E)]
    ms, host_ms = cuda_times(torch, lambda: qm.w4a8_mm(x, xs, wq, ws,
                                                       torch.bfloat16))
    plain_ms = cuda_ms(torch, lambda: qm.w4a8_mm_plain(x, xs, wq, ws,
                                                       torch.bfloat16), 10)
    library_ms = cuda_ms(torch, library)
    ex = 1 if shared else E
    n_bytes = (ex * M * K + E * N * K // 2 + 4 * (E * N + ex * M)
               + 2 * E * M * N)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * E * M * N * K / INT8_OPS_PER_S * 1e3
    res = {"name": f"w4a8_mm {model} {proj} E{E} M{M}", "model": model,
           "body": f"K{K}/N{N}", "E": E, "M": M, "K": K, "N": N,
           "shared_rows": shared, "sums_equal": sums_equal, **err,
           "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    del x, xs, wq, ws, levels, w8, acc, acc_plain, out, ref
    check(sums_equal, f"{res['name']}: int32 sums differ from the plain "
                      f"version's")
    check(res["max_err_over_tol"] <= 1.0,
          f"{res['name']}: output off by {res['max_err_over_tol']} x tol")
    return res


def check_int8_product(torch, gen, row) -> dict:
    """The int8 library product (``int8_mm``: ``torch._int_mm``, rows padded
    to 17) against the plain fp64 product: ``torch.equal``; its time and
    bound (int8 bytes, or int8 operations)."""
    from llmapigateway_tpu_torch.ops import quant_mm as qm
    model, proj, M, K, N = row
    x = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8).t()
    equal = torch.equal(qm.int8_mm(x, w), qm.int8_mm_plain(x, w))
    ms, host_ms = cuda_times(torch, lambda: qm.int8_mm(x, w))
    plain_ms = cuda_ms(torch, lambda: qm.int8_mm_plain(x, w), 10)
    n_bytes = M * K + K * N + 4 * M * N
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * N * K / INT8_OPS_PER_S * 1e3
    res = {"name": f"int8_mm {model} {proj} M{M}", "M": M, "K": K, "N": N,
           "sums_equal": equal, "ms": ms, "host_ms": host_ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "padded_to": max(M, qm.INT_MM_MIN_ROWS)}
    check(equal, f"{res['name']}: torch._int_mm differs from the exact "
                 f"product")
    return res


def check_quantized_shards(torch, params, model_dir: str, quant: str) -> int:
    """Every leaf of an engine loaded with ``quant`` against its tensor read
    back from the shards: a quantizable tensor's levels (unpacked) and
    scales ``torch.equal`` to its quantization on the host (the CPU, from
    the file's own values), every other leaf to the tensor itself (router
    transposed); every leaf covered. → the tensors compared."""
    from pathlib import Path

    from llmapigateway_tpu_torch.engine.checkpoint import _map_name
    from llmapigateway_tpu_torch.models.quant import (is_quantized,
                                                      quantize_levels,
                                                      weight_bits)
    from llmapigateway_tpu_torch.ops.quant_mm import unpack_int4
    from llmapigateway_tpu_torch.utils.safetensors_lite import safe_open
    n = 0
    for shard in sorted(Path(model_dir).glob("*.safetensors")):
        with safe_open(shard) as f:
            for name in f.keys():
                key, layer, expert, transpose = _map_name(name)
                leaf = params[key] if layer is None \
                    else params["layers"][key]
                index = (() if layer is None else (layer,) if expert is None
                         else (layer, expert))
                t = f.get_tensor(name)
                if is_quantized(leaf):
                    q = leaf["q"][index]
                    phys = (q.transpose(-1, -2) if transpose else q).cpu()
                    levels = (unpack_int4(phys) if phys.dtype == torch.uint8
                              else phys)
                    path = key if layer is None else f"layers.{key}"
                    want_q, want_s = quantize_levels(
                        t, 1, weight_bits(quant, path))
                    ok = (torch.equal(levels, want_q) and torch.equal(
                        leaf["s"][index].cpu(), want_s))
                else:
                    v = leaf[index].cpu()
                    ok = torch.equal(v, (t.T if transpose else t).to(v.dtype))
                check(ok, f"quant checkpoint: {key}{list(index)} differs from "
                          f"the host quantization of {name}")
                n += 1
    return n


async def _quantized_load(torch, model_dir: str, quant: str,
                          engine_cfg: dict, what: str) -> dict:
    """An engine built on the card from ``model_dir`` with ``quant``: its
    leaves against the shards' host quantization, its weight bytes against
    the arithmetic, one greedy request of 16 tokens; then closed."""
    from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
    from llmapigateway_tpu_torch.engine.engine import (GenRequest,
                                                       InferenceEngine)
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(LocalEngineConfig(
        model_path=model_dir, quant=quant, **engine_cfg), device="cuda")
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    weights = quant_weights(torch, engine)
    t1 = time.monotonic()
    compared = check_quantized_shards(torch, engine.params, model_dir, quant)
    compare_s = time.monotonic() - t1

    req = GenRequest(prompt_ids=list(range(5, 100)), max_tokens=16)
    await engine.submit(req)
    async for _ in engine.stream(req):
        pass
    await engine.close()
    res = {"what": what, "quant": quant, "layers": engine.model_cfg.n_layers,
           "experts": engine.model_cfg.n_experts, "build_s": build_s,
           "load": dict(engine.load_stats), "tensors_compared": compared,
           "compare_s": compare_s, "weights": weights,
           "generated": len(req.generated), "finish": req.finish_reason}
    del engine
    check(weights["rel_err"] <= WEIGHT_BYTES_REL_TOL,
          f"{what}: {weights['unique_bytes']} weight bytes against "
          f"{weights['arithmetic_bytes']} by arithmetic")
    check(res["generated"] > 0, f"{what}: the request generated nothing")
    return res


async def _quant_concurrent(torch, card: str) -> dict:
    """QUANT_CONCURRENT: each engine alone, then both at once, 4 greedy
    requests each, every run admitted in one step (so the batches, and
    with them every product's shapes, match); the ids must be equal."""
    from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
    from llmapigateway_tpu_torch.engine.engine import (GenRequest,
                                                       InferenceEngine)
    engines = {name: InferenceEngine(LocalEngineConfig(**cfg), device="cuda")
               for name, cfg in QUANT_CONCURRENT}

    async def run(engine) -> list[list[int]]:
        reqs = [GenRequest(prompt_ids=list(range(5, 5 + n)),
                           max_tokens=SERVE_MAX_TOKENS)
                for n in QUANT_CONCURRENT_PROMPTS]
        _gate_first_step(engine, len(reqs))
        for r in reqs:
            await engine.submit(r)

        async def drain(r):
            async for _ in engine.stream(r):
                pass
        await asyncio.gather(*[drain(r) for r in reqs])
        return [list(r.generated) for r in reqs]

    solo = {name: await run(e) for name, e in engines.items()}
    for e in engines.values():
        e.decode_steps = e.prefill_calls = 0
        _reset_pipeline(e)
    t0 = time.monotonic()
    together = dict(zip(engines, await asyncio.gather(
        *[run(e) for e in engines.values()])))
    wall_s = time.monotonic() - t0
    work = {name: {"decode_steps": e.decode_steps,
                   "prefill_calls": e.prefill_calls, **_pipeline(e)}
            for name, e in engines.items()}
    for e in engines.values():
        await e.close()
    del engines
    res = {"phase": "quant-concurrent", "card": card,
           "engines": [name for name, _ in QUANT_CONCURRENT],
           "prompt_tokens": list(QUANT_CONCURRENT_PROMPTS),
           "together_wall_s": wall_s, "work": work,
           "generated": {n: [len(g) for g in together[n]] for n in together},
           "equal": {n: together[n] == solo[n] for n in together}}
    emit(res)
    for name, w in work.items():
        check(w["decode_steps"] > 0 and w["graph_replays"] == 0,
              f"quant concurrent {name}: decode was not eager: {w}")
        check(together[name] == solo[name],
              f"quant concurrent {name}: ids served beside another engine "
              f"{together[name]} differ from those served alone "
              f"{solo[name]}")
    return res


def quant_phase(torch, ks, card: str, gen) -> dict:
    """Phase 11: the W4A8 kernel and the int8 product against their plain
    versions; llama-3-8b and mixtral-8x7b served at int8 and int4 over the
    paged pool, and every other dense preset quantized; two quantized
    engines serving at once against each alone; mixtral-8x7b's decode
    graphs replayed against eager; a synthetic mixtral-8x7b
    checkpoint (full width, one layer) loaded with int8."""
    out = {"w4a8": [check_w4a8(torch, gen, row) for row in W4A8_ROWS]}
    out["int8_mm"] = [check_int8_product(torch, gen, row)
                      for row in INT8_ROWS]
    emit({"phase": "quant-kernel", "card": card, "w4a8": out["w4a8"],
          "int8_mm": out["int8_mm"]})
    torch.cuda.empty_cache()
    serve = {}
    for tag, engine_cfg, prompt_spec in QUANT_SERVE_RUNS + QUANT_PRESET_RUNS:
        t0 = time.monotonic()
        serve[tag] = asyncio.run(_serve(torch, ks, card, tag, engine_cfg,
                                        prompt_spec))
        _freed(torch, tag, t0)
    out["serve"] = serve
    t0 = time.monotonic()
    out["concurrent"] = asyncio.run(_quant_concurrent(torch, card))
    _freed(torch, "quant concurrent", t0)
    t0 = time.monotonic()
    out["graphs"] = _graph_check(torch, *QUANT_GRAPH_RUN)
    _freed(torch, "graphs mixtral", t0)

    from llmapigateway_tpu_torch.tools import make_synthetic_checkpoint
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as d:
        written = make_synthetic_checkpoint.main([
            "--preset", QUANT_CKPT_PRESET, "--out", d, "--n-layers",
            str(QUANT_CKPT_LAYERS), "--shard-gb", "1"])
        write_s = time.monotonic() - t0
        out["checkpoint"] = {"written": written, "write_s": write_s,
                             **asyncio.run(_quantized_load(
                                 torch, d, "int8", QUANT_CKPT_ENGINE,
                                 "quant checkpoint mixtral-8x7b"))}
    emit({"phase": "quant-checkpoint", "card": card, **out["checkpoint"]})
    _freed(torch, "quant checkpoint", t0)
    return out


# ---------------------------------------------------------------------------
# Phase 12: the port's bench tool, short
# ---------------------------------------------------------------------------

def bench_phase(torch) -> dict:
    """The bench tool (llmapigateway_tpu_torch/tools/bench.py) at
    BENCH_ARGS on the card; it prints its own JSON line."""
    from llmapigateway_tpu_torch.tools import bench
    result = bench.main(BENCH_ARGS)
    extra = result.get("extra", {})
    sp = extra.get("shared_prefix") or {}
    emit({"phase": "bench", "args": BENCH_ARGS, "metric": result["metric"],
          "value": result["value"], "card": extra.get("card"),
          "shared_prefix": sp, "ttft_target": extra.get("ttft_target"),
          **{a: extra.get(a) for a in ("quant_int8", "quant_int8_kv8",
                                       "quant_int4_kv8")},
          "errors": extra.get("errors")})
    check(result["value"] > 0, f"bench: value {result['value']}")
    check(not extra.get("errors"), f"bench: rungs failed: {extra}")
    check(str(extra.get("card")).endswith("W"),
          f"bench: no card name and power limit: {extra.get('card')}")
    check(bool(sp) and sp["warm_prefill_calls_max"]
          < sp["cold_prefill_calls"],
          f"bench: warm requests did not skip prefill: {sp}")
    tt = extra.get("ttft_target") or {}
    check(tt.get("scheduler_tok_s", 0) > 0 and tt.get("graph_replays", 0) > 0,
          f"bench: the ttft_target rung did not run on decode graphs: {tt}")
    arms = {a: extra.get(a) or {} for a in ("quant_int8", "quant_int8_kv8",
                                            "quant_int4_kv8")}
    check(all(a.get("tok_s", 0) > 0 and a.get("speedup_vs_bf16")
              for a in arms.values())
          and "speedup_vs_int8" in arms["quant_int4_kv8"]
          and arms["quant_int4_kv8"]["weight_bytes"]
          < arms["quant_int8"]["weight_bytes"],
          f"bench: the quant rung's arms: {arms}")
    _freed(torch, "bench", time.monotonic())
    return result


# ---------------------------------------------------------------------------

def kernels_line(kernel_rows: list[dict], serve: dict,
                 insert_rows: list[dict], tools: dict,
                 quant: dict) -> dict:
    """One row per kernel body and shape: a prefill body's times are its
    first chunk length's (T 512), its error the largest over both.
    ``launches`` counts the launches of the row's body at the row's head
    width and group in the serve run of the row's model, layout, KV type
    and pages per block (``serve``); every body must have run there. Kernel
    #5's row is timed at the insert tool's shape, its error the largest
    over both shapes, its launches those of the tools phase."""
    from llmapigateway_tpu_torch.ops.flash_attention import body_name
    rows = {}
    for r in kernel_rows:
        if r["name"] in rows:
            row = rows[r["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
            continue
        shape = r["shape"]
        body = body_name(r["window"], r["pages_per_block"], r["kv"] == "int8",
                         shape["Dh"], shape["H"] // shape["KV"])
        runs = [tag for tag, res in serve.items()
                if res["engine"]["preset"] == r["model"]
                and res["engine"]["kv_layout"] == r["layout"]
                and res["engine"]["kv_quant"] == ("int8" if r["kv"] == "int8"
                                                   else "")
                and res["geometry"]["kv_ppb"] == r["pages_per_block"]]
        check(bool(runs), f"{r['name']}: no serve run of {r['model']} "
                          f"{r['layout']} {r['kv']} ppb "
                          f"{r['pages_per_block']}")
        run = runs[0]
        launches = serve[run]["body_launches"][r["fn"]].get(body, 0)
        check(launches > 0, f"{r['name']}: its body {body} never ran on the "
                            f"main path of serve run {run}")
        rows[r["name"]] = {
            "name": r["name"], "route": "cuda",
            "source": f"llmapigateway_tpu_torch/csrc/{SOURCES[r['layout']]}",
            "replaces": REPLACES[(r["kind"], r["layout"])],
            "launches": launches, "serve": run, "body": body,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "host_ms": r["host_ms"],
            **{k: r[k] for k in ("n_split", "workspace_bytes") if k in r}}
    ins = insert_rows[0]
    launches = tools["profile_insert"]["kernel_launches"]
    check(launches > 0, "kv_insert: kernel #5 never ran in the tools phase")
    rows[ins["name"]] = {
        "name": ins["name"], "route": "cuda",
        "source": "llmapigateway_tpu_torch/csrc/kv_insert.cu",
        "replaces": "tools/profile_insert.py:66", "launches": launches,
        "serve": "tools: profile_insert",
        "max_abs_err": max(r["max_abs_err"] for r in insert_rows),
        "ms": ins["ms"], "plain_ms": ins["plain_ms"],
        "bound_ms": ins["bound_ms"], "bound_by": ins["bound_by"],
        "library_ms": ins["library_ms"],
        "launch_floor_ms": ins["launch_floor_ms"],
        "single_launch_ms": ins["single_launch_ms"]}
    # The W4A8 kernel, one row per shape: its launches are those of its
    # (K, N) in the int4 serve run of the row's model.
    for r in quant["w4a8"]:
        run = next(tag for tag, cfg, _ in QUANT_SERVE_RUNS
                   if cfg["preset"] == r["model"] and cfg["quant"] == "int4")
        launches = quant["serve"][run]["body_launches"]["w4a8_mm"].get(
            r["body"], 0)
        check(launches > 0, f"{r['name']}: its shape {r['body']} never ran "
                            f"on the main path of serve run {run}")
        rows[r["name"]] = {
            "name": r["name"], "route": "cuda",
            "source": "llmapigateway_tpu_torch/csrc/w4a8_mm.cu",
            "replaces": W4A8_REPLACES, "launches": launches, "serve": run,
            "body": r["body"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "host_ms": r["host_ms"]}
    return {"kernels": list(rows.values())}


# ---------------------------------------------------------------------------
# --decode-ab / --prefill-ab: one kind's rows of several checkouts, one timer
# ---------------------------------------------------------------------------

# Run in a fresh process per tree: the tree's own chip_smoke.py and package
# first on the path; this checkout's timer and row helpers loaded by path.
_AB_RUN = r"""
import importlib.util, json, sys
tree, here, kind = sys.argv[1:4]
sys.path.insert(0, tree)
import torch
def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
timing = load("ab_timing", here + "/llmapigateway_tpu_torch/tools/_timing.py")
this = load("ab_smoke", here + "/chip_smoke.py")
import chip_smoke as cs
cs.cuda_times = lambda torch, fn, iters=25, warmup=3: timing.device_times(
    fn, iters, warmup)
# A tree whose smoke keeps only a device ms gets [device ms, host ms].
cs.cuda_ms = lambda torch, fn, iters=25, warmup=3: list(
    timing.device_times(fn, iters, warmup))
from llmapigateway_tpu_torch.ops import _kernels
from llmapigateway_tpu_torch.ops import flash_attention as fa
from llmapigateway_tpu_torch.ops import paged_attention as pa
torch.backends.cuda.matmul.allow_tf32 = False
_kernels.build()
gen = torch.Generator(device="cuda").manual_seed(0)
rows = getattr(this, kind + "_rows")(torch, cs.Kernels(pa, fa), gen, cs)
print("AB_ROWS " + json.dumps({
    this.ab_key(r): r["ms"] if isinstance(r["ms"], list)
    else [r["ms"], r["host_ms"]] for r in rows}))
"""


def ab_key(row: dict) -> str:
    """A timed row's name in an A/B report: its name, and a prefill row's
    chunk length (one name covers T 512 and T 300)."""
    T = row["shape"].get("T")
    return row["name"] if T is None else f"{row['name']} T={T}"


def run_ab(kind: str, argv) -> int:
    """Each tree's ``kind`` rows (:func:`decode_rows` or
    :func:`prefill_rows` over its own smoke's cases, inputs and checks; the
    prefill chunk lengths are this checkout's) in a fresh process, in the order given, all timed by this checkout's
    timer: [device ms, host ms of one call] per row and run and, for two
    distinct trees, each tree's median device and host ms and the change /
    parent ratio of the device ms (first tree first) on the rows both
    trees have."""
    import argparse
    ap = argparse.ArgumentParser(prog=f"chip_smoke.py --{kind}-ab")
    ap.add_argument("trees", nargs="+", help="tree roots, in run order")
    ap.add_argument("--out", help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, "-c", _AB_RUN, os.path.abspath(tree), HERE,
             kind], capture_output=True, text=True, cwd=os.path.abspath(tree))
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB_ROWS ")]
        if proc.returncode != 0 or not lines:
            print(f"chip_smoke --{kind}-ab: {tree} failed "
                  f"({proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        runs.append((tree, json.loads(lines[-1][len("AB_ROWS "):])))
    report = {"kind": kind, "runs": [{"tree": t, "ms": ms} for t, ms in runs]}
    trees = list(dict.fromkeys(args.trees))
    if len(trees) == 2:
        names = [n for n in runs[0][1] if all(n in ms for _, ms in runs)]
        med = {t: {n: [statistics.median(ms[n][i] for tt, ms in runs
                                         if tt == t) for i in (0, 1)]
                   for n in names} for t in trees}
        report["median_ms"] = med
        report["ratio"] = {n: med[trees[1]][n][0] / med[trees[0]][n][0]
                           for n in names}
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


# The bench tool's arguments for --bench-ab: the headline arms at
# tinyllama-1.1b with TTFT under load, flags every tree's bench takes.
BENCH_AB_ARGS = ["--preset", "tinyllama-1.1b", "--steps", "64",
                 "--ttft-probes", "5", "--eight-b", "0", "--swa", "0",
                 "--long-ctx", "0", "--second-preset", "",
                 "--shared-prefix", "0"]


def run_bench_ab(argv) -> int:
    """Each tree's own bench tool at BENCH_AB_ARGS in a fresh process from
    the tree's root, in the order given: the headline tok/s, every arm's
    tok/s and ms per step, and the first arm's TTFT p50/p95 under load; for
    two distinct trees each tree's medians and the change / parent ratios
    (first tree first)."""
    import argparse
    ap = argparse.ArgumentParser(prog="chip_smoke.py --bench-ab")
    ap.add_argument("trees", nargs="+", help="tree roots, in run order")
    ap.add_argument("--out", help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, "-m", "llmapigateway_tpu_torch.tools.bench",
             *BENCH_AB_ARGS], capture_output=True, text=True,
            cwd=os.path.abspath(tree))
        try:
            line = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            line = None
        if proc.returncode != 0 or not line or line["value"] <= 0:
            print(f"chip_smoke --bench-ab: {tree} failed "
                  f"({proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        extra = line["extra"]
        arms = {k: {"tok_s": v["tok_s"],
                    "ms_per_decode_step": v["ms_per_decode_step"]}
                for k, v in extra.items()
                if isinstance(v, dict) and "tok_s" in v}
        head = next(v for v in extra.values()
                    if isinstance(v, dict) and "ttft_p50_ms" in v)
        runs.append({"tree": tree, "tok_s": line["value"], "arms": arms,
                     "ttft_p50_ms": head["ttft_p50_ms"],
                     "ttft_p95_ms": head["ttft_p95_ms"],
                     "card": extra.get("card")})
    report = {"kind": "bench", "args": BENCH_AB_ARGS, "runs": runs}
    trees = list(dict.fromkeys(args.trees))
    if len(trees) == 2:
        med = {t: {k: statistics.median(r[k] for r in runs if r["tree"] == t)
                   for k in ("tok_s", "ttft_p50_ms")} for t in trees}
        report["median"] = med
        report["ratio"] = {k: med[trees[1]][k] / med[trees[0]][k]
                           for k in ("tok_s", "ttft_p50_ms")}
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


def main(argv=()) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if argv[:1] in (["--decode-ab"], ["--prefill-ab"]):
        return run_ab(argv[0][2:-3], argv[1:])
    if argv[:1] == ["--bench-ab"]:
        return run_bench_ab(argv[1:])
    sys.path.insert(0, HERE)
    try:
        from llmapigateway_tpu_torch.ops import _kernels
        from llmapigateway_tpu_torch.ops import flash_attention as fa
        from llmapigateway_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the llmapigateway_tpu_torch package is not "
              f"beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ks = Kernels(pa, fa)
    seconds = {}

    try:
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})

        t0 = time.monotonic()
        builds = _kernels.build()
        for name in _kernels.SOURCES:
            _kernels.library(name)
        seconds["build"] = time.monotonic() - t0
        emit({"phase": "build", "arch": "sm_90a", "wall_s": seconds["build"],
              "smem_bytes": body_smem_bytes(_kernels.HEAD_DIMS),
              "sources": {name: {
                  "library": os.path.relpath(b.path, HERE),
                  "seconds": b.seconds,
                  "ptxas": [ln.strip() for ln in b.log.splitlines()
                            if "Compiling entry" in ln or "registers" in ln
                            or "spill" in ln]} for name, b in builds.items()}})

        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.monotonic()
        kernel_rows = kernel_phase(torch, ks, gen)
        insert_rows = [check_insert(torch, gen, shape)
                       for shape in INSERT_SHAPES]
        seconds["kernel"] = time.monotonic() - t0
        t0 = time.monotonic()
        check_model(torch)
        seconds["model"] = time.monotonic() - t0
        t0 = time.monotonic()
        graphs_phase(torch)
        seconds["graphs"] = time.monotonic() - t0
        t0 = time.monotonic()
        tools = tools_phase(torch, ks)
        seconds["tools"] = time.monotonic() - t0
        t0 = time.monotonic()
        serve = serve_phase(torch, ks, smi)
        seconds["serve"] = time.monotonic() - t0
        t0 = time.monotonic()
        prefix_phase(torch, ks, smi)
        seconds["prefix"] = time.monotonic() - t0
        t0 = time.monotonic()
        gateway_phase(torch, ks, smi)
        seconds["gateway"] = time.monotonic() - t0
        t0 = time.monotonic()
        checkpoint_phase(torch, ks, smi)
        seconds["checkpoint"] = time.monotonic() - t0
        t0 = time.monotonic()
        quant = quant_phase(torch, ks, smi, gen)
        seconds["quant"] = time.monotonic() - t0
        t0 = time.monotonic()
        bench_phase(torch)
        seconds["bench"] = time.monotonic() - t0

        line = kernels_line(kernel_rows, serve, insert_rows, tools, quant)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    emit({"phase": "seconds", **seconds})
    emit(line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
