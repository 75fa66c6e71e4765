#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``llmapigateway_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

or, to time the decode (or prefill) rows of several checkouts in turn with
one timer (say a ``git archive`` of the parent, this one, this one, the
parent)::

    python3 chip_smoke.py --decode-ab TREE [TREE ...] [--out FILE]
    python3 chip_smoke.py --prefill-ab TREE [TREE ...] [--out FILE]

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
5. tools   — the three engine-driving tools (llmapigateway_tpu_torch/tools/)
             with their default flags at tinyllama-1.1b width and depth:
             every KV-insert variant, kernel #5 launched twice per layer
             per step and its caches equal to index_put's; the decode
             ablation with the kernels' attention (kernel #3 once per layer
             per step); the engine's bursts on both layouts.
6. serve   — the port's aiohttp app in-process on a local port, once per
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
7. the ``kernels`` line (decode rows with the key split ``n_split`` and
   workspace bytes of their timed launch), the nvidia-smi line, and last the contract line
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line. Without a CUDA card,
or without the package beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import asyncio
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
        return list(self.fn.values())

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
    at their split edges. Returns the timed rows."""
    rows = decode_rows(torch, ks, gen)
    rows += prefill_rows(torch, ks, gen)
    from llmapigateway_tpu_torch.ops import _kernels
    check_groups(torch, ks, _kernels.GROUP_SIZES, _kernels.HEAD_DIMS, gen)
    check_split_edges(torch, ks, gen)
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
# Phase 5: the engine-driving tools at tinyllama-1.1b width and depth
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
# Phase 6: serve /v1/chat/completions at full width, per configuration
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    from aiohttp import web

    from llmapigateway_tpu_torch.config.loader import ConfigLoader
    from llmapigateway_tpu_torch.config.settings import Settings
    from llmapigateway_tpu_torch.ops.flash_attention import (body_name,
                                                            reset_launches)
    from llmapigateway_tpu_torch.providers.local import make_local_provider
    from llmapigateway_tpu_torch.server.app import build_app
    from llmapigateway_tpu_torch.utils.sse import SSEParser

    layout = engine_cfg["kv_layout"]
    model = engine_cfg["preset"]
    with tempfile.TemporaryDirectory() as cfg_dir:
        with open(os.path.join(cfg_dir, "providers.json"), "w") as f:
            json.dump([{"local": {"type": "local", "engine": engine_cfg}}], f)
        with open(os.path.join(cfg_dir, "models_fallback_rules.json"), "w") as f:
            json.dump([{"gateway_model_name": "gw/model",
                        "fallback_models": [{"provider": "local",
                                             "model": model}]}], f)
        settings = Settings(fallback_provider="local", config_dir=cfg_dir)
        app = build_app(settings, loader=ConfigLoader(cfg_dir, "local"),
                        local_factory=functools.partial(make_local_provider,
                                                        device="cuda"))
        runner = web.AppRunner(app)
        await runner.setup()
        port = _free_port()
        site = web.TCPSite(runner, "127.0.0.1", port)
        await site.start()
        try:
            t0 = time.monotonic()
            provider = await app["gateway"].registry.get("local")
            check(provider is not None,
                  f"serve {tag}: the local provider did not build")
            engine = provider.engine
            torch.cuda.synchronize()
            build_s = time.monotonic() - t0
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
                body = {"model": "gw/model", "temperature": 0,
                        "max_tokens": SERVE_MAX_TOKENS, "stream": stream,
                        "messages": [{"role": "user", "content": text}]}
                async with session.post(
                        f"http://127.0.0.1:{port}/v1/chat/completions",
                        json=body) as resp:
                    if resp.status != 200:
                        raise SmokeFailure(
                            f"serve {tag}: HTTP {resp.status}: "
                            f"{await resp.text()}")
                    if not stream:
                        out = await resp.json()
                        return {"usage": out["usage"],
                                "text": out["choices"][0]["message"]["content"],
                                "finish": out["choices"][0]["finish_reason"]}
                    parser, frames = SSEParser(), []
                    async for chunk in resp.content.iter_any():
                        frames.extend(parser.feed(chunk))
                    check(bool(frames) and frames[-1].is_done,
                          f"serve {tag}: SSE stream did not end in [DONE]: "
                          f"{[fr.data[:200] for fr in frames[-2:]]}")
                    usage = [fr.json["usage"] for fr in frames
                             if fr.json and "usage" in fr.json]
                    choices = [fr.json["choices"][0] for fr in frames
                               if fr.json and fr.json.get("choices")]
                    text = "".join(c["delta"].get("content") or ""
                                   for c in choices)
                    finish = [c["finish_reason"] for c in choices
                              if c.get("finish_reason")]
                    check(len(usage) == 1,
                          f"serve {tag}: SSE usage frame missing")
                    return {"usage": usage[0], "text": text,
                            "finish": finish[-1] if finish else None}

            ring = _watch_ring(engine) if engine.paged else None
            _gate_first_step(engine, len(prompts))
            # Zero every launch count just before driving the main path.
            for fn in ks.all_wrappers():
                reset_launches(fn)
            engine.decode_steps = engine.prefill_calls = 0
            engine.prefill_one_token_calls = 0
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
        finally:
            await runner.cleanup()
    del provider, engine, app, runner, site

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
    decode_k = ks.name("decode", layout)
    prefill_k = ks.name("prefill", layout)
    other = "contiguous" if layout == "paged" else "paged"
    body = body_name(window, geometry["kv_ppb"],
                     engine_cfg["kv_quant"] == "int8", geometry["head_dim"],
                     geometry["group"])
    check(launches[decode_k] > 0,
          f"serve {tag}: the decode kernel never ran on the main path")
    check(launches[prefill_k] > 0,
          f"serve {tag}: the prefill kernel never ran on the main path")
    # A prefill call one token wide runs the decode kernel (the forward's
    # T == 1 path); every other prefill call runs the prefill kernel. Every
    # launch is of the configured body at the model's head geometry.
    one_tok = steps["prefill_one_token_calls"]
    want = {decode_k: n_layers * (steps["decode_steps"] + one_tok),
            prefill_k: n_layers * (steps["prefill_calls"] - one_tok)}
    for name, n in want.items():
        check(bodies[name] == {body: n},
              f"serve {tag}: {name} ran {bodies[name]}, expected "
              f"{{{body!r}: {n}}} ({n_layers} layers x {steps})")
    for kind in ("decode", "prefill"):
        name = ks.name(kind, other)
        check(launches[name] == 0,
              f"serve {tag}: the {other} layout's kernel {name} ran "
              f"{launches[name]} times")
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
           "note": "TTFT and tok/s are information only"}
    emit(res)
    res["texts"] = [r["text"] for r in results]
    return res


def serve_phase(torch, ks, card: str) -> dict:
    """Phase 5: each served configuration in turn; the card holds one
    engine at a time."""
    out = {}
    for tag, engine_cfg, prompt_spec in SERVE_RUNS:
        t0 = time.monotonic()
        out[tag] = asyncio.run(_serve(torch, ks, card, tag, engine_cfg,
                                      prompt_spec))
        gc.collect()
        torch.cuda.empty_cache()
        freed = torch.cuda.memory_allocated()
        emit({"phase": "serve-freed", "config": tag,
              "allocated_bytes": freed,
              "seconds": time.monotonic() - t0})
        check(freed < FREED_BYTES_MAX,
              f"serve {tag}: {freed} bytes still allocated after the engine "
              f"stopped")
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

def kernels_line(kernel_rows: list[dict], serve: dict,
                 insert_rows: list[dict], tools: dict) -> dict:
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
        tools = tools_phase(torch, ks)
        seconds["tools"] = time.monotonic() - t0
        t0 = time.monotonic()
        serve = serve_phase(torch, ks, smi)
        seconds["serve"] = time.monotonic() - t0

        line = kernels_line(kernel_rows, serve, insert_rows, tools)
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
