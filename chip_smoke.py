#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``llmapigateway_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as JSON lines:

1. device  — ``nvidia-smi`` name and power limit, ``torch.cuda`` name.
2. build   — every CUDA source in ``llmapigateway_tpu_torch/csrc/``
             compiled for sm_90a, one ``nvcc`` per source, all started
             together (build time, and ptxas's registers, shared memory
             and spills per kernel).
3. kernel  — each kernel's wrapper against its plain PyTorch version on the
             same card tensors at the main path's shapes (llama-3-8b heads):
             the paged kernels over a page pool, the flash kernels over a
             contiguous cache [8, 8, 4096, 128], each with a bf16 cache and
             with an int8 cache and its fp32 scales. Per-element error
             against the fp32 plain output under the stated relative +
             absolute tolerance, and times (CUDA events, median of 25 runs
             with L2 flushed before each) beside the plain version, one
             library call on the dense view (``scaled_dot_product_attention``
             on bf16 K/V; timed only — the port never calls it; no library
             call takes int8 K/V with per-key scales) and the least time the
             card could take. Then every group size the kernels are built
             for, held the same way, for every kernel body.
4. model   — a two-layer model of llama-3-8b head geometry through the
             port's forward on the card (kernels) against the same weights
             through the plain path on the CPU in fp32, on both layouts and
             both cache types; and the LM head at llama-3-8b's shape, which
             must give fp32 logits equal to the fp32 product of its bf16
             operands.
5. serve   — the port's aiohttp app in-process on a local port with the
             llama-3-8b config (full width, random weights from a seed),
             once per served configuration: contiguous bf16 KV, contiguous
             int8 KV, paged int8 KV and paged bf16 KV, each engine stopped
             and its memory freed before the next is built. 2 SSE + 2 JSON
             concurrent requests whose prompts cross a KV page and a prefill
             chunk. Launch counters are zeroed just before each run and read
             just after: the layout's kernels must have run once per layer
             per forward of their kind (a one-token prefill call runs the
             decode kernel), the other layout's not at all.
6. the ``kernels`` line, the nvidia-smi line, and last the contract line
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
# Decode groups (query heads per KV head) the kernels are built for, each
# held to the plain version at H 32 and a batch of long and short slots.
GROUP_CASES = dict(B=4, H=32, n_stale=[0, 257, 1000, 4095], T=100,
                   starts=[0, 1000])
# LM head: fp32 logits from bf16 operands, against the fp32 product of the
# same values; a bf16 rounding of the logits (2^-9 of the largest) fails.
HEAD_REL_TOL = 2.0 ** -12
# Model check: bf16 weights and activations on the card (cuBLAS projections,
# bf16 rounding after every op) against fp32 on the CPU; relative to the
# largest reference logit.
MODEL_REL_TOL = 5e-2

DECODE = dict(B=8, H=32, KV=8, Dh=128, page=256, NP=16, S=4096,
              n_stale=[0, 1, 255, 256, 257, 1000, 2047, 4095])
PREFILL = dict(H=32, KV=8, Dh=128, page=256, NP=16, S=4096,
               starts=[0, 256, 1000], T=(512, 300))
LIBRARY_NONE = ("no single PyTorch call takes int8 K/V with per-key fp32 "
                "scales")
# The served configurations, in order. Weights (16 GB) and KV cache live on
# the card one engine at a time.
SERVE_BASE = {"preset": "llama-3-8b", "max_batch_size": 8,
              "max_seq_len": 4096, "prefill_chunk": 512, "mesh": {}}
SERVE_CONFIGS = [
    ("contiguous-bf16", {"kv_layout": "contiguous", "kv_quant": ""}),
    ("contiguous-int8", {"kv_layout": "contiguous", "kv_quant": "int8"}),
    ("paged-int8", {"kv_layout": "paged", "kv_page_size": 256,
                    "kv_pages_per_block": 1, "prefix_cache": False,
                    "kv_quant": "int8"}),
    ("paged-bf16", {"kv_layout": "paged", "kv_page_size": 256,
                    "kv_pages_per_block": 1, "prefix_cache": False,
                    "kv_quant": ""}),
]
SERVE_MAX_TOKENS = 32
# Prompt lengths in bytes (one token each, plus the chat template's ~25):
# one within a page, one across a page, two across a prefill chunk.
SERVE_PROMPT_CHARS = (40, 300, 700, 1100)


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

def cuda_ms(torch, fn, iters: int = 25, warmup: int = 3) -> float:
    """Median ms of ``fn`` on the card: a CUDA event pair per run, L2
    flushed (a 128 MB write) before each, as the main path finds each
    layer's cache cold."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def quantized(torch, x):
    """A [N, KV, S, Dh] bf16 cache (or pool) → the port's int8 dict, through
    the port's own quantizer."""
    from llmapigateway_tpu_torch.models.llama import quantize_kv
    q, s = quantize_kv(x)
    return {"q": q, "s": s[:, :, None, :].contiguous()}


def _pool_and_table(torch, gen, B, KV, Dh, page, NP, live_pages, quant):
    """A pool with page 0 (trash) filled with a large finite value, and a
    shuffled page table whose entries past each slot's live pages are 0 — a
    kernel that reads the trash page for a live key, or a dead page, shows
    up in the error. int8: the pool quantized, trash at q 127, scale 1e3."""
    P = B * NP + 1
    pools = []
    for _ in range(2):
        pool = torch.randn((P, KV, page, Dh), generator=gen, device="cuda"
                           ).to(torch.bfloat16)
        pool[0] = 3e4
        if quant:
            pool = quantized(torch, pool)
            pool["q"][0] = 127
            pool["s"][0] = 1e3
        pools.append(pool)
    perm = torch.randperm(B * NP, generator=gen, device="cuda") + 1
    table = perm.reshape(B, NP).to(torch.int32)
    for b, n in enumerate(live_pages):
        table[b, n:] = 0
    return pools[0], pools[1], table.contiguous()


def _cache(torch, gen, B, KV, S, Dh, quant):
    """A contiguous cache layer [B, KV, S, Dh] of random values: positions
    past a row's live keys hold values too, so a kernel that reads them
    shows up in the error."""
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
                  page=256, NP=16, S=4096):
    """(wrapper args, dense K, dense V, live extent) of one decode case:
    q, k_new, v_new, the cache (a page pool and its table, or a contiguous
    layer), n_stale."""
    if layout == "paged":
        live = [-(-n // page) for n in n_list]
        k, v, table = _pool_and_table(torch, gen, B, KV, Dh, page, NP, live,
                                      quant)
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
                   page=256, NP=16, S=4096):
    B = len(starts)
    if layout == "paged":
        live = [-(-(s + T) // page) for s in starts]
        k, v, table = _pool_and_table(torch, gen, B, KV, Dh, page, NP, live,
                                      quant)
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


def _dense_view(ks, layout, side, table, S):
    """The bf16 dense [B, KV, S, Dh] view of one cache side (SDPA input)."""
    if layout == "paged":
        return ks.pa.gather_pages(side, table, S)
    return side[:, :, :S]


def check_decode(torch, ks, gen, layout, quant) -> dict:
    d = DECODE
    B, H, KV, Dh = d["B"], d["H"], d["KV"], d["Dh"]
    n_list = d["n_stale"]
    args = decode_inputs(torch, gen, layout, quant, B, H, KV, n_list, Dh,
                         d["page"], d["NP"], d["S"])
    q, k_new, v_new = args[:3]
    n_stale = args[-1]
    fn, plain = ks.fn[("decode", layout)], ks.plain[("decode", layout)]
    name = f"{fn.__name__}{'_int8' if quant else ''}"

    got = fn(*args)
    torch.cuda.synchronize()
    err = held(torch, name, got, plain(*_fp32(args)))
    kernel_ms = cuda_ms(torch, lambda: fn(*args))
    plain_ms = cuda_ms(torch, lambda: plain(*args), iters=5)
    library_ms = None
    if not quant:
        # Library yardstick: SDPA over the dense stale view + self column.
        S = (max(-(-n // d["page"]) for n in n_list) * d["page"]
             if layout == "paged" else max(n_list))
        table = args[5] if layout == "paged" else None
        dk = _dense_view(ks, layout, args[3], table, S)
        dv = _dense_view(ks, layout, args[4], table, S)
        k_all = torch.cat([dk, k_new[:, :, None]], dim=2)
        v_all = torch.cat([dv, v_new[:, :, None]], dim=2)
        pos = torch.arange(S + 1, device="cuda")
        mask = ((pos[None, :] < n_stale[:, None]) | (pos[None, :] == S))[
            :, None, None, :]
        library_ms = cuda_ms(torch, lambda: sdpa(torch, q[:, :, None], k_all,
                                                 v_all, mask))
    tokens = sum(n_list)
    index_bytes = sum(a.nbytes for a in args[5:] if hasattr(a, "nbytes"))
    n_bytes = (q.nbytes + k_new.nbytes + v_new.nbytes + got.nbytes
               + index_bytes + tokens * kv_bytes_per_key(quant, KV, Dh))
    n_flops = B * H * (tokens / B + 1) * Dh * 4
    bound_ms, bound_by = bound(n_bytes, n_flops)
    res = {"phase": "kernel", "name": name, "layout": layout,
           "kv": "int8" if quant else "bf16",
           "shape": {"B": B, "H": H, "KV": KV, "Dh": Dh,
                     **({"page": d["page"], "NP": d["NP"]}
                        if layout == "paged" else {"S": d["S"]}),
                     "n_stale": n_list},
           **err, "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           **({"library_none": LIBRARY_NONE} if quant else {}),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "live_kv_bytes": tokens * kv_bytes_per_key(quant, KV, Dh)}
    emit(res)
    check(err["max_err_over_tol"] <= 1.0, f"{name} disagrees: {err}")
    return res


def check_prefill(torch, ks, gen, layout, quant, T: int) -> dict:
    d = PREFILL
    H, KV, Dh = d["H"], d["KV"], d["Dh"]
    starts = d["starts"]
    B = len(starts)
    args = prefill_inputs(torch, gen, layout, quant, T, H, KV, starts, Dh,
                          d["page"], d["NP"], d["S"])
    q, start = args[0], args[-1]
    fn, plain = ks.fn[("prefill", layout)], ks.plain[("prefill", layout)]
    name = f"{fn.__name__}{'_int8' if quant else ''}"

    got = fn(*args)
    torch.cuda.synchronize()
    err = held(torch, f"{name} T={T}", got, plain(*_fp32(args)))
    kernel_ms = cuda_ms(torch, lambda: fn(*args))
    plain_ms = cuda_ms(torch, lambda: plain(*args), iters=5)
    library_ms = None
    if not quant:
        S = max(starts) + T
        table = args[3] if layout == "paged" else None
        dk = _dense_view(ks, layout, args[1], table, S)
        dv = _dense_view(ks, layout, args[2], table, S)
        q_pos = start[:, None] + torch.arange(T, device="cuda")[None, :]
        mask = (torch.arange(S, device="cuda")[None, None, :]
                <= q_pos[:, :, None])[:, None]
        qh = q.transpose(1, 2)
        library_ms = cuda_ms(torch, lambda: sdpa(torch, qh, dk, dv, mask))
    keys = sum(s + T for s in starts)
    index_bytes = sum(a.nbytes for a in args[3:] if hasattr(a, "nbytes"))
    n_bytes = (q.nbytes + got.nbytes + index_bytes
               + keys * kv_bytes_per_key(quant, KV, Dh))
    # Each query t of slot b sees start_b + t + 1 keys: QK and PV, 2 flops
    # per multiply-add, per head.
    n_flops = sum(H * Dh * 4 * (T * (s + 1) + T * (T - 1) / 2)
                  for s in starts)
    bound_ms, bound_by = bound(n_bytes, n_flops)
    res = {"phase": "kernel", "name": name, "layout": layout,
           "kv": "int8" if quant else "bf16",
           "shape": {"B": B, "T": T, "H": H, "KV": KV, "Dh": Dh,
                     **({"page": d["page"], "NP": d["NP"]}
                        if layout == "paged" else {"S": d["S"]}),
                     "start": starts},
           **err, "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           **({"library_none": LIBRARY_NONE} if quant else {}),
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(res)
    check(err["max_err_over_tol"] <= 1.0, f"{name} (T={T}) disagrees: {err}")
    return res


def check_groups(torch, ks, group_sizes, gen) -> list[dict]:
    """Every group size the kernels are built for (H 32 over H/G KV heads),
    every kernel body (paged and contiguous, bf16 and int8, decode and
    prefill), held to the plain versions. Not timed."""
    c = GROUP_CASES
    H = c["H"]
    rows = []
    for G in group_sizes:
        KV = H // G
        for layout in ("paged", "contiguous"):
            for quant in (False, True):
                dargs = decode_inputs(torch, gen, layout, quant, c["B"], H,
                                      KV, c["n_stale"])
                pargs = prefill_inputs(torch, gen, layout, quant, c["T"], H,
                                       KV, c["starts"])
                tag = f"{layout} {'int8' if quant else 'bf16'} G={G}"
                rows.append({
                    "G": G, "KV": KV, "layout": layout,
                    "kv": "int8" if quant else "bf16",
                    "decode": held(torch, f"decode {tag}",
                                   ks.fn[("decode", layout)](*dargs),
                                   ks.plain[("decode", layout)](
                                       *_fp32(dargs))),
                    "prefill": held(torch, f"prefill {tag}",
                                    ks.fn[("prefill", layout)](*pargs),
                                    ks.plain[("prefill", layout)](
                                        *_fp32(pargs)))})
    emit({"phase": "groups", "shape": c, "rtol": KERNEL_RTOL,
          "atol": KERNEL_ATOL, "groups": rows})
    for r in rows:
        for k in ("decode", "prefill"):
            check(r[k]["max_err_over_tol"] <= 1.0,
                  f"{k} kernel disagrees at {r['layout']} {r['kv']} "
                  f"G={r['G']}: {r[k]}")
    return rows


def kernel_phase(torch, ks, gen) -> dict:
    """Phase 3: every kernel body at the main path's shapes, then every
    group size. Returns {(kind, layout, quant): [results]}."""
    out = {}
    for layout in ("paged", "contiguous"):
        for quant in (False, True):
            out[("decode", layout, quant)] = [
                check_decode(torch, ks, gen, layout, quant)]
            out[("prefill", layout, quant)] = [
                check_prefill(torch, ks, gen, layout, quant, T)
                for T in PREFILL["T"]]
    from llmapigateway_tpu_torch.ops import _kernels
    check_groups(torch, ks, _kernels.GROUP_SIZES, gen)
    return out


# ---------------------------------------------------------------------------
# Phase 4: a small model of the main path's head geometry, card vs CPU
# ---------------------------------------------------------------------------

def check_model(torch) -> dict:
    from llmapigateway_tpu_torch.models.config import ModelConfig
    from llmapigateway_tpu_torch.models.llama import (KVCache, forward,
                                                      init_params)
    from llmapigateway_tpu_torch.ops.flash_attention import (
        make_cache_attention_fn)
    from llmapigateway_tpu_torch.ops.paged_attention import (
        PagedKVCache, make_paged_attention_fn)

    cfg = ModelConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                      n_kv_heads=1, d_ff=1024, rope_theta=500000.0,
                      max_seq_len=1024)                 # Dh 128, G 4
    gen = torch.Generator(device="cpu").manual_seed(1)
    params_cpu = init_params(cfg, gen, dtype=torch.bfloat16)
    page, B, P = 256, 2, 9
    table = torch.tensor([[3, 7, 0, 0], [5, 2, 8, 0]], dtype=torch.int32)
    prompt = torch.randint(0, 512, (B, 300), generator=gen)
    # Fixed decode inputs: both runs must see the same tokens.
    steps = torch.randint(0, 512, (4, B), generator=gen)

    def run(device, dtype, layout, kv_quant):
        params = {k: ({n: w.to(device, dtype) for n, w in v.items()}
                      if isinstance(v, dict) else v.to(device, dtype))
                  for k, v in params_cpu.items()}
        if layout == "paged":
            cache = PagedKVCache.create(cfg, P, page, dtype, kv_quant,
                                        device=device)
            attn = make_paged_attention_fn(table.to(device))
        else:
            cache = KVCache.create(cfg, B, 1024, dtype, kv_quant,
                                   device=device)
            attn = make_cache_attention_fn()
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
        for layout in ("paged", "contiguous"):
            for kv_quant in ("", "int8"):
                got = run("cuda", torch.bfloat16, layout, kv_quant)
                ref = run("cpu", torch.float32, layout, kv_quant)
                tag = f"{layout}-{kv_quant or 'bf16'}"
                check(bool(torch.isfinite(got).all()),
                      f"model {tag}: non-finite logits")
                check(got.shape == ref.shape == (5, B, cfg.vocab_size),
                      f"model {tag}: logits shape {tuple(got.shape)}")
                rels[tag] = ((got - ref).abs().max()
                             / ref.abs().max()).item()
    head = check_head(torch)
    res = {"phase": "model", "layers": cfg.n_layers, "prompt": 300,
           "decode_steps": 4, "max_rel_err": rels, "tol": MODEL_REL_TOL,
           "head": head}
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
# Phase 5: serve /v1/chat/completions at llama-3-8b width, per configuration
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _serve(torch, ks, card: str, tag: str, overrides: dict) -> dict:
    import aiohttp
    from aiohttp import web

    from llmapigateway_tpu_torch.config.loader import ConfigLoader
    from llmapigateway_tpu_torch.config.settings import Settings
    from llmapigateway_tpu_torch.providers.local import make_local_provider
    from llmapigateway_tpu_torch.server.app import build_app
    from llmapigateway_tpu_torch.utils.sse import SSEParser

    engine_cfg = {**SERVE_BASE, **overrides}
    layout = engine_cfg["kv_layout"]
    with tempfile.TemporaryDirectory() as cfg_dir:
        with open(os.path.join(cfg_dir, "providers.json"), "w") as f:
            json.dump([{"local": {"type": "local", "engine": engine_cfg}}], f)
        with open(os.path.join(cfg_dir, "models_fallback_rules.json"), "w") as f:
            json.dump([{"gateway_model_name": "gw/llama",
                        "fallback_models": [{"provider": "local",
                                             "model": "llama-3-8b"}]}], f)
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
            cache_kind = (f"{type(engine.cache).__name__}"
                          f"{'[int8]' if isinstance(engine.cache.k, dict) else ''}")

            words = ("the quick brown fox jumps over the lazy dog while "
                     "paged attention streams every live key once ")
            prompts = [(words * 20)[:n] for n in SERVE_PROMPT_CHARS]
            streams = [True, False, True, False]

            async def one(session, text, stream):
                body = {"model": "gw/llama", "temperature": 0,
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

            # Zero every launch count just before driving the main path.
            for fn in ks.all_wrappers():
                fn.launches = 0
            engine.decode_steps = engine.prefill_calls = 0
            engine.prefill_one_token_calls = 0
            t1 = time.monotonic()
            async with aiohttp.ClientSession() as session:
                results = await asyncio.gather(*[
                    one(session, p, s) for p, s in zip(prompts, streams)])
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t1
            launches = {fn.__name__: fn.launches for fn in ks.all_wrappers()}
            steps = {"decode_steps": engine.decode_steps,
                     "prefill_calls": engine.prefill_calls,
                     "prefill_one_token_calls":
                     engine.prefill_one_token_calls}
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
    decode_k = ks.name("decode", layout)
    prefill_k = ks.name("prefill", layout)
    other = "contiguous" if layout == "paged" else "paged"
    check(launches[decode_k] > 0,
          f"serve {tag}: the decode kernel never ran on the main path")
    check(launches[prefill_k] > 0,
          f"serve {tag}: the prefill kernel never ran on the main path")
    # A prefill call one token wide runs the decode kernel (the forward's
    # T == 1 path); every other prefill call runs the prefill kernel.
    one_tok = steps["prefill_one_token_calls"]
    check(launches[decode_k] == n_layers * (steps["decode_steps"] + one_tok),
          f"serve {tag}: decode launches {launches} != {n_layers} x {steps}")
    check(launches[prefill_k]
          == n_layers * (steps["prefill_calls"] - one_tok),
          f"serve {tag}: prefill launches {launches} != {n_layers} x {steps}")
    for kind in ("decode", "prefill"):
        name = ks.name(kind, other)
        check(launches[name] == 0,
              f"serve {tag}: the {other} layout's kernel {name} ran "
              f"{launches[name]} times")
    res = {"phase": "serve", "config": tag, "card": card,
           "engine": engine_cfg, "layers": n_layers, "cache": cache_kind,
           "requests": len(results), "sse": sum(streams),
           "prompt_tokens": [u["prompt_tokens"] for u in usages],
           "completion_tokens": [u["completion_tokens"] for u in usages],
           "finish": [r["finish"] for r in results],
           "ttft_ms": [u.get("ttft_ms") for u in usages],
           "decode_tok_per_s": [u.get("tokens_per_sec") for u in usages],
           "engine_build_s": build_s, "wall_s": wall_s,
           "launches": launches, **steps,
           "note": "TTFT and tok/s are information only"}
    emit(res)
    res["texts"] = [r["text"] for r in results]
    return res


def serve_phase(torch, ks, card: str) -> dict:
    """Phase 5: each served configuration in turn; the card holds one
    engine at a time."""
    out = {}
    for tag, overrides in SERVE_CONFIGS:
        out[tag] = asyncio.run(_serve(torch, ks, card, tag, overrides))
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "serve-freed", "config": tag,
              "allocated_bytes": torch.cuda.memory_allocated()})
    # Information: the two layouts read the same values in the same order,
    # so a cache type's two layouts may well agree token for token; batch
    # composition can change cuBLAS's choices, so this is not a check.
    emit({"phase": "serve-agreement",
          "bf16_layouts_same_text": out["contiguous-bf16"]["texts"]
          == out["paged-bf16"]["texts"],
          "int8_layouts_same_text": out["contiguous-int8"]["texts"]
          == out["paged-int8"]["texts"]})
    return out


# ---------------------------------------------------------------------------

ROWS = [  # (kind, layout, int8, serve config, source, replaces)
    ("decode", "paged", False, "paged-bf16", "paged_attention.cu",
     "llmapigateway_tpu/ops/paged_attention.py:272"),
    ("prefill", "paged", False, "paged-bf16", "paged_attention.cu",
     "llmapigateway_tpu/ops/paged_attention.py:438"),
    ("decode", "contiguous", False, "contiguous-bf16", "flash_attention.cu",
     "llmapigateway_tpu/ops/flash_attention.py:186"),
    ("prefill", "contiguous", False, "contiguous-bf16", "flash_attention.cu",
     "llmapigateway_tpu/ops/flash_attention.py:329"),
    ("decode", "paged", True, "paged-int8", "paged_attention.cu",
     "llmapigateway_tpu/ops/paged_attention.py:272"),
    ("prefill", "paged", True, "paged-int8", "paged_attention.cu",
     "llmapigateway_tpu/ops/paged_attention.py:438"),
    ("decode", "contiguous", True, "contiguous-int8", "flash_attention.cu",
     "llmapigateway_tpu/ops/flash_attention.py:186"),
    ("prefill", "contiguous", True, "contiguous-int8", "flash_attention.cu",
     "llmapigateway_tpu/ops/flash_attention.py:329"),
]


def kernels_line(ks, kernel_res: dict, serve: dict) -> dict:
    rows = []
    for kind, layout, quant, cfg, source, replaces in ROWS:
        res = kernel_res[(kind, layout, quant)]
        name = ks.name(kind, layout)
        rows.append({"name": f"{name}{'_int8' if quant else ''}",
                     "route": "cuda",
                     "source": f"llmapigateway_tpu_torch/csrc/{source}",
                     "replaces": replaces,
                     "launches": serve[cfg]["launches"][name],
                     "max_abs_err": max(r["max_abs_err"] for r in res),
                     "ms": res[0]["ms"], "plain_ms": res[0]["plain_ms"],
                     "bound_ms": res[0]["bound_ms"],
                     "bound_by": res[0]["bound_by"],
                     "library_ms": res[0]["library_ms"]})
    return {"kernels": rows}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
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
        emit({"phase": "build", "arch": "sm_90a",
              "wall_s": time.monotonic() - t0,
              "sources": {name: {
                  "library": os.path.relpath(b.path, HERE),
                  "seconds": b.seconds,
                  "ptxas": [ln.strip() for ln in b.log.splitlines()
                            if "Compiling entry" in ln or "registers" in ln
                            or "spill" in ln]} for name, b in builds.items()}})

        gen = torch.Generator(device="cuda").manual_seed(0)
        kernel_res = kernel_phase(torch, ks, gen)
        check_model(torch)
        serve = serve_phase(torch, ks, smi)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    emit(kernels_line(ks, kernel_res, serve))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
