#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``llmapigateway_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device  — ``nvidia-smi`` name and power limit, ``torch.cuda`` name.
2. build   — both paged-attention kernels compiled with ``nvcc`` for sm_90a
             from ``llmapigateway_tpu_torch/csrc/`` (build time, and ptxas's
             registers, shared memory and spills per kernel).
3. kernel  — each kernel's wrapper against its plain PyTorch version on the
             same card tensors at the main path's shapes (bf16, llama-3-8b
             heads): per-element error against the fp32 plain output under
             the stated relative + absolute tolerance, and times (CUDA
             events, median of 25 runs with L2 flushed before each) beside
             the plain version, one library call on the gathered dense view
             (``scaled_dot_product_attention``, timed only — the port never
             calls it) and the least time the card could take. Then every
             group size the kernels are built for, held the same way.
4. model   — a two-layer model of llama-3-8b head geometry through the
             port's forward on the card (kernels) against the same weights
             through the plain path on the CPU in fp32; and the LM head at
             llama-3-8b's shape, which must give fp32 logits equal to the
             fp32 product of its bf16 operands.
5. serve   — the port's aiohttp app in-process on a local port with the
             llama-3-8b config (full width and depth, random weights from a
             seed): 2 SSE + 2 JSON concurrent requests whose prompts cross a
             KV page and a prefill chunk. Launch counters are zeroed just
             before and read just after; both kernels must have run, once
             per layer per forward of their kind (a one-token prefill call
             runs the decode kernel).
6. the ``kernels`` line, the nvidia-smi line, and last the contract line
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line. Without a CUDA card,
or without the package beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import asyncio
import functools
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
# (bf16-valued) inputs; the kernel accumulates in fp32 and rounds its output
# to bf16 once, which moves a value by at most half a bf16 ulp, 2^-8 of it.
# The absolute term covers the fp32 summation order over up to 4096 keys
# near an output of 0 (a few 1e-6). An element passes when
#   |kernel - plain| <= KERNEL_RTOL * |plain| + KERNEL_ATOL.
# The long rows average over ~1000-4000 keys (|out| ~ 0.03), so a kernel
# that drops or mis-masks a 32-key tile there is off by well over 2^-8.
KERNEL_RTOL = 2.0 ** -8
KERNEL_ATOL = 2.0 ** -14
# Decode groups (query heads per KV head) the kernel is built for, each held
# to the plain version at H 32 and a batch of long and short slots.
GROUP_CASES = dict(B=4, H=32, n_stale=[0, 257, 1000, 4095], T=100,
                   starts=[0, 1000])
# LM head: fp32 logits from bf16 operands, against the fp32 product of the
# same values; a bf16 rounding of the logits (2^-9 of the largest) fails.
HEAD_REL_TOL = 2.0 ** -12
# Model check: bf16 weights and activations on the card (cuBLAS projections,
# bf16 rounding after every op) against fp32 on the CPU; relative to the
# largest reference logit.
MODEL_REL_TOL = 5e-2

DECODE = dict(B=8, H=32, KV=8, Dh=128, page=256, NP=16,
              n_stale=[0, 1, 255, 256, 257, 1000, 2047, 4095])
PREFILL = dict(H=32, KV=8, Dh=128, page=256, NP=16, starts=[0, 256, 1000],
               T=(512, 300))
SERVE_ENGINE = {"preset": "llama-3-8b", "kv_layout": "paged",
                "kv_page_size": 256, "kv_pages_per_block": 1,
                "max_batch_size": 8, "max_seq_len": 4096,
                "prefill_chunk": 512, "prefix_cache": False, "mesh": {}}
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
    layer's pool cold."""
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


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pool_and_table(torch, gen, B, KV, Dh, page, NP, live_pages):
    """A bf16 pool with page 0 (trash) filled with a large finite value, and
    a shuffled page table whose entries past each slot's live pages are 0 —
    a kernel that reads the trash page for a live key, or a dead page, shows
    up in the error."""
    P = B * NP + 1
    pool_k = torch.randn((P, KV, page, Dh), generator=gen, device="cuda"
                         ).to(torch.bfloat16)
    pool_v = torch.randn((P, KV, page, Dh), generator=gen, device="cuda"
                         ).to(torch.bfloat16)
    pool_k[0] = 3e4
    pool_v[0] = 3e4
    perm = torch.randperm(B * NP, generator=gen, device="cuda") + 1
    table = perm.reshape(B, NP).to(torch.int32)
    for b, n in enumerate(live_pages):
        table[b, n:] = 0
    return pool_k, pool_v, table.contiguous()


def _fp32(args):
    """The plain versions' inputs: the same values, in fp32."""
    return tuple(a.float() if a.is_floating_point() else a for a in args)


def held(torch, name: str, got, ref) -> dict:
    """Hold a kernel's bf16 output to its plain version's fp32 output, per
    element (KERNEL_RTOL, KERNEL_ATOL)."""
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got.float() - ref).abs()
    ratio = diff / (KERNEL_RTOL * ref.abs() + KERNEL_ATOL)
    return {"max_abs_err": diff.max().item(),
            "max_err_over_tol": ratio.max().item()}


def decode_inputs(torch, gen, B, H, KV, n_list, page, NP, Dh=128):
    live = [-(-n // page) for n in n_list]
    k_pages, v_pages, table = _pool_and_table(torch, gen, B, KV, Dh, page,
                                              NP, live)
    q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    k_new = torch.randn((B, KV, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    v_new = torch.randn((B, KV, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    n_stale = torch.tensor(n_list, dtype=torch.int32, device="cuda")
    return (q, k_new, v_new, k_pages, v_pages, table, n_stale)


def prefill_inputs(torch, gen, T, H, KV, starts, page, NP, Dh=128):
    live = [-(-(s + T) // page) for s in starts]
    k_pages, v_pages, table = _pool_and_table(torch, gen, len(starts), KV,
                                              Dh, page, NP, live)
    q = torch.randn((len(starts), T, H, Dh), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return (q, k_pages, v_pages, table, start)


def check_decode(torch, pa, gen) -> dict:
    d = DECODE
    B, H, KV, Dh, page, NP = (d[k] for k in ("B", "H", "KV", "Dh", "page",
                                              "NP"))
    n_list = d["n_stale"]
    args = decode_inputs(torch, gen, B, H, KV, n_list, page, NP, Dh)
    q, k_new, v_new, k_pages, v_pages, table, n_stale = args

    got = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    err = held(torch, "decode kernel", got,
               pa._paged_decode_plain(*_fp32(args)))

    kernel_ms = cuda_ms(torch, lambda: pa.paged_decode_attention(*args))
    plain_ms = cuda_ms(torch, lambda: pa._paged_decode_plain(*args), iters=5)
    # Library yardstick: SDPA over the gathered stale view + self column.
    S = max(-(-n // page) for n in n_list) * page
    dk = pa.gather_pages(k_pages, table, S)
    dv = pa.gather_pages(v_pages, table, S)
    k_all = torch.cat([dk, k_new[:, :, None]], dim=2)
    v_all = torch.cat([dv, v_new[:, :, None]], dim=2)
    pos = torch.arange(S + 1, device="cuda")
    mask = ((pos[None, :] < n_stale[:, None]) | (pos[None, :] == S))[
        :, None, None, :]
    library_ms = cuda_ms(torch, lambda: sdpa(torch, q[:, :, None], k_all,
                                             v_all, mask))
    tokens = sum(n_list)
    n_bytes = (q.nbytes + k_new.nbytes + v_new.nbytes + got.nbytes
               + table.nbytes + n_stale.nbytes + tokens * KV * Dh * 2 * 2)
    n_flops = B * H * (tokens / B + 1) * Dh * 4
    bound_ms, bound_by = bound(n_bytes, n_flops)
    res = {"phase": "kernel", "name": "paged_decode_attention",
           "shape": {"B": B, "H": H, "KV": KV, "Dh": Dh, "page": page,
                     "NP": NP, "n_stale": n_list},
           **err, "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "live_kv_bytes": tokens * KV * Dh * 4}
    emit(res)
    check(err["max_err_over_tol"] <= 1.0, f"decode kernel disagrees: {err}")
    return res


def check_prefill(torch, pa, gen, T: int) -> dict:
    d = PREFILL
    H, KV, Dh, page, NP = (d[k] for k in ("H", "KV", "Dh", "page", "NP"))
    starts = d["starts"]
    B = len(starts)
    args = prefill_inputs(torch, gen, T, H, KV, starts, page, NP, Dh)
    q, k_pages, v_pages, table, start = args

    got = pa.paged_prefill_attention(*args)
    torch.cuda.synchronize()
    err = held(torch, "prefill kernel", got,
               pa._paged_prefill_plain(*_fp32(args)))

    kernel_ms = cuda_ms(torch, lambda: pa.paged_prefill_attention(*args))
    plain_ms = cuda_ms(torch, lambda: pa._paged_prefill_plain(*args), iters=5)
    S = max(starts) + T
    dk = pa.gather_pages(k_pages, table, S)
    dv = pa.gather_pages(v_pages, table, S)
    q_pos = start[:, None] + torch.arange(T, device="cuda")[None, :]
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= q_pos[:, :, None])[:, None]
    qh = q.transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: sdpa(torch, qh, dk, dv, mask))
    keys = sum(s + T for s in starts)
    n_bytes = (q.nbytes + got.nbytes + table.nbytes + start.nbytes
               + keys * KV * Dh * 2 * 2)
    # Each query t of slot b sees start_b + t + 1 keys: QK and PV, 2 flops
    # per multiply-add, per head.
    n_flops = sum(H * Dh * 4 * (T * (s + 1) + T * (T - 1) / 2)
                  for s in starts)
    bound_ms, bound_by = bound(n_bytes, n_flops)
    res = {"phase": "kernel", "name": "paged_prefill_attention",
           "shape": {"B": B, "T": T, "H": H, "KV": KV, "Dh": Dh,
                     "page": page, "NP": NP, "start": starts},
           **err, "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(res)
    check(err["max_err_over_tol"] <= 1.0,
          f"prefill kernel (T={T}) disagrees: {err}")
    return res


def check_groups(torch, pa, group_sizes, gen) -> list[dict]:
    """Every group size the kernels are built for (H 32 over H/G KV heads),
    decode and prefill, held to the plain versions. Not timed."""
    c = GROUP_CASES
    H, page, NP = c["H"], 256, 16
    rows = []
    for G in group_sizes:
        KV = H // G
        dargs = decode_inputs(torch, gen, c["B"], H, KV, c["n_stale"], page,
                              NP)
        pargs = prefill_inputs(torch, gen, c["T"], H, KV, c["starts"], page,
                               NP)
        rows.append({
            "G": G, "KV": KV,
            "decode": held(torch, f"decode kernel G={G}",
                           pa.paged_decode_attention(*dargs),
                           pa._paged_decode_plain(*_fp32(dargs))),
            "prefill": held(torch, f"prefill kernel G={G}",
                            pa.paged_prefill_attention(*pargs),
                            pa._paged_prefill_plain(*_fp32(pargs)))})
    emit({"phase": "groups", "shape": c, "rtol": KERNEL_RTOL,
          "atol": KERNEL_ATOL, "groups": rows})
    for r in rows:
        for k in ("decode", "prefill"):
            check(r[k]["max_err_over_tol"] <= 1.0,
                  f"{k} kernel disagrees at G={r['G']}: {r[k]}")
    return rows


# ---------------------------------------------------------------------------
# Phase 4: a small model of the main path's head geometry, card vs CPU
# ---------------------------------------------------------------------------

def check_model(torch) -> dict:
    from llmapigateway_tpu_torch.models.config import ModelConfig
    from llmapigateway_tpu_torch.models.llama import forward, init_params
    from llmapigateway_tpu_torch.ops.paged_attention import (
        PagedKVCache, make_paged_attention_fn)

    cfg = ModelConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                      n_kv_heads=1, d_ff=1024, rope_theta=500000.0,
                      max_seq_len=1024)                 # Dh 128, G 4
    gen = torch.Generator(device="cpu").manual_seed(1)
    params_cpu = init_params(cfg, gen, dtype=torch.bfloat16)
    page, NP, B, P = 256, 4, 2, 9
    table = torch.tensor([[3, 7, 0, 0], [5, 2, 8, 0]], dtype=torch.int32)
    prompt = torch.randint(0, 512, (B, 300), generator=gen)
    # Fixed decode inputs: both runs must see the same tokens.
    steps = torch.randint(0, 512, (4, B), generator=gen)

    def run(device, dtype):
        params = {k: ({n: w.to(device, dtype) for n, w in v.items()}
                      if isinstance(v, dict) else v.to(device, dtype))
                  for k, v in params_cpu.items()}
        cache = PagedKVCache.create(cfg, P, page, dtype, device=device)
        attn = make_paged_attention_fn(table.to(device))
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

    with torch.no_grad():
        got = run("cuda", torch.bfloat16)
        ref = run("cpu", torch.float32)
    check(bool(torch.isfinite(got).all()), "model: non-finite logits")
    check(got.shape == ref.shape == (5, B, cfg.vocab_size),
          f"model: logits shape {tuple(got.shape)}")
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    head = check_head(torch)
    res = {"phase": "model", "layers": cfg.n_layers, "prompt": 300,
           "decode_steps": 4, "max_rel_err": rel, "tol": MODEL_REL_TOL,
           "head": head}
    emit(res)
    check(rel <= MODEL_REL_TOL, f"model logits disagree: {rel}")
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
# Phase 5: serve /v1/chat/completions at llama-3-8b width
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _serve(torch, pa, card: str) -> dict:
    import aiohttp
    from aiohttp import web

    from llmapigateway_tpu_torch.config.loader import ConfigLoader
    from llmapigateway_tpu_torch.config.settings import Settings
    from llmapigateway_tpu_torch.providers.local import make_local_provider
    from llmapigateway_tpu_torch.server.app import build_app
    from llmapigateway_tpu_torch.utils.sse import SSEParser

    with tempfile.TemporaryDirectory() as cfg_dir:
        with open(os.path.join(cfg_dir, "providers.json"), "w") as f:
            json.dump([{"local": {"type": "local", "engine": SERVE_ENGINE}}], f)
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
            check(provider is not None, "serve: the local provider did not build")
            engine = provider.engine
            torch.cuda.synchronize()
            build_s = time.monotonic() - t0
            n_layers = engine.model_cfg.n_layers

            words = ("the quick brown fox jumps over the lazy dog while "
                     "paged attention streams every live key once ")
            prompts = [(words * 20)[:n] for n in SERVE_PROMPT_CHARS]
            streams = [True, False, True, False]

            async def one(session, text, stream):
                body = {"model": "gw/llama", "temperature": 0,
                        "max_tokens": 32, "stream": stream,
                        "messages": [{"role": "user", "content": text}]}
                async with session.post(
                        f"http://127.0.0.1:{port}/v1/chat/completions",
                        json=body) as resp:
                    if resp.status != 200:
                        raise SmokeFailure(
                            f"serve: HTTP {resp.status}: {await resp.text()}")
                    if not stream:
                        return await resp.json()
                    parser, frames = SSEParser(), []
                    async for chunk in resp.content.iter_any():
                        frames.extend(parser.feed(chunk))
                    check(bool(frames) and frames[-1].is_done,
                          f"serve: SSE stream did not end in [DONE]: "
                          f"{[fr.data[:200] for fr in frames[-2:]]}")
                    usage = [fr.json["usage"] for fr in frames
                             if fr.json and "usage" in fr.json]
                    text = "".join(
                        fr.json["choices"][0]["delta"].get("content", "")
                        for fr in frames if fr.json and fr.json.get("choices"))
                    check(len(usage) == 1, "serve: SSE usage frame missing")
                    return {"usage": usage[0], "text": text}

            # Zero every launch count just before driving the main path.
            pa.paged_decode_attention.launches = 0
            pa.paged_prefill_attention.launches = 0
            engine.decode_steps = engine.prefill_calls = 0
            engine.prefill_one_token_calls = 0
            t1 = time.monotonic()
            async with aiohttp.ClientSession() as session:
                results = await asyncio.gather(*[
                    one(session, p, s) for p, s in zip(prompts, streams)])
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t1
            launches = {"paged_decode_attention":
                        pa.paged_decode_attention.launches,
                        "paged_prefill_attention":
                        pa.paged_prefill_attention.launches}
            steps = {"decode_steps": engine.decode_steps,
                     "prefill_calls": engine.prefill_calls,
                     "prefill_one_token_calls":
                     engine.prefill_one_token_calls}
        finally:
            await runner.cleanup()

    usages = [r["usage"] for r in results]
    for u in usages:
        check(u["completion_tokens"] > 0, f"serve: no completion tokens {u}")
    check(launches["paged_decode_attention"] > 0,
          "serve: the decode kernel never ran on the main path")
    check(launches["paged_prefill_attention"] > 0,
          "serve: the prefill kernel never ran on the main path")
    # A prefill call one token wide runs the decode kernel (the forward's
    # T == 1 path); every other prefill call runs the prefill kernel.
    one = steps["prefill_one_token_calls"]
    check(launches["paged_decode_attention"]
          == n_layers * (steps["decode_steps"] + one),
          f"serve: decode launches {launches} != {n_layers} x {steps}")
    check(launches["paged_prefill_attention"]
          == n_layers * (steps["prefill_calls"] - one),
          f"serve: prefill launches {launches} != {n_layers} x {steps}")
    res = {"phase": "serve", "card": card, "engine": SERVE_ENGINE,
           "requests": len(results), "sse": sum(streams),
           "prompt_tokens": [u["prompt_tokens"] for u in usages],
           "completion_tokens": [u["completion_tokens"] for u in usages],
           "ttft_ms": [u.get("ttft_ms") for u in usages],
           "decode_tok_per_s": [u.get("tokens_per_sec") for u in usages],
           "engine_build_s": build_s, "wall_s": wall_s,
           "launches": launches, **steps,
           "note": "TTFT and tok/s are information only"}
    emit(res)
    return res


# ---------------------------------------------------------------------------

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
        from llmapigateway_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the llmapigateway_tpu_torch package is not "
              f"beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})

        build = _kernels.build()
        _kernels.library()
        emit({"phase": "build", "library": os.path.relpath(build.path, HERE),
              "seconds": build.seconds, "arch": "sm_90a",
              "ptxas": [ln.strip() for ln in build.log.splitlines()
                        if "Compiling entry" in ln or "registers" in ln
                        or "spill" in ln]})

        gen = torch.Generator(device="cuda").manual_seed(0)
        decode = check_decode(torch, pa, gen)
        prefill = [check_prefill(torch, pa, gen, T) for T in PREFILL["T"]]
        check_groups(torch, pa, _kernels.GROUP_SIZES, gen)
        check_model(torch)
        serve = asyncio.run(_serve(torch, pa, smi))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    def row(name, res, errs, replaces):
        return {"name": name, "route": "cuda",
                "source": "llmapigateway_tpu_torch/csrc/paged_attention.cu",
                "replaces": replaces,
                "launches": serve["launches"][name],
                "max_abs_err": max(errs), "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "library_ms": res["library_ms"]}

    emit({"kernels": [
        row("paged_decode_attention", decode, [decode["max_abs_err"]],
            "llmapigateway_tpu/ops/paged_attention.py:272"),
        row("paged_prefill_attention", prefill[0],
            [p["max_abs_err"] for p in prefill],
            "llmapigateway_tpu/ops/paged_attention.py:438")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
