"""Ablation profiler for the decode step: the port's counterpart of
``tools/profile_decode.py``.

Times bursts of the decode step (forward + sampling, tokens and lengths
fed forward on the device) with parts disabled; the differences attribute
the per-step milliseconds to attention, KV insert, MLP and sampling. The
attention is the port's plain dense path by default, as the JAX tool's is
its XLA dense path; ``--kernels`` (the counterpart of ``--pallas``) also
runs ``full`` through ``make_cache_attention_fn``, which on the card is
kernel #3 (``csrc/flash_attention.cu``). Then three probes: the seven
projection GEMMs and the LM head alone (``weights_stream``), the same
weights through concatenated QKV and gate/up GEMMs (``fused_stream``), and
the sampler's vocabulary sort alone (``sort_alone``). Projections are
``torch.matmul``, as XLA computes them outside Pallas.

Variants: full (forward + sample), greedy (forward + argmax), nosample
(forward only, token fed back unchanged), noinsert (attention over the
stale cache, no cache write), noattn (attention replaced by zeros: no
insert, no attention), nomlp (MLP replaced by identity).

    python -m llmapigateway_tpu_torch.tools.profile_decode
        [--preset tinyllama-1.1b] [--batch 8] [--seq 1024] [--burst 32]
        [--reps 3] [--variants full,greedy,...] [--kernels] [--kv-quant]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
from functools import partial

import torch

from ..engine.engine import resolve_device
from ..engine.sampling import SamplingParams, sample
from ..models import llama
from ..models.config import get_preset
from ..ops.flash_attention import make_cache_attention_fn
from . import best_ms, note

VARIANTS = "full,greedy,nosample,noinsert,noattn,nomlp"


def build(args, device):
    """(config, params, cache): random bf16 weights from a seed and a
    zeroed contiguous cache [L, B, KV, S, Dh] (int8 with ``--kv-quant``)."""
    if args.quant:
        raise ValueError(
            f"--quant {args.quant}: weight quantization is not ported to the "
            f"PyTorch engine yet (ROADMAP.md, port queue: weight "
            f"quantization)")
    c = get_preset(args.preset)
    gen = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(c, gen, dtype=torch.bfloat16, device=device)
    cache = llama.KVCache.create(c, args.batch, args.seq,
                                 kv_quant="int8" if args.kv_quant else "",
                                 device=device)
    return c, params, cache


def _no_insert(cache_k, cache_v, *args):
    return cache_k, cache_v


def make_step(c, variant: str, attention_fn=None):
    """One decode step with parts ablated: (params, cache, tokens [B],
    lengths [B], active [B], samp, generator) → (next tokens, lengths,
    cache). ``attention_fn`` defaults to the plain dense path."""
    window = c.sliding_window
    attn = llama.dense_cache_attention if attention_fn is None \
        else attention_fn
    if variant == "noattn":
        def zero_attn(q, k_new, v_new, layer_k, layer_v, lengths,
                      active=None):
            B, T, H, Dh = q.shape
            return torch.zeros((B, T, H * Dh), dtype=q.dtype,
                               device=q.device), layer_k, layer_v
        zero_attn.decode = lambda *a, **kw: zero_attn(*a, **kw)[0]
        zero_attn.insert_all = _no_insert
        attn = zero_attn
    elif variant == "noinsert":
        # The stale cache plus the self column, and no cache write.
        def attn(*a, **kw):
            raise AssertionError("decode steps only")
        attn.decode = partial(llama.dense_decode_attention, window=window)
        attn.insert_all = _no_insert
    mlp = (lambda h, lp: h) if variant == "nomlp" else None

    def one_step(params, cache, tokens, lengths, active, samp, generator):
        logits, cache = llama.forward(params, c, tokens[:, None], lengths,
                                      cache, attention_fn=attn,
                                      active=active, mlp_fn=mlp)
        if variant == "full":
            nt = sample(logits[:, 0, :], samp, generator)
        elif variant == "greedy":
            nt = torch.argmax(logits[:, 0, :], dim=-1)
        else:
            nt = tokens
        return nt, torch.where(active, lengths + 1, lengths), cache

    return one_step


def sampling_params(B: int, device, temperature: float = 0.7,
                    top_p: float = 0.95, top_k: int = 40) -> SamplingParams:
    """The JAX tool's sampling state for every slot (0.7 / 0.95 / 40)."""
    def full(v, dtype):
        return torch.full((B,), v, dtype=dtype, device=device)
    return SamplingParams(temperature=full(temperature, torch.float32),
                          top_p=full(top_p, torch.float32),
                          top_k=full(top_k, torch.int32),
                          presence_penalty=full(0.0, torch.float32),
                          frequency_penalty=full(0.0, torch.float32))


def decode_burst(one_step, params, cache, tokens, lengths, active, samp,
                 generator, n_steps: int):
    """``n_steps`` steps back to back, tokens and lengths fed forward on
    the device; one host fetch at the end. Returns (tokens [n, B] on the
    host, cache)."""
    toks = []
    for _ in range(n_steps):
        tokens, lengths, cache = one_step(params, cache, tokens, lengths,
                                          active, samp, generator)
        toks.append(tokens)
    return torch.stack(toks).cpu(), cache


def time_variant(c, params, cache, args, variant, device,
                 attention_fn=None, label=None):
    """ms/step of ``variant`` (best of ``--reps`` bursts after a warm-up
    burst, every burst from the same tokens and lengths, as the JAX tool
    does). Returns (ms/step, cache)."""
    one_step = make_step(c, variant, attention_fn)
    B = args.batch
    tokens = torch.zeros((B,), dtype=torch.long, device=device)
    lengths = torch.full((B,), 128, dtype=torch.int32, device=device)
    active = torch.ones((B,), dtype=torch.bool, device=device)
    samp = sampling_params(B, device)
    generator = torch.Generator(device=device).manual_seed(1)
    box = [cache]

    def burst():
        toks, box[0] = decode_burst(one_step, params, box[0], tokens,
                                    lengths, active, samp, generator,
                                    args.burst)
        return toks

    best, warm, _ = best_ms(burst, device, args.reps)
    ms_step = best / args.burst
    note(f"{label or variant:10s}: {ms_step:8.3f} ms/step   (burst "
         f"{best:.1f} ms, warm-up burst {warm:.1f} ms)")
    return ms_step, box[0]


def _stream_burst(one_pass, x0, burst: int):
    """``burst`` passes, each fed the last one's output (scaled down), so no
    pass can be skipped or overlapped away; returns the summed aux."""
    x, tot = x0, torch.zeros((), device=x0.device)
    for _ in range(burst):
        h, s = one_pass(x)
        x, tot = (h * 1e-3).to(x.dtype), tot + s
    return tot


def time_weights_stream(c, params, args, device):
    """Only the seven projection GEMMs per layer and the LM head, at the
    decode step's shapes ([B, D] activations): the best step time these
    GEMMs reach on this device. Every output feeds the carry or the aux
    sum."""
    lay = params["layers"]
    keys = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")

    def one_pass(x):
        h, aux = x, torch.zeros((), device=device)
        for i in range(c.n_layers):
            q = h @ lay["wq"][i]
            k = h @ lay["wk"][i]
            v = h @ lay["wv"][i]
            o = q @ lay["wo"][i]
            g = h @ lay["wg"][i]
            u = h @ lay["wu"][i]
            d = (g * u) @ lay["wd"][i]
            h, aux = h + o + d, aux + k.float().sum() + v.float().sum()
        logits = llama.head_logits(params, c, h)
        return h, aux + logits.sum()

    x = torch.ones((args.batch, c.d_model), dtype=torch.bfloat16,
                   device=device)
    best, _, _ = best_ms(lambda: _stream_burst(one_pass, x, args.burst),
                         device, args.reps)
    sec = best / args.burst / 1e3
    head = params["embed"] if c.tie_embeddings else params["lm_head"]
    nbytes = sum(lay[k].nbytes for k in keys) + head.nbytes
    note(f"{'weights_stream':10s}: {sec * 1e3:8.3f} ms/step   "
         f"({nbytes / 1e9:.2f} GB of weights -> {nbytes / sec / 1e9:.0f} "
         f"GB/s achieved)")
    return sec * 1e3


def time_weights_stream_fused(c, params, args, device):
    """The same weight bytes through fused projections — wqkv = [wq|wk|wv]
    and wgu = [wg|wu] concatenated on the output axis (6 GEMMs a layer
    instead of 7)."""
    lay = params["layers"]
    wqkv = torch.cat([lay["wq"], lay["wk"], lay["wv"]], dim=-1)
    wgu = torch.cat([lay["wg"], lay["wu"]], dim=-1)
    D, F = lay["wq"].shape[-1], lay["wg"].shape[-1]

    def one_pass(x):
        h, aux = x, torch.zeros((), device=device)
        for i in range(c.n_layers):
            z = h @ wqkv[i]
            o = z[:, :D] @ lay["wo"][i]
            gu = h @ wgu[i]
            d = (gu[:, :F] * gu[:, F:]) @ lay["wd"][i]
            h, aux = h + o + d, aux + z[:, D:].float().sum()
        logits = llama.head_logits(params, c, h)
        return h, aux + logits.sum()

    x = torch.ones((args.batch, c.d_model), dtype=torch.bfloat16,
                   device=device)
    best, _, _ = best_ms(lambda: _stream_burst(one_pass, x, args.burst),
                         device, args.reps)
    ms = best / args.burst
    note(f"{'fused_stream':10s}: {ms:8.3f} ms/step   (wqkv+wgu "
         f"concatenated, 6 GEMMs/layer)")
    return ms


def time_sort_alone(args, V, device):
    """The sampler's descending vocabulary sort of [B, V] fp32, alone."""
    gen = torch.Generator(device=device).manual_seed(0)
    x0 = torch.randn((args.batch, V), generator=gen, device=device)

    def burst():
        carry, outs = x0, []
        for _ in range(args.burst):
            s = torch.sort(carry, dim=-1, descending=True).values
            carry = carry + s[:, :1] * 0
            outs.append(s[:, 0])
        return torch.stack(outs).cpu()

    best, _, _ = best_ms(burst, device, args.reps)
    ms = best / args.burst
    note(f"{'sort alone':10s}: {ms:8.3f} ms/step   ([B={args.batch}, "
         f"V={V}])")
    return ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m llmapigateway_tpu_torch.tools.profile_decode",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--burst", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default=VARIANTS)
    ap.add_argument("--kernels", action="store_true",
                    help="also run `full` with the kernels' attention_fn "
                         "(make_cache_attention_fn)")
    ap.add_argument("--quant", nargs="?", const="int8", default="",
                    choices=("", "int8", "int4"),
                    help="weight quantization (not ported: refused)")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card fails")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    note(f"device: {device}"
         + (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else ""))

    results = {}
    with torch.no_grad():
        c, params, cache = build(args, device)
        for v in args.variants.split(","):
            results[v], cache = time_variant(c, params, cache, args, v,
                                             device)
        if args.kernels:
            results["kernels"], cache = time_variant(
                c, params, cache, args, "full", device,
                attention_fn=make_cache_attention_fn(
                    window=c.sliding_window), label="kernels")
        results["weights_stream"] = time_weights_stream(c, params, args,
                                                        device)
        del cache                   # room for the fused copies
        results["fused_stream"] = time_weights_stream_fused(c, params, args,
                                                            device)
        results["sort_alone"] = time_sort_alone(args, c.vocab_size, device)

    note("\n--- attribution (ms/step) ---")
    f = results.get("full")
    if f is not None:
        for k, v in results.items():
            if k == "full":
                note(f"full step          : {f:8.3f}")
            elif k in ("sort_alone", "kernels", "weights_stream",
                       "fused_stream"):
                note(f"{k:19s}: {v:8.3f}")
            else:
                note(f"delta full-{k:8s}: {f - v:8.3f}")
    print(json.dumps({"device": str(device), "preset": args.preset,
                      "ms_per_step": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
