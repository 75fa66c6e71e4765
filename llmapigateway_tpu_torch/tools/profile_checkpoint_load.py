"""Time a checkpoint's load into the port's engine, then serve one request:
the port's counterpart of ``tools/profile_checkpoint_load.py``.

Builds an ``InferenceEngine`` from ``model_dir`` (a real or synthetic HF
checkpoint, ``tools/make_synthetic_checkpoint.py``) on ``--device`` and
reports the engine's build seconds, the checkpoint load's own wall seconds
(engine/checkpoint.py: file reads into pinned host buffers overlapped with
the copies to the card), the seconds spent in file reads, the bytes read
and their rate over the load's wall time (``h2d_gbps``), the params' device
bytes (a tied ``lm_head`` counted once), the peak host RSS the build added,
and the wall seconds of one greedy request from a cold engine.

    python -m llmapigateway_tpu_torch.tools.profile_checkpoint_load DIR
        [--kv-quant int8] [--batch 8] [--seq 1024] [--tokens 32]
        [--device cuda]

``--quant`` (weight quantization) is refused until it is ported. Prints one
JSON line last and returns it from ``main(argv)``; on the card it carries
the card's name and power limit as ``nvidia-smi`` prints them.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import resource
import time

from ..config.schemas import LocalEngineConfig
from ..engine.checkpoint import unique_bytes
from ..engine.engine import GenRequest, InferenceEngine, resolve_device
from .bench import card_info


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m llmapigateway_tpu_torch.tools.profile_checkpoint_load")
    ap.add_argument("model_dir")
    ap.add_argument("--quant", default="", choices=["", "int8", "int4"])
    ap.add_argument("--kv-quant", default="", choices=["", "int8"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card fails")
    args = ap.parse_args(argv)
    if args.quant:
        raise ValueError(
            f"--quant {args.quant}: weight quantization is not ported to the "
            f"PyTorch engine yet (ROADMAP.md, port queue: weight "
            f"quantization)")
    device = resolve_device(args.device)

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.monotonic()
    engine = InferenceEngine(LocalEngineConfig(
        model_path=args.model_dir, max_batch_size=args.batch,
        max_seq_len=args.seq, kv_quant=args.kv_quant), device=device)
    init_s = time.monotonic() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    load = engine.load_stats
    device_bytes = unique_bytes(engine.params)
    n_elems = sum(t.numel() for t in _leaves(engine.params))

    async def serve():
        req = GenRequest(prompt_ids=engine.tokenizer.encode(
            "The quick brown fox"), max_tokens=args.tokens, temperature=0.0)
        t = time.monotonic()
        await engine.submit(req)
        async for _ in engine.stream(req):
            pass
        await engine.close()
        return req, time.monotonic() - t

    req, serve_s = asyncio.run(serve())
    res = {
        "model_dir": args.model_dir, "device": str(device),
        "quant": "bf16", "kv_quant": args.kv_quant or "bf16",
        "engine_init_s": round(init_s, 2),
        "load_s": load["seconds"], "read_s": load["read_s"],
        "bytes_read_gb": load["bytes"] / 1e9,
        "h2d_gbps": load["bytes"] / 1e9 / load["seconds"],
        "device_param_gb": device_bytes / 1e9,
        "peak_host_rss_gb": round((rss1 - rss0) / 1e6, 2),
        "n_param_leaf_elems_b": round(n_elems / 1e9, 2),
        "generated_tokens": len(req.generated),
        "first_request_s": round(serve_s, 2),
        "text_preview": engine.tokenizer.decode(req.generated)[:60],
        **card_info(device)}
    print(json.dumps(res), flush=True)
    return res


def _leaves(node: dict):
    for v in node.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


if __name__ == "__main__":
    main()
