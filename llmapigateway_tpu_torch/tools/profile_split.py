"""Sweep the decode kernels' key split at one head geometry on the card.

Times kernel #1 (paged) or #3 (contiguous) at a preset's head geometry
under several key splits (``n_split`` values, the planner's own first),
with each slot's ``n_stale`` from ``--n-stale`` (chip_smoke.py's llama-3-8b
decode case by default) and again with every slot empty (``n_stale`` 0:
what a launch costs besides its keys). Device ms per launch from
``_timing.device_times`` (chip_smoke.py's timer: CUDA events around the
device work), with L2 flushed before each run (``cold``) and not
(``warm``), beside an empty kernel's; each split's output is compared
with the planner's.
Information for tuning ``ops/_kernels.py decode_splits``; nothing here is
on a served path.

    python -m llmapigateway_tpu_torch.tools.profile_split
        [--preset llama-3-8b] [--layout paged|contiguous] [--kv bf16|int8]
        [--batch 8] [--seq 4096] [--page 256] [--window 0]
        [--n-stale 0,1,255,...] [--splits 1,2,4,8,16,32,64] [--iters 25]
"""
from __future__ import annotations

import argparse
import json

import torch

from ..engine.engine import resolve_device
from ..models.config import get_preset
from ..models.llama import quantize_kv
from ..ops import _kernels
from ..ops.flash_attention import decode_workspace, split_kv
from ._timing import device_times


def _side(x, quant: bool):
    if not quant:
        return x
    q, s = quantize_kv(x)
    return {"q": q, "s": s[:, :, None, :].contiguous()}


def device_ms(fn, iters: int, cold: bool) -> float:
    """Median device ms of ``fn`` (``_timing.device_times``, the smoke's
    timer), L2 flushed first when ``cold``."""
    return device_times(fn, iters, cold=cold)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="llama-3-8b")
    ap.add_argument("--layout", choices=("paged", "contiguous"),
                    default="paged")
    ap.add_argument("--kv", choices=("bf16", "int8"), default="bf16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--page", type=int, default=256)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--n-stale", default="0,1,255,256,257,1000,2047,4095")
    ap.add_argument("--splits", default="1,2,4,8,16,32,64")
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_split: the kernels run only on a CUDA card")
    cfg = get_preset(args.preset)
    B, H, KV, Dh = args.batch, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    quant, window = args.kv == "int8", args.window
    n_list = [int(x) for x in args.n_stale.split(",")][:B]
    n_list += [0] * (B - len(n_list))
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k_new, v_new = rand(B, H, Dh), rand(B, KV, Dh), rand(B, KV, Dh)
    if args.layout == "paged":
        NP = args.seq // args.page
        k = _side(rand(B * NP + 1, KV, args.page, Dh), quant)
        v = _side(rand(B * NP + 1, KV, args.page, Dh), quant)
        table = (torch.randperm(B * NP, generator=gen, device=dev) + 1
                 ).reshape(B, NP).to(torch.int32)
        limit, page = NP * args.page, args.page

        def launch(n_stale, plan):
            out = torch.empty((B, H * Dh), dtype=torch.bfloat16, device=dev)
            _kernels.launch_paged_decode(
                q, k_new, v_new, split_kv(k), split_kv(v), quant, table,
                n_stale, out, window, 1, plan,
                decode_workspace(plan, B, KV, H // KV, Dh, dev))
            return out
    else:
        k = _side(rand(B, KV, args.seq, Dh), quant)
        v = _side(rand(B, KV, args.seq, Dh), quant)
        limit, page = args.seq, 0

        def launch(n_stale, plan):
            out = torch.empty((B, H * Dh), dtype=torch.bfloat16, device=dev)
            _kernels.launch_flash_decode(
                q, k_new, v_new, split_kv(k), split_kv(v), quant, None,
                n_stale, out, window, plan,
                decode_workspace(plan, B, KV, H // KV, Dh, dev))
            return out

    extent = _kernels.decode_extent(limit, window)
    planned = _kernels.decode_plan(B, KV, limit, window, page,
                                   _kernels.device_sm_count(dev))
    tiles = -(-extent // _kernels.TILE_K)
    plans = [planned]
    for n in (int(x) for x in args.splits.split(",")):
        keys = -(-tiles // n) * _kernels.TILE_K
        plan = _kernels.DecodeSplits(-(-extent // keys), keys)
        if plan not in plans and plan.n_split <= _kernels.MAX_SPLITS:
            plans.append(plan)
    live = torch.tensor(n_list, dtype=torch.int32, device=dev)
    empty = torch.zeros(B, dtype=torch.int32, device=dev)
    ref = launch(live, planned)
    rows = []
    for plan in plans:
        got = launch(live, plan)
        torch.cuda.synchronize()
        rows.append({
            "n_split": plan.n_split, "split_keys": plan.split_keys,
            "planned": plan == planned,
            "max_abs_diff_to_planned": (got.float() - ref.float()).abs()
            .max().item(),
            "cold_ms": device_ms(lambda: launch(live, plan), args.iters,
                                 True),
            "warm_ms": device_ms(lambda: launch(live, plan), args.iters,
                                 False),
            "empty_cold_ms": device_ms(lambda: launch(empty, plan),
                                       args.iters, True)})
    res = {"device": torch.cuda.get_device_name(dev), "preset": args.preset,
           "empty_kernel_cold_ms": device_ms(
               lambda: _kernels.launch_empty(dev), args.iters, True),
           "layout": args.layout, "kv": args.kv,
           "geometry": {"B": B, "H": H, "KV": KV, "Dh": Dh, "window": window,
                        "limit": limit, "n_stale": n_list},
           "plans": rows}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
