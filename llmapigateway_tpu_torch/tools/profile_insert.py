"""Microbench KV-insert strategies for the decode step (T = 1): the port's
counterpart of ``tools/profile_insert.py``, and the home of kernel #5.

Each variant runs a burst of ``--burst`` steps, each step inserting one row
per (slot, KV head) into every one of ``--layers`` layers' K and V caches
``[B, KV, S, Dh]`` (bf16) at ``lengths``, then advancing ``lengths`` — with
the JAX scan's feedback: every layer's result feeds a running sum, and a
functional variant's new cache replaces the old one.

  index_put — one advanced-index assignment per layer and side (the
              counterpart of ``vmap_dus``, the JAX engine's insert).
  onehot    — ``torch.where`` over the whole layer (``onehot``); this is
              also the plain version of kernel #5 (:func:`insert_onehot`).
  cuda      — kernel #5, ``csrc/kv_insert.cu``, through its wrapper
              :func:`insert_kernel` (the counterpart of ``pallas``,
              ``insert_pallas`` :66). It needs a CUDA device: on the CPU it
              is reported as not run, never replaced by another variant.
  stacked   — one insert into the ``[L, ...]`` stacked cache per step, K
              only (``stacked``; x2 for K and V).

The caches and new rows are random (seeded), not the JAX tool's zeros and
ones, so the ``cuda`` burst's final caches can be held ``torch.equal`` to
the ``index_put`` burst's from the same start (``cuda_equals_index_put``).

    python -m llmapigateway_tpu_torch.tools.profile_insert [--layers 22]
        [--batch 8] [--kv-heads 4] [--seq 1024] [--head-dim 64]
        [--burst 32] [--reps 3] [--device cuda]
"""
from __future__ import annotations

import argparse
import json

import torch

from ..engine.engine import resolve_device
from ..ops import _kernels
from ..ops.flash_attention import count_launch, reset_launches
from . import best_ms, note


def insert_index_put(layer_k: torch.Tensor, k_new: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Row ``k_new[b, 0, kv]`` into ``layer_k[b, kv, lengths[b]]`` by one
    advanced-index assignment, in place. layer_k [B, KV, S, Dh]; k_new
    [B, 1, KV, Dh]; lengths [B] in ``[0, S)``. Returns layer_k."""
    B = layer_k.shape[0]
    # Advanced indices separated by a slice: the indexed view is [B, KV, Dh].
    layer_k[torch.arange(B, device=layer_k.device), :, lengths.long()] = \
        k_new[:, 0].to(layer_k.dtype)
    return layer_k


def insert_onehot(layer_k: torch.Tensor, k_new: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Kernel #5's function in plain PyTorch, as a new tensor: position
    ``lengths[b]`` of every (b, kv) row takes ``k_new[b, 0, kv]``, every
    other position keeps ``layer_k``'s value. A length outside ``[0, S)``
    matches no position, so its write is dropped — the kernel's contract."""
    S = layer_k.shape[2]
    hot = (torch.arange(S, device=layer_k.device)[None, :]
           == lengths.long()[:, None])                            # [B, S]
    newv = k_new.transpose(1, 2).to(layer_k.dtype)                # [B, KV, 1, Dh]
    return torch.where(hot[:, None, :, None], newv, layer_k)


def insert_kernel(layer_k: torch.Tensor, k_new: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Kernel #5 (``csrc/kv_insert.cu``): row ``k_new[b, 0, kv]`` into
    ``layer_k[b, kv, lengths[b]]`` IN PLACE (the Pallas call aliases the
    cache to its output); a length outside ``[0, S)`` drops its write.
    layer_k [B, KV, S, Dh] contiguous, a row of 16-byte multiples; k_new
    [B, 1, KV, Dh] (cast to the cache's type, as the JAX kernel does);
    lengths [B] int32. Returns layer_k.

    Only for CUDA tensors: it has no CPU mode and raises for any other
    device (the plain version, :func:`insert_onehot`, is a separate call).
    Counts its launches in ``insert_kernel.launches``."""
    name = "insert_kernel"
    if layer_k.device.type != "cuda":
        raise ValueError(f"{name}: kernel #5 runs only on a CUDA device "
                         f"(got {layer_k.device}); its plain version is "
                         f"insert_onehot")
    if layer_k.dim() != 4:
        raise ValueError(f"{name}: cache {tuple(layer_k.shape)} is not "
                         f"[B, KV, S, Dh]")
    B, KV, S, Dh = layer_k.shape
    new = k_new.to(layer_k.dtype).contiguous()
    if new.shape != (B, 1, KV, Dh) or lengths.shape != (B,):
        raise ValueError(f"{name}: k_new {tuple(k_new.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match cache "
                         f"{tuple(layer_k.shape)}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths is {lengths.dtype}; expected int32")
    for arg, t in (("k_new", new), ("lengths", lengths)):
        if t.device != layer_k.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{layer_k.device}")
    if not (layer_k.is_contiguous() and lengths.is_contiguous()):
        raise ValueError(f"{name}: cache and lengths must be contiguous")
    if (Dh * layer_k.element_size()) % 16 or layer_k.data_ptr() % 16 \
            or new.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte multiples on "
                         f"16-byte aligned storage")
    _kernels.launch_kv_insert(layer_k, new, lengths)
    count_launch(insert_kernel, "row")
    return layer_k


reset_launches(insert_kernel)

INSERTS = {"index_put": insert_index_put, "onehot": insert_onehot,
           "cuda": insert_kernel}


def initial_state(L, B, KV, S, Dh, device, seed: int = 0):
    """(k_cache, v_cache [L, B, KV, S, Dh] bf16, k_new [B, 1, KV, Dh] bf16,
    lengths [B] int32 at 128, clamped into the cache) from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)
    lengths = torch.full((B,), min(128, S // 2), dtype=torch.int32,
                         device=device)
    return rnd(L, B, KV, S, Dh), rnd(L, B, KV, S, Dh), rnd(B, 1, KV, Dh), \
        lengths


def run_scan(name, dims, burst, reps, device):
    """Time ``name``'s insert over bursts of ``burst`` steps x L layers
    (K and V). Returns (ms/step, steps run, final k layers, v layers)."""
    L, B, KV, S, Dh = dims
    insert = INSERTS[name]
    k_cache, v_cache, k_new, lengths0 = initial_state(*dims, device)
    k_layers, v_layers = list(k_cache.unbind(0)), list(v_cache.unbind(0))

    def burst_fn():
        lengths = lengths0
        acc = torch.zeros((), device=device)
        for _ in range(burst):
            for i in range(L):
                k_layers[i] = insert(k_layers[i], k_new, lengths)
                v_layers[i] = insert(v_layers[i], k_new, lengths)
                # Feed every layer's result forward, as the JAX scan does.
                acc = acc + k_layers[i][0, 0, 0, 0].float()
            lengths = lengths + 1
        return acc

    best, warm, _ = best_ms(burst_fn, device, reps)
    ms = best / burst
    note(f"{name:10s}: {ms:8.3f} ms/step (warm-up burst {warm:.1f} ms)")
    return ms, burst * (1 + reps), k_layers, v_layers


def run_stacked(dims, burst, reps, device):
    """One insert into the [L, ...] stacked K cache per step, outside any
    layer loop (K only). Returns (ms/step, steps run)."""
    L, B, KV, S, Dh = dims
    k_cache, _, _, lengths0 = initial_state(*dims, device)
    gen = torch.Generator(device=device).manual_seed(1)
    k_new = torch.randn((L, B, 1, KV, Dh), generator=gen,
                        device=device).to(torch.bfloat16)
    b_idx = torch.arange(B, device=device)
    rows = k_new[:, :, 0].permute(1, 0, 2, 3)               # [B, L, KV, Dh]

    def burst_fn():
        lengths = lengths0
        acc = torch.zeros((), device=device)
        for _ in range(burst):
            # The indexed view k_cache[:, b, :, pos] is [B, L, KV, Dh].
            k_cache[:, b_idx, :, lengths.long()] = rows
            acc = acc + k_cache[0, 0, 0, 0, 0].float()
            lengths = lengths + 1
        return acc

    best, warm, _ = best_ms(burst_fn, device, reps)
    ms = best / burst
    note(f"{'stacked':10s}: {ms:8.3f} ms/step (k only! x2 for k+v; warm-up "
         f"burst {warm:.1f} ms)")
    return ms, burst * (1 + reps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m llmapigateway_tpu_torch.tools.profile_insert",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=22)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--burst", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card fails")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    note(f"device: {device}"
         + (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else ""))
    dims = (args.layers, args.batch, args.kv_heads, args.seq, args.head_dim)
    results = {"device": str(device), "dims": dict(zip(
        ("layers", "batch", "kv_heads", "seq", "head_dim"), dims)),
        "burst": args.burst, "ms_per_step": {}, "steps": {}}
    finals = {}
    with torch.no_grad():
        for name in INSERTS:
            if name == "cuda" and device.type != "cuda":
                note(f"{'cuda':10s}: not run — kernel #5 needs a CUDA device")
                continue
            ms, steps, k_layers, v_layers = run_scan(name, dims, args.burst,
                                                     args.reps, device)
            results["ms_per_step"][name] = ms
            results["steps"][name] = steps
            if name in ("cuda", "index_put"):
                finals[name] = (k_layers, v_layers)
            del k_layers, v_layers
        ms, steps = run_stacked(dims, args.burst, args.reps, device)
        results["ms_per_step"]["stacked"] = ms
        results["steps"]["stacked"] = steps
        if len(finals) == 2:
            results["cuda_equals_index_put"] = all(
                torch.equal(a, b) for side in (0, 1)
                for a, b in zip(finals["cuda"][side],
                                finals["index_put"][side]))
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
