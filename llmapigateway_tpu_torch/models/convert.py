"""Carry parameters and KV caches from the JAX package's layout into the
port's.

The JAX package's llama and mixtral params are a nested dict of arrays in
the stacked-layer layout, quantized leaves ``{"q", "s"}`` included; after
``jax.tree.map(np.asarray, params)`` it is a nested dict of numpy arrays,
which :func:`params_from_jax` turns into the port's nested dict of tensors
with the same keys and shapes — so both
packages compute the same function in the tests. :func:`kv_cache_from_jax`
does the same for a KV cache. No JAX import here: the caller does the
``np.asarray``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(leaf) -> torch.Tensor:
    """A numpy array → a CPU tensor of the same dtype. bf16 arrays
    (``ml_dtypes.bfloat16``, which numpy cannot hand to torch) come across
    bit-exact through their 16-bit payload."""
    arr = np.array(leaf, order="C")     # a writable copy torch can own
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree: dict[str, Any], path: str = "") -> dict[str, Any]:
    """Nested dict of numpy arrays → nested dict of CPU tensors of the same
    dtypes (``.to(device)`` them for the card). A quantized ``{"q", "s"}``
    leaf (int8, or ml_dtypes int4) comes across in the port's storage:
    N-major levels, int4 packed two a byte (models/quant.py)."""
    from .quant import from_jax_leaf, is_quantized
    out = {}
    for name, leaf in tree.items():
        sub = f"{path}.{name}" if path else name
        if is_quantized(leaf):
            out[name] = from_jax_leaf(sub, leaf["q"], leaf["s"])
        elif isinstance(leaf, dict):
            out[name] = params_from_jax(leaf, sub)
        else:
            out[name] = _tensor(leaf)
    return out


def kv_cache_from_jax(cache):
    """A JAX ``KVCache`` or ``PagedKVCache`` whose leaves are numpy arrays
    (bf16/fp32 tensors, or the int8 ``{"q","s"}`` dicts) → the port's cache
    of the same class name, layout and dtypes, on the CPU."""
    from ..models.llama import KVCache
    from ..ops.paged_attention import PagedKVCache
    classes = {"KVCache": KVCache, "PagedKVCache": PagedKVCache}
    cls = classes.get(type(cache).__name__)
    if cls is None:
        raise TypeError(f"not a JAX KV cache: {type(cache).__name__}; "
                        f"expected one of {sorted(classes)}")

    def side(x):
        if isinstance(x, dict):
            return {name: _tensor(leaf) for name, leaf in x.items()}
        return _tensor(x)
    return cls(k=side(cache.k), v=side(cache.v))
