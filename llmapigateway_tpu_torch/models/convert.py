"""Carry parameters from the JAX package's layout into the port's.

The JAX package's llama params are a nested dict of arrays in the
stacked-layer layout; after ``jax.tree.map(np.asarray, params)`` it is a
nested dict of numpy arrays, which :func:`params_from_jax` turns into the
port's nested dict of tensors with the same keys and shapes — so both
packages compute the same function in the tests. No JAX import here: the
caller does the ``np.asarray``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(tree: dict[str, Any]) -> dict[str, Any]:
    """Nested dict of numpy arrays → nested dict of CPU tensors of the same
    dtypes (``.to(device)`` them for the card). bf16 arrays (``ml_dtypes.bfloat16``,
    which numpy cannot hand to torch) come across bit-exact through their
    16-bit payload."""
    out: dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_jax(leaf)
            continue
        arr = np.array(leaf, order="C")     # a writable copy torch can own
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[name] = t
    return out
