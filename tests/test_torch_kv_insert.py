"""Kernel #5 — the decode step's one-row KV insert — in the port
(llmapigateway_tpu_torch/tools/profile_insert.py), held to the JAX tool's
inserts (tools/profile_insert.py): the plain version (``insert_onehot``)
and the ``index_put`` variant against ``insert_pallas`` (interpret mode, as
it runs on the CPU) and ``insert_vmap_dus``, on seeded inputs whose cache
length is no multiple of the Pallas kernel's 8-row block, at lengths 0, 7
and S - 1. A copy has no rounding: the results must be equal.

The kernel's contract is ``0 <= lengths[b] < S``; outside it the port drops
the write. JAX is no oracle there (``insert_pallas`` writes whatever 8-row
block its index map reaches, ``insert_vmap_dus`` clamps onto row S - 1), so
the drop rule is pinned on its own. The CUDA kernel has no CPU mode: its
wrapper and the tool's ``cuda`` variant raise on CPU tensors, and the
``cuda``-marked test holds it to its plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu_torch.tools import profile_insert as tpi
from tools import profile_insert as jpi

B, KV, S, Dh = 3, 2, 20, 16                  # S 20: no multiple of 8
LENGTHS = [np.array(v, np.int32) for v in ([0, 7, S - 1], [S - 1, 0, 7],
                                           [7, 7, 0])]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((B, KV, S, Dh)).astype(np.float32)
    new = rng.standard_normal((B, 1, KV, Dh)).astype(np.float32)
    return cache, new


@pytest.mark.parametrize("lengths", LENGTHS, ids=lambda v: "-".join(map(str, v)))
@pytest.mark.parametrize("variant", ["onehot", "index_put"])
def test_insert_matches_jax_inserts(variant, lengths):
    cache, new = _inputs(int(lengths.sum()))
    ref_pallas = np.asarray(jpi.insert_pallas(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(lengths)))
    ref_dus = np.asarray(jpi.insert_vmap_dus(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(lengths)))
    np.testing.assert_array_equal(ref_pallas, ref_dus)
    fn = {"onehot": tpi.insert_onehot, "index_put": tpi.insert_index_put}[
        variant]
    got = fn(torch.from_numpy(cache.copy()), torch.from_numpy(new),
             torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), ref_pallas)


def test_insert_keeps_bf16_bits():
    """The tool's cache type: the written rows are the new rows' bf16 bits,
    every other row the cache's."""
    cache, new = _inputs(3)
    lengths = LENGTHS[0]
    tc = torch.from_numpy(cache).to(torch.bfloat16)
    tn = torch.from_numpy(new).to(torch.bfloat16)
    got = tpi.insert_onehot(tc, tn, torch.from_numpy(lengths))
    lib = tpi.insert_index_put(tc.clone(), tn, torch.from_numpy(lengths))
    assert torch.equal(got, lib)
    for b, n in enumerate(lengths):
        assert torch.equal(got[b, :, n], tn[b, 0])
        rest = [p for p in range(S) if p != n]
        assert torch.equal(got[b, :, rest], tc[b, :, rest])


def test_out_of_range_lengths_drop_the_write():
    """The port's rule (the kernel's contract and its plain version): a
    length outside [0, S) writes nothing, and the other slots' rows are
    written as usual."""
    cache, new = _inputs(4)
    lengths = torch.tensor([S, -1, 5], dtype=torch.int32)
    got = tpi.insert_onehot(torch.from_numpy(cache), torch.from_numpy(new),
                            lengths)
    want = cache.copy()
    want[2, :, 5] = new[2, 0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_and_cuda_variant_raise_on_cpu_tensors():
    cache, new = _inputs(5)
    lengths = torch.from_numpy(LENGTHS[0])
    launches = tpi.insert_kernel.launches
    with pytest.raises(ValueError, match="CUDA device"):
        tpi.insert_kernel(torch.from_numpy(cache), torch.from_numpy(new),
                          lengths)
    with pytest.raises(ValueError, match="CUDA device"):
        tpi.run_scan("cuda", (2, 2, 2, 16, 16), burst=2, reps=1,
                     device=torch.device("cpu"))
    assert tpi.insert_kernel.launches == launches


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """Kernel #5 on the card, bf16, at lengths 0, 7 and S - 1: equal to its
    plain version and to index_put, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cache, new = _inputs(6)
    c = torch.from_numpy(cache).to("cuda", torch.bfloat16)
    n = torch.from_numpy(new).to("cuda", torch.bfloat16)
    lengths = torch.from_numpy(LENGTHS[0]).cuda()
    launches = tpi.insert_kernel.launches
    got = tpi.insert_kernel(c.clone(), n, lengths)
    torch.cuda.synchronize()
    assert tpi.insert_kernel.launches == launches + 1
    assert torch.equal(got, tpi.insert_onehot(c, n, lengths))
    assert torch.equal(got, tpi.insert_index_put(c.clone(), n, lengths))
