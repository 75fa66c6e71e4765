"""The port's Mixtral family (models/mixtral.py) held to the JAX package's
``models/mixtral.py`` on the CPU, on inputs made from a numpy seed: the
router (ties broken toward the lower expert, as ``jax.lax.top_k`` does),
the dense all-experts MLP and the capacity-dispatch MLP (an overflowing
expert drops the same tokens), the forward of ``tiny-moe-test`` in bf16,
int8 and int4 over a prefill chunk long enough to dispatch and a decode
step, and ``tiny-moe-test`` engines at int8 and int4 on both KV layouts
whose greedy streams the JAX model settles."""
import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.models import llama as jllama
from llmapigateway_tpu.models import mixtral as jmixtral
from llmapigateway_tpu.models import quant as jq
from llmapigateway_tpu.models.config import get_preset as jget_preset
from llmapigateway_tpu_torch.models import llama as tllama
from llmapigateway_tpu_torch.models import mixtral as tmixtral
from llmapigateway_tpu_torch.models.config import get_preset
from llmapigateway_tpu_torch.models.convert import params_from_jax
from test_torch_engine import (GEOMETRY, PROMPTS, assert_jax_model_greedy,
                               one_torch_thread)
from test_torch_quant import (QTOL, np_params, port_greedy_streams,
                              quantized_jax_params)

assert one_torch_thread                  # the module-wide fixture, imported

PRESET = "tiny-moe-test"
# fp32 on both sides: only the order of sums differs.
TOL = 1e-5
# bf16 weights and activations: the two frameworks round at other places
# (an op's bf16 output against a fused fp32 chain); a few bf16 ulps of
# logits of magnitude ~2.
BF16_TOL = 6e-2


def _layer(params, i=0):
    """Layer ``i`` of a numpy params tree, the MoE leaves with it."""
    return {k: ({"q": v["q"][i], "s": v["s"][i]} if isinstance(v, dict)
                else v[i]) for k, v in params["layers"].items()}


def _t(tree):
    return params_from_jax(tree)


def test_route_matches_jax_with_tied_rows():
    """Probabilities equal, the same experts picked: rows whose logits tie
    across experts 1-3 (and an all-zero row, every expert tied) take the
    lower indices, as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(0)
    D, E, k = 16, 4, 2
    router = rng.standard_normal((D, E)).astype(np.float32)
    router[:, 2] = router[:, 3] = router[:, 1]
    x = rng.standard_normal((9, D)).astype(np.float32)
    x[4] = 0.0
    want = np.asarray(jax.jit(jmixtral.route, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(router), k))
    got = tmixtral.route(torch.from_numpy(x), torch.from_numpy(router),
                         k).numpy()
    assert np.array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert list(np.nonzero(got[4])[0]) == [0, 1]
    assert ((got[:, 2] > 0) <= (got[:, 1] > 0)).all()
    assert not (got[:, 3] > 0).any()


@functools.cache
def _params(mode: str):
    """tiny-moe-test params from a numpy seed, quantized by the JAX
    ``quantize_tree`` under ``mode`` (fp32 when "")."""
    params = np_params(PRESET, seed=3)
    if mode:
        run = jax.jit(lambda p: jq.quantize_tree(p, jget_preset(PRESET),
                                                 mode))
        params = jax.tree.map(np.asarray, run(params))
    return params


@pytest.mark.parametrize("mode", ["", "int8", "int4"],
                         ids=["fp32", "int8", "int4"])
def test_moe_mlp_dense_matches_jax(mode):
    x = np.random.default_rng(1).standard_normal((2, 5, 64)).astype(
        np.float32)
    lp = _layer(_params(mode))
    cfg = jget_preset(PRESET)
    want = np.asarray(jax.jit(lambda h, p: jmixtral.moe_mlp_dense(
        h, p, cfg))(jnp.asarray(x), lp))
    got = tmixtral.moe_mlp_dense(torch.from_numpy(x), _t(lp),
                                 get_preset(PRESET)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("capacity_factor", [0.5, 2.0])
def test_moe_mlp_dispatch_drops_the_same_tokens(capacity_factor):
    """Capacity dispatch over 40 tokens: at factor 0.5 (capacity 10 a
    queue) an overflowing expert drops tokens — the same ones in both, in
    token order — and at 2.0 (capacity 40) none, so dispatch equals the
    dense MLP."""
    x = np.random.default_rng(2).standard_normal((2, 20, 64)).astype(
        np.float32)
    lp = _layer(_params(""))
    cfg = jget_preset(PRESET)
    want = np.asarray(jax.jit(lambda h, p: jmixtral.moe_mlp_dispatch(
        h, p, cfg, capacity_factor=capacity_factor))(jnp.asarray(x), lp))
    tcfg = get_preset(PRESET)
    got = tmixtral.moe_mlp_dispatch(torch.from_numpy(x), _t(lp), tcfg,
                                    capacity_factor=capacity_factor).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    dense = tmixtral.moe_mlp_dense(torch.from_numpy(x), _t(lp), tcfg).numpy()
    changed = ~np.isclose(got, dense, rtol=TOL, atol=TOL).all(-1)
    assert np.array_equal(
        changed, ~np.isclose(want, dense, rtol=TOL, atol=TOL).all(-1))
    assert changed.any() == (capacity_factor < 1.0)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_forward_matches_jax(mode):
    """A 40-token prefill of two rows (80 tokens: capacity dispatch), then
    one decode step (the dense MLP), through both forwards and the plain
    cache attention; bf16 weights or fp32 weights quantized."""
    params = _params("" if mode == "bf16" else mode)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if mode == "bf16"
                else (jnp.float32, torch.float32))
    if mode == "bf16":
        params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)),
                              params)
    jcfg, tcfg = jget_preset(PRESET), get_preset(PRESET)
    toks = np.random.default_rng(4).integers(0, 500, (2, 41))
    jfwd = jax.jit(lambda p, t, n, c: jmixtral.forward(p, jcfg, t, n, c))
    jcache = jllama.KVCache.create(jcfg, 2, 64, dtype=jdt)
    tcache = tllama.KVCache.create(tcfg, 2, 64, dtype=tdt)
    tparams = _t(params)
    tol = BF16_TOL if mode == "bf16" else QTOL
    for lo, hi in ((0, 40), (40, 41)):
        jlog, jcache = jfwd(params, jnp.asarray(toks[:, lo:hi], jnp.int32),
                            jnp.full((2,), lo, jnp.int32), jcache)
        tlog, tcache = tmixtral.forward(
            tparams, tcfg, torch.from_numpy(toks[:, lo:hi]),
            torch.full((2,), lo, dtype=torch.int32), tcache,
            attention_fn=tllama.dense_cache_attention)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["int8", "int4"])
async def test_moe_engine_streams_are_the_jax_models(mode):
    """tiny-moe-test at int8 / int4 weights on both KV layouts: every
    greedy token is the JAX model's choice, teacher-forced through the JAX
    mixtral forward with the same quantized params."""
    jparams = await asyncio.to_thread(quantized_jax_params, PRESET, mode)
    geometry = {**GEOMETRY, "preset": PRESET, "quant": mode}
    streams = []
    for layout in ("paged", "contiguous"):
        streams += await port_greedy_streams(
            {**geometry, "kv_layout": layout}, jparams)
    assert all(len(s) == 10 for s in streams)
    await asyncio.to_thread(assert_jax_model_greedy, jparams, geometry,
                            PROMPTS * 2, streams, tol=QTOL)
