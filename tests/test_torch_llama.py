"""The port's llama forward held to the JAX package's on ``tiny-test``, the
same weights carried by ``params_from_jax``: a prefill chunk over the paged
pool and a T = 1 deferred-insert decode step, the port's paged attention fn
against ``make_paged_attention_fn(impl="reference")``.

Tolerance: 1e-4 on fp32 logits and pools (the same function through two
frameworks' matmuls, which sum in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.models import llama as jllama
from llmapigateway_tpu.models.config import RopeScaling as JRopeScaling
from llmapigateway_tpu.models.config import get_preset as jget_preset
from llmapigateway_tpu.ops.paged_attention import (
    PagedKVCache as JPagedKVCache, make_paged_attention_fn as jmake)
from llmapigateway_tpu_torch.models import forward_fn, init_fn
from llmapigateway_tpu_torch.models import llama as tllama
from llmapigateway_tpu_torch.models.config import RopeScaling, get_preset
from llmapigateway_tpu_torch.models.convert import params_from_jax
from llmapigateway_tpu_torch.ops.paged_attention import (
    PagedKVCache, make_paged_attention_fn)
from test_torch_engine import one_torch_thread  # noqa: F401

TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = jget_preset("tiny-test")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3),
                                 dtype=jnp.float32)
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def test_params_from_jax_keeps_layout_and_bf16_bits():
    cfg = jget_preset("tiny-test")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0))   # bf16
    got = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(got) == set(jparams)
    assert set(got["layers"]) == set(jparams["layers"])
    for name, leaf in jparams["layers"].items():
        t = got["layers"][name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16))


def test_port_init_uses_the_stacked_layout():
    cfg = get_preset("tiny-test")
    params = init_fn(cfg)(cfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(
        lambda k: jllama.init_params(jget_preset("tiny-test"), k),
        jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in params["layers"].items()} == {
        k: v.shape for k, v in jshapes["layers"].items()}
    assert tuple(params["embed"].shape) == jshapes["embed"].shape
    assert params["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("scaling", [
    None, ("llama3", 8.0, 1.0, 4.0, 8192), ("linear", 4.0, 1.0, 4.0, 8192)])
def test_rope_tables_match(scaling):
    pos = np.array([[0, 1, 17, 2047], [4095, 5000, 8191, 12000]], np.int32)
    js = JRopeScaling(*scaling) if scaling else None
    ts = RopeScaling(*scaling) if scaling else None
    jcos, jsin = jllama.rope_tables(jnp.asarray(pos), 128, 500000.0, js)
    tcos, tsin = tllama.rope_tables(torch.from_numpy(pos), 128, 500000.0, ts)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-5)


def _case(seed, B=2, page=16, NP=4):
    rng = np.random.default_rng(seed)
    P = B * NP + 1
    table = rng.permutation(np.arange(1, P)).reshape(B, NP).astype(np.int32)
    return rng, P, table


def test_forward_prefill_and_decode_match_jax(tiny):
    jcfg, jparams, tparams = tiny
    cfg = get_preset("tiny-test")
    rng, P, table = _case(1)
    page, B, T = 16, 2, 20
    S = table.shape[1] * page
    start = np.array([0, 9], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)

    # Prefill chunk (insert-then-attend) crossing a page.
    jcache = JPagedKVCache.create(jcfg, P, page, dtype=jnp.float32)
    jattn = jmake(jnp.asarray(table), max_seq=S, impl="reference")
    jlog, jcache = jllama.forward(jparams, jcfg, jnp.asarray(tokens),
                                  jnp.asarray(start), jcache,
                                  attention_fn=jattn)
    tcache = PagedKVCache.create(cfg, P, page, torch.float32)
    tattn = make_paged_attention_fn(torch.from_numpy(table))
    tlog, tcache = forward_fn(cfg)(tparams, cfg, torch.from_numpy(tokens),
                                   torch.from_numpy(start), tcache,
                                   attention_fn=tattn)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=TOL, rtol=TOL)

    # One deferred-insert decode step, one slot inactive.
    lengths = start + T
    step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    active = np.array([True, False])
    jlog, jcache = jllama.forward(jparams, jcfg, jnp.asarray(step),
                                  jnp.asarray(lengths), jcache,
                                  active=jnp.asarray(active),
                                  attention_fn=jattn)
    tlog, tcache = forward_fn(cfg)(tparams, cfg, torch.from_numpy(step),
                                   torch.from_numpy(lengths), tcache,
                                   attention_fn=tattn,
                                   active=torch.from_numpy(active))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               atol=TOL, rtol=TOL)


def test_building_blocks_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    np.testing.assert_allclose(
        tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-6, rtol=1e-6)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2], [7, 8, 9]], np.int32)
    jc, js = jllama.rope_tables(jnp.asarray(pos), 16, 10000.0)
    tc, ts = tllama.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(
        tllama.apply_rope(torch.from_numpy(q), tc, ts).numpy(),
        np.asarray(jllama.apply_rope(jnp.asarray(q), jc, js)),
        atol=1e-6, rtol=1e-6)
    wg, wu = (rng.standard_normal((64, 32)).astype(np.float32) for _ in "gu")
    wd = rng.standard_normal((32, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tllama.swiglu_mlp(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
        .numpy(),
        np.asarray(jllama.swiglu_mlp(*(jnp.asarray(a)
                                       for a in (x, wg, wu, wd)))),
        atol=TOL, rtol=TOL)


def test_moe_family_dispatches_to_mixtral():
    from llmapigateway_tpu_torch.models import init_fn, mixtral
    assert forward_fn(get_preset("tiny-moe-test")) is mixtral.forward
    assert init_fn(get_preset("tiny-moe-test")) is mixtral.init_params
    assert forward_fn(get_preset("tiny-test")) is tllama.forward
