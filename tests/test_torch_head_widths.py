"""Every head width and group size the presets have, in the port, held to
the JAX package: the plain versions of kernels #1-#4 against the Pallas
kernels (interpret mode, as the JAX tests run them on the CPU) at head
widths 64 (tinyllama, qwen2) and 256 (gemma) and at groups of 3
(llama-3b-class) and 7 (qwen2-0.5b) query heads per KV head, decode and
prefill, fp32 and int8 caches, with and without a window; the qwen2 and
gemma families' forward (``tiny-qwen-test``: QKV bias, tied embeddings;
``tiny-gemma-test``: GeGLU, (1 + w) RMSNorm, scaled embeddings) against the
JAX forward on the same weights; and the engine's refusal, at build, of a
head geometry no kernel is compiled for when it is asked for the card.

Tolerances: attention outputs 1e-5 in fp32, as in
test_torch_{paged,flash}_attention.py (the same function, sums in another
order); the forward 1e-4 on fp32 logits, as in test_torch_llama.py (two
frameworks' matmuls). The CUDA bodies of these widths and groups are held
to the same plain versions on the card by chip_smoke.py's group sweep.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.models import llama as jllama
from llmapigateway_tpu.models.config import get_preset as jget_preset
from llmapigateway_tpu.ops import flash_attention as jfa
from llmapigateway_tpu.ops import paged_attention as jpa
from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
from llmapigateway_tpu_torch.engine.engine import InferenceEngine
from llmapigateway_tpu_torch.models import llama as tllama
from llmapigateway_tpu_torch.models.config import get_preset
from llmapigateway_tpu_torch.models.convert import params_from_jax
from llmapigateway_tpu_torch.ops import _kernels
from llmapigateway_tpu_torch.ops import flash_attention as tfa
from llmapigateway_tpu_torch.ops import paged_attention as tpa

ATOL = RTOL = 1e-5
TOL = 1e-4
PAGE, NP = 8, 6
S = PAGE * NP                                  # 48 positions per slot
WINDOW = 13                                    # no multiple of page or block
# (head width, group, KV heads): the new widths at a group the presets
# have, and the new groups at llama-3b-class's and qwen2's widths.
GEOMETRIES = [(64, 8, 1), (256, 8, 1), (256, 1, 2), (128, 3, 2), (64, 7, 2)]
IDS = [f"Dh{d}-G{g}" for d, g, _ in GEOMETRIES]


def _t(a):
    return torch.from_numpy(np.array(a))


def _side(rng, shape, quant):
    """One cache side of fp32 values, or the int8 dict the JAX quantizer
    makes of them (scales [.., KV, 1, N])."""
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    if not quant:
        return x
    q, s = jllama.quantize_kv(jnp.asarray(x))
    return {"q": np.asarray(q), "s": np.asarray(s)[..., None, :]}


def _jax(side):
    if isinstance(side, dict):
        return {k: jnp.asarray(v) for k, v in side.items()}
    return jnp.asarray(side)


def _torch(side):
    if isinstance(side, dict):
        return {k: _t(v) for k, v in side.items()}
    return _t(side)


def _table(rng, B, first_pages, last_pages):
    """A shuffled page table mapping only logical pages [first, last) of
    each slot (what the SWA ring leaves mapped); the rest is trash page 0."""
    table = rng.permutation(np.arange(1, B * NP + 1)).reshape(B, NP)
    table = table.astype(np.int32)
    for b in range(B):
        table[b, :first_pages[b]] = 0
        table[b, last_pages[b]:] = 0
    return table


N_STALE = np.asarray([0, 1, WINDOW - 1, WINDOW + 1, 29, S - 1], np.int32)
STARTS = np.asarray([0, 5, WINDOW + 3, S - 12], np.int32)
T = 12

CASES = [pytest.param(dh, g, kv, quant, window,
                      id=f"{i}-{'int8' if quant else 'fp32'}-w{window}")
         for (dh, g, kv), i in zip(GEOMETRIES, IDS)
         for quant in (False, True) for window in (0, WINDOW)]


@pytest.mark.parametrize("Dh,G,KV,quant,window", CASES)
def test_paged_decode_matches_pallas(Dh, G, KV, quant, window):
    rng = np.random.default_rng(Dh + 10 * G + 100 * quant + window)
    B, H = len(N_STALE), KV * G
    w0 = np.maximum(N_STALE - (window - 1), 0) if window else 0 * N_STALE
    table = _table(rng, B, w0 // PAGE, -(-N_STALE // PAGE))
    pk = _side(rng, (B * NP + 1, KV, PAGE, Dh), quant)
    pv = _side(rng, (B * NP + 1, KV, PAGE, Dh), quant)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(pk), _jax(pv),
        jnp.asarray(table), jnp.asarray(N_STALE), window=window,
        interpret=True)
    got = tpa.paged_decode_attention(_t(q), _t(kn), _t(vn), _torch(pk),
                                     _torch(pv), _t(table), _t(N_STALE),
                                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("Dh,G,KV,quant,window", CASES)
def test_paged_prefill_matches_pallas(Dh, G, KV, quant, window):
    rng = np.random.default_rng(1 + Dh + 10 * G + 100 * quant + window)
    B, H = len(STARTS), KV * G
    floor = np.maximum(STARTS - (window - 1), 0) if window else 0 * STARTS
    table = _table(rng, B, floor // PAGE, -(-(STARTS + T) // PAGE))
    pk = _side(rng, (B * NP + 1, KV, PAGE, Dh), quant)
    pv = _side(rng, (B * NP + 1, KV, PAGE, Dh), quant)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), _jax(pk), _jax(pv), jnp.asarray(table),
        jnp.asarray(STARTS), block_t=T, window=window, interpret=True)
    got = tpa.paged_prefill_attention(_t(q), _torch(pk), _torch(pv),
                                      _t(table), _t(STARTS), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("Dh,G,KV,quant,window", CASES)
def test_flash_decode_matches_pallas(Dh, G, KV, quant, window):
    rng = np.random.default_rng(2 + Dh + 10 * G + 100 * quant + window)
    B, H = len(N_STALE), KV * G
    lk = _side(rng, (B, KV, S, Dh), quant)
    lv = _side(rng, (B, KV, S, Dh), quant)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    ref = jfa.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(lk), _jax(lv),
        jnp.asarray(N_STALE), block_s=16, window=window, interpret=True)
    got = tfa.flash_decode_attention(_t(q), _t(kn), _t(vn), _torch(lk),
                                     _torch(lv), _t(N_STALE), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("Dh,G,KV,quant,window", CASES)
def test_flash_prefill_matches_pallas(Dh, G, KV, quant, window):
    rng = np.random.default_rng(3 + Dh + 10 * G + 100 * quant + window)
    B, H = len(STARTS), KV * G
    lk = _side(rng, (B, KV, S, Dh), quant)
    lv = _side(rng, (B, KV, S, Dh), quant)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    ref = jfa.flash_prefill_attention(
        jnp.asarray(q), _jax(lk), _jax(lv), jnp.asarray(STARTS), block_t=T,
        block_s=16, window=window, interpret=True)
    got = tfa.flash_prefill_attention(_t(q), _torch(lk), _torch(lv),
                                      _t(STARTS), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_kernel_geometry_covers_every_dense_preset():
    """Every head width and decode group of the served (dense) presets is
    one the kernels are built for; a width no preset has stays refused."""
    from llmapigateway_tpu_torch.models.config import PRESETS
    for name, c in PRESETS.items():
        if c.is_moe or name.startswith("tiny-"):
            continue
        assert _kernels.unsupported_geometry(
            c.head_dim, c.n_heads, c.n_kv_heads) is None, name
    assert "head_dim 16" in _kernels.unsupported_geometry(16, 4, 2)
    assert "group of 5" in _kernels.unsupported_geometry(64, 10, 2)
    # Prefill takes any group over a whole number of KV heads.
    assert _kernels.unsupported_geometry(64, 10, 2, decode=False) is None


@pytest.mark.parametrize("preset", ["tiny-qwen-test", "tiny-gemma-test"])
def test_family_forward_matches_jax(preset):
    """A prefill chunk and a deferred-insert decode step (one slot
    inactive) over the contiguous cache through the plain dense path, the
    same fp32 weights in both packages."""
    jcfg = jget_preset(preset)
    cfg = get_preset(preset)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5),
                                 dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(6)
    B, T, S_ = 2, 11, 32
    start = np.array([0, 7], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    jcache = jllama.KVCache.create(jcfg, B, S_, dtype=jnp.float32)
    tcache = tllama.KVCache.create(cfg, B, S_, torch.float32)
    jlog, jcache = jllama.forward(jparams, jcfg, jnp.asarray(tokens),
                                  jnp.asarray(start), jcache)
    tlog, tcache = tllama.forward(tparams, cfg, torch.from_numpy(tokens),
                                  torch.from_numpy(start), tcache,
                                  attention_fn=tllama.dense_cache_attention)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)

    lengths = start + T
    step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    active = np.array([True, False])
    jlog, jcache = jllama.forward(jparams, jcfg, jnp.asarray(step),
                                  jnp.asarray(lengths), jcache,
                                  active=jnp.asarray(active))
    tlog, tcache = tllama.forward(tparams, cfg, torch.from_numpy(step),
                                  torch.from_numpy(lengths), tcache,
                                  attention_fn=tllama.dense_cache_attention,
                                  active=torch.from_numpy(active))
    np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog)[0],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("preset", ["tiny-test", "tiny-gemma-test"])
def test_cuda_engine_refuses_an_unbuilt_head_width_at_build(preset):
    """Asked for the card, an engine whose heads are 16 wide is refused
    before anything touches the device (so the check runs here, with no
    card); on the CPU the same preset builds (the plain versions take any
    width)."""
    cfg = LocalEngineConfig(preset=preset, kv_layout="contiguous",
                            max_seq_len=64)
    with pytest.raises(ValueError, match="head_dim 16 unsupported"):
        InferenceEngine(cfg, device="cuda")
    assert InferenceEngine(cfg, device="cpu").model_cfg.head_dim == 16
