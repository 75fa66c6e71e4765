"""The port's sampler (llmapigateway_tpu_torch/engine/sampling.py) held to
the JAX package's on the same numpy-seeded logits. The random draws come
from different generators, so draws are not compared: greedy rows and the
penalised argmax must be exact, and the top-k/top-p candidate sets (the
support a sampled row draws from) must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.engine import sampling as jsampling
from llmapigateway_tpu_torch.engine import sampling as tsampling

V = 97


def _params(temp, top_p, top_k, pres, freq):
    j = jsampling.SamplingParams(
        temperature=jnp.asarray(temp, jnp.float32),
        top_p=jnp.asarray(top_p, jnp.float32),
        top_k=jnp.asarray(top_k, jnp.int32),
        presence_penalty=jnp.asarray(pres, jnp.float32),
        frequency_penalty=jnp.asarray(freq, jnp.float32))
    t = tsampling.SamplingParams(
        temperature=torch.tensor(temp, dtype=torch.float32),
        top_p=torch.tensor(top_p, dtype=torch.float32),
        top_k=torch.tensor(top_k, dtype=torch.int32),
        presence_penalty=torch.tensor(pres, dtype=torch.float32),
        frequency_penalty=torch.tensor(freq, dtype=torch.float32))
    return j, t


def test_greedy_and_penalised_argmax_exact():
    rng = np.random.default_rng(0)
    B = 6
    logits = rng.standard_normal((B, V)).astype(np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    jp, tp = _params([0.0] * B, [1.0] * B, [0] * B,
                     [0.0, 0.5, 0.0, 1.5, 0.2, 0.0],
                     [0.0, 0.0, 0.7, 0.3, 2.0, 0.0])
    jtok = jsampling.sample(jnp.asarray(logits), jp, jax.random.PRNGKey(0),
                            counts=jnp.asarray(counts))
    ttok = tsampling.sample(torch.from_numpy(logits), tp,
                            torch.Generator().manual_seed(0),
                            counts=torch.from_numpy(counts))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(
        tsampling.apply_penalties(torch.from_numpy(logits),
                                  torch.from_numpy(counts), tp).numpy(),
        np.asarray(jsampling.apply_penalties(jnp.asarray(logits),
                                             jnp.asarray(counts), jp)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (10, 0.3),
                                         (1, 1.0), (V, 0.95), (0, 1.0)])
def test_candidate_sets_equal(monkeypatch, top_k, top_p):
    """JAX masks outside the candidate set with -inf and hands the masked
    logits to ``jax.random.categorical``; capture them there. At top_p = 1
    the port keeps every top-k token by definition, where JAX's fp32
    cumsum may reach 1.0 early and drop tail tokens of negligible mass."""
    rng = np.random.default_rng(top_k + int(100 * top_p))
    B = 4
    logits = (2.0 * rng.standard_normal((B, V))).astype(np.float32)
    temps = [0.7, 1.0, 1.3, 0.2]
    jp, tp = _params(temps, [top_p] * B, [top_k] * B, [0.0] * B, [0.0] * B)

    captured = {}
    real = jax.random.categorical

    def capture(key, masked, axis=-1):
        captured["masked"] = np.asarray(masked)
        return real(key, masked, axis=axis)
    monkeypatch.setattr(jax.random, "categorical", capture)
    jsampling.sample(jnp.asarray(logits), jp, jax.random.PRNGKey(1))
    jkeep = np.isfinite(captured["masked"])

    tmasked = tsampling.candidate_logits(torch.from_numpy(logits), tp)
    tkeep = torch.isfinite(tmasked).numpy()
    if top_p >= 1.0 and top_k in (0, V):
        assert tkeep.all()
        scaled = torch.from_numpy(logits) / torch.tensor(temps)[:, None]
        dropped = torch.softmax(scaled, -1).numpy()[~jkeep]
        assert dropped.sum() < 1e-5     # JAX dropped only a rounding tail
    else:
        np.testing.assert_array_equal(tkeep, jkeep)
    np.testing.assert_allclose(tmasked.numpy()[jkeep],
                               captured["masked"][jkeep], rtol=1e-6)

    # Every draw of the port lands inside its candidate set.
    gen = torch.Generator().manual_seed(2)
    for _ in range(20):
        tok = tsampling.sample(torch.from_numpy(logits), tp, gen).numpy()
        assert tkeep[np.arange(B), tok].all()
