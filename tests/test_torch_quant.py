"""The port's weight quantization (models/quant.py, ops/quant_mm.py) held to
the JAX package's ``models/quant.py`` on the CPU, on inputs made from a
numpy seed: ``quantize_tree`` levels and scales bit for bit (int8, int4,
the tied head copy), ``params_from_jax`` on quantized trees, the int32 sums
of every quantized product equal to the JAX ``dot_general``'s and their
rescaled outputs within an fp32 rounding, the W4A8 kernel's plain version
and its packed layout, random init quantized layer by layer equal to the
quantization of the same draws, and tiny-test engines at int8 and int4 on
both KV layouts whose greedy streams the JAX model settles; and
chip_smoke.py's exact count of the quantized products a run launches, held
to an engine's own products. The W4A8 kernel
itself (csrc/w4a8_mm.cu) runs only on the card: chip_smoke.py holds its
int32 sums to this plain version there."""
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
from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
from llmapigateway_tpu_torch.engine.checkpoint import weight_count
from llmapigateway_tpu_torch.engine.engine import GenRequest, InferenceEngine
from llmapigateway_tpu_torch.models import init_fn
from llmapigateway_tpu_torch.models import quant as tq
from llmapigateway_tpu_torch.models.config import PRESETS, get_preset
from llmapigateway_tpu_torch.models.convert import params_from_jax
from llmapigateway_tpu_torch.ops import quant_mm as qm
from test_torch_engine import (GEOMETRY, PROMPTS, assert_jax_model_greedy,
                               one_torch_thread)

assert one_torch_thread                  # the module-wide fixture, imported

# The rescale is the same two fp32 products in the same order on both
# sides, so outputs agree to within an fp32 rounding of each other.
RTOL, ATOL = 2.0 ** -22, 1e-30
# Teacher-forced logits of a quantized model: the two frameworks' fp32
# activations differ in their last bits, which now and then moves one
# activation across a rounding boundary of its int8 level (1/127 of its
# row's largest magnitude). One such flip moved tiny-test's int8 logits by
# 0.0149 (every other quantized tiny model here: under 5e-7); QTOL admits
# three, both for the logits and as the near-tie margin of a greedy token.
QTOL = 0.05


def np_params(preset: str, seed: int = 0) -> dict:
    """JAX-layout params of ``preset`` (llama or mixtral shapes) drawn from
    a numpy seed: N(0, 1/fan_in), fp32."""
    c = jget_preset(preset)
    init = jmixtral.init_params if c.is_moe else jllama.init_params
    shapes = jax.eval_shape(lambda k: init(c, k, dtype=jnp.float32),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return jax.tree.map(draw, shapes)


def levels(q: torch.Tensor) -> torch.Tensor:
    """A port leaf's int8 levels (unpacked under int4)."""
    return qm.unpack_weight(q) if q.dtype == torch.uint8 else q


def jax_tree(params, preset, mode):
    """The JAX ``quantize_tree`` of ``params``, as numpy arrays. Eager, as
    the function is written: under ``jit`` XLA may compute ``amax / 127``
    otherwise than a division rounded once (its scales then differ from
    the eager function's, and from the JAX loader's numpy ``_np_quantize``,
    in the last bit), and the port's quantizer is the function as
    written."""
    return jax.tree.map(np.asarray, jq.quantize_tree(
        jax.tree.map(jnp.asarray, params), jget_preset(preset), mode))


def walk_quantized(tree, path=""):
    for key, val in tree.items():
        sub = f"{path}{key}"
        if tq.is_quantized(val):
            yield sub, val
        elif isinstance(val, dict):
            yield from walk_quantized(val, sub + ".")


TREE_CASES = [(p, m) for p in ("tiny-test", "tiny-qwen-test", "tiny-moe-test")
              for m in ("int8", "int4")]


@pytest.mark.parametrize("preset,mode", TREE_CASES,
                         ids=[f"{p}-{m}" for p, m in TREE_CASES])
def test_quantize_tree_matches_jax(preset, mode):
    """Levels and scales bit for bit, the same leaves quantized (the tied
    head copy ``lm_head_q8`` included); layer weights N-major, int4 packed
    two levels a byte, the head int8 under either mode."""
    params = np_params(preset)
    want = jax_tree(params, preset, mode)
    got = tq.quantize_tree(params_from_jax(params), get_preset(preset), mode)
    jleaves = dict(walk_quantized(want))
    tleaves = dict(walk_quantized(got))
    assert set(jleaves) == set(tleaves)
    assert ("lm_head_q8" in tleaves) == get_preset(preset).tie_embeddings
    for path, leaf in tleaves.items():
        jleaf = jleaves[path]
        assert torch.equal(levels(leaf["q"]),
                           torch.from_numpy(jleaf["q"].astype(np.int8))), path
        assert torch.equal(leaf["s"], torch.from_numpy(np.array(jleaf["s"]))
                           ), path
        packed = mode == "int4" and path.startswith("layers.")
        assert leaf["q"].dtype == (torch.uint8 if packed else torch.int8)
        if path.startswith("layers."):
            assert leaf["q"].transpose(-1, -2).is_contiguous(), path
            assert tq.is_packed(leaf) == packed


@pytest.mark.parametrize("preset,mode", TREE_CASES,
                         ids=[f"{p}-{m}" for p, m in TREE_CASES])
def test_weight_count_is_the_jax_tree_size(preset, mode):
    """``weight_count`` of a quantized tree is the parameter count of the
    JAX full-precision tree: a packed int4 byte is two weights, scales and
    the tied head copy none."""
    params = np_params(preset)
    got = tq.quantize_tree(params_from_jax(params), get_preset(preset), mode)
    assert weight_count(got) == sum(a.size for a in jax.tree.leaves(params))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_params_from_jax_carries_quantized_trees(mode):
    """A JAX quantized tree (ml_dtypes int4 arrays included) comes across
    in the port's storage: the same tensors, strides and dtypes as the
    port's own quantize_tree."""
    params = np_params("tiny-moe-test", seed=1)
    got = params_from_jax(jax_tree(params, "tiny-moe-test", mode))
    want = tq.quantize_tree(params_from_jax(params),
                            get_preset("tiny-moe-test"), mode)
    for (path, g), (_, w) in zip(walk_quantized(got), walk_quantized(want)):
        for part in ("q", "s"):
            assert g[part].dtype == w[part].dtype, path
            assert g[part].stride() == w[part].stride(), path
            assert torch.equal(g[part], w[part]), path


# -- the products --------------------------------------------------------------

def _product_inputs(fn, rng):
    """(x, weight, contract axis of the weight) at tiny shapes: K 64."""
    if fn == "mm":
        return rng.standard_normal((2, 5, 64)), rng.standard_normal((64, 96)), 0
    if fn == "moe_mm_dense":
        return rng.standard_normal((7, 64)), rng.standard_normal((3, 64, 32)), 1
    if fn == "moe_mm_batched":
        return (rng.standard_normal((3, 6, 64)),
                rng.standard_normal((3, 64, 32)), 1)
    return rng.standard_normal((2, 3, 64)), rng.standard_normal((40, 64)), 1


def _jax_sums(fn, xq, q):
    dn = {"mm": (((xq.ndim - 1,), (0,)), ((), ())),
          "moe_mm_dense": (((1,), (1,)), ((), ())),
          "moe_mm_batched": (((2,), (1,)), ((0,), (0,))),
          "head_matmul": (((xq.ndim - 1,), (1,)), ((), ()))}[fn]
    return np.array(jax.lax.dot_general(
        xq, jnp.asarray(q), dn, preferred_element_type=jnp.int32))


def _port_sums(fn, xq, xs, w):
    """The port's int32 sums before the rescale, in the JAX layout."""
    q = w["q"]
    if fn in ("mm", "head_matmul"):
        flat = xq.reshape(-1, xq.shape[-1])
        if tq.is_packed(w):
            acc = qm.w4a8_mm(flat[None], xs.reshape(-1, 1)[None], q[None],
                             w["s"][None], acc=True)[0]
        else:
            acc = qm.int8_mm(flat, q if fn == "mm" else q.t())
        return acc.reshape(*xq.shape[:-1], -1)
    E = q.shape[0]
    if fn == "moe_mm_dense":
        if tq.is_packed(w):
            acc = qm.w4a8_mm(xq.expand(E, *xq.shape),
                             xs.expand(E, *xs.shape), q, w["s"], acc=True)
        else:
            acc = torch.stack([qm.int8_mm(xq, q[e]) for e in range(E)])
        return acc.transpose(0, 1)                  # [N, E, F]
    if tq.is_packed(w):
        return qm.w4a8_mm(xq, xs, q, w["s"], acc=True)
    return torch.stack([qm.int8_mm(xq[e], q[e]) for e in range(E)])


PRODUCT_CASES = [(fn, m) for fn in ("mm", "moe_mm_dense", "moe_mm_batched")
                 for m in ("int8", "int4")] + [("head_matmul", "int8")]


@pytest.mark.parametrize("fn,mode", PRODUCT_CASES,
                         ids=[f"{f}-{m}" for f, m in PRODUCT_CASES])
def test_quantized_products_match_jax(fn, mode):
    """The activations quantize bit for bit, the int32 sums are equal, and
    the rescaled outputs agree to an fp32 rounding."""
    rng = np.random.default_rng(5)
    x, w, axis = (a.astype(np.float32) if isinstance(a, np.ndarray) else a
                  for a in _product_inputs(fn, rng))
    bits = 4 if mode == "int4" else 8
    jw = jq.quantize_array(jnp.asarray(w), axis, bits=bits)
    tw = tq.quantize_array(torch.from_numpy(w), axis, bits=bits)
    jxq, jxs = jq._dynamic_int8(jnp.asarray(x))           # eager: jax_tree
    txq, txs = tq._dynamic_int8(torch.from_numpy(x))
    assert torch.equal(txq, torch.from_numpy(np.array(jxq)))
    assert torch.equal(txs, torch.from_numpy(np.array(jxs)))
    assert torch.equal(_port_sums(fn, txq, txs, tw),
                       torch.from_numpy(_jax_sums(fn, jxq, jw["q"])))
    want = np.asarray(getattr(jq, fn)(jnp.asarray(x), jw))
    got = getattr(tq, fn)(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_w4a8_plain_version_and_packing():
    """Every level in [-7, 7] survives packing; the plain W4A8 product's
    sums are the exact integer product of the unpacked levels, an expert
    stride of 0 shares one activation block, and the fp32 epilogue is
    ``sums · xs · ws``. The wrapper refuses what the kernel cannot take."""
    lv = torch.arange(-7, 8, dtype=torch.int8).repeat(4)[:58].reshape(1, 58)
    assert torch.equal(qm.unpack_int4(qm.pack_int4(lv)), lv)
    g = torch.Generator().manual_seed(0)
    E, M, K, N = 3, 5, 64, 24
    xq = torch.randint(-127, 128, (M, K), generator=g).to(torch.int8)
    xs = torch.rand((M, 1), generator=g)
    w8 = torch.randint(-7, 8, (E, N, K), generator=g).to(torch.int8)
    wq = qm.pack_int4(w8).transpose(-1, -2)               # [E, K/2, N]
    ws = torch.rand((E, N), generator=g)
    acc = qm.w4a8_mm(xq.expand(E, M, K), xs.expand(E, M, 1), wq, ws,
                     acc=True)
    exact = torch.stack([(xq.double() @ w8[e].double().T).to(torch.int32)
                         for e in range(E)])
    assert torch.equal(acc, exact)
    out = qm.w4a8_mm(xq.expand(E, M, K), xs.expand(E, M, 1), wq, ws,
                     torch.bfloat16)
    assert torch.equal(out, (exact.float() * xs * ws[:, None, :]).to(
        torch.bfloat16))
    with pytest.raises(ValueError, match="uint8 packed w"):
        qm.w4a8_mm(xq[None], xs[None], w8[:1].transpose(-1, -2)[:, :K // 2],
                   ws[:1])
    with pytest.raises(ValueError, match="do not match"):
        qm.w4a8_mm(xq[None, :, :32], xs[None], wq[:1], ws[:1])
    with pytest.raises(ValueError, match="int8 operands"):
        qm.int8_mm(xq.float(), w8[0].T)


def test_an_unknown_quant_mode_fails_the_build():
    """As in the JAX engine (engine.py:396-403): the schema takes any
    string, and the engine's build refuses a mode it does not know."""
    with pytest.raises(ValueError, match="unknown quant 'int3'"):
        InferenceEngine(LocalEngineConfig(**{**GEOMETRY, "quant": "int3"}),
                        device="cpu")


INIT_CASES = [("tiny-test", "int8"), ("tiny-qwen-test", "int4"),
              ("tiny-moe-test", "int4")]


@pytest.mark.parametrize("preset,mode", INIT_CASES,
                         ids=[f"{p}-{m}" for p, m in INIT_CASES])
def test_quantized_init_is_the_quantized_draws(preset, mode):
    """Random init with ``quant`` fills the quantized leaves part by part
    from the same draws as the full-precision init: the result is
    ``quantize_tree`` of that init, leaf for leaf."""
    c = get_preset(preset)
    plain = init_fn(c)(c, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16)
    got = init_fn(c)(c, torch.Generator().manual_seed(0),
                     dtype=torch.bfloat16, quant=mode)
    want = tq.quantize_tree(plain, c, mode)
    assert sorted(got) == sorted(want)
    for (path, g), (wpath, w) in zip(walk_quantized(got),
                                     walk_quantized(want)):
        assert path == wpath
        assert torch.equal(g["q"], w["q"]) and torch.equal(g["s"], w["s"])
        assert g["q"].stride() == w["q"].stride(), path
    for key in ("attn_norm", "mlp_norm"):
        assert torch.equal(got["layers"][key], plain["layers"][key])


# -- engines -----------------------------------------------------------------

@functools.cache
def quantized_jax_params(preset: str, mode: str) -> dict:
    """``preset``'s params from a numpy seed, quantized by the JAX
    ``quantize_tree``, as numpy arrays."""
    return jax_tree(np_params(preset, seed=7), preset, mode)


async def port_greedy_streams(geometry, jparams, max_tokens=10):
    """The port engine's greedy streams of PROMPTS with the JAX params."""
    eng = InferenceEngine(LocalEngineConfig(**geometry), device="cpu")
    eng.params = params_from_jax(jparams)
    try:
        reqs = [GenRequest(prompt_ids=list(p), max_tokens=max_tokens)
                for p in PROMPTS]
        for r in reqs:
            await eng.submit(r)
        for r in reqs:
            async for _ in eng.stream(r):
                pass
        assert eng.stats()["quant"] == geometry["quant"]
        return [r.generated for r in reqs]
    finally:
        await eng.stop()


@pytest.mark.parametrize("mode", ["int8", "int4"])
async def test_quantized_engine_streams_are_the_jax_models(mode):
    """tiny-test at int8 / int4 weights on both KV layouts: every greedy
    token of the port's streams is the JAX model's choice, teacher-forced
    through the JAX forward with the same quantized params (both layouts'
    streams in one call)."""
    jparams = await asyncio.to_thread(quantized_jax_params, "tiny-test",
                                      mode)
    geometry = {**GEOMETRY, "quant": mode}
    streams = []
    for layout in ("paged", "contiguous"):
        streams += await port_greedy_streams(
            {**geometry, "kv_layout": layout}, jparams)
    assert all(len(s) == 10 for s in streams)
    await asyncio.to_thread(assert_jax_model_greedy, jparams, geometry,
                            PROMPTS * 2, streams, tol=QTOL)


SMOKE_COUNT_CASES = [(p, m) for p in ("tiny-test", "tiny-moe-test")
                     for m in ("int8", "int4")]


@pytest.mark.parametrize("preset,mode", SMOKE_COUNT_CASES,
                         ids=[f"{p}-{m}" for p, m in SMOKE_COUNT_CASES])
async def test_smoke_counts_every_quantized_product(monkeypatch, preset,
                                                    mode):
    """chip_smoke.py's exact launch check (``check_quant_run``) against an
    engine's own products, counted here on their plain versions as the
    wrappers count them on the card: each shape as often as the forwards
    need, an MoE chunk of more than 64 tokens in its dispatch form. Taking
    a dispatch chunk for a dense one fails the check."""
    import chip_smoke
    from llmapigateway_tpu_torch.models import mixtral
    from llmapigateway_tpu_torch.ops.flash_attention import (count_launch,
                                                            reset_launches)
    int8_plain, w4a8_plain = qm.int8_mm_plain, qm.w4a8_mm_plain

    def int8_counted(xq, wq):
        count_launch(qm.int8_mm, f"K{wq.shape[0]}/N{wq.shape[1]}")
        return int8_plain(xq, wq)

    def w4a8_counted(xq, xs, wq, ws, out_dtype=torch.float32, acc=False):
        count_launch(qm.w4a8_mm, f"K{xq.shape[2]}/N{wq.shape[2]}")
        return w4a8_plain(xq, xs, wq, ws, out_dtype, acc)
    monkeypatch.setattr(qm, "int8_mm_plain", int8_counted)
    monkeypatch.setattr(qm, "w4a8_mm_plain", w4a8_counted)
    products = (qm.int8_mm, qm.w4a8_mm)
    eng = InferenceEngine(LocalEngineConfig(
        **{**GEOMETRY, "preset": preset, "quant": mode}), device="cpu")
    for fn in products:
        reset_launches(fn)
    try:
        reqs = [GenRequest(prompt_ids=list(p), max_tokens=4)
                for p in PROMPTS]
        for r in reqs:
            await eng.submit(r)
        for r in reqs:
            async for _ in eng.stream(r):
                pass
    finally:
        await eng.stop()
    run = (eng.model_cfg,
           {"quant": mode, "rel_err": 0.0, "unique_bytes": 1,
            "arithmetic_bytes": 1, "build_transient_bytes": 0,
            "bf16_tree_bytes": 2},
           {"decode_steps": eng.decode_steps,
            "prefill_calls": eng.prefill_calls},
           dict(eng.prefill_shapes),
           {fn.__name__: fn.launches for fn in products},
           {fn.__name__: dict(fn.body_launches) for fn in products})
    forms = chip_smoke.check_quant_run(preset, *run)
    moe = eng.model_cfg.is_moe
    assert (forms["dispatch_forwards"] > 0) == moe
    assert forms["dense_forwards"] > eng.decode_steps
    if moe and mode == "int8":
        monkeypatch.setattr(mixtral, "DISPATCH_THRESHOLD", 10 ** 9)
        with pytest.raises(chip_smoke.SmokeFailure, match="int8_mm ran"):
            chip_smoke.check_quant_run(preset, *run)


# ---------------------------------------------------------------------------
# The W4A8 launch plan (ops/_kernels.py w4a8_plan), shapes alone
# ---------------------------------------------------------------------------

# Every full-size preset (the tiny ones run only on the CPU, through the
# plain version) at the row counts a launch sees: one row, decode batches,
# the decode/tile threshold (64) and ±1, ragged chunks, prefill chunks.
PLAN_PRESETS = sorted(p for p in PRESETS if not p.endswith("-test")
                      and not p.startswith("tiny-test"))
PLAN_ROWS = (1, 2, 8, 17, 32, 33, 64, 65, 256, 300, 512, 2048)
PLAN_SMS = 132


def quantized_shapes(c) -> set:
    """The (K, N) of a preset's quantized layer matmuls: Q, K/V, O, the
    MLP's gate/up and down (each expert's under MoE)."""
    D, q, kv = c.d_model, c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return {(D, q), (D, kv), (q, D), (D, c.d_ff), (c.d_ff, D)}


@pytest.mark.parametrize("preset,M", [(p, M) for p in PLAN_PRESETS
                                      for M in PLAN_ROWS],
                         ids=[f"{p}-M{M}" for p in PLAN_PRESETS
                              for M in PLAN_ROWS])
def test_w4a8_plan_covers_every_preset(preset, M):
    """For every (K, N) of the preset, one expert and eight (whether the
    eight share one row block or not: strides are no input of the plan):
    the body the row count asks for, row tiles, channel tiles and K splits
    that cover the product, a grid inside CUDA's limits, and a workspace
    exactly when K is split (each split's partial sums, then one zeroed
    counter an output tile)."""
    from llmapigateway_tpu_torch.ops import _kernels as k
    c = get_preset(preset)
    for K, N in sorted(quantized_shapes(c)):
        assert K % 128 == 0 and N % 128 == 0, (preset, K, N)
        for E in (1, 8):
            p = k.w4a8_plan(E, M, N, K, PLAN_SMS)
            want = ("dp4a" if M == 1 else
                    "decode" if M <= k.W4A8_DECODE_ROWS else "tile")
            if M == 2:          # dp4a unless the decode plan splits K
                want = ("dp4a" if k.w4a8_plan(E, M, N, K, PLAN_SMS, "decode")
                        .n_split == 1 else "decode")
            assert p.body == want, (preset, E, M, K, N, p)
            tiles, n_split, grid_e = p.grid
            assert grid_e == E and n_split == p.n_split
            assert 1 <= tiles < 2 ** 31 and n_split <= 65535 and E <= 65535
            if p.body == "dp4a":
                assert (tiles, p.n_split, p.workspace_ints) == (N // 8, 1, 0)
                assert p.row_tiles == M <= 2
                continue
            if p.body == "decode":
                assert p.row_tiles in (1, 2, 4, 8) and p.kw in (1, 2, 4)
                assert 8 * p.row_tiles >= M            # the fewest tiles
                assert p.row_tiles == 1 or M > 4 * p.row_tiles
                assert tiles * (128 // p.kw) == N
                step = k.W4A8_DECODE_K_STEP
            else:
                assert (p.row_tiles, p.kw) == (16, 1)
                assert tiles == -(-M // 128) * (N // 128)
                step = k.W4A8_K_STEP
            steps = -(-K // step)
            assert p.split_steps * p.n_split >= steps
            assert p.split_steps * (p.n_split - 1) < steps
            if p.n_split == 1:
                assert p.workspace_ints == p.counter_ints == 0
            else:
                assert p.counter_ints == E * tiles
                assert p.workspace_ints == p.n_split * E * M * N + E * tiles
                if p.body == "decode":      # long K, or few blocks
                    assert (steps >= k.W4A8_DECODE_SPLIT_MIN_STEPS
                            or (p.row_tiles >= 4
                                and 2 * E * tiles < PLAN_SMS))
                    assert p.split_steps >= 2
                    assert E * tiles * p.n_split <= 2 * PLAN_SMS
                else:                       # few tiles; one wave
                    assert 2 * E * tiles < PLAN_SMS
                    assert p.split_steps * step >= k.W4A8_TILE_SPLIT_LEVELS
                    assert E * tiles * p.n_split <= PLAN_SMS


@pytest.mark.parametrize("E,M,N,K,body", [
    (1, 8, 4096, 100, None), (1, 8, 96, 4096, None), (1, 8, 4096, 0, None),
    (1, 0, 4096, 4096, None), (0, 8, 4096, 4096, None),
    (70000, 8, 4096, 4096, None), (1, 8, 4096, 131200, None),
    (1, 65, 4096, 4096, "decode"), (1, 3, 4096, 4096, "dp4a"),
    (1, 8, 4096, 4096, "bogus")])
def test_w4a8_plan_refuses_with_the_shape(E, M, N, K, body):
    """A shape the kernel does not take raises ValueError naming it: K or
    N not a positive multiple of 128, K past the int32 bound, no rows, E
    outside CUDA's grid, more rows than a forced body takes, no body."""
    from llmapigateway_tpu_torch.ops import _kernels as k
    with pytest.raises(ValueError, match=f"E{E} M{M} K{K} N{N}"):
        k.w4a8_plan(E, M, N, K, PLAN_SMS, body)
