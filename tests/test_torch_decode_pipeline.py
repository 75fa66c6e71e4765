"""The port's compiled, lag-one-pipelined decode step and its burst-depth
controller (llmapigateway_tpu_torch/engine/engine.py, engine/decode_graphs.py)
held to the JAX engine on the CPU:

* the ``ttft_target_ms`` controller: one script of wall samples, state and
  busy flags fed to both engines' controllers gives the same picks, step
  estimates, fixed costs, state and ``stats()`` fields (cases mirror
  tests/test_engine.py's controller tests);
* the lag-one contract: dispatching burst N returns burst N-1's rows, and
  the rows of a pipelined run equal a synchronous run's, in order; tokens
  of a slot released or re-admitted since its burst's dispatch come back
  as -1, and through the scheduler a request admitted (from the prefix
  cache) into the slot of one cancelled with a burst in flight gets none
  of that burst's tokens;
* greedy streams under churn (more requests than slots, mixed budgets,
  slots re-admitted while a burst is in flight), with and without a TTFT
  target, on both layouts, both KV types, the paged SWA ring and the paged
  pool with the prefix cache on, equal the JAX engine's (a disagreement
  settled by the JAX model, as in test_torch_engine.py), with equal finish
  reasons, usage counts and ``cached_tokens``, no request past its budget
  or the cache, and the prefix cache's invariants held;
* the graph runner's launch accounting, with a stub in place of
  ``torch.cuda.CUDAGraph``; and the sampled draw held to the distribution
  it samples.

Tolerances: controller numbers exact (the same arithmetic in the same
order); streams exact, or each port token the JAX model's greedy choice
within 1e-4 (test_torch_engine.TOL); the draw's frequencies within 5
standard deviations of their probabilities.
"""
import asyncio
import copy
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from llmapigateway_tpu.config.schemas import LocalEngineConfig as JConfig
from llmapigateway_tpu.engine.engine import InferenceEngine as JEngine
from llmapigateway_tpu_torch.config.schemas import LocalEngineConfig
from llmapigateway_tpu_torch.engine import decode_graphs
from llmapigateway_tpu_torch.engine.engine import GenRequest, InferenceEngine
from llmapigateway_tpu_torch.engine.sampling import draw_tokens
from llmapigateway_tpu_torch.models.convert import params_from_jax
from llmapigateway_tpu_torch.ops.flash_attention import (body_name,
                                                        count_launch,
                                                        flash_decode_attention)
from llmapigateway_tpu_torch.ops.paged_attention import paged_decode_attention
from test_torch_engine import (assert_jax_model_greedy, load_jax_params,
                               one_torch_thread, reference_env)  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# The burst-depth controller, step for step against the JAX engine's
# ---------------------------------------------------------------------------

CONTROLLER = dict(kv_layout="contiguous", preset="tiny-test",
                  max_batch_size=2, max_seq_len=64, prefill_chunk=16,
                  dtype="float32")
STATE = ("_burst_walls", "_burst_wall_stamp", "_burst_wall_n", "_fit_slope",
         "_fit_stamp", "_idle_burst_i", "_explore_pending", "_explore_depth",
         "_depth_hist", "_busy_clamps", "_last_burst_depth",
         "_burst_depths")
STATS = ("burst_step_ms_fit", "burst_fixed_cost_ms", "burst_depth_hist",
         "burst_walls_ms", "burst_depth_last", "burst_busy_clamps")
IDLE = [("depth", False)]
# (name, engine knobs, script). Ops: ("set", attr, value); ("wall", depth,
# ms): a steady same-depth pair's wall; ("burst", depth): a real
# _decode_burst; ("depth", busy); ("estimate",): (_step_ms_estimate,
# _fixed_cost_ms); ("stats",): the controller's stats() fields.
CONTROLLER_CASES = [
    ("idle-cap", dict(decode_burst=32, decode_burst_busy=4,
                      ttft_target_ms=100.0), [
        ("depth", False), ("depth", True),
        ("set", "_burst_walls", {32: 64.0}), ("depth", False),
        ("set", "_burst_walls", {32: 96.0}), ("depth", False),
        ("set", "_burst_walls", {32: 32.0}), ("depth", False),
        ("set", "_burst_walls", {32: 1280.0}), ("depth", False),
        ("set", "_burst_walls", {32: 64.0}), ("depth", True), ("stats",)]),
    ("fixed-cost-removed", dict(decode_burst=32, decode_burst_busy=4,
                                ttft_target_ms=100.0), [
        ("set", "_burst_walls", {4: 48.0}), ("estimate",), ("depth", False),
        ("set", "_burst_walls", {4: 48.0, 16: 72.0}), ("estimate",),
        ("depth", False),
        ("set", "_burst_walls", {4: 48.0, 16: 40.0}), ("estimate",),
        ("set", "_fit_slope", None), ("estimate",), ("stats",)]),
    ("stale-depths", dict(decode_burst=32, decode_burst_busy=4,
                          ttft_target_ms=100.0), [
        ("set", "_burst_walls", {32: 80.0, 16: 72.0}),
        ("set", "_burst_wall_stamp", {32: 1, 16: 1000}),
        ("set", "_burst_wall_n", 1000), ("estimate",),
        ("set", "_burst_wall_n", 2000), ("estimate",), ("stats",)]),
    ("slope-survives-ageing", dict(decode_burst=32, decode_burst_busy=4,
                                   ttft_target_ms=200.0), [
        ("set", "_burst_walls", {16: 132.0, 32: 204.0}),
        ("set", "_burst_wall_stamp", {16: 100, 32: 100}),
        ("set", "_burst_wall_n", 100), ("estimate",), ("depth", False),
        ("set", "_burst_wall_stamp", {16: 1000, 32: 100}),
        ("set", "_burst_wall_n", 1000), ("estimate",), ("depth", False),
        ("stats",),
        ("set", "_burst_wall_n", 1000 + 4096 + 1),
        ("set", "_burst_wall_stamp", {16: 1000 + 4096 + 1}),
        ("set", "_burst_walls", {16: 132.0}), ("estimate",), ("stats",)]),
    ("explore-pairs", dict(decode_burst=32, decode_burst_busy=4,
                           ttft_target_ms=200.0), [
        ("set", "_burst_walls", {16: 132.0, 32: 204.0}),
        ("set", "_burst_wall_stamp", {16: 10, 32: 10}),
        ("set", "_burst_wall_n", 10), *IDLE * 68,
        ("set", "_burst_walls", {32: 96.0}),
        ("set", "_burst_wall_stamp", {32: 10}),
        ("set", "_fit_slope", None), ("set", "_explore_pending", 0),
        *IDLE * 34, ("depth", True), *IDLE * 3, ("stats",)]),
    ("any-steady-depth", dict(decode_burst=8, decode_burst_busy=2,
                              max_seq_len=96, ttft_target_ms=100.0), [
        ("wall", 4, 30.0), ("wall", 4, 36.0), ("estimate",),
        ("wall", 8, 41.0), ("estimate",), ("depth", False),
        ("wall", 2, 22.5), ("wall", 8, 47.0), ("estimate",),
        ("depth", True), ("depth", False), ("stats",)]),
    ("steady-pairs-only", dict(decode_burst=8, decode_burst_busy=2,
                               max_seq_len=96, ttft_target_ms=100.0), [
        ("burst", 4), ("burst", 4), ("burst", 8), ("burst", 8),
        ("burst", 2)]),
    ("no-target", dict(decode_burst=8, decode_burst_busy=2), [
        ("set", "_burst_walls", {8: 400.0}), ("depth", False),
        ("depth", True), ("wall", 8, 90.0), ("depth", False), ("stats",)]),
    ("busy-clamp", dict(decode_burst=32, decode_burst_busy=16,
                        ttft_target_ms=100.0), [
        ("depth", True), ("set", "_burst_walls", {32: 96.0, 16: 64.0}),
        ("depth", True), ("depth", False),
        ("set", "_burst_walls", {32: 3200.0}), ("set", "_fit_slope", None),
        ("depth", True), ("set", "_burst_walls", {32: 32.0, 16: 16.0}),
        ("depth", True), ("set", "ttft_target_ms", 0.0),
        ("set", "_burst_walls", {32: 3200.0}), ("depth", True),
        ("stats",)]),
]


def _jax_record_wall(eng, d: int, wall: float) -> None:
    """The JAX engine's steady-pair update, written inline in its
    ``_decode_burst`` (engine.py:3280-3288)."""
    prev_w = eng._burst_walls.get(d)
    eng._burst_walls[d] = wall if prev_w is None else 0.8 * prev_w + 0.2 * wall
    eng._burst_wall_n += 1
    eng._burst_wall_stamp[d] = eng._burst_wall_n


def _run_op(eng, op, is_jax: bool):
    kind = op[0]
    if kind == "set":
        setattr(eng, op[1], copy.deepcopy(op[2]))
    elif kind == "wall":
        if is_jax:
            _jax_record_wall(eng, op[1], op[2])
        else:
            eng._record_burst_wall(op[1], op[2])
    elif kind == "burst":
        eng._decode_burst(op[1])
        # Real walls: their depths, not their values, are comparable.
        return sorted(eng._burst_walls), eng._burst_wall_n
    elif kind == "depth":
        return eng._burst_depth(op[1])
    elif kind == "estimate":
        return eng._step_ms_estimate(), eng._fixed_cost_ms()
    elif kind == "stats":
        s = eng.stats()
        return {k: s[k] for k in STATS if k in s}
    return None


def _controller_state(eng, timed: bool) -> dict:
    state = {k: copy.deepcopy(getattr(eng, k)) for k in STATE}
    if timed:
        state["_burst_walls"] = sorted(state["_burst_walls"])
        state["_fit_slope"] = state["_fit_slope"] is None
    return state


@pytest.mark.parametrize("name,knobs,script", CONTROLLER_CASES,
                         ids=[c[0] for c in CONTROLLER_CASES])
def test_controller_matches_jax_engine(name, knobs, script):
    cfg = {**CONTROLLER, **knobs}
    jeng = JEngine(JConfig(**cfg, prewarm_sampler_variants=False),
                   devices=[jax.devices("cpu")[0]])
    teng = InferenceEngine(LocalEngineConfig(**cfg), device="cpu")
    timed = any(op[0] == "burst" for op in script)
    if timed:
        for eng in (jeng, teng):
            eng.lengths[:] = 4
            eng.active[:] = True
            eng.last_token[:] = 1
            eng._d_dirty = True
    assert teng._burst_depths == jeng._burst_depths
    for i, op in enumerate(script):
        got = _run_op(teng, op, False)
        want = _run_op(jeng, op, True)
        assert got == want, f"op {i} {op}: port {got} != JAX {want}"
        assert _controller_state(teng, timed) == _controller_state(
            jeng, timed), f"state after op {i} {op}"
    if timed:
        # Two steady pairs, at 4 and at 8; the transitions recorded none.
        assert sorted(teng._burst_walls) == [4, 8]
        assert teng._step_ms_estimate() is not None


# ---------------------------------------------------------------------------
# The lag-one contract and epoch masking, on the port's engine
# ---------------------------------------------------------------------------

PIPE = dict(preset="tiny-test", kv_page_size=16, max_batch_size=3,
            max_seq_len=128, prefill_chunk=32, dtype="float32",
            decode_burst=8, decode_burst_busy=4)


def _prefilled(layout: str, params=None) -> InferenceEngine:
    """A port engine with every slot prefilled (greedy) and decoding."""
    eng = InferenceEngine(LocalEngineConfig(**PIPE, kv_layout=layout),
                          device="cpu")
    if params is not None:
        eng.params = params
    rng = np.random.default_rng(3)
    for slot, n in enumerate((9, 26, 40)):
        prompt = rng.integers(0, 256, n).tolist()
        if eng.paged:
            eng.allocator.allocate(slot, eng.S)
            eng._table_dirty = True
        first = eng._exec_prefill([slot], [0], [prompt],
                                  [(0.0, 1.0, 0, 0.0, 0.0)])
        eng.lengths[slot] = n
        eng.active[slot] = True
        eng.last_token[slot] = int(first[0])
    eng._d_dirty = True
    return eng


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_lag_one_rows_equal_a_synchronous_run(layout):
    """The first pipelined call returns nothing; then each returns the burst
    before; a partial depth flushes first and runs synchronously; the rows,
    concatenated, are a synchronous run's, and the host mirrors end equal."""
    piped = _prefilled(layout)
    sync = _prefilled(layout, params=piped.params)
    sync._burst_depths = ()                 # every burst synchronous
    depths = (8, 8, 4, 4, 3, 8, 2)
    got = []
    for i, n in enumerate(depths):
        rows = piped._decode_burst(n)
        if i == 0:
            assert rows == []
        got += rows
    got += piped._flush_pending()
    want = []
    for n in depths:
        want += sync._decode_burst(n)
    assert len(got) == len(want) == sum(depths)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_array_equal(piped.lengths, sync.lengths)
    np.testing.assert_array_equal(piped.last_token, sync.last_token)
    assert piped.decode_steps == sync.decode_steps == sum(depths)
    # Depths 3 and 2 are not on the ladder: synchronous, each after a
    # flush; the last pipelined burst flushed explicitly.
    assert piped.sync_bursts == 2 and piped.flushes == 2
    assert sync.sync_bursts == len(depths)


def test_tokens_of_released_slots_come_back_masked():
    """A burst in flight across a release (slot 0) and a release plus
    re-admission (slot 1) returns -1 for both slots and only their host
    mirrors stay as the scheduler left them; slot 2's tokens are real."""
    eng = _prefilled("paged")
    assert eng._decode_burst(8) == []
    eng.active[0] = False                       # released
    eng._slot_epoch[0] += 1
    eng._slot_epoch[1] += 1                     # released and re-admitted
    eng.last_token[1] = 7
    rows = eng._flush_pending()
    assert len(rows) == 8
    for r in rows:
        assert r[0] == -1 and r[1] == -1 and r[2] >= 0
    assert eng.last_token[1] == 7 and eng.last_token[2] == rows[-1][2]


# ---------------------------------------------------------------------------
# Greedy streams under churn, against the JAX engine
# ---------------------------------------------------------------------------

TINY = dict(preset="tiny-test", kv_page_size=16, max_batch_size=3,
            max_seq_len=256, prefill_chunk=32, prefill_batch=1,
            dtype="float32", decode_burst=8, decode_burst_busy=4)
RING = dict(TINY, preset="tiny-mistral-test", kv_layout="paged")
# Seven requests through three slots: prompts across pages and chunks, past
# the window's ring, and one whose budget the cache cuts (224 + 40 > 256);
# budgets that end mid-burst, so slots free and refill while a burst is in
# flight. Whole 32-token chunks, one prompt a prefill call: one prefill
# program for the JAX reference to compile (it compiles per shape, and the
# suite's time limit is near).
CHURN = [(np.random.default_rng(40 + i).integers(0, 256, n).tolist(), m)
         for i, (n, m) in enumerate(((32, 3), (64, 17), (96, 9), (32, 25),
                                     (64, 5), (224, 40), (32, 12)))]
# The same churn with the prefix cache on: every prompt opens with one
# 64-token system prompt (four 16-token blocks), so each request admitted
# into a slot freed mid-flight is served 64 tokens from blocks that the
# released request indexed while its last burst was still in flight, and
# prefills from token 64 (still whole 32-token chunks).
SHARED = np.random.default_rng(47).integers(0, 256, 64).tolist()
PREFIX_CHURN = [(SHARED + np.random.default_rng(60 + i).integers(
    0, 256, n - 64).tolist(), m) for i, (n, m) in enumerate(
        ((96, 3), (128, 17), (96, 9), (160, 25), (96, 5), (224, 40),
         (128, 12)))]
# Both layouts, both KV types, the SWA ring and the prefix cache, in three
# jobs: contiguous float32, the paged ring in int8, and the main path's
# default, the paged pool with the prefix cache on (float32, ppb 1). The
# four (layout, KV type) pairs are held to the JAX engine in
# test_torch_engine.py, the lag-one rows to a synchronous run on both
# layouts above. (Contiguous int8 is left out: a quantization tie there
# differs by 1.8e-4 between the frameworks' teacher-forced logits, past the
# model's 1e-4 tolerance, so it cannot be settled when the JAX stream
# varies.)
CHURN_JOBS = [("contiguous-float", {**TINY, "kv_layout": "contiguous"},
               CHURN),
              ("ring-int8", {**RING, "kv_quant": "int8"}, CHURN),
              ("prefix-float", {**TINY, "kv_layout": "paged",
                                "prefix_cache": True}, PREFIX_CHURN)]
# Streams the JAX model has already settled, per job: the fixed-depth and
# the target run of one job give the same greedy streams, so one
# teacher-forced check serves both.
_SETTLED: set = set()

# The JAX engine's streams from ONE fresh process serving every job in turn
# (reference_env: one XLA:CPU thread, no compilation cache), started with
# the module's first test so it overlaps the controller tests; it saves each
# job's params for the port.
_JAX_CHURN = r"""
import asyncio, json, sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
from llmapigateway_tpu.config.schemas import LocalEngineConfig
from llmapigateway_tpu.engine.engine import GenRequest, InferenceEngine

jobs, params_dir = json.loads(sys.argv[1])

async def serve(name, geometry, churn):
    eng = InferenceEngine(LocalEngineConfig(**geometry, attention="reference",
                                            prewarm_sampler_variants=False),
                          devices=[jax.devices("cpu")[0]])
    reqs = [GenRequest(prompt_ids=p, max_tokens=m) for p, m in churn]
    for r in reqs:
        await eng.submit(r)
    for r in reqs:
        async for _ in eng.stream(r):
            pass
    await eng.stop()
    cache = eng._prefix_cache
    if cache is not None:
        cache.check_invariants()
        assert cache.pinned_refs() == 0
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(eng.params)[0]}
    np.savez(f"{params_dir}/{name}.npz", **flat)
    return {"tokens": [r.generated for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "max_tokens": [r.max_tokens for r in reqs],
            "cached": [r.cached_tokens for r in reqs]}

async def run():
    return {name: await serve(name, geometry, churn)
            for name, geometry, churn in jobs}

print(json.dumps(asyncio.run(run())))
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_churn_started(tmp_path_factory):
    params_dir = tmp_path_factory.mktemp("jax_churn")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CHURN,
         json.dumps([CHURN_JOBS, str(params_dir)])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=reference_env())
    yield proc, params_dir
    if proc.poll() is None:         # no test asked for the streams
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_churn(_jax_churn_started):
    proc, params_dir = _jax_churn_started
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1]), params_dir


async def _port_churn(geometry, params, churn):
    eng = InferenceEngine(LocalEngineConfig(**geometry), device="cpu")
    eng.params = params
    reqs = [GenRequest(prompt_ids=list(p), max_tokens=m) for p, m in churn]
    for r in reqs:
        await eng.submit(r)
    for r in reqs:
        async for _ in eng.stream(r):
            pass
    await eng.stop()
    return eng, reqs


@pytest.mark.parametrize("target", [0.0, 40.0], ids=["fixed", "target"])
@pytest.mark.parametrize("job", [j[0] for j in CHURN_JOBS])
async def test_churn_streams_match_jax_engine(job, target, jax_churn):
    """Every request's greedy stream, finish reason and token count equal
    the JAX engine's, whether the depths are fixed or the controller picks
    them; slots are reused mid-flight (flushes and -1 masking exercised),
    no request passes its budget or the cache, and every page comes back.
    With the prefix cache on, each request's ``cached_tokens`` equal the
    JAX engine's (fixed depths: the same schedule), every request admitted
    into a freed slot is served the shared prompt from the cache, and the
    tree, the pool's refcounts and the pins agree afterwards."""
    results, params_dir = jax_churn
    _, geometry, churn = next(j for j in CHURN_JOBS if j[0] == job)
    geometry = dict(geometry, ttft_target_ms=target)
    jparams = load_jax_params(params_dir / f"{job}.npz")
    eng, reqs = await _port_churn(geometry, params_from_jax(jparams), churn)
    expected = results[job]
    tokens = [r.generated for r in reqs]
    key = (job, json.dumps(tokens))
    if tokens != expected["tokens"] and key not in _SETTLED:
        # The JAX model adjudicates.
        await asyncio.to_thread(assert_jax_model_greedy, jparams, geometry,
                                [p for p, _ in churn], tokens)
        _SETTLED.add(key)
    elif tokens == expected["tokens"]:
        assert [r.finish_reason for r in reqs] == expected["finish"]
    assert [r.max_tokens for r in reqs] == expected["max_tokens"]
    for r in reqs:
        assert len(r.generated) <= r.max_tokens
        assert len(r.prompt_ids) + len(r.generated) <= eng.S
        if r.generated[-1] in eng.tokenizer.eos_ids:
            assert r.finish_reason == "stop"
        else:
            assert r.finish_reason == "length" and (
                len(r.generated) == r.max_tokens
                or len(r.prompt_ids) + len(r.generated) + 1 >= eng.S)
    # The cache cut the long prompt's budget, at submit, in both engines.
    assert reqs[5].max_tokens == eng.S - len(churn[5][0])
    st = eng.stats()
    assert st["flushes"] > 0 and st["decode_steps"] > 0
    assert st["graphs_captured"] == 0 == st["graph_replays"]   # the CPU
    if target:
        assert st["burst_depth_hist"] and "burst_walls_ms" in st
    cache = eng._prefix_cache
    if cache is not None:
        cached = [r.cached_tokens for r in reqs]
        if not target and [len(t) for t in tokens] == [
                len(t) for t in expected["tokens"]]:
            assert cached == expected["cached"]
        assert cached[0] == 0 and set(cached[:3]) <= {0, len(SHARED)}
        assert cached[3:] == [len(SHARED)] * 4
        assert st["prefix_cached_tokens_total"] == sum(cached)
        assert st["prefix_hits_total"] == sum(c > 0 for c in cached)
        cache.check_invariants()                # the pool's refcounts too
        assert cache.pinned_refs() == 0
        assert (eng.allocator.free_pages + st["prefix_resident_pages"]
                == st["total_pages"])
    elif eng.allocator is not None:
        eng.allocator.check_invariants()
        assert eng.allocator.free_pages == eng.allocator.num_pages - 1
        if job.startswith("ring"):
            assert 0 < eng._swa_ring_pages < eng.allocator.pages_per_slot


async def test_a_slot_freed_mid_flight_feeds_its_next_request_nothing(
        jax_churn):
    """A request cancelled while the burst behind it is in flight frees its
    slot mid-flight; the next queued request is admitted into that slot
    (served its shared prompt from the cache the cancelled request just
    indexed) before the burst is fetched. The burst's tokens for the slot
    come back masked, and the new request's stream is the JAX model's
    greedy continuation of its own prompt: none of the cancelled request's
    tokens reach it."""
    _, params_dir = jax_churn
    _, geometry, churn = next(j for j in CHURN_JOBS if j[0] == "prefix-float")
    jparams = load_jax_params(params_dir / "prefix-float.npz")
    eng = InferenceEngine(LocalEngineConfig(**geometry), device="cpu")
    eng.params = params_from_jax(jparams)
    masked_live = []
    flush_entry = eng._flush_entry

    def spy(entry):
        if entry is not None:
            _, _, active_snap, epoch_snap = entry
            masked_live.extend(np.flatnonzero(
                active_snap & (epoch_snap != eng._slot_epoch)).tolist())
        return flush_entry(entry)

    eng._flush_entry = spy
    decode_burst = eng._decode_burst
    cancelled = GenRequest(prompt_ids=list(churn[1][0]), max_tokens=100)

    def cancel_with_a_burst_in_flight(n):
        rows = decode_burst(n)
        if (len(cancelled.generated) >= 2 and eng._pending is not None
                and not cancelled.cancelled):
            # The client goes: the emission of these rows frees the slot
            # while the burst just dispatched still holds it.
            cancelled.cancelled = True
        return rows

    eng._decode_burst = cancel_with_a_burst_in_flight
    others = [GenRequest(prompt_ids=list(p), max_tokens=m) for p, m in
              ((churn[3][0], 30), (churn[6][0], 30), (churn[0][0], 12),
               (churn[2][0], 9))]
    for r in (cancelled, *others):
        await eng.submit(r)
    for r in others:        # a cancelled request's stream just stops
        async for _ in eng.stream(r):
            pass
    await eng.stop()
    slot = cancelled.slot
    nxt = others[2]
    assert cancelled.finish_reason == "cancelled"
    assert nxt.slot == slot and slot in masked_live
    assert nxt.cached_tokens == len(SHARED)
    await asyncio.to_thread(assert_jax_model_greedy, jparams, geometry,
                            [nxt.prompt_ids], [nxt.generated])
    assert len(nxt.generated) == nxt.max_tokens
    eng._prefix_cache.check_invariants()
    assert eng._prefix_cache.pinned_refs() == 0


# ---------------------------------------------------------------------------
# The graph runner's launch accounting, and the sampled draw
# ---------------------------------------------------------------------------

class StubGraph:
    """``CudaGraph``'s interface without a card: capture runs ``fn`` once
    (its launches count on the host, as under a real capture), replay runs
    nothing (as a real replay runs no Python)."""

    def __init__(self, pool=None, generator=None):
        self.pool = pool or object()
        self.generator = generator
        self.replays = 0

    def capture(self, fn):
        return fn()

    def replay(self):
        self.replays += 1


def test_replays_count_the_launches_their_capture_saw():
    """A capture's own launches are taken back out; every replay adds them
    (per wrapper and per body, with the split record), so launch checks
    read replays as launches; the sampled graph gets the generator."""
    fns = (paged_decode_attention, flash_decode_attention)
    L, B = 3, 2
    body = body_name(0, 1, False, 128, 4)
    split = {"n_split": 4, "split_keys": 256, "workspace_bytes": 1024}

    def decode_body(n, greedy):
        for _ in range(n * L):
            count_launch(paged_decode_attention, body, split)
        return torch.full((n, B), 5 if greedy else 6)

    before = decode_graphs.launch_counts(fns)
    gen = torch.Generator().manual_seed(0)
    graphs = decode_graphs.DecodeGraphs(gen, graph_cls=StubGraph, counted=fns)
    graphs.capture(decode_body, 8, True, warm=False)
    graphs.capture(decode_body, 4, False, warm=False)
    assert decode_graphs.launch_counts(fns) == before
    assert (8, True) in graphs and (4, False) in graphs
    assert graphs.graphs[(8, True)][0].generator is None
    assert graphs.graphs[(4, False)][0].generator is gen
    assert graphs.graphs[(4, False)][0].pool is graphs.graphs[(8, True)][0].pool
    out = [graphs.replay(8, True), graphs.replay(8, True),
           graphs.replay(4, False)]
    assert [int(o[0, 0]) for o in out] == [5, 5, 6]
    assert graphs.replays == 3
    n0, bodies0, _ = before["paged_decode_attention"]
    assert paged_decode_attention.launches == n0 + (8 + 8 + 4) * L
    assert paged_decode_attention.body_launches[body] == (
        bodies0.get(body, 0) + (8 + 8 + 4) * L)
    assert paged_decode_attention.body_splits[body] == split
    assert flash_decode_attention.launches == before[
        "flash_decode_attention"][0]
    decode_graphs.restore_counts(before, fns)


def test_an_engine_with_graphs_is_freed_without_the_collector():
    """The graphs refer to nothing of their engine, so the engine (its
    weights and KV cache, on the card tens of GB) goes with its last
    reference, not at some later garbage collection: a run that builds
    engines one after another never holds two."""
    import gc
    import weakref
    gc.disable()
    try:
        eng = InferenceEngine(LocalEngineConfig(**PIPE, kv_layout="paged"),
                              device="cpu")
        eng._graphs = decode_graphs.DecodeGraphs(eng._rng,
                                                 graph_cls=StubGraph)
        eng._graphs.capture(eng._decode_body, 8, True, warm=False)
        assert (8, True) in eng._graphs
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_draw_follows_its_distribution():
    """The exponential race draws each token with its probability, never
    one of probability 0, and from one generator state draws exactly what
    ``torch.multinomial`` draws."""
    p = torch.tensor([0.4, 0.25, 0.15, 0.1, 0.06, 0.04, 0.0, 0.0])
    n = 40000
    gen = torch.Generator().manual_seed(11)
    draws = draw_tokens(p.expand(n, -1).contiguous(), gen)
    freq = torch.bincount(draws, minlength=8).double() / n
    sd = torch.sqrt(p.double() * (1 - p.double()) / n)
    assert bool((freq - p.double()).abs().le(5 * sd + 1e-12).all()), freq
    assert freq[6] == 0 and freq[7] == 0
    probs = torch.softmax(torch.randn(5, 300, generator=gen), -1)
    state = gen.get_state()
    want = torch.multinomial(probs, 1, generator=gen)[:, 0]
    gen.set_state(state)
    assert torch.equal(draw_tokens(probs, gen), want)
