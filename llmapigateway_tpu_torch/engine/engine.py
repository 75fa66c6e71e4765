"""The serving engine: slot-based continuous batching over the KV cache,
in PyTorch (counterpart of the JAX package's ``engine/engine.py``).

* **Two KV layouts** (``kv_layout``): ``paged`` — a global page pool with a
  page table per slot (ops/paged_attention.py) — and ``contiguous`` — a
  dense ``[L, B, KV, S, Dh]`` cache, one row per slot (models/llama.py
  ``KVCache``, ops/flash_attention.py). Either holds bf16 K/V, or int8 K/V
  with per-token fp32 scales (``kv_quant: "int8"``).
* **Fixed slots.** Decode runs the full slot batch ``[B]`` every step;
  inactive slots ride along masked (``active``): they attend only their self
  column and their K/V writes land on trash page 0 (paged) or on their own
  row's tail (contiguous), where nothing reads them before they are
  rewritten.
* **Chunked, batched prefill.** Each scheduler step advances every pending
  prompt by ONE chunk of at most ``prefill_chunk`` tokens, up to
  ``prefill_batch`` prompts in one forward call (rows padded to the
  longest chunk of the group; pad positions lie past each prompt and are
  overwritten before any read; in the contiguous layout pad positions past
  the cache extent are dropped). The first token is sampled inside the
  prefill call, from the last real position of each row. A call one token
  wide runs the decode path by the forward's protocol (stale pool plus
  self column, then the insert), which is the same attention.
* **Decode bursts.** A burst of decode steps runs back to back on the
  device; the sampled tokens come to the host once per burst. Bursts are
  shallow (``decode_burst_busy``) while prefill work waits, deep
  (``decode_burst``) otherwise.
* **Deferred-insert decode.** Decode attention reads the STALE pool plus a
  self column, and every layer's new K/V is inserted once per step after
  the layer loop (models/llama.py ``forward_hidden``).
* **The engine is an async service.** Model compute runs in a worker thread
  (``asyncio.to_thread``) so the gateway's event loop keeps serving;
  results stream back through per-request asyncio queues. Scheduler state
  is touched only on the event-loop thread.
* **Admission reserves pages** for a request's whole lifetime
  (engine/paged.py): pool exhaustion is backpressure at admission, never a
  mid-generation failure. The contiguous layout owns a whole row per slot,
  so a free slot is enough.
* **Sliding-window models** (mistral family) run the window variants of the
  kernels on either layout. On the paged layout a slot holds a RING of
  O(window) pages when that is smaller than its whole context: before each
  prefill chunk and each decode burst, on the event-loop thread, the slot's
  pages wholly below the window are recycled onto the logical pages the
  dispatch will write (``_swa_map_chunks``, ``_swa_rotate``).
* **Multi-page blocks** (``kv_pages_per_block``): the allocator packs each
  slot's pages in aligned superpage runs and the paged kernels read one
  table entry per run, when the geometry allows it (the resolved run length
  is ``kv_ppb``; the SWA ring and non-divisible geometry fall back to 1, as
  in the JAX engine).

Entry points run on ``cuda`` unless the caller asks for the CPU; asking
for ``cuda`` where there is none raises instead of running on the CPU.
Knobs of the JAX engine that are not ported yet are refused at build with
the ROADMAP item that will bring them.
"""
from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import AsyncIterator

import numpy as np
import torch

from ..config.schemas import LocalEngineConfig, SupervisorConfig, not_ported
from ..models import forward_fn, init_fn
from ..models.config import ModelConfig, get_preset
from ..models.llama import KVCache, forward_hidden, head_logits
from ..ops import _kernels
from ..ops.flash_attention import make_cache_attention_fn
from ..ops.paged_attention import PagedKVCache, make_paged_attention_fn
from .paged import PageAllocator
from .sampling import SamplingParams, sample
from .tokenizer import IncrementalDetokenizer, load_tokenizer

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class EngineOverloaded(Exception):
    """Admission failed (queue full, prompt too long) — maps to a provider
    error so the gateway falls back to the next provider in the chain."""


class EngineUnavailable(Exception):
    """Admission refused because the engine is stopping."""


@dataclass
class GenRequest:
    """One sequence's lifecycle inside the engine."""
    prompt_ids: list[int]
    max_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    stop: list[str] = field(default_factory=list)

    # Filled by the engine:
    slot: int = -1
    prefill_pos: int = 0
    generated: list[int] = field(default_factory=list)
    out_queue: asyncio.Queue = field(default_factory=asyncio.Queue)
    detok: IncrementalDetokenizer | None = None
    text: str = ""
    emitted_upto: int = 0          # index into `text` already sent downstream
    cancelled: bool = False        # client gone — stop generating, free slot
    finish_reason: str | None = None
    t_submit: float = field(default_factory=time.monotonic)
    t_first_token: float | None = None
    t_done: float | None = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


@dataclass
class Delta:
    """One streamed event: text delta and/or terminal state."""
    text: str = ""
    finish_reason: str | None = None
    error: str | None = None


def resolve_device(device: str | torch.device) -> torch.device:
    """The engine's device. ``cuda`` without a usable card is an error —
    the engine never carries on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' "
            "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def _refuse_unported(cfg: LocalEngineConfig, model_cfg: ModelConfig) -> None:
    """Reject every knob whose JAX feature the port does not have yet, so a
    providers.json never silently means something else here."""
    if cfg.kv_layout not in ("paged", "contiguous"):
        raise ValueError(f"unknown kv_layout {cfg.kv_layout!r}; expected "
                         f"'paged' | 'contiguous'")
    if cfg.kv_quant not in ("", "int8"):
        raise ValueError(f"unknown kv_quant {cfg.kv_quant!r}; expected "
                         f"'' | 'int8'")
    # The prefix cache exists only over the page pool, and there only for
    # models without a sliding window: the JAX engine treats the knob as
    # inert under the contiguous layout and for sliding-window models
    # (engine.py:720-722 sits in its paged branch and requires
    # `not c.sliding_window`), so the port refuses it only where it would
    # mean something. Otherwise a contiguous or mistral providers.json with
    # the default prefix_cache=true would be served by the JAX package and
    # refused here.
    if (cfg.kv_layout == "paged" and cfg.prefix_cache
            and not model_cfg.sliding_window):
        raise not_ported("prefix_cache=true", "prefix cache")
    if cfg.spec_draft_len:
        raise not_ported("spec_draft_len", "speculative decoding")
    if cfg.quant:
        raise not_ported(f"quant={cfg.quant!r}", "weight quantization")
    if model_cfg.is_moe:
        raise not_ported("an MoE model", "MoE")
    if any(size != 1 for size in cfg.mesh.values()):
        raise not_ported(f"mesh={cfg.mesh}", "parallelism")
    if cfg.disaggregation.enabled:
        raise not_ported("disaggregation", "disaggregation")
    if cfg.ttft_target_ms > 0:
        raise not_ported("ttft_target_ms", "compiled, pipelined decode step")
    if cfg.supervisor != SupervisorConfig():
        raise not_ported("supervisor", "disaggregation, supervision, "
                                        "observability")
    if cfg.attention not in ("auto", "pallas"):
        raise ValueError(
            f"attention={cfg.attention!r}: the PyTorch engine always runs "
            f"its attention kernels on the card (their plain versions on "
            f"CPU tensors); use 'auto'")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}")


def _refuse_unbuilt_geometry(cfg: LocalEngineConfig, model_cfg: ModelConfig,
                             device: str | torch.device) -> None:
    """On the card every attention call is a kernel, and the kernels are
    compiled for some head widths and group sizes only: refuse any other at
    build, before anything touches the device, rather than at the first
    request. The CPU runs the plain versions, which take any geometry."""
    if torch.device(device).type != "cuda":
        return
    why = _kernels.unsupported_geometry(model_cfg.head_dim, model_cfg.n_heads,
                                        model_cfg.n_kv_heads)
    if why is not None:
        raise ValueError(f"preset {cfg.preset!r} cannot run on the card: "
                         f"{why}")


class InferenceEngine:
    """Owns params, the KV cache, and the batching loop."""

    def __init__(self, engine_cfg: LocalEngineConfig,
                 device: str | torch.device = "cuda"):
        self.cfg = engine_cfg
        if engine_cfg.model_path:
            raise not_ported("model_path (checkpoint loading)", "checkpoints")
        if not engine_cfg.preset:
            raise ValueError("local engine needs 'preset'")
        model_cfg = get_preset(engine_cfg.preset)
        _refuse_unported(engine_cfg, model_cfg)
        _refuse_unbuilt_geometry(engine_cfg, model_cfg, device)
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[engine_cfg.dtype]
        self.paged = engine_cfg.kv_layout == "paged"
        self.kv_quant = engine_cfg.kv_quant

        self.B = engine_cfg.max_batch_size
        self.S = min(engine_cfg.max_seq_len, model_cfg.max_seq_len)
        self.prefill_chunk = engine_cfg.prefill_chunk
        self.prefill_batch = max(1, min(engine_cfg.prefill_batch, self.B))
        self.decode_burst = max(1, engine_cfg.decode_burst)
        self.decode_burst_busy = max(1, min(engine_cfg.decode_burst_busy,
                                            self.decode_burst))
        # A page larger than S would waste a whole-page tail per slot.
        self.kv_page = max(1, min(engine_cfg.kv_page_size, self.S))
        self.tokenizer = load_tokenizer(engine_cfg.tokenizer_path or None,
                                        vocab_size=model_cfg.vocab_size)

        t0 = time.monotonic()
        self._forward = forward_fn(model_cfg)
        # Random weights from a fixed seed (the repo ships no checkpoint).
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.params = init_fn(model_cfg)(model_cfg, gen, dtype=self.dtype,
                                         device=self.device)
        self._init_state()
        logger.info("engine build on %s: %.1fs", self.device,
                    time.monotonic() - t0)

        # Scheduler state: event-loop thread only.
        self._queue: asyncio.Queue[GenRequest] = asyncio.Queue(
            maxsize=max(2 * self.B, 16))
        self._head: GenRequest | None = None
        self._free_slots: list[int] = list(range(self.B - 1, -1, -1))
        self._running: dict[int, GenRequest] = {}
        self._prefilling: dict[int, GenRequest] = {}
        self._loop_task: asyncio.Task | None = None
        self._stopped = False
        self._work_event = asyncio.Event()
        self._loop = None
        # Work counters (worker thread): forward calls of each kind. A
        # prefill call one token wide runs the decode attention path, so it
        # is counted apart as well.
        self.prefill_calls = 0
        self.prefill_one_token_calls = 0
        self.decode_steps = 0

    # -- initialization ------------------------------------------------------
    def _init_state(self) -> None:
        c = self.model_cfg
        self.allocator: PageAllocator | None = None
        self.kv_ppb = 1                 # multi-page kernel blocking (paged)
        self._swa_ring_pages = 0        # pages a ring slot holds (0: no ring)
        self._swa_margin = 0            # in-flight burst margin, tokens
        if self.paged:
            page = self.kv_page
            per_slot = (self.S + page - 1) // page
            # Sliding-window RING reservation: the windowed kernels never
            # read below pos - window, so a ring of O(window) physical pages
            # serves any context length (ensure_mapped recycles each slot's
            # oldest dead page onto the next logical page). The JAX engine's
            # sizing, margin included: decode_burst * (spec_k + 1) covers a
            # lag-one burst still in flight there; the port has none (and no
            # speculation), but keeps the formula so ring size and admission
            # match the JAX engine's.
            if c.sliding_window:
                self._swa_margin = self.decode_burst * (
                    self.cfg.spec_draft_len + 1)
                span = max(self.prefill_chunk, self._swa_margin)
                ring = -(-(c.sliding_window + self._swa_margin + span)
                         // page) + 2
                if ring < per_slot:
                    self._swa_ring_pages = ring
                    logger.info(
                        "paged SWA ring: %d pages/slot (window %d) instead "
                        "of %d — steady-state KV footprint is O(window)",
                        ring, c.sliding_window, per_slot)
            # Multi-page kernel blocking: the requested run length against
            # what the pool can pack — the allocator's superpage runs are
            # what license the kernels' one lookup per run, so a geometry
            # the allocator cannot pack falls back to per-page blocks
            # instead of serving wrong reads.
            ppb_req = max(1, self.cfg.kv_pages_per_block)
            if ppb_req > 1:
                why = None
                if self._swa_ring_pages:
                    why = "SWA page ring (mappings rotate per page)"
                elif per_slot % ppb_req:
                    why = (f"pages per slot ({per_slot}) not divisible "
                           f"by {ppb_req}")
                elif (self.cfg.kv_num_pages
                      and self.cfg.kv_num_pages % ppb_req):
                    why = (f"kv_num_pages ({self.cfg.kv_num_pages}) not "
                           f"divisible by {ppb_req}")
                if why is None:
                    self.kv_ppb = ppb_req
                else:
                    logger.warning(
                        "kv_pages_per_block=%d falls back to per-page "
                        "blocks: %s", ppb_req, why)
            # A packed pool reserves the whole trash superpage.
            n_trash = self.kv_ppb
            num_pages = self.cfg.kv_num_pages or (
                self.B * per_slot + n_trash)
            min_hold = self._swa_ring_pages or per_slot
            if num_pages - n_trash < min_hold:
                raise ValueError(
                    f"kv_num_pages={num_pages} cannot hold one "
                    f"max-footprint sequence ({min_hold} pages of {page})")
            self.allocator = PageAllocator(num_pages, page, self.B, self.S,
                                           pages_per_block=self.kv_ppb)
            self.cache = PagedKVCache.create(c, num_pages, page, self.dtype,
                                             kv_quant=self.kv_quant,
                                             device=self.device)
        else:
            # One [S] row per slot and layer: int8 values plus
            # [L, B, KV, 1, S] fp32 scales under kv_quant (JAX
            # engine.py:750-770).
            self.cache = KVCache.create(c, self.B, self.S, self.dtype,
                                        kv_quant=self.kv_quant,
                                        device=self.device)
        self._d_table: torch.Tensor | None = None
        self._table_dirty = True
        # Host-authoritative per-slot state, mirrored to the device when it
        # changes (admission, release, prefill completion).
        self.lengths = np.zeros((self.B,), np.int32)
        self.active = np.zeros((self.B,), bool)
        self.last_token = np.zeros((self.B,), np.int64)
        self.samp_temperature = np.zeros((self.B,), np.float32)
        self.samp_top_p = np.ones((self.B,), np.float32)
        self.samp_top_k = np.zeros((self.B,), np.int32)
        self.samp_presence = np.zeros((self.B,), np.float32)
        self.samp_frequency = np.zeros((self.B,), np.float32)
        # Token-occurrence counts for presence/frequency penalties, [B, V]
        # on the device: prefill resets a slot's row and counts the prompt;
        # the general decode path counts each step's INPUT token.
        self._d_counts = torch.zeros((self.B, c.vocab_size), dtype=torch.int32,
                                     device=self.device)
        self._rng = torch.Generator(device=self.device).manual_seed(
            int(time.time() * 1e3) % (2 ** 31))
        self._d_dirty = True

    def _device_table(self) -> torch.Tensor:
        if self._table_dirty or self._d_table is None:
            self._d_table = torch.from_numpy(self.allocator.table).to(
                self.device)
            self._table_dirty = False
        return self._d_table

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- public API ----------------------------------------------------------
    async def start(self) -> None:
        if self._loop_task is None:
            self._stopped = False
            loop = asyncio.get_running_loop()
            if self._loop is not loop:
                # asyncio.Event binds to the first loop that awaits it.
                self._work_event = asyncio.Event()
                self._loop = loop
            self._loop_task = loop.create_task(self._run_loop())

    async def stop(self) -> None:
        self._stopped = True
        self._work_event.set()
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None
        # Terminal deltas so no consumer awaits a stream forever.
        for req in list(self._running.values()):
            req.out_queue.put_nowait(Delta(error="engine stopped"))
            self._release(req)
        if self._head is not None:
            self._head.out_queue.put_nowait(Delta(error="engine stopped"))
            self._head = None
        while not self._queue.empty():
            self._queue.get_nowait().out_queue.put_nowait(
                Delta(error="engine stopped"))

    async def submit(self, req: GenRequest) -> None:
        """Admit a request; raises EngineOverloaded when the queue is full
        or the prompt cannot fit."""
        if self._stopped and self._loop_task is not None:
            raise EngineUnavailable("engine is stopping")
        if len(req.prompt_ids) > self.S - 1:
            raise EngineOverloaded(
                f"prompt of {len(req.prompt_ids)} tokens exceeds engine "
                f"max_seq_len {self.S}")
        req.max_tokens = max(1, min(req.max_tokens,
                                    self.S - len(req.prompt_ids)))
        req.detok = IncrementalDetokenizer(self.tokenizer)
        try:
            self._queue.put_nowait(req)
        except asyncio.QueueFull:
            raise EngineOverloaded("engine admission queue is full") from None
        await self.start()
        self._work_event.set()

    async def stream(self, req: GenRequest) -> AsyncIterator[Delta]:
        """Yield deltas for a submitted request until it finishes."""
        while True:
            delta: Delta = await req.out_queue.get()
            yield delta
            if delta.finish_reason is not None or delta.error is not None:
                return

    # -- the batching loop ---------------------------------------------------
    async def _run_loop(self) -> None:
        logger.info("engine loop started (B=%d, S=%d, device=%s)",
                    self.B, self.S, self.device)
        while not self._stopped:
            # Clear BEFORE stepping: a submit() landing during the step's
            # awaits sets the event and must not be wiped afterwards.
            self._work_event.clear()
            try:
                progressed = await self._step()
            except Exception as e:           # the loop must never die silently
                logger.exception("engine step failed")
                self._fail_running(f"engine step failed: {e}")
                progressed = True
            if not progressed:
                await self._work_event.wait()

    def _fail_running(self, msg: str) -> None:
        for req in list(self._running.values()):
            req.out_queue.put_nowait(Delta(error=msg))
            self._release(req)

    async def _step(self) -> bool:
        """One scheduler iteration: admit, advance prefills by one chunk,
        run one decode burst, emit. Emission happens here, on the event-loop
        thread (asyncio.Queue is not thread-safe)."""
        # 1. Admit into free slots while the FIFO head's full page
        #    reservation fits (it waits at the head otherwise).
        while self._free_slots:
            if self._head is None:
                if self._queue.empty():
                    break
                self._head = self._queue.get_nowait()
            req = self._head
            if req.cancelled:
                req.finish_reason = "cancelled"
                self._head = None
                continue
            total = min(len(req.prompt_ids) + req.max_tokens, self.S)
            if self.allocator is not None:
                if not self.allocator.can_admit(
                        total, ring_pages=self._swa_ring_pages):
                    break
            self._head = None
            req.slot = self._free_slots.pop()
            if self.allocator is not None:
                self.allocator.allocate(req.slot, total,
                                        ring_pages=self._swa_ring_pages)
                self._table_dirty = True
            req.prefill_pos = 0
            self._running[req.slot] = req
            self._prefilling[req.slot] = req

        # 2. Advance each pending prefill by ONE chunk, grouped.
        eligible = []
        for req in list(self._prefilling.values()):
            if req.cancelled:
                self._finish(req, "cancelled", emit=False)
            else:
                eligible.append(req)
        for i in range(0, len(eligible), self.prefill_batch):
            batch = [r for r in eligible[i:i + self.prefill_batch]
                     if not r.cancelled]
            if not batch:
                continue
            if self._swa_ring_pages:
                self._swa_map_chunks(batch)
            dones = await asyncio.to_thread(self._prefill_chunk_group, batch)
            for req, prompt_done in zip(batch, dones):
                if prompt_done:
                    del self._prefilling[req.slot]
                    self._emit_token(req)  # first token, sampled off prefill

        # 3. A decode burst for every slot in decode phase.
        decoding = [r for r in self._running.values()
                    if not r.done and r.slot not in self._prefilling]
        if decoding:
            busy = (self._head is not None or not self._queue.empty()
                    or bool(self._prefilling))
            burst = self.decode_burst_busy if busy else self.decode_burst
            # Never burst past any slot's cache capacity or token budget.
            for r in decoding:
                ub = int(self.lengths[r.slot])
                dispatched = ub - len(r.prompt_ids) + 1
                burst = min(burst, self.S - ub,
                            max(1, r.max_tokens - dispatched))
            burst = max(1, burst)
            if self._swa_ring_pages:
                self._swa_rotate(decoding, burst)
            step_tokens = await asyncio.to_thread(self._decode_burst, burst)
            for tokens in step_tokens:          # in generation order
                for req in decoding:
                    if req.done:
                        continue
                    req.generated.append(int(tokens[req.slot]))
                    self._emit_token(req)
        progressed = bool(decoding) or bool(self._prefilling)
        if not progressed and self._free_slots and (
                self._head is not None or not self._queue.empty()):
            progressed = True   # slots freed this step while admissions wait
        return progressed

    # -- the sliding-window ring (event-loop thread, before dispatch) ---------
    def _swa_map_chunks(self, reqs: list[GenRequest]) -> None:
        """Map the pages each request's next prompt chunk writes by
        recycling pages wholly below the chunk's window floor (no in-flight
        margin: a prefilling slot has no decode burst of its own in flight,
        and other slots' bursts touch only their own table rows)."""
        page = self.allocator.page_size
        for req in reqs:
            pos = req.prefill_pos
            n = min(self.prefill_chunk, len(req.prompt_ids) - pos)
            dead = max(0, pos - self.model_cfg.sliding_window + 1) // page
            if self.allocator.ensure_mapped(req.slot, (pos + n - 1) // page,
                                            dead):
                self._table_dirty = True

    def _swa_rotate(self, decoding: list[GenRequest], advance: int) -> None:
        """Before a decode burst, map the logical pages it will write (from
        each slot's length through ``advance`` more positions) by recycling
        pages wholly below the window floor less the burst margin. The
        JAX engine adds its in-flight lag-one burst to the position; the
        port runs none, so the dispatch-true length is the position."""
        page = self.allocator.page_size
        w = self.model_cfg.sliding_window
        changed = False
        for r in decoding:
            pos = int(self.lengths[r.slot])
            dead = max(0, pos - self._swa_margin - w + 1) // page
            changed |= self.allocator.ensure_mapped(
                r.slot, (pos + advance) // page, dead)
        if changed:
            self._table_dirty = True

    # -- compute (worker thread; no asyncio objects touched) ------------------
    def _prefill_chunk_group(self, reqs: list[GenRequest]) -> list[bool]:
        """Advance each request by one prompt chunk in ONE forward call.
        Returns per-request prompt-complete flags."""
        slots, poss, chunks, samps = [], [], [], []
        for req in reqs:
            pos = req.prefill_pos
            if pos == 0:
                self.lengths[req.slot] = 0
                self.active[req.slot] = False
            slots.append(req.slot)
            poss.append(pos)
            chunks.append(req.prompt_ids[pos:pos + self.prefill_chunk])
            samps.append((req.temperature, req.top_p, req.top_k,
                          req.presence_penalty, req.frequency_penalty))
        first = self._exec_prefill(slots, poss, chunks, samps)
        done: list[bool] = []
        first_np: np.ndarray | None = None
        for i, req in enumerate(reqs):
            req.prefill_pos = poss[i] + len(chunks[i])
            if req.prefill_pos < len(req.prompt_ids):
                done.append(False)
                continue
            if first_np is None:
                first_np = first.cpu().numpy()
            first_id = int(first_np[i])
            req.generated.append(first_id)
            req.t_first_token = time.monotonic()
            s = req.slot
            self.lengths[s] = len(req.prompt_ids)
            self.last_token[s] = first_id
            self.active[s] = True
            self.samp_temperature[s] = req.temperature
            self.samp_top_p[s] = req.top_p
            self.samp_top_k[s] = req.top_k
            self.samp_presence[s] = req.presence_penalty
            self.samp_frequency[s] = req.frequency_penalty
            self._d_dirty = True
            done.append(True)
        return done

    @torch.no_grad()
    def _exec_prefill(self, slots, poss, chunks, samps) -> torch.Tensor:
        """The one prefill forward: K rows of prompt chunks (padded to the
        longest), each routed to its slot's page-table row (paged) or cache
        row (contiguous, read and written in place); samples each row's
        first token from its last real position. Returns [K]."""
        K = len(slots)
        width = max(len(ch) for ch in chunks)
        padded = np.zeros((K, width), np.int64)
        for i, ch in enumerate(chunks):
            padded[i, :len(ch)] = ch
        tokens = self._to_device(padded)
        start = self._to_device(np.asarray(poss, np.int32))
        slot_idx = self._to_device(np.asarray(slots, np.int64))
        last_idx = self._to_device(
            np.asarray([len(ch) - 1 for ch in chunks], np.int64))
        window = self.model_cfg.sliding_window
        if self.paged:
            attn = make_paged_attention_fn(self._device_table()[slot_idx],
                                           window, self.kv_ppb)
        else:
            attn = make_cache_attention_fn(slot_idx.int(), window)
        hidden, self.cache = forward_hidden(
            self.params, self.model_cfg, tokens, start, self.cache,
            attention_fn=attn)
        rows = hidden[torch.arange(K, device=self.device), last_idx]
        logits = head_logits(self.params, self.model_cfg, rows)   # [K, V]

        # Penalty counts: reset rows at prompt start, count the chunk's
        # real tokens (pads masked).
        counts = self._d_counts[slot_idx]
        counts[start == 0] = 0
        real = (torch.arange(width, device=self.device)[None, :]
                <= last_idx[:, None]).int()
        counts.scatter_add_(1, tokens, real)
        self._d_counts[slot_idx] = counts
        samp = SamplingParams(
            temperature=self._to_device(np.asarray([s[0] for s in samps],
                                                   np.float32)),
            top_p=self._to_device(np.asarray([s[1] for s in samps],
                                             np.float32)),
            top_k=self._to_device(np.asarray([s[2] for s in samps], np.int32)),
            presence_penalty=self._to_device(
                np.asarray([s[3] for s in samps], np.float32)),
            frequency_penalty=self._to_device(
                np.asarray([s[4] for s in samps], np.float32)))
        self.prefill_calls += 1
        self.prefill_one_token_calls += width == 1
        return sample(logits, samp, self._rng, counts=counts)

    def _all_greedy(self) -> bool:
        """True when every ACTIVE slot is plain-greedy: temperature 0 and
        zero penalties — the condition for the argmax-only decode path."""
        a = self.active
        return not bool(np.any(self.samp_temperature[a] > 0)
                        or np.any(self.samp_presence[a] != 0)
                        or np.any(self.samp_frequency[a] != 0))

    @torch.no_grad()
    def _decode_burst(self, n_steps: int) -> list[np.ndarray]:
        """Run ``n_steps`` decode steps back to back on the device, tokens
        and lengths feeding forward as device tensors; one host fetch at
        the end. Returns the per-step [B] token arrays in order."""
        if self._d_dirty:
            self._d_tokens = self._to_device(self.last_token)
            self._d_lengths = self._to_device(self.lengths)
            self._d_active = self._to_device(self.active)
            self._d_samp = SamplingParams(
                temperature=self._to_device(self.samp_temperature),
                top_p=self._to_device(self.samp_top_p),
                top_k=self._to_device(self.samp_top_k),
                presence_penalty=self._to_device(self.samp_presence),
                frequency_penalty=self._to_device(self.samp_frequency))
            self._d_dirty = False
        greedy = self._all_greedy()
        window = self.model_cfg.sliding_window
        attn = (make_paged_attention_fn(self._device_table(), window,
                                        self.kv_ppb) if self.paged
                else make_cache_attention_fn(window=window))
        tokens, lengths, active = self._d_tokens, self._d_lengths, \
            self._d_active
        out = []
        for _ in range(n_steps):
            if not greedy:
                self._d_counts[torch.arange(self.B, device=self.device),
                               tokens] += active.int()
            logits, self.cache = self._forward(
                self.params, self.model_cfg, tokens[:, None], lengths,
                self.cache, attention_fn=attn, active=active)
            if greedy:
                tokens = torch.argmax(logits[:, 0, :], dim=-1)
            else:
                tokens = sample(logits[:, 0, :], self._d_samp, self._rng,
                                counts=self._d_counts)
            lengths = torch.where(active, lengths + 1, lengths)
            out.append(tokens)
            self.decode_steps += 1
        self._d_tokens, self._d_lengths = tokens, lengths
        host = torch.stack(out).cpu().numpy()
        # Mirror the device-side advance on the host.
        self.last_token[self.active] = host[-1][self.active]
        self.lengths[self.active] += n_steps
        return [host[i] for i in range(n_steps)]

    # -- emission / lifecycle (event-loop thread only) ------------------------
    def _emit_token(self, req: GenRequest) -> None:
        if req.cancelled:
            self._finish(req, "cancelled", emit=False)
            return
        tok = req.generated[-1]
        if tok in self.tokenizer.eos_ids:
            self._finish(req, "stop")
            return
        req.text += req.detok.push(tok)

        # OpenAI `stop` semantics: the stop sequence (and anything after it)
        # is excluded from the output. Text that could still be a stop
        # prefix is HELD BACK until resolved.
        if req.stop:
            idx = -1
            for s in req.stop:
                found = req.text.find(s, req.emitted_upto)
                if found >= 0 and (idx < 0 or found < idx):
                    idx = found
            if idx >= 0:
                req.text = req.text[:idx]
                self._finish(req, "stop", flush_detok=False)
                return

        if len(req.generated) >= req.max_tokens:
            self._finish(req, "length")
            return
        # Exact per-token cache-capacity check.
        if len(req.prompt_ids) + len(req.generated) + 1 >= self.S:
            self._finish(req, "length")
            return

        # Emit everything except the longest tail that is a proper prefix of
        # some stop string.
        hold = 0
        unemitted = len(req.text) - req.emitted_upto
        for s in req.stop:
            for k in range(min(len(s) - 1, unemitted), hold, -1):
                if req.text.endswith(s[:k]):
                    hold = k
                    break
        safe_upto = len(req.text) - hold
        if safe_upto > req.emitted_upto:
            delta = req.text[req.emitted_upto:safe_upto]
            req.emitted_upto = safe_upto
            req.out_queue.put_nowait(Delta(text=delta))

    def _finish(self, req: GenRequest, reason: str, emit: bool = True,
                flush_detok: bool = True) -> None:
        if flush_detok and reason != "cancelled":
            req.text += req.detok.flush()
        req.finish_reason = reason
        req.t_done = time.monotonic()
        if emit:
            delta = req.text[req.emitted_upto:]
            req.emitted_upto = len(req.text)
            req.out_queue.put_nowait(Delta(text=delta, finish_reason=reason))
        self._release(req)

    def _release(self, req: GenRequest) -> None:
        if req.slot in self._running:
            del self._running[req.slot]
            self._prefilling.pop(req.slot, None)
            self.active[req.slot] = False
            self.lengths[req.slot] = 0
            self._free_slots.append(req.slot)
            self._d_dirty = True
            if self.allocator is not None:
                self.allocator.release(req.slot)
                self._table_dirty = True
