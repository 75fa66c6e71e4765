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
* **Decode bursts, compiled and lag-one pipelined.** A burst of decode
  steps runs back to back on the device; the sampled tokens come to the
  host once per burst. On the card a burst whose depth is one of
  ``_burst_depths`` (above 1) is ONE replay of a CUDA graph captured for
  that depth and sampler variant before the engine serves
  (engine/decode_graphs.py); on the CPU the same body runs eagerly. Such a
  burst is pipelined: dispatching burst N returns burst N-1's tokens
  (fetched through pinned memory behind an event), the host length mirror
  advances at dispatch, and tokens of a slot released (or re-admitted)
  while its burst was in flight come back as -1 (``_slot_epoch``). Other
  depths (a request's budget tail, depth 1) run synchronously after
  flushing the burst in flight. Depth is ``decode_burst_busy`` while
  prefill work waits and ``decode_burst`` otherwise; with
  ``ttft_target_ms`` set, a controller caps it from the engine's own fitted
  step time (``_burst_depth``).
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
* **The radix prefix cache** (``prefix_cache``, on by default as in the
  JAX engine; engine/prefix_cache.py): on the paged layout, for models
  without a sliding window, a request whose prompt starts with resident
  blocks maps their pages into its table row at admission and starts its
  prefill at the match; a releasing slot indexes its written blocks. The
  knob is inert on the contiguous layout and for windowed models.

* **Weights** come from an HF safetensors checkpoint (``model_path``,
  engine/checkpoint.py, its architecture from the checkpoint's
  ``config.json`` unless a ``preset`` names it) or, with a ``preset`` alone,
  are random from a seed.

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
from .checkpoint import _config_from_checkpoint, load_checkpoint
from .decode_graphs import DecodeGraphs, LagOneFetch, upload
from .paged import PageAllocator
from .prefix_cache import RadixPrefixCache
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
    # Latency targets (obs/slo.py), evaluated at stream end.
    slo_ttft_ms: float | None = None
    slo_tpot_ms: float | None = None
    t_submit: float = field(default_factory=time.monotonic)
    t_admitted: float | None = None   # slot admission (queued-phase end)
    t_first_token: float | None = None
    t_done: float | None = None
    # Prefix cache: prompt tokens served from resident KV (prefill skipped),
    # the matched nodes this request pins, and the lookup's wall time.
    cached_tokens: int = 0
    prefix_nodes: list = field(default_factory=list)
    prefix_lookup_ms: float | None = None

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
        raise ValueError(f"model {cfg.preset or cfg.model_path!r} cannot run "
                         f"on the card: {why}")


class InferenceEngine:
    """Owns params, the KV cache, and the batching loop."""

    def __init__(self, engine_cfg: LocalEngineConfig,
                 device: str | torch.device = "cuda",
                 model_cfg: ModelConfig | None = None):
        """``model_cfg`` overrides the architecture (as in the JAX engine;
        the bench's long-context and window rungs use it). Otherwise a
        ``preset`` gives it, or the ``config.json`` of ``model_path``. With
        ``model_path`` the weights are the checkpoint's (checked against the
        architecture before any tensor is read), else random from a seed."""
        self.cfg = engine_cfg
        if model_cfg is None:
            if engine_cfg.preset:
                model_cfg = get_preset(engine_cfg.preset)
            elif engine_cfg.model_path:
                model_cfg = _config_from_checkpoint(engine_cfg.model_path)
            else:
                raise ValueError(
                    "local engine needs 'preset' or 'model_path'")
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
        self.ttft_target_ms = max(0.0, engine_cfg.ttft_target_ms)
        # Depths the decode graphs are captured for (above 1). With a TTFT
        # target the 3/4, 1/2 and 1/4 rungs give the adaptive cap landing
        # spots between deep and busy (the cap snaps DOWN to one of them),
        # each rung a graph per sampler variant (JAX engine.py:300-317).
        depths = {self.decode_burst, self.decode_burst_busy}
        if self.ttft_target_ms > 0:
            for frac in (2, 4):
                depths.add(max(1, self.decode_burst // frac))
            depths.add(max(1, 3 * self.decode_burst // 4))
        self._burst_depths = tuple(sorted(depths))
        # A page larger than S would waste a whole-page tail per slot.
        self.kv_page = max(1, min(engine_cfg.kv_page_size, self.S))
        self.tokenizer = load_tokenizer(
            engine_cfg.tokenizer_path or engine_cfg.model_path or None,
            vocab_size=model_cfg.vocab_size)

        t0 = time.monotonic()
        self._forward = forward_fn(model_cfg)
        self.load_stats: dict = {}
        if engine_cfg.model_path:
            self.params = load_checkpoint(
                engine_cfg.model_path, model_cfg, dtype=self.dtype,
                device=self.device, stats=self.load_stats)
            logger.info("checkpoint %s: %.2f GB in %.1fs",
                        engine_cfg.model_path, self.load_stats["bytes"] / 1e9,
                        self.load_stats["seconds"])
        else:
            # Random weights from a fixed seed.
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
        # is counted apart as well. Decode steps count at dispatch;
        # sync_bursts counts the bursts run synchronously, flushes the
        # bursts in flight fetched before the next pipelined dispatch.
        self.prefill_calls = 0
        self.prefill_one_token_calls = 0
        self.decode_steps = 0
        self.sync_bursts = 0
        self.flushes = 0
        self._init_burst_controller()
        # The decode graphs, captured before the engine serves: every
        # pipelined depth, greedy and sampled (a capture never lands inside
        # a request's TTFT).
        self._graphs: DecodeGraphs | None = None
        if self.device.type == "cuda":
            self._graphs = DecodeGraphs(self._rng)
            t0 = time.monotonic()
            for greedy in (True, False):
                for n in self._burst_depths:
                    if n > 1:
                        self._capture(n, greedy)
            logger.info("decode graphs captured: %d in %.1fs",
                        len(self._graphs.graphs), time.monotonic() - t0)

    def _init_burst_controller(self) -> None:
        """State of the ``ttft_target_ms`` burst-depth controller (JAX
        engine.py:816-864). A burst's wall time is C + d·step (C: the
        per-burst fixed cost), so the controller keeps an EMA of the burst
        WALL per depth, fed by steady same-depth pairs only, and fits
        step = Δwall/Δdepth over the two largest fresh depths (C cancels).
        The last fitted slope persists for ``_SLOPE_TTL`` samples, and every
        ``_EXPLORE_EVERY`` idle bursts a steady pair runs one rung deeper,
        so two fresh depths always exist and the fit never falls back to
        the C-biased wall/d for good."""
        self._burst_walls: dict[int, float] = {}
        self._burst_wall_stamp: dict[int, int] = {}
        self._burst_wall_n = 0
        self._fit_slope: float | None = None
        self._fit_stamp = 0
        self._idle_burst_i = 0
        self._explore_pending = 0
        self._explore_depth = 0
        self._depth_hist: dict[int, int] = {}
        self._busy_clamps = 0
        self._last_burst_depth = 0
        # Telemetry of the Retry-After hint (retry_after_hint_s): ms per
        # decode step over steady pairs of any depth, and the queue wait.
        self._ema_step_ms_stats: float | None = None
        self._queue_wait_ema_ms: float | None = None

    # -- initialization ------------------------------------------------------
    def _init_state(self) -> None:
        c = self.model_cfg
        self.allocator: PageAllocator | None = None
        self.kv_ppb = 1                 # multi-page kernel blocking (paged)
        self._swa_ring_pages = 0        # pages a ring slot holds (0: no ring)
        self._swa_margin = 0            # in-flight burst margin, tokens
        self._prefix_cache: RadixPrefixCache | None = None
        if self.paged:
            page = self.kv_page
            per_slot = (self.S + page - 1) // page
            # Sliding-window RING reservation: the windowed kernels never
            # read below pos - window, so a ring of O(window) physical pages
            # serves any context length (ensure_mapped recycles each slot's
            # oldest dead page onto the next logical page). The margin
            # decode_burst * (spec_k + 1) covers the lag-one burst still in
            # flight, which reads from its own, older window floor (the JAX
            # engine's sizing).
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
            # Radix prefix cache over the pool, one block = one superpage
            # run so the multi-page kernels read shared pages unchanged;
            # only where page identity is stable for a sequence's lifetime
            # (no SWA ring, whose rotation re-targets pages; windowed
            # attention never re-reads an old prefix anyway), as in JAX.
            if (self.cfg.prefix_cache and not self._swa_ring_pages
                    and not c.sliding_window):
                self._prefix_cache = RadixPrefixCache(
                    self.allocator, block_tokens=self.kv_ppb * page)
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
        # The decode step's device state: static buffers that every decode
        # graph reads (and whose tokens and lengths each burst advances in
        # place), uploaded in place when the host state changes. Prefill
        # reads the same page table.
        B, dev = self.B, self.device
        self._d_tokens = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._d_lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._d_active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._d_samp = SamplingParams(
            temperature=torch.zeros((B,), dtype=torch.float32, device=dev),
            top_p=torch.ones((B,), dtype=torch.float32, device=dev),
            top_k=torch.zeros((B,), dtype=torch.int32, device=dev),
            presence_penalty=torch.zeros((B,), dtype=torch.float32,
                                         device=dev),
            frequency_penalty=torch.zeros((B,), dtype=torch.float32,
                                          device=dev))
        self._d_table = (torch.zeros(self.allocator.table.shape,
                                     dtype=torch.int32, device=dev)
                         if self.paged else None)
        self._slot_ids = torch.arange(B, device=dev)
        self._d_dirty = True
        # Lag-one pipelining: the burst in flight, (fetch handle, depth,
        # active snapshot, slot epochs) at its dispatch. A slot's epoch moves
        # at every release, so a burst's tokens for a slot released (or
        # released and re-admitted) since its dispatch come back as -1.
        self._pending: tuple | None = None
        self._slot_epoch = np.zeros((B,), np.int64)
        self._fetch = LagOneFetch(self.decode_burst, B, dev)

    def _device_table(self) -> torch.Tensor:
        """The page table's static device buffer, uploaded in place when
        the host table changed (after any burst already dispatched)."""
        if self._table_dirty:
            upload(self._d_table, self.allocator.table)
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

    # Everything the engine holds on the device, or pinned for it.
    _DEVICE_STATE = ("params", "cache", "_graphs", "_fetch", "_pending",
                     "_rng", "_d_counts", "_d_tokens", "_d_lengths",
                     "_d_active", "_d_samp", "_d_table", "_slot_ids")

    async def close(self) -> None:
        """Stop, then drop every device and pinned buffer the engine holds
        (weights, KV cache, decode graphs and their pool, static buffers,
        the generator), so their memory returns to the allocator even while
        something still refers to the engine. The engine serves no more."""
        await self.stop()
        for name in self._DEVICE_STATE:
            setattr(self, name, None)

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

    def retry_after_hint_s(self) -> float:
        """How long a shed client should wait before retrying (JAX
        engine.py:1528): the measured admission wait plus one decode step
        per queued request. Bounded to [1, 30] s: a Retry-After, not a
        promise."""
        step_ms = self._ema_step_ms_stats
        if step_ms is None:
            est = self._step_ms_estimate()
            step_ms = est if est is not None else 0.0
        wait_ms = self._queue_wait_ema_ms or 0.0
        est_ms = wait_ms + step_ms * max(1, self._queue.qsize())
        return min(30.0, max(1.0, est_ms / 1000.0))

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
            matched, shared_pages, nodes = 0, [], []
            cache = self._prefix_cache
            if self.allocator is not None:
                # Prefix lookup: resident prompt blocks map into the new
                # slot's table row instead of being allocated and
                # prefilled. Penalty requests bypass the cache: prefill
                # builds their token counts, which a skipped span would
                # leave incomplete. The matched nodes are pinned here; the
                # pins drop at slot release, or below if the head waits.
                if (cache is not None and req.presence_penalty == 0
                        and req.frequency_penalty == 0):
                    t_lookup = time.monotonic()
                    matched, shared_pages, nodes = cache.match(
                        req.prompt_ids)
                    req.prefix_lookup_ms = 1000.0 * (time.monotonic()
                                                     - t_lookup)
                ok = self.allocator.can_admit(
                    total, ring_pages=self._swa_ring_pages,
                    shared_pages=len(shared_pages))
                if not ok and cache is not None:
                    # Page pressure: evict cold cache entries (LRU leaves;
                    # pinned blocks are untouchable) before the head waits.
                    short = self.allocator.fresh_shortfall(
                        total, ring_pages=self._swa_ring_pages,
                        shared_pages=len(shared_pages))
                    if short > 0 and cache.evict(short) > 0:
                        ok = self.allocator.can_admit(
                            total, ring_pages=self._swa_ring_pages,
                            shared_pages=len(shared_pages))
                if not ok:
                    if cache is not None:
                        cache.release_nodes(nodes)
                    break
            self._head = None
            req.slot = self._free_slots.pop()
            # Queue wait (submit → slot admission), the scheduler half of
            # TTFT: an input of the Retry-After hint.
            req.t_admitted = time.monotonic()
            wait_ms = 1000.0 * (req.t_admitted - req.t_submit)
            self._queue_wait_ema_ms = (
                wait_ms if self._queue_wait_ema_ms is None
                else 0.8 * self._queue_wait_ema_ms + 0.2 * wait_ms)
            if self.allocator is not None:
                self.allocator.allocate(req.slot, total,
                                        ring_pages=self._swa_ring_pages,
                                        shared_pages=shared_pages)
                self._table_dirty = True
                if cache is not None:
                    cache.record_lookup(matched)
                    req.cached_tokens = matched
                    req.prefix_nodes = nodes
            # A warm admission starts prefill at the match: the first
            # chunk's attention reads the shared pages through the table as
            # stale keys, like a later chunk of a cold prefill.
            req.prefill_pos = req.cached_tokens
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
            burst = self._burst_depth(busy)
            # Never burst past any slot's cache capacity or token budget,
            # both from DISPATCH-TRUE state (self.lengths advances at
            # dispatch): with lag-one pipelining len(r.generated) lags a
            # burst behind and would let a whole discarded burst through.
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
                    tok = int(tokens[req.slot])
                    if tok < 0:
                        # Lag-one: this token array predates the slot's
                        # current request (masked in _flush_entry).
                        continue
                    req.generated.append(tok)
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
        each slot's dispatch-true length through ``advance`` more positions)
        by recycling pages wholly below the window floor less one burst of
        margin: the lag-one burst still in flight may read near its own,
        older floor. The table upload lands after that burst on the stream,
        so it reads the table it was dispatched with (JAX engine.py
        ``_swa_rotate``, whose ``inflight`` term is speculative bursts')."""
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

    # -- the burst-depth controller (ttft_target_ms) --------------------------
    _BURST_WALL_WINDOW = 512
    _SLOPE_TTL = 4096
    _EXPLORE_EVERY = 32

    def _step_ms_estimate(self) -> float | None:
        """Per-decode-step ms from the per-depth burst-wall EMAs (JAX
        engine.py:2871-2912). wall(d) = C + d·step, so with two fresh depths
        the slope over the two largest is the fixed-cost-free step time;
        with one, the fitted slope if it has not expired, else wall/d (an
        overestimate, which errs toward shallower bursts). Clamped to
        (0, min wall/d]. Entries older than ``_BURST_WALL_WINDOW`` samples
        sit out (the newest stays if all are stale)."""
        w = self._burst_walls
        if not w:
            return None
        stamp = self._burst_wall_stamp
        fresh = {d: ms for d, ms in w.items()
                 if self._burst_wall_n - stamp.get(d, self._burst_wall_n)
                 <= self._BURST_WALL_WINDOW}
        if not fresh:
            d = max(w, key=lambda k: stamp.get(k, 0))
            fresh = {d: w[d]}
        w = fresh
        ub = min(ms / d for d, ms in w.items())
        if len(w) >= 2:
            d1, d2 = sorted(w)[-2:]
            step = (w[d2] - w[d1]) / (d2 - d1)
            if step > 0:
                self._fit_slope = min(step, ub)
                self._fit_stamp = self._burst_wall_n
                return self._fit_slope
        if (self._fit_slope is not None
                and self._burst_wall_n - self._fit_stamp <= self._SLOPE_TTL):
            return min(self._fit_slope, ub)
        return ub

    def _fixed_cost_ms(self) -> float | None:
        """The per-burst fixed cost C of wall(d) = C + d·step, read off the
        freshest wall with the fitted slope (a diagnostic; None once the
        slope has expired)."""
        if (self._fit_slope is None or not self._burst_walls
                or self._burst_wall_n - self._fit_stamp > self._SLOPE_TTL):
            return None
        d = max(self._burst_walls, key=lambda k:
                self._burst_wall_stamp.get(k, 0))
        return max(0.0, self._burst_walls[d] - d * self._fit_slope)

    def _record_burst_wall(self, n_steps: int, wall: float) -> None:
        """One steady same-depth pair's wall (ms): a lag-one call's wall
        then covers exactly one burst at that depth. Feeds the depth's EMA,
        the controller's input, and the per-step EMA whatever the depth,
        the Retry-After hint's input."""
        prev_w = self._burst_walls.get(n_steps)
        self._burst_walls[n_steps] = (
            wall if prev_w is None else 0.8 * prev_w + 0.2 * wall)
        self._burst_wall_n += 1
        self._burst_wall_stamp[n_steps] = self._burst_wall_n
        ms_any = wall / n_steps
        self._ema_step_ms_stats = (
            ms_any if self._ema_step_ms_stats is None
            else 0.8 * self._ema_step_ms_stats + 0.2 * ms_any)

    def _burst_depth(self, busy: bool) -> int:
        """Depth of the next decode burst (JAX engine.py:3094-3168).

        Busy (work queued or prefilling): ``decode_burst_busy``, and with a
        TTFT target at most a QUARTER of it over the fitted step time (a
        prefill chunk waits out one busy burst), snapped down to a captured
        depth or to 1. Idle: ``decode_burst``, and with a target at most
        HALF of it over the step time (an arriving request waits out the
        burst in flight), snapped down to a captured depth; every
        ``_EXPLORE_EVERY`` idle bursts a steady pair one rung deeper keeps a
        second depth fresh for the fit. Until a wall is measured, the
        configured depth (the first bursts are the measurement)."""
        if busy:
            # A busy interleave splits an exploration pair: its second
            # burst would record nothing. Cancel it.
            self._explore_pending = 0
            pick = self.decode_burst_busy
            if self.ttft_target_ms > 0:
                est = self._step_ms_estimate()
                if est:
                    cap = 0.25 * self.ttft_target_ms / est
                    if cap < pick:
                        fitting = [d for d in self._burst_depths
                                   if d <= cap]
                        pick = max(fitting) if fitting else 1
                        self._busy_clamps += 1
            self._last_burst_depth = pick
            self._depth_hist[pick] = self._depth_hist.get(pick, 0) + 1
            return pick
        pick = self.decode_burst
        if self.ttft_target_ms > 0:
            est = self._step_ms_estimate()
            if est:
                cap = 0.5 * self.ttft_target_ms / est
                fitting = [d for d in self._burst_depths if d <= cap]
                pick = (min(max(fitting), self.decode_burst) if fitting
                        else self._burst_depths[0])
            if self._explore_pending > 0 and self._explore_depth > pick:
                self._explore_pending -= 1
                pick = self._explore_depth
            else:
                self._explore_pending = 0
                self._idle_burst_i += 1
                if pick < self.decode_burst and \
                        self._idle_burst_i % self._EXPLORE_EVERY == 0:
                    deeper = [d for d in self._burst_depths
                              if pick < d <= self.decode_burst]
                    if deeper:
                        self._explore_depth = deeper[0]
                        self._explore_pending = 1
                        pick = self._explore_depth
        self._last_burst_depth = pick
        self._depth_hist[pick] = self._depth_hist.get(pick, 0) + 1
        return pick

    # -- the decode step (worker thread) ---------------------------------------
    def _decode_attention(self):
        """The decode attention over the static page table (paged) or the
        contiguous cache, with the model's window."""
        window = self.model_cfg.sliding_window
        if self.paged:
            return make_paged_attention_fn(self._d_table, window, self.kv_ppb)
        return make_cache_attention_fn(window=window)

    def _decode_body(self, n_steps: int, greedy: bool) -> torch.Tensor:
        """``n_steps`` chained decode steps over the static buffers: what a
        decode graph captures, and what runs eagerly on the CPU and for
        synchronous bursts. Reads tokens, lengths, active, the sampling
        vectors, the penalty counts and the page table; writes the KV cache
        in place; returns the [n, B] token block; its last ops write the
        final tokens and lengths back into the input buffers."""
        attn = self._decode_attention()
        tokens, lengths, active = (self._d_tokens, self._d_lengths,
                                   self._d_active)
        out = []
        for _ in range(n_steps):
            if not greedy:
                # Penalty counts: each step's INPUT token.
                self._d_counts[self._slot_ids, tokens] += active.int()
            logits, cache = self._forward(
                self.params, self.model_cfg, tokens[:, None], lengths,
                self.cache, attention_fn=attn, active=active)
            if cache is not self.cache:
                raise RuntimeError("the decode step must update the KV "
                                   "cache in place")
            if greedy:
                tokens = torch.argmax(logits[:, 0, :], dim=-1)
            else:
                tokens = sample(logits[:, 0, :], self._d_samp, self._rng,
                                counts=self._d_counts)
            lengths = torch.where(active, lengths + 1, lengths)
            out.append(tokens)
        block = torch.stack(out)
        self._d_tokens.copy_(tokens)
        self._d_lengths.copy_(lengths)
        return block

    @torch.no_grad()
    def _capture(self, n_steps: int, greedy: bool) -> None:
        """Capture the (depth, greedy) decode graph. Its eager warm-up runs
        with every slot inactive (their writes land on the trash page or a
        row's never-read tail, their counts add 0), and the tokens, lengths
        and active buffers are put back after it."""
        saved = [t.clone() for t in (self._d_tokens, self._d_lengths,
                                     self._d_active)]
        self._d_active.zero_()
        self._graphs.capture(self._decode_body, n_steps, greedy)
        for dst, src in zip((self._d_tokens, self._d_lengths,
                             self._d_active), saved):
            dst.copy_(src)

    def _dispatch(self, n_steps: int, greedy: bool) -> torch.Tensor:
        """Launch one pipelined burst: on the card the replay of its graph,
        captured at build, on the CPU the body run eagerly. Returns the
        device token block."""
        if self._graphs is None:
            return self._decode_body(n_steps, greedy)
        return self._graphs.replay(n_steps, greedy)

    def _upload_slot_state(self) -> None:
        """The host slot mirrors into the static buffers, in place."""
        for dst, src in ((self._d_tokens, self.last_token),
                         (self._d_lengths, self.lengths),
                         (self._d_active, self.active),
                         *zip(self._d_samp, (
                             self.samp_temperature, self.samp_top_p,
                             self.samp_top_k, self.samp_presence,
                             self.samp_frequency))):
            upload(dst, src)
        self._d_dirty = False

    def _flush_pending(self) -> list[np.ndarray]:
        """Fetch the burst in flight (if any) ahead of the next dispatch."""
        entry, self._pending = self._pending, None
        if entry is not None:
            self.flushes += 1
        return self._flush_entry(entry)

    def _flush_entry(self, entry) -> list[np.ndarray]:
        """A dispatched burst's per-step [B] token arrays, in order, with
        -1 for slots released (or re-admitted) since its dispatch; syncs
        the host ``last_token`` mirror of the slots that survived."""
        if entry is None:
            return []
        handle, n, active_snap, epoch_snap = entry
        host = LagOneFetch.wait(handle)                  # [n, B]
        live = active_snap & (epoch_snap == self._slot_epoch)
        self.last_token[live] = host[-1][live]
        if not live.all():
            host[:, ~live] = -1
        return [host[i] for i in range(n)]

    @torch.no_grad()
    def _decode_burst(self, n_steps: int) -> list[np.ndarray]:
        """Run ``n_steps`` chained decode steps (JAX engine.py:3170-3330).
        A depth in ``_burst_depths`` above 1 runs LAG-ONE pipelined: this
        call dispatches burst N (one graph replay on the card), starts its
        pinned copy to the host, and returns burst N-1's tokens. Other
        depths flush the burst in flight, then run synchronously. Returns
        host token arrays in generation order (possibly the previous
        burst's; two bursts' worth when a flush was forced)."""
        pre: list[np.ndarray] = []
        if self._d_dirty:
            # The upload reads the host last_token mirror, which the burst
            # in flight updates: it lands first.
            pre += self._flush_pending()
            self._upload_slot_state()
        if self.paged:
            self._device_table()
        greedy = self._all_greedy()
        if n_steps > 1 and n_steps in self._burst_depths:
            t0 = time.monotonic()
            handle = self._fetch.start(self._dispatch(n_steps, greedy))
            prev, self._pending = self._pending, (
                handle, n_steps, self.active.copy(), self._slot_epoch.copy())
            # The host length mirror advances at DISPATCH: the scheduler's
            # caps must see device-true lengths.
            self.lengths[self.active] += n_steps
            self.decode_steps += n_steps
            out = pre + self._flush_entry(prev)
            if prev is not None and prev[1] == n_steps:
                # Steady same-depth pair: this call's wall covers exactly
                # one burst at this depth. Depth changes record nothing.
                self._record_burst_wall(
                    n_steps, 1000.0 * (time.monotonic() - t0))
            return out

        pre += self._flush_pending()
        host = self._decode_body(n_steps, greedy).cpu().numpy()
        self.sync_bursts += 1
        self.decode_steps += n_steps
        self.last_token[self.active] = host[-1][self.active]
        self.lengths[self.active] += n_steps
        return pre + [host[i] for i in range(n_steps)]

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

    def _prefix_release(self, req: GenRequest) -> None:
        """Insert-on-release, then unpin: index the slot's written KV into
        the prefix cache BEFORE the allocator frees the row, then drop the
        pins taken at admission. Only tokens whose cache writes have landed
        are indexed: a slot still prefilling covers the chunks that ran
        (``prefill_pos``); a decoding slot covers the prompt and every
        generated token that has been the input of a decode step (the last
        sampled token's KV is not written yet)."""
        cache = self._prefix_cache
        try:
            if req.slot in self._prefilling:
                n_ok = req.prefill_pos
            else:
                n_ok = len(req.prompt_ids) + max(0, len(req.generated) - 1)
            seq = req.prompt_ids + req.generated
            cache.insert(seq, min(n_ok, self.S, len(seq)),
                         self.allocator.table[req.slot])
        finally:
            cache.release_nodes(req.prefix_nodes)
            req.prefix_nodes = []

    def _release(self, req: GenRequest) -> None:
        if req.slot in self._running:
            if self._prefix_cache is not None:
                self._prefix_release(req)
            del self._running[req.slot]
            self._prefilling.pop(req.slot, None)
            self.active[req.slot] = False
            self.lengths[req.slot] = 0
            self._free_slots.append(req.slot)
            self._slot_epoch[req.slot] += 1
            self._d_dirty = True
            if self.allocator is not None:
                self.allocator.release(req.slot)
                self._table_dirty = True

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        """Scheduler, pool and prefix-cache state plus the work counters
        (the JAX engine's ``stats()`` keys that the port has)."""
        out = {
            "running": len(self._running),
            "queued": self._queue.qsize() + (1 if self._head else 0),
            "free_slots": len(self._free_slots),
            "batch_size": self.B,
            "max_seq_len": self.S,
            "kv_layout": self.cfg.kv_layout,
            "prefill_calls": self.prefill_calls,
            "prefill_one_token_calls": self.prefill_one_token_calls,
            "decode_steps": self.decode_steps,
            "sync_bursts": self.sync_bursts,
            "flushes": self.flushes,
            "graphs_captured": (0 if self._graphs is None
                                else len(self._graphs.graphs)),
            "graph_replays": (0 if self._graphs is None
                              else self._graphs.replays),
            "burst_busy_clamps": self._busy_clamps,
        }
        if self._last_burst_depth:
            out["burst_depth_last"] = self._last_burst_depth
        # Burst-depth controller diagnostics (ttft_target_ms): fitted step
        # time, per-burst fixed cost, where bursts ran, and the walls.
        if self.ttft_target_ms > 0:
            est = self._step_ms_estimate()
            if est is not None:
                out["burst_step_ms_fit"] = round(est, 3)
            c = self._fixed_cost_ms()
            if c is not None:
                out["burst_fixed_cost_ms"] = round(c, 1)
            if self._depth_hist:
                out["burst_depth_hist"] = dict(
                    sorted(self._depth_hist.items()))
            out["burst_walls_ms"] = {
                d: round(ms, 1)
                for d, ms in sorted(self._burst_walls.items())}
        if self.kv_quant:
            out["kv_quant"] = self.kv_quant
        if self.allocator is not None:
            out["free_pages"] = self.allocator.free_pages
            out["total_pages"] = (self.allocator.num_pages
                                  - self.allocator.pages_per_block)
            out["page_size"] = self.allocator.page_size
            if self.kv_ppb > 1:
                out["pages_per_block"] = self.kv_ppb
            if self._prefix_cache is not None:
                out.update(self._prefix_cache.stats())
        return out
